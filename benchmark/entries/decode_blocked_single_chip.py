"""Entry: ``parallel.stream.decode_blocked_single_chip`` on one long recording.

A request is one recording f32[T] of the pool, decoded in `n_blocks`
blocks with `max_frames_per_block` walk steps and `n_cand` candidates a
block; its answer is the ``DecodedFrames`` fields [n_blocks *
max_frames_per_block, ...], starts in the whole recording.
"""

from __future__ import annotations

import numpy as np

from harness import phy as P
from harness import roofline



def block_samples(t: int, n_blocks: int) -> int:
    """The speculative route's block: ceil(t / n_blocks) rounded up to
    whole hit rows."""
    per = -(-t // n_blocks)
    return -(-per // roofline.ROW_LAGS) * roofline.ROW_LAGS


class Entry:
    def __init__(self, cfg: dict, phy, mix: dict, t: int):
        from trackmaker_tpu_torch.core.config import PhyConfig
        from trackmaker_tpu_torch.parallel.stream import decode_blocked_single_chip

        self._cfg = PhyConfig(**{k: cfg[k] for k in P.CONFIG_KEYS})
        self._decode = decode_blocked_single_chip
        self.phy, self.mix, self.t = phy, mix, t
        self.ref_max_frames = None   # the whole recording, one walk: the sequential decode
        if mix["rows"] != 1:
            raise ValueError("the blocked decode takes one recording a request")

    def __call__(self, x):
        return tuple(self._decode(self._cfg, x[0], self.mix["local_addr"], self.mix["n_blocks"],
                                  self.mix["max_frames_per_block"], self.mix["n_cand"]))

    @staticmethod
    def frames(host: list[np.ndarray]) -> list[list[tuple]]:
        """The recording's decoded frames in order of start, as
        (start, frame bytes, length, type, seq, src, dst, corr)."""
        valid, fbytes, length, ftype, seq, src, dst, start, corr = host
        ks = sorted(np.nonzero(valid)[0], key=lambda k: int(start[k]))
        return [[(int(start[k]), fbytes[k, :7 + int(length[k])].tobytes(), int(length[k]),
                  int(ftype[k]), int(seq[k]), int(src[k]), int(dst[k]), float(corr[k]))
                 for k in ks]]

    def work(self, hits: list[np.ndarray]) -> dict:
        """(kernel, bytes, operations) of one request's launches, from the
        recording's hit lags."""
        t, nb, n_cand = self.t, self.mix["n_blocks"], self.mix["n_cand"]
        block = block_samples(t, nb)
        per_block = np.bincount(np.asarray(hits[0], np.int64) // block, minlength=nb)
        live = int(np.minimum(per_block, n_cand).sum())
        lc = self.phy.line_coding
        xb, xo = roofline.xcorr_hits(1, nb * block, self.phy.preamble_len)
        ab, ao = roofline.attempt_shared(lc, nb, nb * block, n_cand, live)
        wb, wo = roofline.spec_walk(nb, n_cand)
        out_bytes = nb * self.mix["max_frames_per_block"] * (roofline.FRAME_BYTES + 4 * 7 + 1)
        return {"xcorr": ("xcorr_hits_kernel", xb, xo),
                "attempt": (roofline.ATTEMPT_KERNELS[lc], ab, ao),
                "walk": ("spec_walk_kernel", wb, wo),
                "request": (None, t * 4 + out_bytes, xo + ao + wo)}
