"""Entry: ``phy.decoder.decode_capture_fast`` on a batch of recordings.

A request is the mix's `rows` recordings f32[rows, T] of one pool entry,
decoded in one call with `max_frames` walk steps a recording; its answer is
the ``DecodedFrames`` fields [rows, max_frames, ...].
"""

from __future__ import annotations

import numpy as np

from harness import phy as P
from harness import roofline

N_CAND = 128   # the entry's candidate table


class Entry:
    def __init__(self, cfg: dict, phy, mix: dict, t: int):
        from trackmaker_tpu_torch.core.config import PhyConfig
        from trackmaker_tpu_torch.phy.decoder import decode_capture_fast

        self._cfg = PhyConfig(**{k: cfg[k] for k in P.CONFIG_KEYS})
        self._decode = decode_capture_fast
        self.phy, self.mix, self.t = phy, mix, t
        self.ref_max_frames = mix["max_frames"]   # the reference walks as far

    def __call__(self, x):
        return tuple(self._decode(self._cfg, x, self.mix["local_addr"],
                                  max_frames=self.mix["max_frames"]))

    @staticmethod
    def frames(host: list[np.ndarray]) -> list[list[tuple]]:
        """Each recording's decoded frames, in slot order, as
        (start, frame bytes, length, type, seq, src, dst, corr)."""
        valid, fbytes, length, ftype, seq, src, dst, start, corr = host
        out = []
        for r in range(valid.shape[0]):
            out.append([(int(start[r, k]), fbytes[r, k, :7 + int(length[r, k])].tobytes(),
                         int(length[r, k]), int(ftype[r, k]), int(seq[r, k]), int(src[r, k]),
                         int(dst[r, k]), float(corr[r, k])) for k in np.nonzero(valid[r])[0]])
        return out

    def work(self, hits: list[np.ndarray]) -> dict:
        """(kernel, bytes, operations) of one request's launches, from the
        hit lags of each recording."""
        b, t = len(hits), self.t
        l = self.phy.preamble_len
        live = sum(min(len(h), N_CAND) for h in hits)
        lc = self.phy.line_coding
        xb, xo = roofline.xcorr_hits(b, t, l)
        ab, ao = roofline.attempt(lc, b, t, N_CAND, live)
        wb, wo = roofline.spec_walk(b, N_CAND)
        out_bytes = b * self.mix["max_frames"] * (roofline.FRAME_BYTES + 4 * 7 + 1)
        return {"xcorr": ("xcorr_hits_kernel", xb, xo),
                "attempt": (roofline.ATTEMPT_KERNELS[lc], ab, ao),
                "walk": ("spec_walk_kernel", wb, wo),
                "request": (None, b * t * 4 + out_bytes, xo + ao + wo)}
