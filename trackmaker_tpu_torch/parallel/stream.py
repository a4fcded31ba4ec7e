"""Blocked decode of one long capture (counterpart of the single-device
parts of ``trackmaker_tpu/parallel/stream.py``).

A long recording is cut into `n_blocks` blocks of time, each decoded as if
alone and owning the frames whose preamble starts inside it.  Ownership
alone is not the sequential decode: a frame near a seam can consume into
the next block (its payload may even embed a preamble and a valid frame),
and so suppress candidates there that the next block, walking from its own
start, would attempt.  The **consumed-until fixpoint** fixes that: each
block reports where its walk ended, the block to its right restarts its
walk there, and the walks repeat until no cursor changes.  Block 0 never
depends on a cursor, so block k's cursor is final after k turns, and the
stitched walks equal the sequential walk decision for decision; a block
whose start cursor lies past its own end attempts nothing and forwards the
endpoint.

Two routes:

* :func:`decode_blocked_spec`, the speculative one: the capture is
  correlated once as one stream, its hit rows split into one candidate
  table per block with positions in the whole capture, and the attempt
  kernels read the one capture, so a frame near a seam reads the samples
  that follow it.  Each fixpoint turn re-runs only the walk.
* :func:`decode_blocked_exact`: overlapping windows of block + halo
  samples, each decoded by the exact scan from its start cursor, the
  fixpoint re-decoding every block.

:func:`decode_blocked_single_chip` takes the speculative route and falls
back to the exact one when a block's candidate table overflowed or (4B5B)
an attempted frame holds a near-zero level.
"""

from __future__ import annotations

import torch

from trackmaker_tpu_torch.core.config import PhyConfig
from trackmaker_tpu_torch.phy import spec_decode
from trackmaker_tpu_torch.phy.decoder import DecodedFrames, decode_capture
from trackmaker_tpu_torch.sync.xcorr_hits import ROW_LAGS


def spec_block(t: int, n_blocks: int) -> int:
    """The speculative route's block for a capture of `t` samples:
    ceil(t / n_blocks) rounded up to whole hit rows of 128 samples."""
    return -(-(-(-t // n_blocks)) // ROW_LAGS) * ROW_LAGS


def halo_size(cfg: PhyConfig) -> int:
    """Samples a block's window reaches past its end: the largest frame
    with its preamble, the sync margin and word, and a few more."""
    return cfg.preamble_len + cfg.max_frame_samples + cfg.sync_margin + cfg.sync_len + 8


def _mask_mine(res: DecodedFrames, block: int, starts: torch.Tensor) -> DecodedFrames:
    """Keep the frames of res [n_blocks, K], decoded in windows starting at
    `starts`, whose preamble starts inside their block's own `block`
    samples, with starts moved to positions in the whole capture."""
    mine = res.valid & (res.start >= 0) & (res.start < block)

    def keep(a: torch.Tensor, empty=0) -> torch.Tensor:
        return torch.where(mine[..., None] if a.ndim == 3 else mine, a, empty)

    return DecodedFrames(
        valid=mine, frame_bytes=keep(res.frame_bytes), length=keep(res.length),
        frame_type=keep(res.frame_type), sequence=keep(res.sequence), src=keep(res.src),
        dst=keep(res.dst), start=keep(res.start + starts[:, None], -1), corr=keep(res.corr, 0.0))


def _flat(res: DecodedFrames) -> DecodedFrames:
    """[n_blocks, K, ...] fields -> [n_blocks * K, ...]."""
    return DecodedFrames(*(a.reshape(-1, *a.shape[2:]) for a in res))


def _overlapping_blocks(x: torch.Tensor, n_blocks: int, block: int, halo: int) -> torch.Tensor:
    """[n_blocks, block + halo] windows of x f32[T] from each block's
    start, zero past T (a strided view of the zero-padded capture)."""
    xp = torch.nn.functional.pad(x, (0, n_blocks * block + halo - x.shape[0]))
    return xp.unfold(0, block + halo, block)[:n_blocks]


def decode_blocked_exact(cfg: PhyConfig, x: torch.Tensor, local_addr: int, n_blocks: int,
                         max_frames_per_block: int) -> DecodedFrames:
    """The exact blocked decode of one capture x f32[T]: every block of
    ceil(T / n_blocks) samples is decoded by the exact scan in a window
    reaching `halo_size` samples past it, from its start cursor and
    attempting only candidates inside the block; the consumed-until
    fixpoint re-decodes every block until no start cursor changes.  Returns
    the frames of each block, in its `max_frames_per_block` slots, as one
    DecodedFrames [n_blocks * max_frames_per_block] with starts in the
    whole capture."""
    x = x.to(torch.float32)
    t = x.shape[0]
    halo = halo_size(cfg)
    block = -(-t // n_blocks)
    starts = [k * block for k in range(n_blocks)]
    wins = _overlapping_blocks(x, n_blocks, block, halo)
    vlens = [min(block + halo, t - s) for s in starts]

    def decode(cursors: list[int]):
        out = [decode_capture(cfg, wins[k], local_addr, max_frames=max_frames_per_block,
                              valid_len=vlens[k], with_cursor=True, start_cursor=cursors[k],
                              scan_limit=block)
               for k in range(n_blocks)]
        return [r for r, _, _ in out], [fcur for _, _, fcur in out]

    def propose(fcur: list[int]) -> list[int]:
        # the left neighbour's end of consumption, in this block's window
        return [0] + [max(starts[k] + fcur[k] - starts[k + 1], 0) for k in range(n_blocks - 1)]

    cur = [0] * n_blocks
    res, fcur = decode(cur)
    for _ in range(n_blocks):   # block k's cursor is final after k turns
        nxt = propose(fcur)
        if nxt == cur:
            break
        cur = nxt
        res, fcur = decode(cur)
    else:
        raise RuntimeError("the seam fixpoint did not converge in n_blocks turns")
    stacked = DecodedFrames(*(torch.stack(col) for col in zip(*res)))
    starts_t = torch.tensor(starts, dtype=torch.int32, device=x.device)
    return _flat(_mask_mine(stacked, block, starts_t))


def seam_fixpoint(walk, fields: torch.Tensor, starts: torch.Tensor, limit: torch.Tensor,
                  max_frames: int):
    """The consumed-until fixpoint over the walks of the blocks' candidate
    tables fields int32[n_blocks, 4, C], whose positions, `starts` and
    `limit` are positions in the whole capture: `walk` (``spec_walk`` or
    its plain version) runs from the blocks' starts, then from the end of
    each left neighbour's consumption, until no start cursor changes.
    Returns (the last walk, the number of walks)."""
    cur = starts
    res = walk(fields, cur, limit, max_frames)
    for turns in range(1, starts.shape[0] + 1):
        nxt = torch.cat([starts[:1], torch.maximum(res.cur_f[:-1], starts[1:])])
        if torch.equal(nxt, cur):   # one host sync a turn
            return res, turns
        cur = nxt
        res = walk(fields, cur, limit, max_frames)
    raise RuntimeError("the seam fixpoint did not converge in n_blocks turns")


def decode_blocked_spec(cfg: PhyConfig, x: torch.Tensor, local_addr: int, n_blocks: int,
                        max_frames_per_block: int, n_cand: int = 128):
    """The speculative blocked decode of one capture x f32[T]; returns
    ``(frames, ok, turns)``, frames as one DecodedFrames [n_blocks *
    max_frames_per_block] with starts in the whole capture, kept frames in
    the leading slots of their block, and `turns` the walks the seam
    fixpoint ran.

    Blocks hold `spec_block(T, n_blocks)` samples; the capture is
    zero-padded to n_blocks of them and decoded flat
    (``spec_decode.spec_phase_a`` with ``flat_blocks``), then walked by the
    seam fixpoint.  ``ok`` (a bool tensor) is False when a block's
    candidate table overflowed or, for 4B5B, a frame the converged walk
    attempted holds a near-zero level: then the exact route must decode
    the capture."""
    spec_decode._check_cfg(cfg)
    x = x.to(torch.float32)
    t = x.shape[0]
    dev = x.device
    block = spec_block(t, n_blocks)
    xf = torch.nn.functional.pad(x, (0, n_blocks * block - t)).contiguous()
    starts = torch.arange(n_blocks, dtype=torch.int32, device=dev) * block
    vlens = torch.full((n_blocks,), t, dtype=torch.int32, device=dev)
    a = spec_decode.spec_phase_a(cfg, xf, local_addr, n_cand, vlens,
                                 flat_blocks=(n_blocks, block))
    walk, turns = seam_fixpoint(spec_decode.spec_walk, a.fields, starts, starts + block,
                            max_frames_per_block)
    res = spec_decode.spec_compact(a, walk.keep, max_frames_per_block)
    ok = ~(a.overflow | (walk.attempted & a.nonconf).any(-1)).any()
    return _flat(res), ok, turns


def decode_blocked_single_chip(cfg: PhyConfig, capture: torch.Tensor, local_addr: int,
                               n_blocks: int, max_frames_per_block: int = 32,
                               n_cand: int = 128) -> DecodedFrames:
    """Decode one long capture f32[T] in `n_blocks` blocks on its device.

    Configurations the attempt kernels are specialized for take the
    speculative route (the kernels on a CUDA tensor, their plain versions
    on a CPU tensor); the exact route decodes the capture when that route
    is not ``ok``, and decodes other configurations.  Both equal the
    sequential exact scan frame for frame; the slots differ (the exact
    route leaves failed attempts as empty slots)."""
    if spec_decode.spec_supported_cfg(cfg):
        res, ok, _ = decode_blocked_spec(cfg, capture, local_addr, n_blocks,
                                      max_frames_per_block, n_cand)
        if bool(ok):
            return res
    return decode_blocked_exact(cfg, capture, local_addr, n_blocks, max_frames_per_block)
