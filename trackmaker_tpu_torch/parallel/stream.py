"""Blocked decode of one long capture, on one device or sharded over a
device mesh (counterpart of ``trackmaker_tpu/parallel/stream.py``).

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

:func:`decode_blocked_sharded` is the same decomposition over a mesh
(``parallel/mesh.py``), one block a shard: each shard's window is its block
and the head of its right neighbour's, copied from that shard's device,
and shards on one device decode as one batch.  Its speculative route
(:func:`sharded_spec_run`) runs phase A once a device and re-runs only the
walk each fixpoint turn; its exact route decodes each window with the
exact scan.  It keeps JAX's rules for the windows: the halo is the first
``min(halo, block)`` samples of the next block (zeros for the last shard)
and every shard but the last counts ``block + halo`` valid samples, even
where its window is shorter or holds the capture's zero padding.
"""

from __future__ import annotations

import torch

from typing import NamedTuple

import numpy as np

from trackmaker_tpu_torch.core.config import PhyConfig
from trackmaker_tpu_torch.parallel.mesh import Mesh, by_device, on_device
from trackmaker_tpu_torch.phy import spec_decode
from trackmaker_tpu_torch.phy.decoder import DecodedFrames, _empty_frames, decode_capture
from trackmaker_tpu_torch.sync.xcorr_hits import BIGI, ROW_LAGS


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
    wins = _overlapping_blocks(x, n_blocks, block, halo)
    vlens = [min(block + halo, t - k * block) for k in range(n_blocks)]
    res = _exact_fixpoint(cfg, list(wins), vlens, block, local_addr, max_frames_per_block)
    stacked = DecodedFrames(*(torch.stack(col) for col in zip(*res)))
    starts_t = torch.arange(n_blocks, dtype=torch.int32, device=x.device) * block
    return _flat(_mask_mine(stacked, block, starts_t))


def _exact_fixpoint(cfg: PhyConfig, wins: list[torch.Tensor], vlens: list[int], block: int,
                    local_addr: int, max_frames: int) -> list[DecodedFrames]:
    """The exact scan of each block's window wins[k] (valid length vlens[k],
    candidates inside its first `block` samples) under the consumed-until
    fixpoint: block k restarts at the end of block k-1's consumption, in
    its own window, until no start cursor changes.  Returns each block's
    frames, on its window's device."""
    n = len(wins)

    def decode(cursors: list[int]):
        out = []
        for k in range(n):
            with on_device(wins[k].device):
                out.append(decode_capture(cfg, wins[k], local_addr, max_frames=max_frames,
                                          valid_len=vlens[k], with_cursor=True,
                                          start_cursor=cursors[k], scan_limit=block))
        return [r for r, _, _ in out], [fcur for _, _, fcur in out]

    def propose(fcur: list[int]) -> list[int]:
        # the left neighbour's end of consumption, in this block's window
        return [0] + [max(fcur[k] - block, 0) for k in range(n - 1)]

    cur = [0] * n
    res, fcur = decode(cur)
    for _ in range(n):   # block k's cursor is final after k turns
        nxt = propose(fcur)
        if nxt == cur:
            return res
        cur = nxt
        res, fcur = decode(cur)
    raise RuntimeError("the seam fixpoint did not converge in n_blocks turns")


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


class ShardWindows(NamedTuple):
    """The shards' windows of one capture, grouped by device."""
    block: int
    vlens: list[int]                        # each shard's valid length
    groups: dict                            # device -> (shard indices, f32[S, window])


def shard_windows(capture, mesh: Mesh, halo: int) -> ShardWindows:
    """Cut capture f32[T] (a tensor or a NumPy array) into one block of
    ceil(T / n) samples a shard of the mesh, zero-padded to n blocks, each
    block on its shard's device.  Shard i's window is its block and the
    first min(halo, block) samples of block i+1, copied from shard i+1's
    device (zeros for the last shard); its valid length is block + halo,
    and T - i * block for the last shard, as JAX counts them."""
    devices = mesh.flat
    n = len(devices)
    if not isinstance(capture, torch.Tensor):
        capture = torch.from_numpy(np.ascontiguousarray(capture, np.float32))
    x = capture.to(torch.float32)
    t = x.shape[-1]
    block = -(-t // n)
    blocks = [torch.nn.functional.pad(x[i * block:(i + 1) * block].to(devices[i]),
                                      (0, max(0, min(block, (i + 1) * block - t))))
              for i in range(n)]
    edge = min(halo, block)
    heads = [blocks[i + 1][:edge].to(devices[i]) for i in range(n - 1)]
    heads.append(torch.zeros(edge, dtype=torch.float32, device=devices[-1]))
    groups = {dev: (idx, torch.stack([torch.cat([blocks[i], heads[i]]) for i in idx]))
              for dev, idx in by_device(devices).items()}
    vlens = [block + halo] * (n - 1) + [t - (n - 1) * block]
    return ShardWindows(block, vlens, groups)


def _assemble(parts: dict, n: int, lead: torch.device) -> DecodedFrames:
    """DecodedFrames [n * K] on `lead` from {shard: DecodedFrames [K]}."""
    return DecodedFrames(*(torch.cat([parts[i][f].to(lead) for i in range(n)])
                           for f in range(len(DecodedFrames._fields))))


class _GroupWalk(NamedTuple):
    parts: dict          # device -> the walk of its shards
    cur_f: torch.Tensor  # int32[n] final cursors in positions of the whole capture


def sharded_spec_run(cfg: PhyConfig, capture, local_addr: int, mesh: Mesh,
                     max_frames_per_block: int = 32, n_cand: int = 128,
                     walk=spec_decode.spec_walk):
    """The speculative route of :func:`decode_blocked_sharded` (counterpart
    of JAX's ``_sharded_spec_run``); returns ``(frames, ok, turns)``:
    DecodedFrames [n_shards * max_frames_per_block] on the mesh's first
    device with starts in the whole capture, ok bool[n_shards] (False: a
    candidate table overflowed, or a frame the converged walk attempted is
    not conformant) and the walks the seam fixpoint ran.

    Each device runs ``spec_phase_a`` once over its shards' windows [S,
    block + halo].  Each shard walks its own window from cursor 0 with
    limit `block`; the seam fixpoint (:func:`seam_fixpoint`, in positions
    of the whole capture: shard i's window starts at i * block) then starts
    shard i at the end of shard i-1's consumption, running only the walk,
    with one read of the cursors a turn.  `walk` is ``spec_decode.spec_walk``
    or a function of its arguments and result (a check's)."""
    spec_decode._check_cfg(cfg)
    devices = mesh.flat
    n = len(devices)
    lead = devices[0]
    k = max_frames_per_block
    sw = shard_windows(capture, mesh, halo_size(cfg))
    block = sw.block
    if 2 * block < cfg.preamble_len:    # no lag fits a window: no candidate anywhere
        return (_empty_frames(cfg, n * k, lead), torch.ones(n, dtype=torch.bool, device=lead),
                1)
    phase_a, fields, limits, index = {}, {}, {}, {}
    for dev, (idx, wins) in sw.groups.items():
        with on_device(dev):
            vl = torch.tensor([sw.vlens[i] for i in idx], dtype=torch.int32, device=dev)
            a = spec_decode.spec_phase_a(cfg, wins, local_addr, n_cand, vl)
            base = torch.tensor(idx, dtype=torch.int32, device=dev)[:, None] * block
            pos = a.fields[:, 0]
            fields[dev] = torch.cat([torch.where(pos < BIGI, pos + base, pos)[:, None],
                                     a.fields[:, 1:]], dim=1).contiguous()
            limits[dev] = (base[:, 0] + block).contiguous()
            phase_a[dev] = a
            index[dev] = torch.tensor(idx, device=lead)

    def group_walk(_fields, cur: torch.Tensor, _limit, max_frames: int) -> _GroupWalk:
        parts = {}
        cur_f = torch.empty(n, dtype=torch.int32, device=lead)
        for dev in sw.groups:
            with on_device(dev):
                parts[dev] = walk(fields[dev], cur[index[dev]].to(dev), limits[dev], max_frames)
            cur_f[index[dev]] = parts[dev].cur_f.to(lead)
        return _GroupWalk(parts, cur_f)

    starts = torch.arange(n, dtype=torch.int32, device=lead) * block
    res, turns = seam_fixpoint(group_walk, None, starts, starts + block, k)
    frames, ok = {}, torch.empty(n, dtype=torch.bool, device=lead)
    for dev, (idx, _) in sw.groups.items():
        a, w = phase_a[dev], res.parts[dev]
        with on_device(dev):
            base = torch.tensor(idx, dtype=torch.int32, device=dev) * block
            mine = _mask_mine(spec_decode.spec_compact(a, w.keep, k), block, base)
            ok[index[dev]] = (~(a.overflow | (w.attempted & a.nonconf).any(-1))).to(lead)
        for j, i in enumerate(idx):
            frames[i] = DecodedFrames(*(f[j] for f in mine))
    return _assemble(frames, n, lead), ok, turns


def decode_blocked_sharded(cfg: PhyConfig, capture, local_addr: int, mesh: Mesh,
                           max_frames_per_block: int = 32, n_cand: int = 128,
                           use_spec: bool | None = None) -> DecodedFrames:
    """Decode one long capture f32[T] sharded over the mesh, one block a
    shard (dp * sp of them); returns DecodedFrames [n_shards *
    max_frames_per_block] with starts in the whole capture, on the mesh's
    first device.

    With ``use_spec`` (by default where ``spec_decode.spec_supported_cfg``
    holds) it takes the speculative route, :func:`sharded_spec_run`; when a
    shard of it is not ``ok``, or for another configuration, every shard's
    window goes through the exact scan (``decode_capture`` with its valid
    length, start cursor and ``scan_limit=block``) under the same seam
    fixpoint.  Both routes equal the sequential exact scan frame for frame;
    the slots differ (the exact route leaves failed attempts as empty
    slots)."""
    if use_spec is None:
        use_spec = spec_decode.spec_supported_cfg(cfg)
    if use_spec and spec_decode.spec_supported_cfg(cfg):
        res, ok, _ = sharded_spec_run(cfg, capture, local_addr, mesh, max_frames_per_block,
                                      n_cand)
        if bool(ok.all()):
            return res
    devices = mesh.flat
    sw = shard_windows(capture, mesh, halo_size(cfg))
    wins = [None] * len(devices)
    for idx, group in sw.groups.values():
        for j, i in enumerate(idx):
            wins[i] = group[j]
    res = _exact_fixpoint(cfg, wins, sw.vlens, sw.block, local_addr, max_frames_per_block)
    frames = {}
    for i, r in enumerate(res):
        with on_device(devices[i]):
            base = torch.tensor([i * sw.block], dtype=torch.int32, device=devices[i])
            mine = _mask_mine(DecodedFrames(*(f[None] for f in r)), sw.block, base)
        frames[i] = DecodedFrames(*(f[0] for f in mine))
    return _assemble(frames, len(devices), devices[0])
