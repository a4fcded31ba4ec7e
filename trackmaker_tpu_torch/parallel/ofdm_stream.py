"""Sharded decode of one long capture of OFDM frames over a device mesh
(counterpart of ``trackmaker_tpu/parallel/ofdm_stream.py``).

OFDM frames (v2 and adaptive) do not consume into each other: each is
found by its chirp's normalized correlation and demodulated alone.  So the
sharded decode is one pass, with no seam fixpoint: the capture splits
into one block a shard, each shard's window adds a halo of its right
neighbour's head wide enough to finish a frame whose chirp starts on the
block's last sample, and each shard keeps the frames whose chirp starts
inside its own block.  A frame across a seam is decoded once, by the shard
that holds its first sample.  Shards on one device find their preambles
and demodulate as one batch.
"""

from __future__ import annotations

import numpy as np
import torch

from trackmaker_tpu_torch.core.framing import Frame
from trackmaker_tpu_torch.parallel.mesh import Mesh, on_device
from trackmaker_tpu_torch.parallel.stream import shard_windows
from trackmaker_tpu_torch.phy.ofdm import find_preambles
from trackmaker_tpu_torch.phy.ofdm_v2 import OfdmV2Config, demodulate_at_v2


def _demod_fn(cfg: OfdmV2Config):
    """Adaptive configurations demodulate with their loading's demapper."""
    from trackmaker_tpu_torch.phy.ofdm_adaptive import (OfdmAdaptiveConfig,
                                                        demodulate_at_adaptive)
    if isinstance(cfg, OfdmAdaptiveConfig):
        return demodulate_at_adaptive
    return demodulate_at_v2


def ofdm_halo_size(cfg: OfdmV2Config, n_bits: int) -> int:
    """Samples a shard needs past its block to finish a frame whose chirp
    starts on the block's last sample, with the Schmidl-Cox search's
    slack."""
    return cfg.frame_samples(n_bits) + cfg.preamble_len + 64


def _frames(bits: np.ndarray) -> list[Frame]:
    return [f for row in bits if (f := Frame.from_bits(row)) is not None]


def decode_ofdm_blocked_sharded(cfg: OfdmV2Config, capture, frame_bytes_len: int, mesh: Mesh,
                                max_frames_per_block: int = 16) -> list[Frame]:
    """Decode one long capture f32[T] (a tensor or a NumPy array) of
    equal-length OFDM frames sharded over the mesh (dp * sp shards in one
    ring, as the line-coded decode folds them); returns the frames in
    capture order, each CRC-checked by ``Frame.from_bits``.

    When a shard's block would be shorter than the halo, or the mesh holds
    one shard, the mesh's first device decodes the whole capture at once,
    as JAX does."""
    n_bits = frame_bytes_len * 8
    devices = mesh.flat
    n = len(devices)
    t = capture.shape[-1]
    halo = ofdm_halo_size(cfg, n_bits)
    demod = _demod_fn(cfg)
    k = max_frames_per_block
    if -(-t // n) < halo or n == 1:
        lead = devices[0]
        x = (capture if isinstance(capture, torch.Tensor)
             else torch.from_numpy(np.ascontiguousarray(capture, np.float32)))
        x = x.to(device=lead, dtype=torch.float32)
        with on_device(lead):
            starts = find_preambles(cfg, x, k * n)
            starts = starts[starts >= 0]
            if starts.numel() == 0:
                return []
            return _frames(demod(cfg, x, n_bits, starts).cpu().numpy())

    sw = shard_windows(capture, mesh, halo)
    block = sw.block
    bits_all, gstart_all = [], []
    for dev, (idx, wins) in sw.groups.items():
        with on_device(dev):
            starts = find_preambles(cfg, wins, k)                     # [S, k]
            # the shard whose block holds a chirp's first sample decodes it
            mine = (starts >= 0) & (starts < block)
            bits = demod(cfg, wins, n_bits, torch.where(mine, starts, 0))
            base = torch.tensor(idx, dtype=starts.dtype, device=dev)[:, None] * block
            gstart = torch.where(mine, starts + base, -1)
            bits_all.append(bits.reshape(-1, n_bits).cpu().numpy())
            gstart_all.append(gstart.reshape(-1).cpu().numpy())
    bits = np.concatenate(bits_all)
    gstarts = np.concatenate(gstart_all)
    order = [i for i in np.argsort(gstarts, kind="stable") if gstarts[i] >= 0]
    return _frames(bits[order])
