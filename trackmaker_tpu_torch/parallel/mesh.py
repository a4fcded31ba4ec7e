"""Device meshes and the data-parallel batch decode (counterpart of
``trackmaker_tpu/parallel/mesh.py``).

A :class:`Mesh` is a (dp, sp) grid of devices in one process, as JAX's
single-controller ``Mesh`` is: `dp` is the axis over recordings, `sp` the
axis over a long capture's time (``parallel/stream.py``,
``parallel/ofdm_stream.py``).  A device may stand in the grid more than
once: the CPU tests build eight shards on ``cpu``, and a mesh of shards
on one card runs their work there.  Work that lands on one device runs as
one batch; a shard on another card is reached by a copy between cards.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import numpy as np
import torch

from trackmaker_tpu_torch.core.config import PhyConfig
from trackmaker_tpu_torch.phy.decoder import DecodedFrames, decode_capture_fast


@dataclass(frozen=True)
class Mesh:
    """A (dp, sp) grid of devices, row-major."""

    devices: tuple[tuple[torch.device, ...], ...]

    @property
    def shape(self) -> dict[str, int]:
        return {"dp": len(self.devices), "sp": len(self.devices[0])}

    @property
    def flat(self) -> list[torch.device]:
        """The devices in shard order (dp-major), dp * sp of them."""
        return [d for row in self.devices for d in row]


def make_mesh(n_devices: int | None = None, dp: int | None = None, sp: int = 1,
              devices=None) -> Mesh:
    """A (dp, sp) mesh of the first dp * sp of `devices` (by default every
    visible CUDA device; a device may be listed more than once).  Raises
    when no device is given and no card is visible."""
    if devices is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() == 0:
            raise RuntimeError("no CUDA device is visible: pass devices= to build a mesh "
                               "of other devices")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if n_devices is None:
        n_devices = len(devices)
    if dp is None:
        dp = n_devices // sp
    if dp < 1 or sp < 1 or dp * sp > len(devices):
        raise ValueError(f"a ({dp}, {sp}) mesh needs {dp * sp} devices, {len(devices)} given")
    grid = tuple(tuple(devices[r * sp:(r + 1) * sp]) for r in range(dp))
    return Mesh(grid)


def on_device(device: torch.device):
    """The context in which the kernels launch on `device`: the card's own
    (each kernel launches on the current card), nothing for the CPU."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def by_device(devices: list[torch.device]) -> dict[torch.device, list[int]]:
    """The shard indices of each distinct device, in shard order."""
    groups: dict[torch.device, list[int]] = {}
    for i, d in enumerate(devices):
        groups.setdefault(d, []).append(i)
    return groups


def _to(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)


def batch_sharded_decode(cfg: PhyConfig, captures, local_addr: int, mesh: Mesh,
                         max_frames: int = 64) -> DecodedFrames:
    """Data-parallel decode: the batch f32[B, T] (a tensor or a NumPy
    array; B divisible by the mesh's dp) splits into dp contiguous shards,
    shard r on the first device of mesh row r.  Each device decodes the
    rows of its shards, in order, with ``decode_capture_fast`` (the kernels
    on a card, their plain versions on the CPU), and the rows come back in
    batch order on the mesh's first device.

    JAX's version runs the exact scan on every row: the frames are equal
    valid-masked, and rows that take the speculative decode hold them in
    the leading slots, as ``decode_capture_fast`` documents."""
    b = captures.shape[0]
    dp = mesh.shape["dp"]
    if b % dp:
        raise ValueError(f"a batch of {b} rows does not split over dp={dp}")
    per = b // dp
    owner = [row[0] for row in mesh.devices]
    lead = owner[0]
    parts: list[DecodedFrames | None] = [None] * dp
    for dev, shards in by_device(owner).items():
        rows = np.concatenate([np.arange(s * per, (s + 1) * per) for s in shards])
        with on_device(dev):
            if len(rows) == b:   # every shard on this device: the batch as it is
                x = _to(captures, dev)
            elif isinstance(captures, torch.Tensor):
                x = _to(captures[torch.as_tensor(rows, device=captures.device)], dev)
            else:
                x = _to(np.asarray(captures)[rows], dev)
            res = decode_capture_fast(cfg, x, local_addr, max_frames=max_frames)
        for k, s in enumerate(shards):
            parts[s] = DecodedFrames(*(f[k * per:(k + 1) * per].to(lead) for f in res))
    return DecodedFrames(*(torch.cat(col) for col in zip(*parts)))
