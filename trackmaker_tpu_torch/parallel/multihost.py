"""Multi-process bring-up for batch decode across hosts (counterpart of
``trackmaker_tpu/parallel/multihost.py``).

Batch decode is data-parallel over recordings, so many processes (on one
host or many) each decode the captures they hold, and the results stay in
the process that decoded them: no collective is on the decode path.  The
only traffic between processes is the bring-up, a check that every
process passes the same shapes, and the closing barrier.  So the default
backend is gloo, which moves those few integers on the host and lets two
processes share one card (NCCL refuses two ranks on one GPU).

Every process calls :func:`init_distributed` with the same coordinator
address and its own process id; :func:`global_dp_mesh` is then the job's
data-parallel mesh as this process sees it, and
:func:`decode_captures_multihost` decodes this process's rows on its own
devices.  ``python -m trackmaker_tpu_torch.tools.multihost_dryrun`` runs
it end to end.
"""

from __future__ import annotations

import datetime
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from trackmaker_tpu_torch.parallel.mesh import Mesh, batch_sharded_decode, make_mesh

TIMEOUT_S = 90       # bring-up and every collective give up after this long
_local_devices: int | None = None


def init_distributed(coordinator: str, num_processes: int, process_id: int,
                     local_device_count: int | None = None, backend: str = "gloo") -> None:
    """Join the job at `coordinator` (``host:port`` or a ``tcp://`` address)
    as process `process_id` of `num_processes`; the process then decodes on
    its first `local_device_count` cards (by default every visible one).
    A second call in a process that has joined does nothing."""
    global _local_devices
    if dist.is_initialized():
        return
    address = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(backend, init_method=address, world_size=num_processes,
                            rank=process_id, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    _local_devices = local_device_count


@dataclass(frozen=True)
class ProcessMesh:
    """The job's data-parallel mesh as one process sees it: the process's
    own devices (`local`, one dp axis) among `process_count` processes."""

    process_count: int
    process_index: int
    local: Mesh

    @property
    def shape(self) -> dict[str, int]:
        return {"dp": self.process_count * self.local.shape["dp"]}


def global_dp_mesh(devices=None) -> ProcessMesh:
    """One data-parallel axis over every device of every process; this
    process addresses the part on its own `devices` (by default its cards,
    as :func:`init_distributed` counted them)."""
    if devices is None and _local_devices is not None:
        devices = [torch.device("cuda", i) for i in range(_local_devices)]
    local = make_mesh(devices=devices)
    return ProcessMesh(dist.get_world_size(), dist.get_rank(), local)


def decode_captures_multihost(cfg, local_captures, local_addr: int, max_frames: int = 64,
                              devices=None):
    """Decode this process's captures f32[B_local, T] as its part of the
    job's batch (every process's rows in process order); returns the
    DecodedFrames of the local rows, in this process.  Every process must
    pass the same shapes: they are compared first, and a mismatch raises
    in every process."""
    mesh = global_dp_mesh(devices)
    shape = torch.tensor(np.shape(local_captures), dtype=torch.int64)
    shapes = [torch.zeros_like(shape) for _ in range(mesh.process_count)]
    dist.all_gather(shapes, shape)
    if any(not torch.equal(s, shape) for s in shapes):
        raise ValueError(f"the processes' captures differ in shape: "
                         f"{[tuple(s.tolist()) for s in shapes]}")
    return batch_sharded_decode(cfg, local_captures, local_addr, mesh.local,
                                max_frames=max_frames)


def finalize_distributed() -> None:
    """The closing barrier, then leave the job."""
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()
