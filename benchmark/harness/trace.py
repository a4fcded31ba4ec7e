"""What a traced stretch of the window leaves: device and host events.

``Trace`` reads a ``torch.profiler`` session over whole requests, between
the start and the end of the harness's ``bench.window`` span, into plain
lists of (name, start, end) in seconds: device kernels, device copies and
fills, the host's CUDA runtime calls and the host's other events (operator
calls and the harness's spans).  The per-layer readers take their numbers
from it.
"""

from __future__ import annotations

import heapq
import re
from collections import defaultdict
from pathlib import Path

from harness import stats

WINDOW_SPAN = "bench.window"
TOP = 10
PROFILER_EVENTS = ("Activity Buffer Request",)   # the profiler's own host work
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
              "cudaMemcpy", "cuStreamSynchronize", "cuCtxSynchronize", "cuEventSynchronize")
_GLOBAL = re.compile(r"__global__\s+(?:void\s+)?(?:__launch_bounds__\s*\([^)]*\)\s*)?"
                     r"(?:void\s+)?(\w+)\s*\(", re.S)


def port_kernel_names(package_dir: Path) -> set[str]:
    """The names of the program's own CUDA kernels: every ``__global__``
    function of the sources under its package directory."""
    names = set()
    for src in sorted(package_dir.rglob("*.cu*")):
        names.update(_GLOBAL.findall(src.read_text(errors="replace")))
    return names


def kernel_matches(event_name: str, kernel: str) -> bool:
    """Whether a device event's (demangled) name is a launch of `kernel`."""
    return re.search(rf"(?<!\w){re.escape(kernel)}(?!\w)", event_name) is not None


class Trace:
    def __init__(self, events, requests: int):
        """`events`: the profiler's FunctionEvents; `requests`: the
        requests whose whole work lies inside the window span."""
        self.requests = requests
        self.kernels, self.copies, self.runtime, self.host = [], [], [], []
        window = None
        for e in events:
            s, t = e.time_range.start * 1e-6, e.time_range.end * 1e-6
            if e.name == WINDOW_SPAN:
                if not _is_device(e):
                    window = (s, t)
            elif e.name in PROFILER_EVENTS:
                continue
            elif _is_device(e):
                if getattr(e, "is_user_annotation", False):
                    continue   # a span's copy on the device's timeline is no work
                (self.copies if e.name.startswith(("Memcpy", "Memset")) else self.kernels).append(
                    (e.name, s, t))
            elif e.name.startswith("cu"):
                self.runtime.append((e.name, s, t))
            else:
                self.host.append((e.name, s, t))
        if window is None:
            raise RuntimeError(f"the trace holds no {WINDOW_SPAN} span")
        self.start, self.stop = window
        inside = lambda ev: [x for x in ev if x[1] < self.stop and x[2] > self.start]  # noqa: E731
        self.kernels, self.copies = inside(self.kernels), inside(self.copies)
        self.runtime, self.host = inside(self.runtime), inside(self.host)

    @property
    def window_s(self) -> float:
        return self.stop - self.start

    def busy_s(self) -> float:
        """Seconds of the window in which a kernel or a copy ran."""
        return stats.union_seconds([(max(s, self.start), min(t, self.stop))
                                    for _, s, t in self.kernels + self.copies])

    def syncs(self) -> int:
        """Host calls that wait for the device: synchronizations and
        blocking copies."""
        return sum(1 for name, _, _ in self.runtime if name in SYNC_CALLS)

    def device_seconds(self, kernel: str) -> tuple[float, int]:
        """(device seconds, launches) of the kernel named `kernel`."""
        mine = [t - s for name, s, t in self.kernels if kernel_matches(name, kernel)]
        return sum(mine), len(mine)

    def breakdown(self) -> dict:
        """The device operations that took most time, and the longest
        idle gaps summed by what the host was doing in them (its innermost
        event at the gap's middle)."""
        by_op = defaultdict(float)
        for name, s, t in self.kernels + self.copies:
            by_op[name[:120]] += t - s
        idle = stats.gaps([(s, t) for _, s, t in self.kernels + self.copies],
                          self.start, self.stop)
        by_host = defaultdict(float)
        host = sorted(self.host + self.runtime, key=lambda ev: ev[1])
        active, j = [], 0
        for s, t in sorted(idle, key=lambda g: (g[0] + g[1]) / 2):
            mid = (s + t) / 2
            while j < len(host) and host[j][1] <= mid:
                heapq.heappush(active, (host[j][2], host[j][1], host[j][0]))
                j += 1
            while active and active[0][0] < mid:
                heapq.heappop(active)
            label = (min(active, key=lambda a: a[0] - a[1])[2] if active
                     else "(host: Python between operators)")
            by_host[label[:120]] += t - s
        top = lambda d: sorted(([k, v] for k, v in d.items()), key=lambda kv: -kv[1])[:TOP]  # noqa: E731
        return {"device_ops": top(by_op), "idle_gaps": top(by_host)}


def _is_device(e) -> bool:
    kind = getattr(e, "device_type", None)
    return kind is not None and getattr(kind, "name", str(kind)).upper().endswith("CUDA")
