"""The program's own spans in a trace, and the host time inside them.

The port opens ``tm.<layer>.<phase>`` record-function spans while a
profiler session records (``trackmaker_tpu_torch/utils/trace.py``); a
``Trace`` holds them among its host events, on the clock of its CUDA
runtime calls.  The readers here take unions of intervals, so a span
nested in another of its kind counts once, and time inside a nested span
of another kind, or inside a call that waits for the device, is
subtracted by intersecting unions.  A reader gives None where the trace
holds none of the spans it reads (a program without them).
"""

from __future__ import annotations

from harness.stats import union_seconds
from harness.trace import SYNC_CALLS

ENTRY = "tm.entry.decode"
GLUE = "tm.glue."
KERNEL = "tm.kernel."
EXACT_ROW = "tm.exact.row"


def spans(trace, prefix: str) -> list[tuple[float, float]]:
    """(start, end) of the host spans whose name starts with `prefix` (a
    whole name matches itself)."""
    return [(s, t) for name, s, t in trace.host if name.startswith(prefix)]


def syncs(trace) -> list[tuple[float, float]]:
    """(start, end) of the runtime calls that wait for the device."""
    return [(s, t) for name, s, t in trace.runtime if name in SYNC_CALLS]


def merge(intervals) -> list[tuple[float, float]]:
    """The union of [start, end) intervals as sorted disjoint intervals."""
    out = []
    for s, t in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], t))
        elif t > s:
            out.append((s, t))
    return out


def intersect(a, b) -> list[tuple[float, float]]:
    """The intersection of the unions of `a` and `b`, disjoint."""
    a, b = merge(a), merge(b)
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        s, t = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if t > s:
            out.append((s, t))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def host_ms_per_request(trace, prefix: str, less) -> float | None:
    """Milliseconds a request of the host inside the spans named by
    `prefix`, less the part that the intervals `less` cover; None where
    the trace holds no such span."""
    mine = spans(trace, prefix)
    if not mine:
        return None
    own = union_seconds(mine) - union_seconds(intersect(mine, less))
    return own * 1e3 / trace.requests
