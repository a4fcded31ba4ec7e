"""Arithmetic of the metrics: percentiles and interval unions."""

from __future__ import annotations

import math

MISSING_MS = 1e9   # the latency a failed request counts with: past any limit


def percentile(values: list[float], q: float) -> float:
    """The q-th percentile (0-100) of all `values`, linear between the two
    nearest ranks (NumPy's default rule); infinite values stay infinite."""
    if not values:
        raise ValueError("no values")
    a = sorted(values)
    pos = q / 100 * (len(a) - 1)
    lo = math.floor(pos)
    hi = min(lo + 1, len(a) - 1)
    if math.isinf(a[hi]) or pos == lo:
        return a[hi] if pos > lo else a[lo]
    return a[lo] + (a[hi] - a[lo]) * (pos - lo)


def request_p95_ms(latencies_s: list[float], failed: int) -> float:
    """The 95th percentile of every request's time in ms, a failed request
    counting as missing any limit."""
    p = percentile([s * 1e3 for s in latencies_s] + [math.inf] * failed, 95)
    return MISSING_MS if math.isinf(p) else p


def union_seconds(intervals: list[tuple[float, float]]) -> float:
    """The length of the union of [start, end) intervals."""
    total, end = 0.0, -math.inf
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def gaps(intervals: list[tuple[float, float]], start: float, stop: float) -> list[tuple[float, float]]:
    """The stretches of [start, stop) that no interval covers."""
    out, cur = [], start
    for s, e in sorted(intervals):
        if s > cur:
            out.append((cur, min(s, stop)))
        cur = max(cur, e)
        if cur >= stop:
            break
    if cur < stop:
        out.append((cur, stop))
    return [(s, e) for s, e in out if e > s]

