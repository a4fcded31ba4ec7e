"""The metric arithmetic: percentiles over all requests, interval unions,
and the roofline counts against the port's kernel table."""

import math

import pytest

from harness import roofline, stats
from harness.trace import kernel_matches, port_kernel_names


def test_percentile_linear_between_ranks():
    assert stats.percentile([1, 2, 3, 4, 5], 50) == 3
    assert stats.percentile(list(range(1, 101)), 95) == pytest.approx(95.05)
    assert stats.percentile([7.0], 95) == 7.0


def test_p95_counts_every_request_and_failures():
    lat = [0.001] * 95 + [0.010] * 5
    assert stats.request_p95_ms(lat, 0) == pytest.approx(1.45)   # 95th of 100: between ranks
    assert stats.request_p95_ms([0.001] * 90, 10) == stats.MISSING_MS
    assert stats.request_p95_ms([0.001] * 99, 1) < 10             # one failure in 100 is past p95


def test_union_and_gaps():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6)]
    assert stats.union_seconds(iv) == pytest.approx(3.0)
    assert stats.gaps(iv, 0.0, 5.0) == [(2.0, 3.0), (4.0, 5.0)]
    assert stats.gaps([], 1.0, 2.0) == [(1.0, 2.0)]
    assert stats.union_seconds([]) == 0.0


def ms(work):
    return roofline.least_seconds(*work)[0] * 1e3


# the port's kernel table (PERF.md, "Bound ms") at the flagship's shapes:
# 32 x 433,464 Manchester, 32 x 275,640 4B5B, 128 candidates
def test_xcorr_bound_at_the_flagship():
    assert ms(roofline.xcorr_hits(32, 433_464, 96)) == pytest.approx(0.0795, abs=5e-5)
    assert roofline.least_seconds(*roofline.xcorr_hits(32, 433_464, 96))[1] == "operations"


def test_attempt_bounds_at_the_flagship():
    assert ms(roofline.attempt("manchester", 32, 433_464, 128, 2048)) == pytest.approx(0.0169, abs=5e-5)
    assert ms(roofline.attempt("4b5b", 32, 275_640, 128, 2048)) == pytest.approx(0.0109, abs=5e-5)
    assert roofline.least_seconds(*roofline.attempt("manchester", 32, 433_464, 128, 2048))[1] == "bytes"


def test_walk_bound():
    assert ms(roofline.spec_walk(32, 128)) == pytest.approx(0.00002, abs=5e-6)


def test_shared_attempt_reads_only_live_windows():
    full = roofline.attempt_shared("manchester", 64, 64 * 450_048, 128, 10**6)
    few = roofline.attempt_shared("manchester", 64, 64 * 450_048, 128, 48)
    assert full[0] > few[0] > 48 * 12_624 * 4
    assert few[1] == 48 * (13 * 48 * 4 + 263 * 8 * 6)


def test_kernel_names():
    assert kernel_matches("void xcorr_hits_kernel<false>(float const*, Taps)", "xcorr_hits_kernel")
    assert not kernel_matches("xcorr_hits_kernel_b(float const*)", "xcorr_hits_kernel")
    assert not kernel_matches("void at::native::vectorized_elementwise_kernel<4>", "xcorr_hits_kernel")


def test_port_kernel_names_found():
    import trackmaker_tpu_torch
    from pathlib import Path

    names = port_kernel_names(Path(trackmaker_tpu_torch.__file__).parent)
    assert {"xcorr_hits_kernel", "attempt_manchester_kernel", "attempt_4b5b_kernel",
            "spec_walk_kernel"} <= names
    assert not any(math.isnan(len(n)) for n in names)


class _Trace:
    def __init__(self, launches, each_s):
        self.launches, self.each_s = launches, each_s

    def device_seconds(self, kernel):
        return self.launches * self.each_s, self.launches


@pytest.mark.parametrize("launches", [4, 7])
def test_roofline_share_counts_work_not_launches(launches):
    """Four requests' work over every launch's device time: a launch beyond
    the requests' own (an exact scan's dense correlation) adds time only."""
    import run

    work = roofline.xcorr_hits(32, 433_464, 96)
    least = roofline.least_seconds(*work)[0]
    works = [{"xcorr": ("xcorr_hits_kernel", *work)}] * 4
    ctx = run.ReadContext(_Trace(launches, 2 * least), works, set())
    assert ctx.roofline_share("xcorr") == pytest.approx(100.0 * 4 / (2 * launches))
    assert ctx.roofline_share("xcorr") <= 50.0
    assert run.ReadContext(_Trace(0, 1.0), works, set()).roofline_share("xcorr") is None
