"""The readers of the program's spans (``harness/spans.py`` and the four
``program_span`` metrics) on a hand-built trace: two requests, glue spans
with a kernel span and a glue span nested in them, waits for the device
inside and outside the decode call, and the exact scan's rows."""

from types import SimpleNamespace

import pytest

import run
from harness import manifest, spans
from harness.trace import Trace

SPAN_METRICS = ("glue_host_ms", "wrapper_host_ms", "program_sync_ms",
                "fallback_rows_per_request")


def event(name, start_ms, end_ms):
    """A profiler event on the host, times in ms (the profiler's are us)."""
    return SimpleNamespace(name=name, device_type=None,
                           time_range=SimpleNamespace(start=start_ms * 1e3, end=end_ms * 1e3))


PROGRAM = [
    # request 1
    ("tm.entry.decode", 0, 10),
    ("tm.glue.upload", 0.5, 1.0), ("cudaStreamSynchronize", 0.7, 0.8),
    ("tm.kernel.xcorr_hits", 1.0, 1.5), ("cudaLaunchKernel", 1.1, 1.2),
    ("cudaMemcpyAsync", 1.3, 1.35),
    ("tm.glue.epilogue", 2, 5), ("aten::copy_", 4.4, 4.8), ("cudaMemcpy", 4.5, 4.7),
    ("tm.kernel.spec_walk", 3, 4), ("cudaStreamSynchronize", 3.2, 3.3),
    ("tm.entry.ok_sync", 6, 7), ("cudaStreamSynchronize", 6.2, 6.6),
    ("tm.exact.row", 7, 8),
    ("cudaStreamSynchronize", 9.95, 10.05),    # half inside the decode call
    ("cudaStreamSynchronize", 10.1, 10.5),     # the harness's readback
    # request 2
    ("tm.entry.decode", 20, 30),
    ("tm.glue.compact", 21, 23), ("tm.glue.ok", 22, 22.5),
    ("tm.kernel.attempt_manchester", 24, 25),
    ("tm.exact.row", 26, 27), ("tm.exact.row", 27, 28),
    ("cudaStreamSynchronize", 30.1, 30.4),
]
WINDOW = [("bench.window", -1, 31), ("tm.exact.row", 40, 41)]   # the last span after the window

# by hand, ms over 2 requests:
# glue: [0.5, 1] + [2, 5] + [21, 23] = 5.5, less the wait [0.7, 0.8], the
#   kernel span [3, 4] (its wait inside) and the wait [4.5, 4.7]: 4.2
# wrappers: [1, 1.5] + [3, 4] + [24, 25] = 2.5, less the wait [3.2, 3.3]: 2.4
# waits inside the decode calls: 0.1 + 0.1 + 0.2 + 0.4 + 0.05 = 0.85
# exact-scan rows: 3
EXPECTED = {"glue_host_ms": 4.2 / 2, "wrapper_host_ms": 2.4 / 2,
            "program_sync_ms": 0.85 / 2, "fallback_rows_per_request": 3 / 2}


def context(names_times):
    trace = Trace([event(*e) for e in names_times + WINDOW], requests=2)
    return run.ReadContext(trace, works=[], port_kernels=set())


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_reader_on_a_hand_built_trace(name):
    value = manifest.module("metrics", name).read(context(PROGRAM))
    assert value == pytest.approx(EXPECTED[name], abs=1e-9)


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_reader_without_the_spans_reads_nothing(name):
    """A program that opens no span (the parent of the spans) gives no
    reading, and no error."""
    untouched = [e for e in PROGRAM if not e[0].startswith("tm.")]
    assert manifest.module("metrics", name).read(context(untouched)) is None


def test_spans_land_among_the_host_events():
    t = context(PROGRAM).trace
    assert sum(1 for n, _, _ in t.host if n.startswith("tm.")) == 13   # not the one after the window
    assert len(spans.syncs(t)) == 7


@pytest.mark.parametrize("a,b,want", [
    ([(0, 2), (1, 3)], [(2.5, 5)], [(2.5, 3)]),
    ([(0, 1), (2, 3)], [(0.5, 2.5)], [(0.5, 1), (2, 2.5)]),
    ([(0, 4)], [(1, 2), (1.5, 3)], [(1, 3)]),
    ([(0, 1)], [(1, 2)], []),
])
def test_interval_arithmetic(a, b, want):
    assert spans.intersect(a, b) == want
    assert spans.merge(a + a) == spans.merge(a)


def test_manifest_has_the_span_metrics():
    man = manifest.load()
    assert manifest.problems(man) == []
    entries = {m["name"]: m for m in man["per_layer"]}
    for name in SPAN_METRICS:
        m = entries[name]
        assert m["source"] == "program_span"
        assert m["workloads"] == ["manchester.corpus", "fourb5b.corpus"]
    assert [m["name"] for m in man["per_layer"]][-4:] == list(SPAN_METRICS)
