"""The port's spans (trackmaker_tpu_torch/utils/trace.py) on the CPU.

With no profiler recording, ``span`` hands out one shared no-op context
and makes no record function; inside a ``torch.profiler`` session it
records.  A profiled decode (the kernels' plain versions, on CPU tensors)
opens every ``tm.entry.*``, ``tm.glue.*`` and ``tm.kernel.*`` span of its
path inside ``tm.entry.decode``, a ``tm.exact.row`` span a row the exact
scan decodes, and a ``tm.kernel.spec_walk`` span a seam-fixpoint walk."""

import contextlib
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from trackmaker_tpu_torch.core.config import FOUR_B_FIVE_B, MANCHESTER, PhyConfig
from trackmaker_tpu_torch.core.framing import Frame
from trackmaker_tpu_torch.parallel import stream
from trackmaker_tpu_torch.phy import decoder
from trackmaker_tpu_torch.phy import spec_decode as sd
from trackmaker_tpu_torch.phy.encoder import PhyEncoder
from trackmaker_tpu_torch.utils import trace
from trackmaker_tpu_torch.utils.trace import span

LOCAL = 2


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread while this module runs: the suite runs a worker per
    core, and torch's own thread pool on top of that oversubscribes them."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _captures(coding: str, rows: int, t: int, gap: int = 300, seed: int = 0) -> torch.Tensor:
    """f32[rows, t]: frames to node 2 back to back from sample 100, every
    third to node 3, under a little noise."""
    cfg = PhyConfig(line_coding=coding)
    enc = PhyEncoder(cfg, device="cpu")
    rng = np.random.default_rng(seed)
    x = rng.normal(0.0, 0.02, (rows, t)).astype(np.float32)
    for r in range(rows):
        pos, seq = 100, 0
        while True:
            payload = bytes(rng.integers(0, 256, 20 + 9 * seq, dtype=np.uint8))
            w = enc.encode_frame(Frame.new_data(seq, 1, 3 if seq % 3 == 2 else LOCAL,
                                                payload)).numpy()
            if pos + len(w) > t:
                break
            x[r, pos: pos + len(w)] += w
            pos, seq = pos + len(w) + gap, seq + 1
    return torch.from_numpy(x)


def _spans(prof) -> list[tuple[str, float, float]]:
    return [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
            if e.name.startswith("tm.")]


def test_span_off_is_one_shared_null_context(monkeypatch):
    def no_record(name):
        raise AssertionError(f"a record function for {name} with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", no_record)
    first = span("tm.test.a")
    assert isinstance(first, contextlib.nullcontext)
    assert span("tm.test.b") is first is trace._OFF
    with span("tm.test.c"):
        pass


def test_span_records_inside_a_session():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        s = span("tm.test.recorded")
        assert isinstance(s, torch.profiler.record_function)
        with s:
            torch.zeros(3).add_(1)
    assert [name for name, _, _ in _spans(prof)] == ["tm.test.recorded"]
    assert span("tm.test.after") is trace._OFF


def test_spanned_call_is_a_span_with_the_locals_released_inside():
    """A decorated call is one span, and its locals are released before
    the span ends (a local's finalizer opens a span inside it)."""
    class Local:
        def __del__(self):
            with span("tm.test.released"):
                pass

    @trace.spanned("tm.test.call")
    def work(a, b=2):
        """Adds."""
        keep = Local()  # noqa: F841 -- released at the return
        return a + b

    assert work.__name__ == "work" and work.__doc__ == "Adds."
    assert work(1) == 3
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert work(1, b=5) == 6
    (call, c0, c1), (rel, r0, r1) = sorted(_spans(prof), key=lambda e: e[1])
    assert (call, rel) == ("tm.test.call", "tm.test.released")
    assert c0 <= r0 and r1 <= c1


GLUE = ["tm.glue.spec", "tm.glue.upload", "tm.glue.compact_hits", "tm.glue.epilogue",
        "tm.glue.compact", "tm.glue.ok"]


@pytest.mark.parametrize("fold", [False, True], ids=["legacy", "fold"])
@pytest.mark.parametrize("coding", [MANCHESTER, FOUR_B_FIVE_B])
def test_decode_fast_opens_every_span_of_its_path(monkeypatch, coding, fold):
    monkeypatch.setattr(sd, "SYNC_FOLD", fold)
    cfg = PhyConfig(line_coding=coding)
    x = _captures(coding, rows=3, t=12_000)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = decoder.decode_capture_fast(cfg, x, LOCAL, max_frames=16)
    assert int(res.valid.sum()) > 0
    got = _spans(prof)
    count = Counter(name for name, _, _ in got)
    attempt = "attempt_manchester" if coding == MANCHESTER else "attempt_4b5b"
    kernels = (["tm.kernel.xcorr_hits_refine", f"tm.kernel.{attempt}_fold"] if fold
               else ["tm.kernel.xcorr_hits", f"tm.kernel.{attempt}"])
    kernels.append("tm.kernel.spec_walk")
    want = {"tm.entry.decode": 1, "tm.entry.ok_sync": 1, **{g: 1 for g in GLUE},
            "tm.glue.upload": 3, **{k: 1 for k in kernels}}
    assert dict(count) == want
    (_, start, end), = [s for s in got if s[0] == "tm.entry.decode"]
    assert all(start <= s and e <= end for _, s, e in got)


def test_fallback_rows_each_open_an_exact_row_span(monkeypatch):
    """Rows flagged not ok by the speculative decode go to the exact scan,
    a tm.exact.row span each, after tm.entry.ok_sync and inside
    tm.entry.decode."""
    cfg = PhyConfig(line_coding=MANCHESTER)
    x = _captures(MANCHESTER, rows=4, t=12_000, seed=1)
    spec = sd.decode_capture_spec

    def flag_rows_1_and_3(*args, **kwargs):
        res, ok = spec(*args, **kwargs)
        return res, ok & torch.tensor([True, False, True, False])

    monkeypatch.setattr(sd, "decode_capture_spec", flag_rows_1_and_3)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        decoder.decode_capture_fast(cfg, x, LOCAL, max_frames=16)
    got = _spans(prof)
    rows = [s for s in got if s[0] == "tm.exact.row"]
    (_, start, end), = [s for s in got if s[0] == "tm.entry.decode"]
    (_, _, synced), = [s for s in got if s[0] == "tm.entry.ok_sync"]
    assert len(rows) == 2
    assert all(synced <= s and e <= end and start <= s for _, s, e in rows)


def test_decode_captures_opens_a_span_a_row():
    cfg = PhyConfig(line_coding=MANCHESTER)
    x = _captures(MANCHESTER, rows=3, t=6_000, seed=2)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = decoder.decode_captures(cfg, x, LOCAL, 8, [6_000] * 3)
    assert int(res.valid.sum()) > 0
    assert Counter(name for name, _, _ in _spans(prof))["tm.exact.row"] == 3


@pytest.mark.parametrize("n_blocks", [2, 5])
def test_blocked_decode_walks_a_kernel_span_a_fixpoint_turn(n_blocks):
    """One capture, frames back to back across the seams: the fixpoint
    runs more than one walk, and each is a tm.kernel.spec_walk span."""
    cfg = PhyConfig(line_coding=MANCHESTER)
    x = _captures(MANCHESTER, rows=1, t=40_000, gap=48, seed=3)[0]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res, ok, turns = stream.decode_blocked_spec(cfg, x, LOCAL, n_blocks, 16)
    assert bool(ok) and int(res.valid.sum()) > 0 and turns > 1
    count = Counter(name for name, _, _ in _spans(prof))
    assert count["tm.kernel.spec_walk"] == turns
