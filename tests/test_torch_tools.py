"""The port's measurement tools (trackmaker_tpu_torch.tools) against the JAX
package's: the window probe's kernel against bench.py's Pallas probe, the
two-stream correlation's plain rows against kernel #1 (``pallas_xcorr_hits``,
which the JAX tool's rows equal by construction), both in interpret mode,
and the stage profiler's stages against the port's plain attempts and
JAX's decode, on the CPU.

Tolerances: the probe's output equals JAX's bit for bit (one f32 add).
Hit positions, counts and the empty columns equal JAX's exactly, and the
correlation at each hit agrees within atol 1e-5 (the two sum in another
order; each corpus first checks that no lag lies within 1e-4 of the
threshold); against the port's own ``xcorr_hits_plain`` the rows are
equal bit for bit.  The ``noep`` form equals the truncation of JAX's dense
correlation exactly (each corpus checks that no |corr| lies within 1e-4 of
1, where truncation could change).  The attempt-only stage equals the
port's plain attempts exactly, and the full-decode stage's frames and ok
flags equal JAX's exactly."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from trackmaker_tpu.core.config import PhyConfig as JaxPhyConfig
from trackmaker_tpu.phy import pallas_decode as pd
from trackmaker_tpu.sync import correlate as jcorrelate
from trackmaker_tpu.sync.pallas_xcorr import pallas_xcorr_hits
from trackmaker_tpu_torch import PhyConfig
from trackmaker_tpu_torch.phy import line_coding
from trackmaker_tpu_torch.phy import spec_decode as sd
from trackmaker_tpu_torch.sync.correlate import preamble_energy
from trackmaker_tpu_torch.sync.xcorr_hits import xcorr_hits_plain, xcorr_hits_refine_plain
from trackmaker_tpu_torch.tools import exp_xcorr_streams as ex
from trackmaker_tpu_torch.tools import health, prof_fused

THR = 0.5
ATOL = 1e-5
MARGIN = 1e-4
BIGI = 2**30
T = 20_000
CFG = PhyConfig()
N_FRAMES, BATCH = 6, 3
STAGES = ["xcorr only", "xcorr+extract", "xcorr+refine", "phase_a", "full spec decode",
          "xcorr+extract+attempt", "phase_a+walk", "phase_a+walk+compact"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread while this module runs: the suite runs a worker per
    core, and torch's own thread pool on top oversubscribes them."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# --- the window probe (B.12) --------------------------------------------------


def _jax_probe(x: np.ndarray) -> np.ndarray:
    """bench.py:_probe_window's kernel (bench.py:200-213), in interpret mode."""
    def k(x_ref, o_ref):
        def body(i, c):
            o_ref[...] = x_ref[...] + c
            return c + 1.0
        jax.lax.fori_loop(0, 128, body, jnp.float32(0.0))

    f = pl.pallas_call(
        k,
        grid=(32,),
        in_specs=[pl.BlockSpec((8, 128), lambda i: (0, 0))],
        out_specs=pl.BlockSpec((8, 128), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((32 * 8, 128), jnp.float32),
        interpret=True,
    )
    return np.asarray(f(jnp.asarray(x)))


def test_seq_probe_plain_equals_the_jax_probe():
    x = np.random.default_rng(5).normal(0, 100, (8, 128)).astype(np.float32)
    got = health.seq_probe_plain(torch.from_numpy(x)).numpy()
    want = _jax_probe(x)
    assert got.shape == (256, 128) and got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_seq_probe_on_cpu_runs_the_plain_version():
    x = torch.from_numpy(np.random.default_rng(6).normal(0, 1, (8, 128)).astype(np.float32))
    before = health.seq_probe.launches
    assert torch.equal(health.seq_probe(x), health.seq_probe_plain(x))
    assert health.seq_probe.launches == before
    with pytest.raises(ValueError):
        health.seq_probe(torch.zeros((8, 127)))


def test_health_on_the_cpu_gives_three_positive_numbers():
    got = health.health(torch.device("cpu"))
    assert got["device"] == "cpu"
    for key in ("rtt_ms", "noop_kernel_us", "stream_gbps"):
        assert math.isfinite(got[key]) and got[key] > 0, key


# --- the two-stream correlation (B.15) ------------------------------------------


def _periodic_pattern(l: int, seed: int) -> np.ndarray:
    """A +-1 pattern of period 20: a planted copy correlates above 0.5 at
    shifts of 0, +-20, +-40 and +-60, so one copy puts more than four hits
    in a row of 128 lags."""
    period = np.sign(np.random.default_rng(seed).normal(size=20)).astype(np.float32)
    return np.tile(period, -(-l // 20))[:l]


def _planted(pattern: np.ndarray) -> np.ndarray:
    """Three noisy captures of T samples: copies of the pattern in several
    rows, one ending at the capture's end (a hit at the last lag), and a
    silent tail in the last capture."""
    rng = np.random.default_rng(len(pattern))
    x = rng.normal(0, 0.05, (3, T)).astype(np.float32)
    l = len(pattern)
    for r, starts in enumerate(([300, 2000, 7000], [128 * 40 + 5, 11_111], [500])):
        for s in starts:
            x[r, s:s + l] += pattern
    x[0, T - l:] += pattern
    x[2, 15_000:] = 0.0
    return x


def _corpora():
    noise = np.random.default_rng(7).normal(0, 1, (2, T)).astype(np.float32)
    noise_pattern = np.sign(np.random.default_rng(1).normal(size=96)).astype(np.float32)
    out = {"noise_L96": (noise, noise_pattern)}
    for l in (96, 129):
        pattern = _periodic_pattern(l, seed=l)
        out[f"planted_L{l}"] = (_planted(pattern), pattern)
    return out


@pytest.fixture(scope="module")
def streams_ref():
    """name -> (captures, pattern, JAX hit rows, JAX dense corr)."""
    out = {}
    for name, (x, pattern) in _corpora().items():
        _, rows = jax.vmap(lambda s: pallas_xcorr_hits(
            s, pattern, THR, rpb=4, emit_corr=False, interpret=True))(jnp.asarray(x))
        corr, _ = jax.vmap(lambda s: pallas_xcorr_hits(
            s, pattern, THR, rpb=4, emit_corr=True, interpret=True))(jnp.asarray(x))
        out[name] = (x, pattern, np.asarray(rows), np.asarray(corr))
    return out


CORPORA = ["noise_L96", "planted_L96", "planted_L129"]


@pytest.mark.parametrize("name", CORPORA)
def test_xcorr_hits_2s_plain_rows_match_kernel_1(streams_ref, name):
    x, pattern, want, want_corr = streams_ref[name]
    assert not np.any(np.abs(want_corr - THR) < MARGIN)
    rows = ex.xcorr_hits_2s_plain(torch.from_numpy(x), pattern, THR)
    n_rows = math.ceil(T / 128)
    assert rows.shape == (x.shape[0], n_rows, 16) and rows.dtype == torch.int32
    got = rows.numpy()
    np.testing.assert_array_equal(got[..., :5], want[:, :n_rows, :5])
    np.testing.assert_array_equal(got[..., 9:], want[:, :n_rows, 9:])
    np.testing.assert_allclose(got[..., 5:9].view(np.float32),
                               want[:, :n_rows, 5:9].view(np.float32), rtol=0, atol=ATOL)
    # JAX's rows past ceil(T/128), whole lag blocks of padding, are empty
    assert np.all(want[:, n_rows:, :4] == BIGI) and np.all(want[:, n_rows:, 4:] == 0)
    counts = got[..., 4]
    if name.startswith("noise"):
        assert counts.sum() == 0
    else:
        assert (counts > 0).sum() >= 8 and counts.max() > 4
        assert want_corr[0, -1] >= THR                     # a hit at the last lag
    assert torch.equal(ex.xcorr_hits_2s(torch.from_numpy(x), pattern, THR), rows)
    if len(pattern) <= 128:       # kernel #1's plain version takes at most 128 taps
        assert torch.equal(rows, xcorr_hits_plain(torch.from_numpy(x), pattern, THR)[1])


@pytest.mark.parametrize("name", CORPORA)
def test_xcorr_hits_2s_noep_plain_truncates_kernel_1s_corr(streams_ref, name):
    x, pattern, _, want_corr = streams_ref[name]
    assert not np.any(np.abs(np.abs(want_corr) - 1.0) < MARGIN)
    got = ex.xcorr_hits_2s_plain(torch.from_numpy(x), pattern, THR, epilogue=False).numpy()
    n_rows = math.ceil(T / 128)
    assert got.shape == (x.shape[0], n_rows, 16) and got.dtype == np.int32
    lags = np.pad(want_corr, ((0, 0), (0, n_rows * 128 - want_corr.shape[1])))
    want = lags.reshape(x.shape[0], n_rows, 128)[..., :16].astype(np.int32)
    np.testing.assert_array_equal(got, want)


def test_noep_plain_places_and_truncates_each_lane():
    """Exact copies of a +-1 pattern of L samples in silence correlate to
    +-L / (sqrt(L) * ||p||), rounded in f32 as the JAX package's
    ``correlate.normalized_xcorr`` divides: exactly +-1 at L = 64, where
    sqrt(64) is exact, so lanes 0..15 of their rows hold +-1; at L = 96 the
    quotient is 0.99999994, which truncates to 0, as JAX's does.  Lanes
    past the last lag hold 0."""
    for l, one in ((64, 1), (96, 0)):
        pattern = np.sign(np.random.default_rng(3).normal(size=l)).astype(np.float32)
        x = np.zeros((1, 2020), np.float32)
        x[0, 128 * 2 + 5:128 * 2 + 5 + l] = pattern
        x[0, 128 * 9 + 15:128 * 9 + 15 + l] = -pattern
        want = np.asarray(jcorrelate.normalized_xcorr(
            jnp.asarray(x[0]), jnp.asarray(pattern), jcorrelate.preamble_energy(pattern)))
        assert int(want[128 * 2 + 5]) == one and int(want[128 * 9 + 15]) == -one
        got = ex.xcorr_hits_2s_plain(torch.from_numpy(x), pattern, THR, epilogue=False).numpy()[0]
        assert got[2, 5] == one and got[9, 15] == -one
        got[2, 5] = got[9, 15] = 0
        assert not got.any()
        assert (2020 - l + 1) % 128 != 0      # the last row has lanes past the last lag


@pytest.mark.parametrize("l", [1, 130])
def test_xcorr_hits_2s_refuses_pattern_lengths(l):
    x = torch.zeros((1, 1000))
    with pytest.raises(ValueError):
        ex.xcorr_hits_2s(x, np.ones(l, np.float32), THR)
    with pytest.raises(ValueError):
        ex.xcorr_hits_2s_plain(x, np.ones(l, np.float32), THR, epilogue=False)


def test_two_streams_are_the_tool_s_streams():
    x = torch.from_numpy(np.random.default_rng(9).normal(0, 1, (2, 3000)).astype(np.float32))
    xp, xs = ex.two_streams(x)
    assert xp.shape == xs.shape == (2, 3072)
    assert torch.equal(xp[:, :3000], x) and not xp[:, 3000:].any()
    assert torch.equal(xs[:, :3000 - 128], x[:, 128:]) and not xs[:, 3000 - 128:].any()


# --- the stage profiler (B.16) --------------------------------------------------


@pytest.fixture(scope="module")
def corpus():
    frames, x = prof_fused.build_corpus(CFG, "cpu", n_frames=N_FRAMES, batch=BATCH)
    vlens = torch.full((BATCH,), x.shape[1], dtype=torch.int32)
    return frames, x, vlens


def _tensors(out):
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for item in out for t in _tensors(item)]


def test_every_stage_runs_on_cpu_tensors(corpus):
    _, x, vlens = corpus
    assert x.shape[1] <= 50_000
    got = prof_fused.stages(CFG, x, vlens)
    assert list(got) == STAGES
    for name, fn in got.items():
        out = _tensors(fn(x))
        assert out and all(t.device.type == "cpu" for t in out), name
    four = prof_fused.stages(PhyConfig(line_coding="4b5b"), x, vlens)
    assert list(four) == [s for s in STAGES if s != "xcorr+extract+attempt"]


@pytest.mark.parametrize("fold", [False, True])
def test_attempt_sum_is_the_plain_attempt_on_the_compacted_candidates(corpus, fold):
    _, x, vlens = corpus
    pre = line_coding.preamble_waveform(CFG)
    sync = pre[48:]
    thr = CFG.correlation_threshold
    got = prof_fused.attempt_sum(CFG, x, vlens, fold)
    if fold:
        rows = xcorr_hits_refine_plain(x, vlens, pre, sync, thr, sync_off=42, n_pos=13,
                                       sync_len=48, fall_off=96)
        _, _, n_valid, _, fs = sd.compact_hit_rows(rows, 128, with_fs=True)
        want = sd.attempt_manchester_fold_plain(x, fs, n_valid)
    else:
        _, rows = xcorr_hits_plain(x, pre, thr)
        cand, _, n_valid, _ = sd.compact_hit_rows(rows, 128)
        want = sd.attempt_manchester_plain(x, cand, n_valid, vlens, sync, preamble_energy(sync))
    assert len(got) == 2
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert n_valid.tolist() == [N_FRAMES] * BATCH
    with pytest.raises(ValueError):
        prof_fused.attempt_sum(PhyConfig(line_coding="4b5b"), x, vlens, fold)


def _frames(res, row):
    f = {k: np.asarray(v)[row] for k, v in res._asdict().items()}
    return [(f["frame_bytes"][k, :7 + int(f["length"][k])].tobytes(),
             *(int(f[n][k]) for n in ("length", "frame_type", "sequence", "src", "dst", "start")))
            for k in np.nonzero(f["valid"])[0]]


def test_full_decode_stage_matches_jax(corpus):
    frames, x, vlens = corpus
    res, ok = prof_fused.stages(CFG, x, vlens)["full spec decode"](x)
    want, want_ok = pd.decode_capture_spec_jit(JaxPhyConfig(), jnp.asarray(x.numpy()), 2,
                                               max_frames=72, interpret=True)
    want = jax.tree_util.tree_map(np.asarray, want)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(want_ok))
    assert ok.all()
    for r in range(BATCH):
        got = _frames(res, r)
        assert got == _frames(want, r)
        assert [g[0][7:] for g in got] == [f.data for f in frames]
