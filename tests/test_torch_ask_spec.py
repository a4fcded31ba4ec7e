"""The port's ASK receivers (trackmaker_tpu_torch.phy.ask_spec and the exact
scan of phy/ask.py) against the JAX package's, on the CPU, with the plain
versions of kernels 9 (fire rule), 10 (record chain) and 11 (walk) against
the Pallas kernels in interpret mode.

The corpus is that of tests/test_ask_spec.py: a clean track, noisy tracks
of seeds 0-2, zero gaps, four truncations, degenerate captures (silence,
noise, a lone chirp) and the clean track that test checks against the
oracle.  Every capture is brought to one length T, so that each JAX
reference compiles once: a capture is followed by silence, and a truncated
track is preceded by silence so that it still ends where it was cut.  T is
a multiple of 512, where the block index's clip of a cursor past the end
reads a real sample.

Tolerances: none.  Fire candidates, candidate tables, successor fields,
walks, ``ok`` flags and every decoded field (valid, frame_id, bits, start)
are exactly equal.  They can be, because the dense arrays they decide on
agree to within 2e-6 and no lag of the corpus lies within 1e-5 of an
update threshold where the other condition holds, and no bit sum of a
fired slot within 1e-3 of 0 (unless exactly 0, where both sides agree);
``test_corpus_margins`` asserts both."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trackmaker_tpu.oracle import ask as oracle_ask
from trackmaker_tpu.phy import ask as jask
from trackmaker_tpu.phy import ask_spec as jspec
from trackmaker_tpu.phy.pallas_decode import _extract_candidates
from trackmaker_tpu_torch import convert
from trackmaker_tpu_torch.phy import ask, ask_spec

JCFG = jask.AskConfig()
CFG = convert.ask_config_from_fields(dataclasses.asdict(JCFG))
T = 45_056            # 88 blocks of 512
MF = 16
N_CAND = 96
MARGIN = 1e-5



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread while this module runs: the suite runs a worker per
    core, and torch's own thread pool on top of that oversubscribes the
    cores, where its many small ops then wait on each other."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)

def _corpus() -> dict[str, np.ndarray]:
    def fit(wave):
        assert len(wave) <= T
        return np.pad(np.asarray(wave, np.float32), (0, T - len(wave)))

    caps = {}
    frames = ask.build_frames(b"spec path hello", CFG, num_frames=8)
    caps["clean"] = fit(ask.build_track(CFG, frames, seed=5))
    for seed in (0, 1, 2):
        rng = np.random.default_rng(seed)
        frames = ask.build_frames(b"noise differential", CFG, num_frames=6)
        wave = ask.build_track(CFG, frames, seed=seed)
        caps[f"noisy{seed}"] = fit(wave + rng.normal(0, 0.05, len(wave)).astype(np.float32))
    frames = ask.build_frames(b"zero gap", CFG, num_frames=5)
    caps["zero_gaps"] = fit(ask.build_track(CFG, frames, gaps=np.zeros((5, 2), np.int64)))
    frames = ask.build_frames(b"truncate me", CFG, num_frames=4)
    wave = ask.build_track(CFG, frames, seed=3)
    for cut in (1000, 3000, 4700, 5200):
        w = wave[:len(wave) - cut]
        caps[f"cut{cut}"] = np.concatenate([np.zeros(T - len(w), np.float32), w])
    caps["silence"] = np.zeros(T, np.float32)
    caps["noise"] = np.random.default_rng(9).normal(0, 0.2, T).astype(np.float32)
    caps["lone_chirp"] = fit(np.concatenate([np.zeros(500, np.float32), ask._chirp_np(CFG),
                                             np.zeros(7000, np.float32)]))
    frames = ask.build_frames(b"oracle check", CFG, num_frames=5)
    gaps = np.random.default_rng(8).integers(0, 100, size=(5, 2))
    caps["oracle"] = fit(ask.build_track(CFG, frames, gaps=gaps))
    return caps


CORPUS = _corpus()
NAMES = list(CORPUS)
X = np.stack([CORPUS[n] for n in NAMES])


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@jax.jit
def _jax_analyze(x):
    """The JAX receiver's steps 1-3 for every row, as demodulate_spec runs them."""
    def one(row):
        power, sync, upd_ok = jask.dense_arrays(JCFG, row)
        hits = jspec.dense_fire_candidates(JCFG, sync, upd_ok, interpret=True)
        cand, n_valid, overflow = _extract_candidates(hits, N_CAND, rpb=8)
        cand_full = jnp.concatenate([jnp.full((1,), -(JCFG.frame_samples + 1), jnp.int32), cand])
        fields, _ = jspec._phase_b(JCFG, row, power, sync, upd_ok, cand_full, 512,
                                   interpret=True)
        return hits, cand, n_valid, overflow, fields
    return jax.vmap(one)(x)


@pytest.fixture(scope="module")
def jax_ref():
    xj = jnp.asarray(X)
    exact = [_np(jask.demodulate(JCFG, xj[r], max_frames=MF)) for r in range(len(NAMES))]
    spec, ok = _np(jspec.demodulate_spec_jit(JCFG, xj, max_frames=MF, interpret=True))
    small, small_ok = _np(jspec.demodulate_spec_jit(JCFG, xj, max_frames=MF, n_cand=2,
                                                    interpret=True))
    return dict(exact=exact, spec=spec, ok=ok, small=small, small_ok=small_ok,
                analyze=_np(_jax_analyze(xj)))


def _assert_rows_equal(got, want, row: int, want_row=None, what: str = "") -> None:
    for name, g, w in zip(ask.AskDecoded._fields, got, want):
        w = w if want_row is None else w[want_row]
        np.testing.assert_array_equal(g[row].numpy() if row is not None else g.numpy(), w,
                                      err_msg=f"{what} {name}")


@pytest.mark.parametrize("name", NAMES)
def test_exact_scan_matches_jax(jax_ref, name):
    r = NAMES.index(name)
    got = ask.demodulate(CFG, torch.from_numpy(X[r]), max_frames=MF)
    _assert_rows_equal(got, jax_ref["exact"][r], None, what=name)


def test_spec_steps_match_jax(jax_ref):
    """Fire candidates, the candidate table and the successor fields."""
    hits_j, cand_j, n_valid_j, overflow_j, fields_j = jax_ref["analyze"]
    x = torch.from_numpy(X)
    power, sync, upd_ok = ask.dense_arrays(CFG, x)
    hits = ask_spec.dense_fire_candidates(CFG, sync, upd_ok)
    np.testing.assert_array_equal(hits.numpy(), hits_j)
    cand, n_valid, overflow = ask_spec.extract_candidates(hits, N_CAND)
    np.testing.assert_array_equal(cand.numpy(), cand_j)
    np.testing.assert_array_equal(n_valid.numpy(), n_valid_j)
    np.testing.assert_array_equal(overflow.numpy(), overflow_j)
    virt = torch.full((len(NAMES), 1), -(CFG.frame_samples + 1), dtype=torch.int32)
    fields = ask_spec.phase_b(CFG, x, power, sync, upd_ok, torch.cat([virt, cand], 1))
    np.testing.assert_array_equal(fields.numpy(), fields_j)
    assert int(n_valid.max()) >= 8 and int(fields[:, 1].sum()) >= 40


def test_spec_matches_jax(jax_ref):
    """All four fields and ok, every row; the ok rows equal the exact scan
    slot for slot."""
    res, ok = ask_spec.demodulate_spec(CFG, torch.from_numpy(X), max_frames=MF)
    np.testing.assert_array_equal(ok.numpy(), jax_ref["ok"])
    for r, name in enumerate(NAMES):
        _assert_rows_equal(res, jax_ref["spec"], r, want_row=r, what=name)
        if ok[r]:
            _assert_rows_equal(res, jax_ref["exact"][r], r, what=f"{name} vs exact")
    counts = dict(zip(NAMES, res.count.tolist()))
    assert counts["clean"] == 8 and counts["zero_gaps"] == 5 and counts["oracle"] == 5
    assert all(counts[f"noisy{s}"] == 6 for s in range(3))
    assert counts["silence"] == counts["noise"] == counts["lone_chirp"] == 0
    assert [counts[f"cut{c}"] for c in (1000, 3000, 4700, 5200)] == [3, 3, 3, 3]
    frames = ask.build_frames(b"spec path hello", CFG, num_frames=8)
    clean = NAMES.index("clean")
    np.testing.assert_array_equal(res.bits[clean][res.valid[clean]].numpy(), frames[:, 8:])
    want = oracle_ask.demodulate(X[NAMES.index("oracle")])
    row = NAMES.index("oracle")
    assert res.frame_id[row][res.valid[row]].tolist() == [fid for fid, _ in want]
    for bits, (_, wbits) in zip(res.bits[row][res.valid[row]].numpy(), want):
        np.testing.assert_array_equal(bits, wbits)


def test_corpus_margins():
    """The update thresholds and the bit sums of the fired slots keep clear
    of the ulps the port's sum order can move them by."""
    x = torch.from_numpy(X)
    power, sync, _ = (a.numpy() for a in ask.dense_arrays(CFG, x))
    a = sync - CFG.sync_power_factor * power
    b = sync - CFG.sync_abs_threshold
    assert not ((np.abs(a) <= MARGIN) & (b > -MARGIN)).any()
    assert not ((np.abs(b) <= MARGIN) & (a > -MARGIN)).any()
    res, _ = ask_spec.demodulate_spec(CFG, x, max_frames=MF)
    peaks = torch.where(res.valid, res.start, 0)
    ds, dc = ask.demod_dense(CFG, x)
    sums = ask.dense_bit_sums(CFG, ds, dc, peaks)[res.valid].numpy()
    assert len(sums) >= 40
    assert ((sums == 0) | (np.abs(sums) > 1e-3)).all()


def test_batch_rows_independent():
    res, ok = ask_spec.demodulate_spec(CFG, torch.from_numpy(X), max_frames=MF)
    for r in (0, 1, 5, 8, 10, len(NAMES) - 1):
        solo, solo_ok = ask_spec.demodulate_spec(CFG, torch.from_numpy(X[r:r + 1]), max_frames=MF)
        assert bool(solo_ok[0]) == bool(ok[r])
        for name, g, w in zip(res._fields, solo, res):
            assert torch.equal(g[0], w[r]), (NAMES[r], name)


def test_overflow_flagged_like_jax(jax_ref):
    """With a table of 2 candidates the rows holding more overflow, exactly
    where JAX's do, and every field of every row equals JAX's."""
    res, ok = ask_spec.demodulate_spec(CFG, torch.from_numpy(X), max_frames=MF, n_cand=2)
    np.testing.assert_array_equal(ok.numpy(), jax_ref["small_ok"])
    assert not ok[NAMES.index("clean")] and ok[NAMES.index("silence")]
    for r, name in enumerate(NAMES):
        _assert_rows_equal(res, jax_ref["small"], r, want_row=r, what=name)


def test_demodulate_fast_merges_fallback_rows(jax_ref, monkeypatch):
    """Rows the speculative receiver flags (forced by a 2-candidate table)
    are decoded again by the exact scan; every row equals JAX's exact scan."""
    rows = [NAMES.index(n) for n in ("clean", "noisy1", "cut4700", "silence")]
    got = ask.demodulate_fast(CFG, torch.from_numpy(X[rows]), max_frames=MF)
    for i, r in enumerate(rows):
        _assert_rows_equal(got, jax_ref["exact"][r], i, what=NAMES[r])
    orig = ask_spec.demodulate_spec
    flags = []

    def tiny(cfg, xb, max_frames=128):
        res, ok = orig(cfg, xb, max_frames=max_frames, n_cand=2)
        flags.append(ok.tolist())
        return res, ok

    monkeypatch.setattr(ask_spec, "demodulate_spec", tiny)
    got = ask.demodulate_fast(CFG, torch.from_numpy(X[rows]), max_frames=MF)
    assert flags == [[False, False, False, True]]
    for i, r in enumerate(rows):
        _assert_rows_equal(got, jax_ref["exact"][r], i, what=NAMES[r])
    one = ask.demodulate_fast(CFG, torch.from_numpy(X[rows[0]]), max_frames=MF)
    _assert_rows_equal(one, jax_ref["exact"][rows[0]], None, what="unbatched")


@pytest.mark.parametrize("t", [202, 511, 512, 513, 1000, 4096 + 200, 40_000])
def test_fire_plain_matches_pallas_and_naive(t):
    """Kernel 9's plain version against the Pallas kernel in interpret mode
    and the naive rule, at the lengths of
    tests/test_ask_spec.py::test_dense_fire_sliding_max_vs_naive."""
    w = CFG.peak_guard + 1
    rng = np.random.default_rng(17 + t)
    sync = rng.normal(0, 1, t).astype(np.float32)
    upd = rng.random(t) < 0.3
    masked = np.where(upd, sync, -np.inf)
    padded = np.concatenate([masked, np.full(w + 1, -np.inf)])
    fwd = np.lib.stride_tricks.sliding_window_view(padded[1:], w)[:t].max(-1)
    naive = upd & (masked >= fwd)
    got = ask_spec.dense_fire_candidates(CFG, torch.from_numpy(sync)[None],
                                         torch.from_numpy(upd)[None])[0].numpy()
    np.testing.assert_array_equal(got, naive)
    want = np.asarray(jspec._fire_kernel_call(JCFG, jnp.asarray(sync), jnp.asarray(upd),
                                              interpret=True))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("win", [512, 1024])
def test_chain_plain_matches_pallas(win):
    """Kernel 10's plain version against the Pallas kernel in interpret mode
    on the rows of tests/test_ask_spec.py::test_chain_kernel_vs_scan: ties,
    all-masked rows, single updates, fires at the guard boundary."""
    rng = np.random.default_rng(31 + win)
    for _ in range(4):
        c1 = 13
        vals = np.full((c1, win), -np.inf, np.float32)
        mask = rng.random((c1, win)) < 0.05
        vals[mask] = rng.normal(1, 0.5, mask.sum()).astype(np.float32)
        vals[3, 40] = vals[3, 60] = np.float32(2.5)
        vals[4, :] = -np.inf
        vals[5, :] = -np.inf
        vals[5, 7] = 1.0
        vals[6, :] = -np.inf
        vals[6, 10], vals[6, 211], vals[6, 212] = 3.0, 1.0, 1.0   # fires exactly at the guard
        base = rng.integers(0, 1 << 20, c1).astype(np.int32)
        fired, peak = ask.ask_chain(torch.from_numpy(vals), torch.from_numpy(base), CFG.peak_guard)
        fired_j, peak_j = jspec._chain_kernel_call(jnp.asarray(vals), jnp.asarray(base), win,
                                                   CFG.peak_guard, interpret=True)
        np.testing.assert_array_equal(fired.numpy(), np.asarray(fired_j))
        np.testing.assert_array_equal(peak.numpy(), np.asarray(peak_j))
        assert not fired[4] and int(peak[4]) == -(2**30)
        assert fired[5] and int(peak[5]) == int(base[5]) + 7     # a lone update fires too
        assert fired[6] and int(peak[6]) == int(base[6]) + 10


@pytest.mark.parametrize("max_frames", [1, 5, 72])
def test_walk_plain_matches_pallas(max_frames):
    """Kernel 11's plain version against the Pallas kernel in interpret mode
    on random successor tables."""
    rng = np.random.default_rng(max_frames)
    b, c1 = 6, 97
    fields = np.stack([rng.random((b, c1)) < 0.95, rng.random((b, c1)) < 0.95,
                       rng.random((b, c1)) < 0.95, rng.integers(-5, 400_000, (b, c1)),
                       rng.integers(-1, c1, (b, c1)), rng.random((b, c1)) < 0.03],
                      axis=1).astype(np.int32)
    fields[0, 4] = np.minimum(np.arange(c1) + 1, c1 - 1)        # a long clean chain
    fields[0, :3] = 1
    fields[0, 5] = 0
    got = ask_spec.ask_walk(torch.from_numpy(fields), max_frames)
    want = jspec._walk(jnp.asarray(fields), max_frames, interpret=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(got[1][0].sum()) == max_frames and not got[2][0]


@pytest.mark.parametrize("n_cand", [4, 96, 400])
def test_extract_candidates_matches_jax(n_cand):
    rng = np.random.default_rng(n_cand)
    hits = rng.random((3, 20_000)) < 0.004
    hits[1, 1024:1024 + 9] = True                  # 9 hits in one block: overflow
    hits[2] = False
    hits[2, [0, 511, 512, 19_999]] = True
    cand, n_valid, overflow = ask_spec.extract_candidates(torch.from_numpy(hits), n_cand)
    want = _extract_candidates(jnp.asarray(hits), n_cand, rpb=8)
    for g, w in zip((cand, n_valid, overflow), want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert bool(overflow[1])
