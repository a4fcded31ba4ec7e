"""The port's sync-refine fold against the JAX package's, on the CPU.

The fold moves the speculative decode's per-candidate sync refine out of
the attempt kernels into the correlation kernel (``xcorr_hits_refine``);
the attempt kernels' fold forms decode from the frame starts it found.
The corpora are those of tests/test_sync_fold.py for both line codes:
three noisy 50,000-sample captures of random frames, and one frame whose
refine window the valid length trims, from not at all to every position
(the fallback, a cut added here), as the rows of one batch.  JAX runs the Pallas kernels
in interpret mode at blk=8192, the port the kernels' plain versions.

Tolerances: the hit rows' integer columns (positions, counts, refine
deltas) are exactly equal on the rows both produce, and JAX's extra padded
rows hold no hit; the correlation at each hit agrees within 1e-5 (sum
order).  That rests on two margins the rows test asserts: no lag of a
corpus lies within 1e-4 of the threshold, and wherever a hit is refined,
its best two refine positions differ by more than 1e-5.  The decodes' ok
flags, cursors and valid-masked frames are exactly equal, the correlation
at each frame within 1e-5; the port's fold and legacy decodes are equal in
every field, since both refines add the same way."""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trackmaker_tpu.core.config import FOUR_B_FIVE_B, MANCHESTER
from trackmaker_tpu.core.config import PhyConfig as JaxPhyConfig
from trackmaker_tpu.core.framing import Frame
from trackmaker_tpu.oracle.phy import OracleEncoder
from trackmaker_tpu.phy import pallas_decode as pd
from trackmaker_tpu.phy.line_coding import preamble_waveform as jax_preamble
from trackmaker_tpu.sync.pallas_xcorr import pallas_xcorr_hits_refine
from trackmaker_tpu_torch import convert
from trackmaker_tpu_torch.phy import spec_decode as sd
from trackmaker_tpu_torch.sync.correlate import preamble_energy
from trackmaker_tpu_torch.sync.xcorr_hits import (
    xcorr_hits_plain,
    xcorr_hits_refine,
    xcorr_hits_refine_plain,
)
from trackmaker_tpu_torch.sync.xcorr_norm import normalized_xcorr_dense_plain

BIGI = 2**30
CODINGS = (MANCHESTER, FOUR_B_FIVE_B)
CASES = [(coding, corpus) for coding in CODINGS for corpus in ("random", "boundary")]
CASE_IDS = [f"{coding}-{corpus}" for coding, corpus in CASES]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread while this module runs: the suite runs a worker per
    core, and torch's own thread pool on top of that oversubscribes them."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _random_corpus(cfg) -> np.ndarray:
    """tests/test_sync_fold.py:test_fold_matches_legacy_random's captures."""
    enc = OracleEncoder(cfg)
    rng = np.random.default_rng(11)
    t = 50_000
    caps = []
    for _ in range(3):
        x = np.zeros(t, np.float32)
        pos = int(rng.integers(0, 1500))
        for k in range(4):
            data = bytes(rng.integers(0, 256, int(rng.integers(1, 48)), dtype=np.uint8))
            wav = np.asarray(enc.encode_frame(
                Frame.new_data(sequence=k, src=1, dst=2, data=data)), np.float32)
            if pos + len(wav) > t:
                x[pos:] += wav[: t - pos]
                break
            x[pos: pos + len(wav)] += wav
            pos += len(wav) + int(rng.integers(0, 700))
        x += rng.normal(0, 0.05, t).astype(np.float32)
        caps.append(x)
    return np.stack(caps)


def _boundary_corpus(cfg) -> tuple[np.ndarray, np.ndarray]:
    """tests/test_sync_fold.py:test_fold_capture_end_boundary's captures:
    one frame at 300, its valid length cut back by each amount, a row each.
    Its last cut leaves a few refine positions valid; one more cut here
    leaves none, the fallback."""
    wav = np.asarray(OracleEncoder(cfg).encode_frame(
        Frame.new_data(sequence=1, src=1, dst=2, data=b"edge-case!")), np.float32)
    t, lead = 12_000, 300
    sync_off = cfg.preamble_len - cfg.sync_len - cfg.sync_margin
    cuts = [0, 1, 5, 40, 90, 100, 110, len(wav) - cfg.preamble_len + 3,
            len(wav) - (sync_off + cfg.sync_len - 1)]
    x = np.zeros((len(cuts), t), np.float32)
    x[:, lead: lead + len(wav)] = wav
    return x, np.asarray([lead + len(wav) - c for c in cuts], np.int32)


def _corpus(coding: str, corpus: str):
    """(JAX config, port config, captures, valid lengths, max_frames, n_cand)."""
    jcfg = JaxPhyConfig(line_coding=coding)
    cfg = convert.phy_config_from_fields(dataclasses.asdict(jcfg))
    if corpus == "random":
        x = _random_corpus(jcfg)
        return jcfg, cfg, x, np.full(len(x), x.shape[1], np.int32), 8, 64
    x, vlen = _boundary_corpus(jcfg)
    return jcfg, cfg, x, vlen, 4, 32


def _refine_kw(cfg) -> dict:
    return dict(sync_off=cfg.preamble_len - cfg.sync_len - cfg.sync_margin,
                n_pos=2 * cfg.sync_margin + 1, sync_len=cfg.sync_len,
                fall_off=cfg.preamble_len)


@pytest.fixture(scope="module")
def jax_runs():
    """Per case: the corpus, JAX's refine rows and JAX's fold decode."""
    out = {}
    old = pd.SYNC_FOLD
    pd.SYNC_FOLD = True
    try:
        for coding, corpus in CASES:
            jcfg, cfg, x, vlen, mf, n_cand = _corpus(coding, corpus)
            pre = jax_preamble(jcfg)
            rows = pallas_xcorr_hits_refine(
                jnp.asarray(x), jnp.asarray(vlen), pre, pre[jcfg.preamble_len - jcfg.sync_len:],
                jcfg.correlation_threshold, blk=8192, interpret=True, **_refine_kw(jcfg))
            dec = pd.decode_capture_spec(jcfg, jnp.asarray(x), 2, max_frames=mf, n_cand=n_cand,
                                         valid_len=jnp.asarray(vlen), interpret=True,
                                         with_cursor=True)
            out[coding, corpus] = (cfg, x, vlen, mf, n_cand, np.asarray(rows),
                                   jax.tree_util.tree_map(np.asarray, dec))
    finally:
        pd.SYNC_FOLD = old
    return out


def _refine_cc(x: np.ndarray, vlen: int, hit: int, sync: np.ndarray, sync_off: int,
               n_pos: int) -> np.ndarray:
    """The refine's cc of each position of one hit, in float64 (-inf where
    the valid length trims it)."""
    w = len(sync)
    s = sync.astype(np.float64)
    cc = np.full(n_pos, -np.inf)
    for k in range(n_pos):
        p = hit + sync_off + k
        if p > vlen - w:
            continue
        win = np.zeros(w)
        seg = x[p:p + w].astype(np.float64)
        win[:len(seg)] = seg
        en = float(win @ win)
        cc[k] = float(win @ s) / (np.sqrt(en) * np.sqrt(s @ s)) if en > 1e-6 else 0.0
    return cc


@pytest.mark.parametrize("coding,corpus", CASES, ids=CASE_IDS)
def test_refine_rows_match_jax(jax_runs, coding, corpus):
    cfg, x, vlen, _, _, want, _ = jax_runs[coding, corpus]
    pre = jax_preamble(JaxPhyConfig(line_coding=coding))
    sync = pre[cfg.preamble_len - cfg.sync_len:]
    thr = cfg.correlation_threshold
    kw = _refine_kw(cfg)
    corr = normalized_xcorr_dense_plain(torch.from_numpy(x), pre).numpy()
    assert np.abs(corr - thr).min() > 1e-4

    got = xcorr_hits_refine_plain(torch.from_numpy(x), torch.from_numpy(vlen), pre, sync,
                                  thr, **kw).numpy()
    n_rows = -(-x.shape[1] // 128)
    assert got.shape == (x.shape[0], n_rows, 16)
    ints = np.r_[0:5, 9:16]
    np.testing.assert_array_equal(got[..., ints], want[:, :n_rows, ints])
    np.testing.assert_allclose(got[..., 5:9].view(np.float32),
                               want[:, :n_rows, 5:9].view(np.float32), atol=1e-5)
    assert np.all(want[:, n_rows:, :4] == BIGI) and np.all(want[:, n_rows:, 4] == 0)

    # the margins, and what the corpus exercises
    hits = got[..., :4] < BIGI
    fallback = trimmed = 0
    for b, r, k in zip(*np.nonzero(hits)):
        cc = _refine_cc(x[b], int(vlen[b]), int(got[b, r, k]), sync, kw["sync_off"],
                        kw["n_pos"])
        top = np.sort(cc[np.isfinite(cc)])[::-1]
        assert len(top) < 2 or top[0] - top[1] > 1e-5, (b, r, k, top[:2])
        fallback += len(top) == 0
        trimmed += 0 < len(top) < kw["n_pos"]
        assert got[b, r, 9 + k] == (kw["fall_off"] if len(top) == 0
                                    else kw["sync_off"] + int(np.argmax(cc)) + kw["sync_len"])
    assert hits.sum() >= (3 if corpus == "boundary" else 10)
    if corpus == "boundary":
        assert fallback > 0 and trimmed > 0
    np.testing.assert_array_equal(got[..., 9:13][~hits], kw["fall_off"])


def _frames(res, row):
    f = {k: np.asarray(v)[row] for k, v in res._asdict().items()}
    return [(f["frame_bytes"][k, :7 + int(f["length"][k])].tobytes(),
             *(int(f[n][k]) for n in ("length", "frame_type", "sequence", "src", "dst",
                                      "start")))
            for k in np.nonzero(f["valid"])[0]]


def _decode(cfg, x, vlen, mf, n_cand):
    return sd.decode_capture_spec(cfg, torch.from_numpy(x), 2, max_frames=mf, n_cand=n_cand,
                                  valid_len=torch.from_numpy(vlen), with_cursor=True)


@pytest.mark.parametrize("coding,corpus", CASES, ids=CASE_IDS)
def test_fold_decode_matches_jax_and_legacy(jax_runs, monkeypatch, coding, corpus):
    cfg, x, vlen, mf, n_cand, _, (want, want_ok, want_searched, want_cur) = \
        jax_runs[coding, corpus]
    calls = []

    def refine_spy(*args, **kw):
        calls.append(1)
        return xcorr_hits_refine(*args, **kw)

    monkeypatch.setattr(sd, "xcorr_hits_refine", refine_spy)
    monkeypatch.setattr(sd, "SYNC_FOLD", True)
    fold = _decode(cfg, x, vlen, mf, n_cand)
    assert calls == [1]
    res, ok, searched, cur = fold
    np.testing.assert_array_equal(ok.numpy(), want_ok)
    np.testing.assert_array_equal(searched.numpy(), want_searched)
    np.testing.assert_array_equal(cur.numpy(), want_cur)
    for r in range(x.shape[0]):
        assert _frames(res, r) == _frames(want, r), r
        np.testing.assert_allclose(res.corr.numpy()[r][res.valid.numpy()[r]],
                                   want.corr[r][want.valid[r]], atol=1e-5)
    assert sum(len(_frames(res, r)) for r in range(x.shape[0])) >= (
        6 if corpus == "random" else 1)

    monkeypatch.setattr(sd, "SYNC_FOLD", "0")
    legacy = _decode(cfg, x, vlen, mf, n_cand)
    assert calls == [1]
    for g, w in zip(jax.tree_util.tree_leaves(fold), jax.tree_util.tree_leaves(legacy)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("coding,corpus", CASES, ids=CASE_IDS)
def test_fold_attempts_match_legacy(jax_runs, coding, corpus):
    """The refine rows' frame starts are the legacy attempt's, and the fold
    attempts given the legacy starts decode what the legacy attempts do."""
    cfg, x, vlen, _, n_cand, _, _ = jax_runs[coding, corpus]
    pre = jax_preamble(JaxPhyConfig(line_coding=coding))
    sync = pre[cfg.preamble_len - cfg.sync_len:]
    xt, vt = torch.from_numpy(x), torch.from_numpy(vlen)
    _, rows = xcorr_hits_plain(xt, pre, cfg.correlation_threshold)
    cand, corr, n_valid, overflow = sd.compact_hit_rows(rows, n_cand)
    rows_f = xcorr_hits_refine_plain(xt, vt, pre, sync, cfg.correlation_threshold,
                                        **_refine_kw(cfg))
    assert torch.equal(rows_f[..., :9], rows[..., :9])
    *table, fs = sd.compact_hit_rows(rows_f, n_cand, with_fs=True)
    for g, w in zip(table, (cand, corr, n_valid, overflow)):
        assert torch.equal(g, w)

    attempt, fold_plain = ((sd.attempt_manchester_plain, sd.attempt_manchester_fold_plain)
                           if coding == MANCHESTER
                           else (sd.attempt_4b5b_plain, sd.attempt_4b5b_fold_plain))
    legacy = attempt(xt, cand, n_valid, vt, sync, preamble_energy(sync))
    assert torch.equal(fs, legacy[1])
    assert int(sd._live(cand, n_valid).sum()) >= (3 if corpus == "boundary" else 12)
    fold = fold_plain(xt, legacy[1], n_valid)
    for g, w in zip(fold, legacy):
        assert torch.equal(g, w)


@pytest.mark.parametrize("setting,fold", [("auto", False), ("0", False), ("1", True),
                                          (True, True), (False, False)])
def test_sync_fold_resolution(monkeypatch, setting, fold):
    monkeypatch.setattr(sd, "SYNC_FOLD", setting)
    assert sd._resolve_fold() is fold


def test_sync_fold_reads_the_environment():
    code = ("from trackmaker_tpu_torch.phy import spec_decode as sd; "
            "print(repr(sd.SYNC_FOLD), sd._resolve_fold())")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    seen = []
    for value in ("1", None):
        env = {k: v for k, v in os.environ.items() if k != "TM_SYNC_FOLD"}
        if value is not None:
            env["TM_SYNC_FOLD"] = value
        out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                             env=env, cwd=root, timeout=120, check=True)
        seen.append(out.stdout.strip())
    assert seen == ["'1' True", "'auto' False"]
