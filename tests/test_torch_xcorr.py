"""The port's correlation (trackmaker_tpu_torch.sync) against the JAX
package's: the plain sliding sums, and the correlation kernel's plain
version against ``pallas_xcorr_hits`` / ``pallas_normalized_xcorr`` run in
interpret mode.  The JAX references run once per module (fixtures).

Tolerances: the two sides sum in a different order, so correlations agree
within atol 1e-5.  Hit positions and counts must be equal; each corpus
first checks that no lag lies within 1e-4 of the 0.9 threshold, where a
sum order could move a lag across it."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trackmaker_tpu.core.config import PhyConfig as JaxPhyConfig
from trackmaker_tpu.phy.line_coding import preamble_waveform as jax_preamble
from trackmaker_tpu.sync import correlate as jcorrelate
from trackmaker_tpu.sync.pallas_xcorr import (
    pallas_normalized_xcorr,
    pallas_xcorr_hits,
)
from trackmaker_tpu_torch import PhyConfig
from trackmaker_tpu_torch.core.framing import Frame
from trackmaker_tpu_torch.phy.encoder import PhyEncoder
from trackmaker_tpu_torch.sync import auto_xcorr, correlate
from trackmaker_tpu_torch.sync.xcorr_hits import xcorr_hits, xcorr_hits_plain

CFG = PhyConfig()
PRE = jax_preamble(JaxPhyConfig())
THR = 0.9
ATOL = 1e-5
MARGIN = 1e-4
BIGI = 2**30


def _corpus() -> np.ndarray:
    """Three noisy captures of a few frames each, 6000 samples."""
    rng = np.random.default_rng(11)
    enc = PhyEncoder(CFG, device="cpu")
    rows = []
    for r in range(3):
        frames = [Frame.new_data(i, 1, 2, rng.integers(0, 256, 10 + 7 * i + r,
                                                       dtype=np.uint8).tobytes())
                  for i in range(3)]
        wave = enc.encode_frames(frames, gap_samples=150 + 40 * r).numpy()
        cap = np.zeros(6000, np.float32)
        cap[300 + 50 * r: 300 + 50 * r + len(wave)] = wave
        cap += rng.normal(0, 0.03 * (r + 1), cap.shape).astype(np.float32)
        rows.append(cap)
    rows[2][5000:] = 0.0       # a silent tail: low-energy windows give 0
    return np.stack(rows)


@pytest.fixture(scope="module")
def corpus():
    x = _corpus()
    want_corr, want_rows = jax.vmap(lambda s: pallas_xcorr_hits(
        s, PRE, THR, interpret=True, emit_corr=True))(jnp.asarray(x))
    dense = jax.vmap(lambda s: pallas_normalized_xcorr(s, PRE, interpret=True))(
        jnp.asarray(x))
    return x, np.asarray(want_corr), np.asarray(want_rows), np.asarray(dense)


def test_corpus_has_no_lag_at_the_threshold(corpus):
    x, want_corr, _, _ = corpus
    corr, _ = xcorr_hits_plain(torch.from_numpy(x), PRE, THR, emit_corr=True)
    assert not np.any(np.abs(corr.numpy() - THR) < MARGIN)
    assert not np.any(np.abs(want_corr - THR) < MARGIN)
    assert np.sum(corr.numpy() >= THR) >= 9       # the corpus does have hits


def _check_rows(got: np.ndarray, want: np.ndarray) -> None:
    r = got.shape[-2]
    np.testing.assert_array_equal(got[..., :5], want[..., :r, :5])
    np.testing.assert_array_equal(got[..., 9:], want[..., :r, 9:])
    np.testing.assert_allclose(got[..., 5:9].view(np.float32),
                               want[..., :r, 5:9].view(np.float32), rtol=0, atol=ATOL)
    # the JAX kernel pads to whole lag blocks; its extra rows are empty
    extra = want[..., r:, :]
    assert np.all(extra[..., :4] == BIGI) and np.all(extra[..., 4:] == 0)


def test_xcorr_hits_plain_matches_pallas_kernel(corpus):
    x, want_corr, want_rows, _ = corpus
    corr, rows = xcorr_hits_plain(torch.from_numpy(x), PRE, THR, emit_corr=True)
    assert rows.shape == (3, math.ceil(x.shape[1] / 128), 16)
    assert rows.dtype == torch.int32
    np.testing.assert_allclose(corr.numpy(), want_corr, rtol=0, atol=ATOL)
    _check_rows(rows.numpy(), want_rows)
    none, rows2 = xcorr_hits(torch.from_numpy(x), PRE, THR)
    assert none is None and torch.equal(rows2, rows)


def test_dense_corr_matches_pallas_normalized_xcorr(corpus):
    x, _, _, dense = corpus
    got = auto_xcorr(torch.from_numpy(x), PRE)
    np.testing.assert_allclose(got.numpy(), dense, rtol=0, atol=ATOL)
    one = auto_xcorr(torch.from_numpy(x[1]), PRE)
    np.testing.assert_allclose(one.numpy(), dense[1], rtol=0, atol=ATOL)
    assert np.all(got.numpy()[2, 5000:] == 0.0)


def test_sliding_sums_match_jax_correlate():
    rng = np.random.default_rng(12)
    x = rng.normal(0, 1, (2, 700)).astype(np.float32)
    x[1, 100:300] = 0.0
    p = rng.normal(0, 1, 37).astype(np.float32)
    xt, pt = torch.from_numpy(x), torch.from_numpy(p)
    np.testing.assert_allclose(
        correlate.sliding_dot(xt, pt).numpy(),
        np.asarray(jcorrelate.sliding_dot(jnp.asarray(x), jnp.asarray(p))), atol=1e-4)
    np.testing.assert_allclose(
        correlate.sliding_energy(xt, 37).numpy(),
        np.asarray(jcorrelate.sliding_energy(jnp.asarray(x), 37)), atol=1e-4)
    np.testing.assert_allclose(
        correlate.normalized_xcorr(xt, pt).numpy(),
        np.asarray(jcorrelate.normalized_xcorr(jnp.asarray(x), jnp.asarray(p))),
        atol=ATOL)
    assert correlate.preamble_energy(p) == jcorrelate.preamble_energy(p)


def test_lag_at_the_threshold_agrees_within_tolerance():
    """A window built to correlate at 0.9 (to float precision) with the
    preamble: the two sides may put it on either side of the threshold,
    but their correlations agree within the tolerance."""
    rng = np.random.default_rng(13)
    p = PRE.astype(np.float64)
    q = rng.normal(0, 1, p.shape)
    q -= (q @ p) / (p @ p) * p                        # orthogonal to p
    q *= np.linalg.norm(p) / np.linalg.norm(q)
    a, c = 1.0, np.sqrt(1 / THR**2 - 1)               # corr = a / sqrt(a^2 + c^2)
    x = np.zeros(1024, np.float32)
    x[400:496] = (a * p + c * q).astype(np.float32)
    corr, rows = xcorr_hits_plain(torch.from_numpy(x[None]), PRE, THR, emit_corr=True)
    want_corr, want_rows = pallas_xcorr_hits(jnp.asarray(x), PRE, THR, interpret=True)
    got = corr.numpy()[0]
    assert abs(got[400] - THR) < 1e-6
    np.testing.assert_allclose(got, np.asarray(want_corr), rtol=0, atol=ATOL)
    assert abs(rows.numpy()[0, 3, 4] - np.asarray(want_rows)[3, 4]) <= 1


def test_row_overflow_counts_and_order():
    """A low threshold puts far more than four hits in a row: column 4
    keeps the true count and columns 0..3 the first four, ascending."""
    rng = np.random.default_rng(14)
    x = rng.normal(0, 1, (1, 2000)).astype(np.float32)
    corr, rows = xcorr_hits_plain(torch.from_numpy(x), PRE, 0.05, emit_corr=True)
    hit = np.pad(corr.numpy()[0] >= 0.05, (0, 16 * 128 - corr.shape[1]))
    hit = hit.reshape(16, 128)
    r = rows.numpy()[0]
    np.testing.assert_array_equal(r[:, 4], hit.sum(-1))
    assert r[:, 4].max() > 4
    for i in range(16):
        lags = np.nonzero(hit[i])[0][:4] + 128 * i
        np.testing.assert_array_equal(r[i, :len(lags)], lags)
        assert np.all(r[i, len(lags):4] == BIGI)
        np.testing.assert_array_equal(r[i, 5:5 + len(lags)].view(np.float32),
                                      corr.numpy()[0, lags])
    _, want = pallas_xcorr_hits(jnp.asarray(x[0]), PRE, 0.05, interpret=True)
    np.testing.assert_array_equal(r[:, :5], np.asarray(want)[:16, :5])


def test_wrapper_checks_its_inputs():
    with pytest.raises(ValueError):
        xcorr_hits(torch.zeros(50), PRE, THR)                  # not [B, T]
    with pytest.raises(ValueError):
        xcorr_hits(torch.zeros((1, 50)), PRE, THR)             # shorter than L
    with pytest.raises(ValueError):
        xcorr_hits(torch.zeros((1, 500), dtype=torch.float64), PRE, THR)
