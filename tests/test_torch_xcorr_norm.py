"""The port's normalized correlation at any pattern length and its row stats
(trackmaker_tpu_torch.sync.xcorr_norm, ``auto_xcorr``,
``auto_xcorr_row_stats``) against the JAX package's, on the CPU.  The JAX
side runs as its own suite runs it here: ``auto_xcorr`` and
``auto_xcorr_row_stats`` take their CPU branches, and
``pallas_normalized_xcorr`` / ``pallas_xcorr_rowstats`` run in interpret
mode (the row stats with f32 multiplicands).

Tolerances, each with its reason:
* correlations and row maxima: atol 1e-5 (the two sides add the taps in
  another order; measured below 1e-6 on values up to 1);
* row positions: equal on every row whose two largest lags differ by more
  than 1e-5 (a closer pair may resolve either way under another sum
  order); ties of exactly equal values take the first lag on both sides;
* ``auto_xcorr`` at L <= 128: exactly the correlation kernel's dense
  output, as before long patterns were routed elsewhere."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trackmaker_tpu.core.config import FOUR_B_FIVE_B
from trackmaker_tpu.core.config import PhyConfig as JaxPhyConfig
from trackmaker_tpu.phy.line_coding import preamble_waveform as jax_preamble
from trackmaker_tpu.sync import auto_xcorr as jax_auto_xcorr
from trackmaker_tpu.sync import auto_xcorr_row_stats as jax_row_stats
from trackmaker_tpu.sync.pallas_xcorr import pallas_normalized_xcorr, pallas_xcorr_rowstats
from trackmaker_tpu_torch.dsp.osc import chirp_np
from trackmaker_tpu_torch.sync import auto_xcorr, auto_xcorr_row_stats
from trackmaker_tpu_torch.sync.xcorr_hits import xcorr_hits, xcorr_hits_plain
from trackmaker_tpu_torch.sync.xcorr_norm import (
    normalized_xcorr_dense,
    normalized_xcorr_dense_plain,
    xcorr_rowstats,
    xcorr_rowstats_plain,
)

ATOL = 1e-5
CHIRP = chirp_np(440)
NO_ROW = np.float32(-3.4e38)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread while this module runs: the suite runs a worker per
    core, and torch's own thread pool on top of that oversubscribes them."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _captures(pattern: np.ndarray, t: int, starts, seed: int) -> np.ndarray:
    """Two noisy captures with `pattern` at `starts` (row 1 shifted by 37
    and scaled by 0.5), row 1 silent over its last 1500 samples."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 0.2, (2, t)).astype(np.float32)
    for s in starts:
        x[0, s:s + len(pattern)] += pattern
        x[1, s + 37:s + 37 + len(pattern)] += 0.5 * pattern
    x[1, -1500:] = 0.0
    return x


def _top_two(v: np.ndarray) -> tuple[float, float]:
    s = np.sort(v)[::-1]
    return float(s[0]), float(s[1]) if len(s) > 1 else -math.inf


def _check_row_stats(corr: np.ndarray, rowmax, rowpos, want_max, want_pos) -> int:
    """rowmax within ATOL, rowpos equal on each row whose two largest lags
    differ by more than ATOL; returns the count of such rows."""
    assert rowmax.shape == want_max.shape and rowpos.shape == want_pos.shape
    np.testing.assert_allclose(rowmax, want_max, rtol=0, atol=ATOL)
    n_clear = 0
    for r in range(len(rowmax)):
        a, b = _top_two(corr[128 * r: 128 * (r + 1)])
        if a - b > ATOL:
            assert rowpos[r] == want_pos[r], r
            n_clear += 1
    return n_clear


# --- the dense correlation at any length (fault C.1) -----------------------------


@pytest.mark.parametrize("name,l", [("chirp", 440), ("random", 129), ("random", 1024)])
def test_auto_xcorr_long_patterns_match_jax(name, l):
    """Patterns longer than the hit kernel stages: the port's auto_xcorr
    against JAX's CPU auto_xcorr on every row, and against
    pallas_normalized_xcorr in interpret mode on row 0."""
    rng = np.random.default_rng(l)
    pat = CHIRP if name == "chirp" else rng.normal(0, 1, l).astype(np.float32)
    x = _captures(pat, 6000, (300, 3100), seed=l + 1)
    got = auto_xcorr(torch.from_numpy(x), pat)
    assert got.shape == (2, 6000 - l + 1) and got.dtype == torch.float32
    for r in range(2):
        want = np.asarray(jax_auto_xcorr(jnp.asarray(x[r]), pat))
        np.testing.assert_allclose(got[r].numpy(), want, rtol=0, atol=ATOL)
    kern = np.asarray(pallas_normalized_xcorr(jnp.asarray(x[0]), pat, interpret=True))
    np.testing.assert_allclose(got[0].numpy(), kern, rtol=0, atol=ATOL)
    one = auto_xcorr(torch.from_numpy(x[1]), pat)    # the CPU convolution may
    np.testing.assert_allclose(one.numpy(), got[1].numpy(), rtol=0, atol=ATOL)  # block otherwise
    assert int(got[0].argmax()) in (300, 3100) and float(got[0, 300]) > 0.9
    assert int(got[1].argmax()) in (337, 3137)
    assert np.all(got[1, 4500:].numpy() == 0.0)              # silent windows give 0


def test_auto_xcorr_short_patterns_are_the_hit_kernels_output():
    """L <= 128 still goes through xcorr_hits: exactly its dense corr, which
    is also exactly the normalized-correlation plain version."""
    pre = jax_preamble(JaxPhyConfig())
    x = torch.from_numpy(_captures(pre, 3000, (100, 1500), seed=2))
    got = auto_xcorr(x, pre)
    corr, _ = xcorr_hits(x, pre, threshold=math.inf, emit_corr=True)
    assert torch.equal(got, corr)
    assert torch.equal(got, normalized_xcorr_dense_plain(x, pre))
    want = np.asarray(jax_auto_xcorr(jnp.asarray(x[0].numpy()), pre))
    np.testing.assert_allclose(got[0].numpy(), want, rtol=0, atol=ATOL)


def test_dense_wrapper_runs_the_plain_version_on_cpu():
    x = torch.from_numpy(_captures(CHIRP, 2000, (100,), seed=4))
    before = normalized_xcorr_dense.launches
    assert torch.equal(normalized_xcorr_dense(x, CHIRP), normalized_xcorr_dense_plain(x, CHIRP))
    assert normalized_xcorr_dense.launches == before
    ones = normalized_xcorr_dense(x, np.ones(1, np.float32))
    assert ones.shape == x.shape                    # L = 1: the sign of each sample
    with pytest.raises(ValueError):
        normalized_xcorr_dense(x, np.ones(1025, np.float32))      # longer than 1024
    with pytest.raises(ValueError):
        normalized_xcorr_dense(x[0], CHIRP)                       # not [B, T]
    with pytest.raises(ValueError):
        normalized_xcorr_dense(x[:, :400], CHIRP)                 # shorter than L
    with pytest.raises(ValueError):
        xcorr_hits_plain(x, CHIRP, 0.9)       # the hit kernel stays at L <= 128


# --- the row stats (kernel 8's plain version) ------------------------------------


@pytest.mark.parametrize("l", [96, 60, 440])
def test_rowstats_plain_matches_jax(l):
    """Against JAX's CPU auto_xcorr_row_stats and the first R rows of
    pallas_xcorr_rowstats in interpret mode, with peaks in the first row,
    mid-capture and in the final partial row."""
    rng = np.random.default_rng(11 + l)
    pat = CHIRP if l == 440 else np.sign(rng.normal(size=l)).astype(np.float32)
    t = 20_000
    x = rng.normal(0, 0.3, t).astype(np.float32)
    last = t - l - 5
    for p0 in (50, 9_876, last):
        x[p0: p0 + l] += pat
    rowmax, rowpos = (v.numpy() for v in xcorr_rowstats_plain(torch.from_numpy(x[None]), pat))
    rowmax, rowpos = rowmax[0], rowpos[0]
    assert rowmax.dtype == np.float32 and rowpos.dtype == np.int32
    r = -(-(t - l + 1) // 128)
    assert rowmax.shape == (r,)
    corr = normalized_xcorr_dense_plain(torch.from_numpy(x[None]), pat)[0].numpy()
    cm, cp = (np.asarray(v) for v in jax_row_stats(jnp.asarray(x), pat))
    assert _check_row_stats(corr, rowmax, rowpos, cm, cp) > r // 2
    km, kp = (np.asarray(v) for v in pallas_xcorr_rowstats(
        jnp.asarray(x), pat, blk=8192, interpret=True, use_bf16=False))
    assert _check_row_stats(corr, rowmax, rowpos, km[:r], kp[:r]) > r // 2
    assert np.all(km[r:] == NO_ROW)                # the kernel's padding rows
    assert rowpos[0] == 50 and rowpos[9_876 // 128] == 9_876 and rowpos[-1] == last
    assert last // 128 == r - 1 and (t - l + 1) % 128 != 0       # a partial last row


def test_rowstats_ties_take_the_first_lag():
    pat = np.ones(8, np.float32)
    x = np.zeros(1024, np.float32)
    x[100:108] = 1.0          # two identical windows in one lag row
    x[110:118] = 1.0
    x[600:608] = 1.0          # and two in the next-but-one row, 7 lags apart
    x[607:615] = 1.0
    rowmax, rowpos = xcorr_rowstats_plain(torch.from_numpy(x[None]), pat)
    assert rowpos[0, 0] == 100 and rowpos[0, 4] == 600
    assert float(rowmax[0, 0]) == float(rowmax[0, 4])
    assert rowmax[0, 0] == normalized_xcorr_dense_plain(torch.from_numpy(x[None]), pat)[0, 100]
    _, kp = pallas_xcorr_rowstats(jnp.asarray(x), pat, blk=1024, interpret=True,
                                  use_bf16=False)
    _, cp = jax_row_stats(jnp.asarray(x), pat)
    assert np.asarray(kp)[0] == np.asarray(cp)[0] == 100
    assert np.asarray(kp)[4] == np.asarray(cp)[4] == 600


def test_rowstats_capture_shorter_than_a_row():
    rng = np.random.default_rng(3)
    pat = jax_preamble(JaxPhyConfig(line_coding=FOUR_B_FIVE_B))
    x = rng.normal(0, 0.2, 150).astype(np.float32)
    x[40:100] += pat
    rowmax, rowpos = auto_xcorr_row_stats(torch.from_numpy(x), pat)
    cm, cp = (np.asarray(v) for v in jax_row_stats(jnp.asarray(x), pat))
    assert rowmax.shape == cm.shape == (1,)
    np.testing.assert_allclose(rowmax.numpy(), cm, rtol=0, atol=ATOL)
    assert int(rowpos[0]) == int(cp[0]) == 40
    rowmax, rowpos = auto_xcorr_row_stats(torch.from_numpy(x[:60]), pat)   # one lag
    assert rowpos.tolist() == [0] and rowmax.shape == (1,)


def test_rowstats_batch_and_wrapper():
    """A batch gives each row its single-capture stats; on CPU tensors the
    wrapper runs the plain version and counts no launch."""
    pre = jax_preamble(JaxPhyConfig())
    x = torch.from_numpy(_captures(pre, 5000, (10, 2600), seed=8))
    before = xcorr_rowstats.launches
    rowmax, rowpos = xcorr_rowstats(x, pre)
    plain = xcorr_rowstats_plain(x, pre)
    assert torch.equal(rowmax, plain[0]) and torch.equal(rowpos, plain[1])
    assert xcorr_rowstats.launches == before
    corr = auto_xcorr(x, pre)
    for r in range(2):       # the CPU convolution may block one row otherwise
        one = auto_xcorr_row_stats(x[r], pre)
        _check_row_stats(corr[r].numpy(), one[0].numpy(), one[1].numpy(),
                         rowmax[r].numpy(), rowpos[r].numpy())
    # the row stats are the dense correlation reduced by row
    grid = torch.nn.functional.pad(corr, (0, rowmax.shape[1] * 128 - corr.shape[1]),
                                   value=float(NO_ROW)).reshape(2, -1, 128)
    assert torch.equal(rowmax, grid.amax(-1))
    assert rowpos[0, 0] == 10 and rowpos[1, 2637 // 128] == 2637
    with pytest.raises(ValueError):
        xcorr_rowstats(x[0], pre)                              # not [B, T]
    with pytest.raises(ValueError):
        xcorr_rowstats(x[:, :50], pre)                         # shorter than L
