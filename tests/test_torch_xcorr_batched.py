"""The port's batch-folded hit rows (``xcorr_hits_batched``, the plain
version on the CPU) against the JAX package's ``pallas_xcorr_hits_batched``
in interpret mode, on the corpus of tests/test_pallas_xcorr.py's
batched test: five noisy 40,000-sample captures with planted preambles, at
a batch size that needs capture padding in JAX (b % bc != 0).

Tolerances: the integer columns (positions, counts) are exactly equal on
the rows both produce, JAX's extra padded rows hold no hit, and the
correlation at each hit agrees within 1e-5 (sum order); the corpus has no
lag within 1e-4 of the threshold, which the test asserts."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trackmaker_tpu.core.config import PhyConfig
from trackmaker_tpu.phy.line_coding import preamble_waveform
from trackmaker_tpu.sync.pallas_xcorr import pallas_xcorr_hits_batched
from trackmaker_tpu_torch.sync.xcorr_hits import (
    xcorr_hits_batched,
    xcorr_hits_batched_plain,
    xcorr_hits_plain,
)
from trackmaker_tpu_torch.sync.xcorr_norm import normalized_xcorr_dense_plain

BIGI = 2**30


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread while this module runs: the suite runs a worker per
    core, and torch's own thread pool on top of that oversubscribes them."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _corpus(pre: np.ndarray) -> np.ndarray:
    rng = np.random.default_rng(2)
    t, b = 40_000, 5
    x = rng.normal(0, 0.3, (b, t)).astype(np.float32)
    for row in range(b):
        for p in (1000 + 531 * row, 17000 + 113 * row, t - len(pre) - 7):
            x[row, p:p + len(pre)] += pre
    return x


def test_batched_rows_match_jax():
    cfg = PhyConfig()
    pre = preamble_waveform(cfg)
    thr = cfg.correlation_threshold
    x = _corpus(pre)
    want = np.asarray(pallas_xcorr_hits_batched(jnp.asarray(x), pre, thr, blk=8192, bc=4,
                                                interpret=True))
    xt = torch.from_numpy(x)
    corr = normalized_xcorr_dense_plain(xt, pre).numpy()
    assert np.abs(corr - thr).min() > 1e-4

    before = xcorr_hits_batched.launches
    got = xcorr_hits_batched(xt, pre, thr, bc=4)
    assert xcorr_hits_batched.launches == before
    assert torch.equal(got, xcorr_hits_batched_plain(xt, pre, thr, bc=4))
    assert torch.equal(got, xcorr_hits_plain(xt, pre, thr)[1])
    got = got.numpy()
    n_rows = -(-x.shape[1] // 128)
    assert got.shape == (x.shape[0], n_rows, 16) and want.shape[0] == x.shape[0]
    ints = np.r_[0:5, 9:16]
    np.testing.assert_array_equal(got[..., ints], want[:, :n_rows, ints])
    np.testing.assert_allclose(got[..., 5:9].view(np.float32),
                               want[:, :n_rows, 5:9].view(np.float32), atol=1e-5)
    assert np.all(want[:, n_rows:, :4] == BIGI) and np.all(want[:, n_rows:, 4] == 0)
    assert (got[..., 4] > 0).any(-1).all() and got[..., 4].sum() >= 3 * x.shape[0]
