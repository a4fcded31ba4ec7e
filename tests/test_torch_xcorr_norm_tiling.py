"""The launch parameters and range checks of the raw sliding dot
(``csrc/sliding_dot.cu`` through ``sync/sliding_dot.py``) and of the
normalized correlation and its row stats (``csrc/xcorr_norm.cu`` through
``sync/xcorr_norm.py``), which need no card: the pattern goes to each kernel
by value, 512 and 1024 floats (``pack_taps``), and each wrapper refuses what
its kernel does not take before it launches (``_kernel_args``).  The
kernels themselves run only on a card (``tests/test_torch_kernels_gpu.py``)."""

import importlib

import numpy as np
import pytest
import torch

from trackmaker_tpu_torch.dsp.osc import chirp_np

# the modules (the package exports a function named sliding_dot)
sdot = importlib.import_module("trackmaker_tpu_torch.sync.sliding_dot")
xn = importlib.import_module("trackmaker_tpu_torch.sync.xcorr_norm")

PATTERNS = np.tile(chirp_np(440), 3)        # cut to each L
LENGTHS = [1, 7, 8, 9, 30, 128, 129, 440, 512, 1024]
MODULES = {"sliding_dot": sdot, "xcorr_norm": xn}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("module", list(MODULES))
@pytest.mark.parametrize("l", LENGTHS)
def test_packed_taps_hold_the_pattern_then_zeros(module, l):
    mod = MODULES[module]
    taps = PATTERNS[:l]
    if l > mod.MAX_PATTERN:
        with pytest.raises(ValueError):
            mod.pack_taps(taps)
        return
    packed = mod.pack_taps(taps)
    assert packed.dtype == np.float32 and packed.shape == (mod.MAX_PATTERN,)
    assert packed.flags.c_contiguous
    bits = packed.view(np.uint32)
    assert (bits[:l] == taps.astype(np.float32).view(np.uint32)).all()
    assert (bits[l:] == 0).all()


def test_the_kernels_take_the_ask_and_equalizer_patterns():
    """The limits: the raw form takes the chirp sync's 440 taps (and 512),
    the normalized form up to 1024."""
    assert sdot.MAX_PATTERN == 512 and xn.MAX_PATTERN == 1024
    assert sdot.MAX_BATCH == xn.MAX_BATCH == 65535


def _x(b: int = 2, t: int = 600) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(1).normal(0, 1, (b, t)).astype(np.float32))


@pytest.mark.parametrize("module", list(MODULES))
def test_launch_args_of_a_fitting_call(module):
    mod = MODULES[module]
    b, t, l, taps = mod._kernel_args(_x(), PATTERNS[:60])
    assert (b, t, l) == (2, 600, 60)
    assert np.array_equal(taps, mod.pack_taps(PATTERNS[:60]))


REFUSED = {
    "empty pattern": lambda mod: mod._kernel_args(_x(), PATTERNS[:0]),
    "pattern past the limit": lambda mod: mod._kernel_args(_x(t=2000),
                                                            PATTERNS[:mod.MAX_PATTERN + 1]),
    "non-contiguous x": lambda mod: mod._kernel_args(_x(t=1200)[:, ::2], PATTERNS[:60]),
    "not f32": lambda mod: mod._kernel_args(_x().double(), PATTERNS[:60]),
    "not 2-D": lambda mod: mod._kernel_args(_x()[0], PATTERNS[:60]),
    "too many captures": lambda mod: mod._kernel_args(torch.zeros((mod.MAX_BATCH + 1, 1)),
                                                      PATTERNS[:1]),
}


@pytest.mark.parametrize("module", list(MODULES))
@pytest.mark.parametrize("case", list(REFUSED))
def test_launch_args_refuse_what_the_kernel_does_not_take(module, case):
    with pytest.raises(ValueError):
        REFUSED[case](MODULES[module])


def test_normalized_form_refuses_a_capture_shorter_than_its_pattern():
    with pytest.raises(ValueError):
        xn._kernel_args(_x(t=439), PATTERNS[:440])
    with pytest.raises(ValueError):
        xn.normalized_xcorr_dense(_x(t=439), PATTERNS[:440])
    with pytest.raises(ValueError):
        xn.xcorr_rowstats(_x(t=439), PATTERNS[:440])


def test_raw_form_takes_a_capture_shorter_than_its_pattern():
    """Lag i reads the L samples ending at sample i over zero history, so a
    capture shorter than the pattern is fine; an empty one is not."""
    x = _x(t=100)
    assert sdot._kernel_args(x, PATTERNS[:440])[:3] == (2, 100, 440)
    out = sdot.sliding_dot_scaled(x, PATTERNS[:440], 0.5)
    p = PATTERNS[:440].astype(np.float64)
    want = np.array([[np.dot(row[:i + 1], p[440 - 1 - i:]) for i in range(100)]
                     for row in x.numpy().astype(np.float64)]) * 0.5
    assert out.shape == (2, 100) and np.abs(out.numpy() - want).max() < 1e-4
    with pytest.raises(ValueError):
        sdot._kernel_args(torch.zeros((2, 0)), PATTERNS[:8])


@pytest.mark.parametrize("l", [0, 513])
def test_raw_wrapper_refuses_a_pattern_it_cannot_take(l):
    with pytest.raises(ValueError):
        sdot.sliding_dot_scaled(_x(t=600), PATTERNS[:l], 1.0)


@pytest.mark.parametrize("l", [0, 1025])
def test_normalized_wrappers_refuse_a_pattern_they_cannot_take(l):
    with pytest.raises(ValueError):
        xn.normalized_xcorr_dense(_x(t=2000), PATTERNS[:l])
    with pytest.raises(ValueError):
        xn.xcorr_rowstats(_x(t=2000), PATTERNS[:l])
