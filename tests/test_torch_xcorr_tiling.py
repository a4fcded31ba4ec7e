"""The hit kernel's launch parameters and range checks (``csrc/xcorr_hits.cu``
through ``sync/xcorr_hits.py``), which need no card: the pattern and the
sync word go to the kernel by value as 128 floats (``pack_taps``), and the
refine entry refuses a window that reaches past the samples a block stages
(``_check_refine``).  The kernel itself runs only on a card
(``tests/test_torch_kernels_gpu.py``)."""

import importlib

import numpy as np
import pytest

from trackmaker_tpu_torch import PhyConfig
from trackmaker_tpu_torch.phy.line_coding import preamble_waveform

# the module (the package exports the function under the same name)
xh = importlib.import_module("trackmaker_tpu_torch.sync.xcorr_hits")
REFINES = {"manchester": (42, 13, 48), "4b5b": (15, 31, 30)}   # sync_off, n_pos, W
PATTERNS = np.tile(preamble_waveform(PhyConfig()), 2)   # cut to each L


def _refine_kw(cfg) -> tuple[int, int, int]:
    return (cfg.preamble_len - cfg.sync_len - cfg.sync_margin, 2 * cfg.sync_margin + 1,
            cfg.sync_len)


def test_refine_settings_are_the_line_codes():
    assert REFINES["manchester"] == _refine_kw(PhyConfig())
    assert REFINES["4b5b"] == _refine_kw(PhyConfig(line_coding="4b5b"))


@pytest.mark.parametrize("l", [1, 7, 8, 9, 30, 48, 60, 96, 127, 128])
def test_packed_taps_hold_the_pattern_then_zeros(l):
    taps = PATTERNS[:l]
    packed = xh.pack_taps(taps)
    assert packed.dtype == np.float32 and packed.shape == (xh.MAX_PATTERN,)
    assert packed.flags.c_contiguous
    bits = packed.view(np.uint32)
    assert (bits[:l] == taps.astype(np.float32).view(np.uint32)).all()
    assert (bits[l:] == 0).all()


def test_packing_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError):
        xh.pack_taps(np.ones(xh.MAX_PATTERN + 1, np.float32))
    with pytest.raises(ValueError):
        xh.pack_taps(np.ones(0, np.float32))


@pytest.mark.parametrize("code", list(REFINES))
@pytest.mark.parametrize("l", [1, 60, 96, 128])
def test_refine_check_takes_the_line_codes_settings(code, l):
    sync_off, n_pos, w = REFINES[code]
    xh._check_refine(PATTERNS[:w], w, sync_off, n_pos, l)


def test_refine_check_refuses_a_reach_past_the_stage():
    sync = np.ones(48, np.float32)
    xh._check_refine(sync, 48, 42, 13, 96)
    xh._check_refine(sync, 48, 197, 13, 96)     # 197 + 13 + 48 - 2 = 256, the stage
    with pytest.raises(ValueError):             # 257
        xh._check_refine(sync, 48, 198, 13, 96)
    with pytest.raises(ValueError):
        xh._check_refine(sync, 48, 42, xh.MAX_REFINE_POSITIONS + 1, 96)
    with pytest.raises(ValueError):             # the sync word is not sync_len long
        xh._check_refine(sync[:47], 48, 42, 13, 96)
