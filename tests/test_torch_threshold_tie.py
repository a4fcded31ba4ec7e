"""A lag whose correlation ties the 0.9 threshold to float precision: the
port's decoders against the JAX package's on the CPU.

The capture is the first n samples of the 4B5B preamble followed by one
frame.  The window at lag 0 holds that fragment and the frame's first
60 - n preamble samples, so its correlation is 54/60 = 0.9 in exact
arithmetic.  The JAX package's ``correlate.normalized_xcorr`` divides,
``dot / max(sqrt(energy) * ||p||, 1e-30)``, and gives 0.8999999 in f32:
no hit, and the frame at n is found.  A normalization that multiplies by
``1/sqrt(energy)`` and ``1/||p||`` gives exactly 0.9 there, a hit, whose
failed attempt consumes the frame.  The port divides as the reference
does, so lag 0's correlation equals JAX's bit for bit and every decode
finds the frame at start n.

Each capture is zero-padded to 2,048 samples with its valid length set:
the exact scan and the fast decode take the valid length, the blocked
decode cuts the padded capture into four blocks of 512, the frame inside
the first."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trackmaker_tpu import sync as jsync
from trackmaker_tpu.core.config import PhyConfig as JaxPhyConfig
from trackmaker_tpu.phy import decoder as jdecoder
from trackmaker_tpu.phy.line_coding import preamble_waveform as jax_preamble
from trackmaker_tpu.sync import correlate as jcorrelate
from trackmaker_tpu_torch import PhyConfig
from trackmaker_tpu_torch.core.framing import Frame
from trackmaker_tpu_torch.parallel import stream
from trackmaker_tpu_torch.phy.decoder import decode_capture, decode_capture_fast
from trackmaker_tpu_torch.phy.encoder import PhyEncoder
from trackmaker_tpu_torch.sync import auto_xcorr

CFG = PhyConfig(line_coding="4b5b")
JCFG = JaxPhyConfig(line_coding="4b5b")
PRE = jax_preamble(JCFG)
FRAGMENTS = (39, 48, 49, 50, 51, 57)
T = 2048
N_BLOCKS = 4
MAX_FRAMES = 4
LOCAL_ADDR = 2


def _frame_wave() -> np.ndarray:
    frame = Frame.new_data(5, 1, 2, b"hello")
    return PhyEncoder(CFG, device="cpu").encode_frames([frame], gap_samples=0).numpy()


def _captures() -> tuple[np.ndarray, np.ndarray]:
    """f32[6, T]: one capture per fragment length, zero-padded; and their
    valid lengths int32[6]."""
    wave = _frame_wave()
    x = np.zeros((len(FRAGMENTS), T), np.float32)
    vlens = np.zeros(len(FRAGMENTS), np.int32)
    for r, n in enumerate(FRAGMENTS):
        cap = np.concatenate([PRE[:n], wave])
        x[r, :len(cap)] = cap
        vlens[r] = len(cap)
    return x, vlens


def _frames(res, row: int) -> list[tuple]:
    """The valid frames of one row: (start, bytes), in slot order."""
    valid = np.asarray(res.valid[row])
    starts = np.asarray(res.start[row])
    lengths = np.asarray(res.length[row])
    fb = np.asarray(res.frame_bytes[row])
    return [(int(starts[k]), fb[k, :7 + int(lengths[k])].tobytes())
            for k in np.nonzero(valid)[0]]


@pytest.fixture(scope="module")
def reference():
    """JAX's corr at lag 0, exact scan and fast decode of every capture."""
    x, vlens = _captures()
    xj, vj = jnp.asarray(x), jnp.asarray(vlens)
    pe = jcorrelate.preamble_energy(PRE)
    corr0 = [float(jsync.auto_xcorr(xj[r, :vlens[r]], PRE, pe)[0]) for r in range(len(x))]
    scan = jax.jit(jax.vmap(
        lambda s, v: jdecoder.decode_capture(JCFG, s, LOCAL_ADDR, MAX_FRAMES, valid_len=v)))
    exact = scan(xj, vj)
    fast = jdecoder.decode_capture_fast(JCFG, xj, LOCAL_ADDR, max_frames=MAX_FRAMES,
                                        valid_len=vj)
    return x, vlens, corr0, exact, fast


@pytest.fixture(scope="module")
def port(reference):
    """The port's fast decode of the batch (one call)."""
    x, vlens = reference[:2]
    return decode_capture_fast(CFG, torch.from_numpy(x), LOCAL_ADDR, max_frames=MAX_FRAMES,
                               valid_len=vlens.tolist())


@pytest.mark.parametrize("n", FRAGMENTS)
def test_threshold_tie_decodes_as_jax(reference, port, n):
    x, vlens, corr0, exact, fast = reference
    r = FRAGMENTS.index(n)
    want = _frames(exact, r)
    assert len(want) == 1 and want[0][0] == n          # the frame, at start n
    assert _frames(fast, r) == want

    # lag 0 ties the threshold: the port's correlation is JAX's, bit for bit
    xr = torch.from_numpy(x[r, :vlens[r]])
    got0 = auto_xcorr(xr, PRE)[0].item()
    assert np.float32(got0).tobytes() == np.float32(corr0[r]).tobytes()
    assert abs(got0 - CFG.correlation_threshold) < 1e-6 and got0 < CFG.correlation_threshold

    # the exact scan, the fast decode and the blocked decode find the frame
    assert _frames(decode_capture(CFG, torch.from_numpy(x[r]), LOCAL_ADDR, MAX_FRAMES,
                                  valid_len=int(vlens[r])), slice(None)) == want
    assert _frames(port, r) == want
    xt = torch.from_numpy(x[r])
    res, ok, _ = stream.decode_blocked_spec(CFG, xt, LOCAL_ADDR, N_BLOCKS, MAX_FRAMES)
    assert bool(ok)                      # the speculative route decides alone
    assert _frames(res, slice(None)) == want
    blocked = stream.decode_blocked_single_chip(CFG, xt, LOCAL_ADDR, N_BLOCKS, MAX_FRAMES)
    assert _frames(blocked, slice(None)) == want
    assert stream.spec_block(T, N_BLOCKS) == 512 and want[0][0] + len(_frame_wave()) < 512
