"""The port's decision-directed equalized decode (``trackmaker_tpu_torch.dsp.
equalizer``: ``refit_channel``, ``_mmse_taps_np``, ``_apply_taps_decode``,
``decode_capture_dd``) against the JAX package's, on the CPU.

The corpora are those of ``tests/test_equalizer.py:126-190``: frames back to
back through an echo with the capture's head cut mid-frame, so that no
preamble follows silence, and a clean gapped capture.  They are built with
NumPy and the port's encoder (equal to the JAX package's), the echo added
in float64, so ``tests/test_torch_kernels_gpu.py`` can build them on a card
without JAX: this module imports JAX only inside its tests.  Beside them,
``chip_smoke.py``'s mid-burst corpus of 64 frames of 128-byte payloads,
whose payload digest under JAX's ``decode_capture_dd`` the script holds the
card to.

Tolerances: the refit taps, lam and FIR taps bit for bit (the same host
float64 NumPy on the same waveforms); every decoded frame and start exactly
equal."""

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
from trackmaker_tpu_torch.core.config import PhyConfig
from trackmaker_tpu_torch.core.framing import Frame
from trackmaker_tpu_torch.dsp import equalizer
from trackmaker_tpu_torch.phy.decoder import decode_capture, decode_capture_fast
from trackmaker_tpu_torch.phy.encoder import PhyEncoder

CFG = PhyConfig()
# (echo taps {delay: amplitude}, noise sigma) of each mid-burst corpus
MIDBURST = {"beats_both": ({9: 0.6}, 0.02), "never_below": ({9: 0.5}, 0.03)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread while this module runs: the suite runs a worker per
    core, and torch's own thread pool on top of that oversubscribes them."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _jcfg():
    from trackmaker_tpu.core.config import PhyConfig as JaxPhyConfig

    return JaxPhyConfig(**dataclasses.asdict(CFG))


# --- the corpora (no JAX) -------------------------------------------------------------


def echo(wave: np.ndarray, taps: dict[int, float]) -> np.ndarray:
    """wave through the direct path and `taps` {delay: amplitude}, in float64."""
    out = wave.astype(np.float64)
    for d, a in taps.items():
        out[d:] += a * wave[:len(wave) - d].astype(np.float64)
    return out


def midburst_capture(name: str, n: int = 8, seed: int = 3):
    """A zero-gap burst of n frames of bytes([i + 1]) * 40 through the echo
    of MIDBURST[name], noise from `seed`, the head cut at 0.6 of a frame:
    every surviving preamble follows the previous frame's tail.  Returns
    (capture f32[T], the payloads of frames 1..n-1, sorted)."""
    taps, sigma = MIDBURST[name]
    enc = PhyEncoder(CFG, device="cpu")
    frames = [Frame.new_data(i, 1, 2, bytes([i + 1]) * 40) for i in range(n)]
    parts = [enc.encode_frame(f).numpy() for f in frames]
    wave = np.concatenate(parts + [np.zeros(600, np.float32)])
    rng = np.random.default_rng(seed)
    ech = (echo(wave, taps) + rng.normal(0, sigma, len(wave))).astype(np.float32)
    return ech[int(len(parts[0]) * 0.6):], sorted(f.data for f in frames[1:])


def clean_capture(n: int = 8, seed: int = 5):
    """tests/test_equalizer.py's clean gapped capture: 400 samples of silence
    after each frame, noise sigma 0.02."""
    enc = PhyEncoder(CFG, device="cpu")
    frames = [Frame.new_data(i, 1, 2, bytes([i + 1]) * 40) for i in range(n)]
    parts = []
    for f in frames:
        parts += [enc.encode_frame(f).numpy(), np.zeros(400, np.float32)]
    wave = np.concatenate(parts + [np.zeros(600, np.float32)])
    rng = np.random.default_rng(seed)
    return (wave + rng.normal(0, 0.02, len(wave))).astype(np.float32), sorted(f.data for f in frames)


CORPORA = {"beats_both": lambda: midburst_capture("beats_both"),
           "never_below": lambda: midburst_capture("never_below"),
           "clean": clean_capture}


def frames_of(res) -> list[tuple]:
    """The valid slots of a decode (port or JAX), in slot order."""
    def np_(a):
        return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    valid = np_(res.valid)
    cols = [np_(getattr(res, f)) for f in ("length", "frame_type", "sequence", "src", "dst",
                                            "start")]
    fb = np_(res.frame_bytes)
    return [(fb[k, :7 + int(cols[0][k])].tobytes(), *(int(c[k]) for c in cols))
            for k in np.nonzero(valid)[0]]


def payloads_of(res) -> list[bytes]:
    return sorted(f[0][7:] for f in frames_of(res))


@pytest.fixture(scope="module")
def ref():
    """Each corpus and JAX's decode_capture_dd, decode_capture_eq and stock
    exact scan on it."""
    import jax.numpy as jnp
    from trackmaker_tpu.dsp import equalizer as jeq
    from trackmaker_tpu.phy.decoder import decode_capture as jax_decode

    jcfg = _jcfg()
    out = {}
    for name, make in CORPORA.items():
        x, want = make()
        mf = len(want) + 4
        out[name] = dict(x=x, want=want, mf=mf,
                         dd=jeq.decode_capture_dd(jcfg, x, 2, max_frames=mf),
                         eq=jeq.decode_capture_eq(jcfg, x, 2, max_frames=mf),
                         stock=jax_decode(jcfg, jnp.asarray(x), 2, max_frames=mf))
    return out


# --- the pieces ------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["beats_both", "clean"])
def test_refit_and_taps_match_jax_bit_for_bit(ref, name):
    """refit_channel on the stock decode's frames and starts, then
    _mmse_taps_np: the same host float64 code on the same waveforms."""
    from trackmaker_tpu.dsp import equalizer as jeq

    r = ref[name]
    stock = r["stock"]
    valid = np.asarray(stock.valid)
    starts = np.asarray(stock.start)[valid]
    h, lam = equalizer.refit_channel(CFG, r["x"], _port_frames(stock), starts)
    hj, lamj = jeq.refit_channel(_jcfg(), r["x"], stock.to_frames(), starts)
    assert h.dtype == np.float32
    np.testing.assert_array_equal(h, hj)
    assert lam == lamj
    np.testing.assert_array_equal(equalizer._mmse_taps_np(h, lam), jeq._mmse_taps_np(hj, lamj))


def _port_frames(res) -> list[Frame]:
    return [Frame.from_bytes(f[0]) for f in frames_of(res)]


def test_refit_needs_a_frame_long_enough():
    """A frame cut by the capture's end before 4·N_CH interior rows trains
    nothing: ValueError, as in the JAX package."""
    from trackmaker_tpu.dsp import equalizer as jeq

    f = Frame.new_data(0, 1, 2, bytes([1]) * 40)
    x = np.zeros(300, np.float32)
    with pytest.raises(ValueError):
        equalizer.refit_channel(CFG, x, [f], [100])
    with pytest.raises(ValueError):
        jeq.refit_channel(_jcfg(), x, [f], [100])


def test_apply_taps_decode_matches_jax(ref):
    """The refit taps applied by the banded product and decoded: JAX's
    frames, and the capture within 1e-4·max|x| of JAX's FIR."""
    import jax.numpy as jnp
    from trackmaker_tpu.dsp import equalizer as jeq

    r = ref["beats_both"]
    stock = r["stock"]
    valid = np.asarray(stock.valid)
    h, lam = jeq.refit_channel(_jcfg(), r["x"], stock.to_frames(), np.asarray(stock.start)[valid])
    g = jeq._mmse_taps_np(h, lam)
    got = equalizer._apply_taps_decode(CFG, torch.from_numpy(r["x"]), torch.from_numpy(g), 2,
                                       r["mf"])
    want = jeq._apply_taps_decode(_jcfg(), jnp.asarray(r["x"]), jnp.asarray(g), 2, r["mf"])
    assert frames_of(got) == frames_of(want)
    assert len(frames_of(got)) == len(r["want"])
    eq = equalizer._apply_fir(torch.from_numpy(r["x"])[None], torch.from_numpy(g)[None])[0]
    eq_j = np.asarray(jeq._apply_fir(jnp.asarray(r["x"]), jnp.asarray(g)))
    np.testing.assert_allclose(eq.numpy(), eq_j, rtol=0, atol=1e-4 * np.abs(r["x"]).max())


# --- tests/test_equalizer.py:150-190 on the port ----------------------------------------


@pytest.mark.parametrize("name", list(CORPORA))
def test_decode_capture_dd_matches_jax(ref, name):
    r = ref[name]
    x = torch.from_numpy(r["x"])
    got = equalizer.decode_capture_dd(CFG, x, 2, max_frames=r["mf"])
    assert got.valid.device.type == "cpu"
    assert frames_of(got) == frames_of(r["dd"])
    assert payloads_of(got) == r["want"]
    stock = decode_capture(CFG, x, 2, max_frames=r["mf"])
    eq = equalizer.decode_capture_eq(CFG, x, 2, max_frames=r["mf"])
    assert frames_of(stock) == frames_of(r["stock"])
    assert frames_of(eq) == frames_of(r["eq"])
    n = len(r["want"])
    if name == "beats_both":   # stock partial, mid-burst training worse, dd all
        assert 1 <= len(payloads_of(stock)) < n
        assert len(payloads_of(eq)) < n
        assert set(payloads_of(stock)) < set(payloads_of(got))


def test_chip_smoke_digest_is_the_jax_packages():
    """chip_smoke.py's mid-burst corpus (64 frames of 128-byte payloads):
    the payload digest the script holds the card to is that of JAX's
    decode_capture_dd here, and strictly more than JAX's stock exact scan
    finds."""
    import jax.numpy as jnp
    from trackmaker_tpu.dsp import equalizer as jeq
    from trackmaker_tpu.phy.decoder import decode_capture as jax_decode

    x, payloads = chip_smoke.dd_capture(torch, CFG, torch.device("cpu"))
    assert x.dtype == torch.float32 and len(payloads) == chip_smoke.DD_FRAMES
    mf = chip_smoke.DD_FRAMES + 8
    dd = payloads_of(jeq.decode_capture_dd(_jcfg(), x.numpy(), 2, max_frames=mf))
    stock = payloads_of(jax_decode(_jcfg(), jnp.asarray(x.numpy()), 2, max_frames=mf))
    assert chip_smoke.payload_digest(dd) == chip_smoke.DD_DIGEST
    assert set(stock) < set(dd) and set(dd) <= set(payloads)


def test_numpy_input_goes_to_the_card():
    """A NumPy capture goes to the card by default, and raises without one."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises((AssertionError, RuntimeError)):
        equalizer.decode_capture_dd(CFG, np.zeros(5000, np.float32), 2)


def test_fast_decode_rows_equal_the_exact_scan_on_the_corpora(ref):
    """decode_capture_fast, the decode every refit iteration runs, equals the
    exact scan on the raw corpora."""
    for r in ref.values():
        x = torch.from_numpy(r["x"])
        fast = decode_capture_fast(CFG, x, 2, max_frames=r["mf"])
        assert frames_of(fast) == frames_of(decode_capture(CFG, x, 2, max_frames=r["mf"]))
