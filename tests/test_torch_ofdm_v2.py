"""The port's OFDM v2 receiver (``trackmaker_tpu_torch.phy.ofdm_v2``:
Schmidl-Cox timing, the smoothed channel estimate, pilot-tone tracking,
the stream PHY and the modem) against the JAX package's, on the CPU, and
on the card against the port's CPU run; and ``chip_smoke.py``'s
ofdm_v2_b32 digest against the JAX package's decisions.

The corpora are built by the port (its modulator on the CPU, NumPy noise,
echoes and the port's ``clock_offset``, bit for bit the JAX package's), so
the tests marked ``gpu`` build them on a card without JAX: this module
imports JAX only inside its tests, and each JAX result it compares with
more than once is computed once a session.

Tolerances, each with its reason:
* waveforms: atol 1e-6 (another FFT library);
* the smoothed channel estimate: atol 1e-6 on values about 1 (a 9-tap sum
  in another order);
* the Schmidl-Cox refine: M(d) is flat across the cyclic prefix, to a few
  parts in a million on clean captures, below the effect of another sum
  order.  With M in float64 (each side's f32 sums lie within about 1e-6 of
  it): where its two largest values differ by more than 1e-4 of the
  largest, the port's refined start equals JAX's; elsewhere both picks are
  lags whose M lies within 1e-4 of the largest.  Noiseless captures are
  included: that is where the picks differ;
* starts, bits, frames and buffer lengths: equal.  Each corpus asserts
  that every de-rotated data symbol of a real frame lies at least 1e-3 of
  the symbols' RMS from its QPSK boundary, so that equal bits mean equal
  decisions and not luck.
"""

import dataclasses
import inspect

import numpy as np
import pytest
import torch

import chip_smoke
from test_torch_ofdm import drive, frames_of, jax_drive, stream_track
from trackmaker_tpu_torch import convert
from trackmaker_tpu_torch.core.framing import Frame
from trackmaker_tpu_torch.dsp.channel import clock_offset
from trackmaker_tpu_torch.phy import ofdm, ofdm_v2

CFG = ofdm_v2.OfdmV2Config()
NO_TRACK = ofdm_v2.OfdmV2Config(track_cpe=False, track_slope=False, use_sc=False)
MARGIN = 1e-3
PLATEAU = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread while this module runs: the suite runs a worker per
    core, and torch's own thread pool on top of that oversubscribes them."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _jcfg(cfg):
    from trackmaker_tpu.phy.ofdm_v2 import OfdmV2Config as JaxOfdmV2Config

    return JaxOfdmV2Config(**dataclasses.asdict(cfg))


def capture(frames, lead: int, sigma: float, seed: int, gap: int = 400, tail: int = 2000,
            cfg=CFG) -> np.ndarray:
    rng = np.random.default_rng(seed)
    wave = ofdm_v2.OfdmModemV2(cfg, device="cpu").encode_frames(frames, gap_samples=gap)
    x = np.concatenate([np.zeros(lead, np.float32), wave, np.zeros(tail, np.float32)])
    return (x + rng.normal(0, sigma, len(x))).astype(np.float32) if sigma else x


def echo(x: np.ndarray, delay: int, amp: float) -> np.ndarray:
    y = x.astype(np.float64)
    y[delay:] += amp * x[:-delay].astype(np.float64)
    return y.astype(np.float32)


def margin(sym: torch.Tensor) -> float:
    rms = sym.abs().pow(2).mean().sqrt()
    return (torch.minimum(sym.real.abs(), sym.imag.abs()).min() / rms).item()


# corpus name -> (frames, capture); 4 frames of 40 B (3 symbols) unless said
def _corpora() -> dict:
    f40 = frames_of(21, 4, 40)
    f9 = frames_of(22, 3, 9)                     # 1 data symbol
    f150 = frames_of(23, 2, 150)                 # 9 data symbols
    clean = capture(f40, 31, 0.0, 0)
    return {
        "clean": (f40, clean),
        "noise": (f40, capture(f40, 5, 0.02, 1)),
        "one_symbol": (f9, capture(f9, 97, 0.01, 2)),
        "long": (f150, capture(f150, 200, 0.01, 3)),
        "ppm+200": (f40, clock_offset(torch.from_numpy(clean), 200.0).numpy()),
        "ppm-200": (f40, clock_offset(torch.from_numpy(clean), -200.0).numpy()),
        "echo": (f40, echo(capture(f40, 0, 0.005, 4), 40, 0.5)),
    }


CORPORA = _corpora()


def port_starts(name: str) -> torch.Tensor:
    x = CORPORA[name][1]
    return ofdm.find_preambles(CFG, torch.from_numpy(x), 6)


_JAX: dict = {}


def jax_once(key, fn):
    if key not in _JAX:
        _JAX[key] = fn()
    return _JAX[key]


def jax_starts(name: str) -> np.ndarray:
    import jax.numpy as jnp

    from trackmaker_tpu.phy.ofdm import find_preambles

    return jax_once(("starts", name), lambda: np.asarray(
        find_preambles(_jcfg(CFG), jnp.asarray(CORPORA[name][1]), 6)))


# --- configuration, pilots, modulator, smoother ------------------------------------------


def test_config_and_pilots_match_jax():
    from trackmaker_tpu.phy.ofdm_v2 import OfdmV2Config as JaxOfdmV2Config
    from trackmaker_tpu.phy.ofdm_v2 import _sc_pilot, _tone_pilots

    ours = [(f.name, f.default) for f in dataclasses.fields(ofdm_v2.OfdmV2Config)]
    assert ours == [(f.name, f.default) for f in dataclasses.fields(JaxOfdmV2Config)]
    for cfg in (CFG, NO_TRACK, ofdm_v2.OfdmV2Config(pilot_spacing=5, pilot_seed=4)):
        j = _jcfg(cfg)
        np.testing.assert_array_equal(cfg.pilot_bin_idx, j.pilot_bin_idx)
        np.testing.assert_array_equal(cfg.data_bin_idx, j.data_bin_idx)
        assert cfg.bits_per_symbol == j.bits_per_symbol
        assert cfg.frame_samples(568) == j.frame_samples(568)
        np.testing.assert_array_equal(ofdm_v2._sc_pilot(cfg), _sc_pilot(j))
        np.testing.assert_array_equal(ofdm_v2._tone_pilots(cfg), _tone_pilots(j))
        assert convert.ofdm_v2_config_from_fields(dataclasses.asdict(j)) == cfg


@pytest.mark.parametrize("n_bits", [56, 568, 2104])
def test_modulate_bits_v2_matches_jax(n_bits):
    import jax.numpy as jnp

    from trackmaker_tpu.phy.ofdm_v2 import modulate_bits_v2

    bits = np.random.default_rng(n_bits).integers(0, 2, (2, n_bits)).astype(np.uint8)
    got = ofdm_v2.modulate_bits_v2(CFG, torch.from_numpy(bits), n_bits)
    want = np.asarray(modulate_bits_v2(_jcfg(CFG), jnp.asarray(bits), n_bits))
    assert got.shape == want.shape == (2, CFG.frame_samples(n_bits))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    body = got[0, CFG.preamble_len + CFG.guard_samples + CFG.cp_len:][:CFG.n_fft]
    half = CFG.n_fft // 2
    np.testing.assert_allclose(body[:half].numpy(), body[half:].numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("win", [9, 3, 1])
def test_smooth_complex_matches_jax_under_vmap(win):
    """JAX's receiver runs the smoother under vmap, on 1-D rows: its
    jnp.convolve branch, whose sums the port's correlation forms."""
    import jax
    import jax.numpy as jnp

    from trackmaker_tpu.phy.ofdm_v2 import _smooth_complex

    rng = np.random.default_rng(win)
    h = (rng.normal(size=(3, 4, 85)) + 1j * rng.normal(size=(3, 4, 85))).astype(np.complex64)
    got = ofdm_v2._smooth_complex(torch.from_numpy(h), win)
    one = jax.vmap(lambda r: _smooth_complex(r, win))
    want = np.stack([np.asarray(one(jnp.asarray(b))) for b in h])
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


# --- the Schmidl-Cox refine ------------------------------------------------------------------


def metric64(cfg, x: np.ndarray, start: int) -> tuple[np.ndarray, int]:
    """(M(d) in float64 over the 2·sc_search lags, the first lag's position)."""
    half = cfg.n_fft // 2
    body_off = cfg.preamble_len + cfg.guard_samples
    base = max(start + body_off + cfg.cp_len - cfg.sc_search, 0)
    pad = np.concatenate([x, np.zeros(cfg.n_fft + 4 * cfg.sc_search, np.float32)])
    r = pad.astype(np.float64)
    m = []
    for d in range(2 * cfg.sc_search):
        a = r[base + d:base + d + half]
        b = r[base + d + half:base + d + 2 * half]
        p, r2 = (a * b).sum(), (b * b).sum()
        m.append(p * p / max(r2 * r2, 1e-12))
    return np.asarray(m), base


@pytest.mark.parametrize("name", list(CORPORA))
def test_sc_refine_matches_jax_under_the_plateau_rule(name):
    import jax.numpy as jnp

    from trackmaker_tpu.phy.ofdm_v2 import _sc_refine

    x = CORPORA[name][1]
    st = jax_starts(name)
    st = st[st >= 0]
    got = ofdm_v2._sc_refine(CFG, torch.from_numpy(x)[None], torch.from_numpy(st)[None])[0]
    want = jax_once(("refine", name), lambda: np.asarray(
        _sc_refine(_jcfg(CFG), jnp.asarray(x), jnp.asarray(st))))
    off = CFG.cp_len + CFG.preamble_len + CFG.guard_samples
    n_clear = 0
    for s, g, w in zip(st, got.numpy(), want):
        m, base = metric64(CFG, x, int(s))
        top = np.sort(m)[::-1]
        if top[0] - top[1] > PLATEAU * top[0]:
            assert g == w, (name, s)
            n_clear += 1
        else:
            for pick in (g, w):
                assert m[pick + off - base] >= (1 - PLATEAU) * top[0], (name, s, pick)
    m_t, base_t = ofdm_v2.sc_metric(CFG, torch.from_numpy(x)[None], torch.from_numpy(st)[None])
    for i, s in enumerate(st):
        m, base = metric64(CFG, x, int(s))
        assert int(base_t[0, i]) == base
        np.testing.assert_allclose(m_t[0, i].numpy(), m, rtol=1e-4, atol=1e-12)
    if name == "noise":
        assert n_clear > 0


# --- demodulation --------------------------------------------------------------------------


def _demod_cases():
    cases = []
    for name in CORPORA:
        size = len(CORPORA[name][0][0].data)
        n_bits = (7 + size) * 8
        cases.append((name, n_bits, None, "default"))
    cases += [("noise", 56, None, "default"), ("one_symbol", 56, None, "default"),
              ("noise", 6 * 148, 3, "default"), ("long", 12 * 148, 9, "default"),
              ("noise", (7 + 40) * 8, None, "no_tracking")]
    return cases


@pytest.mark.parametrize("name,n_bits,vsym,mode", _demod_cases())
def test_demodulate_at_v2_bits_match_jax(name, n_bits, vsym, mode):
    """Bits equal to JAX's: every corpus (clean, noise, one data symbol, nine,
    +-200 ppm, an echo inside the cyclic prefix), the header's 56 bits,
    frames demodulated at a larger size with `vsyms` (the real symbols'
    bits compared), and the three tracking switches off."""
    import jax.numpy as jnp

    from trackmaker_tpu.phy.ofdm_v2 import demodulate_at_v2

    cfg = CFG if mode == "default" else NO_TRACK
    frames, x = CORPORA[name]
    st = jax_starts(name)
    st = st[st >= 0]
    np.testing.assert_array_equal(port_starts(name).numpy(), jax_starts(name))
    n_real = cfg.n_symbols((7 + len(frames[0].data)) * 8)
    vs = None if vsym is None else np.full(len(st), vsym, np.int32)
    got = ofdm_v2.demodulate_at_v2(cfg, torch.from_numpy(x), n_bits, torch.from_numpy(st),
                                   None if vs is None else torch.from_numpy(vs))
    want = np.asarray(demodulate_at_v2(_jcfg(cfg), jnp.asarray(x), n_bits, jnp.asarray(st),
                                       None if vs is None else jnp.asarray(vs)))
    keep = min(n_bits, (vsym or n_real) * cfg.bits_per_symbol)
    np.testing.assert_array_equal(got.numpy()[:, :keep], want[:, :keep])
    sym = ofdm_v2.symbols_v2(cfg, torch.from_numpy(x), cfg.n_symbols(n_bits),
                             torch.from_numpy(st), None if vs is None else torch.from_numpy(vs))
    assert margin(sym[:, :min(n_real, cfg.n_symbols(n_bits))]) >= MARGIN
    if n_bits >= (7 + len(frames[0].data)) * 8:
        assert [Frame.from_bits(r) for r in got.numpy()] == frames
    if vsym is not None:       # an int gives the same bits as a tensor of it
        alone = ofdm_v2.demodulate_at_v2(cfg, torch.from_numpy(x), n_bits,
                                         torch.from_numpy(st), vsym)
        assert torch.equal(alone, got)


# --- the stream PHY and the modem --------------------------------------------------------------


def stream_track_v2(seed: int) -> np.ndarray:
    phy = ofdm_v2.OfdmStreamPhyV2(CFG, device="cpu")
    return stream_track(phy.encode_frame, lambda b: ofdm_v2.modulate_bits_v2(
        CFG, torch.from_numpy(b)[None], len(b))[0].numpy(), seed)


@pytest.mark.parametrize("addr,seed", [(2, 31), (None, 32)])
def test_stream_phy_v2_matches_jax_call_for_call(addr, seed):
    from trackmaker_tpu.phy.ofdm_v2 import OfdmStreamPhyV2 as JaxOfdmStreamPhyV2

    x = stream_track_v2(seed=30)
    got = drive(ofdm_v2.OfdmStreamPhyV2(CFG, local_addr=addr, device="cpu"), x, seed)
    want = jax_drive(f"v2{addr}{seed}", lambda: JaxOfdmStreamPhyV2(_jcfg(CFG), local_addr=addr),
                     x, seed)
    assert got == want
    seen = [f for fs, _ in got for f in fs]
    assert len(seen) == (4 if addr == 2 else 5)


def test_stream_phy_v2_encoder_and_checks():
    from trackmaker_tpu.phy.ofdm_v2 import OfdmStreamPhyV2 as JaxOfdmStreamPhyV2

    frames = [Frame.new_data(0, 1, 2, b"variable"), Frame.new_ack(0, 1, 2)]
    got = ofdm_v2.OfdmStreamPhyV2(device="cpu").encode_frames(frames, gap_samples=300)
    want = JaxOfdmStreamPhyV2().encode_frames(frames, gap_samples=300)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert ofdm_v2.OfdmStreamPhyV2(device="cpu").frame_samples(9) == \
        JaxOfdmStreamPhyV2().frame_samples(9)
    with pytest.raises(ValueError):
        ofdm_v2.OfdmStreamPhyV2(ofdm_v2.OfdmV2Config(bin_lo=22, bin_hi=50), device="cpu")


@pytest.mark.parametrize("name", ["noise", "ppm-200"])
def test_modem_v2_decodes_as_jax(name):
    from trackmaker_tpu.phy.ofdm_v2 import OfdmModemV2 as JaxOfdmModemV2

    frames, x = CORPORA[name]
    got = ofdm_v2.OfdmModemV2(CFG, device="cpu").decode(x, 7 + 40, max_frames=6)
    want = jax_once(("modem", name), lambda: JaxOfdmModemV2(_jcfg(CFG)).decode(
        x, 7 + 40, max_frames=6))
    assert got == frames
    assert [dataclasses.astuple(f) for f in want] == [dataclasses.astuple(f) for f in got]
    assert ofdm_v2.OfdmModemV2(CFG, device="cpu").decode(np.zeros(3000, np.float32), 47) == []


def test_entry_points_default_to_the_card():
    for cls in (ofdm_v2.OfdmStreamPhyV2, ofdm_v2.OfdmModemV2):
        assert inspect.signature(cls).parameters["device"].default == "cuda"
    assert ofdm_v2.OfdmStreamPhyV2().device == torch.device("cuda")


# --- chip_smoke.py's ofdm_v2_b32 --------------------------------------------------------------


def test_chip_smoke_ofdm_digest_is_the_jax_packages():
    """OFDM_DIGEST, which the port's run on the card must equal, is the JAX
    package's decisions (bench.py's jit(vmap) of find_preambles and
    demodulate_at_v2) on chip_smoke.py's ofdm_v2_b32 captures; the port's
    CPU run gives the same, every payload decodes, and every decision
    keeps its margin."""
    import jax
    import jax.numpy as jnp

    from trackmaker_tpu.phy import ofdm as jofdm
    from trackmaker_tpu.phy.ofdm_v2 import demodulate_at_v2

    frames, caps = chip_smoke.ofdm_input()
    assert caps.shape == (chip_smoke.OFDM_BATCH, 130_928)
    j = _jcfg(CFG)
    n_bits = (7 + chip_smoke.OFDM_PAYLOAD) * 8
    f = chip_smoke.OFDM_FRAMES
    x = jnp.asarray(caps)
    sj = np.asarray(jax.jit(jax.vmap(lambda rx: jofdm.find_preambles(j, rx, f)))(x))
    bj = np.asarray(jax.jit(jax.vmap(lambda rx, s: demodulate_at_v2(j, rx, n_bits, s)))(
        x, jnp.asarray(sj)))
    assert chip_smoke.ofdm_digest(sj, bj) == chip_smoke.OFDM_DIGEST
    xp = torch.from_numpy(caps)
    sp = ofdm.find_preambles(CFG, xp, f)
    bp = ofdm_v2.demodulate_at_v2(CFG, xp, n_bits, sp)
    np.testing.assert_array_equal(sp.numpy(), sj)
    np.testing.assert_array_equal(bp.numpy(), bj)
    assert all(Frame.from_bits(bp[r, k].numpy()) == frames[k]
               for r in range(len(caps)) for k in range(f))
    assert margin(ofdm_v2.symbols_v2(CFG, xp, CFG.n_symbols(n_bits), sp)) >= MARGIN


# --- on the card -------------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(CORPORA))
def test_v2_on_the_card_equals_the_cpu(cuda, name):
    """Starts and bits on the card equal the port's CPU run; the refined
    starts equal it, or lie on the CPU metric's plateau."""
    frames, x = CORPORA[name]
    n_bits = (7 + len(frames[0].data)) * 8
    xc, xh = torch.from_numpy(x).to(cuda), torch.from_numpy(x)
    st_c, st_h = ofdm.find_preambles(CFG, xc, 6), ofdm.find_preambles(CFG, xh, 6)
    assert torch.equal(st_c.cpu(), st_h)
    st = st_h[st_h >= 0]
    bits = ofdm_v2.demodulate_at_v2(CFG, xc, n_bits, st.to(cuda))
    assert torch.equal(bits.cpu(), ofdm_v2.demodulate_at_v2(CFG, xh, n_bits, st))
    fine = ofdm_v2._sc_refine(CFG, xc[None], st.to(cuda)[None]).cpu()
    m, base = ofdm_v2.sc_metric(CFG, xh[None], st[None])
    picked = m[0].gather(-1, (fine[0] - base[0] + CFG.cp_len + CFG.preamble_len
                              + CFG.guard_samples)[:, None])[:, 0]
    assert bool((picked >= (1 - PLATEAU) * m[0].amax(-1)).all())


@pytest.mark.gpu
def test_stream_phy_v2_on_the_card_equals_the_cpu(cuda):
    x = stream_track_v2(seed=30)
    assert drive(ofdm_v2.OfdmStreamPhyV2(CFG, local_addr=2, device=cuda), x, 31) == \
        drive(ofdm_v2.OfdmStreamPhyV2(CFG, local_addr=2, device="cpu"), x, 31)


@pytest.mark.gpu
def test_chip_smoke_ofdm_batch_on_the_card(cuda):
    frames, caps = chip_smoke.ofdm_input()
    n_bits = (7 + chip_smoke.OFDM_PAYLOAD) * 8
    xc = torch.from_numpy(caps).to(cuda)
    sp = ofdm.find_preambles(CFG, xc, chip_smoke.OFDM_FRAMES)
    bp = ofdm_v2.demodulate_at_v2(CFG, xc, n_bits, sp)
    assert chip_smoke.ofdm_digest(sp.cpu().numpy(), bp.cpu().numpy()) == chip_smoke.OFDM_DIGEST
