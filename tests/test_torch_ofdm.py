"""The port's frame bits, forward error correction and OFDM v1 modem
(``trackmaker_tpu_torch.core.framing``, ``core.fec``, ``phy.ofdm``)
against the JAX package's, on the CPU, and on the card against the port's
CPU run.

The corpora are built by the port (its modulator on the CPU, NumPy noise
and echoes), so the tests marked ``gpu`` build them on a card without JAX:
this module imports JAX only inside its tests, and each JAX result it
compares with more than once is computed once a session.

Tolerances, each with its reason:
* the QPSK map: equal (both look up the same complex64 table);
* time symbols and waveforms: atol 1e-6 (another FFT library; values up to
  about 1.5, measured below 1e-7);
* window spectra: within 1e-4 of the largest bin magnitude (FFTs of 512
  samples in another order, and the de-ramp's f32 phase);
* the chirp correlation: ``chip_smoke.CORR_ATOL`` (another sum order);
* soft metrics: atol 1e-4 (values in [-1, 1]);
* starts, bits, frames and buffer lengths: equal.  Each corpus asserts
  that every QPSK decision lies at least 1e-3 of the symbols' RMS from its
  boundary, so that equal bits mean equal decisions and not luck.
"""

import dataclasses
import inspect

import numpy as np
import pytest
import torch

import chip_smoke
from trackmaker_tpu_torch import convert
from trackmaker_tpu_torch.core import fec
from trackmaker_tpu_torch.core.framing import Frame
from trackmaker_tpu_torch.phy import ofdm

CFG = ofdm.OfdmConfig()
CFG24 = ofdm.OfdmConfig(cp_len=24)        # sym_len 536: the nominal-window fallback
LEADS = (0, 5, 31, 97, 200)
MARGIN = 1e-3
SPEC_RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread while this module runs: the suite runs a worker per
    core, and torch's own thread pool on top of that oversubscribes them."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _jcfg(cfg):
    from trackmaker_tpu.phy.ofdm import OfdmConfig as JaxOfdmConfig

    return JaxOfdmConfig(**dataclasses.asdict(cfg))


def frames_of(seed: int, n: int, size: int, dst: int = 2) -> list[Frame]:
    rng = np.random.default_rng(seed)
    return [Frame.new_data(i, 1, dst, rng.integers(0, 256, size, dtype=np.uint8).tobytes())
            for i in range(n)]


def capture(cfg, frames, lead: int, sigma: float, seed: int, gap: int = 300,
            tail: int = 1500) -> np.ndarray:
    """`frames` modulated by the port on the CPU, `lead` zeros before them,
    `gap` between them and `tail` after, and NumPy noise of `sigma`."""
    rng = np.random.default_rng(seed)
    wave = ofdm.OfdmModem(cfg, device="cpu").encode_frames(frames, gap_samples=gap)
    x = np.concatenate([np.zeros(lead, np.float32), wave, np.zeros(tail, np.float32)])
    return (x + rng.normal(0, sigma, len(x))).astype(np.float32) if sigma else x


def batch(cfg, leads, sigma: float, size: int = 24) -> np.ndarray:
    """One capture a lead-in, the same 3 frames, cut to a common length."""
    caps = [capture(cfg, frames_of(1, 3, size), lead, sigma, seed=10 + lead) for lead in leads]
    t = min(len(c) for c in caps)
    return np.stack([c[:t] for c in caps])


def margin(eq: torch.Tensor) -> float:
    rms = eq.abs().pow(2).mean().sqrt()
    return (torch.minimum(eq.real.abs(), eq.imag.abs()).min() / rms).item()


def v1_symbols(cfg, x: torch.Tensor, starts: torch.Tensor, n_sym: int) -> torch.Tensor:
    eq, _ = ofdm._equalize_v1(cfg, ofdm._windows_spectrum(cfg, x, starts, n_sym))
    return eq


# --- frame bits and FEC -----------------------------------------------------------------


@pytest.mark.parametrize("data", [b"", b"x", bytes(range(64)), bytes(200)])
def test_frame_bits_match_jax(data):
    from trackmaker_tpu.core.framing import Frame as JaxFrame

    ours, theirs = Frame.new_data(9, 1, 2, data), JaxFrame.new_data(9, 1, 2, data)
    bits = ours.to_bits()
    np.testing.assert_array_equal(bits, theirs.to_bits())
    assert bits.dtype == np.uint8 and len(bits) == 8 * (7 + len(data))
    assert Frame.from_bits(bits) == ours
    assert dataclasses.astuple(JaxFrame.from_bits(bits)) == dataclasses.astuple(ours)
    for cut in (bits[:-3], np.concatenate([bits, [1, 0, 1]])):   # a partial byte, padded
        got, want = Frame.from_bits(cut), JaxFrame.from_bits(cut)
        assert (got is None) == (want is None)
        if got is not None:
            assert dataclasses.astuple(got) == dataclasses.astuple(want)
    bad = bits.copy()
    bad[20] ^= 1                                   # the CRC byte
    assert Frame.from_bits(bad) is None and JaxFrame.from_bits(bad) is None


@pytest.mark.parametrize("n_bits,depth", [(56, 16), (71 * 8, 16), (13, 4), (4, 1), (400, 7)])
def test_fec_matches_jax(n_bits, depth):
    """Hamming(7,4) and the interleaver bit for bit, with one flipped bit in
    some codewords (corrected) and two in others (as JAX decodes them)."""
    import jax.numpy as jnp

    from trackmaker_tpu.core import fec as jfec

    rng = np.random.default_rng(n_bits)
    bits = rng.integers(0, 2, (3, n_bits)).astype(np.uint8)
    code = fec.hamming74_encode(torch.from_numpy(bits))
    np.testing.assert_array_equal(code.numpy(), np.asarray(jfec.hamming74_encode(jnp.asarray(bits))))
    assert fec.coded_len(n_bits) == jfec.coded_len(n_bits) == code.shape[-1]
    noisy = code.numpy().copy()
    k = noisy.shape[-1] // 7
    for r in range(3):
        for c in rng.choice(k, min(k, 5), replace=False):
            noisy[r, 7 * c + rng.integers(0, 7)] ^= 1
        if k > 6:
            noisy[r, 7 * (k - 1)] ^= 1
            noisy[r, 7 * (k - 1) + 3] ^= 1
    got = fec.hamming74_decode(torch.from_numpy(noisy)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jfec.hamming74_decode(jnp.asarray(noisy))))
    whole = 4 * (k - 1) if k > 6 else n_bits       # the codewords with one error at most
    np.testing.assert_array_equal(got[:, :whole], bits[:, :whole])
    inter = fec.interleave(code, depth)
    np.testing.assert_array_equal(inter.numpy(),
                                  np.asarray(jfec.interleave(jnp.asarray(code.numpy()), depth)))
    back = fec.deinterleave(inter, depth, code.shape[-1])
    assert torch.equal(back, code)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jfec.deinterleave(jnp.asarray(inter.numpy()), depth,
                                                   code.shape[-1])))
    with pytest.raises(ValueError):
        fec.hamming74_decode(code[..., :-1])


# --- configuration, the QPSK map, the modulator ---------------------------------------------


def test_config_matches_jax():
    from trackmaker_tpu.phy.ofdm import OfdmConfig as JaxOfdmConfig
    from trackmaker_tpu.phy.ofdm import _pilot_symbols as jax_pilots

    ours = [(f.name, f.default) for f in dataclasses.fields(ofdm.OfdmConfig)]
    assert ours == [(f.name, f.default) for f in dataclasses.fields(JaxOfdmConfig)]
    for cfg in (CFG, CFG24, ofdm.OfdmConfig(bin_lo=30, bin_hi=60, pilot_seed=3)):
        j = _jcfg(cfg)
        for n in (1, 56, 170, 171, 2000):
            assert cfg.n_symbols(n) == j.n_symbols(n)
            assert cfg.frame_samples(n) == j.frame_samples(n)
        assert (cfg.n_bins, cfg.bits_per_symbol, cfg.sym_len) == (j.n_bins, j.bits_per_symbol,
                                                                   j.sym_len)
        np.testing.assert_array_equal(ofdm._pilot_symbols(cfg), jax_pilots(j))
        assert convert.ofdm_config_from_fields(dataclasses.asdict(j)) == cfg
    with pytest.raises(KeyError):
        convert.ofdm_config_from_fields({"n_fft": 256, "no_such_field": 1})


def test_qpsk_map_matches_jax():
    import jax.numpy as jnp

    from trackmaker_tpu.phy.ofdm import _bits_to_qpsk, _qpsk_to_bits

    bits = np.random.default_rng(0).integers(0, 2, (3, 170)).astype(np.uint8)
    sym = ofdm._bits_to_qpsk(torch.from_numpy(bits))
    want = np.asarray(_bits_to_qpsk(jnp.asarray(bits)))
    assert sym.dtype == torch.complex64
    np.testing.assert_array_equal(sym.numpy(), want)
    np.testing.assert_array_equal(ofdm._qpsk_to_bits(sym).numpy(), bits)
    np.testing.assert_array_equal(np.asarray(_qpsk_to_bits(jnp.asarray(want))), bits)


@pytest.mark.parametrize("cfg", [CFG, CFG24], ids=["cp128", "cp24"])
def test_spectrum_to_time_and_modulator_match_jax(cfg):
    import jax.numpy as jnp

    from trackmaker_tpu.phy.ofdm import _spectrum_to_time, _time_to_spectrum, modulate_bits

    rng = np.random.default_rng(1)
    subs = (rng.normal(size=(2, 3, cfg.n_bins)) + 1j * rng.normal(size=(2, 3, cfg.n_bins))
            ).astype(np.complex64)
    got = ofdm._spectrum_to_time(cfg, torch.from_numpy(subs))
    want = np.asarray(_spectrum_to_time(_jcfg(cfg), jnp.asarray(subs)))
    assert got.dtype == torch.float32 and got.shape == (2, 3, cfg.sym_len)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    back = ofdm._time_to_spectrum(cfg, got)
    np.testing.assert_allclose(back.numpy(), np.asarray(_time_to_spectrum(
        _jcfg(cfg), jnp.asarray(got.numpy()))), rtol=0, atol=1e-4)
    scale = np.float32(cfg.amplitude * cfg.n_fft / cfg.n_bins)
    np.testing.assert_allclose(back.numpy(), subs * scale, rtol=0, atol=1e-4)
    for n_bits in (56, 200):
        bits = rng.integers(0, 2, (2, n_bits)).astype(np.uint8)
        w = ofdm.modulate_bits(cfg, torch.from_numpy(bits), n_bits)
        assert w.shape == (2, cfg.frame_samples(n_bits))
        np.testing.assert_allclose(w.numpy(), np.asarray(modulate_bits(
            _jcfg(cfg), jnp.asarray(bits), n_bits)), rtol=0, atol=1e-6)


# --- windows, sync, demodulation ------------------------------------------------------------


@pytest.mark.parametrize("cfg", [CFG, CFG24], ids=["aligned", "cp24"])
def test_windows_spectrum_matches_jax(cfg):
    """Both fetches (the 32-aligned back-off with its de-ramp; the nominal
    windows at cp_len=24) at starts of every offset mod 32, near both ends
    of the capture, within 1e-4 of the largest bin magnitude."""
    import jax.numpy as jnp

    from trackmaker_tpu.phy.ofdm import _windows_spectrum

    x = capture(cfg, frames_of(2, 2, 40), 50, 0.01, seed=3)
    starts = np.array([0, 1, 17, 31, 32, 50, 63, 1000, len(x) - 9000, len(x) - 600],
                      np.int32)
    n_sym = 2
    got = ofdm._windows_spectrum(cfg, torch.from_numpy(x)[None], torch.from_numpy(starts)[None],
                                 n_sym)[0].numpy()
    want = np.asarray(_windows_spectrum(_jcfg(cfg), jnp.asarray(x), jnp.asarray(starts), n_sym))
    assert got.shape == want.shape == (len(starts), 1 + n_sym, cfg.n_bins)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= SPEC_RTOL * scale


def test_windows_spectrum_backoff_is_nominal_window():
    """The de-ramped back-off fetch gives the nominal window's spectrum: the
    fallback's windows at cp_len=128 equal it within 1e-4 of the largest
    bin on a clean capture (the cyclic prefix holds the same samples)."""
    x = torch.from_numpy(capture(CFG, frames_of(4, 1, 40), 77, 0.0, seed=0))[None]
    starts = torch.tensor([[77]])
    got = ofdm._windows_spectrum(CFG, x, starts, 2)
    body_off = CFG.preamble_len + CFG.guard_samples
    nominal = torch.stack([ofdm._time_to_spectrum(CFG, x[0, 77 + body_off + i * CFG.sym_len:
                                                        77 + body_off + (i + 1) * CFG.sym_len])
                           for i in range(3)])
    assert (got[0, 0] - nominal).abs().max() <= SPEC_RTOL * nominal.abs().max()


_JAX_STARTS: dict = {}


def jax_starts(key: str, x: np.ndarray, cfg, max_frames: int) -> tuple[np.ndarray, np.ndarray]:
    """(JAX's starts, JAX's CPU corr) of each row of x, once a session."""
    if key not in _JAX_STARTS:
        import jax.numpy as jnp

        from trackmaker_tpu import sync as jsync
        from trackmaker_tpu.dsp.osc import chirp_cached
        from trackmaker_tpu.phy.ofdm import find_preambles

        j = _jcfg(cfg)
        pre = chirp_cached(j.preamble_len, j.chirp_lo_hz, j.chirp_hi_hz, j.sample_rate)
        _JAX_STARTS[key] = (
            np.stack([np.asarray(find_preambles(j, jnp.asarray(r), max_frames)) for r in x]),
            np.stack([np.asarray(jsync.auto_xcorr(jnp.asarray(r), pre)) for r in x]))
    return _JAX_STARTS[key]


@pytest.mark.parametrize("sigma", [0.0, 0.01])
def test_find_preambles_batched_matches_jax(sigma):
    """Starts equal to JAX's at lead-ins 0, 5, 31, 97 and 200 in one batch,
    -1 padding included, the correlation within CORR_ATOL of JAX's."""
    x = batch(CFG, LEADS, sigma)
    want, corr_j = jax_starts(f"batch{sigma}", x, CFG, 6)
    got = ofdm.find_preambles(CFG, torch.from_numpy(x), 6)
    assert got.dtype == torch.int32 and got.shape == (len(LEADS), 6)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want >= 0).sum(-1).tolist() == [3] * len(LEADS)
    assert want[:, 0].tolist() == list(LEADS) and np.all(want[:, 3:] == -1)
    corr = ofdm.preamble_corr(CFG, torch.from_numpy(x))
    assert np.abs(corr.numpy() - corr_j).max() <= chip_smoke.CORR_ATOL
    one = ofdm.find_preambles(CFG, torch.from_numpy(x[2]), 6)
    np.testing.assert_array_equal(one.numpy(), want[2])


def test_find_preambles_capture_ending_inside_a_frame():
    """A capture cut inside its last frame's body, one cut inside the last
    preamble, and max_frames below the count: starts equal to JAX's."""
    x = capture(CFG, frames_of(5, 3, 30), 97, 0.01, seed=6, tail=0)
    step = CFG.frame_samples((7 + 30) * 8) + 300
    third = 97 + 2 * step
    body = CFG.preamble_len + CFG.guard_samples + 700
    cuts = np.stack([x[:third + body], x[:third + body]])
    cuts[1, :step] = 0.0                   # the first frame silent: two found
    want, _ = jax_starts("cut", cuts, CFG, 4)
    np.testing.assert_array_equal(ofdm.find_preambles(CFG, torch.from_numpy(cuts), 4).numpy(),
                                  want)
    assert want.tolist() == [[97, 97 + step, third, -1], [97 + step, third, -1, -1]]
    inside_pre = x[:third + 200][None]
    w2, _ = jax_starts("cut_pre", inside_pre, CFG, 4)
    np.testing.assert_array_equal(
        ofdm.find_preambles(CFG, torch.from_numpy(inside_pre), 4).numpy(), w2)
    assert w2.tolist() == [[97, 97 + step, -1, -1]]
    w3, _ = jax_starts("few", x[None], CFG, 2)
    np.testing.assert_array_equal(ofdm.find_preambles(CFG, torch.from_numpy(x)[None], 2).numpy(),
                                  w3)
    assert w3.tolist() == [[97, 97 + step]]


@pytest.mark.parametrize("cfg", [CFG, CFG24], ids=["aligned", "cp24"])
def test_demodulate_at_matches_jax(cfg):
    """Hard bits equal to JAX's, soft metrics within 1e-4, with margins."""
    import jax.numpy as jnp

    from trackmaker_tpu.phy.ofdm import demodulate_at, demodulate_soft_at

    frames = frames_of(7, 3, 40)
    n_bits = (7 + 40) * 8
    x = capture(cfg, frames, 31, 0.02, seed=8)
    starts = ofdm.find_preambles(cfg, torch.from_numpy(x), 4)
    st = starts[starts >= 0]
    bits = ofdm.demodulate_at(cfg, torch.from_numpy(x), n_bits, st)
    want = np.asarray(demodulate_at(_jcfg(cfg), jnp.asarray(x), n_bits, jnp.asarray(st.numpy())))
    np.testing.assert_array_equal(bits.numpy(), want)
    assert [Frame.from_bits(r) for r in bits.numpy()] == frames
    assert margin(v1_symbols(cfg, torch.from_numpy(x)[None], st[None],
                             cfg.n_symbols(n_bits))) >= MARGIN
    soft = ofdm.demodulate_soft_at(cfg, torch.from_numpy(x), n_bits, st)
    np.testing.assert_allclose(soft.numpy(), np.asarray(demodulate_soft_at(
        _jcfg(cfg), jnp.asarray(x), n_bits, jnp.asarray(st.numpy()))), rtol=0, atol=1e-4)
    np.testing.assert_array_equal((soft.numpy() > 0).astype(np.uint8), want)


def test_demod_symbols_at_matches_jax():
    """The stream PHY's nominal-window demodulation, bits equal, at a start
    near the capture's end (the padded slice) too."""
    import jax.numpy as jnp

    from trackmaker_tpu.phy.ofdm import _demod_symbols_at

    frames = frames_of(9, 2, 100)
    n_syms = CFG.n_symbols((7 + 100) * 8)
    x = capture(CFG, frames, 5, 0.02, seed=9)
    starts = ofdm.find_preambles(CFG, torch.from_numpy(x), 3).numpy()
    for s in [int(v) for v in starts[starts >= 0]] + [len(x) - 3000]:
        got = ofdm._demod_symbols_at(CFG, n_syms, torch.from_numpy(x), torch.tensor(s))
        want = np.asarray(_demod_symbols_at(_jcfg(CFG), n_syms, jnp.asarray(x),
                                            jnp.asarray(s)))
        np.testing.assert_array_equal(got.numpy(), want)
    for s, frame in zip(starts[:2], frames):
        bits = ofdm._demod_symbols_at(CFG, n_syms, torch.from_numpy(x), torch.tensor(int(s)))
        assert Frame.from_bits(bits.numpy()[:(7 + 100) * 8]) == frame
        body_off = CFG.preamble_len + CFG.guard_samples
        seg = torch.from_numpy(x[s + body_off:s + body_off + (1 + n_syms) * CFG.sym_len])
        eq, _ = ofdm._equalize_v1(CFG, ofdm._time_to_spectrum(CFG, seg.reshape(1 + n_syms, -1)))
        assert margin(eq) >= MARGIN


# --- the stream PHY and the modem ------------------------------------------------------------


def stream_track(encode_frame, modulate, seed: int) -> np.ndarray:
    """A live track for a stream PHY (`encode_frame`: Frame -> samples,
    `modulate`: bits -> samples): frames of 1 to 200 bytes to addresses 2
    and 3, a header whose length field (300) exceeds the largest frame, an
    ACK, gaps of random length, noise sigma 0.01."""
    rng = np.random.default_rng(seed)
    parts = [np.zeros(700, np.float32)]
    for i, (dst, n) in enumerate([(2, 12), (3, 40), (2, 1), (2, 200)]):
        payload = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        parts += [encode_frame(Frame.new_data(i, 1, dst, payload)),
                  np.zeros(int(rng.integers(50, 1500)), np.float32)]
    bad = Frame.new_data(9, 1, 2, bytes(16)).to_bits()
    bad[:16] = np.unpackbits(np.array([1, 44], np.uint8))        # length field 300
    parts += [modulate(bad), np.zeros(900, np.float32),
              encode_frame(Frame.new_ack(4, 1, 2)), np.zeros(2500, np.float32)]
    x = np.concatenate(parts)
    return (x + rng.normal(0, 0.01, len(x))).astype(np.float32)


def stream_track_v1(seed: int) -> np.ndarray:
    phy = ofdm.OfdmStreamPhy(CFG, device="cpu")
    return stream_track(phy.encode_frame, lambda b: ofdm.modulate_bits(
        CFG, torch.from_numpy(b)[None], len(b))[0].numpy(), seed)


def drive(phy, x: np.ndarray, seed: int) -> list:
    """Feed x in random chunks; after each call, its frames and the buffer
    length kept."""
    rng = np.random.default_rng(seed)
    out, i = [], 0
    while i < len(x):
        n = int(rng.integers(300, 6000))
        got = phy.process_samples(x[i:i + n])
        out.append(([dataclasses.astuple(f) for f in got], len(phy._buf)))
        i += n
    return out


_JAX_DRIVES: dict = {}


def jax_drive(key: str, make, x: np.ndarray, seed: int) -> list:
    if key not in _JAX_DRIVES:
        _JAX_DRIVES[key] = drive(make(), x, seed)
    return _JAX_DRIVES[key]


@pytest.mark.parametrize("addr", [2, None])
def test_stream_phy_matches_jax_call_for_call(addr):
    from trackmaker_tpu.phy.ofdm import OfdmStreamPhy as JaxOfdmStreamPhy

    x = stream_track_v1(seed=11)
    got = drive(ofdm.OfdmStreamPhy(CFG, local_addr=addr, device="cpu"), x, 12)
    want = jax_drive(f"v1{addr}", lambda: JaxOfdmStreamPhy(_jcfg(CFG), local_addr=addr), x, 12)
    assert got == want
    seen = [f for fs, _ in got for f in fs]
    assert len(seen) == (4 if addr == 2 else 5) and all(f[3] == addr for f in seen if addr)


def test_stream_phy_encoder_matches_jax():
    from trackmaker_tpu.phy.ofdm import OfdmStreamPhy as JaxOfdmStreamPhy

    frames = [Frame.new_data(0, 1, 2, b"abc"), Frame.new_ack(1, 2, 1)]
    got = ofdm.OfdmStreamPhy(CFG, device="cpu").encode_frames(frames, gap_samples=100)
    want = JaxOfdmStreamPhy(_jcfg(CFG)).encode_frames(frames, gap_samples=100)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert ofdm.OfdmStreamPhy(CFG, device="cpu").frame_samples(3) == \
        JaxOfdmStreamPhy(_jcfg(CFG)).frame_samples(3)


@pytest.mark.parametrize("fec_mode,sigma", [(None, 0.02), ("hamming", 0.02), (True, 0.0)])
def test_modem_decodes_as_jax(fec_mode, sigma):
    from trackmaker_tpu.phy.ofdm import OfdmModem as JaxOfdmModem

    frames = frames_of(13, 4, 33)
    modem = ofdm.OfdmModem(CFG, fec=fec_mode, device="cpu")
    jmodem = JaxOfdmModem(_jcfg(CFG), fec=fec_mode)
    wave = modem.encode_frames(frames, gap_samples=200)
    np.testing.assert_allclose(wave, jmodem.encode_frames(frames, gap_samples=200),
                               rtol=0, atol=1e-6)
    rx = (wave + np.random.default_rng(14).normal(0, sigma, len(wave))).astype(np.float32)
    got = modem.decode(rx, 7 + 33, max_frames=6)
    assert got == frames
    assert [dataclasses.astuple(f) for f in jmodem.decode(rx, 7 + 33, max_frames=6)] == \
        [dataclasses.astuple(f) for f in got]
    assert modem.decode(np.zeros(5000, np.float32), 40) == []


def test_modem_conv_fec_is_not_ported_yet():
    """Kept under its first name, from before core/convcode.py was ported:
    fec="conv" now builds, sends 2·(n + 6) coded bits a frame and round-trips
    clean frames; an unknown fec is refused."""
    modem = ofdm.OfdmModem(CFG, fec="conv", device="cpu")
    assert modem._tx_len(47 * 8) == 2 * (47 * 8 + 6)
    frames = [Frame.new_data(i, 1, 2, bytes([i]) * 40) for i in range(2)]
    wave = np.concatenate([np.zeros(300, np.float32), modem.encode_frames(frames, 200),
                           np.zeros(1000, np.float32)])
    assert modem.decode(wave, 47, 4) == frames
    with pytest.raises(ValueError):
        ofdm.OfdmModem(CFG, fec="turbo", device="cpu")


def test_entry_points_default_to_the_card():
    for cls in (ofdm.OfdmStreamPhy, ofdm.OfdmModem):
        assert inspect.signature(cls).parameters["device"].default == "cuda"
    assert ofdm.OfdmStreamPhy().device == torch.device("cuda")


# --- on the card ------------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_v1_on_the_card_equals_the_cpu(cuda):
    """find_preambles (#2 on the card), demodulate_at, the soft metrics and
    the stream PHY, call for call, against the port's CPU run."""
    from trackmaker_tpu_torch.sync import xcorr_norm

    x = batch(CFG, LEADS, 0.01)
    xc = torch.from_numpy(x).to(cuda)
    before = xcorr_norm.normalized_xcorr_dense.launches
    got = ofdm.find_preambles(CFG, xc, 6)
    assert xcorr_norm.normalized_xcorr_dense.launches == before + 1
    want = ofdm.find_preambles(CFG, torch.from_numpy(x), 6)
    assert torch.equal(got.cpu(), want)
    n_bits = (7 + 24) * 8
    bits = ofdm.demodulate_at(CFG, xc, n_bits, got)
    assert torch.equal(bits.cpu(), ofdm.demodulate_at(CFG, torch.from_numpy(x), n_bits, want))
    soft = ofdm.demodulate_soft_at(CFG, xc, n_bits, got)
    np.testing.assert_allclose(soft.cpu().numpy(), ofdm.demodulate_soft_at(
        CFG, torch.from_numpy(x), n_bits, want).numpy(), rtol=0, atol=1e-4)
    track = stream_track_v1(seed=11)
    assert drive(ofdm.OfdmStreamPhy(CFG, local_addr=2, device=cuda), track, 12) == \
        drive(ofdm.OfdmStreamPhy(CFG, local_addr=2, device="cpu"), track, 12)
    modem = ofdm.OfdmModem(CFG, fec="hamming", device=cuda)
    frames = frames_of(13, 4, 33)
    assert modem.decode(modem.encode_frames(frames), 40, 6) == frames
