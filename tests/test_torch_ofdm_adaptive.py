"""The port's adaptive bit-loading OFDM (``trackmaker_tpu_torch.phy.ofdm_adaptive``:
the QAM maps, the loaded modulator, the soft and hard demods, the probe and
its SNR estimate, the loading and water-filling choices, the wire codecs
and the batched coded decode) against the JAX package's, on the CPU, and
``chip_smoke.py``'s adaptive digests against the JAX package's decisions.
``tests/test_torch_ofdm_adaptive_mac.py`` holds the stream PHY, the
handshake, the retrain and the MAC run.

The corpora are built by the port (its modulator on the CPU, NumPy noise
and channels), so the tests marked ``gpu`` build them on a card without
JAX: this module imports JAX only inside its tests.

Tolerances, each with its reason:
* waveforms: atol 1e-6 (another FFT library);
* soft values: atol SOFT_ATOL = 1e-5 on values up to about 1.1 (the FFTs,
  and sums over bins in another order, feed them); the Viterbi decisions
  on them, the hard bits, the starts and the digests: equal;
* hard decisions at the QAM levels' boundaries: equal, on the f32 values
  next to each boundary on both sides (the divisions by the scales are
  true divisions on both sides);
* the probe's SNR: rtol SNR_RTOL = 1e-4 (a bias estimate from a sum of
  cancelling terms); the loadings and the gains chosen from it: equal.
  Each corpus reports its smallest distance, in dB, from a loading
  threshold and, in grid steps, from a gain's rounding edge, and says so
  where that distance is under the SNR's error.
"""

import dataclasses
import inspect
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from trackmaker_tpu_torch import convert
from trackmaker_tpu_torch.core.framing import Frame
from trackmaker_tpu_torch.phy import ofdm, ofdm_adaptive as ad

REPO = Path(__file__).resolve().parents[1]
CFG = ad.OfdmAdaptiveConfig()
N_DATA = len(CFG.data_bin_idx)
SOFT_ATOL = 1e-5
SNR_RTOL = 1e-4
THRESHOLDS = (8.5, 14.0, 23.0, 29.5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread while this module runs: the suite runs a worker per
    core, and torch's own thread pool on top of that oversubscribes them."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _jcfg(cfg):
    from trackmaker_tpu.phy.ofdm_adaptive import OfdmAdaptiveConfig as JaxConfig

    return JaxConfig(**dataclasses.asdict(cfg))


def _jframe(f: Frame):
    from trackmaker_tpu.core.framing import Frame as JaxFrame

    return JaxFrame(*dataclasses.astuple(f))


def mixed_loading(seed: int, kinds=(1, 2, 4, 6), p=(0.2, 0.4, 0.3, 0.1)) -> tuple:
    rng = np.random.default_rng(seed)
    return tuple(int(v) for v in rng.choice(kinds, size=N_DATA, p=p))


def gains_of(seed: int, loading: tuple) -> tuple:
    rng = np.random.default_rng(seed)
    return ad.choose_gains(10.0 ** rng.uniform(1.0, 2.5, N_DATA), loading)


# name -> config: every class alone, mixed with and without 64-QAM, with gains
LOADINGS = {
    "qpsk": CFG,
    "bpsk": dataclasses.replace(CFG, loading=(1,) * N_DATA),
    "qam16": dataclasses.replace(CFG, loading=(4,) * N_DATA),
    "qam64": dataclasses.replace(CFG, loading=(6,) * N_DATA),
    "mixed": dataclasses.replace(CFG, loading=mixed_loading(3)),
    "mixed_gains": dataclasses.replace(CFG, loading=mixed_loading(7, (0, 1, 2, 4),
                                                                  (0.1, 0.2, 0.4, 0.3)),
                                       gains=gains_of(7, mixed_loading(7, (0, 1, 2, 4),
                                                                       (0.1, 0.2, 0.4, 0.3)))),
}
SIGMAS = {"qpsk": 0.01, "bpsk": 0.02, "qam16": 0.004, "qam64": 0.001, "mixed": 0.004,
          "mixed_gains": 0.006}


def loaded_capture(name: str, n_bits: int = 1200, seed: int = 0):
    """(bits uint8[2, n_bits], captures f32[2, T]): two random frames of the
    loading `name`, modulated by the port, each after a lead-in of 300 and
    before 900 samples of silence, noise SIGMAS[name]."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (2, n_bits), dtype=np.uint8)
    wave = ad.modulate_bits_adaptive(LOADINGS[name], torch.from_numpy(bits), n_bits).numpy()
    x = np.concatenate([np.zeros((2, 300), np.float32), wave, np.zeros((2, 900), np.float32)],
                       axis=1)
    return bits, (x + rng.normal(0, SIGMAS[name], x.shape)).astype(np.float32)


# --- configuration, maps, modulator ------------------------------------------------------


def test_config_and_class_split_match_jax():
    from trackmaker_tpu.phy import ofdm_adaptive as jad

    ours = [(f.name, f.default) for f in dataclasses.fields(ad.OfdmAdaptiveConfig)]
    theirs = [(f.name, f.default) for f in dataclasses.fields(jad.OfdmAdaptiveConfig)]
    assert ours == theirs
    for name, cfg in LOADINGS.items():
        j = _jcfg(cfg)
        assert ad._class_idx(cfg) == jad._class_idx(j), name
        assert cfg.bits_per_symbol == j.bits_per_symbol, name
        np.testing.assert_array_equal(cfg.resolved_gains(), j.resolved_gains())
    assert N_DATA == chip_smoke.ADAPTIVE_N_DATA
    for bad in ((3,) * N_DATA, (2,) * (N_DATA - 1)):
        with pytest.raises(ValueError):
            dataclasses.replace(CFG, loading=bad).resolved_loading()
    with pytest.raises(ValueError):
        ad.OfdmAdaptiveModem(loading=(0,) * N_DATA, device="cpu")
    np.testing.assert_array_equal(ad._probe_syms(CFG), jad._probe_syms(_jcfg(CFG)))


@pytest.mark.parametrize("qam", [16, 64])
def test_qam_maps_match_jax_both_ways(qam):
    import jax.numpy as jnp

    from trackmaker_tpu.phy import ofdm_adaptive as jad

    k = 4 if qam == 16 else 6
    to_sym = {16: (ad._bits_to_qam16, jad._bits_to_qam16), 64: (ad._bits_to_qam64,
                                                             jad._bits_to_qam64)}[qam]
    to_bits = {16: (ad._qam16_to_bits, jad._qam16_to_bits), 64: (ad._qam64_to_bits,
                                                              jad._qam64_to_bits)}[qam]
    every = ((np.arange(2 ** k)[:, None] >> np.arange(k - 1, -1, -1)) & 1).astype(np.uint8)
    rng = np.random.default_rng(qam)
    for bits in (every.reshape(1, -1), rng.integers(0, 2, (5, 12 * k), dtype=np.uint8)):
        got = to_sym[0](torch.from_numpy(bits)).numpy()
        want = np.asarray(to_sym[1](jnp.asarray(bits)))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(to_bits[0](torch.from_numpy(got)).numpy(), bits)
    assert abs(float(np.mean(np.abs(to_sym[0](torch.from_numpy(every.reshape(1, -1)))
                                    .numpy()) ** 2)) - 1.0) < 1e-5


@pytest.mark.parametrize("qam", [16, 64])
def test_hard_decisions_at_the_level_boundaries_match_jax(qam):
    """At every boundary between two levels of an axis, the f32 amplitudes
    next to it on both sides (and on it) decide as JAX's do: v / scale + half
    is a true division on both sides, then round half to even."""
    import jax.numpy as jnp

    from trackmaker_tpu.phy import ofdm_adaptive as jad

    half, scale = (3, ad._QAM16_SCALE) if qam == 16 else (7, ad._QAM64_SCALE)
    vals = []
    for edge in range(-half + 1, half, 2):           # the boundaries, in units of the scale
        v = np.float32(edge * scale)
        for _ in range(3):
            v = np.nextafter(v, np.float32(-np.inf))
        for _ in range(7):
            vals.append(v)
            v = np.nextafter(v, np.float32(np.inf))
    vals += [np.float32((half + 1) * scale), np.float32(-(half + 1) * scale)]   # clipped
    re = np.asarray(vals, np.float32)
    sym = (re + 1j * re[::-1]).astype(np.complex64)
    fn = (ad._qam16_to_bits, jad._qam16_to_bits) if qam == 16 else (ad._qam64_to_bits,
                                                                    jad._qam64_to_bits)
    got = fn[0](torch.from_numpy(sym)).numpy()
    np.testing.assert_array_equal(got, np.asarray(fn[1](jnp.asarray(sym))))
    levels = ad._pam_levels(torch.from_numpy(re), float(np.float32(scale)), float(half), half)
    assert set(levels.tolist()) == set(range(half + 1))        # both sides of every boundary


@pytest.mark.parametrize("name", list(LOADINGS))
def test_modulate_bits_adaptive_matches_jax(name):
    import jax.numpy as jnp

    from trackmaker_tpu.phy import ofdm_adaptive as jad

    cfg = LOADINGS[name]
    bits = np.random.default_rng(1).integers(0, 2, (2, 1000), dtype=np.uint8)
    got = ad.modulate_bits_adaptive(cfg, torch.from_numpy(bits), 1000).numpy()
    want = np.asarray(jad.modulate_bits_adaptive(_jcfg(cfg), jnp.asarray(bits), 1000))
    assert got.shape == want.shape == (2, cfg.frame_samples(1000))
    np.testing.assert_allclose(got, want, atol=1e-6)


# --- the receiver -----------------------------------------------------------------------


@pytest.mark.parametrize("name", list(LOADINGS))
def test_soft_and_hard_demods_match_jax(name):
    """At each class: the soft values within SOFT_ATOL, the Viterbi-free hard
    bits equal, at the chirp's starts and at starts the window clamps (-7,
    and past the capture's end), single and batched over captures."""
    import jax.numpy as jnp

    from trackmaker_tpu.phy import ofdm_adaptive as jad

    cfg, j = LOADINGS[name], _jcfg(LOADINGS[name])
    bits, x = loaded_capture(name)
    t = x.shape[1]
    starts = np.array([[300, -7, t - 500], [300, 0, t + 40]])
    soft = ad.soft_demodulate_at_adaptive(cfg, torch.from_numpy(x), 1200,
                                          torch.from_numpy(starts)).numpy()
    hard = ad.demodulate_at_adaptive(cfg, torch.from_numpy(x), 1200,
                                     torch.from_numpy(starts)).numpy()
    for b in range(2):
        ws = np.asarray(jad.soft_demodulate_at_adaptive(j, jnp.asarray(x[b]), 1200,
                                                        jnp.asarray(starts[b])))
        wh = np.asarray(jad.demodulate_at_adaptive(j, jnp.asarray(x[b]), 1200,
                                                   jnp.asarray(starts[b])))
        np.testing.assert_allclose(soft[b], ws, atol=SOFT_ATOL, rtol=0)
        np.testing.assert_array_equal(hard[b], wh)
        np.testing.assert_array_equal(hard[b, 0], bits[b])
        np.testing.assert_array_equal(ad.soft_demodulate_at_adaptive(
            cfg, torch.from_numpy(x[b]), 1200, torch.from_numpy(starts[b])).numpy(), soft[b])
    assert ((soft[:, 0] > 0) == (bits > 0)).all()


# --- probe, SNR, loading, gains ------------------------------------------------------------


def _fir_channel(x, rng, sigma):
    """tests/test_ofdm_adaptive.py's lowpass channel: strong low bins, about
    -24 dB high bins, direct-path leakage."""
    taps = 31
    t = np.arange(taps) - taps // 2
    fc = 6000.0 / 48000.0
    h = 2 * fc * np.sinc(2 * fc * t) * np.hamming(taps)
    h = h + 0.06 * np.eye(taps)[taps // 2]
    y = np.convolve(x, h, mode="same")
    return (y + rng.normal(0, sigma, len(y))).astype(np.float32)


def probe_corpora() -> dict:
    """name -> probe capture: tests/test_ofdm_adaptive.py's shaped-channel
    corpora (seeds 3, 4, 8 and 13) and tests/test_ofdm_adaptive_mac.py's
    roll-off channels (seeds 11 and 5), each through the port's probe."""
    probe = ad.probe_waveform(CFG, device="cpu")
    out = {}
    for seed, lead, tail, sigma in ((3, 500, 800, 0.004), (4, 0, 600, 0.002),
                                    (8, 0, 600, 0.002), (13, 0, 600, 0.0006)):
        rng = np.random.default_rng(seed)
        w = np.concatenate([np.zeros(lead, np.float32), probe, np.zeros(tail, np.float32)])
        out[f"fir_{seed}"] = _fir_channel(w, rng, sigma)
    for seed, sigma in ((11, 0.004), (5, 0.006)):
        rng = np.random.default_rng(seed)
        out[f"rolloff_{seed}"] = chip_smoke.shaped_channel(
            np.concatenate([probe, np.zeros(1000, np.float32)]), rng, sigma)
    return out


PROBES = probe_corpora()


def loading_margin_db(snr: np.ndarray, thresholds=THRESHOLDS, guard_bins: int = 2) -> float:
    """The smallest distance, in dB, of a bin's windowed-minimum SNR from a
    loading threshold."""
    robust = snr.copy()
    for d in range(1, guard_bins + 1):
        left = np.concatenate([snr[:d], snr[:-d]])
        right = np.concatenate([snr[d:], snr[-d:]])
        robust = np.minimum(robust, np.minimum(left, right))
    db = 10.0 * np.log10(np.maximum(robust, 1e-12))
    return float(np.abs(db[:, None] - np.asarray(thresholds)[None]).min())


def gain_margin_steps(snr: np.ndarray, loading: tuple, thresholds=THRESHOLDS) -> float:
    """The smallest distance of an active bin's unquantized 80·log10(g) from
    a rounding edge of the gain grid, in grid steps."""
    grid = []
    orig = ad.quantize_gain
    try:
        ad.quantize_gain = lambda g: grid.append(80.0 * np.log10(max(g, 1e-12))) or orig(g)
        ad.choose_gains(snr, loading, thresholds)
    finally:
        ad.quantize_gain = orig
    act = np.asarray(loading) > 0
    frac = np.asarray(grid)[act] % 1.0
    return float(np.abs(frac - 0.5).min()) if act.any() else 1.0


@pytest.mark.parametrize("name", list(PROBES))
def test_probe_snr_loading_and_gains_match_jax(name):
    """The probe's start, its SNR within SNR_RTOL, and the 4-tier and 16-QAM
    capped loadings and their gains equal to JAX's; each corpus's margins
    from the thresholds and the gain grid's rounding edges are reported."""
    import jax.numpy as jnp

    from trackmaker_tpu.phy import ofdm as jofdm
    from trackmaker_tpu.phy import ofdm_adaptive as jad

    rx = PROBES[name]
    j = _jcfg(CFG)
    s = int(ofdm.find_preambles(CFG, torch.from_numpy(rx), 2)[0])
    assert s == int(np.asarray(jofdm.find_preambles(j, jnp.asarray(rx), 2))[0]) >= 0
    snr = ad.estimate_bin_snr(CFG, torch.from_numpy(rx), s).numpy()
    want = np.asarray(jad.estimate_bin_snr(j, jnp.asarray(rx), s))
    np.testing.assert_allclose(snr, want, rtol=SNR_RTOL)
    np.testing.assert_array_equal(ad.estimate_bin_snr(CFG, rx, s, device="cpu").numpy(), snr)
    err_db = 10.0 * np.log10(1.0 + float(np.abs(snr / want - 1.0).max()))
    for thresholds in (THRESHOLDS, THRESHOLDS[:3]):
        loading = ad.choose_loading(snr, thresholds)
        assert loading == jad.choose_loading(want, thresholds)
        gains = ad.choose_gains(snr, loading, thresholds)
        assert gains == jad.choose_gains(want, loading, thresholds)
        margin_db = loading_margin_db(snr, thresholds)
        margin_steps = gain_margin_steps(snr, loading, thresholds)
        # 80·log10(g) = 40·log10(water level · req / SNR): a relative error
        # of the SNR moves it by 40/ln 10 times that, the water level as much
        err_steps = 2 * 40.0 / np.log(10.0) * float(np.abs(snr / want - 1.0).max())
        print(f"{name} {len(thresholds)} tiers: loading margin {margin_db:.4f} dB, gain margin "
              f"{margin_steps:.4f} steps; SNR error {err_db:.2e} dB, {err_steps:.2e} steps")
        if margin_db < err_db or margin_steps < err_steps:
            warnings.warn(f"{name}: a bin lies within the SNR's error of a threshold or a gain "
                          f"edge ({margin_db:.3g} dB, {margin_steps:.3g} steps)")
    lv = np.asarray(ad.choose_loading(snr))
    assert lv.sum() >= 1


def test_wire_codecs_match_jax():
    from trackmaker_tpu.phy import ofdm_adaptive as jad

    rng = np.random.default_rng(12)
    for n in (9, 37, N_DATA):
        loading = tuple(int(v) for v in rng.choice([0, 1, 2, 4, 6], size=n))
        assert ad.pack_loading(loading) == jad.pack_loading(loading)
        assert ad.unpack_loading(ad.pack_loading(loading), n) == loading
        gains = ad.choose_gains(10.0 ** rng.uniform(0.5, 3.0, n), loading)
        assert ad.pack_gains(gains) == jad.pack_gains(gains)
        assert ad.unpack_gains(ad.pack_gains(gains), n) == jad.unpack_gains(
            jad.pack_gains(gains), n) == gains
        assert all(ad.quantize_gain(g) == jad.quantize_gain(g) == g for g in gains)
    for g in (1e-20, 0.001, 0.5, 1.0, 3.7, 1e6):
        assert ad.quantize_gain(g) == jad.quantize_gain(g)
    frame = ad.make_loading_frame(3, 1, 2, LOADINGS["mixed_gains"].loading,
                                  LOADINGS["mixed_gains"].gains)
    jframe = jad.make_loading_frame(3, 1, 2, LOADINGS["mixed_gains"].loading,
                                    LOADINGS["mixed_gains"].gains)
    assert frame.to_bytes() == jframe.to_bytes()
    assert ad.parse_control(frame, N_DATA) == jad.parse_control(jframe, N_DATA) == (
        "loading", LOADINGS["mixed_gains"].loading, LOADINGS["mixed_gains"].gains)
    bare = ad.make_loading_frame(4, 1, 2, LOADINGS["mixed"].loading)
    assert ad.parse_control(bare, N_DATA) == ("loading", LOADINGS["mixed"].loading, None)
    assert ad.parse_control(ad.make_reprobe_frame(1, 2, 1), N_DATA) == ("reprobe", None, None)
    assert ad.parse_control(Frame.new_data(0, 1, 2, b"data"), N_DATA) is None


# --- the batched coded decode ----------------------------------------------------------------


def batch_corpus():
    """tests/test_ofdm_adaptive.py's batched-decode corpus: 2 captures of 4
    frames of 48 bytes, gaps of 301 and 365, a lead-in under 200 samples,
    300 of silence after, noise sigma 0.02 (default_rng(4))."""
    phy = ad.OfdmAdaptiveStreamPhy(local_addr=2, device="cpu")
    rng = np.random.default_rng(4)
    frames = [Frame.new_data(i, 1, 2, rng.integers(0, 256, 48, dtype=np.uint8).tobytes())
              for i in range(4)]
    caps = []
    for b in range(2):
        wave = phy.encode_frames(frames, gap_samples=301 + 64 * b)
        x = np.concatenate([np.zeros(int(rng.integers(0, 200)), np.float32), wave,
                            np.zeros(300, np.float32)])
        caps.append((x + rng.normal(0, 0.02, len(x))).astype(np.float32))
    batch = np.zeros((2, max(map(len, caps))), np.float32)
    for b, c in enumerate(caps):
        batch[b, :len(c)] = c
    return frames, batch


def test_batched_decode_matches_jax():
    """Starts and bits (the digest) equal JAX's batched decode, the soft
    blocks within SOFT_ATOL, decode_equal_frames gives every frame, a
    missing frame's row (-1) decodes at 0 as JAX's, and the encoder's
    waveform matches JAX's."""
    import jax.numpy as jnp

    from trackmaker_tpu.phy import ofdm_adaptive as jad

    frames, batch = batch_corpus()
    p, j = ad.OfdmAdaptiveStreamPhy(local_addr=2, device="cpu"), jad.OfdmAdaptiveStreamPhy(
        local_addr=2)
    np.testing.assert_allclose(p.encode_frames(frames, 301),
                               j.encode_frames([_jframe(f) for f in frames], 301), atol=1e-6)
    for n_frames in (4, 5):
        sj, bj = (np.asarray(a) for a in j.batched_decode_fn(n_frames, 48)(jnp.asarray(batch)))
        sp, bp = p.batched_decode_fn(n_frames, 48)(torch.from_numpy(batch))
        np.testing.assert_array_equal(sp.numpy(), sj)
        np.testing.assert_array_equal(bp.numpy(), bj)
        assert chip_smoke.ofdm_digest(sp.numpy(), bp.numpy()) == chip_smoke.ofdm_digest(sj, bj)
    assert (sj[:, 4] == -1).all()
    got = p.decode_equal_frames(batch, 4, 48)
    assert [[f.data for f in row] for row in got] == [[f.data for f in frames]] * 2
    hdr, pay = p.soft_blocks(torch.from_numpy(batch), torch.from_numpy(sj[:, :4]), 48)
    total = p._coded_bits(48)
    for b in range(2):
        soft = np.asarray(jad.soft_demodulate_at_adaptive(
            j.cfg, jnp.asarray(batch[b]), total, jnp.asarray(np.maximum(sj[b, :4], 0))))
        inv_h, inv_p = np.argsort(p._perm(124)), np.argsort(p._perm(total - 124))
        np.testing.assert_allclose(hdr[b].numpy(), soft[:, :124][:, inv_h], atol=SOFT_ATOL)
        np.testing.assert_allclose(pay[b].numpy(), soft[:, 124:][:, inv_p], atol=SOFT_ATOL)


@pytest.mark.parametrize("loaded", [False, True])
def test_chip_smoke_adaptive_digests_are_the_jax_packages(loaded):
    """ADAPTIVE_DIGEST and ADAPTIVE_LOADED_DIGEST, which the port's runs on
    the card must equal, are the JAX package's batched decode of
    chip_smoke.py's captures; the port's CPU run gives the same, and every
    frame of every capture decodes."""
    import jax.numpy as jnp

    from trackmaker_tpu.phy import ofdm_adaptive as jad

    frames, caps = chip_smoke.adaptive_input(loaded)
    loading = chip_smoke.adaptive_loading() if loaded else None
    assert caps.shape == (chip_smoke.ADAPTIVE_BATCH, 84_244 if loaded else 104_724)
    want = chip_smoke.ADAPTIVE_LOADED_DIGEST if loaded else chip_smoke.ADAPTIVE_DIGEST
    fn = jad.OfdmAdaptiveStreamPhy(loading=loading, local_addr=2).batched_decode_fn(
        chip_smoke.ADAPTIVE_FRAMES, chip_smoke.ADAPTIVE_PAYLOAD)
    sj, bj = (np.asarray(a) for a in fn(jnp.asarray(caps)))
    assert chip_smoke.ofdm_digest(sj, bj) == want
    phy = ad.OfdmAdaptiveStreamPhy(loading=loading, local_addr=2, device="cpu")
    sp, bp = phy.batched_decode_fn(chip_smoke.ADAPTIVE_FRAMES, chip_smoke.ADAPTIVE_PAYLOAD)(
        torch.from_numpy(caps))
    assert chip_smoke.ofdm_digest(sp.numpy(), bp.numpy()) == want
    assert all(Frame.from_bits(bp[r, k].numpy()) == frames[k]
               for r in range(len(caps)) for k in range(len(frames)))
    if loaded:
        assert set(phy.cfg.resolved_loading().tolist()) == {1, 2, 4, 6}


# --- the modem, the configs, the entry points ----------------------------------------------


@pytest.mark.parametrize("name", ["qpsk", "mixed", "mixed_gains"])
def test_modem_decodes_as_jax(name):
    from trackmaker_tpu.phy import ofdm_adaptive as jad

    cfg = LOADINGS[name]
    rng = np.random.default_rng(2)
    frames = [Frame.new_data(i, 1, 2, rng.integers(0, 256, 40, dtype=np.uint8).tobytes())
              for i in range(3)]
    modem = ad.OfdmAdaptiveModem(cfg, device="cpu")
    wave = modem.encode_frames(frames, gap_samples=300)
    x = (np.concatenate([np.zeros(211, np.float32), wave, np.zeros(900, np.float32)])
         + rng.normal(0, SIGMAS[name], len(wave) + 1111)).astype(np.float32)
    got = modem.decode(x, 47, max_frames=4)
    want = jad.OfdmAdaptiveModem(_jcfg(cfg)).decode(x, 47, max_frames=4)
    assert [dataclasses.astuple(f) for f in got] == [dataclasses.astuple(f) for f in want]
    assert got == frames
    assert modem.bits_per_symbol == cfg.bits_per_symbol
    assert modem.decode(np.zeros(4000, np.float32), 47) == []


def test_configs_carried_across():
    from trackmaker_tpu.phy import ofdm_adaptive as jad

    for cfg in LOADINGS.values():
        j = _jcfg(cfg)
        fields = dataclasses.asdict(j)
        got = convert.ofdm_adaptive_config_from_fields(fields)
        assert got == cfg and hash(got) == hash(cfg)
        assert ad._class_idx(got) == jad._class_idx(j)
        lists = dict(fields, loading=list(fields["loading"]), gains=list(fields["gains"]))
        assert convert.ofdm_adaptive_config_from_fields(lists) == cfg
    with pytest.raises(KeyError):
        convert.ofdm_adaptive_config_from_fields({"no_such_field": 1})


def test_entry_points_default_to_the_card():
    for fn in (ad.OfdmAdaptiveStreamPhy, ad.OfdmAdaptiveModem, ad.probe_waveform,
               ad.estimate_bin_snr, ad.OfdmAdaptiveStreamPhy.handshake_mode):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    assert ad.OfdmAdaptiveStreamPhy().device == torch.device("cuda")
    assert ad.OfdmAdaptiveModem().device == torch.device("cuda")


def test_new_modules_import_no_jax():
    """The adaptive OFDM, FSK, PSK and stream modules, imported alone, load
    neither jax nor the JAX package, and name neither in their code."""
    mods = ("ofdm_adaptive", "fsk", "psk", "stream_sc")
    code = ("import sys\n"
            + "".join(f"import trackmaker_tpu_torch.phy.{m}\n" for m in mods)
            + "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', "
              "'trackmaker_tpu'))\n"
              "assert not bad, bad\nprint('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
    for m in mods:
        src = (REPO / "trackmaker_tpu_torch" / "phy" / f"{m}.py").read_text()
        imports = [ln for ln in src.splitlines() if ln.lstrip().startswith(("import ", "from "))]
        assert not [ln for ln in imports if "jax" in ln or "trackmaker_tpu." in ln
                    or ln.split()[1] == "trackmaker_tpu"], m


# --- on the card -----------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(LOADINGS))
def test_demods_on_the_card_equal_the_cpu(cuda, name):
    """Soft values within SOFT_ATOL of the port's CPU run, the hard bits and
    the waveform's decisions equal."""
    cfg = LOADINGS[name]
    bits, x = loaded_capture(name)
    starts = torch.tensor([[300], [300]])
    for fn, check in ((ad.soft_demodulate_at_adaptive, lambda a, b: torch.allclose(
            a, b, atol=SOFT_ATOL, rtol=0)), (ad.demodulate_at_adaptive, torch.equal)):
        got = fn(cfg, torch.from_numpy(x).to(cuda), 1200, starts.to(cuda)).cpu()
        assert check(got, fn(cfg, torch.from_numpy(x), 1200, starts)), fn.__name__
    wave = ad.modulate_bits_adaptive(cfg, torch.from_numpy(bits).to(cuda), 1200).cpu()
    assert torch.allclose(wave, ad.modulate_bits_adaptive(cfg, torch.from_numpy(bits), 1200),
                          atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("loaded", [False, True])
def test_chip_smoke_adaptive_batch_on_the_card(cuda, loaded):
    frames, caps = chip_smoke.adaptive_input(loaded)
    phy = chip_smoke.adaptive_phy(ad, loaded, cuda)
    sp, bp = phy.batched_decode_fn(chip_smoke.ADAPTIVE_FRAMES, chip_smoke.ADAPTIVE_PAYLOAD)(
        torch.from_numpy(caps).to(cuda))
    want = chip_smoke.ADAPTIVE_LOADED_DIGEST if loaded else chip_smoke.ADAPTIVE_DIGEST
    assert chip_smoke.ofdm_digest(sp.cpu().numpy(), bp.cpu().numpy()) == want


@pytest.mark.gpu
def test_probe_snr_on_the_card_equals_the_cpu(cuda):
    for name, rx in PROBES.items():
        s = int(ofdm.find_preambles(CFG, torch.from_numpy(rx), 2)[0])
        got = ad.estimate_bin_snr(CFG, torch.from_numpy(rx).to(cuda), s).cpu().numpy()
        want = ad.estimate_bin_snr(CFG, torch.from_numpy(rx), s).numpy()
        np.testing.assert_allclose(got, want, rtol=SNR_RTOL, err_msg=name)
        assert ad.choose_loading(got) == ad.choose_loading(want), name
