"""The port's channel models, clock-offset search, per-frame timing gate and
robustness sweeps (``trackmaker_tpu_torch.dsp.channel``, ``dsp.timing``,
``bench.ber``) against the JAX package's, on the CPU.

The corpora are those of ``tests/test_timing.py``, ``tests/test_timing_gate.py``
and ``tests/test_bench_sweeps.py``, built by the port (its encoder and its
``clock_offset``, both equal to the JAX package's, as the first tests here
hold) from the same seeds, so ``tests/test_torch_kernels_gpu.py`` can build
them on a card without JAX: this module imports JAX only inside its tests.
The JAX side runs as its own suite runs it here (its exact scan on the CPU).

Tolerances, each with its reason:
* ``clock_offset``, ``gain``, ``delay``, ``mix``: bit for bit (the same
  float32 operations, one at a time);
* ``awgn``'s sigma: within 1e-6 relative of JAX's, each read back as the
  least-squares ratio of (out - x) to the normal draw (the power's sum runs
  in another order);
* ``estimate_frame_ppm``: within 0.01 ppm of JAX's (sums in another order,
  another sin and cos), its weight within 1e-5 relative, and the decode
  after the resample equal;
* the candidate extraction, every decoded frame, start, chosen ppm and
  sweep row: exactly equal."""

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
from trackmaker_tpu_torch import convert
from trackmaker_tpu_torch.bench import ber
from trackmaker_tpu_torch.core.config import FOUR_B_FIVE_B, MANCHESTER
from trackmaker_tpu_torch.core.config import PhyConfig
from trackmaker_tpu_torch.core.framing import Frame
from trackmaker_tpu_torch.dsp import channel, timing
from trackmaker_tpu_torch.phy import ask_spec
from trackmaker_tpu_torch.phy import spec_decode as sd
from trackmaker_tpu_torch.phy.decoder import DecodedFrames, decode_capture_fast
from trackmaker_tpu_torch.phy.encoder import PhyEncoder

CFG = PhyConfig()
CFG4 = PhyConfig(line_coding=FOUR_B_FIVE_B)
OFFSET_PPMS = (-50.0, 50.0, -400.0, 400.0, 1000.0, 20_000.0)
OFFSET_TS = (1, 2, 1_000, 433_464)
PPM_ATOL = 0.01
GATE_CORPORA = ("recover", "mixed", "clean", "4b5b")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread while this module runs: the suite runs a worker per
    core, and torch's own thread pool on top of that oversubscribes them."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _jcfg(cfg: PhyConfig):
    from trackmaker_tpu.core.config import PhyConfig as JaxPhyConfig

    return JaxPhyConfig(**dataclasses.asdict(cfg))


# --- the corpora (no JAX) -------------------------------------------------------------


def _encode(cfg: PhyConfig, frame: Frame) -> np.ndarray:
    return PhyEncoder(cfg, device="cpu").encode_frame(frame).numpy()


def skewed_capture(ppm: float, n_frames: int = 8, seed: int = 0):
    """tests/test_timing.py's corpus: (frames, the capture skewed by ppm)."""
    rng = np.random.default_rng(seed)
    frames = [Frame.new_data(i, 1, 2, rng.integers(0, 256, 64, dtype=np.uint8).tobytes())
              for i in range(n_frames)]
    wave = PhyEncoder(CFG, device="cpu").encode_frames(frames, gap_samples=240)
    return frames, channel.clock_offset(wave, float(ppm)).numpy()


def _skewed_frame(cfg, frame, ppm, rng, sigma=0.02) -> np.ndarray:
    w = torch.from_numpy(_encode(cfg, frame))
    if ppm:
        w = channel.clock_offset(w, ppm)
    w = w.numpy()
    return (w + rng.normal(0, sigma, len(w))).astype(np.float32)


def gate_corpus(name: str):
    """tests/test_timing_gate.py's captures: (cfg, capture, the payloads the
    exact decode finds, the payloads the gate recovers)."""
    z = lambda n: np.zeros(n, np.float32)          # noqa: E731
    if name == "recover":
        rng = np.random.default_rng(0)
        good = Frame.new_data(0, 1, 2, b"on-clock frame")
        bad = Frame.new_data(1, 1, 2, bytes(range(120)))
        wave = np.concatenate([z(500), _skewed_frame(CFG, good, 0.0, rng), z(700),
                               _skewed_frame(CFG, bad, 400.0, rng), z(1200)])
        return CFG, wave, [good.data], [bad.data]
    if name == "mixed":
        rng = np.random.default_rng(1)
        fa = Frame.new_data(0, 1, 2, bytes([0xAA]) * 100)
        fb = Frame.new_data(1, 1, 2, bytes([0xBB]) * 100)
        wave = np.concatenate([z(400), _skewed_frame(CFG, fa, 400.0, rng), z(900),
                               _skewed_frame(CFG, fb, -400.0, rng), z(1200)])
        return CFG, wave, None, sorted([fa.data, fb.data])
    if name == "clean":
        rng = np.random.default_rng(2)
        frames = [Frame.new_data(i, 1, 2, bytes([i]) * 30) for i in range(4)]
        parts = []
        for f in frames:
            parts += [_skewed_frame(CFG, f, 0.0, rng), z(400)]
        wave = np.concatenate(parts + [z(2000)])
        return CFG, wave, sorted(f.data for f in frames), []
    assert name == "4b5b"
    rng = np.random.default_rng(3)
    bad = Frame.new_data(1, 1, 2, bytes(range(110)))
    wave = np.concatenate([z(600), _skewed_frame(CFG4, bad, -600.0, rng), z(1500)])
    return CFG4, wave, [], [bad.data]


def hit_vectors(seed: int = 0, b: int = 6, t: int = 9_000) -> np.ndarray:
    """Dense hit vectors bool[b, t] whose 512-sample blocks hold 0 to 8 hits
    (the cap is 4), the last block cut short."""
    rng = np.random.default_rng(seed)
    hits = np.zeros((b, t), bool)
    for r in range(b):
        for blk in range(-(-t // 512)):
            lo, hi = 512 * blk, min(512 * (blk + 1), t)
            k = min(int(rng.integers(0, 9)), hi - lo) if r else blk % 9
            hits[r, rng.choice(np.arange(lo, hi), k, replace=False)] = True
    hits[0] = False                                  # a row with no hit
    hits[1, :] = False
    hits[1, [0, 511, 512, t - 1]] = True            # block edges
    return hits


# --- helpers ----------------------------------------------------------------------------


def _np(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def frames_of(res) -> list[tuple]:
    """The valid slots of a decode (port or JAX), in slot order: (frame
    bytes, length, type, sequence, src, dst, start)."""
    valid = _np(res.valid)
    cols = [_np(getattr(res, f)) for f in
            ("length", "frame_type", "sequence", "src", "dst", "start")]
    fb = _np(res.frame_bytes)
    return [(fb[k, :7 + int(cols[0][k])].tobytes(), *(int(c[k]) for c in cols))
            for k in np.nonzero(valid)[0]]


def payloads_of(res) -> list[bytes]:
    return sorted(f[0][7:] for f in frames_of(res))


# --- the channel models -----------------------------------------------------------------


def test_encoder_and_corpora_match_the_jax_package():
    """The corpora are the JAX tests' own: the port's encoder gives the
    oracle encoder's waveforms, so the skewed frames are the same bits."""
    from trackmaker_tpu.oracle.phy import OracleEncoder

    for cfg in (CFG, CFG4):
        enc = OracleEncoder(_jcfg(cfg))
        for f in (Frame.new_data(1, 1, 2, bytes(range(120))), Frame.new_data(0, 1, 2, b"x")):
            np.testing.assert_array_equal(_encode(cfg, f), np.asarray(enc.encode_frame(f)))


@pytest.mark.parametrize("ppm", OFFSET_PPMS)
def test_clock_offset_matches_jax_bit_for_bit(ppm):
    import jax.numpy as jnp
    from trackmaker_tpu.dsp import channel as jchannel

    rng = np.random.default_rng(int(ppm) % 997)
    for t in OFFSET_TS:
        x = rng.normal(0, 1, t).astype(np.float32)
        want = np.asarray(jchannel.clock_offset(jnp.asarray(x), ppm))
        got = channel.clock_offset(torch.from_numpy(x), ppm)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"T={t}")
    # per-row ratios equal one call a row
    rows = torch.from_numpy(rng.normal(0, 1, (3, 5_000)).astype(np.float32))
    ppms = torch.tensor([[ppm], [-ppm], [0.0]])
    got = channel.clock_offset(rows, ppms)
    for r in range(3):
        assert torch.equal(got[r], channel.clock_offset(rows[r], float(ppms[r, 0])))
    one = channel.clock_offset(rows[0], ppms)
    assert torch.equal(one[1], channel.clock_offset(rows[0], -ppm))


def test_gain_delay_mix_match_jax():
    import jax.numpy as jnp
    from trackmaker_tpu.dsp import channel as jchannel

    x = np.random.default_rng(4).normal(0, 1, (3, 4_001)).astype(np.float32)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    for g in (0.3, -1.7, 0.0):
        np.testing.assert_array_equal(channel.gain(xt, g).numpy(), np.asarray(jchannel.gain(xj, g)))
    for d in (0, 1, 17, 4_001, 5_000):
        np.testing.assert_array_equal(channel.delay(xt, d).numpy(),
                                      np.asarray(jchannel.delay(xj, d)))
    np.testing.assert_array_equal(channel.mix(xt).numpy(), np.asarray(jchannel.mix(xj)))
    np.testing.assert_array_equal(channel.mix(xt[:1]).numpy(), x[0])


def _sigma(out: np.ndarray, x: np.ndarray, noise: np.ndarray) -> np.ndarray:
    """Each row's sigma, read back as the least-squares ratio of out - x to
    the normal draw, in float64."""
    d = out.astype(np.float64) - x.astype(np.float64)
    n = noise.astype(np.float64)
    return (d * n).sum(-1) / (n * n).sum(-1)


@pytest.mark.parametrize("snr_db", [-5.0, 0.0, 7.5, 20.0])
def test_awgn_sigma_matches_jax(snr_db):
    import jax
    import jax.numpy as jnp
    from trackmaker_tpu.dsp import channel as jchannel

    rng = np.random.default_rng(5)
    x = (rng.normal(0, 1, (2, 20_000)) * np.array([[0.2], [3.0]])).astype(np.float32)
    key = jax.random.PRNGKey(7)
    out_j = np.asarray(jchannel.awgn(key, jnp.asarray(x), snr_db))
    draw_j = np.asarray(jax.random.normal(key, x.shape, dtype=jnp.float32))
    sigma_j = _sigma(out_j, x, draw_j)
    gen = torch.Generator().manual_seed(11)
    out = channel.awgn(torch.from_numpy(x), snr_db, gen).numpy()
    draw = torch.randn(x.shape, generator=torch.Generator().manual_seed(11)).numpy()
    sigma = _sigma(out, x, draw)
    np.testing.assert_allclose(sigma, sigma_j, rtol=1e-6)
    want = np.sqrt((x.astype(np.float64) ** 2).mean(-1) / 10 ** (snr_db / 10))
    np.testing.assert_allclose(sigma, want, rtol=1e-6)
    # a 1-D capture: the same draw as the batch's first row
    one = channel.awgn(torch.from_numpy(x[1]), snr_db, torch.Generator().manual_seed(11))
    assert one.shape == (20_000,) and one.dtype == torch.float32
    np.testing.assert_allclose(_sigma(one.numpy()[None], x[1:], draw[:1, :20_000]), sigma[1],
                               rtol=1e-6)


# --- the line-coded candidate extraction ------------------------------------------------


@pytest.mark.parametrize("n_cand", [1, 16, 40, 200])
def test_extract_candidates_matches_jax(n_cand):
    import jax.numpy as jnp
    from trackmaker_tpu.phy.pallas_decode import _extract_candidates

    hits = hit_vectors()
    cand, n_valid, overflow = sd.extract_candidates(torch.from_numpy(hits), n_cand)
    want = _extract_candidates(jnp.asarray(hits), n_cand)
    for g, w in zip((cand, n_valid, overflow), want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert cand.dtype == n_valid.dtype == torch.int32
    one_c, one_n, _ = sd.extract_candidates(torch.from_numpy(hits[2:3]), n_cand)
    assert torch.equal(one_c[0], cand[2]) and int(one_n[0]) == int(n_valid[2])


def test_ask_extraction_keeps_eight_a_block():
    """The ASK receiver's extraction is the same code at 8 a block."""
    hits = torch.from_numpy(hit_vectors(seed=1))
    got = ask_spec.extract_candidates(hits, 64)
    want = sd.extract_candidates(hits, 64, per_block=8)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert not torch.equal(got[1], sd.extract_candidates(hits, 64)[1])


# --- the per-frame ppm estimate ----------------------------------------------------------


@pytest.mark.parametrize("cfg", [CFG, CFG4], ids=[MANCHESTER, FOUR_B_FIVE_B])
def test_estimate_frame_ppm_matches_jax(cfg):
    """tests/test_timing_gate.py's estimate check on both line codes: the
    port's ppm within PPM_ATOL of JAX's, and the frame decoded after
    undoing it equal to JAX's decode of JAX's resample."""
    import jax.numpy as jnp
    from trackmaker_tpu.dsp import channel as jchannel
    from trackmaker_tpu.dsp import timing as jtiming
    from trackmaker_tpu.phy.decoder import decode_capture as jax_decode

    jcfg = _jcfg(cfg)
    frame = Frame.new_data(0, 1, 2, bytes(range(100)))
    w = _encode(cfg, frame)
    n_levels = (len(w) - cfg.preamble_len) // cfg.samples_per_level
    bodies = []
    for true_ppm in (-400.0, 0.0, 400.0):
        skewed = channel.clock_offset(torch.from_numpy(w), true_ppm)
        body = skewed[cfg.preamble_len:]
        bodies.append(body)
        est, wsum = timing.estimate_frame_ppm(cfg, body, n_levels)
        est_j, wsum_j = jtiming.estimate_frame_ppm(jcfg, jnp.asarray(body.numpy()), n_levels)
        assert abs(float(est) - float(est_j)) <= PPM_ATOL, (true_ppm, float(est), float(est_j))
        np.testing.assert_allclose(float(wsum), float(wsum_j), rtol=1e-5)
        fixed = torch.cat([channel.clock_offset(skewed, float(est)), torch.zeros(200)])
        fixed_j = np.concatenate([np.asarray(jchannel.clock_offset(
            jnp.asarray(skewed.numpy()), float(est_j))), np.zeros(200, np.float32)])
        got = decode_capture_fast(cfg, fixed, 2, max_frames=2)
        want = jax_decode(jcfg, jnp.asarray(fixed_j), 2, max_frames=2)
        assert frames_of(got) == frames_of(want) and payloads_of(got) == [frame.data]
        if true_ppm:
            assert abs(float(est) + true_ppm) < 0.35 * abs(true_ppm) + 40
    # the batch of windows equals one call a window
    est_b, w_b = timing.estimate_frame_ppm(cfg, torch.stack(bodies), n_levels)
    for r, body in enumerate(bodies):
        est, wsum = timing.estimate_frame_ppm(cfg, body, n_levels)
        assert abs(float(est_b[r]) - float(est)) <= PPM_ATOL
        np.testing.assert_allclose(float(w_b[r]), float(wsum), rtol=1e-5)


# --- the clock-offset search (tests/test_timing.py) -------------------------------------


@pytest.fixture(scope="module")
def search_ref():
    """JAX's clock search on tests/test_timing.py's two corpora and on the
    mixed-skew gate corpus."""
    from trackmaker_tpu.dsp import timing as jtiming

    out = {}
    frames, skewed = skewed_capture(1000.0)
    out["1000ppm"] = (frames, skewed, 12, timing.PPM_GRID,
                      jtiming.decode_with_clock_search(_jcfg(CFG), skewed, 2, max_frames=12))
    frames, clean = skewed_capture(0.0, n_frames=4, seed=2)
    out["clean"] = (frames, clean, 8, timing.PPM_GRID,
                    jtiming.decode_with_clock_search(_jcfg(CFG), clean, 2, max_frames=8))
    _, mixed, _, _ = gate_corpus("mixed")
    grid = (-400.0, 0.0, 400.0)
    out["mixed"] = (None, mixed, 8, grid, jtiming.decode_with_clock_search(
        _jcfg(CFG), mixed, 2, ppm_grid=grid, max_frames=8))
    return out


@pytest.mark.parametrize("name", ["1000ppm", "clean", "mixed"])
def test_clock_search_matches_jax(search_ref, name):
    frames, x, mf, grid, (want, want_ppm) = search_ref[name]
    got, ppm = timing.decode_with_clock_search(CFG, torch.from_numpy(x), 2, ppm_grid=grid,
                                               max_frames=mf)
    assert got.valid.device.type == "cpu" and got.valid.shape == (mf,)
    assert ppm == want_ppm
    assert frames_of(got) == frames_of(want)
    if name == "1000ppm":       # the plain decode collapses, the search recovers all
        assert int(decode_capture_fast(CFG, torch.from_numpy(x), 2, max_frames=12).count) < 8
        assert abs(ppm - 1000.0) <= 500.0
        assert [f.data for f in got.to_frames()] == [f.data for f in frames]
    elif name == "clean":
        assert ppm == 0.0 and int(got.count) == 4
    else:                       # one ratio, one winner
        assert len(payloads_of(got)) <= 1


def test_estimate_clock_ppm():
    from trackmaker_tpu.dsp import timing as jtiming

    for starts in ([0, 10010, 20020, 30030], [-1, 5, 10005], [3], [-1, -1]):
        got = timing.estimate_clock_ppm(np.asarray(starts), 10000.0)
        assert got == jtiming.estimate_clock_ppm(np.asarray(starts), 10000.0)
    assert abs(timing.estimate_clock_ppm(np.asarray([0, 10010, 20020, 30030]), 10000.0)
               - 1000.0) < 1.0


def test_numpy_capture_goes_to_the_card():
    """A NumPy capture goes to the card by default, and raises without one."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    x = np.zeros(5000, np.float32)
    for call in (timing.decode_with_clock_search, timing.decode_with_timing_gate):
        with pytest.raises((AssertionError, RuntimeError)):
            call(CFG, x, 2)


# --- the per-frame timing gate (tests/test_timing_gate.py) -------------------------------


@pytest.fixture(scope="module")
def gate_ref():
    from trackmaker_tpu.dsp import timing as jtiming

    out = {}
    for name in GATE_CORPORA:
        cfg, x, _, _ = gate_corpus(name)
        out[name] = jtiming.decode_with_timing_gate(_jcfg(cfg), x, 2)
    return out


@pytest.mark.parametrize("name", GATE_CORPORA)
def test_timing_gate_matches_jax(gate_ref, name):
    cfg, x, want_exact, want_rec = gate_corpus(name)
    exact, rec = timing.decode_with_timing_gate(cfg, torch.from_numpy(x), 2)
    jexact, jrec = gate_ref[name]
    assert frames_of(exact) == frames_of(jexact)
    assert frames_of(rec) == frames_of(jrec)
    assert rec.valid.shape == (16,) and rec.valid.device.type == "cpu"
    np.testing.assert_array_equal(_np(rec.start), _np(jrec.start))
    if want_exact is not None:
        assert payloads_of(exact) == want_exact
    got = payloads_of(rec) if want_exact is not None else sorted(
        payloads_of(exact) + payloads_of(rec))
    assert got == want_rec
    if name == "recover":      # the recovered frame's start is absolute
        s = int(_np(rec.start)[_np(rec.valid)][0])
        assert abs(s - 500 - len(_encode(CFG, Frame.new_data(0, 1, 2, b"on-clock frame")))
                   - 700) < 20


def test_timing_gate_retries_every_candidate_slot():
    """More failed hits than retry slots: 20 copies of a preamble in silence
    give 20 hits, the gate retries the first 16 (the padded slots' windows
    clamped at the capture's end) and recovers nothing, as JAX's."""
    from trackmaker_tpu.dsp import timing as jtiming
    from trackmaker_tpu_torch.phy.line_coding import preamble_waveform

    pre = preamble_waveform(CFG)
    x = np.concatenate([np.concatenate([pre, np.zeros(700, np.float32)])] * 20
                       + [np.zeros(300, np.float32)]).astype(np.float32)
    exact, rec = timing.decode_with_timing_gate(CFG, torch.from_numpy(x), 2, max_retry=4)
    jexact, jrec = jtiming.decode_with_timing_gate(_jcfg(CFG), x, 2, max_retry=4)
    assert frames_of(exact) == frames_of(jexact) == []
    assert frames_of(rec) == frames_of(jrec) == []
    np.testing.assert_array_equal(_np(rec.start), _np(jrec.start))


# --- chip_smoke.py's corpora, held to the JAX package here ---------------------------


def test_chip_smoke_search_digest_is_the_jax_packages():
    """chip_smoke.py's clock search capture (the flagship's 64 frames,
    +1000 ppm, no noise): JAX's search chooses +1000 ppm and returns 63
    frames in order (frame 60 is lost, see the next test), whose digest the
    script holds the card to; the port's search on the CPU returns the same
    frames and starts."""
    from trackmaker_tpu.dsp import timing as jtiming

    x, frames = chip_smoke.search_capture(torch, CFG, torch.device("cpu"))
    assert x.shape == (433_464,)
    want, want_ppm = jtiming.decode_with_clock_search(_jcfg(CFG), x.numpy(), 2,
                                                      max_frames=chip_smoke.MAX_FRAMES)
    pays = [f[0][7:] for f in frames_of(want)]
    assert want_ppm == chip_smoke.SEARCH_PPM
    assert chip_smoke.payload_digest(pays) == chip_smoke.SEARCH_DIGEST
    assert [f[3] for f in frames_of(want)] == [i for i in range(64) if i != 60]
    got, ppm = timing.decode_with_clock_search(CFG, x, 2, max_frames=chip_smoke.MAX_FRAMES)
    assert ppm == want_ppm and frames_of(got) == frames_of(want)


def _resample_f64(x: np.ndarray, ratio: float) -> np.ndarray:
    """clock_offset's floor, clip and linear interpolation at positions
    arange(t) * ratio, all in float64, rounded to float32 at the end."""
    x = x.astype(np.float64)
    pos = np.arange(len(x), dtype=np.float64) * ratio
    i0 = np.clip(np.floor(pos).astype(np.int64), 0, len(x) - 2)
    frac = pos - i0
    return (x[i0] * (1.0 - frac) + x[i0 + 1] * frac).astype(np.float32)


def test_search_corpus_loses_frame_60_to_the_grid_ratio():
    """What loses frame 60 of the search capture: the grid's -1000 ppm row
    resamples by 0.999, not by the exact inverse 1/1.001 of the +1000 ppm
    skew.  At 0.999 the float32 resample and a float64 one both lose frame
    60 alone; a float64 resample by 1/1.001 brings back all 64, as does the
    unskewed encode.  So the capture holds every frame, and float32
    positions are not what loses it."""
    from trackmaker_tpu_torch.phy.encoder import PhyEncoder

    x, frames = chip_smoke.search_capture(torch, CFG, torch.device("cpu"))
    wave = PhyEncoder(CFG, device="cpu").encode_frames(frames, gap_samples=chip_smoke.GAP)
    ppm = chip_smoke.SEARCH_PPM

    def seqs(y) -> list[int]:
        res = decode_capture_fast(CFG, torch.as_tensor(y), 2, max_frames=chip_smoke.MAX_FRAMES)
        return sorted(_np(res.sequence)[_np(res.valid)].tolist())

    but_60 = [i for i in range(64) if i != 60]
    assert seqs(channel.clock_offset(x, -ppm)) == but_60
    assert seqs(_resample_f64(x.numpy(), 1.0 - ppm * 1e-6)) == but_60
    assert seqs(_resample_f64(x.numpy(), 1.0 / (1.0 + ppm * 1e-6))) == list(range(64))
    assert seqs(wave) == list(range(64))


@pytest.mark.parametrize("layout", ["quiet", "flagship_gaps"])
def test_chip_smoke_gate_corpus_on_the_jax_package(layout):
    """chip_smoke.py's timing gate captures: 64 frames, six of them at +-400
    ppm.  Where each skewed frame is followed by 6,600 samples of quiet,
    JAX's exact decode finds the 58 on-clock frames and its gate recovers
    the six skewed ones.  At the flagship's 200-sample gaps a retry window
    spans the next frame and JAX's gate recovers none.  The port's gate
    returns the same frames and starts on both."""
    from trackmaker_tpu.dsp import timing as jtiming

    quiet = chip_smoke.GATE_QUIET if layout == "quiet" else chip_smoke.GAP
    x, frames = chip_smoke.gate_capture(torch, CFG, torch.device("cpu"), quiet)
    jexact, jrec = jtiming.decode_with_timing_gate(_jcfg(CFG), x.numpy(), 2,
                                                   max_frames=chip_smoke.MAX_FRAMES)
    skewed = sorted(frames[i].data for i in chip_smoke.GATE_SKEWS)
    on_clock = sorted(f.data for i, f in enumerate(frames) if i not in chip_smoke.GATE_SKEWS)
    assert sorted(payloads_of(jexact)) == on_clock
    assert payloads_of(jrec) == (skewed if layout == "quiet" else [])
    exact, rec = timing.decode_with_timing_gate(CFG, x, 2, max_frames=chip_smoke.MAX_FRAMES)
    assert frames_of(exact) == frames_of(jexact) and frames_of(rec) == frames_of(jrec)


def test_timing_gate_back_to_back_frames_match_jax():
    """The flagship's layout, 200 samples between frames, two frames skewed
    +-400 ppm: a retry window spans the next frame, whose own phase spoils
    the drift estimate, so the gate recovers neither; the port equals JAX
    there too."""
    from trackmaker_tpu.dsp import timing as jtiming

    rng = np.random.default_rng(8)
    frames = [Frame.new_data(i, 1, 2, rng.integers(0, 256, 128, dtype=np.uint8).tobytes())
              for i in range(6)]
    parts = []
    for i, f in enumerate(frames):
        parts += [_skewed_frame(CFG, f, {1: 400.0, 3: -400.0}.get(i, 0.0), rng),
                  np.zeros(200, np.float32)]
    x = np.concatenate(parts)
    exact, rec = timing.decode_with_timing_gate(CFG, torch.from_numpy(x), 2)
    jexact, jrec = jtiming.decode_with_timing_gate(_jcfg(CFG), x, 2)
    assert frames_of(exact) == frames_of(jexact) and frames_of(rec) == frames_of(jrec)
    assert len(frames_of(exact)) == 4 and frames_of(rec) == []


# --- the sweeps (tests/test_bench_sweeps.py) --------------------------------------------


def _spy_awgn(monkeypatch) -> list[np.ndarray]:
    """Record every capture the port's awgn returns."""
    made = []
    awgn = channel.awgn

    def spy(x, snr_db, generator):
        out = awgn(x, snr_db, generator)
        made.append(out.numpy())
        return out

    monkeypatch.setattr(channel, "awgn", spy)
    return made


def _assert_rows_match_jax(rows, captures, n_frames, payload_len):
    payloads = np.random.default_rng(0).integers(0, 256, (n_frames, payload_len), dtype=np.uint8)
    want = _jax_rows(_jcfg(CFG), captures, payloads, n_frames)
    assert [r["frames_decoded"] for r in rows] == [w[1] for w in want]
    if "payload_bit_errors" in rows[0]:
        assert [r["payload_bit_errors"] for r in rows] == [w[0] for w in want]


def test_ber_sweep_monotone_ish(monkeypatch):
    made = _spy_awgn(monkeypatch)
    res = ber.ber_sweep(snr_dbs=(-5, 5, 20), n_frames=8, payload_len=32, device="cpu")
    loss = [r["frame_loss_pct"] for r in res]
    assert loss[-1] == 0.0
    assert loss[0] >= loss[-1]
    assert res[-1]["payload_bit_errors"] == 0
    _assert_rows_match_jax(res, made, 8, 32)


def test_clock_offset_sweep_tolerates_small_ppm(monkeypatch):
    """0 ppm loses nothing and 2% skew more than half; 100 ppm is the
    decoder's edge at these 39-byte frames, where the loss hangs on the
    noise draw (JAX's own decoder loses 0-2 of the 8 frames over PRNG keys
    0..11; its suite's key 0 loses none), so there the port's rows are held
    to JAX's decode of the port's own captures, as at every point."""
    made = _spy_awgn(monkeypatch)
    res = ber.clock_offset_sweep(ppms=(0, 100, 20000), n_frames=8, payload_len=32, device="cpu")
    assert res[0]["frame_loss_pct"] == 0.0
    assert res[1]["frame_loss_pct"] <= 25.0
    assert res[2]["frame_loss_pct"] > 50.0
    _assert_rows_match_jax(res, made, 8, 32)


def _jax_rows(jcfg, captures: list[np.ndarray], payloads: np.ndarray, n_frames: int):
    """JAX's decode_capture and _score on each capture."""
    import jax.numpy as jnp
    from trackmaker_tpu.bench.ber import _score
    from trackmaker_tpu.phy.decoder import decode_capture as jax_decode

    return [_score(jax_decode(jcfg, jnp.asarray(c), 2, max_frames=n_frames + 8), payloads)
            for c in captures]


@pytest.mark.parametrize("sweep", ["ber", "clock_offset"])
def test_sweep_rows_match_jax_on_identical_captures(monkeypatch, sweep):
    """The port's awgn replaced by the captures this test makes with NumPy
    (the JAX package's capture, its resample, NumPy noise at the sweep's
    sigma): every row equals JAX's decode_capture and _score on them."""
    import jax.numpy as jnp
    from trackmaker_tpu.bench.ber import _build_capture
    from trackmaker_tpu.dsp import channel as jchannel

    jcfg = _jcfg(CFG)
    n_frames, payload_len = 8, 32
    payloads, wave = _build_capture(jcfg, n_frames, payload_len, 0)
    wave = np.asarray(wave)
    points = (-5.0, -2.0, 0.0, 5.0, 20.0) if sweep == "ber" else (0.0, 300.0, 800.0, 20_000.0)
    rng = np.random.default_rng(9)
    captures = []
    for p in points:
        clean = wave if sweep == "ber" else np.asarray(jchannel.clock_offset(jnp.asarray(wave), p))
        snr = p if sweep == "ber" else 20.0
        sigma = np.sqrt(np.mean(clean.astype(np.float64) ** 2) / 10 ** (snr / 10))
        captures.append((clean + rng.normal(0, sigma, clean.shape)).astype(np.float32))
    calls = []

    def fake_awgn(x, snr_db, generator):
        i = len(calls)
        calls.append(snr_db)
        if sweep == "clock_offset":     # the port's resample is JAX's, bit for bit
            np.testing.assert_array_equal(x.numpy(), np.asarray(
                jchannel.clock_offset(jnp.asarray(wave), points[i])))
        else:
            np.testing.assert_array_equal(x.numpy(), wave)
        return torch.from_numpy(captures[i])

    monkeypatch.setattr(channel, "awgn", fake_awgn)
    if sweep == "ber":
        rows = ber.ber_sweep(snr_dbs=points, n_frames=n_frames, payload_len=payload_len,
                             device="cpu")
    else:
        rows = ber.clock_offset_sweep(ppms=points, n_frames=n_frames, payload_len=payload_len,
                                      device="cpu")
    assert len(calls) == len(points)
    want = _jax_rows(jcfg, captures, payloads, n_frames)
    for row, (bit_err, decoded, bits), p in zip(rows, want, points):
        assert row["frames_decoded"] == decoded and row["frames_sent"] == n_frames
        assert row["frame_loss_pct"] == 100.0 * (n_frames - decoded) / n_frames
        if sweep == "ber":
            assert row["snr_db"] == p and row["payload_bit_errors"] == bit_err
            assert row["ber"] == (bit_err / bits if bits else None)
        else:
            assert row["clock_ppm"] == p
    losses = [r["frame_loss_pct"] for r in rows]
    assert losses[-1] == (0.0 if sweep == "ber" else 100.0) and len(set(losses)) > 1


def test_score_matches_jax():
    """_score on one decode, valid slots with a sequence past the frames sent
    skipped, bit errors counted."""
    from trackmaker_tpu.bench.ber import _score as jax_score

    payloads = np.random.default_rng(2).integers(0, 256, (3, 10), dtype=np.uint8)
    k = 5
    fb = np.zeros((k, 7 + 256), np.uint8)
    seq = np.array([0, 2, 7, 1, 0], np.int32)
    valid = np.array([True, True, True, False, True])
    for s in range(k):
        fb[s, 7:17] = payloads[min(seq[s], 2)]
    fb[4, 9] ^= 0b1011                                # three bit errors
    res = DecodedFrames(valid=torch.from_numpy(valid), frame_bytes=torch.from_numpy(fb),
                        length=torch.full((k,), 10, dtype=torch.int32),
                        frame_type=torch.ones(k, dtype=torch.int32),
                        sequence=torch.from_numpy(seq), src=torch.ones(k, dtype=torch.int32),
                        dst=torch.full((k,), 2, dtype=torch.int32),
                        start=torch.zeros(k, dtype=torch.int32), corr=torch.ones(k))
    jres = convert.frames_to_numpy(res)
    got = ber._score(res, payloads)
    assert got == jax_score(DecodedFrames(**jres), payloads) == (3, 3, 240)
