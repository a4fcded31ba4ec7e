"""The port's ASK modem building blocks (trackmaker_tpu_torch.phy.ask, dsp,
core/blockq, sync/sliding_dot) against the JAX package's, on the CPU.

Tolerances, each with its reason:
* chirp, carrier, the warm-up band, the demodulation weights and dense
  tables, frames, modulated frames and tracks: bit for bit (the same
  float32 operations in the same order);
* EMA power: rtol 4e-6 (a 512-term blocked product summed in another
  order; measured 8e-7);
* dense sync: atol 2e-6 on values up to about 1.1 (440 taps in tap order
  against XLA's convolution; measured 4e-7);
* the sliding-dot plain version against the Pallas kernel in interpret
  mode: 2e-6 of scale·Σ|x·p| per lag (tap order against banded matmuls;
  measured 2.2e-7);
* the update mask, first-set queries and the exact scan's decisions:
  exactly equal.  The update mask is exact because no lag of the captures
  lies within 1e-5 of a threshold where the other condition holds (the
  margin asserts below)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trackmaker_tpu.core import blockq as jblockq
from trackmaker_tpu.dsp import filters as jfilters
from trackmaker_tpu.dsp import osc as josc
from trackmaker_tpu.oracle import ask as oracle_ask
from trackmaker_tpu.phy import ask as jask
from trackmaker_tpu.sync.pallas_xcorr import pallas_normalized_xcorr
from trackmaker_tpu_torch import convert
from trackmaker_tpu_torch.core import blockq
from trackmaker_tpu_torch.dsp import filters, osc
from trackmaker_tpu_torch.phy import ask
from trackmaker_tpu_torch.sync.sliding_dot import (
    sliding_dot_scaled,
    sliding_dot_scaled_plain,
)

JCFG = jask.AskConfig()
CFG = convert.ask_config_from_fields(dataclasses.asdict(JCFG))
TEXT = open("assets/think-different.txt", "rb").read()
MARGIN = 1e-5


def _noisy_track(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    frames = ask.build_frames(b"noise differential", CFG, num_frames=6)
    wave = ask.build_track(CFG, frames, seed=seed)
    return wave + rng.normal(0, 0.05, len(wave)).astype(np.float32)



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread while this module runs: the suite runs a worker per
    core, and torch's own thread pool on top of that oversubscribes the
    cores, where its many small ops then wait on each other."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)

def _assert_decoded_equal(got: ask.AskDecoded, want) -> None:
    for name, g, w in zip(want._fields, got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


def test_ask_config_matches_jax():
    assert dataclasses.asdict(CFG) == dataclasses.asdict(JCFG)
    assert (CFG.coded_bits, CFG.frame_samples, CFG.payload_bits) == (
        JCFG.coded_bits, JCFG.frame_samples, JCFG.payload_bits)
    with pytest.raises(KeyError):
        convert.ask_config_from_fields({"carrier": 1.0})


@pytest.mark.parametrize("args", [(440, 2000.0, 10000.0, 48000), (256, 1000.0, 7000.0, 44100),
                                  (32, 500.0, 900.0, 8000)])
def test_chirp_and_carrier_bit_identical(args):
    n, lo, hi, fs = args
    np.testing.assert_array_equal(osc.chirp_freq_profile(n, lo, hi),
                                  josc.chirp_freq_profile(n, lo, hi))
    np.testing.assert_array_equal(osc.chirp_np(*args), josc.chirp_np(*args))
    np.testing.assert_array_equal(osc.chirp_cached(*args), josc.chirp_cached(*args))
    np.testing.assert_array_equal(osc.carrier_np(5000, hi, fs), josc.carrier_np(5000, hi, fs))


@pytest.mark.parametrize("kw", [{}, {"bit_lo": 2}, {"bit_hi": 42, "smooth_half": 7},
                                {"carrier_hz": 10_000.5}])
def test_tables_bit_identical(kw):
    cfg, jcfg = ask.AskConfig(**kw), jask.AskConfig(**kw)
    np.testing.assert_array_equal(ask._warmup_band_np(cfg), jask._warmup_band_np(jcfg))
    np.testing.assert_array_equal(ask._demod_weights_np(cfg), jask._demod_weights_np(jcfg))
    got, want = ask._demod_dense_tables_np(cfg), jask._demod_dense_tables_np(jcfg)
    assert (got is None) == (want is None) == bool(kw)
    for g, w in zip(got or (), want or ()):
        np.testing.assert_array_equal(g, w)
    car, wts = ask.demod_tables(cfg, "cpu")
    jcar, jwts = jask.demod_tables(jcfg)
    np.testing.assert_array_equal(car.numpy(), np.asarray(jcar))
    np.testing.assert_array_equal(wts.numpy(), np.asarray(jwts))


def test_frames_modulation_and_track_bit_identical():
    for n in (5, 100, 130):
        np.testing.assert_array_equal(ask.build_frames(TEXT, CFG, n),
                                      jask.build_frames(TEXT, JCFG, n))
    frames = ask.build_frames(TEXT, CFG, num_frames=5)
    np.testing.assert_array_equal(
        ask.modulate_frames(CFG, torch.from_numpy(frames)).numpy(),
        np.asarray(jask.modulate_frames(JCFG, jnp.asarray(frames))))
    gaps = np.asarray([[3, 7], [0, 0], [50, 99], [1, 2], [20, 30]])
    np.testing.assert_array_equal(ask.build_track(CFG, frames, gaps=gaps),
                                  jask.build_track(JCFG, frames, gaps=gaps))
    np.testing.assert_array_equal(ask.build_track(CFG, frames, seed=4),
                                  jask.build_track(JCFG, frames, seed=4))
    np.testing.assert_array_equal(ask.build_track(CFG, frames, gaps=gaps),
                                  oracle_ask.modulate(frames, gaps=gaps))


@pytest.mark.parametrize("t", [1, 511, 512, 5000, 20_480])
def test_ema_power_matches_jax(t):
    x = np.random.default_rng(t).normal(0, 0.5, (3, t)).astype(np.float32)
    got = filters.ema_power(torch.from_numpy(x)).numpy()
    want = np.asarray(jfilters.ema_power(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=4e-6, atol=1e-12)


def test_matmul_f32_restores_the_tf32_flag():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        a = torch.ones(3, 4)
        assert torch.equal(filters.matmul_f32(a, a.T), torch.full((3, 3), 4.0))
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dense_arrays_match_jax(seed):
    """The dense phase on the noisy captures of tests/test_ask_spec.py."""
    wave = _noisy_track(seed)
    power, sync, upd = (a[0].numpy() for a in ask.dense_arrays(CFG, torch.from_numpy(wave)[None]))
    jpower, jsync, jupd = (np.asarray(a) for a in jax.jit(
        lambda r: jask.dense_arrays(JCFG, r))(jnp.asarray(wave)))
    np.testing.assert_allclose(power, jpower, rtol=4e-6, atol=1e-12)
    np.testing.assert_allclose(sync, jsync, rtol=0, atol=2e-6)
    np.testing.assert_array_equal(upd, jupd)
    assert upd.sum() >= 6                              # one run per preamble at least
    # upd = A & B; a lag can flip only where one condition is within the
    # margin and the other is not clearly false
    a = sync - CFG.sync_power_factor * power
    b = sync - CFG.sync_abs_threshold
    assert not ((np.abs(a) <= MARGIN) & (b > -MARGIN)).any()
    assert not ((np.abs(b) <= MARGIN) & (a > -MARGIN)).any()


@pytest.mark.parametrize("t", [3000, 3072])
def test_first_set_from_matches_jax(t):
    """Random masks, cursors before the start, inside, at and past the end
    (where the clip to the last padded position applies when T is a
    multiple of 512)."""
    rng = np.random.default_rng(t)
    mask = rng.random((4, t)) < 0.002
    mask[1] = False
    mask[2, -1] = True
    mask[3, :] = False
    mask[3, 700] = True
    cursors = np.concatenate([[-5, 0, 1, 511, 512, t - 1, t, t + 1, t + 600, 2**30],
                              rng.integers(0, t, 30)]).astype(np.int32)
    got_first, got_has = blockq.first_set_from(
        blockq.block_tables(torch.from_numpy(mask)),
        torch.from_numpy(np.broadcast_to(cursors, (4, len(cursors))).copy()))
    for r in range(4):
        tables = jblockq.block_tables(jnp.asarray(mask[r]))
        first, has = jax.vmap(lambda c: jblockq.first_set_from(tables, c))(jnp.asarray(cursors))
        np.testing.assert_array_equal(got_first[r].numpy(), np.asarray(first))
        np.testing.assert_array_equal(got_has[r].numpy(), np.asarray(has))
    assert bool(got_has[2, list(cursors).index(t + 600)]) == (t % 512 == 0)


@pytest.mark.parametrize("pattern,scale", [("chirp", 1.0 / 200.0), ("demod", 1.0)])
def test_sliding_dot_plain_matches_pallas(pattern, scale):
    """Kernel 2's plain version against the Pallas kernel in interpret mode
    on the left-padded input, as trackmaker_tpu/sync/__init__.py calls it."""
    p = ask._chirp_np(CFG) if pattern == "chirp" else ask._demod_dense_tables_np(CFG)[0]
    l = len(p)
    x = np.random.default_rng(l).normal(0, 1, (2, 9000)).astype(np.float32)
    x[1, 4000:] = 0.0
    got = sliding_dot_scaled_plain(torch.from_numpy(x), p, scale).numpy()
    before = sliding_dot_scaled.launches
    assert np.array_equal(sliding_dot_scaled(torch.from_numpy(x), p, scale).numpy(), got)
    assert sliding_dot_scaled.launches == before
    for r in range(2):
        padded = jnp.concatenate([jnp.zeros(l - 1, jnp.float32), jnp.asarray(x[r])])
        want = np.asarray(pallas_normalized_xcorr(padded, np.asarray(p), normalize=False,
                                                  scale=scale, interpret=True))
        ref = scale * np.convolve(np.abs(x[r]), np.abs(p)[::-1])[:x.shape[1]]
        assert want.shape == got[r].shape
        assert (np.abs(got[r] - want) <= 2e-6 * ref).all()
    with pytest.raises(ValueError):
        sliding_dot_scaled(torch.zeros(2, 100), np.ones(513, np.float32), 1.0)


def test_exact_scan_matches_oracle_and_jax():
    """A clean track (tests/test_ask_spec.py::test_spec_vs_oracle) through
    the exact scan: its frames equal the NumPy oracle's and every field the
    JAX exact scan's."""
    frames = ask.build_frames(b"oracle check", CFG, num_frames=5)
    gaps = np.random.default_rng(8).integers(0, 100, size=(5, 2))
    wave = ask.build_track(CFG, frames, gaps=gaps)
    got = ask.demodulate(CFG, torch.from_numpy(wave), max_frames=8)
    _assert_decoded_equal(got, jask.demodulate(JCFG, jnp.asarray(wave), max_frames=8))
    want = oracle_ask.demodulate(wave)
    valid = got.valid.numpy()
    assert got.frame_id.numpy()[valid].tolist() == [fid for fid, _ in want] == [1, 2, 3, 4, 5]
    for bits, (_, wbits) in zip(got.bits.numpy()[valid], want):
        np.testing.assert_array_equal(bits, wbits)
    np.testing.assert_array_equal(got.bits.numpy()[valid], frames[:, 8:])


def test_dense_demod_matches_slot_demod():
    """The slot and dense demodulations across unaligned and clipped-negative
    peaks (as tests/test_ask_spec.py::test_dense_demod_matches_slot): bit
    sums within 1e-5 of the JAX package's (another sum order; measured
    4e-6), none within 1e-4 of 0, so every decision equals JAX's."""
    rng = np.random.default_rng(11)
    frames = ask.build_frames(b"dense pin", CFG, num_frames=3)
    wave = ask.build_track(CFG, frames, seed=6)
    wave = wave + rng.normal(0, 0.1, len(wave)).astype(np.float32)
    t = len(wave)
    peaks = np.concatenate([rng.integers(0, t - CFG.frame_samples - 2, 32),
                            [-4753, -1, 0, 1, 23, 24, t - CFG.frame_samples - 2]]).astype(np.int32)
    x, pk = torch.from_numpy(wave), torch.from_numpy(peaks)
    ok = torch.ones(len(peaks), dtype=torch.bool)
    rx_pad = torch.nn.functional.pad(x, (0, CFG.frame_samples + 1032))
    car, wts = ask.demod_tables(CFG, "cpu")
    ds, dc = ask.demod_dense(CFG, x[None])
    sums = {"slot": ask.slot_bit_sums(CFG, rx_pad, car, wts, pk).numpy(),
            "dense": ask.dense_bit_sums(CFG, ds, dc, pk[None])[0].numpy()}
    got = {"slot": ask.demod_slot(CFG, rx_pad, car, wts, pk, ok),
           "dense": ask.demod_slot_dense(CFG, ds[0], dc[0], pk, ok)}

    jrx_pad = jnp.concatenate([jnp.asarray(wave), jnp.zeros(CFG.frame_samples + 1032)])
    jcar, jwts = jask.demod_tables(JCFG)
    jds, jdc = jask.demod_dense(JCFG, jnp.asarray(wave))
    _, s_per, c_per = (jnp.asarray(a) for a in jask._demod_dense_tables_np(JCFG))
    p0 = np.maximum(peaks + 1, 0)
    win = jrx_pad[p0[:, None] + np.arange(CFG.frame_samples)]
    idx = p0[:, None] + CFG.bit_lo - CFG.smooth_half + CFG.samples_per_bit * np.arange(108)
    m = p0 % 24
    want_sums = {"slot": np.asarray((win * jcar) @ jwts),
                 "dense": np.asarray(c_per[m][:, None] * jds[idx] - s_per[m][:, None] * jdc[idx])}
    one = jnp.asarray(True)
    want = {"slot": jax.vmap(lambda p: jask.demod_slot(JCFG, jrx_pad, jcar, jwts, p, one))(peaks),
            "dense": jax.vmap(lambda p: jask.demod_slot_dense(
                JCFG, jds, jdc, s_per, c_per, p, one))(peaks)}
    for form in ("slot", "dense"):
        np.testing.assert_allclose(sums[form], want_sums[form], rtol=0, atol=1e-5)
        assert np.abs(sums[form]).min() > 1e-4
        for name in want[form]:
            np.testing.assert_array_equal(got[form][name].numpy(), np.asarray(want[form][name]),
                                          err_msg=f"{form} {name}")
    # the carrier's direct sin at offsets up to 4752 drifts from the dense
    # path's periodic table by about 1e-3 (as the JAX test states)
    np.testing.assert_allclose(sums["dense"], sums["slot"], rtol=2e-3, atol=3e-3)


def test_text_roundtrip_through_demodulate_fast():
    """The reference's loopback check: 100 frames of think-different.txt
    with random gaps decode back to the text's prefix."""
    frames = ask.build_frames(TEXT, CFG, num_frames=100)
    track = ask.build_track(CFG, frames, seed=1)
    got = ask.demodulate_fast(CFG, torch.from_numpy(track), max_frames=110)
    assert int(got.count) == 100
    text = ask.assemble_text(got)
    assert text[:len(TEXT)] == TEXT and len(text) == 1150
