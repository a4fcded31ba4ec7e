"""The port's line codes and encoder (trackmaker_tpu_torch.phy.line_coding,
.encoder) against the JAX package's, bit for bit, on the CPU.

Tolerance: none; every bit, validity flag and sample is equal.  The
decoder inputs keep every level mean either exactly 0 or farther than
1e-7 from the near-zero bound 1e-6 and from 0, where a different sum
order could move a decision."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trackmaker_tpu.core import config as jconfig
from trackmaker_tpu.core import framing as jframing
from trackmaker_tpu.phy import encoder as jencoder
from trackmaker_tpu.phy import line_coding as jline
from trackmaker_tpu_torch import convert
from trackmaker_tpu_torch.core.framing import Frame
from trackmaker_tpu_torch.phy import encoder, line_coding

JCFG = jconfig.PhyConfig()
CFG = convert.phy_config_from_fields(dataclasses.asdict(JCFG))
JCFG4 = JCFG.replace(line_coding=jconfig.FOUR_B_FIVE_B)
CFG4 = CFG.replace(line_coding=jconfig.FOUR_B_FIVE_B)


@pytest.mark.parametrize("pattern_bytes,spl", [(2, 3), (3, 3), (2, 4)])
def test_preamble_matches_jax(pattern_bytes, spl):
    jcfg = JCFG.replace(preamble_pattern_bytes=pattern_bytes, samples_per_level=spl)
    cfg = CFG.replace(preamble_pattern_bytes=pattern_bytes, samples_per_level=spl)
    np.testing.assert_array_equal(line_coding.preamble_bits(pattern_bytes),
                                  jline.preamble_bits(pattern_bytes))
    ours = line_coding.preamble_waveform(cfg)
    assert ours.dtype == np.float32 and len(ours) == cfg.preamble_len
    np.testing.assert_array_equal(ours, jline.preamble_waveform(jcfg))


@pytest.mark.parametrize("spl", [1, 3])
def test_manchester_matches_jax(spl):
    rng = np.random.default_rng(spl)
    bits = rng.integers(0, 2, (3, 40), dtype=np.uint8)
    wave = line_coding.manchester_encode(torch.from_numpy(bits), spl)
    np.testing.assert_array_equal(
        wave.numpy(), np.asarray(jline.manchester_encode(jnp.asarray(bits), spl)))
    noisy = wave.numpy() + rng.normal(0, 0.4, wave.shape).astype(np.float32)
    noisy[0, :12] = 0.0          # silence decodes as 1 on both sides
    got = line_coding.manchester_decode(torch.from_numpy(noisy), spl)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jline.manchester_decode(jnp.asarray(noisy), spl)))
    np.testing.assert_array_equal(
        line_coding.manchester_decode(wave, spl).numpy(), bits)


@pytest.mark.parametrize("pattern_bytes,spl", [(2, 3), (3, 3), (2, 4)])
def test_fourb5b_preamble_matches_jax(pattern_bytes, spl):
    jcfg = JCFG4.replace(preamble_pattern_bytes=pattern_bytes, samples_per_level=spl)
    cfg = CFG4.replace(preamble_pattern_bytes=pattern_bytes, samples_per_level=spl)
    ours = line_coding.preamble_waveform(cfg)
    assert ours.dtype == np.float32 and len(ours) == cfg.preamble_len
    np.testing.assert_array_equal(ours, jline.preamble_waveform(jcfg))


def test_fourb5b_tables_match_jax():
    np.testing.assert_array_equal(line_coding.FOURB_FIVEB_ENCODE, jline.FOURB_FIVEB_ENCODE)
    np.testing.assert_array_equal(line_coding.FOURB_FIVEB_DECODE, jline.FOURB_FIVEB_DECODE)


@pytest.mark.parametrize("n_bits,spl", [(40, 3), (37, 3), (64, 2)])
def test_fourb5b_encode_matches_jax(n_bits, spl):
    rng = np.random.default_rng(n_bits)
    bits = rng.integers(0, 2, (3, n_bits), dtype=np.uint8)
    coded = line_coding.fourb5b_code_bits(torch.from_numpy(bits))
    want = np.asarray(jline.fourb5b_code_bits(jnp.asarray(bits)))
    assert coded.dtype == torch.uint8
    np.testing.assert_array_equal(coded.numpy(), want)
    np.testing.assert_array_equal(line_coding.nrzi_encode_levels(coded).numpy(),
                                  np.asarray(jline.nrzi_encode_levels(jnp.asarray(want))))
    wave = line_coding.fourb5b_encode(torch.from_numpy(bits), spl)
    np.testing.assert_array_equal(
        wave.numpy(), np.asarray(jline.fourb5b_encode(jnp.asarray(bits), spl)))
    np.testing.assert_array_equal(
        line_coding.encode(CFG4.replace(samples_per_level=spl), torch.from_numpy(bits)).numpy(),
        wave.numpy())


def _fourb5b_waves(rng, n_rows=6, n_bits=96, spl=3):
    """Encoded waves with noise, zeroed levels (where the receiver's carry
    skips them), near-zero levels, and flipped symbols."""
    bits = rng.integers(0, 2, (n_rows, n_bits), dtype=np.uint8)
    wave = line_coding.fourb5b_encode(torch.from_numpy(bits), spl).numpy()
    wave = wave + rng.normal(0, 0.2, wave.shape).astype(np.float32)
    lvl = wave.reshape(n_rows, -1, spl)
    lvl[1, 3] = 0.0
    lvl[1, 4] = 0.0                     # two skipped levels in a row
    lvl[2, 0] = 0.0                     # the first level: the carry starts at +1
    lvl[2, 17] = 0.0
    lvl[3, 10] = [3e-7, 3e-7, 3e-7]     # mean 3e-7: near zero, skipped
    lvl[3, 20] = [3e-6, 3e-6, 3e-6]     # mean 3e-6: a sign
    lvl[4, 30:45] *= -1.0               # three inverted symbols
    lvl[5, 50:] = 0.0                   # silence from level 50 on
    return bits, wave


def test_fourb5b_decode_matches_jax():
    rng = np.random.default_rng(8)
    bits, wave = _fourb5b_waves(rng)
    mean = wave.reshape(wave.shape[0], -1, 3).astype(np.float64).mean(-1)
    away = (np.abs(mean) > 1e-7) & (np.abs(np.abs(mean) - 1e-6) > 1e-7)
    assert np.all((mean == 0) | away)
    got_bits, got_ok = line_coding.decode(CFG4, torch.from_numpy(wave))
    want_bits, want_ok = jline.decode(JCFG4, jnp.asarray(wave))
    assert got_bits.dtype == torch.uint8 and got_ok.dtype == torch.bool
    np.testing.assert_array_equal(got_bits.numpy(), np.asarray(want_bits))
    np.testing.assert_array_equal(got_ok.numpy(), np.asarray(want_ok))
    ok = got_ok.numpy()
    assert ok[0].all() and (got_bits.numpy()[0] == bits[0]).all()
    assert not ok[4].all() and not ok[5].all()
    # a ragged tail (not a whole symbol) is dropped on both sides
    got = line_coding.fourb5b_decode(torch.from_numpy(wave[:, :-7]), 3)
    want = jline.fourb5b_decode(jnp.asarray(wave[:, :-7]), 3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_last_valid_carry_matches_jax():
    rng = np.random.default_rng(9)
    avg = rng.normal(0, 1, (4, 50)).astype(np.float32)
    valid = rng.random((4, 50)) < 0.6
    valid[1] = False
    valid[2, :10] = False
    got = line_coding._last_valid_scan(torch.from_numpy(avg), torch.from_numpy(valid))
    want = jline._last_valid_scan(jnp.asarray(avg), jnp.asarray(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert np.all(got.numpy()[1] == 1.0)


def test_manchester_decode_dispatch_marks_every_bit_valid():
    rng = np.random.default_rng(10)
    wave = rng.normal(0, 1, (2, 60)).astype(np.float32)
    bits, ok = line_coding.decode(CFG, torch.from_numpy(wave))
    want_bits, want_ok = jline.decode(JCFG, jnp.asarray(wave))
    np.testing.assert_array_equal(bits.numpy(), np.asarray(want_bits))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(want_ok))
    with pytest.raises(ValueError):
        line_coding.decode(CFG.replace(line_coding="nrz"), torch.from_numpy(wave))


def test_encode_frame_bytes_matches_jax():
    rng = np.random.default_rng(5)
    raw = rng.integers(0, 256, (4, 19), dtype=np.uint8)
    got = encoder.encode_frame_bytes(CFG, torch.from_numpy(raw))
    want = np.asarray(jencoder.encode_frame_bytes(JCFG, jnp.asarray(raw)))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("gap", [None, 0, 200])
def test_encode_frames_matches_jax(gap):
    rng = np.random.default_rng(6)
    sizes = [3, 128, 3, 0, 256, 17]
    payloads = [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in sizes]
    ours = [Frame.new_data(i, 1, 2, p) for i, p in enumerate(payloads)]
    theirs = [jframing.Frame.new_data(i, 1, 2, p) for i, p in enumerate(payloads)]
    got = encoder.PhyEncoder(CFG, device="cpu").encode_frames(ours, gap_samples=gap)
    want = jencoder.PhyEncoder(JCFG).encode_frames(theirs, gap_samples=gap)
    np.testing.assert_array_equal(got.numpy(), want)
    one = encoder.PhyEncoder(CFG, device="cpu").encode_frame(ours[1])
    np.testing.assert_array_equal(one.numpy(),
                                  jencoder.PhyEncoder(JCFG).encode_frame(theirs[1]))
    assert encoder.PhyEncoder(CFG, device="cpu").encode_frames([]).shape == (0,)


def test_encoder_refuses_payload_over_decoder_cap():
    enc = encoder.PhyEncoder(CFG, device="cpu")
    assert enc.preamble_len == CFG.preamble_len
    with pytest.raises(ValueError):
        enc.encode_frame(Frame.new_data(0, 1, 2, bytes(CFG.max_frame_bytes + 1)))


@pytest.mark.parametrize("gap", [None, 150])
def test_fourb5b_encode_frames_matches_jax(gap):
    rng = np.random.default_rng(11)
    sizes = [5, 0, 128, 5, 33]
    payloads = [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in sizes]
    ours = [Frame.new_data(i, 1, 2, p) for i, p in enumerate(payloads)]
    theirs = [jframing.Frame.new_data(i, 1, 2, p) for i, p in enumerate(payloads)]
    got = encoder.PhyEncoder(CFG4, device="cpu").encode_frames(ours, gap_samples=gap)
    want = jencoder.PhyEncoder(JCFG4).encode_frames(theirs, gap_samples=gap)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.shape[0] == sum(CFG4.preamble_len + CFG4.frame_samples(n) for n in sizes) + (
        (len(sizes) - 1) * (CFG4.inter_frame_gap_samples if gap is None else gap))


def test_encoder_makes_waveforms_on_its_device():
    """The encoder defaults to the card; asked for the CPU it stays there,
    and without a card the default raises instead of falling back."""
    frame = Frame.new_data(0, 1, 2, b"dev")
    assert encoder.PhyEncoder(CFG).device == torch.device("cuda")
    cpu = encoder.PhyEncoder(CFG4, device="cpu")
    assert cpu.encode_frame(frame).device.type == "cpu"
    assert cpu.encode_frames([frame, frame]).device.type == "cpu"
    assert cpu.encode_frames([]).device.type == "cpu"
    if torch.cuda.is_available():
        assert encoder.PhyEncoder(CFG).encode_frame(frame).is_cuda
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            encoder.PhyEncoder(CFG).encode_frame(frame)
