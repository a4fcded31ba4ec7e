"""The port's line code and encoder (trackmaker_tpu_torch.phy.line_coding,
.encoder) against the JAX package's, bit for bit, on the CPU."""

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


def test_four_b_five_b_is_not_ported_yet():
    cfg4 = CFG.replace(line_coding=jconfig.FOUR_B_FIVE_B)
    with pytest.raises(NotImplementedError):
        line_coding.preamble_waveform(cfg4)
    with pytest.raises(NotImplementedError):
        line_coding.encode(cfg4, torch.zeros(8, dtype=torch.uint8))


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
    got = encoder.PhyEncoder(CFG).encode_frames(ours, gap_samples=gap)
    want = jencoder.PhyEncoder(JCFG).encode_frames(theirs, gap_samples=gap)
    np.testing.assert_array_equal(got.numpy(), want)
    one = encoder.PhyEncoder(CFG).encode_frame(ours[1])
    np.testing.assert_array_equal(one.numpy(),
                                  jencoder.PhyEncoder(JCFG).encode_frame(theirs[1]))
    assert encoder.PhyEncoder(CFG).encode_frames([]).shape == (0,)


def test_encoder_refuses_payload_over_decoder_cap():
    enc = encoder.PhyEncoder(CFG)
    assert enc.preamble_len == CFG.preamble_len
    with pytest.raises(ValueError):
        enc.encode_frame(Frame.new_data(0, 1, 2, bytes(CFG.max_frame_bytes + 1)))
