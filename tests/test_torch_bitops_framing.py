"""The port's configuration, bit ops, CRC8 and frame codec
(trackmaker_tpu_torch.core) against the JAX package's, on the CPU."""

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trackmaker_tpu.core import bitops as jbitops
from trackmaker_tpu.core import config as jconfig
from trackmaker_tpu.core import framing as jframing
from trackmaker_tpu_torch import convert
from trackmaker_tpu_torch.core import bitops, config, framing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

JAX_CONFIGS = [
    jconfig.PhyConfig(),
    jconfig.PhyConfig(max_frame_data_size=64, samples_per_level=4),
    jconfig.PhyConfig(line_coding=jconfig.FOUR_B_FIVE_B),
    jconfig.PhyConfig(preamble_pattern_bytes=3, correlation_threshold=0.8,
                      inter_frame_gap_samples=96),
]


@pytest.mark.parametrize("jcfg", JAX_CONFIGS, ids=range(len(JAX_CONFIGS)))
def test_phy_config_matches_jax(jcfg):
    cfg = convert.phy_config_from_fields(dataclasses.asdict(jcfg))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    for prop in ("max_frame_bytes", "header_bits", "preamble_len", "sync_len",
                 "sync_margin", "header_samples", "max_frame_samples"):
        assert getattr(cfg, prop) == getattr(jcfg, prop), prop
    for n in (0, 1, 7, 8, 56, 2104):
        assert cfg.samples_for_bits(n) == jcfg.samples_for_bits(n)
    for n in (0, 1, 128, 256):
        assert cfg.frame_samples(n) == jcfg.frame_samples(n)
    assert cfg.replace(max_frame_data_size=32) == convert.phy_config_from_fields(
        dataclasses.asdict(jcfg.replace(max_frame_data_size=32)))


def test_config_constants_and_field_names_match_jax():
    for name in ("MANCHESTER", "FOUR_B_FIVE_B", "PHY_HEADER_BYTES",
                 "FRAME_TYPE_DATA", "FRAME_TYPE_ACK"):
        assert getattr(config, name) == getattr(jconfig, name), name
    ours = [(f.name, f.default) for f in dataclasses.fields(config.PhyConfig)]
    theirs = [(f.name, f.default) for f in dataclasses.fields(jconfig.PhyConfig)]
    assert ours == theirs
    with pytest.raises(KeyError):
        convert.phy_config_from_fields({"sample_rate": 48_000, "no_such_field": 1})


def test_crc8_table_and_host_crc_match_jax():
    np.testing.assert_array_equal(bitops.CRC8_TABLE, jbitops.CRC8_TABLE)
    rng = np.random.default_rng(1)
    for n in (0, 1, 5, 128, 256):
        data = rng.integers(0, 256, n, dtype=np.uint8)
        assert bitops.crc8_host(data) == jbitops.crc8_host(data)
        assert bitops.crc8_host(data.tobytes()) == jbitops.crc8_host(data.tobytes())


@pytest.mark.parametrize("n", [1, 7, 40, 256])
def test_batched_crc8_matches_jax_scan(n):
    rng = np.random.default_rng(n)
    data = rng.integers(0, 256, (6, n), dtype=np.uint8)
    length = rng.integers(0, n + 1, 6).astype(np.int32)
    length[0] = n
    want = np.asarray(jbitops.crc8(jnp.asarray(data), jnp.asarray(length)))
    got = bitops.crc8(torch.from_numpy(data), torch.from_numpy(length)).numpy()
    np.testing.assert_array_equal(got, want)
    full = bitops.crc8(torch.from_numpy(data)).numpy()
    assert full.tolist() == [jbitops.crc8_host(row) for row in data]


def test_pack_unpack_match_jax():
    rng = np.random.default_rng(2)
    data = rng.integers(0, 256, (3, 5, 33), dtype=np.uint8)
    bits = bitops.unpack_bits(torch.from_numpy(data))
    np.testing.assert_array_equal(bits.numpy(),
                                  np.asarray(jbitops.unpack_bits(jnp.asarray(data))))
    np.testing.assert_array_equal(bitops.pack_bits(bits).numpy(), data)
    raw_bits = rng.integers(0, 2, (4, 64), dtype=np.uint8)
    np.testing.assert_array_equal(
        bitops.pack_bits(torch.from_numpy(raw_bits)).numpy(),
        np.asarray(jbitops.pack_bits(jnp.asarray(raw_bits))))
    with pytest.raises(ValueError):
        bitops.pack_bits(torch.zeros(9, dtype=torch.uint8))
    np.testing.assert_array_equal(bitops.bytes_to_bits_host(data[0, 0].tobytes()),
                                  jbitops.bytes_to_bits_host(data[0, 0].tobytes()))
    np.testing.assert_array_equal(bitops.bits_to_bytes_host(raw_bits[0, :13]),
                                  jbitops.bits_to_bytes_host(raw_bits[0, :13]))


def test_frame_bytes_match_jax():
    rng = np.random.default_rng(3)
    for seq, n in ((0, 0), (7, 1), (255, 128), (300, 256)):
        payload = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        ours = framing.Frame.new_data(seq, 1, 2, payload)
        theirs = jframing.Frame.new_data(seq, 1, 2, payload)
        raw = ours.to_bytes()
        assert raw == theirs.to_bytes()
        back = framing.Frame.from_bytes(raw)
        assert dataclasses.asdict(back) == dataclasses.asdict(
            jframing.Frame.from_bytes(raw))
        corrupt = bytearray(raw)
        corrupt[2] ^= 0x40
        assert framing.Frame.from_bytes(bytes(corrupt)) is None
        assert jframing.Frame.from_bytes(bytes(corrupt)) is None
    assert framing.Frame.from_bytes(b"\x00\x01") is None
    bad_type = bytearray(framing.Frame.new_data(1, 1, 2, b"x").to_bytes())
    bad_type[3] = 7
    assert framing.Frame.from_bytes(bytes(bad_type)) is None


def test_parse_header_matches_jax():
    rng = np.random.default_rng(4)
    fb = rng.integers(0, 256, (5, 3, 12), dtype=np.uint8)
    fb[0, :, 3] = 1
    fb[1, :, 3] = 2
    got = framing.parse_header(torch.from_numpy(fb))
    want = jframing.parse_header(jnp.asarray(fb))
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), key)


def test_port_imports_no_jax():
    """Importing the port and every one of its modules loads neither jax
    nor the JAX package, and touches no device."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import trackmaker_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'trackmaker_tpu' or m.startswith('trackmaker_tpu.'))\n"
        "assert not bad, bad\n"
        "assert 'trackmaker_tpu_torch.phy.spec_decode' in sys.modules\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
