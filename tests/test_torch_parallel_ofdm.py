"""The port's sharded OFDM decode (trackmaker_tpu_torch/parallel/ofdm_stream.py)
against the JAX package's on its 8-device CPU mesh, the port on meshes of
``cpu`` repeated: the four cases of tests/test_parallel_ofdm.py (frames in
gaps over a (2, 4) mesh, frames across the seams of 8 shards, the mixed
adaptive loading, and a capture too short to shard), then chip_smoke.py's
two sharded OFDM captures over 4 shards.  The captures come from the
port's modulators on the host; both packages decode the same samples.

Tolerances: the frames (every byte) are equal, in capture order."""

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
from trackmaker_tpu.parallel import mesh as jmesh
from trackmaker_tpu.parallel import ofdm_stream as jofdm_stream
from trackmaker_tpu.phy.ofdm_adaptive import OfdmAdaptiveConfig as JaxAdaptiveConfig
from trackmaker_tpu.phy.ofdm_v2 import OfdmV2Config as JaxV2Config
from trackmaker_tpu_torch.core.framing import Frame
from trackmaker_tpu_torch.parallel import mesh
from trackmaker_tpu_torch.parallel.ofdm_stream import decode_ofdm_blocked_sharded, ofdm_halo_size
from trackmaker_tpu_torch.phy.ofdm_adaptive import OfdmAdaptiveConfig, OfdmAdaptiveModem
from trackmaker_tpu_torch.phy.ofdm_v2 import OfdmModemV2, OfdmV2Config

PAYLOAD = 40


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _capture(modem, frames, gaps, lead=500, tail=900, sigma=0.006, seed=0):
    rng = np.random.default_rng(seed)
    parts = [np.zeros(lead, np.float32)]
    for f, g in zip(frames, gaps):
        parts += [modem.encode_frames([f]), np.zeros(g, np.float32)]
    wave = np.concatenate(parts + [np.zeros(tail, np.float32)])
    return (wave + rng.normal(0, sigma, len(wave))).astype(np.float32)


def _v2_gaps():
    modem = OfdmModemV2(device="cpu")
    frames = [Frame.new_data(i, 1, 2, bytes([i + 1]) * PAYLOAD) for i in range(12)]
    gaps = [int(g) for g in np.random.default_rng(1).integers(200, 2500, 12)]
    return modem.cfg, frames, _capture(modem, frames, gaps), (2, 4)


def _straddlers():
    modem = OfdmModemV2(device="cpu")
    cfg = modem.cfg
    flen = len(modem.encode_frames([Frame.new_data(0, 1, 2, bytes(PAYLOAD))]))
    frames = [Frame.new_data(i, 1, 2, bytes([i + 1]) * PAYLOAD) for i in range(10)]
    t = 8 * (ofdm_halo_size(cfg, (7 + PAYLOAD) * 8) + 4000)
    block = -(-t // 8)
    parts = np.zeros(t + flen + 2000, np.float32)
    starts = [700 + i * (t // 10) for i in range(10)]
    for pos, f in zip(starts, frames):
        w = modem.encode_frames([f])
        parts[pos:pos + len(w)] += w
    assert sum((p % block) + flen > block for p in starts) >= 2
    wave = (parts + np.random.default_rng(2).normal(0, 0.006, len(parts))).astype(np.float32)
    return cfg, frames, wave, (1, 8)


def _adaptive():
    rng = np.random.default_rng(3)
    n_data = len(OfdmAdaptiveConfig().data_bin_idx)
    loading = tuple(int(v) for v in rng.choice([1, 2, 4, 6], size=n_data,
                                                p=[0.2, 0.4, 0.3, 0.1]))
    modem = OfdmAdaptiveModem(OfdmAdaptiveConfig(), loading=loading, device="cpu")
    frames = [Frame.new_data(i, 1, 2, bytes([i + 9]) * PAYLOAD) for i in range(8)]
    gaps = [int(g) for g in rng.integers(400, 3000, 8)]
    return modem.cfg, frames, _capture(modem, frames, gaps, sigma=0.004, seed=3), (4, 2)


def _short():
    modem = OfdmModemV2(device="cpu")
    frames = [Frame.new_data(i, 1, 2, bytes([i + 1]) * PAYLOAD) for i in range(2)]
    return modem.cfg, frames, _capture(modem, frames, [300, 300]), (2, 4)


def _chip_smoke(adaptive: bool):
    modem, frames, _, wave = chip_smoke.ofdm_shard_input(adaptive)
    return modem.cfg, frames, wave, (1, chip_smoke.MESH_SHARDS)


# name -> (capture function, max_frames_per_block as tests/test_parallel_ofdm.py passes it)
CASES = {"v2_gaps": (_v2_gaps, 8), "straddlers": (_straddlers, 6),
         "adaptive_loading": (_adaptive, 6), "short_capture": (_short, 16),
         "chip_smoke_v2": (lambda: _chip_smoke(False), 16),
         "chip_smoke_adaptive": (lambda: _chip_smoke(True), 16)}


def _jax_cfg(cfg):
    """The JAX package's configuration with the port's fields."""
    cls = JaxAdaptiveConfig if isinstance(cfg, OfdmAdaptiveConfig) else JaxV2Config
    return cls(**dataclasses.asdict(cfg))


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_ofdm_matches_jax(name):
    build, mfpb = CASES[name]
    cfg, frames, wave, (dp, sp) = build()
    n = dp * sp
    fb_len = len(frames[0].to_bytes())
    want = jofdm_stream.decode_ofdm_blocked_sharded(
        _jax_cfg(cfg), wave, fb_len, jmesh.make_mesh(n, dp=dp, sp=sp), max_frames_per_block=mfpb)
    got = decode_ofdm_blocked_sharded(cfg, wave, fb_len, mesh.make_mesh(
        dp=dp, sp=sp, devices=["cpu"] * n), max_frames_per_block=mfpb)
    assert [f.to_bytes() for f in got] == [f.to_bytes() for f in want]
    assert [f.data for f in got] == [f.data for f in frames]


def test_sharded_ofdm_equals_single_device():
    """The sharded decode of chip_smoke.py's v2 capture equals the
    single-device decode, and a tensor capture decodes as its array."""
    cfg, frames, wave, _ = _chip_smoke(False)
    fb_len = len(frames[0].to_bytes())
    m = mesh.make_mesh(sp=4, devices=["cpu"] * 4)
    got = decode_ofdm_blocked_sharded(cfg, torch.from_numpy(wave), fb_len, m,
                                      max_frames_per_block=16)
    single = OfdmModemV2(cfg, device="cpu").decode(wave, fb_len, max_frames=len(frames) + 4)
    assert [f.to_bytes() for f in got] == [f.to_bytes() for f in single]
    assert decode_ofdm_blocked_sharded(cfg, np.zeros(50_000, np.float32), fb_len, m) == []
