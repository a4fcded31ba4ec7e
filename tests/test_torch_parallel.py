"""The port's multi-device decode (trackmaker_tpu_torch/parallel/mesh.py and
the sharded routes of parallel/stream.py) against the JAX package's on its
8-device CPU mesh, the port on meshes of ``cpu`` repeated.

The sharded captures: chip_smoke.py's seam scenarios (those of
tests/test_parallel_adversarial.py:119-164, in both line codes: evil frames
whose payload embeds a preamble and a CRC-valid frame of sequence 99, and a
chain of them across seams), blocks a third of the halo long (a window
shorter than block + halo, its valid length past its end), a last block
shorter than the halo, a clean capture, and a capture so short that the
last shard's valid length is below 0.  JAX's speculative route runs its
Pallas kernels in interpret mode, the port its kernels' plain versions;
each JAX reference runs once.

Tolerances: the ok flags, the valid masks and the valid-masked fields
(bytes, length, type, sequence, addresses, start) are equal, the
correlation within 1e-5 (sum order).  The data-parallel decode keeps JAX's
frames in other slots (JAX runs the exact scan, the port the speculative
decode), so its rows are compared as lists of frames."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

import chip_smoke
from trackmaker_tpu.core.config import PhyConfig as JaxPhyConfig
from trackmaker_tpu.parallel import mesh as jmesh
from trackmaker_tpu.parallel import stream as jstream
from trackmaker_tpu_torch import convert
from trackmaker_tpu_torch.core.framing import Frame
from trackmaker_tpu_torch.parallel import mesh, stream
from trackmaker_tpu_torch.phy.decoder import decode_capture, decode_capture_fast
from trackmaker_tpu_torch.phy.encoder import PhyEncoder
from trackmaker_tpu_torch.tools.dryrun_multichip import dryrun_multichip, evil_frame

LOCAL = 2
MFPB = chip_smoke.SEAM_SHARD_MFPB
CPU8 = ["cpu"] * 8


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _configs(coding: str):
    jcfg = JaxPhyConfig(line_coding=coding)
    return jcfg, convert.phy_config_from_fields(dataclasses.asdict(jcfg))


def _place(cfg, total: int, placed) -> np.ndarray:
    enc = PhyEncoder(cfg, device="cpu")
    wave = np.zeros(total, np.float32)
    for pos, frame in placed:
        w = enc.encode_frame(frame).numpy()[: total - pos]
        wave[pos: pos + len(w)] = w
    return wave


def _small_blocks():
    """An evil frame spanning three blocks of halo // 3, a frame at the end."""
    cfg = _configs("manchester")[1]
    block = stream.halo_size(cfg) // 3
    total = 8 * block
    tail_len = len(PhyEncoder(cfg, device="cpu").encode_frame(Frame.new_data(2, 1, 2, b"tail")))
    return _place(cfg, total, [(block - 60, evil_frame(1, b"WIDE")),
                               (total - tail_len - 10, Frame.new_data(2, 1, 2, b"tail"))])


def _short_last_block():
    """Blocks a little longer than the halo, the last one 500 samples: a
    frame in shard 6, a long frame from shard 6's end whose body runs past
    the capture (into shard 6's zero-padded halo, counted valid), and a
    frame in the last 500 samples cut by the capture's end."""
    cfg = _configs("manchester")[1]
    block = stream.halo_size(cfg) + 3000
    total = 7 * block + 500
    return _place(cfg, total, [
        (6 * block + 100, Frame.new_data(2, 1, 2, b"in shard 6")),
        (7 * block - 900, Frame.new_data(5, 1, 2, bytes(range(200)))),
        (7 * block + 40, Frame.new_data(6, 1, 2, b"cut")),
    ])


def _clean():
    cfg = _configs("manchester")[1]
    enc = PhyEncoder(cfg, device="cpu")
    rng = np.random.default_rng(5)
    parts = []
    for i in range(10):
        parts.append(rng.normal(0, 0.02, 2000 + 321 * i).astype(np.float32))
        parts.append(enc.encode_frame(Frame.new_data(i, 1, 2, bytes([i]) * (4 + i))).numpy())
    parts.append(np.zeros(30000, np.float32))
    return np.concatenate(parts)


def _scenarios() -> dict:
    out = dict(chip_smoke.sharded_inputs())
    out["small_blocks"] = ("manchester", _small_blocks(), (2, 4))
    out["short_last_block"] = ("manchester", _short_last_block(), (2, 4))
    out["clean"] = ("manchester", _clean(), (2, 4))
    out["tiny"] = ("manchester", np.zeros(41, np.float32), (2, 4))   # last shard's vlen -1
    return out


SCENARIOS = _scenarios()
_JAX: dict = {}


def _jax(name: str, use_spec: bool):
    """JAX's sharded decode of a scenario, once: the speculative route as
    (frames, ok per shard) from its shard_map body, the exact route as
    decode_blocked_sharded gives it."""
    if (name, use_spec) not in _JAX:
        coding, wave, (dp, sp) = SCENARIOS[name]
        jcfg = _configs(coding)[0]
        jm = jmesh.make_mesh(dp=dp, sp=sp)
        if use_spec:
            x = jnp.asarray(wave, jnp.float32)
            t, n = x.shape[-1], dp * sp
            block = -(-t // n)
            blocks = jnp.pad(x, (0, block * n - t)).reshape(n, block)
            flat = JaxMesh(jm.devices.reshape(-1), axis_names=("sp",))
            out, ok = jstream._sharded_spec_run(jcfg, blocks, LOCAL, flat, t, block, MFPB, 128,
                                                True)
            _JAX[name, use_spec] = (jax.tree_util.tree_map(
                lambda a: np.asarray(a).reshape((-1,) + a.shape[2:]), out),
                np.asarray(ok).reshape(-1))
        else:
            _JAX[name, use_spec] = (jstream.decode_blocked_sharded(
                jcfg, wave, LOCAL, jm, max_frames_per_block=MFPB, use_spec=False), None)
    return _JAX[name, use_spec]


def _assert_valid_masked(got, want):
    valid = got.valid.numpy()
    np.testing.assert_array_equal(valid, np.asarray(want.valid), "valid")
    for name in ("frame_bytes", "length", "frame_type", "sequence", "src", "dst", "start"):
        np.testing.assert_array_equal(getattr(got, name).numpy()[valid],
                                      np.asarray(getattr(want, name))[valid], name)
    np.testing.assert_allclose(got.corr.numpy()[valid], np.asarray(want.corr)[valid],
                               rtol=0, atol=1e-5)


def _pairs(res):
    valid = np.asarray(res.valid)
    return sorted(zip(np.asarray(res.start)[valid].tolist(),
                      np.asarray(res.sequence)[valid].tolist()))


def _row_frames(res, r: int) -> list:
    """Row r's valid frames in slot order: (bytes, length, type, sequence,
    src, dst, start)."""
    cols = {f: np.asarray(getattr(res, f))[r] for f in res._fields}
    return [(cols["frame_bytes"][k, :7 + int(cols["length"][k])].tobytes(),
             *(int(cols[f][k]) for f in ("length", "frame_type", "sequence", "src", "dst",
                                          "start")))
            for k in np.nonzero(cols["valid"])[0]]


def _port_mesh(name):
    dp, sp = SCENARIOS[name][2]
    return mesh.make_mesh(dp=dp, sp=sp, devices=CPU8)


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_sharded_spec_route_matches_jax(name):
    coding, wave, _ = SCENARIOS[name]
    want, want_ok = _jax(name, True)
    got, ok, turns = stream.sharded_spec_run(_configs(coding)[1], wave, LOCAL, _port_mesh(name),
                                             MFPB)
    np.testing.assert_array_equal(ok.numpy(), want_ok)
    _assert_valid_masked(got, want)
    assert 1 <= turns <= 8
    assert all(sq != 99 for _, sq in _pairs(got))


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_sharded_exact_route_matches_jax(name):
    coding, wave, _ = SCENARIOS[name]
    want, _ = _jax(name, False)
    got = stream.decode_blocked_sharded(_configs(coding)[1], wave, LOCAL, _port_mesh(name),
                                        max_frames_per_block=MFPB, use_spec=False)
    _assert_valid_masked(got, want)
    # both routes give the same frames
    assert _pairs(got) == _pairs(_jax(name, True)[0])


def test_sharded_expect_is_jax():
    """chip_smoke.SHARDED_EXPECT: JAX's (start, sequence) pairs of the seam
    scenarios, which equal the sequential exact scan's."""
    for name in chip_smoke.sharded_inputs():
        assert chip_smoke.SHARDED_EXPECT[name] == _pairs(_jax(name, True)[0]), name
        coding, wave, _ = SCENARIOS[name]
        seq = decode_capture(_configs(coding)[1], torch.from_numpy(wave), LOCAL, max_frames=32)
        assert _pairs(seq) == chip_smoke.SHARDED_EXPECT[name], name


def test_default_route_and_fallback():
    """use_spec=None takes the speculative route on a covered
    configuration; a configuration the kernels do not cover takes the
    exact route even with use_spec=True, as in JAX."""
    coding, wave, _ = SCENARIOS["evil_seam, manchester"]
    cfg = _configs(coding)[1]
    m = _port_mesh("evil_seam, manchester")
    got = stream.decode_blocked_sharded(cfg, wave, LOCAL, m, max_frames_per_block=MFPB)
    spec, ok, _ = stream.sharded_spec_run(cfg, wave, LOCAL, m, MFPB)
    assert bool(ok.all())
    for g, s in zip(got, spec):
        assert torch.equal(g, s)
    other = cfg.replace(samples_per_level=2)
    wave2 = _place(other, 40_000, [(9_950, Frame.new_data(3, 1, 2, b"spl2 straddler"))])
    got2 = stream.decode_blocked_sharded(other, wave2, LOCAL, mesh.make_mesh(sp=4, devices=CPU8),
                                         max_frames_per_block=4, use_spec=True)
    assert _pairs(got2) == [(9_950, 3)]


def test_windows_and_valid_lengths():
    """JAX's window rule: the next block's first min(halo, block) samples,
    zeros for the last shard, valid lengths block + halo and T - i * block;
    shards on one device in order, as copies of the capture."""
    x = torch.arange(50, dtype=torch.float32)
    m = mesh.make_mesh(dp=1, sp=4, devices=["cpu"] * 4)
    sw = stream.shard_windows(x, m, halo=5)
    assert sw.block == 13 and sw.vlens == [18, 18, 18, 50 - 39]
    idx, wins = sw.groups[torch.device("cpu")]
    assert idx == [0, 1, 2, 3] and wins.shape == (4, 18)
    assert wins[1].tolist() == list(range(13, 31))
    assert wins[3].tolist() == list(range(39, 50)) + [0.0] * 7
    sw = stream.shard_windows(x, m, halo=40)          # block < halo: the window is 2 * block
    assert sw.groups[torch.device("cpu")][1].shape == (4, 26) and sw.vlens[:3] == [53] * 3
    wins.fill_(-1.0)
    assert x[13] == 13.0


def test_batch_sharded_decode_matches_jax():
    """dp = 8 over rows of four frames at different offsets and noise."""
    jcfg, cfg = _configs("manchester")
    rng = np.random.default_rng(0)
    frames = [Frame.new_data(i, 1, 2, rng.integers(0, 256, 64, dtype=np.uint8).tobytes())
              for i in range(4)]
    wave = PhyEncoder(cfg, device="cpu").encode_frames(frames, gap_samples=300).numpy()
    t = len(wave) + 800
    batch = np.zeros((8, t), np.float32)
    for r in range(8):
        batch[r, 97 * r: 97 * r + len(wave)] = wave
    batch += rng.normal(0, 0.05, batch.shape).astype(np.float32)
    want = jmesh.batch_sharded_decode(jcfg, batch, LOCAL, jmesh.make_mesh(8, dp=8, sp=1),
                                      max_frames=8)
    got = mesh.batch_sharded_decode(cfg, batch, LOCAL, mesh.make_mesh(dp=8, devices=CPU8),
                                    max_frames=8)
    for r in range(8):
        assert _row_frames(got, r) == _row_frames(want, r), r
        assert [f.data for f in got.to_frames(r)] == [f.data for f in frames]
    whole = decode_capture_fast(cfg, torch.from_numpy(batch), LOCAL, max_frames=8)
    for g, w in zip(got, whole):
        assert torch.equal(g, w)
    # rows split over dp = 4 with two devices repeated
    got4 = mesh.batch_sharded_decode(cfg, torch.from_numpy(batch), LOCAL,
                                     mesh.make_mesh(dp=4, sp=2, devices=CPU8), max_frames=8)
    for g, w in zip(got4, whole):
        assert torch.equal(g, w)
    with pytest.raises(ValueError):
        mesh.batch_sharded_decode(cfg, batch[:6], LOCAL, mesh.make_mesh(dp=4, devices=CPU8))


def test_make_mesh():
    m = mesh.make_mesh(dp=2, sp=4, devices=CPU8)
    assert m.shape == {"dp": 2, "sp": 4} and len(m.flat) == 8
    assert mesh.make_mesh(devices=CPU8).shape == {"dp": 8, "sp": 1}
    assert mesh.make_mesh(4, sp=2, devices=CPU8).shape == {"dp": 2, "sp": 2}
    with pytest.raises(ValueError):
        mesh.make_mesh(dp=3, sp=3, devices=CPU8)


def test_make_mesh_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("needs a machine with no CUDA card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.make_mesh(dp=2, sp=1)


@pytest.mark.parametrize("n_shards", [4, 8])
def test_dryrun_multichip_on_the_cpu(n_shards):
    """The four checks of __graft_entry__.py's dryrun_multichip over a mesh
    of the CPU repeated."""
    got = dryrun_multichip(n_shards, ["cpu"] * n_shards)
    assert got["counts"] == {"exact": 12, "spec": 12}
    assert got["dp_counts"] == [3] * n_shards and got["ofdm_frames"] == 2 * n_shards
    assert got["evil_seam"] and all(sq == 5 for _, sq in got["evil_seam"])
    with pytest.raises(ValueError):
        dryrun_multichip(n_shards, ["cpu"] * (n_shards - 1))
