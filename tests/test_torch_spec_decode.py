"""The port's speculative decode (trackmaker_tpu_torch.phy.spec_decode)
against the JAX package's (trackmaker_tpu/phy/pallas_decode.py), with the
Pallas kernels in interpret mode and the port's kernels through their
plain versions, on the CPU.  The JAX references run once per module.

Tolerances: candidate tables, attempt bytes and frame starts, walk
outputs, ok flags and the valid-masked frames are exactly equal; the
correlation at each frame agrees within atol 1e-5 (sum order)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from trackmaker_tpu.core.config import PhyConfig as JaxPhyConfig
from trackmaker_tpu.phy import pallas_decode as pd
from trackmaker_tpu.phy.line_coding import preamble_waveform as jax_preamble
from trackmaker_tpu.sync.pallas_xcorr import pallas_xcorr_hits
from trackmaker_tpu_torch import convert
from trackmaker_tpu_torch.core import bitops
from trackmaker_tpu_torch.core.framing import Frame
from trackmaker_tpu_torch.phy import line_coding
from trackmaker_tpu_torch.phy import spec_decode as sd
from trackmaker_tpu_torch.phy.encoder import PhyEncoder
from trackmaker_tpu_torch.sync.correlate import preamble_energy
from trackmaker_tpu_torch.sync.xcorr_hits import xcorr_hits

JCFG = JaxPhyConfig()
CFG = convert.phy_config_from_fields(dataclasses.asdict(JCFG))
PRE = jax_preamble(JCFG)
SYNC = PRE[48:]
N_CAND = 64
BIGI = 2**30
T = 10496


# --- the Manchester scenarios of tests/test_pallas_decode.py ----------------


def _raw(data, seq=0, src=1, dst=2, ftype=1):
    n = len(data)
    return bytes([n >> 8, n & 0xFF, bitops.crc8_host(data), ftype,
                  seq, src, dst]) + data


def _scenarios() -> dict[str, tuple[np.ndarray, int]]:
    """name -> (capture, valid length) of every scenario."""
    enc = PhyEncoder(CFG, device="cpu")

    def frame(seq, dst, data):
        return enc.encode_frame(Frame.new_data(seq, 1, dst, data)).numpy()

    def zeros(n):
        return np.zeros(n, np.float32)

    rng = np.random.default_rng(0)
    basic = []
    for i in range(5):
        basic.append(rng.normal(0, 0.03, 300 + 211 * i).astype(np.float32))
        basic.append(frame(i, 2, bytes([i]) * (3 + 5 * i)))
    evil = Frame.new_data(1, 1, 2, bytes([0x33, 0x5A]) + _raw(b"EVIL", seq=99))
    crc_bad = frame(2, 2, b"corrupt!").copy()
    bit = 7 * 8 + 4
    crc_bad[96 + bit * 6: 96 + (bit + 1) * 6] *= -1.0

    def hdr_wave(hb):
        bits = np.concatenate([bitops.bytes_to_bits_host(hb), np.zeros(64, np.uint8)])
        body = line_coding.manchester_encode(torch.from_numpy(bits), 3).numpy()
        return np.concatenate([PRE, body])

    cut_frame = frame(4, 2, b"cut-off-frame")
    caps = {
        "basic": np.concatenate(basic + [zeros(1500)]),
        "evil": np.concatenate([zeros(777), enc.encode_frame(evil).numpy(), zeros(400),
                                frame(2, 2, b"tail"), zeros(600)]),
        "dst_crc": np.concatenate([frame(1, 9, b"foreign"), zeros(300), crc_bad,
                                   zeros(300), frame(3, 2, b"good")]),
        "bad_headers": np.concatenate([
            hdr_wave(bytes([0, 0, 0, 1, 0, 1, 2])), zeros(300),
            hdr_wave(bytes([9, 9, 0, 7, 0, 1, 2])), zeros(300),
            frame(5, 2, b"after"), zeros(300)]),
        "incomplete": np.concatenate([zeros(200), cut_frame, zeros(500)]),
        "max_frames": enc.encode_frames(
            [Frame.new_data(i, 1, 2, bytes([i]) * 4) for i in range(8)],
            gap_samples=250).numpy(),
        "dense_hits": np.concatenate([PRE] * 8 + [zeros(3000)]),
        "promiscuous": np.concatenate([frame(1, 9, b"any"), zeros(300),
                                       frame(2, 5, b"dst"), zeros(300)]),
    }
    out = {name: (c, len(c)) for name, c in caps.items()}
    out["incomplete_cut"] = (caps["incomplete"], 200 + len(cut_frame) - 40)
    return out


def _batch():
    scen = _scenarios()
    names = list(scen)
    x = np.zeros((len(names), T), np.float32)
    vlen = np.zeros(len(names), np.int32)
    for r, name in enumerate(names):
        cap, n = scen[name]
        assert len(cap) <= T
        x[r, :len(cap)] = cap
        vlen[r] = n
    return names, x, vlen


RUNS = [(2, 16), (-1, 16), (2, 3)]       # (local address, max_frames)


@pytest.fixture(scope="module")
def jax_runs():
    names, x, vlen = _batch()
    out = {}
    for local, mf in RUNS:
        res, ok, searched, cur = pd.decode_capture_spec_jit(
            JCFG, jnp.asarray(x), local, max_frames=mf, n_cand=N_CAND,
            valid_len=jnp.asarray(vlen), interpret=True, with_cursor=True)
        out[local, mf] = (jax.tree_util.tree_map(np.asarray, res), np.asarray(ok),
                          np.asarray(searched), np.asarray(cur))
    phase_a = jax.jit(lambda xx, la, vl: pd._spec_phase_a(JCFG, xx, la, N_CAND, vl, True))
    a = phase_a(jnp.asarray(x), 2, jnp.asarray(vlen))
    return names, x, vlen, out, jax.tree_util.tree_map(np.asarray, a)


def _frames(res, row):
    """Valid-masked frames of one row in slot order."""
    f = {k: np.asarray(v)[row] for k, v in res._asdict().items()}
    return [(f["frame_bytes"][k, :7 + int(f["length"][k])].tobytes(),
             *(int(f[n][k]) for n in ("length", "frame_type", "sequence", "src",
                                      "dst", "start")))
            for k in np.nonzero(f["valid"])[0]]


@pytest.mark.parametrize("local,mf", RUNS)
def test_decode_capture_spec_matches_jax(jax_runs, local, mf):
    names, x, vlen, out, _ = jax_runs
    want, want_ok, want_searched, want_cur = out[local, mf]
    res, ok, searched, cur = sd.decode_capture_spec(
        CFG, torch.from_numpy(x), local, max_frames=mf, n_cand=N_CAND,
        valid_len=torch.from_numpy(vlen), with_cursor=True)
    np.testing.assert_array_equal(ok.numpy(), want_ok)
    assert want_ok.all()
    np.testing.assert_array_equal(searched.numpy(), want_searched)
    np.testing.assert_array_equal(cur.numpy(), want_cur)
    for r, name in enumerate(names):
        assert _frames(res, r) == _frames(want, r), name
        got_corr = res.corr.numpy()[r][res.valid.numpy()[r]]
        np.testing.assert_allclose(got_corr, want.corr[r][want.valid[r]], atol=1e-5)
    got = convert.frames_to_numpy(res)
    assert got["frame_bytes"].dtype == np.uint8 and got["start"].dtype == np.int32
    for key in ("frame_bytes", "length", "frame_type", "sequence", "src", "dst",
                "start", "corr"):
        empty = ~got["valid"]
        assert np.all(got[key][empty] == (-1 if key == "start" else 0)), key


def test_scenario_outcomes(jax_runs):
    """The scenarios' own expectations, on the port's results."""
    names, x, vlen, _, _ = jax_runs
    seqs = {}
    for local, mf in RUNS:
        res, _ = sd.decode_capture_spec(CFG, torch.from_numpy(x), local,
                                        max_frames=mf, n_cand=N_CAND,
                                        valid_len=torch.from_numpy(vlen))
        for r, name in enumerate(names):
            seqs[name, local, mf] = [f[3] for f in _frames(res, r)]
    assert 99 not in seqs["evil", 2, 16]
    assert seqs["dst_crc", 2, 16] == [3]
    assert seqs["bad_headers", 2, 16] == [5]
    assert seqs["incomplete_cut", 2, 16] == []
    assert seqs["incomplete", 2, 16] == [4]
    assert seqs["max_frames", 2, 3] == [0, 1, 2]
    assert seqs["promiscuous", -1, 16] == [1, 2]
    assert seqs["basic", 2, 16] == [0, 1, 2, 3, 4]


def test_spec_phase_a_matches_jax(jax_runs):
    names, x, vlen, _, want = jax_runs
    a = sd.spec_phase_a(CFG, torch.from_numpy(x), 2, N_CAND, torch.from_numpy(vlen))
    np.testing.assert_array_equal(a.cand.numpy(), want.cand)
    np.testing.assert_array_equal(a.overflow.numpy(), want.overflow)
    live = want.cand < BIGI
    assert live.sum() >= 30
    # slots past n_valid are never attempted; the JAX kernel leaves them unwritten
    for key in ("bytes_m", "dlen", "ftype", "seq", "src", "dst"):
        np.testing.assert_array_equal(getattr(a, key).numpy()[live],
                                      np.asarray(getattr(want, key))[live], key)
    np.testing.assert_array_equal(a.fields.numpy().transpose(0, 2, 1)[live],
                                  want.fields.transpose(0, 2, 1)[live])
    np.testing.assert_allclose(a.corr.numpy(), want.corr, atol=1e-5)


# --- step 2: compaction -------------------------------------------------------


_jax_compact_hit_rows = jax.jit(pd._compact_hit_rows, static_argnums=1)


def _jax_compact(rows, n_cand):
    return [np.asarray(v) for v in _jax_compact_hit_rows(jnp.asarray(rows), n_cand)]


def _check_compact(rows, n_cand):
    got = [v.numpy() for v in sd.compact_hit_rows(torch.from_numpy(rows), n_cand)]
    want = _jax_compact(rows, n_cand)
    for name, g, w in zip(("cand", "corr", "n_valid", "overflow"), got, want):
        np.testing.assert_array_equal(g, w, name)
    return got


def test_compact_hit_rows_matches_jax_on_kernel_rows(jax_runs):
    _, x, _, _, _ = jax_runs
    _, rows = xcorr_hits(torch.from_numpy(x), PRE, CFG.correlation_threshold)
    _, jrows = jax.vmap(lambda s: pallas_xcorr_hits(
        s, PRE, CFG.correlation_threshold, interpret=True, emit_corr=False))(
            jnp.asarray(x))
    np.testing.assert_array_equal(rows.numpy()[..., :5], np.asarray(jrows)[:, :rows.shape[1], :5])
    # the port has ceil(T/128) rows, the JAX kernel whole lag blocks: same table
    got = _check_compact(rows.numpy(), N_CAND)
    want = _jax_compact(np.asarray(jrows), N_CAND)
    for g, w in zip(got[:1] + got[2:], want[:1] + want[2:]):
        np.testing.assert_array_equal(g, w)


def test_compact_hit_rows_overflow_rows():
    """The per-row cap of tests/test_pallas_decode.py, then the group cap
    and the table cap."""
    rows = np.full((1, 4, 16), BIGI, np.int32)
    rows[..., 4:] = 0
    rows[0, 1, :4] = [128, 130, 140, 150]
    rows[0, 1, 5:9] = np.asarray([0.91, 0.92, 0.93, 0.94], np.float32).view(np.int32)
    rows[0, 1, 4] = 5
    assert _check_compact(rows, 16)[3][0]
    rows[0, 1, 4] = 4
    cand, corr, _, overflow = _check_compact(rows, 16)
    assert not overflow[0]
    assert cand[0, :4].tolist() == [128, 130, 140, 150]
    np.testing.assert_allclose(corr[0, :4], [0.91, 0.92, 0.93, 0.94], rtol=1e-6)

    rng = np.random.default_rng(21)
    many = np.full((3, 70, 16), BIGI, np.int32)
    many[..., 4:] = 0
    for b in range(3):
        for r in range(70):
            k = int(rng.integers(0, 3 if b < 2 else 5))
            many[b, r, :min(k, 4)] = np.sort(rng.choice(128, min(k, 4), replace=False)) + 128 * r
            many[b, r, 4] = k
            many[b, r, 5:5 + min(k, 4)] = rng.random(min(k, 4)).astype(np.float32).view(np.int32)
    for n_cand in (16, 64, 128, 300):
        _check_compact(many, n_cand)


# --- step 3: the attempt kernel ------------------------------------------------


def _jax_attempt_raw(x, cand, n_valid, vlen):
    """The JAX attempt kernel's own output, launched as _spec_phase_a
    launches it (interpret mode): bytes [B, C, 263] and fs [B, C]."""
    b, t = x.shape
    t8, sync_e = pd._sync_tables(tuple(SYNC.tolist()), 13)
    r384 = -(-(t + 48) // pd.DROW) + pd.NR + 10
    x384 = jnp.pad(jnp.asarray(x), ((0, 0), (0, r384 * pd.DROW - t))).reshape(
        b, r384, pd.DROW)
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=4, grid=(b,),
        in_specs=[pl.BlockSpec(memory_space=pltpu.HBM)]
        + [pl.BlockSpec(memory_space=pltpu.VMEM)] * 3,
        out_specs=pl.BlockSpec((1, N_CAND, pd.BROWS, 128),
                               lambda bb, *_: (bb, 0, 0, 0),
                               memory_space=pltpu.VMEM),
        scratch_shapes=[pltpu.VMEM((pd.ATTEMPT_PIPE, pd.NR, pd.DROW), jnp.float32),
                        pltpu.SemaphoreType.DMA((pd.ATTEMPT_PIPE,))])
    out = pl.pallas_call(
        functools.partial(pd._attempt_kernel, n_cand=N_CAND, t_max=t, sync_e=sync_e),
        out_shape=jax.ShapeDtypeStruct((b, N_CAND, pd.BROWS, 128), jnp.float32),
        grid_spec=grid_spec, interpret=True,
    )(jnp.asarray(cand), jnp.zeros_like(jnp.asarray(cand)), jnp.asarray(vlen),
      jnp.asarray(n_valid), x384, jnp.asarray(t8), jnp.asarray(pd._body_table()),
      jnp.asarray(pd._pack_table()))
    out = np.nan_to_num(np.asarray(out))      # slots past n_valid are unwritten
    byts = out[..., :8].reshape(b, N_CAND, pd.BROWS * 8)[..., :263].astype(np.uint8)
    fs = np.minimum(cand, t) + out[:, :, pd.BROWS - 1, 8].astype(np.int32)
    return byts, fs


def test_attempt_plain_matches_jax_kernel(jax_runs):
    names, x, vlen, _, _ = jax_runs
    xt = torch.from_numpy(x)
    _, rows = xcorr_hits(xt, PRE, CFG.correlation_threshold)
    cand, _, n_valid, _ = sd.compact_hit_rows(rows, N_CAND)
    # vlen cuts the refine window; the incomplete scenario's cut lands mid-frame
    byts, fs = sd.attempt_manchester(xt, cand, n_valid, torch.from_numpy(vlen), SYNC,
                                     preamble_energy(SYNC))
    want_b, want_fs = _jax_attempt_raw(x, cand.numpy(), n_valid.numpy(), vlen)
    live = np.arange(N_CAND)[None] < np.minimum(n_valid.numpy(), N_CAND)[:, None]
    np.testing.assert_array_equal(fs.numpy()[live], want_fs[live])
    np.testing.assert_array_equal(byts.numpy()[live], want_b[live])
    assert np.all(byts.numpy()[~live] == 0) and np.all(fs.numpy()[~live] == 0)
    assert byts.dtype == torch.uint8 and fs.dtype == torch.int32


def test_attempt_refine_edges():
    """Candidates whose refine windows run past the valid length or the
    capture's end, or lie in silence."""
    rng = np.random.default_rng(22)
    x = rng.normal(0, 0.2, (2, 700)).astype(np.float32)
    x[1, 300:] = 0.0
    cand = np.array([[0, 500, 600, 650] + [BIGI] * (N_CAND - 4),
                     [10, 280, 520, 604] + [BIGI] * (N_CAND - 4)], np.int32)
    n_valid = np.array([4, 4], np.int32)
    vlen = np.array([640, 700], np.int32)
    byts, fs = sd.attempt_manchester(torch.from_numpy(x), torch.from_numpy(cand),
                                     torch.from_numpy(n_valid), torch.from_numpy(vlen),
                                     SYNC, preamble_energy(SYNC))
    want_b, want_fs = _jax_attempt_raw(x, cand, n_valid, vlen)
    np.testing.assert_array_equal(fs.numpy()[:, :4], want_fs[:, :4])
    np.testing.assert_array_equal(byts.numpy()[:, :4], want_b[:, :4])
    # no refine position left before the valid length: fall back to i + 96
    assert fs.numpy()[0, 3] == 650 + 96
    # silence scores 0 at every position, and the first position wins
    assert fs.numpy()[1, 2] == 520 + 42 + 48


# --- step 5: the walk ---------------------------------------------------------


def _tables(seed):
    """One batch of 8 random tables of 128 candidates per cap: ascending
    positions (from none to all 128 real) with 2^30 pads, random flags,
    cursors and scan limits."""
    rng = np.random.default_rng(seed)
    b, c = 8, 128
    for mf in (1, 2, 5, 72, 256):
        pos = np.full((b, c), BIGI, np.int64)
        for i in range(b):
            k = int(rng.choice([0, 8, 32, 100, 128])) if i < 5 else int(rng.integers(0, c + 1))
            pos[i, :k] = np.sort(rng.integers(0, 40_000, k))
        fields = np.stack([pos, rng.integers(1, 3000, (b, c)),
                           rng.random((b, c)) < 0.25, rng.random((b, c)) < 0.6],
                          axis=1).astype(np.int32)
        cur0 = rng.integers(0, 30_000, b).astype(np.int32)
        limit = rng.choice([20_000, 41_000, BIGI], b).astype(np.int32)
        yield fields, cur0, limit, mf


def test_walk_plain_matches_jax_walks():
    """Randomized tables as in tests/test_blocked_spec.py, with caps that
    bind, against both the vectorized walk and the walk kernel."""
    names = ("keep", "attempted", "cur_f", "done", "pending")
    for fields, cur0, limit, mf in _tables(17):
        got = sd.spec_walk(torch.from_numpy(fields), torch.from_numpy(cur0),
                           torch.from_numpy(limit), mf)
        args = (jnp.asarray(fields), jnp.asarray(cur0), jnp.asarray(limit), mf)
        for want in (pd._spec_walk(*args), pd._spec_walk_smem(*args, interpret=True)):
            for name, g, w in zip(names, got, want):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w), (mf, name))
        np.testing.assert_array_equal(got.att.numpy(), got.attempted.numpy().sum(-1))
        assert got.keep.dtype == torch.bool and got.cur_f.dtype == torch.int32
        if mf <= 5:
            assert got.att.numpy().max() == mf       # the cap binds


def test_wrappers_check_devices():
    x = torch.zeros((1, 500))
    cand = torch.zeros((1, 4), dtype=torch.int32)
    one = torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError):
        sd.attempt_manchester(x, cand, one, one.to("meta"), SYNC, 1.0)
    with pytest.raises(ValueError):
        sd.decode_capture_spec(CFG, torch.zeros(500), 2)
    with pytest.raises(ValueError):
        sd.decode_capture_spec(CFG.replace(line_coding="4b5b", samples_per_level=4), x, 2)
    assert not sd.spec_supported_cfg(CFG.replace(samples_per_level=4))
    assert sd.spec_supported_cfg(CFG.replace(line_coding="4b5b"))
