"""The port's 4B5B speculative decode (trackmaker_tpu_torch.phy.spec_decode
with the attempt kernel's plain version) against the JAX package's
(trackmaker_tpu/phy/pallas_decode.py, Pallas kernels in interpret mode) and
its exact scan, on the CPU.  The scenarios are the four 4B5B ones of
tests/test_pallas_decode.py plus a noisy row.  The JAX references run once
per module.

Tolerances: candidate tables, the attempt's frame starts, valid-prefix
bytes, first invalid and first near-zero symbols, the walk fields, the
``nonconf`` and ``ok`` flags, cursors and the valid-masked frames are
exactly equal; the correlation at each frame agrees within atol 1e-5 (sum
order).  The exact equality of the attempt rests on two properties of the
corpus, which the attempt test asserts: no level sum lies within 1e-7 of
+-4e-6 (the near-zero bound) or, unless exactly 0, of 0 (where a sign
could flip), and no two refine positions of a slot score within 1e-6 of
the best (where the first maximum could move), since the JAX kernel sums
in another order."""

import dataclasses
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from trackmaker_tpu.core.config import FOUR_B_FIVE_B
from trackmaker_tpu.core.config import PhyConfig as JaxPhyConfig
from trackmaker_tpu.phy import decoder as jdecoder
from trackmaker_tpu.phy import pallas_decode as pd
from trackmaker_tpu.phy.line_coding import preamble_waveform as jax_preamble
from trackmaker_tpu_torch import _build, convert
from trackmaker_tpu_torch.core import bitops
from trackmaker_tpu_torch.core.framing import Frame
from trackmaker_tpu_torch.phy import decoder, line_coding
from trackmaker_tpu_torch.phy import spec_decode as sd
from trackmaker_tpu_torch.phy.encoder import PhyEncoder
from trackmaker_tpu_torch.sync.correlate import preamble_energy
from trackmaker_tpu_torch.sync.xcorr_hits import xcorr_hits

JCFG = JaxPhyConfig(line_coding=FOUR_B_FIVE_B)
CFG = convert.phy_config_from_fields(dataclasses.asdict(JCFG))
PRE = jax_preamble(JCFG)
SYNC = PRE[30:]
N_CAND = 64
BIGI = 2**30
T = 4864


def _raw(data, seq=0, src=1, dst=2, ftype=1):
    n = len(data)
    return bytes([n >> 8, n & 0xFF, bitops.crc8_host(data), ftype,
                  seq, src, dst]) + data


def _scenarios() -> dict[str, tuple[np.ndarray, int]]:
    """name -> (capture, valid length)."""
    enc = PhyEncoder(CFG, device="cpu")
    pre = CFG.preamble_len

    def frame(seq, dst, data):
        return enc.encode_frame(Frame.new_data(seq, 1, dst, data)).numpy().copy()

    def zeros(n):
        return np.zeros(n, np.float32)

    rng = np.random.default_rng(1)
    crc_bad = frame(3, 2, b"badcrc")
    sym = (7 * 8 + 3) // 4        # one inverted symbol: an invalid code
    crc_bad[pre + sym * 15: pre + sym * 15 + 15] *= -1.0
    zeroed = frame(1, 2, b"zeroed-levels")
    zeroed[pre + 20 * 15 + 3: pre + 20 * 15 + 6] = 0.0
    evil = Frame.new_data(1, 1, 2, bytes([0x33, 0x5A]) + _raw(b"EV", seq=99))
    hdr_cut = frame(2, 2, b"hdrcut")
    hdr_cut[pre + 12 * 15: pre + 13 * 15] *= -1.0
    six = enc.encode_frames([Frame.new_data(i, 1, 2, bytes([i]) * 5) for i in range(6)],
                            gap_samples=250).numpy()
    noisy = []
    for i in range(3):
        noisy += [zeros(150), frame(10 + i, 2, rng.integers(0, 256, 20 + 15 * i,
                                                         dtype=np.uint8).tobytes())]
    noisy = np.concatenate(noisy + [zeros(300)])
    noisy = noisy + rng.normal(0, 0.05, len(noisy)).astype(np.float32)
    caps = {
        "basic_failures": np.concatenate([
            rng.normal(0, 0.03, 400).astype(np.float32), frame(1, 2, b"first"), zeros(300),
            frame(2, 9, b"foreign"), zeros(300), crc_bad, zeros(300), frame(4, 2, b"last"),
            zeros(600)]),
        "zero_levels": np.concatenate([zeroed, zeros(500)]),
        "zero_clean": np.concatenate([frame(2, 2, b"clean"), zeros(4000)]),
        "evil_partial": np.concatenate([
            zeros(200), enc.encode_frame(evil).numpy(), zeros(400), hdr_cut, zeros(400),
            frame(5, 2, b"tail"), zeros(500)]),
        "max_frames": six,
        "noisy": noisy,
    }
    out = {name: (c, len(c)) for name, c in caps.items()}
    out["incomplete"] = (np.concatenate([six, zeros(200)]), len(six) - 30)
    return out


def _batch():
    scen = _scenarios()
    names = list(scen)
    x = np.zeros((len(names), T), np.float32)
    vlen = np.zeros(len(names), np.int32)
    for r, name in enumerate(names):
        cap, n = scen[name]
        assert len(cap) <= T, name
        x[r, :len(cap)] = cap
        vlen[r] = n
    return names, x, vlen


RUNS = [(2, 16), (-1, 16), (2, 3)]       # (local address, max_frames)


@jax.jit
def _jax_exact(x, vlens):
    return jax.vmap(lambda s, v: jdecoder.decode_capture(JCFG, s, 2, 16, valid_len=v))(x, vlens)


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
    a = jax.tree_util.tree_map(np.asarray, phase_a(jnp.asarray(x), 2, jnp.asarray(vlen)))
    exact = jax.tree_util.tree_map(np.asarray, _jax_exact(jnp.asarray(x), jnp.asarray(vlen)))
    return names, x, vlen, out, a, exact


def _frames(res, row):
    """Valid-masked frames of one row in slot order."""
    f = {k: np.asarray(v)[row] for k, v in res._asdict().items()}
    return [(f["frame_bytes"][k, :7 + int(f["length"][k])].tobytes(),
             *(int(f[n][k]) for n in ("length", "frame_type", "sequence", "src",
                                      "dst", "start")))
            for k in np.nonzero(f["valid"])[0]]


@pytest.mark.parametrize("local,mf", RUNS)
def test_decode_capture_spec_4b5b_matches_jax(jax_runs, local, mf):
    names, x, vlen, out, _, _ = jax_runs
    want, want_ok, want_searched, want_cur = out[local, mf]
    res, ok, searched, cur = sd.decode_capture_spec(
        CFG, torch.from_numpy(x), local, max_frames=mf, n_cand=N_CAND,
        valid_len=torch.from_numpy(vlen), with_cursor=True)
    np.testing.assert_array_equal(ok.numpy(), want_ok)
    np.testing.assert_array_equal(searched.numpy(), want_searched)
    np.testing.assert_array_equal(cur.numpy(), want_cur)
    for r, name in enumerate(names):
        assert _frames(res, r) == _frames(want, r), name
        got_corr = res.corr.numpy()[r][res.valid.numpy()[r]]
        np.testing.assert_allclose(got_corr, want.corr[r][want.valid[r]], atol=1e-5)


def test_scenario_outcomes_4b5b(jax_runs):
    """The scenarios' own expectations (tests/test_pallas_decode.py), on the
    port's results."""
    names, x, vlen, _, _, _ = jax_runs
    seqs, oks = {}, {}
    for local, mf in RUNS:
        res, ok = sd.decode_capture_spec(CFG, torch.from_numpy(x), local, max_frames=mf,
                                         n_cand=N_CAND, valid_len=torch.from_numpy(vlen))
        for r, name in enumerate(names):
            seqs[name, local, mf] = [f[3] for f in _frames(res, r)]
            oks[name, local, mf] = bool(ok[r])
    assert seqs["basic_failures", 2, 16] == [1, 4]
    assert seqs["basic_failures", -1, 16] == [1, 2, 4]
    assert not oks["zero_levels", 2, 16]       # the exact scan must redo it
    assert oks["zero_clean", 2, 16]            # zeros outside attempted frames do not
    assert 99 not in seqs["evil_partial", 2, 16] and seqs["evil_partial", 2, 16][-1] == 5
    assert seqs["max_frames", 2, 3] == [0, 1, 2]
    assert seqs["max_frames", 2, 16] == [0, 1, 2, 3, 4, 5]
    assert seqs["incomplete", 2, 16] == [0, 1, 2, 3, 4]
    assert seqs["noisy", 2, 16] == [10, 11, 12]
    assert all(ok for (name, _, _), ok in oks.items() if name != "zero_levels")


def test_spec_phase_a_4b5b_matches_jax(jax_runs):
    names, x, vlen, _, want, _ = jax_runs
    a = sd.spec_phase_a(CFG, torch.from_numpy(x), 2, N_CAND, torch.from_numpy(vlen))
    np.testing.assert_array_equal(a.cand.numpy(), want.cand)
    np.testing.assert_array_equal(a.overflow.numpy(), want.overflow)
    live = want.cand < BIGI
    assert live.sum() >= 20
    # slots past n_valid are never attempted; the JAX kernel leaves them unwritten
    for key in ("nonconf", "bytes_m", "dlen", "ftype", "seq", "src", "dst"):
        np.testing.assert_array_equal(getattr(a, key).numpy()[live],
                                      np.asarray(getattr(want, key))[live], key)
    np.testing.assert_array_equal(a.fields.numpy().transpose(0, 2, 1)[live],
                                  want.fields.transpose(0, 2, 1)[live])
    np.testing.assert_allclose(a.corr.numpy(), want.corr, atol=1e-5)
    assert a.nonconf.numpy()[names.index("zero_levels")].any()
    # kept candidates and failed ones both occur
    stop, keep = a.fields.numpy()[:, 2], a.fields.numpy()[:, 3]
    assert keep[live].sum() >= 10 and ((keep == 0) & (stop == 0))[live].sum() >= 3


# --- the attempt kernel ---------------------------------------------------------


def _jax_attempt_raw(x, cand, n_valid, vlen):
    """The JAX 4B5B attempt kernel's own output, launched as _spec_phase_a
    launches it (interpret mode), read out as the port's four fields."""
    b, t = x.shape
    t8, sync_e = pd._sync_tables(tuple(SYNC.tolist()), 31)
    r384 = -(-(t + 48) // pd.DROW) + pd.NR4 + 10
    x384 = jnp.pad(jnp.asarray(x), ((0, 0), (0, r384 * pd.DROW - t))).reshape(
        b, r384, pd.DROW)
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=4, grid=(b,),
        in_specs=[pl.BlockSpec(memory_space=pltpu.HBM)]
        + [pl.BlockSpec(memory_space=pltpu.VMEM)] * 3,
        out_specs=pl.BlockSpec((1, N_CAND, pd.BROWS4, 128),
                               lambda bb, *_: (bb, 0, 0, 0), memory_space=pltpu.VMEM),
        scratch_shapes=[pltpu.VMEM((pd.ATTEMPT_PIPE, pd.NR4, pd.DROW), jnp.float32),
                        pltpu.SemaphoreType.DMA((pd.ATTEMPT_PIPE,))])
    out = pl.pallas_call(
        functools.partial(pd._attempt_kernel_4b5b, n_cand=N_CAND, t_max=t, sync_e=sync_e),
        out_shape=jax.ShapeDtypeStruct((b, N_CAND, pd.BROWS4, 128), jnp.float32),
        grid_spec=grid_spec, interpret=True,
    )(jnp.asarray(cand), jnp.zeros_like(jnp.asarray(cand)), jnp.asarray(vlen),
      jnp.asarray(n_valid), x384, jnp.asarray(t8), jnp.asarray(pd._level_mats_cat()),
      jnp.asarray(pd._sym_mats_256()))
    out = np.nan_to_num(np.asarray(out))      # slots past n_valid are unwritten
    # rows 0-5 nibbles, 6-11 symbol ok, 12-17 near-zero counts (128 symbols
    # a row), row 18 lane 0 the refine delta fs - min(cand, t)
    nib = out[:, :, 0:6].reshape(b, N_CAND, 768).astype(np.int32)
    ok = out[:, :, 6:12].reshape(b, N_CAND, 768) > 0
    zero = out[:, :, 12:18].reshape(b, N_CAND, 768) > 0

    def first(flag, n):
        return np.where(flag[..., :n].any(-1), flag[..., :n].argmax(-1), n).astype(np.int32)

    first_bad = first(~ok, sd.FRAME_SYMBOLS)
    first_zero = first(zero, sd.ZERO_SYMBOLS)
    nib = np.where(np.arange(sd.FRAME_SYMBOLS) < first_bad[..., None],
                   nib[..., :sd.FRAME_SYMBOLS], 0)
    byts = (nib[..., 0::2] * 16 + nib[..., 1::2]).astype(np.uint8)
    fs = np.minimum(cand, t) + out[:, :, 18, 0].astype(np.int32)
    return byts, fs, first_bad, first_zero


def _refine_scores(x, cand, vlen):
    """float64 refine scores f64[B, C, 31] (-inf where cut by vlen)."""
    b, t = x.shape
    xz = np.concatenate([x.astype(np.float64), np.zeros((b, 64))], axis=1)
    base = np.minimum(cand, t)[..., None] + 15 + np.arange(31)
    idx = np.minimum(base[..., None] + np.arange(30), t)
    win = np.take_along_axis(xz, idx.reshape(b, -1), 1).reshape(idx.shape)
    en = (win * win).sum(-1)
    cc = np.where(en > 1e-6, (win @ SYNC.astype(np.float64))
                  / (np.sqrt(np.maximum(en, 1e-30)) * np.sqrt(30.0)), 0.0)
    return np.where(base <= vlen[:, None, None] - 30, cc, -np.inf)


def _levels(x, fs):
    """The f32 level sums of the 640 symbols from each frame start."""
    b, t = x.shape
    xz = np.concatenate([x, np.zeros((b, 1), np.float32)], axis=1)
    idx = np.minimum(fs[..., None] + np.arange(sd.ZERO_SYMBOLS * 15), t)
    w = np.take_along_axis(xz, idx.reshape(b, -1), 1).reshape(*fs.shape, -1, 3)
    return (w[..., 0] + w[..., 1]) + w[..., 2]


def _check_attempt(x, cand, n_valid, vlen):
    xt = torch.from_numpy(x)
    got = sd.attempt_4b5b(xt, torch.from_numpy(cand), torch.from_numpy(n_valid),
                          torch.from_numpy(vlen), SYNC, preamble_energy(SYNC))
    assert [g.dtype for g in got] == [torch.uint8] + [torch.int32] * 3
    want = _jax_attempt_raw(x, cand, n_valid, vlen)
    live = np.arange(N_CAND)[None] < np.minimum(n_valid, N_CAND)[:, None]
    for name, g, w in zip(("bytes", "fs", "first_bad", "first_zero"), got, want):
        np.testing.assert_array_equal(g.numpy()[live], w[live], name)
        assert np.all(g.numpy()[~live] == 0), name
    return [g.numpy() for g in got], live


def test_attempt_4b5b_plain_matches_jax_kernel(jax_runs):
    names, x, vlen, _, _, _ = jax_runs
    _, rows = xcorr_hits(torch.from_numpy(x), PRE, CFG.correlation_threshold)
    cand, _, n_valid, _ = sd.compact_hit_rows(rows, N_CAND)
    cand, n_valid = cand.numpy(), n_valid.numpy()
    (byts, fs, first_bad, first_zero), live = _check_attempt(x, cand, n_valid, vlen)
    assert live.sum() >= 20
    assert (first_bad[live] < sd.FRAME_SYMBOLS).any() and (first_zero[live] < sd.FRAME_SYMBOLS).any()

    # the corpus keeps clear of the values where a sum order could decide
    lv = np.abs(_levels(x, fs)[live])
    assert not np.any((lv > 0) & (lv < 1e-7))
    assert not np.any(np.abs(lv - sd.LEVEL_NEAR_ZERO) < 1e-7)
    cc = np.sort(_refine_scores(x, cand, vlen)[live], axis=-1)
    top, second = cc[:, -1], cc[:, -2]
    assert np.all((top - second > 1e-6) | ((top == 0) & (second == 0)))


def test_attempt_4b5b_refine_edges():
    """Candidates whose refine windows run past the valid length or the
    capture's end, or lie in silence, and whose symbols read past T."""
    rng = np.random.default_rng(23)
    x = rng.normal(0, 0.3, (2, 900)).astype(np.float32)
    x[1, 400:] = 0.0
    cand = np.array([[0, 500, 780, 860] + [BIGI] * (N_CAND - 4),
                     [10, 300, 520, 604] + [BIGI] * (N_CAND - 4)], np.int32)
    n_valid = np.array([4, 3], np.int32)
    vlen = np.array([840, 900], np.int32)
    (byts, fs, first_bad, first_zero), _ = _check_attempt(x, cand, n_valid, vlen)
    # no refine position left before the valid length: fall back to i + 60
    assert fs[0, 3] == 860 + 60
    # silence scores 0 at every position, and the first position wins
    assert fs[1, 2] == 520 + 15 + 30
    # levels past the capture's end are zero, hence near zero
    assert first_zero[0, 2] <= (900 - fs[0, 2]) // 15 + 1
    assert fs[0, 3] >= 900 and first_zero[0, 3] == 0 and first_bad[0, 3] == 0
    assert np.all(fs[1, 3:] == 0) and np.all(byts[1, 3:] == 0)


def test_kernel_source_agrees_with_the_module():
    """The constants and the 4B5B inverse table that csrc/attempt_4b5b.cu
    compiles in are the module's."""
    src = (_build.CSRC / "attempt_4b5b.cu").read_text()

    def const(name):
        return re.search(rf"constexpr \w+ {name} = ([^;]+);", src).group(1)

    assert int(const("kSymbols")) == sd.ZERO_SYMBOLS
    assert int(const("kFrameSymbols")) == sd.FRAME_SYMBOLS
    assert int(const("kSyncLen")) == sd.SYNC_LEN_4B5B
    assert int(const("kPositions")) == sd.SYNC_POSITIONS_4B5B
    assert float(const("kNearZero").rstrip("f")) == sd.LEVEL_NEAR_ZERO
    table = re.search(r"kDecode\[32\] = \{([^}]+)\}", src).group(1)
    assert [int(v) for v in table.split(",")] == line_coding.FOURB_FIVEB_DECODE.tolist()


# --- the whole slice ------------------------------------------------------------


def test_decode_capture_fast_4b5b_matches_the_exact_scan(jax_runs):
    """The zero-level row is not ok and takes the exact scan's result;
    every row equals the JAX exact scan frame for frame."""
    names, x, vlen, _, _, exact = jax_runs
    xt = torch.from_numpy(x)
    _, ok = sd.decode_capture_spec(CFG, xt, 2, max_frames=16, n_cand=N_CAND,
                                   valid_len=torch.from_numpy(vlen))
    assert ok.tolist() == [name != "zero_levels" for name in names]
    got = decoder.decode_capture_fast(CFG, xt, 2, max_frames=16, valid_len=vlen.tolist())
    for r, name in enumerate(names):
        assert _frames(got, r) == _frames(exact, r), name
    r = names.index("zero_levels")
    for name, g, w in zip(got._fields, got, exact):
        if name == "corr":
            np.testing.assert_allclose(g[r].numpy(), w[r], atol=1e-5)
        else:
            np.testing.assert_array_equal(g[r].numpy(), w[r], name)
    one = decoder.decode_capture_fast(CFG, xt[0], 2, max_frames=16, valid_len=int(vlen[0]))
    assert one.valid.shape == (16,) and int(one.count) == 2


def test_long_length_fields_search_640_symbols_for_zeros():
    """A header whose length runs past the largest frame (len_bad, one
    sample consumed) is still attempted, and its near-zero search covers
    640 symbols, as the JAX epilogue's does: a zero level at symbol 600
    makes the row not ok, none there keeps it ok."""
    rng = np.random.default_rng(29)
    payload = rng.integers(0, 256, 300, dtype=np.uint8).tobytes()
    raw = _raw(payload)                      # length 300 > max_frame_bytes
    bits = torch.from_numpy(bitops.bytes_to_bits_host(raw))
    wave = np.concatenate([PRE, line_coding.fourb5b_encode(bits, 3).numpy()])
    x = np.zeros((2, 10240), np.float32)
    x[:, 100:100 + len(wave)] = wave
    fs = 100 + CFG.preamble_len
    x[1, fs + 600 * 15 + 6: fs + 600 * 15 + 9] = 0.0
    res, ok = sd.decode_capture_spec(CFG, torch.from_numpy(x), 2, max_frames=4, n_cand=16)
    want, want_ok = pd.decode_capture_spec_jit(JCFG, jnp.asarray(x), 2, max_frames=4,
                                               n_cand=16, interpret=True)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(want_ok))
    assert ok.tolist() == [True, False]
    a = sd.spec_phase_a(CFG, torch.from_numpy(x), 2, 16, torch.full((2,), 10240, dtype=torch.int32))
    assert a.dlen[:, 0].tolist() == [300, 300] and a.nonconf[:, 0].tolist() == [False, True]
    assert res.count.tolist() == [0, 0]
