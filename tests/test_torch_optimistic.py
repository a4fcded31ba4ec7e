"""The port's optimistic 4B5B mode against the JAX package's, on the CPU:
``core.bitops.crc8_bits`` against ``crc8_bits_matmul``,
``phy.line_coding.fourb5b_decode_opt`` against JAX's, and
``decode_capture(optimistic=True)`` and ``decode_capture_fast`` on the
cases of tests/test_fast_decode.py (a clean capture, a line failure that
trips the conformance flag, the same on a foreign frame, a mixed batch, a
seeded fuzz) and on chip_smoke.py's optimistic corpus (8 rows at
samples_per_level=4, which the speculative kernels do not cover).  The
corpora are encoded by the port's encoder and zero-padded to one length,
so each JAX function compiles once.

Tolerances: the conformant flags and every field of every slot are equal,
except the correlation, within atol 1e-5 (sum order)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from trackmaker_tpu.core import bitops as jbitops
from trackmaker_tpu.core.config import FOUR_B_FIVE_B
from trackmaker_tpu.core.config import PhyConfig as JaxPhyConfig
from trackmaker_tpu.phy import decoder as jdecoder
from trackmaker_tpu.phy import line_coding as jline
from trackmaker_tpu_torch import convert
from trackmaker_tpu_torch.core import bitops
from trackmaker_tpu_torch.core.framing import Frame
from trackmaker_tpu_torch.phy import decoder, line_coding
from trackmaker_tpu_torch.phy.encoder import PhyEncoder

JCFG = JaxPhyConfig(line_coding=FOUR_B_FIVE_B)
CFG = convert.phy_config_from_fields(dataclasses.asdict(JCFG))
T = 20480
MF = 16
LOCAL = 2


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _enc(cfg=CFG):
    enc = PhyEncoder(cfg, device="cpu")
    return lambda frame: enc.encode_frame(frame).numpy()


def _clean():
    enc, rng = _enc(), np.random.default_rng(0)
    parts = []
    for i in range(6):
        parts.append(rng.normal(0, 0.02, 500 + 200 * i).astype(np.float32))
        parts.append(enc(Frame.new_data(i, 1, 2, bytes([i]) * (3 + i))))
    return np.concatenate(parts + [np.zeros(2000, np.float32)])


def _line_fail(dst: int, payload: bytes, sym: int, tail: bytes):
    """A frame with the levels of symbol `sym` zeroed (an invalid symbol,
    the line fails there), a gap, then a frame to us."""
    enc = _enc()
    w1 = enc(Frame.new_data(1, 1, dst, payload)).copy()
    w1[CFG.preamble_len + sym * 15: CFG.preamble_len + (sym + 1) * 15] = 0.0
    return np.concatenate([w1, np.zeros(300, np.float32), enc(Frame.new_data(2, 1, 2, tail))])


def _mixed():
    """tests/test_fast_decode.py's batch: row 2 corrupted."""
    enc, waves = _enc(), []
    for b in range(4):
        parts = [np.zeros(137 * (b + 1), np.float32)]
        for i in range(3):
            parts.append(enc(Frame.new_data(10 * b + i, 1, 2, bytes([b]) * (4 + i))))
            parts.append(np.zeros(400, np.float32))
        w = np.pad(np.concatenate(parts), (0, 20000 - sum(len(p) for p in parts)))
        if b == 2:
            w[200 + CFG.preamble_len + 18 * 15: 200 + CFG.preamble_len + 19 * 15] = 0.0
            w[137 * 3: 137 * 3 + 60] = 0.0
        waves.append(w)
    return waves


def _fuzz(seed: int):
    enc, rng = _enc(), np.random.default_rng(100 + seed)
    parts = []
    for i in range(5):
        parts.append(rng.normal(0, 0.03, int(rng.integers(100, 2000))).astype(np.float32))
        parts.append(enc(Frame.new_data(i, 1, int(rng.integers(2, 4)), bytes(
            rng.integers(0, 256, rng.integers(1, 40), dtype=np.uint8)))))
    wave = np.concatenate(parts + [np.zeros(1500, np.float32)])
    for _ in range(int(rng.integers(0, 4))):
        p = int(rng.integers(0, len(wave) - 40))
        wave[p: p + int(rng.integers(5, 40))] = 0.0
    return wave


CASES = (["clean", "line_fail", "line_fail_foreign"] + [f"mixed_{b}" for b in range(4)]
         + [f"fuzz_{s}" for s in range(6)])


def _corpus():
    rows = [_clean(), _line_fail(2, b"0123456789abcdef", 20, b"recovered-after"),
            _line_fail(9, b"not-ours-corrupted", 22, b"mine"), *_mixed(),
            *(_fuzz(s) for s in range(6))]
    x = np.zeros((len(rows), T), np.float32)
    for r, row in enumerate(rows):
        x[r, :len(row)] = row
    return x, np.asarray([len(row) for row in rows], np.int32)


def _jax_runs(jcfg, x, vlens, mf):
    """JAX's optimistic and exact scans (vmapped) and its decode_capture_fast,
    which reuses both compiled functions."""
    xj, vj = jnp.asarray(x), jnp.asarray(vlens)
    opt, conformant = jdecoder._batched_fn(jcfg, mf, True)(xj, LOCAL, vj)
    exact = jdecoder._batched_fn(jcfg, mf, False)(xj, LOCAL, vj)
    fast = jdecoder.decode_capture_fast(jcfg, xj, LOCAL, mf, valid_len=vj)
    return opt, np.asarray(conformant), exact, fast


@pytest.fixture(scope="module")
def reference():
    x, vlens = _corpus()
    return x, vlens, _jax_runs(JCFG, x, vlens, MF)


def _assert_same_slots(got, want, row=None):
    pick = (lambda a: a) if row is None else (lambda a: a[row])
    for name in got._fields:
        g, w = getattr(got, name).numpy(), pick(np.asarray(getattr(want, name)))
        if name == "corr":
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)
        else:
            np.testing.assert_array_equal(g, w, name)


# --- the building blocks -------------------------------------------------------


def test_crc8_bits_matches_crc8_bits_matmul():
    rng = np.random.default_rng(3)
    n = CFG.max_frame_bytes
    lengths = np.asarray([0, 1, n] + rng.integers(2, n, 13).tolist(), np.int32)
    bits = rng.integers(0, 2, (len(lengths), n * 8), dtype=np.uint8)
    bits[np.arange(n * 8)[None] >= 8 * lengths[:, None]] = 0   # zero past the length
    want = np.asarray(jax.vmap(jbitops.crc8_bits_matmul)(jnp.asarray(bits),
                                                         jnp.asarray(lengths)))
    got = bitops.crc8_bits(torch.from_numpy(bits), torch.from_numpy(lengths))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.uint8
    one = bitops.crc8_bits(torch.from_numpy(bits[5]), int(lengths[5]))
    assert int(one) == int(want[5])


@pytest.mark.parametrize("spl", [2, 3, 4])
def test_fourb5b_decode_opt_matches_jax(spl):
    """Random levels (invalid symbols among them) with levels near zero:
    exactly 0, +-1e-7, +-2e-6 and a tiny mean of opposite signs."""
    rng = np.random.default_rng(spl)
    n_lvl = 5 * 97
    levels = rng.choice([-1.0, 1.0], (4, n_lvl)).astype(np.float32)
    levels[0, ::7] = 0.0
    levels[1, ::11] = np.float32(1e-7)
    levels[2, ::13] = np.float32(-2e-6)
    x = np.repeat(levels, spl, axis=-1) + rng.normal(0, 0.2, (4, n_lvl * spl)).astype(np.float32)
    x[3, : 5 * spl] = np.asarray([3e-7, -3e-7, 1e-7] * 5 * spl, np.float32)[: 5 * spl]
    x = np.concatenate([x, np.ones((4, spl - 1), np.float32)], axis=-1)   # a partial level
    want = [np.asarray(a) for a in jline.fourb5b_decode_opt(jnp.asarray(x), spl)]
    got = line_coding.fourb5b_decode_opt(torch.from_numpy(x), spl)
    for name, g, w in zip(("bits", "bit_ok", "near0"), got, want):
        np.testing.assert_array_equal(g.numpy(), w, name)
    assert want[2].any() and not want[1].all()
    # the exact decode's levels are the same means
    bits, ok = line_coding.fourb5b_decode(torch.from_numpy(x), spl)
    jb, jo = jline.fourb5b_decode(jnp.asarray(x), spl)
    np.testing.assert_array_equal(bits.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jo))


# --- the optimistic scan --------------------------------------------------------


@pytest.mark.parametrize("case", CASES)
def test_optimistic_scan_matches_jax(reference, case):
    x, vlens, (opt, conformant, _, _) = reference
    r = CASES.index(case)
    got, ok = decoder.decode_capture(CFG, torch.from_numpy(x[r]), LOCAL, MF,
                                     valid_len=int(vlens[r]), optimistic=True)
    assert ok is bool(conformant[r])
    _assert_same_slots(got, opt, r)


def test_conformance_flags(reference):
    """The clean row is conformant; the line failures (to us and to
    another address) are not."""
    conformant = reference[2][1]
    flags = dict(zip(CASES, conformant.tolist()))
    assert flags["clean"] and not flags["line_fail"] and not flags["line_fail_foreign"]


def _row_frames(res, r: int) -> list:
    """Row r's valid frames in slot order: (bytes, length, type, sequence,
    src, dst, start)."""
    cols = {f: np.asarray(getattr(res, f))[r] for f in res._fields}
    return [(cols["frame_bytes"][k, :7 + int(cols["length"][k])].tobytes(),
             *(int(cols[f][k]) for f in ("length", "frame_type", "sequence", "src", "dst",
                                          "start")))
            for k in np.nonzero(cols["valid"])[0]]


def test_decode_capture_fast_matches_jax(reference):
    """The port's fast decode of the batch equals JAX's (its optimistic
    scan, the exact scan for the rows that are not conformant) frame for
    frame: at samples_per_level=3 the port takes the speculative decode,
    which keeps the frames in the leading slots."""
    x, vlens, (_, conformant, exact, fast) = reference
    got = decoder.decode_capture_fast(CFG, torch.from_numpy(x), LOCAL, MF, valid_len=vlens)
    for r in range(x.shape[0]):
        assert _row_frames(got, r) == _row_frames(fast, r) == _row_frames(exact, r), CASES[r]
    assert not conformant.all()


def test_optimistic_asserts():
    with pytest.raises(AssertionError):
        decoder.decode_capture(CFG.replace(line_coding="manchester"), torch.zeros(500), 2,
                               optimistic=True)
    with pytest.raises(AssertionError):
        decoder.decode_capture(CFG, torch.zeros(500), 2, optimistic=True, with_cursor=True)


def test_chip_smoke_optimistic_corpus():
    """chip_smoke.py's optimistic batch (samples_per_level=4, two rows with
    an invalid symbol in a frame): the port's optimistic scan and fast
    decode equal JAX's slot for slot, and OPTIMISTIC_EXPECT is JAX's digest
    of them."""
    frames, x, vlens = chip_smoke.optimistic_input()
    cfg = CFG.replace(samples_per_level=chip_smoke.OPT_SPL)
    jcfg = JCFG.replace(samples_per_level=chip_smoke.OPT_SPL)
    mf = chip_smoke.OPT_MAX_FRAMES
    opt, conformant, _, fast = _jax_runs(jcfg, x, vlens, mf)
    xt = torch.from_numpy(x)
    rows = [decoder.decode_capture(cfg, xt[r], LOCAL, mf, valid_len=int(vlens[r]),
                                   optimistic=True) for r in range(x.shape[0])]
    assert [ok for _, ok in rows] == conformant.tolist()
    for r, (res, _) in enumerate(rows):
        _assert_same_slots(res, opt, r)
    got = decoder.decode_capture_fast(cfg, xt, LOCAL, mf, valid_len=vlens)
    _assert_same_slots(got, fast)
    jax_np = {name: np.asarray(getattr(fast, name)) for name in chip_smoke.DIGEST_FIELDS}
    jax_opt = {name: np.asarray(getattr(opt, name)) for name in chip_smoke.DIGEST_FIELDS}
    assert chip_smoke.optimistic_digest(conformant, jax_opt, jax_np) == \
        chip_smoke.OPTIMISTIC_EXPECT
    assert conformant.tolist().count(False) == len(chip_smoke.OPT_BROKEN_ROWS)
    for r in range(x.shape[0]):
        if r not in chip_smoke.OPT_BROKEN_ROWS:
            assert [f.data for f in got.to_frames(r)] == [f.data for f in frames]
