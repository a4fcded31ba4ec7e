"""The port's exact scan and fast decode (trackmaker_tpu_torch.phy.decoder)
against the JAX package's exact scan (trackmaker_tpu/phy/decoder.py), on
the CPU, for the Manchester and the 4B5B line codes.  The JAX references
run once per module.

Tolerances: every field of every slot is equal, except the correlation,
which agrees within atol 1e-5 (sum order)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trackmaker_tpu.core.config import FOUR_B_FIVE_B
from trackmaker_tpu.core.config import PhyConfig as JaxPhyConfig
from trackmaker_tpu.phy import decoder as jdecoder
from trackmaker_tpu.phy.line_coding import preamble_waveform as jax_preamble
from trackmaker_tpu_torch import convert
from trackmaker_tpu_torch.core.framing import Frame
from trackmaker_tpu_torch.phy import decoder, spec_decode
from trackmaker_tpu_torch.phy.encoder import PhyEncoder

JCFG = JaxPhyConfig()
CFG = convert.phy_config_from_fields(dataclasses.asdict(JCFG))
PRE = jax_preamble(JCFG)
T = 8192
MF = 12


def _captures():
    """Rows: frames in noise; a CRC failure and a foreign frame; a frame
    cut by the valid length; 40 back-to-back preambles (which overflow the
    speculative candidate table) before two frames; silence."""
    rng = np.random.default_rng(31)
    enc = PhyEncoder(CFG, device="cpu")

    def frame(seq, dst, n):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        return enc.encode_frame(Frame.new_data(seq, 1, dst, data)).numpy()

    rows, vlens = [], []
    parts = []
    for i in range(4):
        parts += [rng.normal(0, 0.05, 150 + 97 * i).astype(np.float32), frame(i, 2, 5 + 9 * i)]
    rows.append(np.concatenate(parts))
    bad = frame(1, 2, 12).copy()
    bad[96 + 60 * 6: 96 + 61 * 6] *= -1.0
    rows.append(np.concatenate([frame(0, 7, 9), np.zeros(200, np.float32), bad,
                                np.zeros(200, np.float32), frame(2, 2, 30)]))
    cut = np.concatenate([np.zeros(300, np.float32), frame(5, 2, 40)])
    rows.append(cut)
    rows.append(np.concatenate([np.tile(PRE, 40), np.zeros(400, np.float32),
                                frame(6, 2, 8), np.zeros(300, np.float32), frame(7, 2, 3)]))
    rows.append(np.zeros(1000, np.float32))
    x = np.zeros((len(rows), T), np.float32)
    for r, row in enumerate(rows):
        x[r, :len(row)] = row
        vlens.append(len(row))
    vlens[2] -= 100
    return x, np.asarray(vlens, np.int32)


@jax.jit
def _jax_exact(x, vlens, local, c0, lim):
    """vmapped JAX exact scan with cursors: (frames, searched, final cursor)."""
    def one(s, v, c, m):
        return jdecoder.decode_capture(JCFG, s, local, MF, valid_len=v, with_cursor=True,
                                       start_cursor=c, scan_limit=m)
    return jax.vmap(one)(x, vlens, c0, lim)


@pytest.fixture(scope="module")
def reference():
    x, vlens = _captures()
    b = x.shape[0]
    runs = {}
    for local in (2, -1):
        for c0, lim in ((0, 2**30), (700, 3000)):
            res, searched, cur = _jax_exact(
                jnp.asarray(x), jnp.asarray(vlens), local, jnp.full(b, c0, jnp.int32),
                jnp.full(b, lim, jnp.int32))
            runs[local, c0, lim] = (jax.tree_util.tree_map(np.asarray, res),
                                    np.asarray(searched), np.asarray(cur))
    return x, vlens, runs


def _assert_same_slots(got, want, row=None):
    pick = (lambda a: a) if row is None else (lambda a: a[row])
    for name in got._fields:
        g, w = getattr(got, name).numpy(), pick(np.asarray(getattr(want, name)))
        if name == "corr":
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)
        else:
            np.testing.assert_array_equal(g, w, name)


@pytest.mark.parametrize("local,c0,lim", [(2, 0, 2**30), (-1, 0, 2**30), (2, 700, 3000)])
def test_exact_scan_matches_jax(reference, local, c0, lim):
    x, vlens, runs = reference
    want, want_searched, want_cur = runs[local, c0, lim]
    for r in range(x.shape[0]):
        got, searched, cur = decoder.decode_capture(
            CFG, torch.from_numpy(x[r]), local, MF, valid_len=int(vlens[r]),
            with_cursor=True, start_cursor=c0, scan_limit=lim)
        _assert_same_slots(got, want, r)
        assert (searched, cur) == (int(want_searched[r]), int(want_cur[r])), r
    frames0 = decoder.decode_capture(CFG, torch.from_numpy(x[0]), local, MF,
                                     start_cursor=c0, scan_limit=lim)
    assert int(frames0.count) == int(want.valid[0].sum())


def test_exact_scan_outcomes(reference):
    x, vlens, runs = reference
    want = runs[2, 0, 2**30][0]
    got = decoder.decode_captures(CFG, torch.from_numpy(x), 2, MF, vlens.tolist())
    _assert_same_slots(got, want)
    assert got.count.tolist() == [4, 1, 0, 2, 0]
    assert [f.sequence for f in got.to_frames(row=0)] == [0, 1, 2, 3]
    assert [f.sequence for f in got.to_frames(row=3)] == [6, 7]


def test_decode_capture_fast_merges_the_fallback_row(reference):
    """The row of back-to-back preambles overflows the speculative table
    and takes the exact scan's result; every row equals the JAX exact scan
    frame for frame."""
    x, vlens, runs = reference
    want = runs[2, 0, 2**30][0]
    xt = torch.from_numpy(x)
    _, ok = spec_decode.decode_capture_spec(CFG, xt, 2, max_frames=MF,
                                            valid_len=torch.from_numpy(vlens))
    assert ok.tolist() == [True, True, True, False, True]
    got = decoder.decode_capture_fast(CFG, xt, 2, max_frames=MF, valid_len=vlens.tolist())
    for r in range(x.shape[0]):
        valid = got.valid[r].numpy()
        wvalid = want.valid[r]
        for name in ("frame_bytes", "length", "frame_type", "sequence", "src", "dst", "start"):
            np.testing.assert_array_equal(getattr(got, name)[r].numpy()[valid],
                                          getattr(want, name)[r][wvalid], (r, name))
        np.testing.assert_allclose(got.corr[r].numpy()[valid], want.corr[r][wvalid],
                                   rtol=0, atol=1e-5)
    merged = decoder.DecodedFrames(*(f[3] for f in got))
    _assert_same_slots(merged, want, 3)
    one = decoder.decode_capture_fast(CFG, xt[0], 2, max_frames=MF, valid_len=int(vlens[0]))
    assert one.valid.shape == (MF,) and int(one.count) == 4


def test_short_capture_and_unsupported_configs():
    res = decoder.decode_capture(CFG, torch.zeros(50), 2, 4)
    want = jdecoder.decode_capture(JCFG, jnp.zeros(50), 2, 4)
    _assert_same_slots(res, want)
    with pytest.raises(ValueError):
        decoder.decode_capture_fast(CFG.replace(line_coding="nrz"), torch.zeros(500), 2)
    with pytest.raises(ValueError):
        decoder.decode_capture(CFG, torch.zeros((2, 500)), 2)


def test_exact_scan_at_another_samples_per_level():
    """A configuration the speculative kernels do not cover runs the exact
    scan for every row."""
    jcfg = JCFG.replace(samples_per_level=2)
    cfg = CFG.replace(samples_per_level=2)
    enc = PhyEncoder(cfg, device="cpu")
    wave = enc.encode_frames([Frame.new_data(i, 1, 2, bytes([i]) * 6) for i in range(3)],
                             gap_samples=120).numpy()
    x = np.concatenate([np.zeros(80, np.float32), wave, np.zeros(200, np.float32)])
    got = decoder.decode_capture_fast(cfg, torch.from_numpy(x[None]), 2, max_frames=6)
    want = jdecoder.decode_capture(jcfg, jnp.asarray(x), 2, 6)
    _assert_same_slots(decoder.DecodedFrames(*(f[0] for f in got)), want)
    assert int(got.count[0]) == 3


# --- 4B5B ---------------------------------------------------------------------

JCFG4 = JCFG.replace(line_coding=FOUR_B_FIVE_B)
CFG4 = CFG.replace(line_coding=FOUR_B_FIVE_B)


def _captures_4b5b():
    """Rows: frames in noise; a foreign frame, a frame with an inverted
    symbol in its payload (the line fails there) and one in its header
    (fewer than 49 header bits); a frame with zeroed levels (the receiver
    skips them, and the frame fails) and a frame cut by the valid length;
    silence."""
    rng = np.random.default_rng(41)
    enc = PhyEncoder(CFG4, device="cpu")
    pre = CFG4.preamble_len

    def frame(seq, dst, n):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        return enc.encode_frame(Frame.new_data(seq, 1, dst, data)).numpy()

    def gap(n):
        return np.zeros(n, np.float32)

    noisy = []
    for i in range(4):
        noisy += [rng.normal(0, 0.05, 120 + 83 * i).astype(np.float32), frame(i, 2, 6 + 11 * i)]
    body_bad = frame(2, 2, 20).copy()
    body_bad[pre + 30 * 15: pre + 31 * 15] *= -1.0
    hdr_bad = frame(3, 2, 9).copy()
    hdr_bad[pre + 12 * 15: pre + 13 * 15] *= -1.0
    zeroed = frame(5, 2, 16).copy()
    zeroed[pre + 20 * 15 + 3: pre + 20 * 15 + 6] = 0.0
    rows = [np.concatenate(noisy),
            np.concatenate([frame(1, 7, 8), gap(200), body_bad, gap(200), hdr_bad, gap(200),
                            frame(4, 2, 12)]),
            np.concatenate([gap(150), zeroed, gap(250), frame(6, 2, 30), gap(100)]),
            np.concatenate([gap(300), frame(7, 2, 40)]),
            gap(900)]
    x = np.zeros((len(rows), T), np.float32)
    vlens = []
    for r, row in enumerate(rows):
        x[r, :len(row)] = row
        vlens.append(len(row))
    vlens[3] -= 100
    return x, np.asarray(vlens, np.int32)


@jax.jit
def _jax_exact_4b5b(x, vlens, local, c0, lim):
    def one(s, v, c, m):
        return jdecoder.decode_capture(JCFG4, s, local, MF, valid_len=v, with_cursor=True,
                                       start_cursor=c, scan_limit=m)
    return jax.vmap(one)(x, vlens, c0, lim)


RUNS_4B5B = [(2, 0, 2**30), (-1, 0, 2**30), (2, 700, 2500)]


@pytest.fixture(scope="module")
def reference_4b5b():
    x, vlens = _captures_4b5b()
    b = x.shape[0]
    runs = {}
    for local, c0, lim in RUNS_4B5B:
        res, searched, cur = _jax_exact_4b5b(
            jnp.asarray(x), jnp.asarray(vlens), local, jnp.full(b, c0, jnp.int32),
            jnp.full(b, lim, jnp.int32))
        runs[local, c0, lim] = (jax.tree_util.tree_map(np.asarray, res),
                                np.asarray(searched), np.asarray(cur))
    return x, vlens, runs


@pytest.mark.parametrize("local,c0,lim", RUNS_4B5B)
def test_exact_scan_4b5b_matches_jax(reference_4b5b, local, c0, lim):
    x, vlens, runs = reference_4b5b
    want, want_searched, want_cur = runs[local, c0, lim]
    for r in range(x.shape[0]):
        got, searched, cur = decoder.decode_capture(
            CFG4, torch.from_numpy(x[r]), local, MF, valid_len=int(vlens[r]),
            with_cursor=True, start_cursor=c0, scan_limit=lim)
        _assert_same_slots(got, want, r)
        assert (searched, cur) == (int(want_searched[r]), int(want_cur[r])), r


def test_exact_scan_4b5b_outcomes(reference_4b5b):
    x, vlens, runs = reference_4b5b
    want = runs[2, 0, 2**30][0]
    got = decoder.decode_captures(CFG4, torch.from_numpy(x), 2, MF, vlens.tolist())
    _assert_same_slots(got, want)
    assert [[f.sequence for f in got.to_frames(row=r)] for r in range(x.shape[0])] == [
        [0, 1, 2, 3], [4], [6], [], []]     # the zeroed levels break frame 5
    promiscuous = decoder.decode_capture(CFG4, torch.from_numpy(x[1]), -1, MF)
    assert [f.sequence for f in promiscuous.to_frames()] == [1, 4]
