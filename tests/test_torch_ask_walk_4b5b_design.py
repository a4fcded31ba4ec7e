"""The 4B5B attempt's and the ASK frame walk's edge inputs, held on the CPU
against the JAX package.

The 4B5B attempt kernel (``csrc/attempt_4b5b.cu``) stages each live slot's
window from the 16-byte boundary at or below its start and zero-fills it at
and past T: its edge inputs (:func:`fourb5b_edge_inputs`) put windows across
T and the valid length, starts at every offset mod 4, a base at or past T,
row stride 0, rows with no live slot and with more hits than slots, near-zero
levels (an exact zero and a sum of 3e-6) and invalid symbols at 0 and at 525;
here the plain attempts equal JAX's ``_attempt_kernel_4b5b`` (interpret
mode) at every live slot: legacy, fold (from the legacy frame starts, the
only ones JAX's fold stages a window for) and legacy on one shared capture.

The ASK walk kernel (``csrc/ask_walk.cu``) finds each slot's candidate by
binary lifting over a step function, and its plain version
(``phy/ask_spec.py:ask_walk_plain``) runs the same algorithm in tensor ops:
here the plain walk equals the statement-for-statement loop
(:func:`ask_walk_serial`, the TPU kernel's steps) and JAX's ``_walk``
(interpret mode) on tables at the algorithm's edges
(:func:`ask_edge_tables`): C+1 in ASK_C1S, max_frames in ASK_MFS, with a
self-loop, a cycle, succ < 0 at an emitting node, nonconf with succ >= 0, a
clean chain longer than max_frames, a stop at the first node and flags
below zero.

``tests/test_torch_kernels_gpu.py`` and ``chip_smoke.py`` hold the kernels
against their plain versions on the same inputs on a card; this module
imports JAX only inside its tests, so they can import the builders
without it.

Tolerances: the walk and the kernels' comparisons are exact.  Against JAX's
attempt, bytes, frame starts, first invalid and first near-zero symbols are
exactly equal at every live slot; that rests on two properties of the
inputs, asserted with it, since JAX sums its refine and levels in another
order: no level sum lies within 1e-7 of +-4e-6 or, unless exactly 0, of 0,
and no slot's two best refine positions score within 1e-6 of each other
(unless both are 0 or both -inf)."""

import functools

import numpy as np
import pytest
import torch

from trackmaker_tpu_torch import PhyConfig
from trackmaker_tpu_torch.core.framing import Frame
from trackmaker_tpu_torch.phy import ask_spec
from trackmaker_tpu_torch.phy import spec_decode as sd
from trackmaker_tpu_torch.phy.encoder import PhyEncoder
from trackmaker_tpu_torch.phy.line_coding import FOURB_FIVEB_ENCODE, preamble_waveform
from trackmaker_tpu_torch.sync.correlate import preamble_energy

BIGI = 2**30
CFG4 = PhyConfig(line_coding="4b5b")
PRE4 = preamble_waveform(CFG4)
SYNC4 = PRE4[30:]
B4, C4, T4 = 4, 24, 40_003          # T not a multiple of 4
BODY4 = sd.ZERO_SYMBOLS * sd.SYMBOL_SAMPLES          # 9,600 samples from fs
WINDOW4 = 60 + BODY4                                 # a legacy slot's window from base
FOURB_FORMS = ("legacy", "fold", "legacy shared", "fold shared")
FRAME_STARTS = (1_003, 9_506, 22_001)
# planted at these preamble starts in every row: symbol 0 invalid; 525
# valid symbols, symbol m the code of nibble m % 16, then an invalid one;
# an exact zero level in symbol 7; a level of 3e-6 in symbol 3
BAD0, BAD525, ZERO7, TINY3 = 3_000, 12_000, 25_000, 27_000
ASK_C1S = (1, 31, 32, 33, 97, 129, 2048)
ASK_MFS = (1, 2, 63, 64, 65, 72, 128, 300)
# rows of every ASK edge table, in order
ASK_ROWS = ("random", "clean chain", "self-loop", "cycle", "miss at an emitting node",
            "nonconf with a successor", "stop first", "flags below zero")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# --- the 4B5B attempt --------------------------------------------------------------


def _symbols_wave(codes, amp: float = 0.5) -> np.ndarray:
    """The NRZI waveform of 5-bit codes, MSB first, from level +1: a 1 bit
    flips the level, each level 3 samples of +-amp."""
    level, out = 1.0, []
    for code in codes:
        for k in range(4, -1, -1):
            if (int(code) >> k) & 1:
                level = -level
            out += [level * amp] * 3
    return np.asarray(out, np.float32)


def _plant(x: np.ndarray, rng, start: int, codes) -> int:
    """Write the preamble at `start` and the codes' waveform after it into
    every row of x, with noise of sigma 0.01 (so no two refine positions
    tie); returns the frame start start + 60."""
    wave = np.concatenate([PRE4, _symbols_wave(codes)])
    x[:, start:start + len(wave)] = wave + rng.normal(0, 0.01, (x.shape[0], len(wave)))
    return start + len(PRE4)


def _fourb5b_capture(rng) -> np.ndarray:
    """B4 rows of T4 samples: noise, three frames at FRAME_STARTS in each
    row, and the planted symbol runs at BAD0, BAD525, ZERO7 and TINY3."""
    enc = PhyEncoder(CFG4, device="cpu")
    x = rng.normal(0, 0.3, (B4, T4)).astype(np.float32)
    for i, s in enumerate(FRAME_STARTS):
        wave = enc.encode_frame(Frame.new_data(i, 1, 2, bytes([i + 3]) * 40)).numpy()
        x[:, s:s + len(wave)] += wave
    valid = FOURB_FIVEB_ENCODE
    _plant(x, rng, BAD0, [0] + list(rng.choice(valid, 30)))
    _plant(x, rng, BAD525, [valid[m % 16] for m in range(sd.FRAME_SYMBOLS - 1)] + [0])
    fs = _plant(x, rng, ZERO7, rng.choice(valid, 20))
    x[:, fs + 7 * 15 + 6:fs + 7 * 15 + 9] = 0.0          # level 2 of symbol 7
    fs = _plant(x, rng, TINY3, rng.choice(valid, 20))
    x[:, fs + 3 * 15 + 3:fs + 3 * 15 + 6] = 1e-6         # level 1 of symbol 3
    return x


def fourb5b_edge_inputs(device="cpu"):
    """The four 4B5B attempt forms' edge inputs, form -> (x, args) for
    ``attempt_4b5b`` (legacy forms: cand, n_valid, vlen, sync, sync_e) or
    ``attempt_4b5b_fold`` (fold forms: fs, n_valid).

    x f32[4, 40,003] starts one float past a 16-byte boundary, so its rows
    start at every offset mod 4; the shared forms read its row 0 expanded
    to 4 rows (row stride 0).  Row 0 holds 24 live slots: the three frames,
    the four planted runs, starts at every offset mod 4, windows that end
    just before T, cross T by one sample and mid-body, a refine that
    crosses T, a base at T and past it; row 1 no live slot; row 2 ten,
    whose refines cross the valid length T - 5,000 at every kind of
    position; row 3 more hits than slots.  The fold forms start each slot
    at its expected frame start, and row 0's last eight at every offset
    mod 4 near T and past it."""
    rng = np.random.default_rng(15)
    x_np = _fourb5b_capture(rng)
    t = T4
    edge = [t - WINDOW4 - 15 - 1, t - WINDOW4 - 15 + 1, t - 6_000, t - 70, t - 16, t - 15,
            t - 1, t, t + 5, BIGI]
    row0 = list(FRAME_STARTS) + [BAD0, BAD525, ZERO7, TINY3] + [500 + k for k in range(4)] + [
        30_001 + k for k in range(3)] + edge
    vlen = np.full(B4, t, np.int32)
    vlen[2] = t - 5_000
    # position k of a refine is valid while base + k <= vlen - 30
    row2 = [int(vlen[2]) - 30 - 15 - k for k in (-2, 0, 1, 5, 15, 29, 30, 31)] + list(
        FRAME_STARTS[:2])
    cand = np.full((B4, C4), BIGI, np.int64)
    cand[0] = sorted(row0)
    cand[2, :len(row2)] = sorted(row2)
    cand[3] = np.sort(rng.integers(0, t, C4))
    cand[1, :5] = list(FRAME_STARTS) + [7, 8]           # present, but no slot is live
    n_valid = np.array([C4, 0, len(row2), C4 + 5], np.int32)
    fs = np.minimum(cand, t) + 60
    fs[0, -8:] = [t - BODY4 - 1, t - BODY4, t - BODY4 + 1, t - 6_001, t - 2, t - 1, t, t + 3]
    buf = torch.zeros(B4 * t + 1)
    x = buf[1:].view(B4, t)                              # a first sample off a 16-byte boundary
    x.copy_(torch.from_numpy(x_np))
    if torch.device(device).type == "cuda":             # keep the offset on the card
        on_card = torch.zeros(B4 * t + 1, device=device)
        x = on_card[1:].view(B4, t).copy_(x)
    tens = {k: torch.from_numpy(np.ascontiguousarray(v).astype(np.int32)).to(device)
            for k, v in (("cand", cand), ("n_valid", n_valid), ("vlen", vlen), ("fs", fs))}
    legacy = (tens["cand"], tens["n_valid"], tens["vlen"], SYNC4, preamble_energy(SYNC4))
    fold = (tens["fs"], tens["n_valid"])
    shared = x[:1].expand(B4, -1)
    return {"legacy": (x, legacy), "fold": (x, fold), "legacy shared": (shared, legacy),
            "fold shared": (shared, fold)}


def attempt_4b5b_call(form: str):
    """The wrapper and the plain version of a 4B5B attempt form."""
    if form.startswith("fold"):
        return sd.attempt_4b5b_fold, sd.attempt_4b5b_fold_plain
    return sd.attempt_4b5b, sd.attempt_4b5b_plain


def _slot(cand: torch.Tensor, row: int, pos: int) -> int:
    return int((cand[row] == pos).nonzero()[0, 0])


def test_fourb5b_inputs_plant_what_they_say():
    inputs = fourb5b_edge_inputs()
    x, (cand, n_valid, vlen, sync, sync_e) = inputs["legacy"]
    t = x.shape[1]
    assert t % 4 and x.data_ptr() % 16 and inputs["legacy shared"][0].stride(0) == 0
    live = sd._live(cand, n_valid)
    base = torch.minimum(cand, torch.tensor(t)) + 15
    assert {int(v) for v in base[0] % 4} == {0, 1, 2, 3}
    assert {(x.data_ptr() // 4 + r * t) % 4 for r in range(B4)} == {0, 1, 2, 3}
    assert int((live & (base < t) & (base + WINDOW4 > t)).sum()) >= 4    # windows across T
    assert int((live & (base >= t)).sum()) >= 3
    near_vlen = live[2] & (base[2] + 30 > vlen[2] - 30) & (base[2] <= vlen[2] - 30)
    assert int(near_vlen.sum()) >= 5                                     # refines across vlen
    assert n_valid.tolist()[1] == 0 and n_valid.tolist()[3] > C4
    byts, fs, first_bad, first_zero = sd.attempt_4b5b_plain(x, cand, n_valid, vlen, sync, sync_e)
    for pos in (BAD0, BAD525, ZERO7, TINY3):
        assert int(fs[0, _slot(cand, 0, pos)]) == pos + 60
    assert int(first_bad[0, _slot(cand, 0, BAD0)]) == 0
    assert not byts[0, _slot(cand, 0, BAD0)].any()
    s525 = _slot(cand, 0, BAD525)
    assert int(first_bad[0, s525]) == sd.FRAME_SYMBOLS - 1
    m = torch.arange(0, sd.FRAME_SYMBOLS, 2)
    want = ((m % 16) << 4 | (m + 1) % 16).to(torch.uint8)
    want[-1] = (524 % 16) << 4                          # symbol 525's nibble is zero
    assert torch.equal(byts[0, s525], want)
    assert int(first_zero[0, _slot(cand, 0, ZERO7)]) == 7
    assert int(first_zero[0, _slot(cand, 0, TINY3)]) == 3
    for i, s in enumerate(FRAME_STARTS):      # the frames decode: the header names the length
        slot = _slot(cand, 0, s)
        assert byts[0, slot, 1] == 40 and (byts[0, slot, 7:47] == i + 3).all()
    fs_f = inputs["fold"][1][0]
    assert {int(v) for v in fs_f[0] % 4} == {0, 1, 2, 3}
    assert int(((fs_f[0] < t) & (fs_f[0] + BODY4 > t)).sum()) >= 4 and int((fs_f[0] >= t).sum()) >= 2


@pytest.mark.parametrize("form", FOURB_FORMS)
def test_fourb5b_wrappers_run_the_plain_versions_on_the_cpu(form):
    x, args = fourb5b_edge_inputs()[form]
    wrapper, plain = attempt_4b5b_call(form)
    before = (wrapper.launches, wrapper.shared_launches)
    got = wrapper(x, *args)
    want = plain(x, *args)
    assert [g.dtype for g in got] == [torch.uint8] + [torch.int32] * 3
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert (wrapper.launches, wrapper.shared_launches) == before
    live = sd._live(args[0], args[1])
    assert all(not g[~live].any() for g in got)


def _jax_attempt_4b5b(x: np.ndarray, cand: np.ndarray, n_valid: np.ndarray, vlen: np.ndarray,
                      fs=None, shared: bool = False):
    """JAX's 4B5B attempt kernel as _spec_phase_a launches it (interpret
    mode), read out as the port's four fields: legacy, or fold from the
    frame starts fs, on rows of their own or on row 0 of x shared by every
    row; slots past n_valid are unwritten."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    from trackmaker_tpu.phy import pallas_decode as pd

    b, t = x.shape
    c = cand.shape[1]
    fold = fs is not None
    t8, sync_e = pd._sync_tables(tuple(SYNC4.tolist()), 31)
    r384 = -(-(t + 48) // pd.DROW) + pd.NR4 + 10
    xs = x[:1] if shared else x
    x384 = jnp.pad(jnp.asarray(xs), ((0, 0), (0, r384 * pd.DROW - t))).reshape(
        xs.shape[0], r384, pd.DROW)
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=4, grid=(b,),
        in_specs=[pl.BlockSpec(memory_space=pltpu.HBM)]
        + [pl.BlockSpec(memory_space=pltpu.VMEM)] * (2 if fold else 3),
        out_specs=pl.BlockSpec((1, c, pd.BROWS4, 128), lambda bb, *_: (bb, 0, 0, 0),
                               memory_space=pltpu.VMEM),
        scratch_shapes=[pltpu.VMEM((pd.ATTEMPT_PIPE, pd.NR4, pd.DROW), jnp.float32),
                        pltpu.SemaphoreType.DMA((pd.ATTEMPT_PIPE,))])
    tables = [] if fold else [jnp.asarray(t8)]
    fs_in = jnp.asarray(fs) if fold else jnp.zeros_like(jnp.asarray(cand))
    out = pl.pallas_call(
        functools.partial(pd._attempt_kernel_4b5b, n_cand=c, t_max=t, sync_e=sync_e,
                          fold_sync=fold, shared_x=shared),
        out_shape=jax.ShapeDtypeStruct((b, c, pd.BROWS4, 128), jnp.float32),
        grid_spec=grid_spec, interpret=True,
    )(jnp.asarray(cand), fs_in, jnp.asarray(vlen), jnp.asarray(n_valid), x384, *tables,
      jnp.asarray(pd._level_mats_cat()), jnp.asarray(pd._sym_mats_256()))
    out = np.nan_to_num(np.asarray(out))
    # rows 0-5 nibbles, 6-11 symbol ok, 12-17 near-zero counts (128 symbols
    # a row), row 18 lane 0 the refine delta fs - min(cand, t)
    nib = out[:, :, 0:6].reshape(b, c, 768).astype(np.int32)
    ok = out[:, :, 6:12].reshape(b, c, 768) > 0
    zero = out[:, :, 12:18].reshape(b, c, 768) > 0

    def first(flag, n):
        return np.where(flag[..., :n].any(-1), flag[..., :n].argmax(-1), n).astype(np.int32)

    first_bad = first(~ok, sd.FRAME_SYMBOLS)
    first_zero = first(zero, sd.ZERO_SYMBOLS)
    nib = np.where(np.arange(sd.FRAME_SYMBOLS) < first_bad[..., None],
                   nib[..., :sd.FRAME_SYMBOLS], 0)
    byts = (nib[..., 0::2] * 16 + nib[..., 1::2]).astype(np.uint8)
    fs_out = fs if fold else np.minimum(cand, t) + out[:, :, 18, 0].astype(np.int32)
    return byts, fs_out, first_bad, first_zero


def _levels(x: np.ndarray, fs: np.ndarray) -> np.ndarray:
    """The f32 level sums of the 640 symbols from each frame start."""
    b, t = x.shape
    xz = np.concatenate([x, np.zeros((b, 1), np.float32)], axis=1)
    idx = np.minimum(fs[..., None].astype(np.int64) + np.arange(BODY4), t)
    w = np.take_along_axis(xz, idx.reshape(b, -1), 1).reshape(*fs.shape, -1, 3)
    return (w[..., 0] + w[..., 1]) + w[..., 2]


def _refine_scores(x: np.ndarray, cand: np.ndarray, vlen: np.ndarray) -> np.ndarray:
    """float64 refine scores f64[B, C, 31] (-inf where cut by vlen)."""
    b, t = x.shape
    xz = np.concatenate([x.astype(np.float64), np.zeros((b, 64))], axis=1)
    base = np.minimum(cand, t)[..., None] + 15 + np.arange(31)
    idx = np.minimum(base[..., None] + np.arange(30), t)
    win = np.take_along_axis(xz, idx.reshape(b, -1), 1).reshape(idx.shape)
    en = (win * win).sum(-1)
    cc = np.where(en > 1e-6, (win @ SYNC4.astype(np.float64))
                  / (np.sqrt(np.maximum(en, 1e-30)) * np.sqrt((SYNC4.astype(np.float64) ** 2).sum())),
                  0.0)
    return np.where(base <= vlen[:, None, None] - 30, cc, -np.inf)


@pytest.mark.parametrize("form", ("legacy", "fold", "legacy shared"))
def test_fourb5b_plain_equals_jax_kernel_at_the_edges(form):
    inputs = fourb5b_edge_inputs()
    x, (cand, n_valid, vlen, sync, sync_e) = inputs["legacy"]
    shared = form.endswith("shared")
    xx = inputs["legacy shared"][0] if shared else x
    got = sd.attempt_4b5b_plain(xx, cand, n_valid, vlen, sync, sync_e)
    if form == "fold":
        got = sd.attempt_4b5b_fold_plain(x, got[1], n_valid)
    xs = xx.contiguous().numpy()
    want = _jax_attempt_4b5b(x.contiguous().numpy(), cand.numpy(), n_valid.numpy(), vlen.numpy(),
                             fs=got[1].numpy() if form == "fold" else None, shared=shared)
    live = sd._live(cand, n_valid).numpy()
    for name, g, w in zip(("bytes", "fs", "first_bad", "first_zero"), got, want):
        np.testing.assert_array_equal(g.numpy()[live], w[live], err_msg=f"{form} {name}")
    # the inputs keep clear of the values where JAX's sum order could decide
    lv = np.abs(_levels(xs, got[1].numpy())[live])
    assert not np.any((lv > 0) & (lv < 1e-7))
    assert not np.any(np.abs(lv - sd.LEVEL_NEAR_ZERO) < 1e-7)
    cc = np.sort(_refine_scores(xs, cand.numpy(), vlen.numpy())[live], axis=-1)
    top, second = cc[:, -1], cc[:, -2]
    with np.errstate(invalid="ignore"):     # -inf - -inf where every position is cut
        assert np.all((top - second > 1e-6) | (top == second) & ((top == 0) | (top == -np.inf)))
    assert int(got[2][torch.from_numpy(live)].min()) == 0
    assert int((got[3][torch.from_numpy(live)] < sd.ZERO_SYMBOLS).sum()) >= 4


# --- the ASK frame walk -------------------------------------------------------------


def ask_walk_serial(fields: torch.Tensor, max_frames: int):
    """The TPU kernel's steps statement for statement, batched over
    captures: the oracle of the walk by binary lifting."""
    b = fields.shape[0]
    rows = torch.arange(b)
    i = torch.zeros(b, dtype=torch.int64)
    done = torch.zeros(b, dtype=torch.bool)
    bad = torch.zeros(b, dtype=torch.bool)
    peaks, emits = [], []
    for _ in range(max_frames):
        has, fired, complete, peak, succ, nc = fields[rows, :, i].unbind(-1)
        active = ~done
        ok_fire = active & (has > 0) & (fired > 0)
        emit = ok_fire & (complete > 0)
        peaks.append(peak)
        emits.append(emit)
        miss = (emit & (succ < 0)) | (active & (nc > 0))
        done = done | (active & ((has == 0) | (fired == 0) | (ok_fire & (complete == 0)) | miss))
        i = torch.where(emit & (succ >= 0), succ.to(torch.int64), i)
        bad = bad | miss
    return torch.stack(peaks, 1), torch.stack(emits, 1), bad


def ask_edge_tables(c1: int, seed: int = 15) -> torch.Tensor:
    """The walk's edge table of C+1 = c1 candidates: int32[8, 6, c1], row by
    row as ASK_ROWS names them, each peak distinct, so a slot's peak names
    its candidate."""
    rng = np.random.default_rng(seed + c1)
    b = len(ASK_ROWS)
    node = np.arange(c1)
    flags = np.ones((b, 3, c1), np.int64)                   # has, fired, complete
    succ = np.broadcast_to(np.minimum(node + 1, c1 - 1), (b, c1)).copy()
    nonconf = np.zeros((b, c1), np.int64)
    # random: flags 0.95, successors anywhere, nonconf 0.03
    flags[0] = rng.random((3, c1)) < 0.95
    succ[0] = rng.integers(-1, c1, c1)
    nonconf[0] = rng.random(c1) < 0.03
    # clean chain: i -> i + 1, the last node loops to the first
    succ[1, -1] = 0
    # self-loop: at the middle node
    succ[2, c1 // 2] = c1 // 2
    # cycle: the last node back to the middle one
    succ[3, -1] = c1 // 2
    # an emitting node without a successor, two thirds along
    succ[4, 2 * c1 // 3] = -1
    # nonconf at an emitting node with a successor, a third along
    nonconf[5, c1 // 3] = 1
    # stop first: candidate 0 has no update
    flags[6, 0, 0] = 0
    # flags below zero a third along: no emit, no stop
    flags[7, :, c1 // 3] = -1
    peak = rng.permutation(b * c1).reshape(b, c1) * 7 - 5
    fields = np.concatenate([flags, peak[:, None], succ[:, None], nonconf[:, None]], axis=1)
    return torch.from_numpy(fields.astype(np.int32))


@pytest.mark.parametrize("c1", ASK_C1S)
def test_ask_tables_plant_what_they_say(c1):
    fields = ask_edge_tables(c1)
    peak = fields[:, 3]
    for mf in ASK_MFS:
        peaks, fire_ok, bad = ask_walk_serial(fields, mf)
        cand = (peaks[..., None] == peak[:, None, :]).int().argmax(-1)   # each slot's candidate
        assert fire_ok[1].all() and not bad[1]                           # the clean chain
        assert (cand[1] == torch.arange(mf) % c1).all()
        assert not fire_ok[6].any() and (cand[6] == 0).all()             # stop first
        mid = c1 // 2
        if mf > mid + 1:
            assert (cand[2, mid:] == mid).all() and fire_ok[2].all()     # the self-loop
        if mf > c1 + 1 and c1 > 2:
            assert set(cand[3, c1:].tolist()) <= set(range(mid, c1))     # the cycle
            assert fire_ok[3].all()
        miss_at = 2 * c1 // 3
        assert bool(bad[4]) == (mf > miss_at)
        if mf > miss_at + 1:
            assert (cand[4, miss_at:] == miss_at).all() and not fire_ok[4, miss_at + 1:].any()
        nc_at = c1 // 3
        assert bool(bad[5]) == (mf > nc_at)
        if mf > nc_at + 1 and c1 > 1:
            # the walk advances in the step that stops it
            assert (cand[5, nc_at + 1:] == nc_at + 1).all() and not fire_ok[5, nc_at + 1:].any()
        if mf > nc_at + 1:
            assert (cand[7, nc_at:] == nc_at).all() and not fire_ok[7, nc_at:].any()
            assert not bad[7]


@pytest.mark.parametrize("c1", ASK_C1S)
def test_ask_walk_plain_equals_serial_and_jax(c1):
    import jax.numpy as jnp

    from trackmaker_tpu.phy import ask_spec as jspec

    fields = ask_edge_tables(c1)
    for mf in ASK_MFS:
        got = ask_spec.ask_walk_plain(fields, mf)
        assert [g.dtype for g in got] == [torch.int32, torch.bool, torch.bool]
        for name, g, w, j in zip(("peaks", "fire_ok", "bad"), got, ask_walk_serial(fields, mf),
                                 jspec._walk(jnp.asarray(fields.numpy()), mf, interpret=True)):
            assert torch.equal(g, w), (c1, mf, name)
            np.testing.assert_array_equal(g.numpy(), np.asarray(j), err_msg=f"{c1} {mf} {name}")


def test_ask_walk_wrapper_runs_the_plain_version_on_the_cpu():
    fields = ask_edge_tables(97)
    before = ask_spec.ask_walk.launches
    for mf in (1, 72, 1025, 3000):    # past the kernel's chunk of 1,024 slots
        got = ask_spec.ask_walk(fields, mf)
        assert all(torch.equal(g, w) for g, w in zip(got, ask_walk_serial(fields, mf)))
    assert ask_spec.ask_walk.launches == before
    with pytest.raises(ValueError):
        ask_spec.ask_walk(fields, 0)
