"""The window probe (#12, ``csrc/seq_probe.cu``) and the offset add (#14,
``csrc/offset_add.cu``) at their edges, held on the CPU against the JAX
package's kernels and against twins of the kernels' schedules.

The probe kernel stages x + c in shared memory for c = 0..127 and writes
x + 127 once; its plain version is ``x + 127.0`` repeated over the 32
blocks.  Here the plain version equals bench.py's Pallas probe (interpret
mode) on inputs where the add rounds: |x| around 2^24, ties at 3 * 2^23
(odd sums halfway between two floats), infinities, NaN and -0.0, compared
as int32 views where no NaN stands (NaN only as NaN: its payload may
differ).

The offset-add kernels cut each output's terms (A and B: row i's 384,
then row i + 1's; C: one row's 384 at the shifted column) into 32 slices
a block, sum each slice in ascending order with fused multiply-adds and
add the slices in ascending order.  :func:`schedule_twin` runs that
schedule with the kernel's own index arithmetic (a block's lanes, rows,
slices, C's shifted column crossing into the next row at 128) in NumPy,
each fused multiply-add emulated in float64.  Here the twin equals the
plain version bit for bit on the tool's inputs (every sum exact) for the
kept design and the tool's ``lanes32`` and ``rows4`` variants, and both
lie within :func:`error_bound` of a float64 product on N(0, 1) inputs.
The plain versions equal the JAX tool's kernels (interpret mode) on those
inputs within rtol 1e-5, atol 1e-4 (both sum in f32, in other orders:
about sqrt(768) * 2^-24 * 28 = 5e-5 apart on sums near 28), at lane
shifts 0, 63 and from a negative sum.

The tool's variants (``tools/exp_probe_offset.py``) still patch the kept
sources, and ``chip_smoke.py``'s bounds for #12 and #14 are the figures in
PERF.md.

``tests/test_torch_kernels_gpu.py`` and ``chip_smoke.py`` hold the kernels
against the plain versions on these inputs on a card; this module imports
JAX only inside its tests, so they can import the builders without it."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from trackmaker_tpu_torch import _build
from trackmaker_tpu_torch.tools import exp_offset_add as eo
from trackmaker_tpu_torch.tools import exp_probe_offset as epo
from trackmaker_tpu_torch.tools import health

ROOT = Path(__file__).resolve().parent.parent

# --- the window probe (#12) -------------------------------------------------------

PROBE_EDGES = ("near_2_24", "ties", "special")


def probe_edge_input(kind: str, device="cpu") -> torch.Tensor:
    """x f32[8, 128] where x + c rounds: ``near_2_24`` integers and halves
    within 300 of +-2^24 (x + 127 crosses it, and past it only even
    integers are floats); ``ties`` 3 * 2^23 + 2n, +-, where ulp is 2 and
    every odd c lands halfway (round to even); ``special`` +-inf, NaN,
    -0.0, +0.0, +-FLT_MAX, the smallest subnormal and -127 among N(0, 1e3)."""
    rng = np.random.default_rng({"near_2_24": 11, "ties": 12, "special": 13}[kind])
    if kind == "near_2_24":
        x = 2.0**24 + rng.integers(-300, 300, 1024) + 0.5 * rng.integers(0, 2, 1024)
        x *= rng.choice([-1.0, 1.0], 1024)
    elif kind == "ties":
        x = (3 * 2.0**23 + 2 * rng.integers(-500, 500, 1024)) * rng.choice([-1.0, 1.0], 1024)
    else:
        x = rng.normal(0, 1e3, 1024)
        f32 = np.finfo(np.float32)
        specials = [np.inf, -np.inf, np.nan, -0.0, 0.0, f32.max, -f32.max,
                    float(f32.smallest_subnormal), -127.0]
        x[rng.permutation(1024)[:len(specials) * 8]] = np.repeat(specials, 8)
    return torch.from_numpy(x.astype(np.float32).reshape(health.PROBE_SHAPE)).to(device)


def assert_probe_equal(got: np.ndarray, want: np.ndarray) -> None:
    """Bit for bit as int32 views, NaN only as NaN."""
    nan = np.isnan(want)
    assert np.array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got[~nan].view(np.int32), want[~nan].view(np.int32))


@pytest.mark.parametrize("kind", PROBE_EDGES)
def test_seq_probe_plain_equals_the_jax_probe_where_the_add_rounds(kind):
    from test_torch_tools import _jax_probe     # imports JAX

    x = probe_edge_input(kind)
    got = health.seq_probe_plain(x).numpy()
    want = _jax_probe(x.numpy())
    assert got.shape == (256, 128) and got.dtype == np.float32
    assert_probe_equal(got, want)
    xn = x.numpy()
    if kind == "ties":          # every x + 127 was a tie, rounded to even
        assert np.all(got[:8] != (xn.astype(np.float64) + 127))
        assert np.all(got[:8].astype(np.int64) % 4 == 0)
    if kind == "special":
        assert np.isposinf(got[np.isposinf(np.tile(xn, (32, 1)))]).all()
        minus0 = np.signbit(xn) & (xn == 0)
        assert np.array_equal(got[:8][minus0].view(np.int32),
                              np.full(minus0.sum(), np.float32(127).view(np.int32)))


# --- the offset add (#14) ---------------------------------------------------------

# x[0, 0:8] and the lane shift each gives: 64 (shift 0), 63, and a negative
# sum of truncations (-3 - 2 = -5: 59)
SHIFT_HEADS = {"ql0": ([64, 0, 0, 0, 0, 0, 0, 0], 0), "ql63": ([63, 0, 0, 0, 0, 0, 0, 0], 63),
               "negative": ([-3.7, -2.2, 0.9, -0.9, 0.0, 0.0, 0.0, 0.0], 59)}
TERMS = 768                     # the most terms an output sums (A, B)
RTOL, ATOL = 1e-5, 1e-4


def offset_random_input(seed: int = 0, head=None, device="cpu"):
    """x f32[40, 384] and t f32[384, 256] of N(0, 1), from
    ``default_rng(seed)``; x[0, 0:8] = head when given."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, eo.X_SHAPE).astype(np.float32)
    t = rng.normal(0, 1, eo.T_SHAPE).astype(np.float32)
    if head is not None:
        x[0, :8] = head
    return torch.from_numpy(x).to(device), torch.from_numpy(t).to(device)


def epilogue64(form: str, o: np.ndarray, ql: int) -> np.ndarray:
    """The form's epilogue on a float64 product o[40, 256]."""
    if form == "A":
        return o[0:32, :128] + o[1:33, 128:]
    if form == "B":
        return np.broadcast_to(o[0, :128] + o[1, 128:], (32, 128))
    pairs = np.concatenate([o[0:32, :128], o[1:33, :128]], axis=1)
    return pairs[:, ql:ql + 128]


def reference64(form: str, x: torch.Tensor, t: torch.Tensor) -> np.ndarray:
    """The form in float64 (products and sums exact to 2^-53)."""
    xn, tn = x.cpu().double().numpy(), t.cpu().double().numpy()
    return epilogue64(form, xn @ tn, eo.lane_shift(x.cpu()))


def error_bound(form: str, x: torch.Tensor, t: torch.Tensor) -> np.ndarray:
    """2 * 768 * 2^-24 * sum_j |x_j t_jk| for each output: f32 sums of at
    most 768 terms, one rounding a term, in any order."""
    xn, tn = np.abs(x.cpu().double().numpy()), np.abs(t.cpu().double().numpy())
    return 2 * TERMS * 2.0**-24 * epilogue64(form, xn @ tn, eo.lane_shift(x.cpu()))


def _fma(a, b, c):
    return (a.astype(np.float64) * b + c).astype(np.float32)


def schedule_twin(form: str, x: torch.Tensor, t: torch.Tensor, block_lanes: int = 8,
                  rows: int = 8, threads: int = 256) -> np.ndarray:
    """``csrc/offset_add.cu``'s schedule in NumPy, thread by thread with
    the kernel's index arithmetic: block (bx, by), thread (slice, lane)
    sums its slice's terms in ascending j from 0.0f, one fused multiply-add
    a term; the block adds its slices in ascending order and stores its
    rows (B: its one row to all 32)."""
    xn, tn = x.cpu().numpy(), t.cpu().numpy()
    k_dim, lanes, out_rows = eo.X_SHAPE[1], eo.LANES, eo.OUT_ROWS
    terms = k_dim if form == "C" else 2 * k_dim
    r_rows = 1 if form == "B" else rows
    slices = threads // block_lanes
    ks = terms // slices
    assert terms % slices == 0 and ks % 4 == 0 and k_dim % ks == 0
    gx, gy = lanes // block_lanes, 1 if form == "B" else out_rows // r_rows
    bx, by, tid = (a.reshape(-1) for a in np.meshgrid(
        np.arange(gx), np.arange(gy), np.arange(threads), indexing="ij"))
    lane, sl = tid % block_lanes, tid // block_lanes
    k = bx * block_lanes + lane
    i0 = by * r_rows
    if form == "C":
        s = int(np.trunc(xn[0, :8]).astype(np.int32).sum())
        m = k + s % eo.QL_MOD                              # Python's % is a floor mod
        row_off = (m >= lanes).astype(np.int64)
        col, j0 = m - row_off * lanes, sl * ks
    else:
        first = sl * ks
        row_off = first // k_dim
        col, j0 = row_off * lanes + k, first - row_off * k_dim
    acc = np.zeros((tid.size, r_rows), np.float32)
    for jj in range(ks):
        tv = tn[j0 + jj, col]
        for r in range(r_rows):
            acc[:, r] = _fma(xn[i0 + row_off + r, j0 + jj], tv, acc[:, r])
    # part[block, slice, r, lane], then each block's slices in ascending order
    part = acc.reshape(gx * gy, slices, block_lanes, r_rows).transpose(0, 1, 3, 2)
    total = part[:, 0].copy()
    for s_ in range(1, slices):
        total = (total + part[:, s_]).astype(np.float32)
    out = np.full((out_rows, lanes), np.nan, np.float32)
    for b in range(gx * gy):
        bxb, byb = divmod(b, gy)
        ks_cols = slice(bxb * block_lanes, (bxb + 1) * block_lanes)
        if form == "B":
            out[:, ks_cols] = total[b, 0]
        else:
            out[byb * r_rows:(byb + 1) * r_rows, ks_cols] = total[b]
    assert not np.isnan(out).any()
    return out


# (block lanes, rows): the kept design and the tool's lanes32 and rows4
DESIGNS = {"kept": (8, 8), "lanes32": (32, 8), "rows4": (8, 4)}


@pytest.mark.parametrize("design", list(DESIGNS))
@pytest.mark.parametrize("form", eo.FORMS)
def test_schedule_twin_equals_plain_on_the_tool_input(form, design):
    """The tool's integers: every sum exact, so the kernel's schedule
    equals the plain version bit for bit; at the tool's shift (59) and at
    the shifts of SHIFT_HEADS, whose heads are integers here."""
    lanes, rows = DESIGNS[design]
    x, t = eo.tool_input("cpu")
    heads = [None] + ([np.trunc(h) for h, _ in SHIFT_HEADS.values()] if form == "C" else [])
    for head in heads:
        if head is not None:
            x = x.clone()
            x[0, :8] = torch.tensor(head, dtype=torch.float32)
        want = eo.offset_add_plain(form, x, t).numpy()
        assert np.array_equal(schedule_twin(form, x, t, lanes, rows), want)
        assert np.array_equal(want, eo.ORACLES[form](x.numpy(), t.numpy()))


@pytest.mark.parametrize("design", list(DESIGNS))
@pytest.mark.parametrize("form", eo.FORMS)
def test_schedule_twin_and_plain_lie_within_the_bound(form, design):
    lanes, rows = DESIGNS[design]
    for seed, head in ((1, None), *((2 + n, h) for n, (h, _) in enumerate(SHIFT_HEADS.values()))):
        x, t = offset_random_input(seed, head)
        want, bnd = reference64(form, x, t), error_bound(form, x, t)
        twin = schedule_twin(form, x, t, lanes, rows)
        for got in (twin, eo.offset_add_plain(form, x, t).numpy()):
            assert np.all(np.abs(got - want) <= bnd), (form, seed)


JAX_CASES = [(form, None) for form in eo.FORMS] + [("C", head) for head in SHIFT_HEADS]


@pytest.mark.parametrize("form, head", JAX_CASES, ids=[f"{f}-{h}" for f, h in JAX_CASES])
def test_offset_add_plain_near_the_jax_kernels_on_random_input(form, head):
    """N(0, 1) inputs, non-integer: the plain version against the JAX
    tool's kernel in interpret mode, within rtol 1e-5, atol 1e-4; C also at
    the lane shifts 0, 63 and 59 from a negative sum."""
    from test_torch_tools_exp import _load_offset_tool, _pallas_form   # import JAX

    offset_tool = _load_offset_tool()
    x, t = offset_random_input(7, None if head is None else SHIFT_HEADS[head][0])
    if head is not None:
        assert eo.lane_shift(x) == SHIFT_HEADS[head][1]
    want = _pallas_form(offset_tool, form, x.numpy(), t.numpy())
    got = eo.offset_add(form, x, t).numpy()          # CPU tensors: the plain version
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert np.all(np.abs(want - reference64(form, x, t)) <= error_bound(form, x, t))


# --- the experiment's variants (tools/exp_probe_offset.py) ------------------------


@pytest.mark.parametrize("key", list(epo.VARIANTS), ids="-".join)
def test_experiment_variants_patch_the_kept_sources(key):
    """Each variant's anchors lie once in the kept source, and its patch
    leaves a source that still holds its kernels and entry points."""
    src, _ = key
    kept = (_build.CSRC / f"{src}.cu").read_text()
    text = epo.patched(src, epo.VARIANTS[key])
    assert text != kept
    for _, _, new in epo.VARIANTS[key]:
        assert new in text
    symbols = {"seq_probe": ["seq_probe_kernel", "extern \"C\" int tm_seq_probe("],
               "offset_add": [*(f"offset_add_{f}_kernel" for f in "abc"),
                              *(f"extern \"C\" int tm_offset_add_{f}(" for f in "abc")]}[src]
    for symbol in symbols:
        assert symbol in text


def test_empty_grids_are_the_kernels():
    grids = {what: (blocks, threads) for what, blocks, threads in epo.empty_grids()}
    assert grids["#12 seq_probe"] == (128, 64)
    assert 128 * 64 * 4 == 256 * 128                  # a float4 of the output a thread
    assert grids["#12 seq_probe first design"] == (32, 1024)
    for form in eo.FORMS:
        blocks, threads = grids[f"#14 offset_add {form}"]
        lanes, rows = DESIGNS["kept"]
        assert threads == 256 and blocks == (128 // lanes) * (1 if form == "B" else 32 // rows)
    assert grids["#14 offset_add B first design"] == (1, 128)


# --- chip_smoke.py's bounds ---------------------------------------------------------


@pytest.fixture(scope="module")
def chip_smoke():
    """chip_smoke.py as a module: it imports torch and the port only in main()."""
    spec = importlib.util.spec_from_file_location("chip_smoke_bounds", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# (kernel, ms as PERF.md writes it, digits, what sets it)
BOUNDS = [("seq_probe", 0.0000626, 7, "operations"), ("A", 0.000137, 6, "bytes"),
          ("B", 0.000123, 6, "bytes"), ("C", 0.0000787, 7, "bytes")]


@pytest.mark.parametrize("kernel, ms, digits, by", BOUNDS, ids=[b[0] for b in BOUNDS])
def test_chip_smoke_bounds_are_perf_md_s(chip_smoke, kernel, ms, digits, by):
    got = chip_smoke.probe_bound() if kernel == "seq_probe" else chip_smoke.offset_bound(kernel)
    assert (round(got[0], digits), got[1]) == (ms, by)
    if kernel == "seq_probe":
        # x read once, the output written once, 128 adds an element
        assert got[0] == max((4 * 1024 + 4 * 256 * 128) / 3.35e12,
                             128 * 256 * 128 / 67e12) * 1e3
