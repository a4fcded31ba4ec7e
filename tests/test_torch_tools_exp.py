"""The port's last two experiments (trackmaker_tpu_torch.tools.exp_offset_add
and .exp_attempt_tiles) against the JAX tools' Pallas kernels in interpret
mode, on the CPU.

``tools/exp_offset_add.py`` runs nothing at import and is loaded from its
file.  ``tools/exp_attempt_tiles.py`` runs its timings at import, so only
its ``make_kernel`` function and its constants are taken from its source
(``ast``) and run here, the ``pallas_call`` built as the tool builds it,
with ``interpret=True`` and one capture.

Tolerances: none.  The offset-add inputs are small integers and a 0/1
table, so every sum is exact in any order: the port's plain forms equal
the Pallas kernels and the NumPy oracles bit for bit.  The attempt tiles
run on an integer-valued copy of the tool's corpus (x of integers -2..2,
ternary tables): every product and sum is an exact integer, and the only
rounded step, the sync's ``dot * rsqrt(en)`` (``dot / sqrt(en)`` in the
port), decides an argmax; the corpus is first checked to have no two
deciding lanes within 1e-6 of each other unless their sums are equal.  So
every block, and the accumulator in ``out[:, 0]``, is equal.  The TPU
kernel leaves what it does not store undefined (NaN in interpret mode):
there the port's zeros and accumulator are held against sums of the JAX
outputs and of the corpus.  Its ``_nodma`` form reads an unfilled scratch
buffer, so the port's (the rows read from device memory) is held against
the port's staged form."""

import ast
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from trackmaker_tpu_torch.tools import exp_attempt_tiles as et
from trackmaker_tpu_torch.tools import exp_offset_add as eo

ROOT = Path(__file__).resolve().parent.parent
OFFSET_TOOL = ROOT / "tools" / "exp_offset_add.py"
TILES_TOOL = ROOT / "tools" / "exp_attempt_tiles.py"
STORING = ["base", "n128", "sync1", "both", "bf16b", "base_u5", "n128_u2"]
MARGIN = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread while this module runs: the suite runs a worker per
    core, and torch's own thread pool on top oversubscribes them."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _function(path: Path, name: str) -> ast.FunctionDef:
    tree = ast.parse(path.read_text())
    return next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == name)


def _run_statements(path: Path, statements: list, ns: dict) -> dict:
    exec(compile(ast.Module(body=statements, type_ignores=[]), str(path), "exec"), ns)
    return ns


# --- kernel #14: the offset-add experiment -----------------------------------

def _load_offset_tool():
    spec = importlib.util.spec_from_file_location("exp_offset_add_tool", OFFSET_TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def offset_tool():
    return _load_offset_tool()


def _pallas_form(tool, form: str, x: np.ndarray, t: np.ndarray) -> np.ndarray:
    kernel = {"A": tool.kernel_a, "B": tool.kernel_b, "C": tool.kernel_c}[form]
    call = pl.pallas_call(kernel, out_shape=jax.ShapeDtypeStruct((32, 128), jnp.float32),
                          interpret=True)
    return np.asarray(call(jnp.asarray(x), jnp.asarray(t)))


def test_offset_add_tool_input_is_the_tool_s():
    run = _function(OFFSET_TOOL, "run")
    first = [s for s in run.body if isinstance(s, ast.Assign)][:3]     # rng, x, t
    ns = _run_statements(OFFSET_TOOL, first, {"np": np})
    x, t = eo.tool_input("cpu")
    assert np.array_equal(x.numpy(), ns["x"]) and np.array_equal(t.numpy(), ns["t"])
    assert x.dtype == torch.float32 and tuple(t.shape) == (384, 256)


@pytest.mark.parametrize("form", eo.FORMS)
def test_offset_add_plain_equals_pallas_and_oracle(offset_tool, form):
    x, t = eo.tool_input("cpu")
    xn, tn = x.numpy(), t.numpy()
    want = _pallas_form(offset_tool, form, xn, tn)
    assert np.array_equal(want, getattr(offset_tool, "o" + form.lower())(xn, tn))
    assert np.array_equal(eo.ORACLES[form](xn, tn), want)
    before = eo.offset_add.launches
    got = eo.offset_add(form, x, t)          # CPU tensors: the plain version
    assert eo.offset_add.launches == before
    assert got.shape == (32, 128) and np.array_equal(got.numpy(), want)
    assert np.array_equal(eo.offset_add_plain(form, x, t).numpy(), want)
    assert eo.errors(form, got, x, t) == (0.0, 0.0)


# x[0, 0:8] and the lane shift each gives: the tool's seed-0 input (a sum
# of -5), sums past +64 and past -64, and halves that truncate toward zero
# (their float sum is 64, the sum of their truncations 63)
SHIFT_CASES = {
    "seed0": (None, 59),
    "past_plus_64": ([20, 20, 20, 10, 0, 0, 0, 0], 6),
    "past_minus_64": ([-20, -20, -20, -10, 0, 0, 0, 0], 58),
    "halves": ([2.5, -2.5, 1.5, -1.5, 0.5, -0.5, 30.5, 33.5], 63),
}


@pytest.mark.parametrize("case", list(SHIFT_CASES))
def test_lane_shift_is_a_floor_mod(offset_tool, case):
    head, ql = SHIFT_CASES[case]
    x, t = eo.tool_input("cpu")
    if head is not None:
        x[0, :8] = torch.tensor(head, dtype=torch.float32)
    else:
        assert int(x[0, :8].sum()) == -5
    assert eo.lane_shift(x) == ql
    xn, tn = x.numpy(), t.numpy()
    want = _pallas_form(offset_tool, "C", xn, tn)
    assert np.array_equal(offset_tool.oc(xn, tn), want)
    got = eo.offset_add_plain("C", x, t).numpy()
    assert np.array_equal(got, want)
    lsel = (xn @ tn)[:, :128]
    assert np.array_equal(got[:, 0], lsel[:32, ql])                    # the shift itself
    assert np.array_equal(got[:, 127], lsel[1:33, ql - 1])


def test_offset_add_refuses_other_shapes_and_forms():
    x, t = eo.tool_input("cpu")
    with pytest.raises(ValueError):
        eo.offset_add("D", x, t)
    with pytest.raises(ValueError):
        eo.offset_add("A", x[:33].contiguous(), t)
    with pytest.raises(ValueError):
        eo.offset_add("A", x, t.double())


# --- kernel #13: the attempt-tile experiment ---------------------------------

def _tiles_constants() -> dict:
    """The tool's B, NV, NR, DROW, BROWS (its line 31)."""
    tree = ast.parse(TILES_TOOL.read_text())
    assign = next(n for n in tree.body if isinstance(n, ast.Assign)
                  and isinstance(n.targets[0], ast.Tuple)
                  and [e.id for e in n.targets[0].elts] == ["B", "NV", "NR", "DROW", "BROWS"])
    return _run_statements(TILES_TOOL, [assign], {})


def test_attempt_tiles_constants_are_the_tool_s():
    c = _tiles_constants()
    assert (c["B"], c["NV"], c["NR"], c["DROW"], c["BROWS"]) == (et.B, et.NV, et.NR, et.DROW,
                                                                et.BROWS)


def test_attempt_tiles_tool_input_is_the_tool_s():
    run = _function(TILES_TOOL, "run")
    body = []
    for s in run.body:
        if isinstance(s, ast.Assign) and getattr(s.targets[0], "id", None) == "call":
            break
        body.append(s)
    ns = _run_statements(TILES_TOOL, body, {"np": np, "jnp": jnp, **_tiles_constants()})
    got = et.tool_input("cpu")
    names = ("x384", "ts", "tsc", "tb", "tbn", "w", "wn")
    for name, a in zip(names, got):
        assert np.array_equal(a.numpy(), np.asarray(ns[name])), name


@pytest.fixture(scope="module")
def tiles():
    """The integer corpus (one capture), and the JAX tool's make_kernel."""
    ns = {"jax": jax, "jnp": jnp, "pl": pl, "pltpu": pltpu, "PIPE": et.PIPE,
          **_tiles_constants()}
    _run_statements(TILES_TOOL, [_function(TILES_TOOL, "make_kernel")], ns)
    return et.tool_input("cpu", b=1, integer=True), ns["make_kernel"]


def _pallas_tiles(make_kernel, variant: str, inputs) -> np.ndarray:
    """The JAX tool's pallas_call (its lines 165-176) in interpret mode."""
    b = inputs[0].shape[0]
    call = pl.pallas_call(
        make_kernel(variant),
        out_shape=jax.ShapeDtypeStruct((b, et.NV, et.BROWS, 128), jnp.float32),
        grid=(b,),
        in_specs=[pl.BlockSpec(memory_space=pltpu.HBM)]
        + [pl.BlockSpec(memory_space=pltpu.VMEM)] * 6,
        out_specs=pl.BlockSpec((1, et.NV, et.BROWS, 128), lambda bb: (bb, 0, 0, 0),
                               memory_space=pltpu.VMEM),
        scratch_shapes=[pltpu.VMEM((et.PIPE, et.NR, et.DROW), jnp.float32),
                        pltpu.SemaphoreType.DMA((et.PIPE,))],
        interpret=True,
    )
    return np.asarray(call(*(jnp.asarray(a.numpy()) for a in inputs)))


@pytest.mark.parametrize("kind", ["base", "sync1"])
def test_sync_lanes_keep_a_margin_on_the_corpus(tiles, kind):
    """No two deciding lanes lie within 1e-6 unless their dot and their
    energy floored at 1e-6 are equal (then every rounding of the quotient
    ties them), so rsqrt (JAX) and 1/sqrt (the port) pick the same lane."""
    (x, ts, tsc, *_), _ = tiles
    dot, en, cc, best = et.sync_plain(et.parse_variant(kind), x, ts, tsc)
    en = en.clamp(min=1e-6)
    top = cc.max(-1, keepdim=True).values
    near = (top - cc) <= MARGIN
    pick = best[..., None]
    same = (dot == dot.gather(-1, pick)) & (en == en.gather(-1, pick))
    assert bool((~near | same).all())
    assert int(near.sum()) >= cc.shape[1]           # the winners themselves


@pytest.mark.parametrize("variant", STORING)
def test_attempt_tiles_plain_matches_pallas(tiles, variant):
    inputs, make_kernel = tiles
    n = et.parse_variant(variant).n_cand
    want = _pallas_tiles(make_kernel, variant, inputs)
    before = et.attempt_tiles.launches
    got = et.attempt_tiles(variant, *inputs).numpy()      # CPU tensors: the plain version
    assert et.attempt_tiles.launches == before
    assert np.array_equal(got[:, :n], want[:, :n])         # every block and the accumulator
    assert not got[:, n:].any()                            # not computed: zero
    assert got[:, 1:n].max() > 0 and np.isfinite(got).all()


def test_attempt_tiles_accumulators_without_stores(tiles):
    """``noop`` and ``_nostore`` store no block: the port's out is zero but
    for out[:, 0], the accumulator, held against sums of the corpus (noop:
    x01[0, 0:8] of every candidate) and of JAX's base blocks (nostore:
    dot + block[0, 0] of every candidate, which sum to base's out[:, 0, 0,
    0] and the other blocks' [0, 0])."""
    inputs, make_kernel = tiles
    x = inputs[0].numpy().astype(np.float64)
    base = _pallas_tiles(make_kernel, "base", inputs).astype(np.float64)
    for variant, want in (
            ("noop", sum(x[:, 9 * (c % 8), :8].sum(-1) for c in range(et.NV))),
            ("base_nostore", base[:, 0, 0, 0] + base[:, 1:, 0, 0].sum(-1))):
        got = et.attempt_tiles_plain(variant, *inputs).numpy()
        assert not got[:, 1:].any(), variant
        assert np.array_equal(got[:, 0], np.broadcast_to(want[:, None, None], got[:, 0].shape)), \
            variant


def test_attempt_tiles_nodma_reads_the_same_rows(tiles):
    inputs, _ = tiles
    base = et.attempt_tiles_plain("base", *inputs)
    assert torch.equal(et.attempt_tiles_plain("base_nodma", *inputs), base)
    assert torch.equal(et.attempt_tiles_plain("base_nodma_nostore_u5", *inputs),
                       et.attempt_tiles_plain("base_nostore", *inputs))


def test_variants_parse_and_refuse():
    v = et.parse_variant("n128_nodma_nostore_u4")
    assert (v.kind, v.stage, v.store, v.n_cand, v.n128, v.merged) == ("n128", False, False, 64,
                                                                      True, False)
    assert et.parse_variant("noop").store is False
    for bad in ("fast", "base_dma", "base_u0", "base_u", "base_u66"):
        with pytest.raises(ValueError):
            et.parse_variant(bad)


def test_a_ring_that_does_not_fit_raises(tiles):
    """Four stages (16 table rows and 35 rows of x over 16 columns) fit a
    block's share of an SM's shared memory when three blocks share it
    (76,800 bytes); five do not, and the depth is refused, not clamped, on
    every device."""
    inputs, _ = tiles
    assert et.stage_smem(et.parse_variant("base"), 4) == 4 * (16 * 256 + 35 * 16) * 4 + \
        et.STATIC_SMEM
    assert et.stage_smem(et.parse_variant("base"), 4) <= et.SMEM_PER_BLOCK == 76_800
    for call in (et.attempt_tiles, et.attempt_tiles_plain):
        with pytest.raises(ValueError):
            call("base", *inputs, pipe=5)
        with pytest.raises(ValueError):
            call("base", *inputs, pipe=0)
    assert et.stage_smem(et.parse_variant("base_nodma"), 9) == 2 * et.STAGE_BYTES + et.STATIC_SMEM
    with pytest.raises(ValueError):
        et.main(["1", "base", "5"])
