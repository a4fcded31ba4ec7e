"""The consumption walk's and the Manchester attempt's edge inputs, held on
the CPU against the JAX package.

The walk kernel (``csrc/spec_walk.cu``) chases a successor table by pointer
doubling, and its plain version (``phy/spec_decode.py:spec_walk_plain``)
runs the same algorithm in tensor ops: here the plain version equals both
of JAX's walks, the vectorized ``_spec_walk`` and the walk kernel
``_spec_walk_smem`` in interpret mode, on tables at the algorithm's edges
(:func:`walk_edge_tables`).  The attempt kernel (``csrc/attempt_manchester.cu``)
stages each live slot's window from the 16-byte boundary at or below its
start and zero-fills it at and past T: its edge inputs
(:func:`attempt_edge_inputs`) put windows across T and the valid length,
starts at every offset mod 4, a base at or past T, a first sample off a
16-byte boundary, row stride 0, and rows with no live slot and with more
hits than slots; here the plain attempt equals JAX's ``_attempt_kernel``
(interpret mode) at every live slot.  ``tests/test_torch_kernels_gpu.py``
and ``chip_smoke.py`` hold the kernels against their plain versions on the
same inputs on a card; this module imports JAX only inside its tests, so
they can import the builders without it.

Tolerances: none; every field is compared exactly (integers, and attempt
bytes that the kernel, the plain version and JAX's kernel add in the same
order)."""

import functools

import numpy as np
import pytest
import torch

from trackmaker_tpu_torch import PhyConfig, _build
from trackmaker_tpu_torch.core.framing import Frame
from trackmaker_tpu_torch.phy import spec_decode as sd
from trackmaker_tpu_torch.phy.encoder import PhyEncoder
from trackmaker_tpu_torch.phy.line_coding import preamble_waveform
from trackmaker_tpu_torch.sync.correlate import preamble_energy
from trackmaker_tpu_torch.tools import exp_walk_attempt as ew

BIGI = 2**30
WALK_CS = (1, 31, 32, 33, 128, 129, 1000)
# rows of every walk table, in order
WALK_ROWS = ("random", "none exists", "all exist", "stop first", "duplicates",
             "cursor past all", "limit mid", "random from 0")
ATT_B, ATT_C, ATT_T = 4, 24, 40_003     # T not a multiple of 4
WINDOW = 60 + sd.FRAME_BYTES * 8 * sd.BIT_SAMPLES   # a legacy slot's window from base
ATTEMPT_FORMS = ("legacy", "fold", "legacy shared", "fold shared")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _walk_batch(rng, c: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One table of len(WALK_ROWS) rows of c candidates, row by row as
    WALK_ROWS names them: fields int32[8, 4, c], cur0 and limit int32[8]."""
    b = len(WALK_ROWS)
    pos = np.full((b, c), BIGI, np.int64)
    consumed = rng.integers(1, 3000, (b, c))
    stop = rng.random((b, c)) < 0.25
    keep = rng.random((b, c)) < 0.6
    cur0 = rng.integers(0, 30_000, b)
    limit = np.full(b, BIGI, np.int64)
    for r, kind in enumerate(WALK_ROWS):
        k = c if kind in ("all exist", "duplicates", "limit mid", "stop first") else (
            0 if kind == "none exists" else int(rng.integers(0, c + 1)))
        hi = max(1, c // 3) if kind == "duplicates" else 40_000
        pos[r, :k] = np.sort(rng.integers(0, hi, k))
    for r in (2, 4):                 # long chains: short frames, no stop
        consumed[r] = rng.integers(1, 50, c) if r == 2 else 1
        stop[r] = False
    stop[3] = True
    cur0[[2, 3, 4, 7]] = 0
    cur0[5] = pos[5][pos[5] < BIGI].max(initial=0) + 1
    limit[6] = pos[6, c // 2]
    fields = np.stack([pos, consumed, stop, keep], axis=1).astype(np.int32)
    return fields, cur0.astype(np.int32), limit.astype(np.int32)


def walk_edge_tables(c: int, seed: int = 14):
    """The walk's edge tables of c candidates: one batch (rows WALK_ROWS) at
    max_frames 1, L - 1, L and c + 1, L the chain length of the row with
    every candidate present (clipped to at least 1).  Yields (fields,
    cur0, limit, max_frames) as CPU tensors."""
    fields, cur0, limit = (torch.from_numpy(a) for a in _walk_batch(np.random.default_rng(seed + c), c))
    chain = int(sd.spec_walk_plain(fields, cur0, limit, c + 1).att[2])
    for mf in sorted({1, max(1, chain - 1), max(1, chain), c + 1}):
        yield fields, cur0, limit, mf


@pytest.mark.parametrize("c", WALK_CS)
def test_walk_tables_plant_what_they_say(c):
    for fields, cur0, limit, mf in walk_edge_tables(c):
        got = sd.spec_walk_plain(fields, cur0, limit, mf)
        att = got.att.tolist()
        assert att[1] == 0 and att[5] == 0                     # nothing exists / reachable
        assert att[3] == 1 and got.done[3] and got.pending[3] == fields[3, 0, 0]
        assert att[2] == min(mf, int(sd.spec_walk_plain(fields, cur0, limit, c + 1).att[2]))
        assert got.attempted[6, c // 2:].sum() == 0 or c == 1  # the limit cuts the table
        if c >= 32:
            assert att[4] >= 2 and att[2] >= 2 or mf == 1      # chains through duplicates


@pytest.mark.parametrize("c", WALK_CS)
def test_walk_plain_equals_jax_walks_at_the_edges(c):
    import jax.numpy as jnp

    from trackmaker_tpu.phy import pallas_decode as pd

    names = ("keep", "attempted", "cur_f", "done", "pending")
    for fields, cur0, limit, mf in walk_edge_tables(c):
        got = sd.spec_walk_plain(fields, cur0, limit, mf)
        args = (jnp.asarray(fields.numpy()), jnp.asarray(cur0.numpy()),
                jnp.asarray(limit.numpy()), mf)
        # the walk kernel keeps its state in lanes 0..3 of its third row, so
        # it takes tables of at least 4 candidates
        wants = [pd._spec_walk(*args)] + ([pd._spec_walk_smem(*args, interpret=True)]
                                          if c >= 4 else [])
        for want in wants:
            for name, g, w in zip(names, got, want):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f"{mf} {name}")
        np.testing.assert_array_equal(got.att.numpy(), got.attempted.numpy().sum(-1))


def test_walk_plain_takes_a_cap_of_zero_and_beyond_the_table():
    fields, cur0, limit, _ = next(walk_edge_tables(33))
    none = sd.spec_walk_plain(fields, cur0, limit, 0)
    assert not none.attempted.any() and not none.done.any()
    assert torch.equal(none.cur_f, cur0) or bool((cur0 < -1).any())
    far = sd.spec_walk_plain(fields, cur0, limit, 10**6)
    full = sd.spec_walk_plain(fields, cur0, limit, 34)
    assert all(torch.equal(f, g) for f, g in zip(far, full))


# --- the Manchester attempt ----------------------------------------------------


def _attempt_capture(rng) -> tuple[np.ndarray, list[int]]:
    """ATT_B rows of ATT_T samples: noise, and three frames in each row
    whose preambles start at the returned positions."""
    cfg = PhyConfig()
    enc = PhyEncoder(cfg, device="cpu")
    x = rng.normal(0, 0.3, (ATT_B, ATT_T)).astype(np.float32)
    starts = [1_003, 9_506, 22_001]
    for i, s in enumerate(starts):
        wave = enc.encode_frame(Frame.new_data(i, 1, 2, bytes([i + 3]) * 40)).numpy()
        x[:, s:s + len(wave)] += wave
    return x, starts


def attempt_edge_inputs(device="cpu"):
    """The four Manchester attempt forms' edge inputs, form -> (x, args) for
    ``attempt_manchester`` (legacy forms: cand, n_valid, vlen, sync,
    sync_e) or ``attempt_manchester_fold`` (fold forms: fs, n_valid).

    x f32[4, 40,003] starts one float past a 16-byte boundary, so its rows
    start at every offset mod 4; the shared forms read its row 0 expanded
    to 4 rows (row stride 0).  Row 0 holds 24 live slots: the three frames,
    starts at every offset mod 4, windows that end just before T, cross T
    by one sample and mid-body, a refine that crosses T, a base at T and
    past it; row 1 no live slot; row 2 nine, whose refines cross the valid
    length T - 5,000 at every position; row 3 more hits than slots."""
    rng = np.random.default_rng(14)
    x_np, starts = _attempt_capture(rng)
    t = ATT_T
    edge = [t - WINDOW - 42 - 1, t - WINDOW - 42 + 1, t - 6_000, t - 70, t - 43, t - 42,
            t - 1, t, t + 5, BIGI]
    row0 = starts + [500 + k for k in range(4)] + [30_001 + k for k in range(7)] + edge
    vlen = np.full(ATT_B, t, np.int32)
    vlen[2] = t - 5_000
    row2 = [int(vlen[2]) - 48 - 42 - k for k in (-2, 0, 1, 5, 11, 12, 13)] + starts[:2]
    cand = np.full((ATT_B, ATT_C), BIGI, np.int64)
    cand[0] = sorted(row0)
    cand[2, :len(row2)] = sorted(row2)
    cand[3] = np.sort(rng.integers(0, t, ATT_C))
    cand[1, :5] = starts + [7, 8]                  # present, but no slot is live
    n_valid = np.array([ATT_C, 0, len(row2), ATT_C + 5], np.int32)
    # the fold forms' frame starts: each legacy start's expected one, and
    # starts at every offset mod 4 near T and past it
    fs = np.minimum(cand, t) + 96
    fs[0, -8:] = [t - sd.FRAME_BYTES * 48 - 1, t - sd.FRAME_BYTES * 48,
                  t - sd.FRAME_BYTES * 48 + 1, t - 6_001, t - 2, t - 1, t, t + 3]
    buf = torch.zeros(ATT_B * t + 1)
    x = buf[1:].view(ATT_B, t)                     # a first sample off a 16-byte boundary
    x.copy_(torch.from_numpy(x_np))
    x = x.to(device)
    if x.device.type == "cuda":                    # keep the offset on the card
        on_card = torch.zeros(ATT_B * t + 1, device=device)
        x = on_card[1:].view(ATT_B, t).copy_(x)
    tens = {k: torch.from_numpy(np.ascontiguousarray(v).astype(np.int32)).to(device)
            for k, v in (("cand", cand), ("n_valid", n_valid), ("vlen", vlen), ("fs", fs))}
    sync = preamble_waveform(PhyConfig())[48:]
    legacy = (tens["cand"], tens["n_valid"], tens["vlen"], sync, preamble_energy(sync))
    fold = (tens["fs"], tens["n_valid"])
    shared = x[:1].expand(ATT_B, -1)
    return {"legacy": (x, legacy), "fold": (x, fold), "legacy shared": (shared, legacy),
            "fold shared": (shared, fold)}


def attempt_call(form: str):
    """The wrapper and the plain version of an attempt form."""
    if form.startswith("fold"):
        return sd.attempt_manchester_fold, sd.attempt_manchester_fold_plain
    return sd.attempt_manchester, sd.attempt_manchester_plain


def test_attempt_inputs_plant_what_they_say():
    inputs = attempt_edge_inputs()
    x, (cand, n_valid, vlen, _, _) = inputs["legacy"]
    t = x.shape[1]
    assert t % 4 and x.data_ptr() % 16 and inputs["legacy shared"][0].stride(0) == 0
    live = sd._live(cand, n_valid)
    base = torch.minimum(cand, torch.tensor(t)) + 42
    assert {int(v) for v in base[0] % 4} == {0, 1, 2, 3}
    assert {(x.data_ptr() // 4 + r * t) % 4 for r in range(ATT_B)} == {0, 1, 2, 3}
    assert int((live & (base < t) & (base + WINDOW > t)).sum()) >= 4     # windows across T
    assert int((live & (base >= t)).sum()) >= 3
    near_vlen = live[2] & (base[2] + 12 > vlen[2] - 48) & (base[2] <= vlen[2] - 48)
    assert int(near_vlen.sum()) >= 3                                     # refines across vlen
    assert n_valid.tolist()[1] == 0 and n_valid.tolist()[3] > ATT_C
    fs = inputs["fold"][1][0]
    assert {int(v) for v in fs[0] % 4} == {0, 1, 2, 3}
    body = sd.FRAME_BYTES * 48
    assert int(((fs[0] < t) & (fs[0] + body > t)).sum()) >= 4 and int((fs[0] >= t).sum()) >= 2


@pytest.mark.parametrize("form", ATTEMPT_FORMS)
def test_attempt_wrappers_run_the_plain_versions_on_the_cpu(form):
    x, args = attempt_edge_inputs()[form]
    wrapper, plain = attempt_call(form)
    before = (wrapper.launches, wrapper.shared_launches)
    got = wrapper(x, *args)
    want = plain(x, *args)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert (wrapper.launches, wrapper.shared_launches) == before
    live = sd._live(got[1], args[1])
    assert not got[0][~live].any() and not got[1][~live].any()


def _jax_attempt(x: np.ndarray, cand: np.ndarray, n_valid: np.ndarray, vlen: np.ndarray):
    """JAX's attempt kernel as _spec_phase_a launches it (interpret mode):
    bytes [B, C, 263] and fs [B, C]; slots past n_valid are unwritten."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    from trackmaker_tpu.phy import pallas_decode as pd

    b, t = x.shape
    c = cand.shape[1]
    sync = preamble_waveform(PhyConfig())[48:]
    t8, sync_e = pd._sync_tables(tuple(sync.tolist()), 13)
    r384 = -(-(t + 48) // pd.DROW) + pd.NR + 10
    x384 = jnp.pad(jnp.asarray(x), ((0, 0), (0, r384 * pd.DROW - t))).reshape(b, r384, pd.DROW)
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=4, grid=(b,),
        in_specs=[pl.BlockSpec(memory_space=pltpu.HBM)] + [pl.BlockSpec(memory_space=pltpu.VMEM)] * 3,
        out_specs=pl.BlockSpec((1, c, pd.BROWS, 128), lambda bb, *_: (bb, 0, 0, 0),
                               memory_space=pltpu.VMEM),
        scratch_shapes=[pltpu.VMEM((pd.ATTEMPT_PIPE, pd.NR, pd.DROW), jnp.float32),
                        pltpu.SemaphoreType.DMA((pd.ATTEMPT_PIPE,))])
    out = pl.pallas_call(
        functools.partial(pd._attempt_kernel, n_cand=c, t_max=t, sync_e=sync_e),
        out_shape=jax.ShapeDtypeStruct((b, c, pd.BROWS, 128), jnp.float32),
        grid_spec=grid_spec, interpret=True,
    )(jnp.asarray(cand), jnp.zeros_like(jnp.asarray(cand)), jnp.asarray(vlen),
      jnp.asarray(n_valid), x384, jnp.asarray(t8), jnp.asarray(pd._body_table()),
      jnp.asarray(pd._pack_table()))
    out = np.nan_to_num(np.asarray(out))
    byts = out[..., :8].reshape(b, c, pd.BROWS * 8)[..., :sd.FRAME_BYTES].astype(np.uint8)
    fs = np.minimum(cand, t) + out[:, :, pd.BROWS - 1, 8].astype(np.int32)
    return byts, fs


def test_attempt_plain_equals_jax_kernel_at_the_edges():
    x, (cand, n_valid, vlen, sync, sync_e) = attempt_edge_inputs()["legacy"]
    byts, fs = sd.attempt_manchester_plain(x, cand, n_valid, vlen, sync, sync_e)
    want_b, want_fs = _jax_attempt(x.contiguous().numpy(), cand.numpy(), n_valid.numpy(),
                                   vlen.numpy())
    live = sd._live(cand, n_valid).numpy()
    np.testing.assert_array_equal(fs.numpy()[live], want_fs[live])
    np.testing.assert_array_equal(byts.numpy()[live], want_b[live])
    # the frames decode: their headers name the payload's length
    for i in range(3):
        slot = int((cand[0] == [1_003, 9_506, 22_001][i]).nonzero()[0, 0])
        assert byts[0, slot, 1] == 40 and (byts[0, slot, 7:47] == i + 3).all()


# --- the experiment's variants (tools/exp_walk_attempt.py) ------------------------


@pytest.mark.parametrize("key", list(ew.VARIANTS), ids="-".join)
def test_experiment_variants_patch_the_kept_sources(key):
    """Each variant's anchors lie once in the kept source, and its patch
    leaves a source that still holds the kernel and its entry points."""
    src, _ = key
    kept = (_build.CSRC / f"{src}.cu").read_text()
    text = ew.patched(src, ew.VARIANTS[key])
    assert text != kept
    for _, _, new in ew.VARIANTS[key]:
        assert new in text
    for symbol in (f"{src}_kernel", f"extern \"C\" int tm_{src}("):
        assert symbol in text
    with pytest.raises(ValueError):
        ew.patched(src, [("no such line", "no such line", "")])
