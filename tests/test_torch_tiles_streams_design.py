"""The attempt-tile kernel's (#13) grouped schedule and the two-stream
correlation's (#15) staged buffer, held on the CPU at their edges against
the plain versions and the JAX package.

The attempt-tile kernel (``csrc/attempt_tiles.cu``) gives a block GROUP
consecutive candidates of one capture.  A warp computes a candidate's
sync: lane (l, h) sums its two products with x row h in four chunks at
once, adds the chunks in order, a shuffle forms dot and en, and a
butterfly of shuffles takes the first lane of largest cc.  The body rows
and the table rows come through a ring of `pipe` stages, a stage being
one candidate's 12 table rows and its 35 body rows of x over the same 12
columns (noop: the x rows of its first 12 columns, from row 0; ``_nodma``:
x from device memory, the table through a ring of two), stage s + pipe -
1 copied while stage s computes; the pack borrows the stage the body
just freed for the bits of all 34 rows.  Each candidate's dot[0] and
block[0, 0] go to a scratch, the blocks arrive in any order, and the last
of a capture adds the scratch in candidate order to out[b, 0].
:func:`grouped_tiles` is that schedule in tensor ops, the ring a tensor
of slots written and read in the kernel's order, the pack's passes
overwriting the freed slot (a slot read before it is staged again would
feed the poison to a body), the arrivals in a shuffled order.  Here it
equals ``attempt_tiles_plain`` bit for bit on the tool's normal corpus
(two captures) for ``_u1``, ``_u2``, ``_u5``, ``_u13`` and ``_u65``,
groups of 2, 3 and 65 (neither of the first two divides 65),
``_nostore``, ``noop`` and ``_nodma``, rings of 1-4 and every kind.  The
body's arithmetic (each acc in k order, then acc_a + acc_b) is computed
once for each set of rows a schedule delivers, and reused when another
schedule delivers the same rows.

The two-stream kernel (``csrc/xcorr_streams.cu``) stages a tile of 1,024
lags from the first stream and the 128 samples after it from the second
into the padded layout sx() of ``csrc/xcorr_tile.cuh``, zero-fills the 8
staged samples past them, and sums each thread's 8 lags from windows of
16 staged samples, taps 8 a step.  :func:`staged_buffers` builds that
buffer (the padding NaN, and the 8 past the halo NaN on request) and
:func:`tap_operands` reads each lag's taps through the kernel's windows.
Here the operands equal the capture's samples exactly (zero past T) and
are finite with the 8 set to NaN, so no tap reads them; the rows from
them equal ``xcorr_hits_2s_plain``'s, kernel #1's plain rows and JAX's
``pallas_xcorr_hits`` (interpret mode) at L in STREAM_LS and T in
STREAM_TS, with a hit at the last lag.

``tests/test_torch_kernels_gpu.py`` and ``chip_smoke.py`` hold the kernels
against their plain versions on the same inputs on a card; this module
imports JAX only inside its tests, so they can import the builders without
it.

Tolerances: none for the attempt tiles (the tool's tables make every
product exact and both sum in k order).  The streams' corr from the
operands is summed in float64 here and by ``conv1d`` in the plain
version: within 1e-5, and the rows equal but for rows holding a lag
within 1e-5 of the threshold."""

import math

import numpy as np
import pytest
import torch

from trackmaker_tpu_torch import _build
from trackmaker_tpu_torch.dsp.filters import matmul_f32
from trackmaker_tpu_torch.sync import correlate
from trackmaker_tpu_torch.sync.xcorr_hits import ROW_LAGS, hit_rows_plain, xcorr_hits_plain
from trackmaker_tpu_torch.tools import exp_attempt_tiles as et
from trackmaker_tpu_torch.tools import exp_tiles_streams as ets
from trackmaker_tpu_torch.tools import exp_xcorr_streams as ex

# --- the attempt tiles (#13) ------------------------------------------------------

GROUP = et.GROUP
CHUNK = et.STAGE_COLS                # k a stage (the sync's chunks are 96)
CHUNKS = et.DROW // CHUNK
SYNC_HALF = 16                       # the lanes of a half-warp
SYNC_CHUNKS = et.SYNC_CHUNKS
SYNC_CHUNK = et.DROW // SYNC_CHUNKS
TILE_RINGS = (1, 2, 3, 4)
# (variant, ring, group): the edges the kernel's schedule must hold
TILE_CASES = (
    ("base_u1", 4, GROUP), ("base_u2", 4, GROUP), ("base_u5", 4, GROUP),
    ("base_u13", 4, GROUP), ("base_u65", 4, GROUP),
    ("base", 4, 3), ("base", 4, et.NV), ("base_u2", 2, 3),
    ("base_nostore", 4, GROUP), ("noop", 4, GROUP), ("noop", 1, 3), ("base_nodma", 4, GROUP),
    ("base", 1, GROUP), ("base", 2, GROUP), ("base", 3, GROUP),
    ("n128_nostore_u3", 2, GROUP), ("sync1", 4, GROUP), ("both_nodma", 1, 3),
    ("bf16b", 3, GROUP), ("bf16b_nodma_nostore", 4, GROUP))
# the variants the card runs on the edge input, each at every ring
TILE_EDGE_VARIANTS = ("base_u1", "base_u2", "base_u5", "base_u13", "base_u65", "base_nostore",
                      "noop", "base_nodma", "n128_nostore_u3", "sync1", "both_nodma", "bf16b",
                      "bf16b_nodma_nostore")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def tile_edge_input(device="cpu"):
    """The tool's normal corpus, two captures."""
    return et.tool_input(device, b=2)


def _bf16(a: torch.Tensor) -> torch.Tensor:
    return a.to(torch.bfloat16).to(torch.float32)


def sync_warps(spec: et.Variant, x: torch.Tensor, ts: torch.Tensor, tsc: torch.Tensor):
    """(dot0 f32[B, n], best int64[B, n]) by the kernel's warp: lane (l, h)
    sums x row h against its dot column and, squared, its energy column,
    four chunks of 96 at once, then adds the chunks in order; lane l takes
    dot = its S0 + lane l + 16's S1 (en likewise); the first lane of
    largest cc by a butterfly over the half-warp, lanes 13-15 at -inf."""
    n = spec.n_cand
    c = torch.arange(n)
    x01 = x[:, (9 * (c % 8))[:, None] + torch.arange(2)]          # [B, n, 2 (h), 384]
    q = 37 * c % et.DROW
    v = q % 8
    slab = (q - v)[:, None] + torch.arange(et.DROW)
    l = torch.arange(SYNC_HALF)
    h = torch.arange(2)[:, None]
    if spec.merged:
        tab = tsc[v[:, None], slab]                                  # [n, 384, 128]
        t_dot, t_en = tab[:, :, 32 * h + l], tab[:, :, 64 + 32 * h + l]
    else:
        tab = ts[v[:, None], slab]                                   # [n, 384, 256]
        t_dot = tab[:, :, 128 * h + l]
        t_en = t_dot * t_dot
    pd = torch.zeros(x.shape[0], n, 2, SYNC_HALF, SYNC_CHUNKS)
    pe = torch.zeros_like(pd)
    ks = torch.arange(SYNC_CHUNKS) * SYNC_CHUNK
    for kk in range(SYNC_CHUNK):
        xv = x01[:, :, :, None, ks + kk]                             # [B, n, 2, 1, 4]
        pd = pd + xv * t_dot[:, ks + kk].permute(0, 2, 3, 1)
        pe = pe + (xv * xv) * t_en[:, ks + kk].permute(0, 2, 3, 1)
    sd, se = pd[..., 0], pe[..., 0]
    for ch in range(1, SYNC_CHUNKS):
        sd = sd + pd[..., ch]
        se = se + pe[..., ch]
    dot = sd[:, :, 0] + sd[:, :, 1]
    en = se[:, :, 0] + se[:, :, 1]
    top = torch.where(l < et.SYNC_LANES, dot * torch.reciprocal(torch.sqrt(en.clamp(min=1e-6))),
                      -math.inf)
    at = l.expand_as(top)
    for off in (8, 4, 2, 1):
        o, oi = top[..., l ^ off], at[..., l ^ off]
        take = (o > top) | ((o == top) & (oi < at))
        top, at = torch.where(take, o, top), torch.where(take, oi, at)
    return dot[..., 0], at[..., 0]


_bodies: dict = {}


def _tile_bits(spec: et.Variant, rows: torch.Tensor, u_rows: torch.Tensor) -> torch.Tensor:
    """bits f32[B, n, 34, P] of the bodies on the rows of x f32[B, n, 35,
    384] and of the table f32[B, n, 384, N] that each candidate's stages
    delivered: acc_a and acc_b each in k order, one rounded product and sum
    a term, then acc_a + acc_b <= 0; computed once for each (kind, rows)."""
    key = (spec.kind, rows.shape)
    hit = _bodies.get(key)
    if hit is not None and torch.equal(hit[0], rows) and torch.equal(hit[1], u_rows):
        return hit[2]
    half = u_rows.shape[-1] // 2
    acc_a = torch.zeros(rows.shape[:2] + (et.BROWS, half))
    acc_b = torch.zeros_like(acc_a)
    for k in range(et.DROW):
        u = u_rows[:, :, k]                                          # [B, n, N]
        acc_a = acc_a + rows[:, :, :et.BROWS, k, None] * u[:, :, None, :half]
        acc_b = acc_b + rows[:, :, 1:, k, None] * u[:, :, None, half:]
    bits = ((acc_a + acc_b) <= 0.0).to(torch.float32)
    _bodies[key] = (rows.clone(), u_rows.clone(), bits)
    return bits


def grouped_tiles(variant: str, x, ts, tsc, tb, tbn, w, wn, pipe: int = et.PIPE,
                  group: int = GROUP, seed: int = 0, lead: int = 0) -> torch.Tensor:
    """out f32[B, 65, 34, 128] by csrc/attempt_tiles.cu's schedule (see the
    module docstring), the blocks of a capture arriving in an order
    shuffled from `seed`; `lead` issues each copy that many stages early
    (a broken ring, for the check that the ring carries the rows)."""
    spec = et.parse_variant(variant)
    et.stage_smem(spec, pipe)
    noop = spec.kind == "noop"
    if not spec.stage:
        pipe = et.NODMA_PIPE            # the table's ring alone
    b, n = x.shape[0], spec.n_cand
    n_blocks = -(-n // group)
    per = 1 if noop else CHUNKS
    table = tbn if spec.n128 else tb
    width = table.shape[-1]
    out = torch.zeros((b, et.NV, et.BROWS, et.LANES))
    part = torch.full((b, et.NV, 2), math.nan)
    blk = torch.arange(n_blocks)
    if not noop:
        dot0, best = sync_warps(spec, x, ts, tsc)
        c_all = torch.arange(n)
        o2 = (53 * c_all + best) % et.DROW                            # [B, n]
        u_first = (o2 % 8) * et.TROWS + o2 - o2 % 8                   # the table row of U[0]
        flat = table.reshape(-1, width)

    def stage_rows(s: int):
        """Stage s of every block: x f32[B, blocks, 35, 12] and U f32[B,
        blocks, 12, N], NaN where a block has no such stage."""
        c = blk * group + s // per
        live = c < n
        cc = c.clamp(max=n - 1)
        first = 9 * (cc % 8) + (0 if noop else cc % 2)
        cols = (s % per) * CHUNK + torch.arange(CHUNK)
        xs = x[:, (first[:, None] + torch.arange(et.STAGE_ROWS))[..., None], cols]
        xs[:, ~live] = math.nan
        if noop:
            return xs, None
        us = flat[u_first[:, cc][..., None] + cols]                   # [B, blocks, 12, N]
        us[:, ~live] = math.nan
        return xs, us

    ring_x = torch.full((pipe, b, n_blocks, et.STAGE_ROWS, CHUNK), math.nan)
    ring_u = torch.full((pipe, b, n_blocks, CHUNK, width), math.nan)

    def issue(s: int) -> None:
        if s < group * per:
            xs, us = stage_rows(s)
            if spec.stage:
                ring_x[s % pipe] = xs
            if us is not None:
                ring_u[s % pipe] = us

    for s in range(pipe - 1):
        issue(s)

    def acquire(s: int):
        """(x, U) of stage s: x from the ring (``_nodma``: from device
        memory), rounded in place for bf16b."""
        issue(s + pipe - 1 + lead)
        if spec.kind == "bf16b":           # the stage rounded in place once it lands
            ring_x[s % pipe] = _bf16(ring_x[s % pipe])
            ring_u[s % pipe] = _bf16(ring_u[s % pipe])
        xs = ring_x[s % pipe]
        if not spec.stage:
            xs = stage_rows(s)[0]
            xs = _bf16(xs) if spec.kind == "bf16b" else xs
        return xs, ring_u[s % pipe]

    if noop:
        for g in range(group):
            c = blk * group + g
            live = c < n
            xs = (acquire(g)[0] if spec.stage else stage_rows(g)[0])[:, live]
            s = torch.zeros(b, int(live.sum()))
            for j in range(8):
                s = s + xs[:, :, 0, j]
            part[:, c[live], 0] = s
            part[:, c[live], 1] = 0.0
    else:
        rows = torch.full((b, n, et.STAGE_ROWS, et.DROW), math.nan)
        u_rows = torch.full((b, n, et.DROW, width), math.nan)
        for g in range(group):
            c = blk * group + g
            live = c < n
            for q in range(CHUNKS):
                xs, us = acquire(g * CHUNKS + q)
                cols = slice(q * CHUNK, (q + 1) * CHUNK)
                rows[:, c[live], :, cols] = xs[:, live]
                u_rows[:, c[live], cols] = us[:, live]
            last = (g * CHUNKS + CHUNKS - 1) % pipe    # the pack's passes overwrite it
            ring_x[last] = -7.0
            ring_u[last] = -7.0
        bits = _tile_bits(spec, rows, u_rows)
        wm = wn if spec.n128 else w
        assert et.BROWS * bits.shape[-1] <= et.STAGE_BYTES // 4     # the bits fit the slot
        blocks = matmul_f32(bits, wm)
        if spec.store:
            out[:, :n] = blocks
        part[:, :n, 0] = dot0
        part[:, :n, 1] = blocks[:, :, 0, 0]
    # the arrivals: the last block of each capture sums the scratch in order
    count = torch.zeros(b, dtype=torch.int64)
    order = np.random.default_rng(seed).permutation(n_blocks)
    for k, blk_id in enumerate(order):
        count += 1
        assert blk_id * group < n
        if k == n_blocks - 1:
            assert bool((count == n_blocks).all())
            acc = torch.zeros(b)
            for c in range(n):
                acc = acc + part[:, c, 0]
                if not noop and not spec.store:
                    acc = acc + part[:, c, 1]
            out[:, 0] = out[:, 0] + acc[:, None, None]
            count[:] = 0
    return out


@pytest.fixture(scope="module")
def tiles():
    """(inputs, {variant: plain output})."""
    return tile_edge_input(), {}


def _plain(tiles, variant: str) -> torch.Tensor:
    """The plain version's output, once for each function (``_nodma`` and
    the ``_uN`` that keep 65 candidates compute the same one)."""
    inputs, cache = tiles
    spec = et.parse_variant(variant)
    key = (spec.kind, spec.store, spec.n_cand)
    if key not in cache:
        cache[key] = et.attempt_tiles_plain(variant, *inputs)
    return cache[key]


def test_sync_warps_equal_the_plain_sync():
    inputs = tile_edge_input()
    for kind in ("base", "sync1"):
        spec = et.parse_variant(kind)
        dot, _, cc, best = et.sync_plain(spec, *inputs[:3])
        dot0, best_w = sync_warps(spec, *inputs[:3])
        assert torch.equal(dot0, dot[..., 0]) and torch.equal(best_w, best), kind
        assert len(set(best.reshape(-1).tolist())) > 4           # many lanes win


def test_butterfly_keeps_the_first_lane_of_a_tie():
    """Candidate 0's lanes 3 and 5..12 equal, lanes 0..2 and 4 their
    negation: nine lanes tie at the largest cc when lane 3's is positive,
    four when it is negative, and the butterfly keeps lane 3 or lane 0, as
    the plain version's argmax does."""
    spec = et.parse_variant("base")
    x, ts, tsc, *_ = tile_edge_input()
    ts = ts.clone()
    q = 0                                   # candidate 0: q = 37 * 0 % 384
    for col0 in (0, 128):
        src = ts[0, q:q + et.DROW, col0 + 3].clone()
        for lane in range(et.SYNC_LANES):
            ts[0, q:q + et.DROW, col0 + lane] = -src if lane in (0, 1, 2, 4) else src
    _, _, cc, best = et.sync_plain(spec, x, ts, tsc)
    _, best_w = sync_warps(spec, x, ts, tsc)
    assert torch.equal(best_w, best)
    for r in range(x.shape[0]):
        assert cc[r, 0, 3] == cc[r, 0, 9] and cc[r, 0, 0] == cc[r, 0, 4] != 0
        assert int(best_w[r, 0]) == (3 if cc[r, 0, 3] > 0 else 0)


@pytest.mark.parametrize("variant,pipe,group", TILE_CASES, ids=lambda v: str(v))
def test_grouped_tiles_equal_plain(tiles, variant, pipe, group):
    inputs, _ = tiles
    got = grouped_tiles(variant, *inputs, pipe=pipe, group=group, seed=pipe + group)
    assert torch.equal(got, _plain(tiles, variant)), (variant, pipe, group)


def test_a_ring_that_hands_out_a_slot_early_shows():
    """The ring carries the rows: a copy issued one stage too soon
    overwrites the slot about to be read, and the sums differ."""
    inputs = tile_edge_input()
    want = et.attempt_tiles_plain("noop", *inputs)
    for pipe in TILE_RINGS:
        assert torch.equal(grouped_tiles("noop", *inputs, pipe=pipe, group=13), want)
        assert not torch.equal(grouped_tiles("noop", *inputs, pipe=pipe, group=13, lead=1), want)


def test_tile_wrapper_runs_the_plain_version_on_the_cpu():
    inputs = tile_edge_input()
    before = et.attempt_tiles.launches
    got = et.attempt_tiles("base_u13", *inputs, pipe=1)
    assert et.attempt_tiles.launches == before
    assert torch.equal(got, grouped_tiles("base_u13", *inputs, pipe=1))


# --- the two streams (#15) --------------------------------------------------------

STREAM_LS = (2, 7, 8, 9, 96, 127, 128, 129)
STREAM_TS = (129, 1024, 1025, 1152, 1153, 50_001)
STREAM_THR = 0.5
TILE = 8 * ROW_LAGS                  # lags a block
HALO = ROW_LAGS                      # samples the second stream gives past the tile
TAPS = ex.TAPS                       # the last step's reach past the tile
LAGS_A_THREAD, TAPS_A_STEP, WINDOW = 8, 8, 16


def sx(i):
    """csrc/xcorr_tile.cuh's padded index: 4 floats after every 32."""
    return i + ((i >> 5) << 2)


STAGED = int(sx(TILE + TAPS))


def stream_edge_input(l: int, t: int, device="cpu", seed: int = 17):
    """(x f32[2, t], pattern f32[l]): capture 0 noise of sigma 0.05 with the
    pattern planted at the last lag and, where they do not overlap it, at
    lag 0 and mid-capture; capture 1 unit noise.  The pattern is +-1 from
    `seed`."""
    rng = np.random.default_rng(seed + 1000 * l + t)
    pattern = np.where(rng.normal(size=l) < 0, -1.0, 1.0).astype(np.float32)
    x = np.stack([rng.normal(0, 0.05, t), rng.normal(0, 1, t)]).astype(np.float32)
    last = t - l
    starts = [last] + ([0] if last >= l else []) + ([last // 2] if last >= 2 * l + 1 else [])
    for s in starts:
        x[0, s:s + l] += pattern
    return torch.from_numpy(x).to(device), pattern


def staged_buffers(x: torch.Tensor, tail: float = 0.0) -> torch.Tensor:
    """f32[B, n_tiles, STAGED]: each block's buffer as the kernel stages it:
    the tile from the first stream, the 128 samples after it from the
    second, `tail` in the 8 staged past them, NaN in the padding."""
    xp, xs = ex.two_streams(x)
    b, p = xp.shape
    nt = p // TILE
    buf = torch.full((b, nt, STAGED), math.nan)
    buf[:, :, sx(torch.arange(TILE))] = xp.reshape(b, nt, TILE)
    buf[:, :, sx(TILE + torch.arange(HALO))] = xs.reshape(b, nt, TILE)[:, :, TILE - HALO:]
    buf[:, :, sx(TILE + HALO + torch.arange(TAPS - HALO))] = tail
    return buf


def window_index(l: int) -> torch.Tensor:
    """int64[128, steps, 16]: the staged index of each window value a
    thread loads a step, as load_step reads it (4 float4s from sx(s), s =
    8 t + j0, each shifted past the padding it crosses)."""
    steps = -(-l // TAPS_A_STEP)
    s = (LAGS_A_THREAD * torch.arange(128))[:, None] + TAPS_A_STEP * torch.arange(steps)
    q4 = torch.arange(0, WINDOW, 4)
    start = sx(s)[..., None] + q4 + ((((s & 31)[..., None] + q4) >> 5) << 2)
    return (start[..., None] + torch.arange(4)).reshape(128, steps, WINDOW)


def tap_operands(buf: torch.Tensor, l: int) -> torch.Tensor:
    """f32[B, n_tiles * 1024, L]: the staged sample tap j of each lag reads:
    lag 8 t + k at tap j0 + m (m < min(8, L - j0)) reads window[m + k] of
    thread t's step j0."""
    win = buf[:, :, window_index(l)]                                 # [B, nt, 128, steps, 16]
    k = torch.arange(LAGS_A_THREAD)[:, None]
    m = torch.arange(TAPS_A_STEP)[None, :]
    ops = win[..., m + k]                                            # [B, nt, 128, steps, 8k, 8m]
    b, nt, steps = buf.shape[0], buf.shape[1], win.shape[3]
    ops = ops.permute(0, 1, 2, 4, 3, 5).reshape(b, nt * TILE, steps * TAPS_A_STEP)
    return ops[..., :l]


def staged_rows(x: torch.Tensor, pattern: np.ndarray, threshold: float, epilogue: bool = True,
                tail: float = 0.0) -> torch.Tensor:
    """The two-stream rows from the tap operands of the staged buffers:
    dot and energy summed in float64, corr in f32 as the kernel divides."""
    t, l = x.shape[1], len(pattern)
    ops = tap_operands(staged_buffers(x, tail), l)[:, :t - l + 1].double()
    p = torch.from_numpy(pattern).double()
    dot = (ops * p).sum(-1).float()
    energy = (ops * ops).sum(-1).float()
    pe = torch.tensor(correlate.preamble_energy(pattern), dtype=torch.float32)
    corr = torch.where(energy < correlate.EPS, 0.0,
                       dot / (torch.sqrt(energy.clamp(min=0.0)) * pe).clamp(min=1e-30))
    n_rows = -(-t // ROW_LAGS)
    return hit_rows_plain(corr, n_rows, threshold) if epilogue else ex.noep_plain(corr, n_rows)


def _near_rows(corr_p, thr, n_rows):
    near = torch.nn.functional.pad((corr_p - thr).abs() < 1e-5, (0, n_rows * 128 - corr_p.shape[1]))
    return near.reshape(corr_p.shape[0], n_rows, 128).any(-1)


def assert_rows_agree(got, want, corr_p, thr):
    """Equal but for rows holding a lag within 1e-5 of thr; the hit corr
    within 1e-5 elsewhere."""
    same = (got[..., :5] == want[..., :5]).all(-1) & (got[..., 9:] == want[..., 9:]).all(-1)
    assert bool((same | _near_rows(corr_p, thr, got.shape[1])).all())
    vals = (got[..., 5:9].contiguous().view(torch.float32)
            - want[..., 5:9].contiguous().view(torch.float32))[same]
    assert vals.numel() == 0 or vals.abs().max().item() <= 1e-5


def test_stream_inputs_plant_a_hit_at_the_last_lag():
    for l in STREAM_LS:
        for t in STREAM_TS:
            x, pattern = stream_edge_input(l, t)
            corr = ex.normalized_xcorr_dense_plain(x, pattern)
            assert corr[0, t - l] >= STREAM_THR, (l, t)


def test_pieces_land_whole_and_aligned():
    """Every piece of 4 samples lands on 4 contiguous floats from a 16-byte
    boundary of sx(), so a 16-byte copy puts it where the tile reads it."""
    i = torch.arange(0, TILE + TAPS, 4)
    assert bool((sx(i) % 4 == 0).all()) and bool((sx(i + 3) == sx(i) + 3).all())
    assert int(sx(TILE + TAPS - 1)) + 1 == STAGED


@pytest.mark.parametrize("l", STREAM_LS)
def test_windows_read_the_staged_samples(l):
    """Window value q of step j0 of thread t is staged sample 8 t + j0 + q,
    and the last step reaches round_up(L, 8) samples past the tile."""
    idx = window_index(l)
    s = (8 * torch.arange(128))[:, None, None] + 8 * torch.arange(idx.shape[1])[:, None] \
        + torch.arange(WINDOW)
    assert torch.equal(idx, sx(s))
    assert int(s.max()) == TILE - 1 + -(-l // 8) * 8


@pytest.mark.parametrize("l", STREAM_LS)
def test_tap_operands_are_the_capture_s_samples(l):
    """Each lag's tap j reads x[lag + j] (zero past T) exactly, and with the
    8 staged samples past the halo set to NaN no operand is NaN."""
    for t in STREAM_TS:
        x, _ = stream_edge_input(l, t)
        ops = tap_operands(staged_buffers(x, tail=math.nan), l)
        nt = ops.shape[1] // TILE
        xz = torch.nn.functional.pad(x, (0, nt * TILE + TAPS - t))
        want = xz.unfold(1, l, 1)[:, :nt * TILE]
        assert bool(torch.isfinite(ops).all()), (l, t)
        assert torch.equal(ops, want), (l, t)


@pytest.mark.parametrize("l", STREAM_LS)
def test_staged_rows_equal_plain_and_kernel_1(l):
    for t in STREAM_TS:
        x, pattern = stream_edge_input(l, t)
        corr_p = ex.normalized_xcorr_dense_plain(x, pattern)
        for tail in (0.0, math.nan):
            got = staged_rows(x, pattern, STREAM_THR, tail=tail)
            want = ex.xcorr_hits_2s_plain(x, pattern, STREAM_THR)
            assert_rows_agree(got, want, corr_p, STREAM_THR)
            if l <= 128:
                assert_rows_agree(got, xcorr_hits_plain(x, pattern, STREAM_THR)[1], corr_p,
                                  STREAM_THR)
            noep = staged_rows(x, pattern, STREAM_THR, epilogue=False, tail=tail)
            edge = ex.noep_plain(((corr_p.abs() - 1.0).abs() < 1e-5).float(), noep.shape[1]) > 0
            assert bool(((noep == ex.xcorr_hits_2s_plain(x, pattern, STREAM_THR, False))
                         | edge).all()), (l, t)
        n_lags = t - l + 1
        assert int(got[0, (n_lags - 1) // ROW_LAGS, 4]) >= 1          # the hit at the last lag


@pytest.mark.parametrize("l,t", [(9, 1153), (129, 1153)])
def test_staged_rows_equal_jax(l, t):
    import jax
    import jax.numpy as jnp

    from trackmaker_tpu.sync.pallas_xcorr import pallas_xcorr_hits

    x, pattern = stream_edge_input(l, t)
    _, want = jax.vmap(lambda s: pallas_xcorr_hits(
        s, pattern, STREAM_THR, rpb=4, emit_corr=False, interpret=True))(jnp.asarray(x.numpy()))
    n_rows = -(-t // ROW_LAGS)
    want = torch.from_numpy(np.asarray(want)[:, :n_rows].copy())
    corr_p = ex.normalized_xcorr_dense_plain(x, pattern)
    assert_rows_agree(staged_rows(x, pattern, STREAM_THR), want, corr_p, STREAM_THR)


def test_stream_wrapper_runs_the_plain_version_on_the_cpu():
    before = ex.xcorr_hits_2s.launches
    for l in (2, 129):
        x, pattern = stream_edge_input(l, 1153)
        for epilogue in (True, False):
            assert torch.equal(ex.xcorr_hits_2s(x, pattern, STREAM_THR, epilogue),
                               ex.xcorr_hits_2s_plain(x, pattern, STREAM_THR, epilogue))
    assert ex.xcorr_hits_2s.launches == before
    taps = correlate.pack_taps(np.ones(129, np.float32), ex.TAPS)
    assert taps.shape == (136,) and taps[:129].all() and not taps[129:].any()


# --- the experiment's variants (tools/exp_tiles_streams.py) -------------------------


@pytest.mark.parametrize("key", [k for k, v in ets.VARIANTS.items() if v], ids="-".join)
def test_experiment_variants_patch_the_kept_sources(key):
    """Each variant's anchors lie once in the kept source, and its patch
    leaves a source that still holds the kernel and its entry point."""
    src, _ = key
    kept = (_build.CSRC / f"{src}.cu").read_text()
    text = ets.patched(src, ets.VARIANTS[key])
    assert text != kept
    for _, _, new in ets.VARIANTS[key]:
        assert new in text
    kernel = ets.KERNEL_FNS[src]
    entry = {"attempt_tiles": "tm_attempt_tiles", "xcorr_streams": "tm_xcorr_hits_2s"}[src]
    for symbol in (kernel, f"extern \"C\" int {entry}("):
        assert symbol in text


def test_empty_grids_are_the_kernels():
    grids = dict((what, (blocks, threads)) for what, blocks, threads in ets.empty_grids())
    assert grids["#13 attempt_tiles"] == (32 * 33, 128)
    assert grids["#15 xcorr_hits_2s"] == (32 * 424, 128)
    assert grids["#12 seq_probe"] == (128, 64)
    assert grids["#14 offset_add A"] == grids["#14 offset_add C"] == (64, 256)
    assert grids["#14 offset_add B"] == (16, 256)
