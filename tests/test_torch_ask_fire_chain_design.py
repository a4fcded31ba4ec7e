"""The ASK record chain's and fire rule's algorithms, held on the CPU at their
edges against the plain versions and the JAX package.

The record-chain kernel (``csrc/ask_chain.cu``) reads a tile of TILE
columns at once, a lane holding a contiguous segment of SEG of them, and
resolves the chain by two exclusive warp max-scans (the carry m from each
segment's maximum, the carry rec from each segment's last update, which is
the first position of its maximum where that exceeds m) and a walk of each
segment from both carries to its first fire; rows wider than a tile carry
m and rec from tile to tile.  :func:`chain_segments` is that algorithm in
tensor ops.  Here it equals the plain version (``phy/ask.py:
ask_chain_plain``) and JAX's ``_chain_kernel_call`` (interpret mode) on
the rows of :func:`chain_edge_rows` at every width of CHAIN_WS and both
guards of CHAIN_GUARDS: rows of all -inf, a lone update, equal values on
both sides of a segment edge and of a tile edge, fires exactly at the
guard, at the first column after a segment edge and after a tile edge and
at the last column, and a row that never fires.

The fire-rule kernel (``csrc/ask_fire.cu``) stages a tile of FIRE_TILE
positions and the w after them from where the flattened index is a
multiple of 4, as rows of 128 cut into blocks of the largest power of two
<= w (at most 128), and assembles each window maximum from the block
suffix maximum after the position, the block maxima in between and the
block prefix maximum at the window's end.  :func:`fire_tiles` is that
algorithm in tensor ops.  Here it equals the plain version
(``phy/ask_spec.py:dense_fire_candidates_plain``), the naive rule where
the window is small enough to slide in numpy, JAX's ``_fire_kernel_call``
(interpret mode) where JAX takes it (128 < w <= 256) and JAX's XLA forms
of ``dense_fire_candidates`` for the other w, on :func:`fire_edge_inputs`
at every w of FIRE_WS and T of FIRE_TS: three captures (30% of ``upd``
set, all set, none set) on sync quantized to eighths, so that equal values
meet at the windows' ends (the rule is ``>=``), of odd and even T, whose
rows start at every offset mod 4.

``tests/test_torch_kernels_gpu.py`` and ``chip_smoke.py`` hold the kernels
against their plain versions on the same inputs on a card; this module
imports JAX only inside its tests, so they can import the builders without
it.

Tolerances: none.  Max, compare and integers only, so every comparison is
exact."""

import dataclasses
import math

import numpy as np
import pytest
import torch

from trackmaker_tpu_torch import _build
from trackmaker_tpu_torch.phy import ask, ask_spec
from trackmaker_tpu_torch.tools import exp_fire_chain as efc

NEGB = -(2**30)
SEG, TILE = 32, 1024                 # csrc/ask_chain.cu's kSeg and kTile
CHAIN_WS = (1, 31, 32, 33, 512, 1000, 1024, 1025, 4096)
CHAIN_GUARDS = (200, 3)
# rows of every chain edge input, in order
CHAIN_ROWS = ("random", "all -inf", "lone update", "tie at a segment edge", "tie at a tile edge",
              "fire at the guard", "fire after a segment edge", "fire after a tile edge",
              "fire at the last column", "never fires")
FIRE_TILE = 4096                     # csrc/ask_fire.cu's kTile
FIRE_WS = (1, 2, 127, 128, 129, 201, 256, 257, 1000, 11264)
FIRE_TS = (1, 127, 128, 129, 4095, 4096, 4097, "4096+w", 339_453)
FIRE_PATTERNS = ("30% set", "all set", "none set")
FIRE_MAX_W = 53_500                  # the largest w a block's 227 KB holds on an H100
ACFG = ask.AskConfig()


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# --- the record chain -------------------------------------------------------------


def chain_segments(vals: torch.Tensor, base: torch.Tensor, guard: int, seg: int = SEG,
                   tile: int = TILE):
    """(fired bool[N], peak int32[N]) by csrc/ask_chain.cu's algorithm: tiles
    of `tile` columns, lanes of `seg` contiguous ones, the carries m and rec
    by exclusive max-scans over the lanes, each lane's walk to its first
    fire, the first lane that fires; the carries move on to the next tile
    only while no lane has fired."""
    n, win = vals.shape
    lanes = tile // seg
    n_tiles = -(-win // tile)
    v = torch.nn.functional.pad(vals, (0, n_tiles * tile - win), value=-math.inf)
    v = v.reshape(n, n_tiles, lanes, seg)
    lane = torch.arange(lanes, dtype=torch.int32)
    carry_m = torch.full((n,), -math.inf)
    carry_rec = torch.full((n,), NEGB, dtype=torch.int32)
    done = torch.zeros(n, dtype=torch.bool)
    pk = torch.full((n,), NEGB, dtype=torch.int32)
    for t in range(n_tiles):
        x = v[:, t]
        smax = x.amax(-1)
        first = (x == smax[..., None]).int().argmax(-1).to(torch.int32)   # first position of it
        pre_m = torch.nn.functional.pad(smax.cummax(-1).values[:, :-1], (1, 0), value=-math.inf)
        m0 = torch.maximum(carry_m[:, None], pre_m)
        idx0 = base[:, None] + t * tile + lane * seg
        last = torch.where(smax > m0, idx0 + first, NEGB)
        pre_rec = torch.nn.functional.pad(last.cummax(-1).values[:, :-1], (1, 0), value=NEGB)
        rec = torch.maximum(carry_rec[:, None], pre_rec)
        m = m0
        hit = torch.zeros(n, lanes, dtype=torch.bool)
        hit_rec = torch.full((n, lanes), NEGB, dtype=torch.int32)
        lim = win - t * tile - lane * seg
        for k in range(seg):
            idx = idx0 + k
            upd = x[..., k] > m
            fire = ~upd & (k < lim) & (idx > rec + guard) & (m > -math.inf)
            hit_rec = torch.where(fire & ~hit, rec, hit_rec)
            hit = hit | fire
            m = torch.where(upd, x[..., k], m)
            rec = torch.where(upd, idx, rec)
        fires = hit.any(-1)
        first_lane = hit.int().argmax(-1)
        pk = torch.where(fires & ~done, hit_rec.gather(1, first_lane[:, None])[:, 0], pk)
        going = ~done & ~fires
        carry_m = torch.where(going, torch.maximum(carry_m, smax.amax(-1)), carry_m)
        carry_rec = torch.where(going, torch.maximum(carry_rec, last.amax(-1)), carry_rec)
        done = done | fires
    return done, torch.where(done, pk, carry_rec)


def chain_edge_rows(win: int, guard: int, seed: int = 16):
    """The chain's edge rows at width `win` and `guard`: (vals f32[10, win],
    base int32[10]), row by row as CHAIN_ROWS names them.  A planting that
    does not fit in `win` leaves its row -inf but for what fits."""
    rng = np.random.default_rng(seed + win + guard)
    vals = np.full((len(CHAIN_ROWS), win), -np.inf, np.float32)

    def put(row: int, col: int, value: float) -> None:
        if 0 <= col < win:
            vals[row, col] = value

    mask = rng.random(win) < 0.05
    vals[0, mask] = np.round(rng.normal(1, 0.5, mask.sum()) * 8) / 8       # ties among them
    put(2, win // 2, 1.0)
    for row, edge in ((3, SEG), (4, TILE)):      # the earlier of two equal maxima holds
        e = edge if edge < win else win - 1
        put(row, e - 3, 0.5)
        put(row, e - 1, 2.0)
        put(row, e, 2.0)
        put(row, e + 2, 1.5)
    put(5, 5, 3.0)                               # smaller values at the guard and after it
    put(5, 5 + guard, 1.0)
    put(5, 5 + guard + 1, 1.0)
    seg_fire = -(-(guard + 1) // SEG) * SEG      # the first segment start a fire can reach
    put(6, seg_fire - guard - 1, 1.0)
    put(7, TILE - guard - 1, 1.0)
    put(8, win - guard - 2, 1.0)
    for k, col in enumerate(range(0, win, max(guard, 1))):     # a new record every guard columns
        put(9, col, 1.0 + k / 64)
    base = rng.integers(0, 1 << 20, len(CHAIN_ROWS)).astype(np.int32)
    return torch.from_numpy(vals), torch.from_numpy(base)


@pytest.mark.parametrize("win", CHAIN_WS)
def test_chain_rows_plant_what_they_say(win):
    for guard in CHAIN_GUARDS:
        vals, base = chain_edge_rows(win, guard)
        fired, peak = ask.ask_chain_plain(vals, base, guard)
        b = base.tolist()
        assert not fired[1] and int(peak[1]) == NEGB
        assert int(peak[2]) == b[2] + win // 2
        assert bool(fired[2]) == (win // 2 + guard + 1 < win)
        for row, edge in ((3, SEG), (4, TILE)):
            if win > edge + 2:                   # the tie straddles the edge
                assert int(peak[row]) == b[row] + edge - 1
                assert bool(fired[row]) == (edge + guard < win)
        if 5 + guard + 1 < win:
            assert fired[5] and int(peak[5]) == b[5] + 5
        seg_fire = -(-(guard + 1) // SEG) * SEG
        if seg_fire < win:
            assert fired[6] and int(peak[6]) == b[6] + seg_fire - guard - 1
        if TILE < win:
            assert fired[7] and int(peak[7]) == b[7] + TILE - guard - 1
        if win >= guard + 2:
            assert fired[8] and int(peak[8]) == b[8] + win - guard - 2
            # it fires at the last column: one column fewer and it does not
            f, _ = ask.ask_chain_plain(vals[8:9, :-1], base[8:9], guard)
            assert not f[0]
        assert not fired[9]


@pytest.mark.parametrize("win", CHAIN_WS)
@pytest.mark.parametrize("guard", CHAIN_GUARDS)
def test_chain_segments_equal_plain_and_jax(win, guard):
    import jax.numpy as jnp

    from trackmaker_tpu.phy import ask_spec as jspec

    vals, base = chain_edge_rows(win, guard)
    got = chain_segments(vals, base, guard)
    want = ask.ask_chain_plain(vals, base, guard)
    fired_j, peak_j = jspec._chain_kernel_call(jnp.asarray(vals.numpy()), jnp.asarray(base.numpy()),
                                               win, guard, interpret=True)
    for name, g, w, j in zip(("fired", "peak"), got, want, (fired_j, peak_j)):
        assert g.dtype == w.dtype and torch.equal(g, w), (win, guard, name)
        np.testing.assert_array_equal(g.numpy(), np.asarray(j), err_msg=f"{win} {guard} {name}")


def test_chain_segments_at_other_segment_and_tile_sizes():
    """The carries hold for any cut of the row: segments of 1, 4 and 32 in
    tiles of 32, 128 and 1024, on the random rows of every width."""
    for win in CHAIN_WS:
        vals, base = chain_edge_rows(win, 200)
        want = ask.ask_chain_plain(vals, base, 200)
        for seg, tile in ((1, 32), (4, 128), (32, 1024), (8, 64)):
            got = chain_segments(vals, base, 200, seg, tile)
            assert all(torch.equal(g, w) for g, w in zip(got, want)), (win, seg, tile)


def test_chain_wrapper_runs_the_plain_version_on_the_cpu():
    before = ask.ask_chain.launches
    for win in (1, 1025):
        vals, base = chain_edge_rows(win, 3)
        got = ask.ask_chain(vals, base, 3)
        assert all(torch.equal(g, w) for g, w in zip(got, chain_segments(vals, base, 3)))
    assert ask.ask_chain.launches == before


# --- the fire rule -----------------------------------------------------------------


def fire_length(t, w: int) -> int:
    return FIRE_TILE + w if t == "4096+w" else t


def fire_ties(w: int, t) -> list[int]:
    """The positions of fire_edge_inputs(w, t) planted with the capture's
    largest value, 9.0: pairs (p, p + w), each at the other's window end,
    and (q, q + 1), at the other's window start; one pair of each across
    the first tile's edge.  All of them fire (the rule is ``>=``)."""
    t = fire_length(t, w)
    out = []
    for p, gap in ((t // 3, w), (FIRE_TILE - w // 2 - 2, w), (2 * t // 3, 1), (FIRE_TILE - 1, 1)):
        if 0 <= p and p + gap < t:
            out += [p, p + gap]
    return out


def fire_edge_inputs(w: int, t, offset: int = 0, device="cpu", seed: int = 16):
    """(sync f32[3, T], upd bool[3, T]) of the fire rule's edge inputs at w
    and T (FIRE_TS; "4096+w" is a tile and its halo), row by row as
    FIRE_PATTERNS names them: sync quantized to eighths, and in the first
    two rows the ties of :func:`fire_ties` planted, with upd set there.
    With `offset`, sync and upd start that many elements into their
    buffers on `device` (the kernel's scalar path)."""
    rng = np.random.default_rng(seed + w + fire_length(t, w))
    ties = fire_ties(w, t)
    t = fire_length(t, w)
    sync = (np.round(rng.normal(0, 1, (len(FIRE_PATTERNS), t)) * 8) / 8).astype(np.float32)
    upd = np.stack([rng.random(t) < 0.3, np.ones(t, bool), np.zeros(t, bool)])
    sync[:2, ties] = 9.0
    upd[0, ties] = True
    s = torch.zeros(3 * t + offset, device=device)
    u = torch.zeros(3 * t + offset, dtype=torch.bool, device=device)
    s[offset:] = torch.from_numpy(sync).reshape(-1).to(device)
    u[offset:] = torch.from_numpy(upd).reshape(-1).to(device)
    return s[offset:].view(3, t), u[offset:].view(3, t)


def fire_cfg(w: int) -> ask.AskConfig:
    return dataclasses.replace(ACFG, peak_guard=w - 1)


def fire_tiles(sync: torch.Tensor, upd: torch.Tensor, w: int, tile: int = FIRE_TILE):
    """hit bool[B, T] by csrc/ask_fire.cu's algorithm: for row b the tiles
    start at k·tile − (b·T mod 4); each stages positions r0 .. r0 + 128·rows
    (-inf outside the row and where upd is clear), cuts them into blocks of
    bk = the largest power of two <= w (at most 128), and takes each
    position's window maximum from suf[s+1], the block maxima strictly
    between the blocks of s+1 and s+w (suf at their starts) and pre[s+w]."""
    b, t = sync.shape
    rows = (tile + w + 4 + 127) // 128
    n_staged = rows * 128
    sh = 0
    while sh < 7 and (2 << sh) <= w:
        sh += 1
    bk = 1 << sh
    s = torch.arange(tile)
    a, e = s + 1, s + w
    ca, ce = a >> sh, e >> sh
    hit = torch.zeros(b, t, dtype=torch.bool)
    for row in range(b):
        r0 = torch.arange(-(-(t + 3) // tile)) * tile - (row * t) % 4
        r0 = r0[r0 < t]
        pos = r0[:, None] + torch.arange(n_staged)
        inside = (pos >= 0) & (pos < t)
        at = pos.clamp(0, t - 1)
        m = torch.where(inside & upd[row][at], sync[row][at], -math.inf)
        blocks = m.reshape(len(r0), n_staged // bk, bk)
        pre = blocks.cummax(-1).values.reshape(len(r0), n_staged)
        suf = blocks.flip(-1).cummax(-1).values.flip(-1).reshape(len(r0), n_staged)
        mx = torch.maximum(suf[:, a], pre[:, e])
        for i in range(1, int((ce - ca).max())):
            c = ca + i
            mx = torch.where(c < ce, torch.maximum(mx, suf[:, (c << sh).clamp(max=n_staged - 1)]),
                             mx)
        r = r0[:, None] + s
        own = (r >= 0) & (r < t)
        dec = (inside & upd[row][at])[:, :tile] & (m[:, :tile] >= mx)
        hit[row, r[own]] = dec[own]
    return hit


def _naive(sync: np.ndarray, upd: np.ndarray, w: int) -> np.ndarray:
    masked = np.where(upd, sync, -np.inf)
    t = masked.shape[-1]
    padded = np.concatenate([masked, np.full((masked.shape[0], w + 1), -np.inf)], axis=-1)
    fwd = np.lib.stride_tricks.sliding_window_view(padded[:, 1:], w, axis=-1)[:, :t].max(-1)
    return upd & (masked >= fwd)


def test_fire_inputs_plant_what_they_say():
    for w in FIRE_WS:
        for t in (1, 4097, "4096+w", 339_453):
            sync, upd = fire_edge_inputs(w, t)
            n = fire_length(t, w)
            assert sync.shape == (3, n) and upd[1].all() and not upd[2].any()
            assert {(r * n) % 4 for r in range(3)} == ({0} if n % 4 == 0 else {0, n % 4, 2 * n % 4})
            if n > 1000:
                assert 0.25 < float(upd[0].float().mean()) < 0.35
            ties = fire_ties(w, t)
            if n > FIRE_TILE:      # a tie across the first tile's edge
                assert FIRE_TILE - 1 in ties and FIRE_TILE in ties
            hits = ask_spec.dense_fire_candidates_plain(fire_cfg(w), sync, upd)
            assert hits[:2, ties].all() and (sync[:2, ties] == 9.0).all()
            assert int(hits[:2].sum()) > len(ties)
    s, u = fire_edge_inputs(201, 4097, offset=1)
    assert s.data_ptr() % 16 == 4 and u.data_ptr() % 4 != 0


@pytest.mark.parametrize("w", FIRE_WS)
@pytest.mark.parametrize("t", FIRE_TS)
def test_fire_tiles_equal_plain_and_naive(w, t):
    sync, upd = fire_edge_inputs(w, t)
    got = fire_tiles(sync, upd, w)
    want = ask_spec.dense_fire_candidates_plain(fire_cfg(w), sync, upd)
    assert got.dtype == want.dtype and torch.equal(got, want), (w, t)
    assert not got[2].any()
    if sync.shape[1] * w <= 20_000_000:
        np.testing.assert_array_equal(got.numpy(), _naive(sync.numpy(), upd.numpy(), w))


@pytest.mark.parametrize("w", FIRE_WS)
def test_fire_tiles_equal_jax(w):
    """Against JAX's Pallas kernel (interpret mode) where it takes w, else
    its XLA forms (van Herk blocks of w for w <= 128, the 1-D form of 128
    blocks beyond 256), row by row (JAX's rule takes one capture); the
    main path's length only at its w, 201."""
    import jax.numpy as jnp

    from trackmaker_tpu.phy import ask as jask
    from trackmaker_tpu.phy import ask_spec as jspec

    jcfg = dataclasses.replace(jask.AskConfig(), peak_guard=w - 1)
    for t in (4097, "4096+w") + ((339_453,) if w == ACFG.peak_guard + 1 else ()):
        sync, upd = fire_edge_inputs(w, t)
        got = fire_tiles(sync, upd, w)
        for r in range(2):                       # the third row holds no update
            js, ju = jnp.asarray(sync[r].numpy()), jnp.asarray(upd[r].numpy())
            if 128 < w <= 256:
                want = jspec._fire_kernel_call(jcfg, js, ju, interpret=True)
            else:
                want = jspec.dense_fire_candidates(jcfg, js, ju, use_kernel=False)
            np.testing.assert_array_equal(got[r].numpy(), np.asarray(want), err_msg=f"{w} {t} {r}")


def test_fire_tiles_at_other_tiles():
    """The staging holds at any tile that is a multiple of 128."""
    for w in (2, 201, 1000):
        sync, upd = fire_edge_inputs(w, 4097)
        want = ask_spec.dense_fire_candidates_plain(fire_cfg(w), sync, upd)
        for tile in (128, 1024, 8192):
            assert torch.equal(fire_tiles(sync, upd, w, tile), want), (w, tile)


def test_fire_wrapper_runs_the_plain_version_on_the_cpu():
    before = ask_spec.dense_fire_candidates.launches
    for w, offset in ((1, 0), (201, 1), (FIRE_MAX_W + 1, 0)):
        sync, upd = fire_edge_inputs(w, 129, offset)
        got = ask_spec.dense_fire_candidates(fire_cfg(w), sync, upd)
        assert torch.equal(got, fire_tiles(sync, upd, w))
    assert ask_spec.dense_fire_candidates.launches == before


# --- the experiment's variants (tools/exp_fire_chain.py) --------------------------


@pytest.mark.parametrize("key", list(efc.VARIANTS), ids="-".join)
def test_experiment_variants_patch_the_kept_sources(key):
    """Each variant's anchors lie once in the kept source, and its patch
    leaves a source that still holds the kernel and its entry point."""
    src, _ = key
    kept = (_build.CSRC / f"{src}.cu").read_text()
    text = efc.patched(src, efc.VARIANTS[key])
    assert text != kept
    for _, _, new in efc.VARIANTS[key]:
        assert new in text
    for symbol in (f"{src}_kernel", f"extern \"C\" int tm_{src}("):
        assert symbol in text


def test_exact_scan_row_is_the_first_chain_of_the_exact_scan():
    """The tool's exact-scan row: one row of phy/ask.py's CHAIN_WINDOW
    columns, which fires, and whose peak is the exact scan's first frame."""
    cfg = ask.AskConfig()
    frames = ask.build_frames(b"the quick brown fox", cfg, num_frames=2)
    rx = torch.from_numpy(ask.build_track(cfg, frames, seed=7))
    vals, base = efc.exact_scan_row(cfg, rx)
    assert vals.shape == (1, ask.CHAIN_WINDOW) and ask.ask_chain is efc.ask.ask_chain
    fired, peak = ask.ask_chain_plain(vals, base, cfg.peak_guard)
    assert fired[0] and int(peak[0]) == int(ask.demodulate(cfg, rx, max_frames=1).start[0])
    assert all(torch.equal(g, w) for g, w in zip(chain_segments(vals, base, cfg.peak_guard),
                                                 (fired, peak)))
