"""The attempt-tile experiment (counterpart of ``tools/exp_attempt_tiles.py``):
skeletons of the attempt kernel's per-candidate products.

``attempt_tiles(variant, x, ts, tsc, tb, tbn, w, wn, pipe)`` launches
``csrc/attempt_tiles.cu`` on CUDA tensors and runs ``attempt_tiles_plain``
on CPU tensors.  For captures x f32[B, 1200, 384], tables ts and tb
f32[8, 768, 256], tsc and tbn f32[8, 768, 128], and packing matrices w
f32[128, 128] and wn f32[64, 128], it returns out f32[B, 65, 34, 128].
Each capture b loops over the candidates c < 65; candidate c reads the 36
rows x[b, 9 (c % 8) + j], j < 36 (the tool's slab x[b, 8 (c % 8):+48]
from its row c % 8), and:

* **sync**: x01 = rows 0 and 1; with q = 37 c mod 384, v = q mod 8 and
  the table slice T = ts[v, q - v : q - v + 384], for the 13 lanes
  l < 13 ``dot = x01[0] . T[:, l] + x01[1] . T[:, 128 + l]`` and
  ``en = x01[0]^2 . T[:, l]^2 + x01[1]^2 . T[:, 128 + l]^2``
  (``sync1``/``both``: one table tsc, ``dot`` from its lanes l and
  32 + l, ``en`` from x01^2 against lanes 64 + l and 96 + l, the table
  not squared), ``cc = dot / sqrt(max(en, 1e-6))`` and ``best`` the
  first lane of largest cc;
* **body**: the 35 rows from row c % 2, o2 = (53 c + best) mod 384 and the
  slice U = tb[o2 mod 8, o2 - o2 mod 8 : +384]; ``d[r, k] = xsh[r] . U[:, k]
  + xsh[r + 1] . U[:, 128 + k]`` for r < 34, k < 128 (``n128``/``both``:
  tbn, halves of 64 lanes), ``bits = d <= 0`` and the block
  ``bits @ w`` (``wn``) f32[34, 128];
* **bf16b**: as ``base`` with x and U rounded to bf16, sums in f32;
* **noop**: only ``acc += sum(x01[0, 0:8])``.

Candidate c's block goes to out[b, c]; each adds its lane-0 ``dot`` to an
accumulator (``_nostore``: adds ``dot + block[0, 0]`` and stores
nothing), and out[b, 0] gets the accumulator added at the end.  ``out``
starts as zeros, so the blocks a variant does not write are 0 (the TPU
kernel leaves them unwritten).  Modifiers: ``_nodma`` reads the rows from
device memory in place of staging them in shared memory, ``_nostore``,
``_uN`` computes only the first (65 // N) N candidates.

Every dot product is a sum in k order, one rounded term a step, split for
the sync into four chunks of 96 added in order; on the tool's tables
(ternary, and 0/1 for w) every product is exact, so the kernel and the
plain version agree bit for bit on any x.

The kernel spreads the candidates over the card: a block of 128 threads
takes GROUP consecutive candidates of one capture, stores each one's
share of the accumulator, and the last block of a capture to finish adds
them in candidate order (``csrc/attempt_tiles.cu``'s header).  Its ring
holds `pipe` stages, each STAGE_COLS rows of the table and STAGE_ROWS
body rows of x over the same STAGE_COLS columns, and fits when
BLOCKS_PER_SM blocks share an SM; ``_nodma`` reads x from device memory
and keeps NODMA_PIPE stages for the table whatever the depth.

    python -m trackmaker_tpu_torch.tools.exp_attempt_tiles [iters] [variants] [pipe]

prints the card's name and power limit, then per variant the ms a call
and the us a candidate (CUDA events, the least of 3 repeats of `iters`
calls back to back).  The ring depth `pipe` defaults to ``TM_EXP_PIPE``
or 4; a depth whose ring does not fit a block's share of an SM raises.
"""

from __future__ import annotations

import ctypes
import os
import sys
from typing import NamedTuple

import numpy as np
import torch

from trackmaker_tpu_torch import _build
from trackmaker_tpu_torch.dsp.filters import matmul_f32
from trackmaker_tpu_torch.tools.health import card_line
from trackmaker_tpu_torch.tools.prof_fused import time_stage

B, NV, NR, DROW, BROWS = 32, 65, 48, 384, 34      # the JAX tool's constants
ROWS = 1200                 # rows of each capture
TABLES, TROWS = 8, 768
LANES = 128
SYNC_LANES = 13
SYNC_CHUNKS = 4             # the sync sums: four chunks of 96 terms, added in order
SLAB_ROWS = 36              # rows a candidate reads
STAGE_ROWS, STAGE_COLS = BROWS + 1, 16   # a stage's body rows of x, and its k
NODMA_PIPE = 2              # _nodma's ring, for the table alone
GROUP = 2                   # candidates a block (csrc/attempt_tiles.cu:kGroup)
ITERS = 100
PIPE = 4
VARIANTS = ("noop", "base", "n128", "sync1", "both", "bf16b")
BLOCKS_PER_SM = 3           # the kernel's blocks an SM, each with its ring
# an H100 SM's 233,472 bytes of shared memory shared by BLOCKS_PER_SM
# blocks, less the 1,024 the system keeps for each
SMEM_PER_BLOCK = 233_472 // BLOCKS_PER_SM - 1_024
STATIC_SMEM = 1_024         # the kernel's fixed scratch (csrc/attempt_tiles.cu:kStaticSmem)
STAGE_BYTES = (STAGE_COLS * 256 + STAGE_ROWS * STAGE_COLS) * 4
# kernel kinds, as csrc/attempt_tiles.cu numbers them
KINDS = {"base": 0, "n128": 1, "sync1": 2, "both": 3, "bf16b": 4, "noop": 5}


class Variant(NamedTuple):
    kind: str           # one of KINDS
    stage: bool         # rows staged in shared memory (False: _nodma)
    store: bool         # blocks stored (False: _nostore)
    n_cand: int         # candidates computed (_uN: (65 // N) N)

    @property
    def merged(self) -> bool:
        return self.kind in ("sync1", "both")

    @property
    def n128(self) -> bool:
        return self.kind in ("n128", "both")


def parse_variant(variant: str) -> Variant:
    """The variant named `variant`: a kind of KINDS, then any of the
    modifiers ``_nodma``, ``_nostore`` and ``_uN``; raises on another."""
    kind, *mods = variant.split("_")
    if kind not in KINDS:
        raise ValueError(f"unknown variant {variant!r}: its kind must be one of {list(KINDS)}")
    stage, store, n_cand = True, True, NV
    for mod in mods:
        if mod == "nodma":
            stage = False
        elif mod == "nostore":
            store = False
        elif mod.startswith("u") and mod[1:].isdigit() and 1 <= int(mod[1:]) <= NV:
            n_cand = NV // int(mod[1:]) * int(mod[1:])
        else:
            raise ValueError(f"unknown modifier {mod!r} in variant {variant!r}")
    return Variant(kind, stage, store and kind != "noop", n_cand)


def stage_smem(spec: Variant, pipe: int) -> int:
    """Bytes of shared memory a block of the kernel uses at ring depth
    `pipe` (``_nodma``: NODMA_PIPE stages, whatever the depth); raises
    ValueError where the ring does not fit."""
    if pipe < 1:
        raise ValueError(f"the ring depth must be positive, got {pipe}")
    need = (pipe if spec.stage else NODMA_PIPE) * STAGE_BYTES + STATIC_SMEM
    if need > SMEM_PER_BLOCK:
        raise ValueError(f"a ring of {pipe} stages of {STAGE_BYTES} B needs {need} B of shared "
                         f"memory; each of {BLOCKS_PER_SM} blocks an SM may use {SMEM_PER_BLOCK}")
    return need


def tool_input(device, seed: int = 0, b: int = B, integer: bool = False):
    """The tool's corpus on `device`, from ``default_rng(seed)``: (x, ts,
    tsc, tb, tbn, w, wn) with x f32[b, 1200, 384] unit normal (or, with
    `integer`, integers -2..2), ternary tables ts f32[8, 768, 256] and tsc
    f32[8, 768, 128], tb = ts and tbn = tsc as the tool passes them, and
    0/1 matrices w f32[128, 128] and wn f32[64, 128]."""
    rng = np.random.default_rng(seed)
    shape = (b, ROWS, DROW)
    x = (rng.integers(-2, 3, shape) if integer else rng.normal(0, 1, shape)).astype(np.float32)
    ts = rng.integers(-1, 2, (TABLES, TROWS, 256)).astype(np.float32)
    tsc = rng.integers(-1, 2, (TABLES, TROWS, 128)).astype(np.float32)
    w = rng.integers(0, 2, (128, 128)).astype(np.float32)
    wn = rng.integers(0, 2, (64, 128)).astype(np.float32)
    ts_t, tsc_t = (torch.from_numpy(a).to(device) for a in (ts, tsc))
    return (torch.from_numpy(x).to(device), ts_t, tsc_t, ts_t, tsc_t,
            torch.from_numpy(w).to(device), torch.from_numpy(wn).to(device))


def _check_inputs(x, ts, tsc, tb, tbn, w, wn) -> None:
    b = x.shape[0] if x.ndim == 3 else 0
    for name, a, shape in (("x", x, (b, ROWS, DROW)), ("ts", ts, (TABLES, TROWS, 256)),
                           ("tsc", tsc, (TABLES, TROWS, 128)), ("tb", tb, (TABLES, TROWS, 256)),
                           ("tbn", tbn, (TABLES, TROWS, 128)), ("w", w, (128, 128)),
                           ("wn", wn, (64, 128))):
        if (tuple(a.shape) != shape or a.dtype != torch.float32 or not a.is_contiguous()
                or b < 1):
            raise ValueError(f"{name} must be a contiguous f32{list(shape)}, got "
                             f"{a.dtype}{list(a.shape)}")


def _seq_dot(xs: torch.Tensor, tab: torch.Tensor, k0: int, k1: int) -> torch.Tensor:
    """sum over k0 <= k < k1 of xs[..., k, None] * tab[..., k, :], one
    rounded product and one rounded sum a term, in k order."""
    acc = torch.zeros(torch.broadcast_shapes(xs.shape[:-1] + (1,), tab.shape[:-2] + tab.shape[-1:]),
                      dtype=torch.float32, device=xs.device)
    for k in range(k0, k1):
        acc = acc + xs[..., k, None] * tab[..., k, :]
    return acc


def _chunked_dot(xs: torch.Tensor, tab: torch.Tensor) -> torch.Tensor:
    """The sync's sum: four chunks of 96 terms, each in k order, added in
    order."""
    step = DROW // SYNC_CHUNKS
    parts = [_seq_dot(xs, tab, i * step, (i + 1) * step) for i in range(SYNC_CHUNKS)]
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return total


def _rows(c: torch.Tensor) -> torch.Tensor:
    """The first of candidate c's 36 rows in its capture."""
    return 9 * (c % 8)


def sync_plain(spec: Variant, x: torch.Tensor, ts: torch.Tensor, tsc: torch.Tensor):
    """The sync of every candidate: (dot, en, cc) f32[B, n, 13] over the 13
    deciding lanes and best int64[B, n], n = spec.n_cand."""
    dev = x.device
    c = torch.arange(spec.n_cand, device=dev)
    x01 = x[:, _rows(c)[:, None] + torch.arange(2, device=dev)]        # [B, n, 2, 384]
    q = (37 * c) % DROW
    v = q % 8
    slab = (q - v)[:, None] + torch.arange(DROW, device=dev)           # [n, 384]
    lanes = torch.arange(SYNC_LANES, device=dev)
    if spec.merged:
        tab = tsc[v[:, None], slab]                                    # [n, 384, 128]
        cols, square_t = (0, 32, 64, 96), False
    else:
        tab = ts[v[:, None], slab]                                     # [n, 384, 256]
        cols, square_t = (0, 128, 0, 128), True
    sums = []
    for s, col in enumerate(cols):
        xs = x01[:, :, s % 2]
        t_s = tab[:, :, col + lanes]
        if s >= 2:
            xs = xs * xs
            if square_t:
                t_s = t_s * t_s
        sums.append(_chunked_dot(xs, t_s))
    dot, en = sums[0] + sums[1], sums[2] + sums[3]
    cc = dot * torch.reciprocal(torch.sqrt(en.clamp(min=1e-6)))
    return dot, en, cc, cc.argmax(-1)      # argmax: the first of equal maxima


def _bf16(a: torch.Tensor) -> torch.Tensor:
    return a.to(torch.bfloat16).to(torch.float32)


def blocks_plain(spec: Variant, x: torch.Tensor, tb: torch.Tensor, tbn: torch.Tensor,
                 w: torch.Tensor, wn: torch.Tensor, best: torch.Tensor) -> torch.Tensor:
    """The body of every candidate given its sync's `best`: blocks f32[B,
    n, 34, 128]."""
    dev = x.device
    c = torch.arange(spec.n_cand, device=dev)
    rows = (_rows(c) + c % 2)[:, None] + torch.arange(BROWS + 1, device=dev)
    xsh = x[:, rows]                                                   # [B, n, 35, 384]
    table = tbn if spec.n128 else tb
    half = table.shape[-1] // 2
    if spec.kind == "bf16b":
        xsh = _bf16(xsh)
    o2 = (53 * c + best) % DROW                                        # [B, n]
    v2 = o2 % 8
    base = o2 - v2
    acc_a = torch.zeros(xsh.shape[:2] + (BROWS, half), dtype=torch.float32, device=dev)
    acc_b = torch.zeros_like(acc_a)
    for k in range(DROW):
        trow = table[v2, base + k]                                     # [B, n, N]
        if spec.kind == "bf16b":
            trow = _bf16(trow)
        acc_a = acc_a + xsh[:, :, :BROWS, k, None] * trow[:, :, None, :half]
        acc_b = acc_b + xsh[:, :, 1:, k, None] * trow[:, :, None, half:]
    bits = ((acc_a + acc_b) <= 0.0).to(torch.float32)
    return matmul_f32(bits, wn if spec.n128 else w)     # sums of 0/1: exact in any order


def attempt_tiles_plain(variant: str, x: torch.Tensor, ts: torch.Tensor, tsc: torch.Tensor,
                        tb: torch.Tensor, tbn: torch.Tensor, w: torch.Tensor, wn: torch.Tensor,
                        pipe: int = PIPE) -> torch.Tensor:
    """Plain PyTorch version of :func:`attempt_tiles`."""
    spec = parse_variant(variant)
    _check_inputs(x, ts, tsc, tb, tbn, w, wn)
    stage_smem(spec, pipe)
    b, dev = x.shape[0], x.device
    out = torch.zeros((b, NV, BROWS, LANES), dtype=torch.float32, device=dev)
    acc = torch.zeros(b, dtype=torch.float32, device=dev)
    if spec.kind == "noop":
        for c in range(spec.n_cand):
            s = torch.zeros(b, dtype=torch.float32, device=dev)
            for j in range(8):
                s = s + x[:, 9 * (c % 8), j]
            acc = acc + s
    else:
        dot, _, _, best = sync_plain(spec, x, ts, tsc)
        blocks = blocks_plain(spec, x, tb, tbn, w, wn, best)
        if spec.store:
            out[:, :spec.n_cand] = blocks
        for c in range(spec.n_cand):
            acc = acc + dot[:, c, 0]
            if not spec.store:
                acc = acc + blocks[:, c, 0, 0]
    out[:, 0] += acc[:, None, None]
    return out


_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_counts: dict[torch.device, torch.Tensor] = {}


def _arrival_counts(device: torch.device, b: int) -> torch.Tensor:
    """int32[>= b] on `device`, zero: the kernel's arrival counter for each
    capture, which every launch leaves zero again."""
    counts = _counts.get(device)
    if counts is None or counts.numel() < b:
        counts = _counts[device] = torch.zeros(b, dtype=torch.int32, device=device)
    return counts


def attempt_tiles(variant: str, x: torch.Tensor, ts: torch.Tensor, tsc: torch.Tensor,
                  tb: torch.Tensor, tbn: torch.Tensor, w: torch.Tensor, wn: torch.Tensor,
                  pipe: int = PIPE) -> torch.Tensor:
    """out f32[B, 65, 34, 128] of variant `variant` at ring depth `pipe`
    (see the module docstring)."""
    tensors = (x, ts, tsc, tb, tbn, w, wn)
    if not _build.on_cuda(*tensors):
        return attempt_tiles_plain(variant, *tensors, pipe=pipe)
    spec = parse_variant(variant)
    _check_inputs(*tensors)
    stage_smem(spec, pipe)
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned for the staging copies")
    b = x.shape[0]
    out = torch.zeros((b, NV, BROWS, LANES), dtype=torch.float32, device=x.device)
    part = torch.empty((b, NV, 2), dtype=torch.float32, device=x.device)
    fn = _build.entry("attempt_tiles", "tm_attempt_tiles", _ARGTYPES)
    err = fn(*(a.data_ptr() for a in tensors), out.data_ptr(), part.data_ptr(),
             _arrival_counts(x.device, b).data_ptr(), b, KINDS[spec.kind], int(spec.stage),
             int(spec.store), spec.n_cand, pipe, _build.stream_ptr(x))
    _build.check(err, f"attempt_tiles {variant}")
    attempt_tiles.launches += 1
    return out


attempt_tiles.launches = 0


def main(argv: list[str] | None = None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    iters = int(argv[0]) if argv else ITERS
    variants = argv[1].split(",") if len(argv) > 1 else VARIANTS
    pipe = int(argv[2]) if len(argv) > 2 else int(os.environ.get("TM_EXP_PIPE", str(PIPE)))
    for v in variants:
        stage_smem(parse_variant(v), pipe)
    if not torch.cuda.is_available():
        raise SystemExit("the experiment needs a CUDA card; torch.cuda.is_available() is False")
    card = card_line()
    print(card, flush=True)
    x, *tables = tool_input("cuda")
    b = x.shape[0]
    print(f"B={b} NV={NV} NR={NR} DROW={DROW} BROWS={BROWS} pipe={pipe} iters={iters}",
          flush=True)
    for v in variants:
        mn, med = time_stage(lambda xx, v=v: attempt_tiles(v, xx, *tables, pipe=pipe), x, iters)
        print(f"{v:8s} {mn:7.3f} ms  ({mn * 1e3 / (b * NV):6.3f} us/cand)  (med {med:.3f})  "
              f"[{card}]", flush=True)


if __name__ == "__main__":
    main()
