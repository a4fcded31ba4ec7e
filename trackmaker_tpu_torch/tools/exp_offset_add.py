"""The offset-add experiment (counterpart of ``tools/exp_offset_add.py``):
three epilogues of one product o = x @ t, each a kernel of its own.

``offset_add(form, x, t)`` launches ``csrc/offset_add.cu`` on CUDA
tensors and runs ``offset_add_plain`` on CPU tensors.  For x f32[40, 384]
and t f32[384, 256] it returns out f32[32, 128]:

* ``"A"``, the sliding offset-1 add: ``o[0:32, 0:128] + o[1:33, 128:256]``;
* ``"B"``, one row: ``o[0, 0:128] + o[1, 128:256]``, broadcast to 32 rows;
* ``"C"``, a data-dependent lane shift: ``ql = (sum of int(x[0, 0:8])) mod
  64``, a floor mod, as in JAX and NumPy (a sum of -5 gives 59), then
  ``out[i, k] = L[i, k + ql]`` where ``k + ql < 128``, else
  ``L[i + 1, k + ql - 128]``, with L = o[:, 0:128].  The TPU kernel builds
  that shift as a (128, 256) one-hot product; here it is an index.

Each kernel computes only the sums its form needs (A: 32 x 128 sums of
768 products, C of 384, B: one row of 768), each cut into 32 slices
summed in ascending order and then added in ascending slice order (the
header of ``csrc/offset_add.cu``); the plain version sums as
``matmul_f32`` does.  On the tool's inputs (``tool_input``: small
integers and a 0/1 table) every sum is exact in any order, so the
kernels, the plain versions and the NumPy oracles ``oa``, ``ob`` and
``oc`` (the JAX tool's, copied) agree bit for bit.

    python -m trackmaker_tpu_torch.tools.exp_offset_add

prints the card's name and power limit, then each form's max_abs and
max_rel against its oracle, and exits non-zero unless all three equal it.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from trackmaker_tpu_torch import _build
from trackmaker_tpu_torch.dsp.filters import matmul_f32
from trackmaker_tpu_torch.tools.health import card_line

X_SHAPE = (40, 384)
T_SHAPE = (384, 256)
OUT_ROWS, LANES = 32, 128
QL_MOD = 64
FORMS = ("A", "B", "C")
NAMES = {"A": "A(sliding offset-1 add)", "B": "B(mask+rowsum 2-row)",
         "C": "C(index shift + add)"}


def tool_input(device, seed: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """The tool's inputs on `device`: x f32[40, 384] of integers -2..2 and
    t f32[384, 256] of 0/1 (one in four), from ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-2, 3, X_SHAPE).astype(np.float32)
    t = (rng.integers(0, 4, T_SHAPE) == 0).astype(np.float32)
    return torch.from_numpy(x).to(device), torch.from_numpy(t).to(device)


# --- the JAX tool's NumPy oracles ----------------------------------------------

def oa(x: np.ndarray, t: np.ndarray) -> np.ndarray:
    out = x @ t
    return out[0:32, 0:128] + out[1:33, 128:256]


def ob(x: np.ndarray, t: np.ndarray) -> np.ndarray:
    out = x[0:2] @ t
    d = out[0:1, 0:128] + out[1:2, 128:256]
    return np.broadcast_to(d, (32, 128))


def oc(x: np.ndarray, t: np.ndarray) -> np.ndarray:
    ql = int(x[0, 0:8].astype(np.int32).sum()) % 64
    ar = np.arange(128)[:, None]
    ac = np.arange(256)[None, :]
    s12 = (ar == (ac % 128) + ql - 128 * (ac // 128)).astype(np.float32)
    lsel = (x @ t)[:, 0:128]
    out = lsel[0:33] @ s12
    return out[0:32, 0:128] + out[1:33, 128:256]


ORACLES = {"A": oa, "B": ob, "C": oc}


# --- the plain version and the kernel ------------------------------------------

def _check(form: str, x: torch.Tensor, t: torch.Tensor) -> None:
    if form not in FORMS:
        raise ValueError(f"unknown form {form!r}; the forms are {FORMS}")
    for name, a, shape in (("x", x, X_SHAPE), ("t", t, T_SHAPE)):
        if tuple(a.shape) != shape or a.dtype != torch.float32 or not a.is_contiguous():
            raise ValueError(f"{name} must be a contiguous f32{list(shape)}, got "
                             f"{a.dtype}{list(a.shape)}")


def lane_shift(x: torch.Tensor) -> int:
    """Form C's shift: the sum of int(x[0, 0:8]) (truncated toward zero,
    as ``astype(int32)``), floor mod 64."""
    return int(x[0, :8].to(torch.int32).sum()) % QL_MOD


def offset_add_plain(form: str, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`offset_add`: the product in f32
    (TF32 off), then the form's epilogue."""
    _check(form, x, t)
    o = matmul_f32(x, t)
    if form == "A":
        return o[0:OUT_ROWS, :LANES] + o[1:OUT_ROWS + 1, LANES:]
    if form == "B":
        return (o[0, :LANES] + o[1, LANES:]).expand(OUT_ROWS, LANES).contiguous()
    ql = lane_shift(x)
    lsel = o[:, :LANES]
    # row i continues into row i + 1: lanes k + ql past 127 come from there
    pairs = torch.cat([lsel[0:OUT_ROWS], lsel[1:OUT_ROWS + 1]], dim=1)
    return pairs[:, ql:ql + LANES].contiguous()


_ARGTYPES = [ctypes.c_void_p] * 4


def offset_add(form: str, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """out f32[32, 128] of form `form` ("A", "B" or "C") for x f32[40, 384]
    and t f32[384, 256] (see the module docstring)."""
    if not _build.on_cuda(x, t):
        return offset_add_plain(form, x, t)
    _check(form, x, t)
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned on the card (the kernels load it as float4)")
    out = torch.empty((OUT_ROWS, LANES), dtype=torch.float32, device=x.device)
    fn = _build.entry("offset_add", f"tm_offset_add_{form.lower()}", _ARGTYPES)
    _build.check(fn(x.data_ptr(), t.data_ptr(), out.data_ptr(), _build.stream_ptr(x)),
                 f"offset_add {form}")
    offset_add.launches += 1
    return out


offset_add.launches = 0


def errors(form: str, got: torch.Tensor, x: torch.Tensor, t: torch.Tensor):
    """(max_abs, max_rel) of `got` against the form's NumPy oracle, as the
    JAX tool reports them."""
    want = ORACLES[form](x.cpu().numpy(), t.cpu().numpy())
    err = np.abs(got.cpu().numpy() - want)
    rel = err / np.maximum(np.abs(want), 1e-6)
    return float(err.max()), float(rel.max())


def main(argv: list[str] | None = None) -> None:
    del argv   # the tool takes no arguments
    if not torch.cuda.is_available():
        raise SystemExit("the experiment needs a CUDA card; torch.cuda.is_available() is False")
    card = card_line()
    print(card, flush=True)
    x, t = tool_input("cuda")
    failed = []
    for form in FORMS:
        got = offset_add(form, x, t)
        torch.cuda.synchronize()
        max_abs, max_rel = errors(form, got, x, t)
        print(f"{NAMES[form]}: max_abs={max_abs:.3e} max_rel={max_rel:.3e} [{card}]", flush=True)
        if max_abs != 0.0:
            failed.append(form)
    if failed:
        raise SystemExit(f"offset_add forms {failed} differ from their oracles")


if __name__ == "__main__":
    main()
