"""The Viterbi kernel (``csrc/viterbi.cu``) beside its losing designs and,
given one, an earlier tree's ``viterbi.cu``: the outputs checked against
the plain version, then each design's device time at the batch and live
shapes, in turns.

    python -m trackmaker_tpu_torch.tools.exp_viterbi [--parent PATH] [--runs N] [--check-only]

The designs, each but the first a text patch of the kept source built
into ``build/trackmaker_tpu_torch/exp/``:

* ``kept``: the source as it stands, a thread a state (the wrapper's);
* ``T2``, ``T4``: a state's 16 paths split over T adjacent lanes, 16 / T
  consecutive predecessors each, joined by ``__shfl_xor_sync`` with the
  lower j winning equal values (64·T threads a row);
* ``S2``: two states a thread, s and s + 32, whose paths share steps 1-3
  and whose step-4 addends are negatives (32 threads a row);
* ``tailloop``: the radix-1 tail (outside the chain) written as a loop
  over the block's states instead of a thread's own state: what the
  compiler makes of the chain then;
* ``devchoices``: the choices always in the device memory scratch (what
  keeping them in shared memory buys);
* ``exchange``: the block step reduced to its exchange (one metric
  loaded and stored, the barrier; bits not checked): the floor a block
  step cannot go under;
* ``noindex``: the tree without its index (bits not checked): what
  keeping the first maximum's j costs;
* ``parent``: the ``viterbi.cu`` at PATH (an earlier tree's, with the
  same C entry and a choices tensor allocated a call, as its wrapper did).

The shapes (:data:`SHAPES`): 256 rows of 518 trellis steps and of 62 (the
payloads and headers of ``chip_smoke.py``'s coded_manchester_b8), one row
of 62, 518 and 2,054 steps (a live call's header, a 64-byte and a
263-byte frame's payload).  For each shape the designs run in turns, the
parent (when given) first and last and the others between, then the same
backwards.  Each turn prints the device time of a launch (CUDA events
around a CUDA graph of 50 launches, median of 5 replays, the graph only as
timing scaffolding; and torch.profiler's median over the launches it
traced, with their count), one call's CUDA-event time, the host time of one
call (no synchronisation) and the time a block step (device time /
ceil(n_steps / 4)), with the card's name and power limit.  The timing
helpers are ``chip_smoke.py``'s.  Before any timing, every checked design's
bits equal the plain version's on the shapes' inputs and on every corpus of
``viterbi_corpora(long=True)`` (the ties across the kernel's tree and the
long rows, up to the choices past the shared memory, among them).  The
registers and spills of the kept source (``nvcc -Xptxas -v``) print first.
Needs a card.
"""

from __future__ import annotations

import argparse
import ctypes
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from trackmaker_tpu_torch import _build
from trackmaker_tpu_torch.core import convcode
from trackmaker_tpu_torch.tools.exp_walk_attempt import EXP_DIR, build_source, patched
from trackmaker_tpu_torch.tools.health import card_line

ROOT = Path(__file__).resolve().parents[2]
SHAPES = ((256, 518), (256, 62), (1, 62), (1, 518), (1, 2054))
_KERNEL_HEAD = ("template <bool kSharedChoices>\n"
                "__global__ void __launch_bounds__(kStates) viterbi_kernel(")
_LAUNCH = "kernel<<<n_rows, kStates, smem,"
_STORES = ("      pm[((blk + 1) & 1) * kStates + h] = best;\n"
           "      ch[blk * kStates + h] = static_cast<uint8_t>(j);\n")


# the radix-1 tail (from, through) and as a loop over the block's states
_TAIL = ("    float cand[2];\n", "    ch[(q + i) * kStates + h] = static_cast<uint8_t>(c);\n")
_TAIL_LOOP = ("    for (int st = threadIdx.x; st < kStates; st += blockDim.x) {\n"
              "      float cand[2];\n"
              "#pragma unroll\n"
              "      for (int c = 0; c < 2; ++c) {\n"
              "        const int l = label(st, c << 3, kRadix);\n"
              "        const float f = (l & 1) ? sm.y : sm.x;\n"
              "        cand[c] = __fadd_rn(cur[2 * (st & 31) + c], (l & 2) ? -f : f);\n"
              "      }\n"
              "      const int c = cand[1] > cand[0];\n"
              "      pm[((q + i + 1) & 1) * kStates + st] = c ? cand[1] : cand[0];\n"
              "      ch[(q + i) * kStates + st] = static_cast<uint8_t>(c);\n"
              "    }\n")


def _one(anchor: str, new: str) -> tuple[str, str, str]:
    """A patch replacing the text `anchor` (found once) by `new`."""
    return anchor, anchor, new


def split_patches(t: int) -> list:
    """T lanes a state: lane p keeps paths p·16/T .. p·16/T + 16/T - 1."""
    return [
        _one(_KERNEL_HEAD, f"constexpr int kSplit = {t};\n\n"
             + _KERNEL_HEAD.replace("(kStates)", "(kStates * kSplit)")),
        _one("  constexpr int kPaths = 16;", "  constexpr int kPaths = 16 / kSplit;"),
        _one("  const int h = threadIdx.x;",
             "  const int h = threadIdx.x / kSplit, p = threadIdx.x % kSplit;"),
        _one("label(h, 0, i + 1)", "label(h, p * kPaths, i + 1)"),
        _one("const int pred = 16 * (h & 3);", "const int pred = 16 * (h & 3) + p * kPaths;"),
        _one("      const float best = first_max<kPaths>(v, j);\n",
             "      float best = first_max<kPaths>(v, j);\n"
             "      j += p * kPaths;\n"
             "#pragma unroll\n"
             "      for (int off = 1; off < kSplit; off <<= 1) {\n"
             "        const float ob = __shfl_xor_sync(0xffffffffu, best, off);\n"
             "        const int oj = __shfl_xor_sync(0xffffffffu, j, off);\n"
             "        if (ob > best || (ob == best && oj < j)) {\n"
             "          best = ob;\n"
             "          j = oj;\n"
             "        }\n"
             "      }\n"),
        _one(_LAUNCH, _LAUNCH.replace("kStates,", "kStates * kSplit,")),
    ]


_SEQ = "std::make_integer_sequence<int, kPaths>{}"
PAIR_PATCHES = [
    _one(_KERNEL_HEAD,
         "template <int... J>\n"
         "__device__ __forceinline__ void prefix_values(float* a, const float* m, const float* x,\n"
         "                                              const float* y,\n"
         "                                              std::integer_sequence<int, J...>) {\n"
         "  ((a[J] = add_part<part(J, 3)>(add_part<part(J, 2)>(add_part<part(J, 1)>(m[J], x[0],\n"
         "      y[0]), x[1], y[1]), x[2], y[2])), ...);\n"
         "}\n\n"
         "template <bool kNegate, int... J>\n"
         "__device__ __forceinline__ void last_values(float* v, const float* a, float x, float y,\n"
         "                                            std::integer_sequence<int, J...>) {\n"
         "  ((v[J] = add_part<part(J, 4) ^ (kNegate ? 2 : 0)>(a[J], x, y)), ...);\n"
         "}\n\n"
         + _KERNEL_HEAD.replace("(kStates)", "(kStates / 2)")),
    ("      float v[kPaths];\n      path_values(", _STORES,
     "      float a[kPaths], v[kPaths];\n"
     f"      prefix_values(a, m, x, y, {_SEQ});\n"
     f"      last_values<false>(v, a, x[3], y[3], {_SEQ});\n"
     "      int j;\n"
     "      float best = first_max<kPaths>(v, j);\n"
     + _STORES
     + f"      last_values<true>(v, a, x[3], y[3], {_SEQ});\n"
     "      best = first_max<kPaths>(v, j);\n"
     "      pm[((blk + 1) & 1) * kStates + h + 32] = best;\n"
     "      ch[blk * kStates + h + 32] = static_cast<uint8_t>(j);\n"),
    (*_TAIL, "#pragma unroll\n"
     + _TAIL_LOOP.replace("int st = threadIdx.x; st < kStates; st += blockDim.x",
                          "int e = 0; e < 2; ++e")
     .replace("      float cand[2];\n",
              "      const int st = h + 32 * e;\n      float cand[2];\n")),
    _one(_LAUNCH, _LAUNCH.replace("kStates,", "kStates / 2,")),
]
VARIANTS = {
    "T2": split_patches(2),
    "T4": split_patches(4),
    "S2": PAIR_PATCHES,
    "tailloop": [(*_TAIL, _TAIL_LOOP)],
    "devchoices": [_one("  const bool shared_choices = staged + choice_bytes <= kSmemMax;",
                        "  const bool shared_choices = false;")],
    # the block step's exchange alone: one metric loaded, one stored, the barrier
    "exchange": [("      const float* cur = pm + (blk & 1) * kStates + pred;", _STORES,
                  "      pm[((blk + 1) & 1) * kStates + h] = pm[(blk & 1) * kStates + pred] +"
                  " sums[0].x;\n"
                  "      ch[blk * kStates + h] = 0;\n")],
    # the tree without its index: every choice 0
    "noindex": [_one("        idx[k] = idx[k + w];\n", "")],
}
UNCHECKED = {"exchange", "noindex"}     # variants whose bits differ by design


def rows_input(n_rows: int, n_steps: int, device, seed: int = 24) -> torch.Tensor:
    """n_rows noisy soft rows (sigma 0.9) of encoded random bits."""
    rng = np.random.default_rng(seed + n_rows * 7919 + n_steps)
    bits = rng.integers(0, 2, (n_rows, n_steps - 6)).astype(np.uint8)
    tx = 2.0 * convcode.conv_encode(torch.from_numpy(bits)).numpy() - 1.0
    return torch.from_numpy((tx + rng.normal(0, 0.9, tx.shape)).astype(np.float32)).to(device)


def lib_call(lib: ctypes.CDLL, scratch_always: bool = False):
    """A call of tm_viterbi from `lib` as the wrapper makes it (the scratch
    where the choices do not fit), or with a scratch allocated every call
    (as the earlier wrapper did)."""
    fn = lib.tm_viterbi
    fn.argtypes = convcode._ARGTYPES
    fn.restype = ctypes.c_int

    def call(r: torch.Tensor, n_bits: int, soft: bool = True) -> torch.Tensor:
        n, n_steps = r.shape[0], n_bits + 6
        out = torch.empty((n, n_bits), dtype=torch.uint8, device=r.device)
        scratch = None
        if scratch_always or not convcode.choices_fit(n_steps):
            q, rem = divmod(n_steps, 4)
            scratch = torch.empty((n, q + rem, 64), dtype=torch.uint8, device=r.device)
        _build.check(fn(r.data_ptr(), n, n_steps, n_bits, int(not soft),
                        None if scratch is None else scratch.data_ptr(), out.data_ptr(),
                        _build.stream_ptr(r)), "viterbi")
        return out

    return call


def ptxas_report(text: str) -> list[str]:
    """`nvcc -Xptxas -v`'s lines on registers and spills for `text`."""
    EXP_DIR.mkdir(parents=True, exist_ok=True)
    src = EXP_DIR / "viterbi-ptxas.cu"
    src.write_text(text)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I",
                           str(_build.CSRC), "-o", str(src.with_suffix(".so")), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    return [line.strip() for line in proc.stderr.splitlines()
            if "registers" in line or "spill" in line or "Compiling entry" in line]


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, help="an earlier tree's csrc/viterbi.cu")
    ap.add_argument("--runs", type=int, default=30)
    ap.add_argument("--check-only", action="store_true")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    if not torch.cuda.is_available():
        raise SystemExit("the experiment needs a CUDA card; torch.cuda.is_available() is False")
    sys.path[:0] = [str(ROOT), str(ROOT / "tests")]
    import chip_smoke as smoke
    from test_torch_convcode import viterbi_corpora

    card = card_line()
    dev = torch.device("cuda", 0)
    for line in ptxas_report((_build.CSRC / "viterbi.cu").read_text()):
        print(f"ptxas: {line}")
    designs = {"kept": lib_call(_build.load("viterbi"))}
    for name, patches in VARIANTS.items():
        lib = ctypes.CDLL(str(build_source(f"viterbi-{name}", patched("viterbi", patches))))
        designs[name] = lib_call(lib, scratch_always=name == "devchoices")
    if args.parent is not None:
        designs["parent"] = lib_call(ctypes.CDLL(str(build_source(
            "viterbi-parent", args.parent.read_text()))), scratch_always=True)

    inputs = {shape: rows_input(*shape, dev) for shape in SHAPES}
    cases = [(f"{n} x {s}", x, s - 6, True) for (n, s), x in inputs.items()]
    cases += [(name, torch.from_numpy(r).to(dev), n_bits, soft)
              for name, r, n_bits, soft in viterbi_corpora(long=True)]
    for what, x, n_bits, soft in cases:
        want = convcode.viterbi_decode_plain(x, n_bits, soft).reshape(-1, n_bits)
        rows = convcode._rows(x, n_bits, soft)[0].contiguous()
        for name, call in designs.items():
            got = call(rows, n_bits, soft)
            torch.cuda.synchronize()
            if name not in UNCHECKED and not torch.equal(got, want):
                raise SystemExit(f"{name} differs from the plain version on {what}")
    print(f"check: {', '.join(d for d in designs if d not in UNCHECKED)} == plain bit for bit "
          f"on {len(cases)} inputs: {', '.join(c[0] for c in cases)}")
    if args.check_only:
        return
    order = list(designs)
    if "parent" in order:
        order.remove("parent")
        order = ["parent", *order]
    order = order + order[::-1]
    for (n, s), x in inputs.items():
        chain = math.ceil(s / 4)
        for name in order:
            call = designs[name]

            def fn(call=call, x=x, s=s):
                return call(x, s - 6)

            g = smoke.graph_ms(torch, fn)
            prof, traced = smoke.traced_ms(torch, fn, "viterbi_kernel", args.runs)
            print(f"time: {name} {n} x {s} steps: device {g:.5f} ms a launch (graph of "
                  f"{smoke.GRAPH_LAUNCHES}, median of {smoke.GRAPH_REPLAYS}), profiler "
                  + ("none traced" if prof is None else f"{prof:.5f} ms (median of {traced} of "
                     f"{args.runs} traced)")
                  + f", one call {smoke.time_ms(torch, fn, args.runs):.5f} ms (events), host "
                  f"{smoke.host_ms(torch, fn):.5f} ms, {1e3 * g / chain:.4f} us a block step "
                  f"({chain} block steps) [{card}]")
    # the wrapper itself
    for (n, s), x in inputs.items():
        def fn(x=x, s=s):
            return convcode.viterbi_decode(x, s - 6, True)

        print(f"time: wrapper {n} x {s} steps: device {smoke.graph_ms(torch, fn):.5f} ms, one "
              f"call {smoke.time_ms(torch, fn, args.runs):.5f} ms (events), host "
              f"{smoke.host_ms(torch, fn):.5f} ms [{card}]")


if __name__ == "__main__":
    main()
