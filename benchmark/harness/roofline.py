"""The yardstick of the kernels' roofline shares: peaks, operations, bytes.

The least time of a piece of work is the larger of its operations over the
chip's float32 rate and its bytes over the chip's memory bandwidth, with
each input byte read once and each output byte written once.  Operations
and bytes are worked out from a request's shapes and from the live
candidates its recordings hold, so they read the same work whatever
implements the kernel.  The counts are those the port's kernel table was
bounded by (``chip_smoke.py:bound`` and its per-kernel counts), frozen
here.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (NVIDIA data sheet)
F32_OPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores

# the attempt kernel each line code launches
ATTEMPT_KERNELS = {"manchester": "attempt_manchester_kernel", "4b5b": "attempt_4b5b_kernel"}
ROW_LAGS = 128              # lags of one hit row
ROW_INTS = 16               # int32 words of one hit row
FRAME_BYTES = 263           # the largest frame: 7 header bytes and a 256-byte body
BIT_SAMPLES = 6             # samples of one Manchester bit
ZERO_SYMBOLS = 640          # 4B5B symbols an attempt searches for a near-zero level
SYMBOL_SAMPLES = 15         # samples of one 4B5B symbol


def least_seconds(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """(least seconds, what sets it) of work moving `n_bytes`, doing `n_ops`."""
    by_bytes = n_bytes / HBM_BYTES_PER_S
    by_ops = n_ops / F32_OPS_PER_S
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def xcorr_hits(b: int, t: int, l: int) -> tuple[float, float]:
    """(bytes, operations) of one correlation and hit-row launch over
    captures f32[b, t] and a pattern of l samples: the captures in, the hit
    rows out; l multiply-adds for the dot and for the energy at each lag."""
    n_lags = t - l + 1
    n_rows = -(-t // ROW_LAGS)
    return b * t * 4 + b * n_rows * ROW_INTS * 4, b * n_lags * 4 * l


def _attempt_parts(line_coding: str) -> tuple[int, int, int, int]:
    """(body samples, output bytes a slot, refine operations, decode
    operations) of one candidate's attempt."""
    if line_coding == "manchester":
        # 13 positions x 48 sync taps (4 ops), 2,104 bits of 6 ops
        return FRAME_BYTES * 8 * BIT_SAMPLES, FRAME_BYTES + 4, 13 * 48 * 4, FRAME_BYTES * 8 * 6
    # 31 positions x 30 sync taps (4 ops), 3,200 levels of 2 adds, a product, a compare
    return ZERO_SYMBOLS * SYMBOL_SAMPLES, FRAME_BYTES + 12, 31 * 30 * 4, ZERO_SYMBOLS * 5 * 4


def attempt(line_coding: str, b: int, t: int, n_cand: int, live: int) -> tuple[float, float]:
    """(bytes, operations) of one attempt launch over captures f32[b, t]
    with tables of n_cand candidates, `live` of them live: the captures
    in, the candidates, their counts and the valid lengths in, each slot's
    frame bytes and start out; each live candidate's refine and decode."""
    _, out_per_slot, refine_ops, decode_ops = _attempt_parts(line_coding)
    small_in = 3 * b * 4 + b * n_cand * 4
    return (b * t * 4 + small_in + b * n_cand * out_per_slot,
            live * (refine_ops + decode_ops))


def attempt_shared(line_coding: str, n_blocks: int, samples: int, n_cand: int,
                   live: int) -> tuple[float, float]:
    """(bytes, operations) of one shared-capture attempt launch: the
    samples its live candidates' windows need (at most the whole capture of
    `samples`), the tables and valid lengths in, each slot's output; each
    live candidate's refine and decode."""
    body, out_per_slot, refine_ops, decode_ops = _attempt_parts(line_coding)
    refine_span = 13 + 47 if line_coding == "manchester" else 31 + 29
    slots = n_blocks * n_cand
    reads = min(samples, live * (body + refine_span)) * 4
    small = slots * 4 + n_blocks * 4 * 2
    return reads + small + slots * out_per_slot, live * (decode_ops + refine_ops)


def spec_walk(b: int, n_cand: int) -> tuple[float, float]:
    """(bytes, operations) of one walk launch: the fields in, keep and
    attempted flags, done and three ints a capture out; a few integer
    operations a candidate."""
    return b * 4 * n_cand * 4 + 2 * b * 4 + 2 * b * n_cand + b + 3 * b * 4, b * n_cand * 4
