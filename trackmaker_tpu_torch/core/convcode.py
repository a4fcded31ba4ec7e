"""Rate-1/2 K=7 convolutional code and its Viterbi decoder (counterpart of
``trackmaker_tpu/core/convcode.py``).

The (133, 171)_8 code: ``conv_encode`` XORs shifted copies of the
zero-flushed input for each of the two output streams; rate 3/4 punctures
the mother code with the pattern [11, 10, 01] and re-enters the erased
positions as soft 0.0.  ``block_interleaver`` is the JAX package's
permutation, a NumPy generator seeded by the block length.

``viterbi_decode`` decides as the JAX package's default decode does, a
scan of radix 4: each step of the scan covers 4 trellis steps, and state
s keeps the first maximum of its 16 paths j = c4·8 + c3·4 + c2·2 + c1
(c4 the choice at the block's last step), each path's value added in
trellis order in f32, ``(((m[s0] + bm1) + bm2) + bm3) + bm4``.  The last
``n_steps mod 4`` steps take radix 1 (choice 1 where its value is
strictly larger), and the traceback from state 0 undoes that tail first,
then the blocks.  Radix 4 is not radix 1 written faster: where ``a + c``
and ``b + c`` round to one f32 value with ``a != b`` the two rules part,
so the port computes radix 4's decisions exactly.

On a CUDA tensor ``viterbi_decode`` launches ``csrc/viterbi.cu`` (one
block of 64 threads a row, a thread a state, the received values staged and
the choices kept in shared memory, one launch a call); on a CPU tensor it
runs :func:`viterbi_decode_plain`, the same radix-4 rule as tensor ops
batched over rows.  Decisions are defined for finite inputs.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from trackmaker_tpu_torch import _build

K = 7
NSTATES = 64
G0 = 0o133
G1 = 0o171
RADIX = 4


def _parity(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint32)
    x ^= x >> 4
    x ^= x >> 2
    x ^= x >> 1
    return (x & 1).astype(np.uint8)


# Transition tables: for state s (6 bits of history, the newest in the
# MSB) and input bit b, the register is (b << 6) | s.
_REG = (np.arange(2)[:, None] << 6) | np.arange(NSTATES)[None, :]
_OUT0 = _parity(_REG & G0)      # (2, 64) first output bit
_OUT1 = _parity(_REG & G1)      # (2, 64) second output bit
_NEXT = (_REG >> 1).astype(np.int32)   # (2, 64) next state
# predecessor view: state s has two predecessors, 2 (s % 32) + c for
# c = 0, 1, entered on the input bit s >> 5
_PRED = np.zeros((NSTATES, 2), np.int32)
_PBIT = np.zeros((NSTATES,), np.int32)
_POUT = np.zeros((NSTATES, 2, 2), np.uint8)  # [s, which_pred, stream]
for _b in range(2):
    for _s in range(NSTATES):
        _ns = _NEXT[_b, _s]
        _PRED[_ns, _s & 1] = _s
        _PBIT[_ns] = _b
        _POUT[_ns, _s & 1, 0] = _OUT0[_b, _s]
        _POUT[_ns, _s & 1, 1] = _OUT1[_b, _s]
_POUT_PM = _POUT.astype(np.float32) * 2.0 - 1.0    # (64, 2, 2) as +-1

# Rate 3/4: per 3 input steps (6 coded bits, [c0 c1] pairs) transmit
# [11, 10, 01]; the erased positions decode as soft 0.0.
_PUNCT_34 = np.array([1, 1, 1, 0, 0, 1], dtype=bool)


@functools.lru_cache(maxsize=256)
def _punct_idx(n_coded: int) -> np.ndarray:
    """Indices of the transmitted positions of an n_coded-bit mother block."""
    reps = -(-n_coded // 6)
    mask = np.tile(_PUNCT_34, reps)[:n_coded]
    return np.nonzero(mask)[0]


def punctured_len_34(n_coded: int) -> int:
    return len(_punct_idx(n_coded))


@functools.lru_cache(maxsize=64)
def _punct_index(n_coded: int, device: torch.device) -> torch.Tensor:
    """:func:`_punct_idx` on `device`, copied there once a process."""
    return torch.from_numpy(_punct_idx(n_coded)).to(device)


def puncture_34(coded: torch.Tensor) -> torch.Tensor:
    """[..., n_coded] rate-1/2 output -> [..., ~2n/3] transmitted bits."""
    return coded[..., _punct_index(coded.shape[-1], coded.device)]


def depuncture_34(soft: torch.Tensor, n_coded: int) -> torch.Tensor:
    """Transmitted soft values -> [..., n_coded] with 0.0 erasures."""
    out = torch.zeros((*soft.shape[:-1], n_coded), dtype=soft.dtype, device=soft.device)
    out[..., _punct_index(n_coded, soft.device)] = soft
    return out


@functools.lru_cache(maxsize=128)
def block_interleaver(m: int) -> np.ndarray:
    """The pseudorandom permutation of an m-bit coded block: both ends derive
    it from the length alone, so a burst of weak wire positions lands spread
    over the Viterbi decoder's span."""
    return np.random.default_rng(0x1EAF ^ m).permutation(m)


def conv_encode(bits: torch.Tensor) -> torch.Tensor:
    """uint8[..., N] -> uint8[..., 2*(N+K-1)], the register flushed by K-1
    zeros; the two streams interleave as [c0 c1] pairs."""
    bits = bits.to(torch.uint8)
    zeros = torch.zeros((*bits.shape[:-1], K - 1), dtype=torch.uint8, device=bits.device)
    bits = torch.cat([bits, zeros], dim=-1)
    n = bits.shape[-1]
    # the register starts cleared: output t reads bits t, t-1, ..., t-6
    padded = torch.cat([zeros, bits], dim=-1)

    def stream(g: int) -> torch.Tensor:
        acc = torch.zeros_like(bits)
        for i in range(K):
            if (g >> (K - 1 - i)) & 1:
                acc = acc ^ padded[..., K - 1 - i:K - 1 - i + n]
        return acc

    return torch.stack([stream(G0), stream(G1)], dim=-1).reshape(*bits.shape[:-1], 2 * n)


# --- the Viterbi decoder ------------------------------------------------------------


def _rows(received: torch.Tensor, n_bits: int, soft: bool) -> tuple[torch.Tensor, int]:
    """(received as f32 rows [N, 2*n_steps], n_steps) after the shape check."""
    n_steps = n_bits + K - 1
    if n_bits < 0 or received.shape[-1] != 2 * n_steps:
        raise ValueError(f"received [..., {received.shape[-1]}] is not 2*(n_bits+{K - 1}) = "
                         f"{2 * n_steps} values")
    return received.reshape(-1, 2 * n_steps).to(torch.float32), n_steps


def _branch(pout: torch.Tensor, rt: torch.Tensor) -> torch.Tensor:
    """bm[n, s, c] = pout[s, c, 0]·r0 + pout[s, c, 1]·r1 for rt f32[N, 2]."""
    return (pout[None, :, :, 0] * rt[:, 0, None, None]
            + pout[None, :, :, 1] * rt[:, 1, None, None])


def _expand(pout: torch.Tensor, acc: torch.Tensor, rt: torch.Tensor) -> torch.Tensor:
    """acc [N, 64, *prev choices] -> [N, 64, 2, *prev choices] after one more
    trellis step: state s's predecessor 2 (s % 32) + c on the new axis."""
    n, tail = acc.shape[0], acc.shape[2:]
    pred = acc.reshape(n, 32, 2, *tail).repeat(1, 2, *([1] * (len(tail) + 1)))
    return pred + _branch(pout, rt).reshape(n, NSTATES, 2, *([1] * len(tail)))


def viterbi_decode_plain(received: torch.Tensor, n_bits: int,
                         soft: bool = False) -> torch.Tensor:
    """Plain PyTorch version of :func:`viterbi_decode`: the radix-4 rule of
    the module docstring, batched over rows, a loop over blocks."""
    lead = received.shape[:-1]
    r, n_steps = _rows(received, n_bits, soft)
    if not soft:
        r = 2.0 * r - 1.0
    n = r.shape[0]
    dev = r.device
    r = r.reshape(n, n_steps, 2)
    pout = torch.from_numpy(_POUT_PM).to(dev)
    q, rem = divmod(n_steps, RADIX)
    metrics = torch.full((n, NSTATES), -1e9, dtype=torch.float32, device=dev)
    metrics[:, 0] = 0.0
    choices = []
    for blk in range(q):
        acc = metrics
        for i in range(RADIX):
            acc = _expand(pout, acc, r[:, RADIX * blk + i])
        flat = acc.reshape(n, NSTATES, 1 << RADIX)     # j = c4 c3 c2 c1
        metrics, choice = flat.amax(-1), flat.argmax(-1)
        choices.append(choice)
    tail = []
    for i in range(rem):
        cand = _expand(pout, metrics, r[:, q * RADIX + i])     # [N, 64, 2]
        metrics, choice = cand.amax(-1), cand.argmax(-1)
        tail.append(choice)
    state = torch.zeros((n, 1), dtype=torch.int64, device=dev)
    bits = torch.zeros((n, n_steps), dtype=torch.uint8, device=dev)
    for i in range(rem - 1, -1, -1):
        c = tail[i].gather(1, state)
        bits[:, q * RADIX + i] = (state[:, 0] >> 5).to(torch.uint8)
        state = 2 * (state % 32) + c
    for blk in range(q - 1, -1, -1):
        j = choices[blk].gather(1, state)
        for i in range(RADIX):
            bits[:, RADIX * blk + RADIX - 1 - i] = (state[:, 0] >> 5).to(torch.uint8)
            state = 2 * (state % 32) + ((j >> (RADIX - 1 - i)) & 1)
    return bits[:, :n_bits].reshape(*lead, n_bits)


# The kernel's shared memory (csrc/viterbi.cu): two metric buffers, the
# (P, M) sums of up to WINDOW trellis steps (a whole row, or a ring of two
# halves for a longer one), and the choices, a byte a state a block step,
# when they fit in Hopper's opt-in 227 KB; tm_viterbi decides the same way.
WINDOW = 4096
SMEM_MAX = 232_448
_METRIC_BYTES = 2 * NSTATES * 4


def choices_fit(n_steps: int) -> bool:
    """True when a row of n_steps keeps its choices in shared memory; else
    the wrapper hands the kernel a scratch in device memory."""
    window = WINDOW if n_steps > WINDOW else n_steps + (n_steps & 1)
    q, rem = divmod(n_steps, RADIX)
    return _METRIC_BYTES + 8 * window + (q + rem) * NSTATES <= SMEM_MAX


_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]


def viterbi_decode(received: torch.Tensor, n_bits: int, soft: bool = False) -> torch.Tensor:
    """Decode [..., 2*(n_bits+K-1)] received values -> uint8[..., n_bits].

    `received`: hard bits (0/1, mapped to 2r - 1) or, with soft=True, soft
    values where +1 means coded bit 1 and 0.0 an erasure.  Every row is one
    flushed code block decoded from state 0 to state 0.  One kernel launch
    for all rows on a CUDA tensor; the plain version on a CPU tensor."""
    if not _build.on_cuda(received):
        return viterbi_decode_plain(received, n_bits, soft)
    lead = received.shape[:-1]
    r, n_steps = _rows(received, n_bits, soft)
    r = r.contiguous()
    n = r.shape[0]
    out = torch.empty((n, n_bits), dtype=torch.uint8, device=r.device)
    if n == 0:
        return out.reshape(*lead, n_bits)
    scratch = None
    if not choices_fit(n_steps):
        q, rem = divmod(n_steps, RADIX)
        scratch = torch.empty((n, q + rem, NSTATES), dtype=torch.uint8, device=r.device)
    fn = _build.entry("viterbi", "tm_viterbi", _ARGTYPES)
    err = fn(r.data_ptr(), n, n_steps, n_bits, int(not soft),
             None if scratch is None else scratch.data_ptr(), out.data_ptr(), _build.stream_ptr(r))
    _build.check(err, "viterbi")
    viterbi_decode.launches += 1
    return out.reshape(*lead, n_bits)


viterbi_decode.launches = 0
