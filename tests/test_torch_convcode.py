"""The port's convolutional code and Viterbi decoder
(``trackmaker_tpu_torch.core.convcode``) against the JAX package's, on the
CPU; and a NumPy twin of ``csrc/viterbi.cu``'s schedule (a thread a state,
16 paths a block of 4 steps, the traceback by one thread) against the
plain version, so that the kernel's indexing is checked where no card is.

The corpora (:func:`viterbi_corpora`) are built without JAX, from seeded
NumPy and the port's encoder, so ``tests/test_torch_kernels_gpu.py`` and
``chip_smoke.py`` hold the kernel against the plain version on them; this
module imports JAX only inside its tests.

Tolerances: none.  The encoder, the puncture, the interleaver and the
tables are integers; the decoder's decisions are compared bit for bit,
ties made by rounding included (the 1/8-grid corpus and the all-zero row
tie on purpose).
"""

import numpy as np
import pytest
import torch

from trackmaker_tpu_torch.core import convcode

# every n_steps mod 4 (n_steps = n_bits + 6): 56 -> 2, 57 -> 3, 58 -> 0, 59 -> 1
TAIL_BITS = (56, 57, 58, 59)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread while this module runs: the suite runs a worker per
    core, and torch's own thread pool on top of that oversubscribes them."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _encode(bits: np.ndarray) -> np.ndarray:
    return convcode.conv_encode(torch.from_numpy(bits)).numpy()


def viterbi_corpora(big: int = 0) -> list[tuple[str, np.ndarray, int, bool]]:
    """(name, received [N, 2*(n_bits+6)], n_bits, soft) corpora: soft rows
    clean, noisy (sigma 0.5) and very noisy (sigma 1.5) at every tail; hard
    rows clean, with 4% of the coded bits flipped, and random; a ties corpus
    of soft values on a 1/8 grid with a row of all zeros; depunctured
    rate-3/4 blocks; one row alone.  With `big`, also `big` noisy rows of
    the payload block of a 64-byte coded frame (518 trellis steps)."""
    rng = np.random.default_rng(23)
    out = []
    for n_bits in TAIL_BITS:
        bits = rng.integers(0, 2, (6, n_bits)).astype(np.uint8)
        tx = 2.0 * _encode(bits).astype(np.float32) - 1.0
        for sigma, what in ((0.0, "clean"), (0.5, "noisy"), (1.5, "very noisy")):
            soft = (tx + rng.normal(0, sigma, tx.shape)).astype(np.float32)
            out.append((f"soft {what}, n_bits {n_bits}", soft, n_bits, True))
        coded = _encode(bits)
        flipped = coded ^ (rng.random(coded.shape) < 0.04).astype(np.uint8)
        out.append((f"hard clean, n_bits {n_bits}", coded, n_bits, False))
        out.append((f"hard 4% flipped, n_bits {n_bits}", flipped, n_bits, False))
        out.append((f"hard random, n_bits {n_bits}", rng.integers(0, 2, coded.shape)
                    .astype(np.uint8), n_bits, False))
        grid = (rng.integers(-8, 9, (6, 2 * (n_bits + 6))) / 8).astype(np.float32)
        grid[0] = 0.0
        out.append((f"ties on a 1/8 grid, n_bits {n_bits}", grid, n_bits, True))
    for n_bits in (56, 200):
        bits = rng.integers(0, 2, (6, n_bits)).astype(np.uint8)
        coded = _encode(bits)
        kept = convcode.puncture_34(torch.from_numpy(coded)).numpy()
        soft = (2.0 * kept - 1.0 + rng.normal(0, 0.6, kept.shape)).astype(np.float32)
        dep = convcode.depuncture_34(torch.from_numpy(soft), coded.shape[-1]).numpy()
        out.append((f"rate 3/4 depunctured, n_bits {n_bits}", dep, n_bits, True))
    bits = rng.integers(0, 2, (1, 13)).astype(np.uint8)
    out.append(("one row", (2.0 * _encode(bits) - 1.0 + rng.normal(0, 0.8, (1, 38)))
                .astype(np.float32), 13, True))
    if big:
        bits = rng.integers(0, 2, (big, 512)).astype(np.uint8)
        soft = (2.0 * _encode(bits) - 1.0 + rng.normal(0, 0.9, (big, 1036))).astype(np.float32)
        out.append((f"{big} rows of 518 steps", soft, 512, True))
    return out


def kernel_twin(received: np.ndarray, n_bits: int, soft: bool) -> np.ndarray:
    """csrc/viterbi.cu's schedule in NumPy f32, the 64 threads of a block as
    one vector: each block of 4 steps walks the 16 paths j = c4 c3 c2 c1 from
    s4 = s back by s_{i-1} = 2 (s_i % 32) + c_i, adds bm(s_i, c_i) in trellis
    order with bm from the register's parity, keeps the first maximum; the
    tail at radix 1; then one thread's traceback, tail first."""
    f = np.float32
    n_steps = n_bits + 6
    q, rem = divmod(n_steps, 4)
    s = np.arange(64)

    def parity(x):
        return np.array([bin(int(v)).count("1") & 1 for v in x])

    def branch(st, c, r0, r1):
        reg = ((st >> 5) << 6) | (2 * (st & 31) + c)
        a = np.where(parity(reg & convcode.G0), r0, -r0).astype(f)
        b = np.where(parity(reg & convcode.G1), r1, -r1).astype(f)
        return a + b

    out = []
    for row in received.reshape(-1, 2 * n_steps).astype(f):
        if not soft:
            row = f(2.0) * row + f(-1.0)
        pm = np.full(64, -1e9, f)
        pm[0] = 0.0
        choices = []
        for blk in range(q):
            rv = row[8 * blk: 8 * blk + 8]
            best, best_j = None, np.zeros(64, np.int64)
            for j in range(16):
                c1, c2, c3, c4 = j & 1, (j >> 1) & 1, (j >> 2) & 1, j >> 3
                s3 = 2 * (s & 31) + c4
                s2 = 2 * (s3 & 31) + c3
                s1 = 2 * (s2 & 31) + c2
                s0 = 2 * (s1 & 31) + c1
                v = pm[s0]
                v = v + branch(s1, c1, rv[0], rv[1])
                v = v + branch(s2, c2, rv[2], rv[3])
                v = v + branch(s3, c3, rv[4], rv[5])
                v = v + branch(s, c4, rv[6], rv[7])
                if best is None:
                    best = v
                else:
                    take = v > best
                    best, best_j = np.where(take, v, best), np.where(take, j, best_j)
            pm = best.astype(f)
            choices.append(best_j)
        for i in range(rem):
            t = 4 * q + i
            a = pm[2 * (s & 31)] + branch(s, 0, row[2 * t], row[2 * t + 1])
            b = pm[2 * (s & 31) + 1] + branch(s, 1, row[2 * t], row[2 * t + 1])
            choices.append((b > a).astype(np.int64))
            pm = np.where(b > a, b, a).astype(f)
        bits = np.zeros(n_steps, np.uint8)
        state = 0
        for i in range(rem - 1, -1, -1):
            bits[4 * q + i] = state >> 5
            state = 2 * (state & 31) + int(choices[q + i][state])
        for blk in range(q - 1, -1, -1):
            j = int(choices[blk][state])
            for i in range(4):
                bits[4 * blk + 3 - i] = state >> 5
                state = 2 * (state & 31) + ((j >> (3 - i)) & 1)
        out.append(bits[:n_bits])
    return np.stack(out).reshape(*received.shape[:-1], n_bits)


# --- the code's tables and helpers ------------------------------------------------------------


def test_tables_equal_jax():
    from trackmaker_tpu.core import convcode as jc

    for name in ("_REG", "_OUT0", "_OUT1", "_NEXT", "_PRED", "_PBIT", "_POUT", "_PUNCT_34"):
        np.testing.assert_array_equal(getattr(convcode, name), getattr(jc, name), name)
    assert (convcode.K, convcode.NSTATES, convcode.G0, convcode.G1) == (jc.K, jc.NSTATES,
                                                                         jc.G0, jc.G1)


def test_pout_is_the_kernels_parity_rule():
    """pout(s, c, k) = parity(((s >> 5) << 6 | (2 (s % 32) + c)) & G_k), as
    csrc/viterbi.cu computes it; and the predecessor is 2 (s % 32) + c."""
    for s in range(64):
        for c in range(2):
            reg = ((s >> 5) << 6) | (2 * (s % 32) + c)
            for k, g in enumerate((convcode.G0, convcode.G1)):
                assert convcode._POUT[s, c, k] == bin(reg & g).count("1") % 2
            assert convcode._PRED[s, c] == 2 * (s % 32) + c
        assert convcode._PBIT[s] == s >> 5


@pytest.mark.parametrize("n", [0, 1, 7, 56, 200])
def test_conv_encode_equals_jax(n):
    import jax.numpy as jnp

    from trackmaker_tpu.core import convcode as jc

    bits = np.random.default_rng(n).integers(0, 2, (3, n)).astype(np.uint8)
    want = np.stack([np.asarray(jc.conv_encode(jnp.asarray(b))) for b in bits])
    got = convcode.conv_encode(torch.from_numpy(bits))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(convcode.conv_encode(torch.from_numpy(bits[0])).numpy(),
                                  want[0])


@pytest.mark.parametrize("n_coded", [12, 124, 125, 1036, 4108])
def test_puncture_and_interleaver_equal_jax(n_coded):
    import jax.numpy as jnp

    from trackmaker_tpu.core import convcode as jc

    rng = np.random.default_rng(n_coded)
    coded = rng.integers(0, 2, (2, n_coded)).astype(np.uint8)
    kept = convcode.puncture_34(torch.from_numpy(coded)).numpy()
    np.testing.assert_array_equal(kept, np.asarray(jc.puncture_34(jnp.asarray(coded))))
    assert convcode.punctured_len_34(n_coded) == jc.punctured_len_34(n_coded) == kept.shape[-1]
    soft = rng.normal(0, 1, kept.shape).astype(np.float32)
    np.testing.assert_array_equal(
        convcode.depuncture_34(torch.from_numpy(soft), n_coded).numpy(),
        np.asarray(jc.depuncture_34(jnp.asarray(soft), n_coded)))
    for m in (n_coded, kept.shape[-1]):
        np.testing.assert_array_equal(convcode.block_interleaver(m), jc.block_interleaver(m))


# --- the decoder -------------------------------------------------------------------------------


def _jax_decode(received: np.ndarray, n_bits: int, soft: bool) -> np.ndarray:
    """The JAX package's default decode (radix 4), row by row under vmap."""
    import jax
    import jax.numpy as jnp

    from trackmaker_tpu.core import convcode as jc

    assert jc.VITERBI_RADIX == 4
    rows = received.reshape(-1, received.shape[-1])
    out = jax.vmap(lambda r: jc.viterbi_decode(r, n_bits, soft=soft))(jnp.asarray(rows))
    return np.asarray(out).reshape(*received.shape[:-1], n_bits)


CORPORA = viterbi_corpora()


@pytest.mark.parametrize("name,received,n_bits,soft", CORPORA, ids=[c[0] for c in CORPORA])
def test_plain_viterbi_equals_jax(name, received, n_bits, soft):
    got = convcode.viterbi_decode(torch.from_numpy(received), n_bits, soft=soft)
    assert got.dtype == torch.uint8 and got.shape == (*received.shape[:-1], n_bits)
    np.testing.assert_array_equal(got.numpy(), _jax_decode(received, n_bits, soft), name)


def test_plain_viterbi_decodes_batched_rows():
    """Leading axes are rows: a [2, 3, L] batch decodes as its six rows."""
    _, received, n_bits, soft = CORPORA[1]
    batch = received.reshape(2, 3, -1)
    got = convcode.viterbi_decode_plain(torch.from_numpy(batch), n_bits, soft)
    np.testing.assert_array_equal(got.reshape(6, n_bits).numpy(),
                                  _jax_decode(received, n_bits, soft))


def test_clean_rows_decode_their_bits():
    rng = np.random.default_rng(5)
    bits = rng.integers(0, 2, (4, 100)).astype(np.uint8)
    coded = _encode(bits)
    np.testing.assert_array_equal(convcode.viterbi_decode(torch.from_numpy(coded), 100).numpy(),
                                  bits)
    soft = (2.0 * coded - 1.0).astype(np.float32)
    np.testing.assert_array_equal(
        convcode.viterbi_decode(torch.from_numpy(soft), 100, soft=True).numpy(), bits)


@pytest.mark.parametrize("name,received,n_bits,soft", CORPORA[::3], ids=[c[0] for c in CORPORA[::3]])
def test_kernel_schedule_equals_plain(name, received, n_bits, soft):
    np.testing.assert_array_equal(
        kernel_twin(received, n_bits, soft),
        convcode.viterbi_decode_plain(torch.from_numpy(received), n_bits, soft).numpy(), name)


def test_cpu_tensors_run_the_plain_decoder():
    before = convcode.viterbi_decode.launches
    _, received, n_bits, soft = CORPORA[2]
    x = torch.from_numpy(received)
    assert torch.equal(convcode.viterbi_decode(x, n_bits, soft),
                       convcode.viterbi_decode_plain(x, n_bits, soft))
    assert convcode.viterbi_decode.launches == before


def test_decoder_refuses_a_wrong_length():
    with pytest.raises(ValueError):
        convcode.viterbi_decode(torch.zeros(2, 20), 5)
    with pytest.raises(ValueError):
        convcode.viterbi_decode(torch.zeros(12), -1)
    assert convcode.viterbi_decode(torch.zeros(3, 12), 0).shape == (3, 0)
