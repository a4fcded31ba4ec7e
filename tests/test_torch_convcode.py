"""The port's convolutional code and Viterbi decoder
(``trackmaker_tpu_torch.core.convcode``) against the JAX package's, on the
CPU; and a NumPy twin of ``csrc/viterbi.cu``'s schedule (the staging of
the ±(r0 ± r1) sums, a whole row or a ring of two halves; a thread a state
with the labels' split into the state's and each path's constant part;
the first maximum's tree; the tail, the traceback by one thread and the
bits expanded from the block ends) against JAX's decode and the plain
version, so that the kernel's indexing is checked where no card is; the
identities the ±P / ±M sums rest on; and the wrapper's arguments.

The corpora (:func:`viterbi_corpora`) are built without JAX, from seeded
NumPy and the port's encoder, so ``tests/test_torch_kernels_gpu.py`` and
``chip_smoke.py`` hold the kernel against the plain version on them; this
module imports JAX only inside its tests.

Tolerances: none.  The encoder, the puncture, the interleaver and the
tables are integers; the decoder's decisions are compared bit for bit,
ties made by rounding included (the 1/8-grid corpus, the all-zero row and
the ties between the tree's halves tie on purpose).
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


def viterbi_corpora(big: int = 0, long: bool = False) -> list[tuple[str, np.ndarray, int, bool]]:
    """(name, received [N, 2*(n_bits+6)], n_bits, soft) corpora: soft rows
    clean, noisy (sigma 0.5) and very noisy (sigma 1.5) at every tail; hard
    rows clean, with 4% of the coded bits flipped, and random; a ties corpus
    of soft values on a 1/8 grid with a row of all zeros; depunctured
    rate-3/4 blocks; one row alone; ties between the halves of the
    kernel's first-maximum tree (values of -1/2, 0 and 1/2, where equal
    path values meet at j <= 3 and j >= 12).  With `big`, also `big` noisy
    rows of the payload block of a 64-byte coded frame (518 trellis steps).
    With `long`, also the rows the kernel's staging and choices meet at
    their limits: one row of 62 steps (a header), one of 2,054 (a 263-byte
    frame's payload), two of 6,145 (the staging ring, the tail at a half's
    start, the second row not 16-byte aligned), one of 12,448 (the longest
    whose choices fit in shared memory: the budget's edge) and two of
    16,006 (choices past the shared memory)."""
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
    split = np.random.default_rng(24)
    for n_bits in (56, 58):
        vals = (split.integers(-1, 2, (8, 2 * (n_bits + 6))) / 2).astype(np.float32)
        vals[0, :40] = 0.0
        out.append((f"ties between the tree's halves, n_bits {n_bits}", vals, n_bits, True))
    if long:
        for rows, n_bits, what in ((1, 56, "one row of 62 steps"),
                                   (1, 2048, "one row of 2,054 steps"),
                                   (2, 6139, "two rows of 6,145 steps (the staging ring)"),
                                   (1, 12442, "one row of 12,448 steps (the shared memory's edge)"),
                                   (2, 16000,
                                    "two rows of 16,006 steps (choices in device memory)")):
            bits = split.integers(0, 2, (rows, n_bits)).astype(np.uint8)
            tx = 2.0 * _encode(bits) - 1.0
            out.append((what, (tx + split.normal(0, 0.9, tx.shape)).astype(np.float32), n_bits,
                        True))
    return out


def label(s: int, j: int, i: int) -> int:
    """csrc/viterbi.cu's label(): the branch metric at step i (1..4) of a
    block for state s and path j is +P (0), +M (1), -P (2) or -M (3), with
    P = r0 + r1 and M = r0 - r1: bit 0 the M family, bit 1 negated."""
    st = s
    for k in range(4, i, -1):
        st = 2 * (st & 31) + ((j >> (k - 1)) & 1)
    reg = ((st >> 5) << 6) | (2 * (st & 31) + ((j >> (i - 1)) & 1))
    a0 = bin(reg & convcode.G0).count("1") & 1
    a1 = bin(reg & convcode.G1).count("1") & 1
    return (a0 ^ a1) | ((a0 ^ 1) << 1)


def first_max(v: np.ndarray, ties: list | None = None):
    """The kernel's first_max over the last axis (16 paths): a tree in which
    the right value, the higher j, wins only when strictly larger.  Returns
    (value, j); `ties` collects (winner's j, loser's j) where equal values
    met."""
    v = v.copy()
    n = v.shape[-1]
    idx = np.broadcast_to(np.arange(n), v.shape).copy()
    w = 1
    while w < n:
        for k in range(0, n - w, 2 * w):
            take = v[..., k + w] > v[..., k]
            if ties is not None:
                eq = v[..., k + w] == v[..., k]
                ties.extend(zip(idx[..., k][eq].tolist(), idx[..., k + w][eq].tolist()))
            v[..., k] = np.where(take, v[..., k + w], v[..., k])
            idx[..., k] = np.where(take, idx[..., k + w], idx[..., k])
        w *= 2
    return v[..., 0], idx[..., 0]


def kernel_twin(received: np.ndarray, n_bits: int, soft: bool, window: int = convcode.WINDOW,
                ties: list | None = None) -> np.ndarray:
    """csrc/viterbi.cu's schedule in NumPy f32, the 64 threads of a block
    and the rows as array axes: thread h holds state h.  The staging buffer
    of `window` steps (the kernel's is convcode.WINDOW) holds a whole row,
    or a ring of two halves, each half converted to (P, M) at its start and
    the half after it copied into the half just read, as the kernel does;
    every read asserts that the slot holds the step it wants, converted.
    Each thread adds its 16 paths from the metrics at 16 (h % 4) + j
    through the four steps, each addend its state's value X or the other
    family's Y by the path's constant label part, negated by the part;
    keeps their first maximum by :func:`first_max`.  The tail at radix 1,
    then thread 0's traceback writing each block's end state over its first
    choice byte, and the bits expanded from those."""
    f = np.float32
    n_steps = n_bits + 6
    q, rem = divmod(n_steps, 4)
    rows = received.reshape(-1, 2 * n_steps).astype(f)
    n = rows.shape[0]
    ring = n_steps > window
    width = window if ring else n_steps + (n_steps & 1)
    half = window // 2
    assert window % 8 == 0
    base = np.array([[label(h, 0, i) for i in range(1, 5)] for h in range(64)])   # [64, 4]
    sel, neg = (base & 1).astype(bool), (base >> 1).astype(bool)
    part = np.array([[label(0, j, i) for i in range(1, 5)] for j in range(16)])  # [16, 4]
    psel, pneg = (part & 1).astype(bool), ((part >> 1) ^ 1).astype(bool)
    pred = 16 * (np.arange(64)[:, None] & 3) + np.arange(16)                    # [64, 16]

    stage = np.full((n, width, 2), np.nan, f)
    held = np.full(width, -1)           # the trellis step a slot holds
    converted = np.zeros(width, bool)

    def copy(a, e):
        pos = a % width
        stage[:, pos:pos + e - a] = rows[:, 2 * a:2 * e].reshape(n, e - a, 2)
        held[pos:pos + e - a] = np.arange(a, e)
        converted[pos:pos + e - a] = False

    def convert(a, e):
        pos = a % width
        r = stage[:, pos:pos + e - a]
        if not soft:
            r = f(2.0) * r + f(-1.0)
        stage[:, pos:pos + e - a] = np.stack([r[..., 0] + r[..., 1], r[..., 0] - r[..., 1]], -1)
        converted[pos:pos + e - a] = True

    def read(t, k):
        pos = t % width
        assert (held[pos:pos + k] == np.arange(t, t + k)).all() and converted[pos:pos + k].all()
        return stage[:, pos:pos + k]

    copy(0, min(n_steps, width))
    convert(0, min(n_steps, width))
    pm = np.full((2, n, 64), -1e9, f)
    pm[0, :, 0] = 0.0
    ch = np.zeros((n, q + rem, 64), np.int64)
    for blk in range(q):
        t = 4 * blk
        if ring and t > 0 and t % half == 0:
            if t >= window:
                convert(t, min(t + half, n_steps))
            if t + half < n_steps:
                copy(t + half, min(t + 2 * half, n_steps))
        sums = read(t, 4)                                           # [N, 4, 2]
        pp, mm = sums[:, None, :, 0], sums[:, None, :, 1]
        fam, oth = np.where(sel, mm, pp), np.where(sel, pp, mm)     # [N, 64, 4]
        x, y = np.where(neg, -fam, fam), np.where(neg, -oth, oth)
        v = pm[blk & 1][:, pred]                                    # [N, 64, 16]
        for i in range(4):
            add = np.where(psel[:, i], y[..., i:i + 1], x[..., i:i + 1])
            v = v + np.where(pneg[:, i], -add, add)
        pm[(blk + 1) & 1], ch[:, blk] = first_max(v, ties)
    if ring and rem and (4 * q) % half == 0 and 4 * q >= window:
        convert(4 * q, n_steps)
    s = np.arange(64)
    for i in range(rem):
        sm = read(4 * q + i, 1)[:, 0]                               # [N, 2]
        cand = []
        for c in range(2):
            lab = np.array([label(st, c << 3, 4) for st in s])
            val = np.where(lab & 1, sm[:, None, 1], sm[:, None, 0])
            cand.append(pm[(q + i) & 1][:, 2 * (s & 31) + c] + np.where(lab & 2, -val, val))
        c = cand[1] > cand[0]
        pm[(q + i + 1) & 1] = np.where(c, cand[1], cand[0])
        ch[:, q + i] = c
    out = np.zeros((n, n_bits), np.uint8)
    for r in range(n):
        state = 0
        for i in range(rem - 1, -1, -1):
            state = 2 * (state & 31) + int(ch[r, q + i, state])
        for blk in range(q - 1, -1, -1):
            j = int(ch[r, blk, state])
            ch[r, blk, 0] = state
            state = 16 * (state & 3) + j
        t = np.arange(n_bits)
        out[r] = (ch[r, t >> 2, 0] >> (2 + (t & 3))) & 1
    return out.reshape(*received.shape[:-1], n_bits)


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


@pytest.mark.parametrize("name,received,n_bits,soft", CORPORA, ids=[c[0] for c in CORPORA])
def test_kernel_schedule_equals_jax_and_plain(name, received, n_bits, soft):
    """The twin equals JAX's default decode and the plain version on every
    corpus."""
    got = kernel_twin(received, n_bits, soft)
    np.testing.assert_array_equal(got, _jax_decode(received, n_bits, soft), name)
    np.testing.assert_array_equal(
        got, convcode.viterbi_decode_plain(torch.from_numpy(received), n_bits, soft).numpy(), name)


@pytest.mark.parametrize("window", [8, 16, 24, 56])
def test_kernel_schedule_through_the_ring(window):
    """With a staging window shorter than the rows, the twin's ring of two
    halves (filled a half ahead, converted at the block step before, every
    read checked for its step) decides as the plain version does: rows of
    62 to 65 steps cross many halves, at every tail."""
    for name, received, n_bits, soft in CORPORA[1:28:3]:
        np.testing.assert_array_equal(
            kernel_twin(received, n_bits, soft, window=window),
            convcode.viterbi_decode_plain(torch.from_numpy(received), n_bits, soft).numpy(),
            f"{name}, window {window}")


def test_kernel_schedule_through_the_ring_at_its_window():
    """A row of 6,145 steps, past convcode.WINDOW: the kernel's own ring,
    its tail at a half's start, against JAX and the plain version."""
    (name, received, n_bits, soft), = [c for c in viterbi_corpora(long=True)
                                       if c[0].startswith("two rows of 6,145")]
    assert (n_bits + 6) > convcode.WINDOW and (n_bits + 6) // 4 * 4 % (convcode.WINDOW // 2) == 0
    got = kernel_twin(received[:1], n_bits, soft)
    np.testing.assert_array_equal(got, _jax_decode(received[:1], n_bits, soft), name)
    np.testing.assert_array_equal(got, convcode.viterbi_decode_plain(
        torch.from_numpy(received[:1]), n_bits, soft).numpy(), name)


def test_labels_are_the_parity_rule_and_linear():
    """label(s, j, i) is the branch metric of _POUT (pout0 r0 + pout1 r1 as
    +-P or +-M) at the path's step-i state, and splits over the bits: the
    state's label (path 0's) with the path's constant part (its M bit, and
    its a0 as the sign), the decomposition the kernel uses."""
    r0, r1 = np.float32(0.75), np.float32(-0.3125)
    values = {0: r0 + r1, 1: r0 - r1, 2: -(r0 + r1), 3: -(r0 - r1)}
    for s in range(64):
        for j in range(16):
            st = [s]
            for i in (4, 3, 2):
                st.insert(0, 2 * (st[0] & 31) + ((j >> (i - 1)) & 1))
            for i in range(1, 5):
                c = (j >> (i - 1)) & 1
                pout = convcode._POUT_PM[st[i - 1], c]
                assert values[label(s, j, i)] == pout[0] * r0 + pout[1] * r1
                b, part = label(s, 0, i), label(0, j, i)
                assert label(s, j, i) == (b & 1 ^ part & 1) | (b & 2 ^ (part & 2 ^ 2))


def _grid() -> np.ndarray:
    """Seeded f32 values with +-0, subnormals, values near overflow, and
    pairs whose sums cancel or round."""
    rng = np.random.default_rng(2024)
    tiny = np.float32(np.finfo(np.float32).tiny)
    big = np.finfo(np.float32).max
    special = np.array([0.0, -0.0, tiny, -tiny, tiny / 8, -tiny / 8, np.float32(1e-45),
                        big, -big, big / 2, 1.0, -1.0, 0.5, 3.0, 1e-8, -1e-8],
                       np.float32)
    rand = np.concatenate([rng.normal(0, 1, 300), rng.normal(0, 1e-38, 100),
                           rng.normal(0, 1e38, 100), rng.integers(-8, 9, 100) / 8])
    return np.concatenate([special, rand.astype(np.float32)])


def test_branch_sums_are_symmetric_under_negation():
    """The identities the kernel's +-P / +-M rests on, in f32 under
    round-to-nearest: (-a) + (-b) == -(a + b) and a + (-b) == -((-a) + b),
    equal as values (a zero's sign may differ), bit for bit when nonzero."""
    g = _grid()
    a, b = np.meshgrid(g, g)
    with np.errstate(over="ignore"):
        for lhs, rhs in (((-a) + (-b), -(a + b)), (a + (-b), -((-a) + b)), (a - b, a + (-b))):
            assert lhs.dtype == np.float32
            same = (lhs == rhs) | (np.isinf(lhs) & (lhs == rhs))
            assert same.all()
            nz = lhs != 0
            assert (lhs[nz].view(np.uint32) == rhs[nz].view(np.uint32)).all()


def test_first_max_keeps_the_lower_j():
    """Equal values at j = 3 and j = 12, the tree's halves meeting at its
    last level: j = 3 wins; a strictly larger value wins whatever its j;
    -0 and +0 tie, and the lower j keeps it."""
    v = np.full(16, -1.0, np.float32)
    v[3] = v[12] = 5.0
    ties = []
    assert first_max(v, ties) == (5.0, 3) and (3, 12) in ties
    v[12] = 5.5
    assert first_max(v) == (5.5, 12)
    v = np.full(16, -1.0, np.float32)
    v[7], v[8] = -0.0, 0.0
    assert first_max(v)[1] == 7


def test_ties_corpus_meets_across_the_tree_halves():
    """On the ties-between-the-halves corpora, equal path values do meet
    between j <= 3 and j >= 12, the lower j wins, and the decisions equal
    JAX's."""
    corpora = [c for c in CORPORA if c[0].startswith("ties between the tree's halves")]
    assert len(corpora) == 2
    for name, received, n_bits, soft in corpora:
        ties = []
        got = kernel_twin(received, n_bits, soft, ties=ties)
        np.testing.assert_array_equal(got, _jax_decode(received, n_bits, soft), name)
        assert all(w < l for w, l in ties)
        assert any(w <= 3 and l >= 12 for w, l in ties), (name, len(ties))


def test_choices_fit_in_shared_memory_up_to_the_budget():
    """Every frame a caller builds keeps its choices in shared memory (a
    263-byte frame's 2,054 steps among them); 12,448 steps are the last
    that fit (the long corpora's edge row), past that they go to the
    scratch.  The rule is tm_viterbi's."""
    assert convcode.choices_fit(62) and convcode.choices_fit(2054) and convcode.choices_fit(4096)
    last = max(n for n in range(12000, 13000) if convcode.choices_fit(n))
    assert last == 12448 and not any(convcode.choices_fit(n) for n in range(last + 1, 16007))
    q, rem = divmod(last, 4)
    assert 512 + 8 * convcode.WINDOW + 64 * (q + rem) == convcode.SMEM_MAX
    steps = {n_bits + 6 for _, _, n_bits, _ in viterbi_corpora(long=True)}
    assert {2054, last, 16006} <= steps


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


def test_wrapper_hands_the_kernel_no_scratch_where_choices_fit(monkeypatch):
    """The wrapper's host path with the launch replaced by a recorder: one
    call of tm_viterbi a decode, with no choices pointer where the choices
    fit in shared memory (2,054 steps, and 12,448 at the budget's edge)
    and a scratch of [N, q + rem, 64] past that (12,449 and 16,006
    steps)."""
    calls, shapes = [], []
    real_empty = torch.empty

    def entry(name, symbol, argtypes):
        assert (name, symbol, argtypes) == ("viterbi", "tm_viterbi", convcode._ARGTYPES)
        return lambda *args: calls.append(args) or 0

    def empty(*args, **kwargs):
        shapes.append(tuple(args[0]))
        return real_empty(*args, **kwargs)

    monkeypatch.setattr(convcode._build, "on_cuda", lambda *t: True)
    monkeypatch.setattr(convcode._build, "entry", entry)
    monkeypatch.setattr(convcode._build, "stream_ptr", lambda t: 0)
    monkeypatch.setattr(torch, "empty", empty)
    for rows, n_bits in ((3, 2048), (1, 12442), (2, 12443), (2, 16000)):
        n_steps = n_bits + 6
        before = convcode.viterbi_decode.launches
        calls.clear()
        shapes.clear()
        out = convcode.viterbi_decode(torch.zeros(rows, 2 * n_steps), n_bits, soft=True)
        assert out.shape == (rows, n_bits) and convcode.viterbi_decode.launches == before + 1
        (args,) = calls
        assert args[1:5] == (rows, n_steps, n_bits, 0)
        if convcode.choices_fit(n_steps):
            assert args[5] is None and shapes == [(rows, n_bits)]
        else:
            assert args[5] and shapes == [(rows, n_bits), (rows, n_steps // 4 + n_steps % 4, 64)]
