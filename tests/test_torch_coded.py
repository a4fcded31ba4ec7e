"""The port's Viterbi-coded PHYs (``trackmaker_tpu_torch.phy.coded``), its
pattern sync (``sync.find_pattern_starts``) and ``OfdmModem(fec="conv")``
against the JAX package's, on the CPU.  ``tests/test_torch_coded_runs.py``
holds the sweep, the MAC transfer and ``chip_smoke.py``'s coded gates.

The corpora are built by the port (its encoders on the CPU, NumPy noise),
so the builders serve the tests marked ``gpu`` and ``chip_smoke.py``
without JAX: this module imports JAX only inside its tests.

Tolerances, each with its reason:
* soft values: none.  The Viterbi decoder decides on them, so the port
  follows XLA's CPU arithmetic (``phy/coded.py``), and these tests pin it,
  on both sides of ``XLA_ORDERED_DOT_ROWS``;
* starts, bits, frames, waveforms of the line codes and buffer lengths:
  equal.  Every corpus asserts that no
  correlation lag lies within 1e-4 of its threshold, so equal starts mean
  equal decisions and not luck;
* the OFDM waveform: atol 1e-6 (another FFT library); its frames equal.
"""

import dataclasses
import inspect
from fractions import Fraction

import numpy as np
import pytest
import torch

from trackmaker_tpu_torch.bench import ber
from trackmaker_tpu_torch.core.config import FOUR_B_FIVE_B, MANCHESTER, PhyConfig
from trackmaker_tpu_torch.core.framing import Frame
from trackmaker_tpu_torch.phy import coded, ofdm
from trackmaker_tpu_torch.sync import auto_xcorr, find_pattern_starts

THR = 0.45
MARGIN = 1e-4
KINDS = [(MANCHESTER, False), (MANCHESTER, True), (FOUR_B_FIVE_B, False), (FOUR_B_FIVE_B, True)]
# each batch corpus's seed: one whose captures keep every lag MARGIN off the
# threshold at both noise levels
SEEDS = {(MANCHESTER, False): 11, (MANCHESTER, True): 0, (FOUR_B_FIVE_B, False): 11,
         (FOUR_B_FIVE_B, True): 11}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread while this module runs: the suite runs a worker per
    core, and torch's own thread pool on top of that oversubscribes them."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def port_phy(kind: str, rate34: bool, addr: int | None = 2, device="cpu"):
    cfg = PhyConfig(line_coding=kind, correlation_threshold=THR)
    cls = coded.CodedManchesterPhy if kind == MANCHESTER else coded.CodedFourB5BPhy
    return cls(cfg, local_addr=addr, rate34=rate34, device=device)


def jax_phy(kind: str, rate34: bool, addr: int | None = 2):
    from trackmaker_tpu.core.config import PhyConfig as JaxPhyConfig
    from trackmaker_tpu.phy import coded as jcoded

    cfg = JaxPhyConfig(line_coding=kind, correlation_threshold=THR)
    cls = jcoded.CodedManchesterPhy if kind == MANCHESTER else jcoded.CodedFourB5BPhy
    return cls(cfg, local_addr=addr, rate34=rate34)


def frames_of(n: int, plen: int, seed: int) -> list[Frame]:
    rng = np.random.default_rng(seed)
    return [Frame.new_data(i, 1, 2, rng.integers(0, 256, plen, dtype=np.uint8).tobytes())
            for i in range(n)]


def batch_corpus(kind: str, rate34: bool, sigma: float, seed: int | None = None):
    """(frames, captures f32[2, T]): 4 frames of 40 bytes, a lead-in under 300
    samples and gaps of 257 and 288, noise `sigma`; no correlation lag
    within MARGIN of the threshold."""
    seed = SEEDS[kind, rate34] if seed is None else seed
    phy = port_phy(kind, rate34)
    frames = frames_of(4, 40, seed)
    rng = np.random.default_rng(seed + 1)
    caps = []
    for b in range(2):
        wave = phy.encode_frames(frames, gap_samples=257 + 31 * b)
        x = np.concatenate([np.zeros(int(rng.integers(0, 300)), np.float32), wave,
                            np.zeros(400, np.float32)])
        caps.append((x + rng.normal(0, sigma, len(x))).astype(np.float32))
    batch = np.zeros((2, max(map(len, caps))), np.float32)
    for b, c in enumerate(caps):
        batch[b, :len(c)] = c
    corr = auto_xcorr(torch.from_numpy(batch), phy.pre)
    assert (corr - THR).abs().min().item() > MARGIN
    return frames, batch


def _sig(f: Frame) -> tuple:
    return dataclasses.astuple(f)


# --- the soft demods ------------------------------------------------------------------------


@pytest.mark.parametrize("spl", [3, 5])
def test_soft_demods_equal_jax_bit_for_bit(spl):
    """Manchester and 4B5B soft values equal JAX's jitted demods at sizes on
    both sides of XLA_ORDERED_DOT_ROWS, at starts the window clamps."""
    import jax.numpy as jnp

    from trackmaker_tpu.phy import coded as jcoded

    rng = np.random.default_rng(spl)
    pad = rng.normal(0, 1, 20_000).astype(np.float32)
    x = torch.from_numpy(pad)[None]
    for n in (1, 31, 50, 51, 259):
        for st in (0, 19_990):
            want = np.asarray(jcoded._soft_bits(spl, jnp.asarray(pad), n, jnp.int32(st)))
            got = coded.soft_bits(spl, x, n, torch.tensor([[st]]))[0, 0].numpy()
            np.testing.assert_array_equal(got, want, f"manchester n {n} start {st}")
            want = np.asarray(jcoded._soft_bits_4b5b(spl, jnp.asarray(pad), n, jnp.int32(st)))
            got = coded.soft_bits_4b5b(spl, x, n, torch.tensor([[st]]))[0, 0].numpy()
            np.testing.assert_array_equal(got, want, f"4b5b n {n} start {st}")


@pytest.mark.parametrize("b,f,n_kept", [(1, 2, 100), (1, 2, 104), (1, 1, 204), (2, 3, 124),
                                        (3, 3, 24), (4, 8, 780)])
def test_batched_soft_demods_equal_jax(b, f, n_kept):
    """Under the batched decode's two vmaps XLA sizes its dot by every
    symbol of the call: the port's batched soft values follow it."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(n_kept)
    pads = rng.normal(0, 1, (b, 20_000)).astype(np.float32)
    bodies = rng.integers(0, 1000, (b, f)).astype(np.int32)
    for kind in (MANCHESTER, FOUR_B_FIVE_B):
        j = jax_phy(kind, False)
        fn = jax.jit(jax.vmap(lambda pad, bs: jax.vmap(
            lambda s: j._soft_kept_traced(pad, n_kept, s))(bs)))
        want = np.asarray(fn(jnp.asarray(pads), jnp.asarray(bodies)))
        got = port_phy(kind, False)._soft_kept(torch.from_numpy(pads), n_kept,
                                               torch.from_numpy(bodies))
        np.testing.assert_array_equal(got.numpy(), want, kind)


def _round_f32(x: Fraction) -> np.float32:
    """The f32 nearest the exact rational x, ties to even."""
    y = np.float32(float(x))
    cands = [np.nextafter(y, np.float32(-np.inf)), y, np.nextafter(y, np.float32(np.inf))]
    return min(cands, key=lambda c: (abs(Fraction(float(c)) - x),
                                     int(np.float32(c).view(np.int32)) & 1))


def test_fma_rounds_once():
    """fma_f32 equals a·b + c rounded once from the exact rational value, on
    random inputs and where the f64 sum lands on an f32 midpoint: 1 + 2^-23
    - (1 - 2^-23)·2^-24·(1 + 2^-23) is 2^-70 above the midpoint of 1 and
    1 + 2^-23, and rounding the f64 sum to f32 would pick 1."""
    rng = np.random.default_rng(0)
    a = rng.normal(0, 1, 500).astype(np.float32)
    b = np.full_like(a, np.float32(1.0) / np.float32(3.0))
    c = (rng.normal(0, 1, 500) * 10.0 ** rng.integers(-9, 3, 500)).astype(np.float32)
    got = coded.fma_f32(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c)).numpy()
    want = [_round_f32(Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z)))
            for x, y, z in zip(a, b, c)]
    np.testing.assert_array_equal(got, np.array(want, np.float32))
    a = torch.tensor([-(1.0 - 2.0 ** -23)], dtype=torch.float32)
    b = torch.tensor([2.0 ** -24 * (1.0 + 2.0 ** -23)], dtype=torch.float32)
    c = torch.tensor([1.0 + 2.0 ** -23], dtype=torch.float32)
    assert (a.double() * b.double() + c.double()).float().item() == 1.0   # rounded twice
    assert coded.fma_f32(a, b, c).item() == 1.0 + 2.0 ** -23


# --- the pattern sync ----------------------------------------------------------------------


def _sync_capture(kind: str) -> np.ndarray:
    return batch_corpus(kind, False, 0.2, seed=0)[1][0]


@pytest.mark.parametrize("kind", [MANCHESTER, FOUR_B_FIVE_B])
def test_find_pattern_starts_equals_jax(kind):
    """Default and frame-length min_sep, no hits (silence), and max_frames
    running out before the hits do."""
    import jax.numpy as jnp

    from trackmaker_tpu import sync as jsync

    phy = port_phy(kind, False)
    x = _sync_capture(kind)
    frame_len = phy.frame_samples(40)
    cases = [(x, 8, None), (x, 8, frame_len), (x, 2, frame_len),
             (np.zeros(5000, np.float32), 4, None)]
    for rx, mf, sep in cases:
        want = np.asarray(jsync.find_pattern_starts(jnp.asarray(rx), phy.pre, THR, mf,
                                                    min_sep=sep))
        got = find_pattern_starts(torch.from_numpy(rx), phy.pre, THR, mf, min_sep=sep)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want, (mf, sep))
    assert (np.asarray(find_pattern_starts(torch.from_numpy(x), phy.pre, THR, 2,
                                           min_sep=frame_len)) >= 0).all()
    both = find_pattern_starts(torch.from_numpy(np.stack([x, x[::-1].copy()])), phy.pre, THR, 8)
    np.testing.assert_array_equal(both[0].numpy(),
                                  find_pattern_starts(torch.from_numpy(x), phy.pre, THR, 8))


def test_ofdm_sync_is_the_pattern_walk():
    """find_preambles is find_pattern_starts with the chirp at the OFDM
    threshold: the OFDM sync and the coded sync share one walk."""
    cfg = ofdm.OfdmConfig()
    wave = ofdm.OfdmModem(device="cpu").encode_frames(frames_of(3, 20, 1), gap_samples=300)
    x = torch.from_numpy(np.concatenate([np.zeros(321, np.float32), wave]))
    got = ofdm.find_preambles(cfg, x, 5)
    assert torch.equal(got, find_pattern_starts(x, ofdm.chirp(cfg), cfg.sync_threshold, 5,
                                                min_sep=cfg.preamble_len))
    assert (got[:3] >= 321).all() and (got[3:] == -1).all()


# --- the coded PHYs -------------------------------------------------------------------------


@pytest.mark.parametrize("kind,rate34", KINDS)
def test_encoder_equals_jax(kind, rate34):
    frames = frames_of(2, 30, 2) + [Frame.new_ack(3, 1, 2)]
    want = jax_phy(kind, rate34).encode_frames(frames, gap_samples=100)
    got = port_phy(kind, rate34).encode_frames(frames, gap_samples=100)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert port_phy(kind, rate34).frame_samples(30) == jax_phy(kind, rate34).frame_samples(30)


@pytest.mark.parametrize("kind,rate34", KINDS)
def test_batched_decode_equals_jax(kind, rate34):
    """Starts and bits equal JAX's batched decode at sigma 0.3 and 0.6, and
    decode_equal_frames gives the frames JAX's decisions hold."""
    import jax.numpy as jnp

    from trackmaker_tpu.core.framing import Frame as JaxFrame

    j, p = jax_phy(kind, rate34), port_phy(kind, rate34)
    fn = j.batched_decode_fn(6, 40)
    for sigma in (0.3, 0.6):
        frames, batch = batch_corpus(kind, rate34, sigma)
        sj, bj = (np.asarray(a) for a in fn(jnp.asarray(batch)))
        sp, bp = p.batched_decode_fn(6, 40)(torch.from_numpy(batch))
        np.testing.assert_array_equal(sp.numpy(), sj, sigma)
        np.testing.assert_array_equal(bp.numpy(), bj, sigma)
        want = [[_sig(f) for f in (JaxFrame.from_bits(bj[b, k]) for k in range(6) if sj[b, k] >= 0)
                 if f is not None and f.dst == 2] for b in range(2)]
        got = p.decode_equal_frames(batch, 6, 40)
        assert [[_sig(f) for f in row] for row in got] == want
    assert [_sig(f) for f in got[0]] == [_sig(f) for f in frames]


@pytest.mark.parametrize("kind,rate34", KINDS)
def test_process_samples_equals_jax_call_for_call(kind, rate34):
    """Chunked pushes: each call's frames and the buffer kept equal JAX's,
    at a noise where the decoder corrects, with an ACK and a frame to
    another address among them."""
    j, p = jax_phy(kind, rate34), port_phy(kind, rate34)
    frames = frames_of(3, 25, 4) + [Frame.new_ack(9, 1, 2), Frame.new_data(7, 1, 5, b"not ours")]
    wave = p.encode_frames(frames, gap_samples=300)
    rng = np.random.default_rng(6)
    x = np.concatenate([np.zeros(500, np.float32), wave, np.zeros(1500, np.float32)])
    x = (x + rng.normal(0, 0.45, len(x))).astype(np.float32)
    out = []
    for i in range(0, len(x), 1700):
        got = [_sig(f) for f in p.process_samples(x[i:i + 1700])]
        want = [_sig(f) for f in j.process_samples(x[i:i + 1700])]
        assert got == want and len(p._buf) == len(j._buf), i
        out += got
    assert out == [_sig(f) for f in frames[:4]]
    assert p.decode_calls > 0


def test_process_samples_rejects_noise_and_other_addresses():
    phy = port_phy(FOUR_B_FIVE_B, False)
    assert phy.process_samples(np.random.default_rng(0).normal(0, 0.05, 6000)
                               .astype(np.float32)) == []
    wave = phy.encode_frames([Frame.new_data(0, 1, 9, b"not yours")])
    assert phy.process_samples(np.concatenate([wave, np.zeros(3000, np.float32)])) == []


def test_entry_points_default_to_the_card():
    for cls in (coded.CodedManchesterPhy, coded.CodedFourB5BPhy, ofdm.OfdmModem):
        assert inspect.signature(cls).parameters["device"].default == "cuda"
    assert inspect.signature(ber.coded_ber_sweep).parameters["device"].default == "cuda"
    assert coded.CodedManchesterPhy().device == torch.device("cuda")
    with pytest.raises(ValueError):
        coded.CodedManchesterPhy(PhyConfig(line_coding=FOUR_B_FIVE_B))


# --- OFDM with the convolutional code ------------------------------------------------------


def test_ofdm_modem_conv_equals_jax():
    """OfdmModem(fec="conv") encodes the frames JAX's does (the FFT's atol)
    and decodes the same frames from a noisy capture."""
    from trackmaker_tpu.core.framing import Frame as JaxFrame
    from trackmaker_tpu.phy.ofdm import OfdmModem as JaxOfdmModem

    frames = frames_of(4, 40, 9)
    jm, pm = JaxOfdmModem(fec="conv"), ofdm.OfdmModem(fec="conv", device="cpu")
    assert pm._tx_len(47 * 8) == jm._tx_len(47 * 8) == 2 * (47 * 8 + 6)
    want = np.asarray(jm.encode_frames([JaxFrame(*dataclasses.astuple(f)) for f in frames], 300))
    wave = pm.encode_frames(frames, 300)
    np.testing.assert_allclose(wave, want, atol=1e-6)
    rng = np.random.default_rng(10)
    x = np.concatenate([np.zeros(700, np.float32), wave, np.zeros(2000, np.float32)])
    x = (x + rng.normal(0, 0.05, len(x))).astype(np.float32)
    got = pm.decode(x, 47, 8)
    assert [_sig(f) for f in got] == [_sig(f) for f in jm.decode(x, 47, 8)]
    assert [_sig(f) for f in got] == [_sig(f) for f in frames]
    assert pm.decode(np.zeros(3000, np.float32), 47) == []
