"""The port's single-carrier modems (``trackmaker_tpu_torch.phy.fsk``,
``phy.psk``) and their stream PHYs (``phy.stream_sc``) against the JAX
package's, on the CPU, and ``chip_smoke.py``'s PSK and FSK MAC runs.

The JAX side of ``MAC_EXPECT["csma_transfer, psk"]`` and ``["csma_transfer,
fsk"]`` is ``tests/test_torch_link.py``'s (every MAC run's); the port's CPU
runs are held to it here.  This module imports JAX only inside its tests.

Tolerances, each with its reason:
* PSK waveforms: atol 1e-6 (the quadratures are the same host constants;
  the products may fuse differently);
* FSK waveforms: two f32 ulps of the largest phase the frame reaches.  The
  phase is 2π·cumsum(f)/sr in f32, the JAX package's sum in f32 and the
  port's in float64 rounded once, and it reaches about 10^5 rad on a
  263-byte frame, where an ulp is 0.008 rad.  So each package also decodes
  the other's waveform;
* bits, starts, frames and buffer lengths: equal.
"""

import dataclasses
import inspect

import numpy as np
import pytest
import torch

import chip_smoke
from test_torch_ofdm import drive
from trackmaker_tpu_torch import convert
from trackmaker_tpu_torch.core.config import MacConfig, PhyConfig
from trackmaker_tpu_torch.core.framing import Frame
from trackmaker_tpu_torch.link import transfer
from trackmaker_tpu_torch.phy import fsk, psk, stream_sc

KINDS = ["fsk", "bpsk", "qpsk"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread while this module runs: the suite runs a worker per
    core, and torch's own thread pool on top of that oversubscribes them."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _jframe(f: Frame):
    from trackmaker_tpu.core.framing import Frame as JaxFrame

    return JaxFrame(*dataclasses.astuple(f))


def port_cfg(kind: str):
    return fsk.FskConfig() if kind == "fsk" else psk.PskConfig(
        bits_per_symbol=1 if kind == "bpsk" else 2)


def jax_mod(kind: str):
    from trackmaker_tpu.phy import fsk as jfsk
    from trackmaker_tpu.phy import psk as jpsk

    return jfsk if kind == "fsk" else jpsk


def jax_cfg(kind: str):
    mod = jax_mod(kind)
    cls = mod.FskConfig if kind == "fsk" else mod.PskConfig
    return cls(**dataclasses.asdict(port_cfg(kind)))


def port_modulate(kind: str, bits: np.ndarray) -> np.ndarray:
    b = torch.from_numpy(bits)
    if kind == "fsk":
        return fsk.modulate_bits(port_cfg(kind), b).numpy()
    return psk.modulate_bits(port_cfg(kind), b, bits.shape[-1]).numpy()


def jax_modulate(kind: str, bits: np.ndarray) -> np.ndarray:
    import jax.numpy as jnp

    if kind == "fsk":
        return np.asarray(jax_mod(kind).modulate_bits(jax_cfg(kind), jnp.asarray(bits)))
    return np.asarray(jax_mod(kind).modulate_bits(jax_cfg(kind), jnp.asarray(bits),
                                                  bits.shape[-1]))


def fsk_atol(n_bits: int) -> float:
    """Two f32 ulps of the largest FSK phase of an n_bits frame."""
    cfg = fsk.FskConfig()
    top = 2 * np.pi * max(cfg.f0_hz, cfg.f1_hz) * n_bits * cfg.samples_per_bit / cfg.sample_rate
    return 2 * float(np.spacing(np.float32(top)))


# --- configurations and waveforms --------------------------------------------------------


def test_configs_match_jax_and_carry_across():
    for kind in KINDS:
        ours = [(f.name, f.default) for f in dataclasses.fields(type(port_cfg(kind)))]
        theirs = [(f.name, f.default) for f in dataclasses.fields(type(jax_cfg(kind)))]
        assert ours == theirs
        fields = dataclasses.asdict(jax_cfg(kind))
        conv = convert.fsk_config_from_fields if kind == "fsk" else convert.psk_config_from_fields
        assert conv(fields) == port_cfg(kind)
    assert psk.PskConfig().baud == jax_cfg("bpsk").baud
    for n in (16, 57):
        for c, s in zip(psk._quadratures(port_cfg("qpsk"), n),
                        jax_mod("qpsk")._quadratures(jax_cfg("qpsk"), n)):
            np.testing.assert_array_equal(c, s)
    with pytest.raises(KeyError):
        convert.psk_config_from_fields({"carrier": 1.0})


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n_bits", [8, 56, 400, 2104])
def test_modulators_match_jax(kind, n_bits):
    bits = np.random.default_rng(n_bits).integers(0, 2, (2, n_bits), dtype=np.uint8)
    got, want = port_modulate(kind, bits), jax_modulate(kind, bits)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=fsk_atol(n_bits) if kind == "fsk" else 1e-6,
                               rtol=0)


def sc_capture(kind: str, bits: np.ndarray, wave: np.ndarray, sigma: float, seed: int):
    """Two frames' waveforms after lead-ins of 250 and 0 samples with 700 of
    silence after, noise `sigma`."""
    rng = np.random.default_rng(seed)
    x = np.concatenate([np.zeros((2, 250), np.float32), wave, np.zeros((2, 700), np.float32)], 1)
    x[1] = np.roll(x[1], -250)
    return (x + rng.normal(0, sigma, x.shape)).astype(np.float32)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("source", ["port", "jax"])
def test_demodulate_at_matches_jax(kind, source):
    """Bits equal JAX's on either package's waveform, noisy, at the frames'
    starts and at starts the window clamps (negative, past the end),
    single and batched over captures."""
    import jax.numpy as jnp

    n_bits = 400
    bits = np.random.default_rng(3).integers(0, 2, (2, n_bits), dtype=np.uint8)
    wave = port_modulate(kind, bits) if source == "port" else jax_modulate(kind, bits)
    x = sc_capture(kind, bits, wave, 0.3, 5)
    t = x.shape[1]
    starts = np.array([[250, -600, t - 300], [0, -5, t + 40]])
    got = (fsk if kind == "fsk" else psk).demodulate_at(
        port_cfg(kind), torch.from_numpy(x), n_bits, torch.from_numpy(starts)).numpy()
    for b in range(2):
        want = np.asarray(jax_mod(kind).demodulate_at(jax_cfg(kind), jnp.asarray(x[b]), n_bits,
                                                      jnp.asarray(starts[b])))
        np.testing.assert_array_equal(got[b], want)
        np.testing.assert_array_equal(got[b, 0], bits[b])


@pytest.mark.parametrize("kind", KINDS)
def test_modems_decode_each_others_waveforms(kind):
    """Each package's modem decodes the other's noisy frames, and the port's
    frames equal JAX's on both."""
    rng = np.random.default_rng(7)
    frames = [Frame.new_data(i, 1, 2, rng.integers(0, 256, 32, dtype=np.uint8).tobytes())
              for i in range(4)]
    cls = fsk.FskModem if kind == "fsk" else psk.PskModem
    jcls = jax_mod(kind).FskModem if kind == "fsk" else jax_mod(kind).PskModem
    ours, theirs = cls(port_cfg(kind), device="cpu"), jcls(jax_cfg(kind))
    for wave in (ours.encode_frames(frames, 400),
                 theirs.encode_frames([_jframe(f) for f in frames], 400)):
        x = (np.concatenate([np.zeros(123, np.float32), wave])
             + rng.normal(0, 0.3, len(wave) + 123)).astype(np.float32)
        got = ours.decode(x, 39)
        assert got == frames
        assert [dataclasses.astuple(f) for f in got] == [dataclasses.astuple(f)
                                                         for f in theirs.decode(x, 39)]
    assert ours.decode(np.zeros(5000, np.float32), 39) == []
    with pytest.raises(ValueError):
        ours.encode_frames([frames[0], Frame.new_ack(1, 1, 2)])


# --- the stream PHYs ---------------------------------------------------------------------------


def stream_track(kind: str, seed: int) -> np.ndarray:
    """Frames of 1 to 60 bytes to addresses 2 and 3, a header whose length
    field (300) exceeds the largest frame, an ACK, random gaps, noise 0.2."""
    phy = stream_phy(kind)
    rng = np.random.default_rng(seed)
    parts = [np.zeros(700, np.float32)]
    for i, (dst, n) in enumerate([(2, 12), (3, 20), (2, 1), (2, 60)]):
        payload = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        parts += [phy.encode_frame(Frame.new_data(i, 1, dst, payload)),
                  np.zeros(int(rng.integers(50, 1500)), np.float32)]
    bad = Frame.new_data(9, 1, 2, bytes(16)).to_bits()
    bad[:16] = np.unpackbits(np.array([1, 44], np.uint8))        # length field 300
    parts += [phy._modulate(torch.from_numpy(bad)[None])[0].numpy(), np.zeros(900, np.float32),
              phy.encode_frame(Frame.new_ack(4, 1, 2)), np.zeros(2500, np.float32)]
    x = np.concatenate(parts)
    return (x + rng.normal(0, 0.2, len(x))).astype(np.float32)


def stream_phy(kind: str, device="cpu", **kw):
    if kind == "fsk":
        return stream_sc.FskStreamPhy(port_cfg(kind), device=device, **kw)
    return stream_sc.PskStreamPhy(port_cfg(kind), device=device, **kw)


def jax_stream_phy(kind: str, **kw):
    from trackmaker_tpu.phy import stream_sc as jsc

    cls = jsc.FskStreamPhy if kind == "fsk" else jsc.PskStreamPhy
    return cls(jax_cfg(kind), **kw)


@pytest.mark.parametrize("kind", KINDS)
def test_stream_phys_match_jax_call_for_call(kind):
    """Random chunks: each call's frames and the buffer kept equal JAX's."""
    x = stream_track(kind, 50)
    p, j = stream_phy(kind, local_addr=2), jax_stream_phy(kind, local_addr=2)
    got = drive(p, x, 51)
    assert got == drive(j, x, 51)
    assert sum(len(frames) for frames, _ in got) == 4 and p.decode_calls > 0
    assert p.frame_samples(40) == j.frame_samples(40)


@pytest.mark.parametrize("kind", ["fsk", "bpsk"])
def test_stream_phys_duck_type(kind):
    """tests/test_stream_sc.py's cases: variable lengths in 2,000-sample
    chunks, another address filtered."""
    phy = stream_phy(kind, local_addr=2)
    frames = [Frame.new_data(0, 1, 2, b"variable"), Frame.new_ack(0, 1, 2),
              Frame.new_data(1, 1, 2, b"lengths differ between frames!")]
    wave = phy.encode_frames(frames, gap_samples=300)
    got = []
    for i in range(0, len(wave), 2000):
        got.extend(phy.process_samples(wave[i:i + 2000]))
    assert got == frames
    phy.reset()
    assert phy.process_samples(phy.encode_frames([Frame.new_data(0, 1, 9, b"not yours")])) == []
    assert phy.encode_frames([]).shape == (0,)


@pytest.mark.parametrize("name", ["csma_transfer, psk", "csma_transfer, fsk"])
def test_csma_transfers_equal_mac_expect(name):
    """chip_smoke.py's PSK and FSK MAC runs through the port on the CPU: the
    data arrives and the stats equal MAC_EXPECT, the JAX package's."""
    link = {"csma": transfer.transfer_over_bus, "psk": stream_sc.PskStreamPhy,
            "fsk": stream_sc.FskStreamPhy}
    data, received, stats = chip_smoke.mac_run(name, link, PhyConfig, MacConfig, device="cpu")
    assert received == data
    assert stats == chip_smoke.MAC_EXPECT[name]


def test_entry_points_default_to_the_card():
    for cls in (fsk.FskModem, psk.PskModem, stream_sc.FskStreamPhy, stream_sc.PskStreamPhy):
        assert inspect.signature(cls).parameters["device"].default == "cuda"
        assert cls().device == torch.device("cuda")


# --- on the card -------------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", KINDS)
def test_single_carrier_on_the_card_equals_the_cpu(cuda, kind):
    """The waveform (FSK: exactly, the cumulative sum taken in float64 on
    both), the demodulated bits and the stream PHY call for call."""
    bits = np.random.default_rng(3).integers(0, 2, (2, 400), dtype=np.uint8)
    mod = fsk if kind == "fsk" else psk
    args = () if kind == "fsk" else (400,)
    wave = mod.modulate_bits(port_cfg(kind), torch.from_numpy(bits).to(cuda), *args).cpu()
    want = mod.modulate_bits(port_cfg(kind), torch.from_numpy(bits), *args)
    assert torch.allclose(wave, want, atol=1e-6, rtol=0)
    x = sc_capture(kind, bits, want.numpy(), 0.3, 5)
    starts = torch.tensor([[250], [0]])
    got = mod.demodulate_at(port_cfg(kind), torch.from_numpy(x).to(cuda), 400, starts.to(cuda))
    assert torch.equal(got.cpu(), mod.demodulate_at(port_cfg(kind), torch.from_numpy(x), 400,
                                                    starts))
    track = stream_track(kind, 50)
    assert drive(stream_phy(kind, cuda, local_addr=2), track, 51) == drive(
        stream_phy(kind, local_addr=2), track, 51)
