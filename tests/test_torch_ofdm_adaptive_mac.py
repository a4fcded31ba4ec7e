"""The port's adaptive coded OFDM as the MAC's PHY
(``trackmaker_tpu_torch.phy.ofdm_adaptive.OfdmAdaptiveStreamPhy``): the
streaming receiver call for call, its pre-FEC monitor, the handshake, the
live retrain and the CSMA transfer, against the JAX package's on the CPU;
and ``chip_smoke.py``'s ``RETRAIN_EXPECT`` and adaptive ``MAC_EXPECT``.

The JAX side of ``MAC_EXPECT["csma_transfer, ofdm_adaptive"]`` is
``tests/test_torch_link.py``'s (every MAC run's); the port's CPU run is
held to it here.  This module imports JAX only inside its tests.

Tolerances: frames, buffer lengths, loadings, gains and the pre-FEC
figures (counts over lengths) equal.  The pre-FEC monitor takes the signs
of soft values that equal JAX's within 1e-5 (``tests/test_torch_ofdm_adaptive.py``);
the retrain reports the smallest |soft value| it took a sign of, and says
so where it lies within that tolerance of 0.
"""

import dataclasses
import inspect
import warnings

import numpy as np
import pytest
import torch

import chip_smoke
from test_torch_ofdm import drive
from test_torch_ofdm_adaptive import SOFT_ATOL
from trackmaker_tpu_torch.core.framing import Frame
from trackmaker_tpu_torch.link import transfer
from trackmaker_tpu_torch.phy import ofdm, ofdm_adaptive as ad

CFG = ad.OfdmAdaptiveConfig()
N_DATA = len(CFG.data_bin_idx)
THIRDS = chip_smoke.ADAPTIVE_THIRDS


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


def _jphy(**kw):
    from trackmaker_tpu.phy.ofdm_adaptive import OfdmAdaptiveStreamPhy

    return OfdmAdaptiveStreamPhy(**kw)


def port_start(cfg, rx: np.ndarray) -> int:
    return int(ofdm.find_preambles(cfg, torch.from_numpy(rx), 1)[0])


def jax_start(cfg, rx: np.ndarray) -> int:
    import jax.numpy as jnp

    from trackmaker_tpu.phy.ofdm import find_preambles

    return int(np.asarray(find_preambles(cfg, jnp.asarray(rx), 1))[0])


def stream_track(loading, sigma: float, seed: int) -> np.ndarray:
    """A live track for the adaptive stream PHY: frames of 1 to 200 bytes to
    addresses 2 and 3, a header whose length field (300) exceeds the largest
    frame, an ACK, gaps of random length, noise `sigma`."""
    phy = ad.OfdmAdaptiveStreamPhy(loading=loading, device="cpu")
    rng = np.random.default_rng(seed)
    parts = [np.zeros(700, np.float32)]
    for i, (dst, n) in enumerate([(2, 12), (3, 40), (2, 1), (2, 200)]):
        payload = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        parts += [phy.encode_frame(Frame.new_data(i, 1, dst, payload)),
                  np.zeros(int(rng.integers(50, 1500)), np.float32)]
    fb = Frame.new_data(9, 1, 2, bytes(16)).to_bytes()
    hdr = np.unpackbits(np.frombuffer(fb[:7], np.uint8))
    hdr[:16] = np.unpackbits(np.array([1, 44], np.uint8))         # length field 300
    coded = torch.cat([phy._encode_block(hdr), phy._encode_block(
        np.unpackbits(np.frombuffer(fb[7:], np.uint8)))])
    parts += [ad.modulate_bits_adaptive(phy.cfg, coded[None], coded.shape[-1])[0].numpy(),
              np.zeros(900, np.float32), phy.encode_frame(Frame.new_ack(4, 1, 2)),
              np.zeros(2500, np.float32)]
    x = np.concatenate(parts)
    return (x + rng.normal(0, sigma, len(x))).astype(np.float32)


TRACKS = {"default": (None, 0.02, 40), "thirds": (THIRDS, 0.01, 41),
          "thirds_noisy": (THIRDS, 0.05, 42)}


@pytest.mark.parametrize("name", list(TRACKS))
@pytest.mark.parametrize("addr", [2, None])
def test_process_samples_matches_jax_call_for_call(name, addr):
    """Random chunks: each call's frames, the buffer kept and the pre-FEC
    history equal JAX's; the noisy track gives the monitor errors to count."""
    loading, sigma, seed = TRACKS[name]
    x = stream_track(loading, sigma, seed)
    p = ad.OfdmAdaptiveStreamPhy(loading=loading, local_addr=addr, device="cpu")
    j = _jphy(loading=loading, local_addr=addr)
    assert drive(p, x, seed) == drive(j, x, seed)
    assert p.frame_prefec == j.frame_prefec
    assert len(p.frame_prefec) >= 5 and p.decode_calls > 0
    assert (max(p.frame_prefec) > 0) == (name == "thirds_noisy")
    assert p.prefec_ber(4) == j.prefec_ber(4)
    assert p.link_degraded(0.01, 4) == j.link_degraded(0.01, 4)


def test_stream_phy_duck_type_and_filters():
    """tests/test_ofdm_adaptive_mac.py's duck-type and filter cases: variable
    lengths in 2,000-sample chunks, noise alone, another address."""
    phy = ad.OfdmAdaptiveStreamPhy(local_addr=2, device="cpu")
    frames = [Frame.new_data(0, 1, 2, b"variable"), Frame.new_ack(0, 1, 2),
              Frame.new_data(1, 1, 2, b"coded adaptive phy frames!")]
    wave = phy.encode_frames(frames, gap_samples=300)
    j = _jphy(local_addr=2)
    np.testing.assert_allclose(wave, j.encode_frames([_jframe(f) for f in frames], 300),
                               atol=1e-6)
    assert phy.frame_samples(26) == j.frame_samples(26)
    assert phy.net_bits_per_symbol == j.net_bits_per_symbol
    got = []
    for i in range(0, len(wave), 2000):
        got.extend(phy.process_samples(wave[i:i + 2000]))
    assert got == frames
    phy.reset()
    assert phy.process_samples(np.random.default_rng(0).normal(0, 0.01, 8000)
                               .astype(np.float32)) == []
    other = phy.encode_frames([Frame.new_data(0, 1, 9, b"not yours")])
    assert phy.process_samples(np.concatenate([other, np.zeros(4000, np.float32)])) == []


def test_handshake_matches_jax():
    """tests/test_ofdm_adaptive_mac.py:71's handshake through both packages:
    the probed loading, the handshake mode's frame carrying it, and the
    loaded frames after it, equal at every step."""
    from trackmaker_tpu.phy import ofdm_adaptive as jad

    jcfg = jad.OfdmAdaptiveConfig()
    results = []
    for mod, start, kw in ((ad, port_start, {"device": "cpu"}), (jad, jax_start, {})):
        rng = np.random.default_rng(11)
        cfg = mod.OfdmAdaptiveConfig()
        rx_probe = chip_smoke.shaped_channel(np.concatenate(
            [mod.probe_waveform(cfg, **kw), np.zeros(1000, np.float32)]), rng, sigma=0.004)
        loading = mod.choose_loading(chip_smoke.host(mod.estimate_bin_snr(
            cfg, rx_probe, start(cfg, rx_probe), **kw)))
        hs = mod.OfdmAdaptiveStreamPhy.handshake_mode(cfg, local_addr=1, **kw)
        wave = hs.encode_frames([mod.Frame.new_data(0, 2, 1, mod.pack_loading(loading))])
        got = mod.OfdmAdaptiveStreamPhy.handshake_mode(cfg, local_addr=1, **kw).process_samples(
            chip_smoke.shaped_channel(np.concatenate([wave, np.zeros(4000, np.float32)]), rng,
                                      sigma=0.004))
        negotiated = mod.unpack_loading(got[0].data, len(cfg.data_bin_idx))
        tx = mod.OfdmAdaptiveStreamPhy(cfg, loading=negotiated, local_addr=2, **kw)
        rx = mod.OfdmAdaptiveStreamPhy(cfg, loading=negotiated, local_addr=2, **kw)
        frames = [mod.Frame.new_data(i, 1, 2, bytes([i]) * 48) for i in range(3)]
        out = rx.process_samples(chip_smoke.shaped_channel(np.concatenate(
            [tx.encode_frames(frames, gap_samples=400), np.zeros(4000, np.float32)]), rng,
            sigma=0.004))
        results.append((loading, negotiated, [(f.sequence, f.data) for f in out],
                        rx.frame_prefec))
    assert results[0] == results[1]
    loading, negotiated, delivered, _ = results[0]
    assert negotiated == loading and 0 in loading and 4 in loading
    assert delivered == [(i, bytes([i]) * 48) for i in range(3)]
    assert ad.OfdmAdaptiveStreamPhy.handshake_mode(CFG, device="cpu").cfg.loading == \
        jad.OfdmAdaptiveStreamPhy.handshake_mode(jcfg).cfg.loading


def test_chip_smoke_retrain_expect_is_the_jax_packages():
    """RETRAIN_EXPECT, which the port's run on the card must equal, is the
    JAX package's retrain run; the port's CPU run gives the same."""
    from trackmaker_tpu.phy import ofdm_adaptive as jad

    assert chip_smoke.retrain_run(jad, jax_start) == chip_smoke.RETRAIN_EXPECT
    signs = []
    orig = ad.OfdmAdaptiveStreamPhy._prefec

    def prefec(soft, bits):
        signs.append(float(np.abs(soft).min()))
        return orig(soft, bits)

    ad.OfdmAdaptiveStreamPhy._prefec = staticmethod(prefec)
    try:
        got = chip_smoke.retrain_run(ad, port_start, device="cpu")
    finally:
        ad.OfdmAdaptiveStreamPhy._prefec = staticmethod(orig)
    assert got == chip_smoke.RETRAIN_EXPECT
    assert got["tripped"][0] and not got["calm"][0] and got["bits1"] < got["bits0"]
    print(f"retrain: the smallest |soft value| the pre-FEC monitor took a sign of "
          f"{min(signs):.3g}")
    if min(signs) <= SOFT_ATOL:
        warnings.warn(f"the retrain's pre-FEC monitor took the sign of a soft value within "
                      f"{SOFT_ATOL} of 0 ({min(signs):.3g})")


def test_csma_transfer_equals_mac_expect():
    """chip_smoke.py's adaptive MAC run through the port on the CPU: the data
    arrives and the stats equal MAC_EXPECT, the JAX package's."""
    link = {"csma": transfer.transfer_over_bus, "ofdm_adaptive": ad.OfdmAdaptiveStreamPhy}
    from trackmaker_tpu_torch.core.config import MacConfig, PhyConfig

    name = "csma_transfer, ofdm_adaptive"
    data, received, stats = chip_smoke.mac_run(name, link, PhyConfig, MacConfig, device="cpu")
    assert received == data
    assert stats == chip_smoke.MAC_EXPECT[name]
    assert chip_smoke.MAC_RUNS[name][2]["loading"] == THIRDS
    assert THIRDS.count(4) == THIRDS.count(2) == N_DATA // 3


def test_stream_entry_points_default_to_the_card():
    assert inspect.signature(ad.OfdmAdaptiveStreamPhy).parameters["device"].default == "cuda"
    assert ad.OfdmAdaptiveStreamPhy.handshake_mode().device == torch.device("cuda")


# --- on the card -------------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(TRACKS))
def test_process_samples_on_the_card_equals_the_cpu(cuda, name):
    loading, sigma, seed = TRACKS[name]
    x = stream_track(loading, sigma, seed)
    card = ad.OfdmAdaptiveStreamPhy(loading=loading, local_addr=2, device=cuda)
    cpu = ad.OfdmAdaptiveStreamPhy(loading=loading, local_addr=2, device="cpu")
    assert drive(card, x, seed) == drive(cpu, x, seed)
    assert card.frame_prefec == cpu.frame_prefec


@pytest.mark.gpu
def test_retrain_on_the_card(cuda):
    assert chip_smoke.retrain_run(ad, port_start, device=cuda) == chip_smoke.RETRAIN_EXPECT
