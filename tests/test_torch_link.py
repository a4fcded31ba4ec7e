"""The port's link layer (``trackmaker_tpu_torch.link``: the endpoint, the
bus, CSMA with stop-and-wait, Go-Back-N and Selective-Repeat) against the
JAX package's, on the CPU, and on the card against the port's CPU run.

The bus draws its noise from ``np.random.default_rng(seed)`` and the
senders their backoff from ``random.Random(seed)``, as the JAX package's do,
and every deadline counts samples; so when the port's PHY decides as the
JAX package's does, a transfer's received bytes and its whole stats dict
are equal, floats included.  The JAX side runs as its own suite runs it
here (its exact scan on the CPU); the port's PhyDecoder runs the
speculative decode's plain versions.  This module imports JAX only inside
its tests, so the tests marked ``gpu`` run on a card without it.

Tolerances: none (bytes, integers, and floats computed from equal integers
by the same Python expressions).
"""

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
from trackmaker_tpu_torch import convert
from trackmaker_tpu_torch.core.config import FOUR_B_FIVE_B, MacConfig, PhyConfig
from trackmaker_tpu_torch.core.framing import Frame
from trackmaker_tpu_torch.link import AppState, AudioEndpoint, SimulatedBus, is_channel_busy
from trackmaker_tpu_torch.link import gbn, sr, transfer
from trackmaker_tpu_torch.phy import coded, ofdm, ofdm_adaptive, ofdm_v2, stream_sc

# the transfers, and the stream PHYs that replace the line-coded one
PORT_LINK = {"csma": transfer.transfer_over_bus, "gbn": gbn.gbn_transfer,
             "sr": sr.sr_transfer, "ofdm": ofdm.OfdmStreamPhy,
             "ofdm_v2": ofdm_v2.OfdmStreamPhyV2, "coded_manchester": coded.CodedManchesterPhy,
             "ofdm_adaptive": ofdm_adaptive.OfdmAdaptiveStreamPhy,
             "psk": stream_sc.PskStreamPhy, "fsk": stream_sc.FskStreamPhy}
OFDM = ("ofdm", "ofdm_v2")
# (ARQ, line code or OFDM PHY, noise sigma): a few frames each; sigma 0.12
# at seed 5 is tests/test_link.py's noisy channel
TRANSFERS = [("csma", "manchester", 0.0), ("csma", "manchester", 0.12),
             ("csma", FOUR_B_FIVE_B, 0.0), ("gbn", "manchester", 0.0),
             ("gbn", "manchester", 0.12), ("sr", "manchester", 0.0),
             ("sr", "manchester", 0.12), ("csma", "ofdm", 0.0), ("csma", "ofdm_v2", 0.0)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread while this module runs: the suite runs a worker per
    core, and torch's own thread pool on top of that oversubscribes them."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _jax_link():
    from trackmaker_tpu.link.gbn import gbn_transfer
    from trackmaker_tpu.link.sr import sr_transfer
    from trackmaker_tpu.link.transfer import transfer_over_bus
    from trackmaker_tpu.phy.coded import CodedManchesterPhy
    from trackmaker_tpu.phy.ofdm import OfdmStreamPhy
    from trackmaker_tpu.phy.ofdm_adaptive import OfdmAdaptiveStreamPhy
    from trackmaker_tpu.phy.ofdm_v2 import OfdmStreamPhyV2
    from trackmaker_tpu.phy.stream_sc import FskStreamPhy, PskStreamPhy

    return {"csma": transfer_over_bus, "gbn": gbn_transfer, "sr": sr_transfer,
            "ofdm": OfdmStreamPhy, "ofdm_v2": OfdmStreamPhyV2,
            "coded_manchester": CodedManchesterPhy, "ofdm_adaptive": OfdmAdaptiveStreamPhy,
            "psk": PskStreamPhy, "fsk": FskStreamPhy}


def _jax_configs():
    from trackmaker_tpu.core.config import MacConfig as JaxMacConfig
    from trackmaker_tpu.core.config import PhyConfig as JaxPhyConfig

    return JaxPhyConfig, JaxMacConfig


def _transfer(link, phy_config, mac_config, arq: str, coding: str, sigma: float, **kw):
    """A transfer over a line code, or over the OFDM stream PHY `coding`
    names (each node its own, on the transfer's `device` where given)."""
    data = bytes(range(256)) + bytes(range(0, 256, 3))
    if coding in OFDM:
        phy_kw = {"device": kw["device"]} if "device" in kw else {}
        kw["phy_factory"] = lambda addr, phy=link[coding]: phy(local_addr=addr, **phy_kw)
        coding = "manchester"
    received, stats = link[arq](data, cfg=phy_config(line_coding=coding),
                                mac_cfg=mac_config(), noise_std=sigma, seed=5,
                                max_duration_s=30.0, **kw)
    return data, received, stats


# --- configuration and framing ------------------------------------------------------


def test_mac_config_matches_jax():
    _, JaxMacConfig = _jax_configs()
    ours = [(f.name, f.default) for f in dataclasses.fields(MacConfig)]
    theirs = [(f.name, f.default) for f in dataclasses.fields(JaxMacConfig)]
    assert ours == theirs
    jmac = JaxMacConfig(ack_timeout_ms=150, energy_threshold=3.0, cw_max=64)
    assert dataclasses.asdict(convert.mac_config_from_fields(dataclasses.asdict(jmac))) == \
        dataclasses.asdict(jmac)
    with pytest.raises(KeyError):
        convert.mac_config_from_fields({"cw_min": 1, "no_such_field": 2})


@pytest.mark.parametrize("seq,src,dst,data", [(0, 1, 2, b""), (255, 2, 1, bytes(8)),
                                              (7, 3, 255, bytes(range(64)))])
def test_frame_new_ack_matches_jax(seq, src, dst, data):
    from trackmaker_tpu.core.framing import Frame as JaxFrame

    ours, theirs = Frame.new_ack(seq, src, dst, data), JaxFrame.new_ack(seq, src, dst, data)
    assert ours.to_bytes() == theirs.to_bytes()
    assert dataclasses.astuple(ours) == dataclasses.astuple(theirs)
    assert Frame.from_bytes(ours.to_bytes()) == ours


# --- the endpoint, the bus, carrier sense --------------------------------------------


def test_is_channel_busy_matches_jax():
    from trackmaker_tpu.link import is_channel_busy as jax_busy

    _, JaxMacConfig = _jax_configs()
    rng = np.random.default_rng(0)
    for thr, n_min in ((0.5, 20), (3.0, 20), (0.05, 1)):
        mac, jmac = (MacConfig(energy_threshold=thr, energy_detection_samples=n_min),
                     JaxMacConfig(energy_threshold=thr, energy_detection_samples=n_min))
        for n in (0, 1, 19, 20, 21, 128, 1000):
            for sigma in (0.01, 0.2, 1.0):
                x = rng.normal(0, sigma, n).astype(np.float32)
                assert is_channel_busy(x, mac) == jax_busy(x, jmac)
        edge = np.full(30, np.float32(thr))
        assert is_channel_busy(edge, mac) is jax_busy(edge, jmac) is False


def _drive_endpoint(ep_cls, state_cls) -> list:
    """A script of the MAC's endpoint calls; every observable, in order."""
    ep = ep_cls("e")
    out = []
    rng = np.random.default_rng(1)
    for step in range(40):
        op = step % 5
        if op == 0:
            ep.set_playback(rng.normal(0, 1, int(rng.integers(0, 400))).astype(np.float32))
            ep.set_state([state_cls.PLAYING, state_cls.RECORDING_AND_PLAYING][step % 2])
        elif op == 1:
            out.append(ep.pull_playback(128).tolist())
        elif op == 2:
            ep.push_record(rng.normal(0, 1, 128).astype(np.float32))
        elif op == 3:
            out.append(ep.peek_record().tolist())
            if step % 3 == 0:
                out.append(ep.take_record().tolist())
        else:
            if step % 4 == 0:
                ep.clear_record()
            ep.set_state([state_cls.IDLE, state_cls.RECORDING][step % 2])
        out.append((ep.state.name, ep.record_len(), ep.playing_remaining,
                    ep.samples_played, ep.samples_recorded))
    return out


def test_endpoint_matches_jax():
    from trackmaker_tpu.link import AppState as JaxAppState
    from trackmaker_tpu.link import AudioEndpoint as JaxAudioEndpoint

    assert [s.name for s in AppState] == [s.name for s in JaxAppState]
    assert _drive_endpoint(AudioEndpoint, AppState) == _drive_endpoint(JaxAudioEndpoint,
                                                                       JaxAppState)


def test_endpoint_plays_a_tensor_as_its_samples():
    """set_playback takes the port's encoder's tensor as it would its NumPy
    samples."""
    wave = np.random.default_rng(2).normal(0, 1, 300).astype(np.float32)
    played = []
    for samples in (wave, torch.from_numpy(wave.copy())):
        ep = AudioEndpoint("e")
        ep.set_playback(samples)
        ep.set_state(AppState.PLAYING)
        played.append(ep.pull_playback(400))
    assert played[0].dtype == played[1].dtype == np.float32
    np.testing.assert_array_equal(played[0], played[1])


def _drive_bus(bus_cls, ep_cls, state_cls) -> list:
    class Ticks:
        def __init__(self):
            self.seen = []

        def on_tick(self, now):
            self.seen.append(now)

    bus = bus_cls(noise_std=0.1, seed=3, chunk=96)
    eps = [ep_cls(str(i)) for i in range(3)]
    node = Ticks()
    for i, ep in enumerate(eps):
        bus.attach(ep, node if i == 1 else None)
    bus.set_gain(0, 2, 0.5)
    bus.set_gain(1, 2, 0.0)
    eps[0].set_playback(np.linspace(-1, 1, 300, dtype=np.float32))
    eps[0].set_state(state_cls.PLAYING)
    eps[1].set_playback(np.full(150, 0.25, np.float32))
    eps[1].set_state(state_cls.RECORDING_AND_PLAYING)
    eps[2].set_state(state_cls.RECORDING)
    bus.run(700, until=lambda: bus.now >= 480)
    return [ep.take_record().tobytes() for ep in eps] + [node.seen, bus.now, bus.ms(25)]


def test_bus_matches_jax_sample_for_sample():
    from trackmaker_tpu.link import AppState as JaxAppState
    from trackmaker_tpu.link import AudioEndpoint as JaxAudioEndpoint
    from trackmaker_tpu.link import SimulatedBus as JaxSimulatedBus

    got = _drive_bus(SimulatedBus, AudioEndpoint, AppState)
    assert got == _drive_bus(JaxSimulatedBus, JaxAudioEndpoint, JaxAppState)
    assert got[-3] == [96, 192, 288, 384, 480]


# --- the SACK codec -------------------------------------------------------------------


@pytest.mark.parametrize("expected,have", [(7, {9, 12, 7 + 64}), (250, {251, 253, 54}),
                                           (0, set()), (3, {4, 5, 200, 3 + 65}),
                                           (255, {0, 63})])
def test_sack_codec_matches_jax(expected, have):
    from trackmaker_tpu.link.sr import decode_sack as jax_decode_sack
    from trackmaker_tpu.link.sr import encode_sack as jax_encode_sack

    ours, theirs = sr.encode_sack(expected, have, 2, 1), jax_encode_sack(expected, have, 2, 1)
    assert ours.to_bytes() == theirs.to_bytes()
    wire = Frame.from_bytes(ours.to_bytes())
    assert sr.decode_sack(wire) == jax_decode_sack(theirs)


# --- transfers --------------------------------------------------------------------------


@pytest.mark.parametrize("arq,coding,sigma", TRANSFERS)
def test_transfer_matches_jax(arq, coding, sigma):
    """Received bytes and the whole stats dict equal the JAX package's."""
    data, got, stats = _transfer(PORT_LINK, PhyConfig, MacConfig, arq, coding, sigma,
                                 device="cpu")
    _, want, want_stats = _transfer(_jax_link(), *_jax_configs(), arq, coding, sigma)
    assert got == want == data
    assert stats == want_stats


def test_run_file_transfer(tmp_path):
    src, dst = tmp_path / "INPUT1to2.bin", tmp_path / "OUTPUT1to2.bin"
    src.write_bytes(bytes(range(200)))
    stats = transfer.run_file_transfer(src, dst, device="cpu", max_duration_s=10.0)
    assert stats["exact"] and dst.read_bytes() == bytes(range(200))
    assert transfer.chunk_payload(bytes(300), 128) == [bytes(128), bytes(128), bytes(44)]
    received, stats = transfer.transfer_over_bus(b"", device="cpu", max_duration_s=1.0)
    assert received == b"" and stats["acked"] == 0


@pytest.mark.parametrize("name", list(chip_smoke.MAC_RUNS))
def test_chip_smoke_mac_expect_is_the_jax_packages(name):
    """chip_smoke.py's MAC runs through the JAX package: the data arrives and
    the stats equal MAC_EXPECT, which the port's runs on the card must equal."""
    data, received, stats = chip_smoke.mac_run(name, _jax_link(), *_jax_configs())
    assert received == data
    assert stats == chip_smoke.MAC_EXPECT[name]


def test_mac_runs_exercise_the_arq_paths():
    """The noisy window runs retransmit: MAC_EXPECT holds their ARQ paths."""
    for name in ("gbn_transfer, noise", "sr_transfer, noise"):
        assert chip_smoke.MAC_EXPECT[name]["retransmit_bursts"] > 0
    assert chip_smoke.MAC_EXPECT["sr_transfer, noise"]["frames_retransmitted"] > 0
    assert set(chip_smoke.MAC_EXPECT) == set(chip_smoke.MAC_RUNS)
    assert chip_smoke.MAC_RUNS["csma_transfer, ofdm_v2"][2]["phy"] == "ofdm_v2"


def test_nodes_default_to_the_card():
    nodes = [gbn.GbnSender(AudioEndpoint(), PhyConfig(), MacConfig(), 1, 2),
             sr.SrReceiver(AudioEndpoint(), PhyConfig(), MacConfig(), 2, 1)]
    for node in nodes:
        assert node.encoder.device == node.decoder.device == torch.device("cuda")


# --- on the card --------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("arq,coding,sigma", TRANSFERS)
def test_transfer_on_the_card_equals_the_cpu(cuda, arq, coding, sigma):
    got = _transfer(PORT_LINK, PhyConfig, MacConfig, arq, coding, sigma, device=cuda)
    want = _transfer(PORT_LINK, PhyConfig, MacConfig, arq, coding, sigma, device="cpu")
    assert got == want
