"""The port's ping round trip (``trackmaker_tpu_torch.net.tools`` over
``link.interface.AcousticInterface``: the whole PHY+MAC+NET stack in a
simulated audio loopback) against the JAX package's, on the CPU, and on
the card against the port's CPU run.

The bus draws its noise from ``np.random.default_rng(seed)``, the pinging
interface its backoff from ``random.Random(seed)`` and the host's from
``seed + 1``, every deadline counts samples and the RTTs are computed from
sample counts; so when the port's PHY decides as the JAX package's does,
``run_ping_simulation``'s whole dict is equal, floats included.  The runs
are ``chip_smoke.PING_RUNS`` (the router run is in
``tests/test_torch_router.py``; one runs over the OFDM v2 stream PHY) and a
lossy one.  The JAX side runs as its
own suite runs it here; the port's PhyDecoder runs the speculative
decode's plain versions.  This module imports JAX only inside its tests,
so the tests marked ``gpu`` run on a card without it.

Tolerances: none (integers, and floats computed from equal integers by the
same Python expressions).
"""

import inspect

import pytest
import torch

import chip_smoke
from trackmaker_tpu_torch.core.config import MacConfig, NetConfig, PhyConfig
from trackmaker_tpu_torch.link import AcousticInterface, AudioEndpoint
from trackmaker_tpu_torch.net import tools

PINGS = [name for name in chip_smoke.PING_RUNS if name != "router"]
# every ping lost: the timeout path and the empty summary
LOSSY = {"count": 3, "noise_std": 0.3, "seed": 5, "max_duration_s": 30.0}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread while this module runs: the suite runs a worker per
    core, and torch's own thread pool on top of that oversubscribes them."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


_JAX_RUNS: dict = {}


def jax_ping(name: str) -> dict:
    """The JAX package's result of PING_RUNS[name], run once a session."""
    if name not in _JAX_RUNS:
        _JAX_RUNS[name] = chip_smoke.ping_run(name, chip_smoke.net_modules("trackmaker_tpu"))
    return _JAX_RUNS[name]


def port_ping(name: str, device) -> dict:
    return chip_smoke.ping_run(name, chip_smoke.net_modules("trackmaker_tpu_torch"),
                               device=device)


@pytest.mark.parametrize("name", PINGS)
def test_ping_matches_jax(name):
    """The whole stats dict equals the JAX package's, floats included."""
    got = port_ping(name, "cpu")
    assert got == jax_ping(name)
    assert got["received"] == got["sent"] == got["responded"] == chip_smoke.PING_RUNS[name]["count"]


@pytest.mark.parametrize("name", PINGS)
def test_chip_smoke_ping_expect_is_the_jax_packages(name):
    """PING_EXPECT, which the port's runs on the card must equal, is the
    JAX package's result."""
    assert jax_ping(name) == chip_smoke.PING_EXPECT[name]


def test_ping_runs_exercise_their_paths():
    """The fragmented run's echo exceeds the MTU, so the fragmenter and the
    reassembler run; the 4B5B run's PHY decodes 4B5B."""
    frag = chip_smoke.PING_RUNS["ping, fragments"]["payload_size"] + 28
    assert frag > NetConfig().mtu
    assert chip_smoke.PING_RUNS["ping, 4b5b"]["line_coding"] == "4b5b"
    assert chip_smoke.PING_RUNS["ping, ofdm_v2"]["phy"] == "ofdm_v2"
    assert set(chip_smoke.PING_EXPECT) == set(chip_smoke.PING_RUNS)


def test_lossy_ping_matches_jax():
    """At sigma 0.3 every echo is lost: the deadlines expire, the summary is
    empty, and the dict still equals the JAX package's."""
    from trackmaker_tpu.net.tools import run_ping_simulation as jax_run_ping_simulation

    got = tools.run_ping_simulation(**LOSSY, device="cpu")
    assert got == jax_run_ping_simulation(**LOSSY)
    assert got["sent"] == 3 and got["received"] == 0 and got["loss_pct"] == 100.0
    assert got["rtt_min_ms"] is got["rtt_avg_ms"] is got["rtt_max_ms"] is None
    assert got["airtime_s"] == 192_128 / 48_000     # the 30 s cap not reached: the last deadline


@pytest.mark.parametrize("sent,rtts", [(0, []), (3, []), (4, [208.0]), (2, [152.0, 162.5])])
def test_ping_stats_summary_matches_jax(sent, rtts):
    from trackmaker_tpu.net.tools import PingStats as JaxPingStats

    ours = tools.PingStats(sent, len(rtts), list(rtts))
    theirs = JaxPingStats(sent, len(rtts), list(rtts))
    assert ours.summary() == theirs.summary()
    assert ours.loss_pct == theirs.loss_pct


def test_interface_and_ping_default_to_the_card():
    iface = AcousticInterface(AudioEndpoint(), PhyConfig(), MacConfig(), NetConfig(), 2)
    assert iface.encoder.device == iface.decoder.device == torch.device("cuda")
    assert inspect.signature(tools.run_ping_simulation).parameters["device"].default == "cuda"
    phy = chip_smoke.LineCodedPhy(None, None)
    assert AcousticInterface(AudioEndpoint(), PhyConfig(), MacConfig(), NetConfig(), 2,
                             phy=phy).decoder is phy


# --- on the card ------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("name", PINGS)
def test_ping_on_the_card_equals_the_cpu(cuda, name):
    assert port_ping(name, cuda) == port_ping(name, "cpu")
