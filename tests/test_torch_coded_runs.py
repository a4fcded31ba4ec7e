"""The port's coded runs against the JAX package's, on the CPU:
``bench.ber.coded_ber_sweep``, a CSMA transfer over ``CodedManchesterPhy``,
and ``chip_smoke.py``'s coded gates (CODED_BER_EXPECT, CODED_DIGEST,
CODED4_DIGEST; the coded MAC run's MAC_EXPECT is
``tests/test_torch_link.py``'s).  The corpora come from ``chip_smoke.py``'s
builders (the port's encoders on the CPU, NumPy noise); this module imports
JAX only inside its tests.

Tolerances: none (sweep dicts, frames, digests of starts and bits, bytes
and stats dicts).  Every corpus asserts that no correlation lag lies within
1e-4 of its threshold.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from test_torch_coded import MARGIN, THR, _sig, jax_phy, port_phy
from trackmaker_tpu_torch.bench import ber
from trackmaker_tpu_torch.core.config import FOUR_B_FIVE_B, PhyConfig
from trackmaker_tpu_torch.phy import coded
from trackmaker_tpu_torch.sync import auto_xcorr


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread while this module runs: the suite runs a worker per
    core, and torch's own thread pool on top of that oversubscribes them."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# --- the sweep and chip_smoke.py's gates ---------------------------------------------------------


def test_small_coded_ber_sweep_equals_jax():
    """The coded 4B5B waveform at rate 3/4 (the defaults' Manchester sweep is
    CODED_BER_EXPECT's test)."""
    from trackmaker_tpu.bench import ber as jber

    kw4 = dict(snr_dbs=(-2, 4), n_frames=3, payload_len=24, line_coding="4b5b", rate34=True)
    assert ber.coded_ber_sweep(**kw4, device="cpu") == jber.coded_ber_sweep(**kw4)


def test_chip_smoke_coded_ber_expect_is_the_jax_packages():
    """CODED_BER_EXPECT, which the port's run on the card must equal, is the
    JAX package's coded_ber_sweep at its defaults; the port's CPU run gives
    the same, and the coded cliff sits left of the uncoded one."""
    from trackmaker_tpu.bench import ber as jber

    assert jber.coded_ber_sweep() == chip_smoke.CODED_BER_EXPECT
    assert ber.coded_ber_sweep(device="cpu") == chip_smoke.CODED_BER_EXPECT
    assert any(r["coded_loss_pct"] < r["uncoded_loss_pct"] for r in chip_smoke.CODED_BER_EXPECT)


def test_chip_smoke_coded_digests_are_the_jax_packages():
    """CODED_DIGEST and CODED4_DIGEST are the JAX package's batched decodes of
    coded_manchester_b8 and of the coded 4B5B rate-3/4 batch; the port's CPU
    runs give the same decisions, every frame of every capture decodes, and
    no lag lies within MARGIN of either threshold."""
    import jax.numpy as jnp

    from trackmaker_tpu.core.config import PhyConfig as JaxPhyConfig
    from trackmaker_tpu.phy.coded import CodedManchesterPhy as JaxCodedManchesterPhy

    frames, caps = chip_smoke.coded_input()
    assert caps.shape == (chip_smoke.CODED_BATCH, 235_092)
    f, plen = chip_smoke.CODED_FRAMES, chip_smoke.CODED_PAYLOAD
    sj, bj = JaxCodedManchesterPhy(JaxPhyConfig(), local_addr=2).batched_decode_fn(f, plen)(
        jnp.asarray(caps))
    assert chip_smoke.ofdm_digest(np.asarray(sj), np.asarray(bj)) == chip_smoke.CODED_DIGEST
    phy = coded.CodedManchesterPhy(PhyConfig(), local_addr=2, device="cpu")
    sp, bp = phy.batched_decode_fn(f, plen)(torch.from_numpy(caps))
    np.testing.assert_array_equal(sp.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(bp.numpy(), np.asarray(bj))
    assert all([_sig(x) for x in row] == [_sig(x) for x in frames]
               for row in phy.decode_equal_frames(caps, f, plen))
    corr = auto_xcorr(torch.from_numpy(caps), phy.pre)
    assert (corr - phy.cfg.correlation_threshold).abs().min().item() > MARGIN

    frames4, caps4 = chip_smoke.coded4_input()
    j4, p4 = jax_phy(FOUR_B_FIVE_B, True), port_phy(FOUR_B_FIVE_B, True)
    n4 = chip_smoke.CODED4_FRAMES + 2
    sj, bj = j4.batched_decode_fn(n4, chip_smoke.CODED4_PAYLOAD)(jnp.asarray(caps4))
    assert chip_smoke.ofdm_digest(np.asarray(sj), np.asarray(bj)) == chip_smoke.CODED4_DIGEST
    sp, bp = p4.batched_decode_fn(n4, chip_smoke.CODED4_PAYLOAD)(torch.from_numpy(caps4))
    np.testing.assert_array_equal(sp.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(bp.numpy(), np.asarray(bj))
    assert all([_sig(x) for x in row] == [_sig(x) for x in frames4]
               for row in p4.decode_equal_frames(caps4, n4, chip_smoke.CODED4_PAYLOAD))
    corr = auto_xcorr(torch.from_numpy(caps4), p4.pre)
    assert (corr - THR).abs().min().item() > MARGIN


def test_small_csma_transfer_over_the_coded_phy_equals_jax():
    """Bytes and the whole stats dict of a noisy CSMA transfer over
    CodedManchesterPhy, each node its own, equal JAX's."""
    from trackmaker_tpu.core.config import MacConfig as JaxMacConfig
    from trackmaker_tpu.core.config import PhyConfig as JaxPhyConfig
    from trackmaker_tpu.link.transfer import transfer_over_bus as jax_transfer
    from trackmaker_tpu.phy.coded import CodedManchesterPhy as JaxCodedManchesterPhy
    from trackmaker_tpu_torch.core.config import MacConfig
    from trackmaker_tpu_torch.link.transfer import transfer_over_bus

    data = bytes(range(200))
    kw = dict(noise_std=0.7, seed=3, max_duration_s=30.0)
    cfg = PhyConfig(correlation_threshold=THR)
    got = transfer_over_bus(data, cfg=cfg, mac_cfg=MacConfig(energy_threshold=3.0), **kw,
                            phy_factory=lambda a: coded.CodedManchesterPhy(
                                cfg, local_addr=a, device="cpu"), device="cpu")
    jcfg = JaxPhyConfig(correlation_threshold=THR)
    want = jax_transfer(data, cfg=jcfg, mac_cfg=JaxMacConfig(energy_threshold=3.0), **kw,
                        phy_factory=lambda a: JaxCodedManchesterPhy(jcfg, local_addr=a))
    assert got == want and got[0] == data
