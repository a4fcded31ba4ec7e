"""The generator: the same seed gives the same recordings, every seed the
same sizes, and the frames where the mix says."""

import pytest
import torch

from harness import manifest, traffic
from harness import phy as P

CONFIGS = ("manchester", "fourb5b")


def phy_of(name):
    return P.Phy(manifest.config(manifest.load(), name))


def small(mix_name, **kw):
    mix = manifest.traffic(mix_name)
    mix.update(kw)
    return mix


@pytest.mark.parametrize("cfg", CONFIGS)
@pytest.mark.parametrize("mix_name", ["corpus", "hour"])
def test_same_seed_same_pool(cfg, mix_name):
    phy = phy_of(cfg)
    mix = (small("corpus", rows=2, frames_per_row=5, pool=2) if mix_name == "corpus"
           else small("hour", seconds=3, frames_per_row=7, pool=2))
    seed = 2**31 + 12345     # seeds may pass 32 signed bits
    a = traffic.make_pool(phy, mix, seed, "cpu")
    b = traffic.make_pool(phy, mix, seed, "cpu")
    c = traffic.make_pool(phy, mix, seed + 1, "cpu")
    assert torch.equal(a, b)
    assert a.shape == c.shape
    assert not torch.equal(a, c)
    assert not torch.equal(a[0], a[1])     # the pool's entries are distinct


@pytest.mark.parametrize("cfg,t", [("manchester", 423_888), ("fourb5b", 266_064)])
def test_corpus_rows_fit_the_longest_gaps(cfg, t):
    phy = phy_of(cfg)
    assert traffic.row_samples(phy, manifest.traffic("corpus")) == t
    mix = manifest.traffic("corpus")
    assert traffic.audio_seconds(phy, mix) == pytest.approx(mix["rows"] * t / 48_000)


@pytest.mark.parametrize("cfg", CONFIGS)
def test_hour_is_an_hour(cfg):
    assert traffic.row_samples(phy_of(cfg), manifest.traffic("hour")) == 172_800_000


@pytest.mark.parametrize("cfg", CONFIGS)
@pytest.mark.parametrize("placement", ["gaps", "spread"])
def test_planted_frames(cfg, placement):
    phy = phy_of(cfg)
    if placement == "gaps":
        mix = small("corpus", rows=3, frames_per_row=8, noise_sigma=0.0)
    else:
        mix = small("hour", seconds=2, frames_per_row=8, noise_sigma=0.0)
    g = torch.Generator().manual_seed(5)
    x, truth = traffic.make_request(phy, mix, g, "cpu")
    fl = phy.frame_samples(mix["payload_bytes"])
    starts = truth["starts"]
    step = starts[:, 1:] - starts[:, :-1]
    if placement == "gaps":     # the sender's gap between frames
        gap = manifest.config(manifest.load(), cfg)["inter_frame_gap_samples"]
        assert mix["gap_samples"] == [gap, gap]
        assert (step == fl + gap).all()
        assert (starts[:, 0] == 0).all()
    else:
        assert (step >= fl + mix["min_gap_samples"]).all()
    assert ((truth["dst"] == 3).sum(1) == 2).all()    # a quarter of 8
    wave = P.encode(phy, truth["frames"].reshape(-1, truth["frames"].shape[-1]))
    for r in range(x.shape[0]):
        for k in range(8):
            s = int(starts[r, k])
            assert torch.equal(x[r, s:s + fl], wave[r * 8 + k])
    # silence between frames when there is no noise
    covered = torch.zeros_like(x, dtype=torch.bool)
    for r in range(x.shape[0]):
        for s in starts[r].tolist():
            covered[r, s:s + fl] = True
    assert (x[~covered] == 0).all()


def test_frame_bytes_layout():
    payload = torch.tensor([[1, 2, 3]], dtype=torch.uint8)
    one = torch.ones(1, dtype=torch.int64)
    fb = P.frame_bytes(payload, one, 5 * one, 1 * one, 2 * one)
    crc = 0
    for b in (1, 2, 3):
        crc = int(P.CRC8[crc ^ b])
    assert fb.tolist() == [[0, 3, crc, 1, 5, 1, 2, 1, 2, 3]]


def test_echo_adds_delayed_copies():
    phy = phy_of("manchester")
    mix = small("corpus", rows=2, frames_per_row=3, noise_sigma=0.0)
    clean, _ = traffic.make_request(phy, mix, torch.Generator().manual_seed(4), "cpu")
    mix["echo"] = [[9, 0.6], [20, -0.1]]
    echoed, _ = traffic.make_request(phy, mix, torch.Generator().manual_seed(4), "cpu")
    want = clean.clone()
    want[:, 9:] += 0.6 * clean[:, :-9]
    want[:, 20:] += -0.1 * clean[:, :-20]
    assert torch.allclose(echoed, want, atol=1e-6)
