"""The plain reference finds every planted frame addressed to the local
address, and agrees with the program's CPU path at a tiny size."""

import numpy as np
import pytest
import torch

from harness import manifest, traffic
from harness import phy as P
from references import phy_exact_scan as R

CONFIGS = ("manchester", "fourb5b")


def setup(cfg, mix_name, **kw):
    man = manifest.load()
    c = manifest.config(man, cfg)
    mix = manifest.traffic(mix_name)
    mix.update(kw)
    return c, P.Phy(c), mix


@pytest.mark.parametrize("cfg", CONFIGS)
@pytest.mark.parametrize("mix_name", ["corpus", "hour"])
def test_reference_finds_every_planted_frame(cfg, mix_name):
    kw = (dict(rows=3, frames_per_row=8) if mix_name == "corpus"
          else dict(seconds=2, frames_per_row=10))
    _, phy, mix = setup(cfg, mix_name, **kw)
    x, truth = traffic.make_request(phy, mix, torch.Generator().manual_seed(9), "cpu")
    out = R.decode(phy, x, mix["local_addr"], mix.get("max_frames"))
    for r in range(x.shape[0]):
        want = [(int(truth["starts"][r, k]), truth["frames"][r, k].numpy().tobytes())
                for k in range(mix["frames_per_row"]) if int(truth["dst"][r, k]) == mix["local_addr"]]
        got = [(f[0], f[1]) for f in out["frames"][r]]
        assert got == want
        assert all(f[7] > 0.99 for f in out["frames"][r])
        assert len(out["hits"][r]) >= mix["frames_per_row"]


@pytest.mark.parametrize("cfg", CONFIGS)
def test_reference_rules_on_damaged_frames(cfg):
    """A frame cut by the recording's end stops the walk; a frame with a
    flipped payload bit fails its CRC and is consumed whole."""
    _, phy, mix = setup(cfg, "corpus", rows=1, frames_per_row=4, noise_sigma=0.0)
    x, truth = traffic.make_request(phy, mix, torch.Generator().manual_seed(3), "cpu")
    fl = phy.frame_samples(mix["payload_bytes"])
    starts = truth["starts"][0].tolist()
    local = truth["dst"][0] == mix["local_addr"]
    y = x.clone()
    s1 = starts[1] + phy.preamble_len + phy.samples_for_bits(8 * 20)   # a payload bit of frame 1
    y[0, s1:s1 + phy.spl * (2 if phy.line_coding == "manchester" else 1)] *= -1
    cut = starts[3] + fl // 2
    out = R.decode(phy, y[:, :cut], mix["local_addr"], 72)["frames"][0]
    want = [starts[k] for k in (0, 2) if bool(local[k])]
    assert [f[0] for f in out] == want


@pytest.mark.parametrize("cfg", CONFIGS)
def test_reference_equals_program_corpus(cfg):
    from entries.decode_capture_fast import Entry

    c, phy, mix = setup(cfg, "corpus", rows=3, frames_per_row=8)
    x, _ = traffic.make_request(phy, mix, torch.Generator().manual_seed(21), "cpu")
    entry = Entry(c, phy, mix, x.shape[1])
    prog = entry.frames([f.numpy() for f in entry(x)])
    ref = R.decode(phy, x, mix["local_addr"], entry.ref_max_frames)["frames"]
    assert [[f[:7] for f in row] for row in prog] == [[f[:7] for f in row] for row in ref]
    gap = max(abs(a[7] - b[7]) for pr, rr in zip(prog, ref) for a, b in zip(pr, rr))
    assert gap < 1e-5


@pytest.mark.parametrize("cfg", CONFIGS)
def test_reference_equals_program_blocked(cfg):
    from entries.decode_blocked_single_chip import Entry

    c, phy, mix = setup(cfg, "hour", seconds=3, frames_per_row=12, n_blocks=8,
                        max_frames_per_block=6)
    x, _ = traffic.make_request(phy, mix, torch.Generator().manual_seed(22), "cpu")
    entry = Entry(c, phy, mix, x.shape[1])
    prog = entry.frames([f.numpy() for f in entry(x)])
    ref = R.decode(phy, x, mix["local_addr"], entry.ref_max_frames)["frames"]
    assert [f[:7] for f in prog[0]] == [f[:7] for f in ref[0]]
    assert len(ref[0]) == 9     # the 12 frames less the quarter sent elsewhere


def test_correlate_matches_numpy():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 300))
    p = rng.normal(size=17).astype(np.float32)
    corr = R.correlate(torch.from_numpy(x), p, torch.float64).numpy()
    for r in range(2):
        for i in (0, 5, 283):
            w = x[r, i:i + 17]
            want = w @ p.astype(np.float64) / (np.linalg.norm(w) * np.linalg.norm(p.astype(np.float64)))
            assert corr[r, i] == pytest.approx(want, rel=1e-12)
