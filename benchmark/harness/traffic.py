"""The one traffic generator: recordings made on the device from a seed.

A traffic mix is a JSON file of parameters under ``workloads/``; this
module reads every mix.  A request is `rows` recordings of `row_samples`
samples (or `seconds` of audio) at the configuration's sample rate, taken
in turn from a pool of `pool` distinct requests that set-up makes on the
device.  Each recording holds `frames_per_row` frames of random
`payload_bytes`-byte payloads, numbered from 0, from `src`, addressed to
`local_addr` except for a `foreign_share` of them (exactly that many in
each recording, at random) addressed to `foreign_dst`.  Frames are placed

* ``"placement": "gaps"``: one after another from sample 0, each gap drawn
  from `gap_samples` [lo, hi]; with ``"row_samples": "fit"`` the recording
  is as long as the longest gaps need, and noise fills it past the last
  frame;
* ``"placement": "spread"``: at random over the recording with no overlap,
  at least `min_gap_samples` apart.

An optional ``"echo": [[delay, gain], ...]`` adds delayed copies of the
clean signal; then Gaussian noise of `noise_sigma` is added everywhere.
Every seed gives the same sizes and counts; only the bytes, the positions
and the noise change.
"""

from __future__ import annotations

import torch

from harness import phy as P


def row_samples(phy: P.Phy, mix: dict) -> int:
    if "seconds" in mix:
        return int(round(mix["seconds"] * phy.sample_rate))
    if mix["row_samples"] == "fit":
        if mix["placement"] != "gaps":
            raise ValueError("row_samples 'fit' needs placement 'gaps'")
        n = mix["frames_per_row"]
        return n * phy.frame_samples(mix["payload_bytes"]) + (n - 1) * mix["gap_samples"][1]
    return int(mix["row_samples"])


def audio_seconds(phy: P.Phy, mix: dict) -> float:
    """Seconds of audio in one request."""
    return mix["rows"] * row_samples(phy, mix) / phy.sample_rate


def _starts(mix: dict, rows: int, t: int, fl: int, g: torch.Generator, dev) -> torch.Tensor:
    """Frame starts int64[rows, F], ascending, frames of fl samples."""
    n = mix["frames_per_row"]
    if mix["placement"] == "gaps":
        lo, hi = mix["gap_samples"]
        gaps = torch.randint(lo, hi + 1, (rows, n - 1), generator=g, device=dev)
        steps = torch.cat([torch.zeros((rows, 1), dtype=torch.int64, device=dev),
                           gaps + fl], dim=1)
        starts = steps.cumsum(1)
    elif mix["placement"] == "spread":
        gap = mix["min_gap_samples"]
        slack = t - n * fl - (n - 1) * gap
        if slack < 0:
            raise ValueError("the frames do not fit the recording")
        u = torch.randint(0, slack + 1, (rows, n), generator=g, device=dev).sort(1).values
        starts = u + torch.arange(n, device=dev) * (fl + gap)
    else:
        raise ValueError(f"unknown placement {mix['placement']!r}")
    if int(starts[:, -1].max()) + fl > t:
        raise ValueError("the frames do not fit the recording")
    return starts


def make_request(phy: P.Phy, mix: dict, g: torch.Generator, dev) -> tuple[torch.Tensor, dict]:
    """One request's recordings f32[rows, T] and what was planted in them."""
    rows, n, length = mix["rows"], mix["frames_per_row"], mix["payload_bytes"]
    t = row_samples(phy, mix)
    payload = torch.randint(0, 256, (rows * n, length), generator=g, device=dev,
                            dtype=torch.int64).to(torch.uint8)
    n_foreign = int(round(mix["foreign_share"] * n))
    rank = torch.rand((rows, n), generator=g, device=dev).argsort(1).argsort(1)
    foreign = (rank < n_foreign).reshape(-1)
    dst = torch.where(foreign, mix["foreign_dst"], mix["local_addr"])
    seq = torch.arange(n, device=dev).repeat(rows)
    frames = P.frame_bytes(payload, torch.full_like(seq, P.FRAME_TYPE_DATA), seq,
                           torch.full_like(seq, mix["src"]), dst)
    waves = P.encode(phy, frames)
    fl = waves.shape[1]
    starts = _starts(mix, rows, t, fl, g, dev)
    x = torch.zeros((rows, t), dtype=torch.float32, device=dev)
    row_base = torch.arange(rows, device=dev)[:, None] * t
    for r0 in range(0, rows, 16):     # index tensors of 16 recordings at a time
        sel = slice(r0 * n, (r0 + 16) * n)
        idx = (row_base[r0:r0 + 16] + starts[r0:r0 + 16]).reshape(-1, 1) + torch.arange(fl, device=dev)
        x.view(-1)[idx.reshape(-1)] = waves[sel].reshape(-1)
    if mix.get("echo"):
        clean = x.clone()
        for delay, gain in mix["echo"]:
            x[:, delay:] += gain * clean[:, :t - delay]
        del clean
    x += torch.randn((rows, t), generator=g, device=dev) * mix["noise_sigma"]
    truth = {"starts": starts, "frames": frames.reshape(rows, n, -1), "dst": dst.reshape(rows, n)}
    return x, truth


def make_pool(phy: P.Phy, mix: dict, seed: int, dev) -> torch.Tensor:
    """The pool of distinct requests f32[pool, rows, T] for `seed`."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    t = row_samples(phy, mix)
    pool = torch.empty((mix["pool"], mix["rows"], t), dtype=torch.float32, device=dev)
    for p in range(mix["pool"]):
        pool[p], _ = make_request(phy, mix, g, dev)
    return pool
