"""Multi-device dry run of the sharded decodes (counterpart of
``__graft_entry__.py:dryrun_multichip``): four checks over a mesh of an
explicit device list, on small captures.

1. one long capture of 12 frames through ``decode_blocked_sharded`` over a
   (dp, sp) mesh, by the exact route and by the speculative route;
2. ``batch_sharded_decode`` of one capture per device over dp = n;
3. ``decode_ofdm_blocked_sharded`` of 2n OFDM frames, blocks longer than
   the halo;
4. the evil seam on the speculative route: a frame whose payload embeds
   the preamble's bytes and a CRC-valid frame of sequence 99, across the
   seam of shards 0 and 1 and a seam in the middle of the mesh, decoded as
   the sequential exact scan decodes it (sequence 99 zero times).

    python -m trackmaker_tpu_torch.tools.dryrun_multichip [n_shards] [--cpu]

runs it over n_shards shards of the visible cards in turn (``--cpu``: of
the CPU) and prints one line.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

LOCAL_ADDR = 2


def _example_capture(cfg, n_frames: int, seed: int = 0) -> np.ndarray:
    """n_frames frames of random 64-byte payloads, 240 samples apart."""
    from trackmaker_tpu_torch.core.framing import Frame
    from trackmaker_tpu_torch.phy.encoder import PhyEncoder

    rng = np.random.default_rng(seed)
    frames = [Frame.new_data(i, 1, 2, rng.integers(0, 256, 64, dtype=np.uint8).tobytes())
              for i in range(n_frames)]
    return PhyEncoder(cfg, device="cpu").encode_frames(frames, gap_samples=240).numpy()


def evil_frame(seq: int, payload: bytes):
    """A frame whose payload embeds the preamble's bytes and a CRC-valid
    frame of sequence 99 (tests/test_parallel_adversarial.py's attack)."""
    from trackmaker_tpu_torch.core.bitops import crc8_host
    from trackmaker_tpu_torch.core.framing import Frame

    n = len(payload)
    embedded = bytes([n >> 8, n & 0xFF, crc8_host(payload), 1, 99, 1, 2]) + payload
    return Frame.new_data(seq, 1, 2, bytes([0x33, 0x5A]) + embedded)


def _pairs(res) -> list[tuple[int, int]]:
    valid = res.valid.cpu().numpy()
    return sorted(zip(res.start.cpu().numpy()[valid].tolist(),
                      res.sequence.cpu().numpy()[valid].tolist()))


def dryrun_multichip(n_shards: int, devices) -> dict:
    """Run the four checks over the first n_shards of `devices` (repeats
    allowed); raises AssertionError on a failed check, else returns what
    each check found."""
    from trackmaker_tpu_torch.core.config import PhyConfig
    from trackmaker_tpu_torch.core.framing import Frame
    from trackmaker_tpu_torch.parallel import (batch_sharded_decode, decode_blocked_sharded,
                                               decode_ofdm_blocked_sharded, make_mesh)
    from trackmaker_tpu_torch.parallel.ofdm_stream import ofdm_halo_size
    from trackmaker_tpu_torch.parallel.stream import halo_size
    from trackmaker_tpu_torch.phy.decoder import decode_capture
    from trackmaker_tpu_torch.phy.encoder import PhyEncoder
    from trackmaker_tpu_torch.phy.ofdm_v2 import OfdmModemV2, OfdmV2Config

    devices = [torch.device(d) for d in devices][:n_shards]
    if len(devices) < n_shards:
        raise ValueError(f"need {n_shards} devices, {len(devices)} given")
    cfg = PhyConfig()
    wave = _example_capture(cfg, n_frames=3)
    # sp takes the largest power of 2 up to n / 2 that divides n
    sp = 1
    while sp * 2 <= n_shards // 2 and n_shards % (sp * 2) == 0:
        sp *= 2
    dp = n_shards // sp
    mesh = make_mesh(n_shards, dp=dp, sp=sp, devices=devices)

    # 1. the long capture over dp x sp shards, by both routes
    long_wave = np.concatenate([wave] * 4)
    counts = {route: int(decode_blocked_sharded(cfg, long_wave, LOCAL_ADDR, mesh,
                                                max_frames_per_block=8,
                                                use_spec=route == "spec").count)
              for route in ("exact", "spec")}
    assert counts == {"exact": 12, "spec": 12}, f"sharded decode found {counts}, wanted 12"

    # 2. one capture a device over dp = n
    mesh_dp = make_mesh(n_shards, dp=n_shards, sp=1, devices=devices)
    res = batch_sharded_decode(cfg, np.stack([wave] * n_shards), LOCAL_ADDR, mesh_dp,
                               max_frames=8)
    dp_counts = res.count.tolist()
    assert dp_counts == [3] * n_shards, dp_counts

    # 3. OFDM frames over the mesh, blocks longer than the halo
    ocfg = OfdmV2Config()
    modem = OfdmModemV2(ocfg, device="cpu")
    payload = 24
    oframes = [Frame.new_data(i, 1, 2, bytes([i + 1]) * payload) for i in range(2 * n_shards)]
    halo = ofdm_halo_size(ocfg, (7 + payload) * 8)
    rng = np.random.default_rng(0)
    parts = []
    for f in oframes:
        parts += [modem.encode_frames([f]),
                  np.zeros(int(rng.integers(200, halo // 2)), np.float32)]
    owave = np.concatenate(parts + [np.zeros(900, np.float32)])
    owave = np.concatenate([owave, np.zeros(n_shards * halo, np.float32)])
    ogot = decode_ofdm_blocked_sharded(ocfg, owave, 7 + payload, mesh, max_frames_per_block=8)
    assert [f.data for f in ogot] == [f.data for f in oframes], (
        f"ofdm sharded decode: {len(ogot)} of {len(oframes)} frames")

    # 4. the evil seam through the speculative route
    ew = PhyEncoder(cfg, device="cpu").encode_frame(evil_frame(5, b"EVIL-EMBEDDED")).numpy()
    block = halo_size(cfg) + 400
    ewave = np.zeros(n_shards * block, np.float32)
    pos = block - 80                       # across the seam of shards 0 and 1
    ewave[pos:pos + len(ew)] = ew
    pos2 = (n_shards // 2) * block - 60    # and a seam in the middle of the mesh
    if pos2 > pos + len(ew):
        ewave[pos2:pos2 + len(ew)] = ew
    want = _pairs(decode_capture(cfg, torch.from_numpy(ewave).to(devices[0]), LOCAL_ADDR,
                                 max_frames=16))
    got = _pairs(decode_blocked_sharded(cfg, ewave, LOCAL_ADDR, mesh, max_frames_per_block=8,
                                        use_spec=True))
    assert got == want, f"adversarial seam mismatch: {got} != {want}"
    assert got and all(sq == 5 for _, sq in got), f"the embedded frame decoded: {got}"
    return {"mesh": (dp, sp), "counts": counts, "dp_counts": dp_counts,
            "ofdm_frames": len(ogot), "evil_seam": got}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("n_shards", type=int, nargs="?", default=8)
    parser.add_argument("--cpu", action="store_true", help="shards of the CPU")
    args = parser.parse_args(argv)
    if args.cpu:
        devices = ["cpu"] * args.n_shards
    elif torch.cuda.is_available():
        count = torch.cuda.device_count()
        devices = [torch.device("cuda", i % count) for i in range(args.n_shards)]
    else:
        print("no CUDA device found (pass --cpu to run on the CPU)", file=sys.stderr)
        return 1
    got = dryrun_multichip(args.n_shards, devices)
    print(f"dryrun_multichip OK: mesh={got['mesh']}, blocked counts={got['counts']}, dp "
          f"counts={got['dp_counts']}, ofdm={got['ofdm_frames']} frames, evil-seam frames="
          f"{got['evil_seam']} (the embedded frame never decoded), on "
          f"{sorted(set(map(str, devices)))}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
