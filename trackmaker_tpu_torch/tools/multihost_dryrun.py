"""Multi-process dry run of the batch decode (counterpart of
``tools/multihost_dryrun.py``): each process joins the job over gloo,
encodes its own captures with the port's encoder, decodes them through
``parallel.multihost.decode_captures_multihost``, checks its payloads,
prints its frames (and the kernels' launches) as one JSON line, reaches the
closing barrier and exits 0.

Run once per process, all with the same coordinator:

    python -m trackmaker_tpu_torch.tools.multihost_dryrun <coordinator> <num_procs> <pid> [--cpu]

By default each process decodes 4 captures of one frame each (`--cpu`: on
4 CPU shards).  ``--flagship N`` decodes instead rows pid*N..(pid+1)*N-1 of
the flagship batch: 64 frames of random 128-byte payloads, 200-sample gaps,
noise sigma 0.05, payloads and noise from NumPy's default_rng(--seed), the
rows built as ``chip_smoke.py`` builds its 32.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

# the flagship batch (chip_smoke.py's N_FRAMES, PAYLOAD, GAP, NOISE)
FLAGSHIP_FRAMES = 64
FLAGSHIP_PAYLOAD = 128
FLAGSHIP_GAP = 200
FLAGSHIP_NOISE = 0.05
LOCAL_ADDR = 2


def small_captures(enc, pid: int, rows: int = 4, t: int = 20_000):
    """(payloads per row, captures f32[rows, t]): one frame of
    bytes([pid * 16 + i]) * (6 + i) at 137 * (i + 1) in noise sigma 0.02
    from default_rng(pid), as the JAX dry run builds them."""
    from trackmaker_tpu_torch.core.framing import Frame

    rng = np.random.default_rng(pid)
    caps, want = [], []
    for i in range(rows):
        payload = bytes([pid * 16 + i]) * (6 + i)
        w = enc.encode_frame(Frame.new_data(i, 1, LOCAL_ADDR, payload)).cpu().numpy()
        cap = np.zeros(t, np.float32)
        cap[137 * (i + 1): 137 * (i + 1) + len(w)] = w
        caps.append(cap + rng.normal(0, 0.02, t).astype(np.float32))
        want.append([payload])
    return want, np.stack(caps)


def flagship_rows(enc, seed: int, first: int, rows: int, total: int):
    """(payloads per row, rows first..first+rows-1 of the flagship batch of
    `total` rows), on the encoder's device."""
    import torch

    from trackmaker_tpu_torch.core.framing import Frame

    rng = np.random.default_rng(seed)
    frames = [Frame.new_data(i & 0xFF, 1, 2, rng.integers(
        0, 256, FLAGSHIP_PAYLOAD, dtype=np.uint8).tobytes()) for i in range(FLAGSHIP_FRAMES)]
    wave = enc.encode_frames(frames, gap_samples=FLAGSHIP_GAP)
    noise = rng.normal(0, FLAGSHIP_NOISE, (total, wave.shape[0])).astype(np.float32)
    x = wave[None] + torch.from_numpy(noise[first:first + rows]).to(wave.device)
    return [[f.data for f in frames]] * rows, x.contiguous()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("coordinator")
    parser.add_argument("num_procs", type=int)
    parser.add_argument("pid", type=int)
    parser.add_argument("--cpu", action="store_true", help="decode on 4 CPU shards")
    parser.add_argument("--flagship", type=int, default=0, metavar="N",
                        help="decode N rows of the flagship batch")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    import torch

    from trackmaker_tpu_torch.core.config import PhyConfig
    from trackmaker_tpu_torch.parallel import multihost
    from trackmaker_tpu_torch.phy import spec_decode
    from trackmaker_tpu_torch.phy.encoder import PhyEncoder
    from trackmaker_tpu_torch.sync.xcorr_hits import xcorr_hits

    if not args.cpu and not torch.cuda.is_available():
        print("no CUDA device found (pass --cpu to run on the CPU)", file=sys.stderr)
        return 1
    torch.set_num_threads(1)
    multihost.init_distributed(args.coordinator, args.num_procs, args.pid)
    devices = [torch.device("cpu")] * 4 if args.cpu else None
    cfg = PhyConfig()
    enc = PhyEncoder(cfg, device="cpu" if args.cpu else "cuda")
    if args.flagship:
        want, caps = flagship_rows(enc, args.seed, args.pid * args.flagship, args.flagship,
                                   args.num_procs * args.flagship)
    else:
        want, caps = small_captures(enc, args.pid)
    kernels = (xcorr_hits, spec_decode.attempt_manchester, spec_decode.spec_walk)
    for k in kernels:
        k.launches = 0
    max_frames = FLAGSHIP_FRAMES + 8 if args.flagship else 4
    res = multihost.decode_captures_multihost(cfg, caps, LOCAL_ADDR, max_frames=max_frames,
                                              devices=devices)
    valid, fb = res.valid.cpu().numpy(), res.frame_bytes.cpu().numpy()
    start, seq, ln = (a.cpu().numpy() for a in (res.start, res.sequence, res.length))
    frames = [[[int(start[r, k]), int(seq[r, k]), fb[r, k, 7:7 + ln[r, k]].tobytes().hex()]
               for k in np.nonzero(valid[r])[0]] for r in range(valid.shape[0])]
    got = [[bytes.fromhex(p) for _, _, p in row] for row in frames]
    ok = got == want
    print(json.dumps({"pid": args.pid, "processes": args.num_procs, "ok": ok,
                      "devices": [str(d) for d in multihost.global_dp_mesh(devices).local.flat],
                      "launches": {k.__name__: k.launches for k in kernels},
                      "frames": frames}), flush=True)
    multihost.finalize_distributed()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
