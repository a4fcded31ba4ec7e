#!/usr/bin/env python3
"""The readings that the limits of ``correct`` are set from.

    python3 benchmark/control.py --workload manchester.corpus --seeds 1 2 3 ...

For each seed it makes the cell's pool as a run does, decodes every pool
entry through the program's entry point at the cell's sizes, and through
the control (the plain reference computed in the next precision below the
configuration's: bfloat16 for float32), and compares both with the float64
reference by the run's comparison.  It prints one line a seed and the
extremes: the program's largest readings (the lower ends of the limits)
and the control's smallest (the upper ends).  The benchmark's runs do not
run it.  Without a CUDA card it exits 2.
"""

import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
CONTROL_DTYPE = {"float64": "float32", "float32": "bfloat16"}


def readings(workload: str, seeds: list[int], device=None, mix_override=None) -> dict:
    """{"program": [checks a seed], "control": [checks a seed]} of `workload`."""
    for p in (str(BENCH), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    import torch

    from harness import check, manifest, traffic
    from harness import phy as P

    man = manifest.load(ROOT)
    cell = manifest.cell(man, workload)
    cfg = manifest.config(man, cell["config"], ROOT)
    mix = manifest.traffic(cell["traffic"])
    if mix_override:
        mix.update(mix_override)
    if device is None:
        if not torch.cuda.is_available():
            raise SystemExit(2)
        device = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phy = P.Phy(cfg)
    t = traffic.row_samples(phy, mix)
    entry = manifest.module("entries", mix["entry"]).Entry(cfg, phy, mix, t)
    ref = manifest.module("references", cfg["reference"])
    low = getattr(torch, CONTROL_DTYPE[cfg["precision"]])
    out = {"program": [], "control": []}
    for seed in seeds:
        pool = traffic.make_pool(phy, mix, seed % 2**63, device)
        prog_pairs, ctrl_pairs = [], []
        for p in range(mix["pool"]):
            host = [f.cpu().numpy() for f in entry(pool[p])]
            truth = ref.decode(phy, pool[p], mix["local_addr"], entry.ref_max_frames)["frames"]
            lower = ref.decode(phy, pool[p], mix["local_addr"], entry.ref_max_frames, dtype=low)
            prog_pairs.append((entry.frames(host), truth))
            ctrl_pairs.append((lower["frames"], truth))
        del pool
        out["program"].append(check.compare(prog_pairs, cfg["limits"]))
        out["control"].append(check.compare(ctrl_pairs, cfg["limits"]))
        print(json.dumps({"seed": seed, "program": {k: v["value"] for k, v in out["program"][-1].items()},
                          "control": {k: v["value"] for k, v in out["control"][-1].items()}}),
              flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    r = readings(args.workload, args.seeds)
    names = r["program"][0].keys()
    print(json.dumps({
        "workload": args.workload, "seeds": len(args.seeds),
        "program_max": {n: max(c[n]["value"] for c in r["program"]) for n in names},
        "control_min": {n: min(c[n]["value"] for c in r["control"]) for n in names},
        "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
