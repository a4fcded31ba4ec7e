#!/usr/bin/env python3
"""The benchmark of the PyTorch and CUDA port, one cell a run.

    python3 benchmark/run.py --workload manchester.corpus --seed 7 --seconds 10 --trace 0

From the root of a checkout.  Set-up makes the cell's pool of requests on
the card from the seed and warms the program's entry point up on them;
then, for `--seconds`, requests run one after another (one in flight),
each timed by the host's clock from the hand-over of its recordings to its
answer's fields being on the host.  After the window the plain reference
decodes the pool entries of a sample of the requests, drawn from the seed,
and the answers are compared with it.

The last line of standard output is the result as one JSON object: with
``--trace 0`` the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics, read from a ``torch.profiler`` trace of the window's
first `trace_seconds` (the mix's parameter).  The numbers compared and
their limits are the last lines of standard error and the result's last
key.  Without a CUDA card, or with fewer cards than the cell asks for, the
run exits 2 and prints no result; when a module of JAX, Flax or the JAX
package is loaded after the window, it exits 3.
"""

import time

T0 = time.perf_counter()   # the set-up is timed from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "trackmaker_tpu")   # whole top-level names
CACHES = {"TORCH_EXTENSIONS_DIR": "build/torch_extensions", "TRITON_CACHE_DIR": "build/triton"}


def forbidden_modules(names) -> list[str]:
    """The loaded top-level modules that no run may hold: JAX, Flax and the
    JAX package, compared whole (``trackmaker_tpu_torch`` is the port)."""
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


class Sample:
    """A reservoir of `k` requests' answers, drawn uniformly from all the
    window's requests by a generator seeded from the run's seed."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.seen, self.items = k, random.Random(seed), 0, {}

    def offer(self, index: int, pool_index: int, host) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            slot = len(self.items)
        else:
            slot = self.rng.randrange(self.seen)
            if slot >= self.k:
                return
        self.items[slot] = (index, pool_index, [a.copy() for a in host])


class Readback:
    """Copies an answer's fields to host buffers, pinned on a card, and
    waits for them: the request's end."""

    def __init__(self, torch):
        self.torch, self.bufs = torch, None

    def __call__(self, fields):
        torch = self.torch
        if self.bufs is None:
            pin = fields[0].is_cuda
            self.bufs = [torch.empty(f.shape, dtype=f.dtype, pin_memory=pin) for f in fields]
        for b, f in zip(self.bufs, fields):
            b.copy_(f, non_blocking=True)
        if fields[0].is_cuda:
            torch.cuda.current_stream(fields[0].device).synchronize()
        return [b.numpy() for b in self.bufs]


class ReadContext:
    """What a per-layer reader reads: the trace, the traced requests' work
    and the program's own kernel names."""

    def __init__(self, trace, works, port_kernels):
        self.trace, self.works, self.port_kernels = trace, works, port_kernels

    def roofline_share(self, part: str):
        """Percent of the least time of the traced requests' `part` work
        over the device time of every launch of its kernel in the trace;
        None where it did not run.  A launch beyond a request's own (the
        exact scan's dense correlation) adds time and no work."""
        from harness.roofline import least_seconds

        kernel = self.works[0][part][0]
        dev_s, launches = self.trace.device_seconds(kernel)
        if launches == 0 or dev_s <= 0:
            return None
        least = sum(least_seconds(w[part][1], w[part][2])[0] for w in self.works)
        return 100.0 * least / dev_s


def card_power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def run(args, device=None, entry_wrap=None) -> dict | None:
    """One run; returns the result object, or None after printing why there
    is none.  `device` None looks for the card; `entry_wrap`, where given,
    wraps the entry point (the tests' planted faults)."""
    for var, rel in CACHES.items():
        os.environ[var] = str(ROOT / rel)
    for p in (str(BENCH), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    import torch

    from harness import check, manifest, stats, traffic
    from harness import phy as P

    imported = time.perf_counter() - T0

    man = manifest.load(ROOT)
    cell = manifest.cell(man, args.workload)
    cfg = manifest.config(man, cell["config"], ROOT)
    mix = manifest.traffic(cell["traffic"])
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            print(f"{args.workload} needs {cell['chips']} CUDA card(s); "
                  f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return None
        device = torch.device("cuda:0")
    on_card = device.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    stages = {"imports": imported}

    def stage(name):
        if on_card:
            torch.cuda.synchronize(device)
        stages[name] = time.perf_counter() - T0 - sum(stages.values())

    if on_card:
        torch.empty(1, device=device)   # the CUDA context
    card = torch.cuda.get_device_name(device) if on_card else "cpu"
    stage("context")
    phy = P.Phy(cfg)
    t = traffic.row_samples(phy, mix)
    entry = manifest.module("entries", mix["entry"]).Entry(cfg, phy, mix, t)
    call = entry if entry_wrap is None else entry_wrap(entry)
    stage("entry")
    pool = traffic.make_pool(phy, mix, args.seed % 2**63, device)
    stage("pool")
    readback = Readback(torch)
    for w in range(mix["warmup"]):
        readback(call(pool[w % mix["pool"]]))
    stage("warmup")
    if on_card:
        setup_peak = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
        resident = torch.cuda.memory_allocated(device)
    setup_s = time.perf_counter() - T0
    print(f"set-up {setup_s:.3f} s ({', '.join(f'{k} {v:.3f}' for k, v in stages.items())}), "
          f"pool {tuple(pool.shape)}", file=sys.stderr, flush=True)

    sample = Sample(mix["check_requests"], args.seed)
    latencies, failed, attempted, traced = [], 0, 0, None
    session = span = None
    if args.trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
        session = profile(activities=acts)
        session.__enter__()
        span = record_function("bench.window")
        span.__enter__()
    t_start = time.perf_counter()
    deadline = t_start + args.seconds
    k = 0
    while True:
        p = k % mix["pool"]
        t0 = time.perf_counter()
        try:
            host = readback(call(pool[p]))
        except Exception:   # a failed request counts; the window goes on
            traceback.print_exc()
            host = None
        t1 = time.perf_counter()
        attempted += 1
        if host is None:
            failed += 1
        else:
            latencies.append(t1 - t0)
            sample.offer(k, p, host)
        k += 1
        if span is not None and (t1 - t_start >= mix["trace_seconds"] or t1 >= deadline):
            span.__exit__(None, None, None)
            session.__exit__(None, None, None)
            traced, span = k, None
        if t1 >= deadline:
            break
    window_s = t1 - t_start
    memory_peak = 0
    if on_card:
        torch.cuda.synchronize(device)
        window_peak = torch.cuda.max_memory_allocated(device)
        memory_peak = max(setup_peak, window_peak)
    completed = attempted - failed
    limit_line = card_power_limit() if on_card else "cpu"
    print(f"card: {limit_line}", file=sys.stderr)
    print(f"window {window_s:.3f} s: {attempted} requests, {failed} failed", file=sys.stderr,
          flush=True)

    # the plain reference, on the sampled requests' pool entries (the
    # traced ones too in a traced run), after the program's state is freed
    readback.bufs = None
    del host
    if on_card:
        torch.cuda.empty_cache()
    ref_mod = manifest.module("references", cfg["reference"])
    wanted = {p for _, p, _ in sample.items.values()}
    if traced:
        wanted |= {i % mix["pool"] for i in range(traced)}
    t_ref = time.perf_counter()
    refs = {p: ref_mod.decode(phy, pool[p], mix["local_addr"], entry.ref_max_frames)
            for p in sorted(wanted)}
    print(f"reference: {len(refs)} pool entries in {time.perf_counter() - t_ref:.3f} s",
          file=sys.stderr, flush=True)
    checks = check.compare(
        [(entry.frames(host), refs[p]["frames"]) for _, p, host in sample.items.values()],
        cfg["limits"])
    checked = sum(len(ref) for _, p, _ in sample.items.values() for ref in refs[p]["frames"])
    correct = failed == 0 and completed > 0 and checked > 0 and check.passed(checks)

    result = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": {},
              "device": {"platform": "gpu" if on_card else "cpu", "kind": card,
                         "count": cell["chips"] if on_card else 0,
                         "memory_peak_bytes": memory_peak, "power": limit_line}}
    if not args.trace:
        audio = traffic.audio_seconds(phy, mix)
        values = {"audio_s_per_s": completed * audio / window_s,
                  "request_ms_p95": stats.request_p95_ms(latencies, failed),
                  "peak_mem_mib": ((window_peak - resident) / 2**20) if on_card else 0.0,
                  "setup_s": setup_s}
        for m in manifest.metrics_of(man, args.workload, "end_to_end"):
            result["metrics"][m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
        print(f"requests: median {stats.percentile([s * 1e3 for s in latencies], 50):.4f} ms "
              f"over {completed}", file=sys.stderr)
    else:
        from harness.trace import Trace, port_kernel_names
        import trackmaker_tpu_torch

        t_tr = time.perf_counter()
        tr = Trace(session.events(), traced)
        works = [entry.work(refs[i % mix["pool"]]["hits"]) for i in range(traced)]
        ctx = ReadContext(tr, works, port_kernel_names(Path(trackmaker_tpu_torch.__file__).parent))
        for m in manifest.metrics_of(man, args.workload, "per_layer"):
            value = manifest.module("metrics", m["name"]).read(ctx)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
        result["device"]["busy_s"] = tr.busy_s()
        result["device"]["window_s"] = tr.window_s
        result["breakdown"] = tr.breakdown()
        print(f"trace: {traced} requests in {tr.window_s:.3f} s, read in "
              f"{time.perf_counter() - t_tr:.3f} s", file=sys.stderr)
        if on_card:
            from trackmaker_tpu_torch.tools.health import health

            print(f"health: {json.dumps(health(device))}", file=sys.stderr)
    result["frames_checked"] = checked
    print(f"frames checked: {checked} in {len(sample.items)} requests", file=sys.stderr)
    result["checks"] = checks
    for name, c in checks.items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    return result


def cache_bytecode() -> None:
    """Write and read the compiled bytecode of every module imported from
    here on (PyTorch's too) under the checkout's ``build/pycache``: an
    environment that turns the writing off (``PYTHONDONTWRITEBYTECODE``)
    would otherwise have every run compile PyTorch's sources anew."""
    sys.pycache_prefix = str(ROOT / "build" / "pycache")
    sys.dont_write_bytecode = False


def main(argv=None) -> int:
    cache_bytecode()
    args = parse(argv)
    result = run(args)
    if result is None:
        return 2
    bad = forbidden_modules(sys.modules)
    if bad:
        print(f"modules that no run may load are loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
