"""The window health probe (counterpart of ``bench.py:_probe_window``).

``health(device)`` returns a snapshot of the device that separates the
code's state from the card's:

* ``rtt_ms``: the median of 5 round trips of a one-element add read back
  with ``.item()``, the host's dispatch and synchronise floor;
* ``noop_kernel_us``: the time of one launch of the probe kernel
  ``csrc/seq_probe.cu`` (32 blocks, each a 128-step store loop), 400
  launches back to back between two CUDA events, the median of 3 repeats:
  the card's launch and loop floor, against which the port's tiny kernels
  are read;
* ``stream_gbps``: the rate of ``x * 1.0000001 + 1e-12`` over 2^24 f32,
  200 calls between two events, the median of 3 repeats.  It counts the
  bytes the two eager passes really move, 16 a element (each pass reads
  and writes 4); JAX's one fused pass counted 8.

and ``device``, the name of what it ran on.  On the card a probe that
fails raises (the JAX probe writes None).  Given ``torch.device("cpu")``
every probe runs on the host, the kernel through its plain version, and
the numbers are the host's.

    python -m trackmaker_tpu_torch.tools.health

prints the card's name and power limit and the snapshot as one JSON object.
"""

from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import time

import torch

from trackmaker_tpu_torch import _build

PROBE_BLOCKS = 32
PROBE_STEPS = 128
PROBE_SHAPE = (8, 128)
RTT_TRIPS = 5
LAUNCHES = 400
REPEATS = 3
STREAM_ELEMS = 1 << 24
STREAM_CALLS = 200
STREAM_CALLS_HOST = 2     # the host pass over 64 MB takes tens of ms
STREAM_BYTES_PER_ELEM = 16


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _check_probe(x: torch.Tensor) -> None:
    if tuple(x.shape) != PROBE_SHAPE or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous f32{list(PROBE_SHAPE)}, got "
                         f"{x.dtype}{list(x.shape)}")


def seq_probe_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`seq_probe`."""
    _check_probe(x)
    return (x + float(PROBE_STEPS - 1)).repeat(PROBE_BLOCKS, 1)


def seq_probe(x: torch.Tensor) -> torch.Tensor:
    """The probe kernel on x f32[8, 128]: out f32[256, 128], every (8, 128)
    block of it x + 127, stored 128 times (x + 0, x + 1, ..., x + 127)."""
    if not _build.on_cuda(x):
        return seq_probe_plain(x)
    _check_probe(x)
    out = torch.empty((PROBE_BLOCKS * PROBE_SHAPE[0], PROBE_SHAPE[1]), dtype=torch.float32,
                      device=x.device)
    fn = _build.entry("seq_probe", "tm_seq_probe", [ctypes.c_void_p] * 3)
    _build.check(fn(x.data_ptr(), out.data_ptr(), _build.stream_ptr(x)), "seq_probe")
    seq_probe.launches += 1
    return out


seq_probe.launches = 0


def time_calls(fn, device: torch.device, calls: int, repeats: int = REPEATS) -> list[float]:
    """Seconds per call of `fn` in each of `repeats` runs of `calls` calls
    back to back, after one warm-up call: on the card between two CUDA
    events (one host sync a repeat), on the host by its clock."""
    fn()
    if device.type != "cuda":
        out = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            out.append((time.perf_counter() - t0) / calls)
        return out
    torch.cuda.synchronize(device)
    out = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / 1e3 / calls)
    return out


def health(device: torch.device | str = "cuda") -> dict:
    """The probe's snapshot of `device` (see the module docstring)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("health on a CUDA device needs a card")
    on_card = dev.type == "cuda"

    v = torch.zeros((), device=dev)
    (v + 1.0).item()
    rtts = []
    for _ in range(RTT_TRIPS):
        t0 = time.perf_counter()
        (v + 1.0).item()
        rtts.append(time.perf_counter() - t0)

    xk = torch.ones(PROBE_SHAPE, dtype=torch.float32, device=dev)
    noop = time_calls(lambda: seq_probe(xk), dev, LAUNCHES)

    xs = torch.ones(STREAM_ELEMS, dtype=torch.float32, device=dev)
    stream = time_calls(lambda: xs * 1.0000001 + 1e-12, dev,
                        STREAM_CALLS if on_card else STREAM_CALLS_HOST)
    return {
        "rtt_ms": statistics.median(rtts) * 1e3,
        "noop_kernel_us": statistics.median(noop) * 1e6,
        "stream_gbps": STREAM_BYTES_PER_ELEM * STREAM_ELEMS / statistics.median(stream) / 1e9,
        "device": torch.cuda.get_device_name(dev) if on_card else "cpu",
    }


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("the health probe needs a CUDA card; torch.cuda.is_available() is False")
    print(card_line(), flush=True)
    print(json.dumps(health("cuda")), flush=True)


if __name__ == "__main__":
    main()
