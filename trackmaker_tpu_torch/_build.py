"""Builds the port's CUDA kernels at first use and loads them with ctypes.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for Hopper (``sm_90a``) into
a shared library with a plain C interface under ``build/trackmaker_tpu_torch/``
at the repository root.  The library's file name carries a hash of its
source, the shared headers and the flags, so an edited source rebuilds and
an unchanged one loads the library already built.  Nothing here runs at
import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "trackmaker_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
KERNELS = ("xcorr_hits", "attempt_manchester", "attempt_4b5b", "spec_walk",
           "sliding_dot", "ask_fire", "ask_chain", "ask_walk", "xcorr_norm",
           "seq_probe", "xcorr_streams", "offset_add", "attempt_tiles")

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _digest(src: Path) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [src, *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    return BUILD_DIR / f"{name}-{_digest(src)}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: a concurrent build of the
    # same source never sees a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp,
           str(CSRC / f"{name}.cu")]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed for {name}.cu:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if need be."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        _loaded[name] = lib
    return lib


def build_all() -> list[Path]:
    """Build every kernel, one nvcc process per source, all at once."""
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        return list(pool.map(build, KERNELS))


def entry(name: str, symbol: str, argtypes: list) -> ctypes._CFuncPtr:
    """C entry point `symbol` of kernel `name`, returning a cudaError_t."""
    fn = getattr(load(name), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def on_cuda(*tensors: torch.Tensor) -> bool:
    """The dispatch rule of every kernel wrapper: True when all tensors lie
    on one CUDA device (launch the kernel), False when all lie on the CPU
    (run the plain version); anything else raises."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devices))}")
    device = devices.pop()
    if device.type == "cuda":
        return True
    if device.type == "cpu":
        return False
    raise ValueError(f"no kernel for device {device}")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")
