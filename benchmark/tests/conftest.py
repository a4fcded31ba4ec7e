"""The benchmark's own tests: on the CPU at tiny sizes; tests marked
``gpu`` skip without a CUDA card (decided in a fixture, never at import)."""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
for p in (str(BENCH), str(BENCH.parent)):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture(autouse=True)
def _skip_gpu_without_card(request):
    if request.node.get_closest_marker("gpu"):
        import torch

        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card")


@pytest.fixture
def tiny(monkeypatch):
    """Shrink every traffic mix to a size the CPU decodes in a second or
    two: a few short recordings, a short pool, a short traced stretch."""
    from harness import manifest

    orig = manifest.traffic

    def small(name):
        m = orig(name)
        if m["entry"] == "decode_capture_fast":
            m.update(rows=3, frames_per_row=6, pool=2, warmup=1, check_requests=3,
                     trace_seconds=0.3)
        else:
            m.update(seconds=2, frames_per_row=6, n_blocks=8, max_frames_per_block=4, pool=2,
                     warmup=1, check_requests=3, trace_seconds=0.3)
        return m

    monkeypatch.setattr(manifest, "traffic", small)
    return small
