"""Robustness sweeps (counterpart of ``trackmaker_tpu/bench``): frame loss
against noise and against sample-clock mismatch."""

from trackmaker_tpu_torch.bench.ber import ber_sweep, clock_offset_sweep

__all__ = ["ber_sweep", "clock_offset_sweep"]
