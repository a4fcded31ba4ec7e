"""Robustness sweeps and dashboards (counterpart of ``trackmaker_tpu/bench``):
frame loss against noise and against sample-clock mismatch, the contended
MAC/PHY parameter sweep (``bench.sweep``), and the signal dashboards
(``bench.viz`` to PNG with matplotlib, ``bench.viz_html`` to one
self-contained HTML file)."""

from trackmaker_tpu_torch.bench.ber import ber_sweep, clock_offset_sweep
from trackmaker_tpu_torch.bench.sweep import mac_parameter_sweep

__all__ = ["ber_sweep", "clock_offset_sweep", "mac_parameter_sweep"]
