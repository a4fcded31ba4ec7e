"""Oscillators, filters, the echo channel and the MMSE equalizer."""

from trackmaker_tpu_torch.dsp import channel, equalizer, filters, osc  # noqa: F401
