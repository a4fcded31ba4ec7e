"""Oscillators, filters, the channel models, the MMSE equalizer and the
clock-offset recovery."""

from trackmaker_tpu_torch.dsp import channel, equalizer, filters, osc, timing  # noqa: F401
