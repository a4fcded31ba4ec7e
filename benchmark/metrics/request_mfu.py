"""request_mfu: the whole request's least time (the recordings read once,
the answer written once, the correlation's, attempts' and walk's
operations, at the chip's peaks) summed over the traced requests, over the
traced window's length, in percent: the share of the chip's peak the
requests reach end to end."""

from harness.roofline import least_seconds


def read(ctx):
    least = sum(least_seconds(w["request"][1], w["request"][2])[0] for w in ctx.works)
    return 100.0 * least / ctx.trace.window_s
