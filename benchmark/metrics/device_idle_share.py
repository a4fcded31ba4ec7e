"""device_idle_share: the share of the traced window in which no kernel and
no copy ran on the device, in percent."""


def read(ctx):
    t = ctx.trace
    return 100.0 * (1.0 - t.busy_s() / t.window_s)
