"""xcorr_roofline: the correlation and hit-row kernel's least time (its
operations and bytes at the chip's peaks, from the request's shapes) over
its device time, in percent.  Nothing to read where the kernel did not run."""


def read(ctx):
    return ctx.roofline_share("xcorr")
