"""attempt_roofline: the attempt kernel's least time (the line code's
attempt, from the request's shapes and its live candidates) over its
device time, in percent.  Nothing to read where the kernel did not run."""


def read(ctx):
    return ctx.roofline_share("attempt")
