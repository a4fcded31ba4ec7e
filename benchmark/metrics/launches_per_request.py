"""launches_per_request: device kernels, copies and fills the profiler
traced in the window, over the requests traced."""


def read(ctx):
    t = ctx.trace
    return (len(t.kernels) + len(t.copies)) / t.requests
