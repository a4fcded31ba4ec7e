"""syncs_per_request: host calls that wait for the device (stream, device
and event synchronizations and blocking copies, the profiler's CUDA
runtime events) in the traced window, over the requests traced.  Each
request's readback adds one."""


def read(ctx):
    return ctx.trace.syncs() / ctx.trace.requests
