"""wrapper_host_ms: host milliseconds a request inside the kernel
wrappers' spans (``tm.kernel.*``: argument checks, the library's entry,
the launch), less the calls that wait for the device within them.
Nothing to read without the spans."""

from harness import spans


def read(ctx):
    t = ctx.trace
    return spans.host_ms_per_request(t, spans.KERNEL, spans.syncs(t))
