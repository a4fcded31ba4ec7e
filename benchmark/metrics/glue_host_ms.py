"""glue_host_ms: host milliseconds a request inside the decode glue's
spans (``tm.glue.*``: the speculative decode, ``tm.glue.spec``, and its
phases), less the time inside nested kernel-wrapper spans
(``tm.kernel.*``) and inside calls that wait for the device: the host's
own cost of the glue's operators, as the profiler, which records every
operator, stretches it: a traced host time, not an untraced cost.
Nothing to read without the spans."""

from harness import spans


def read(ctx):
    t = ctx.trace
    return spans.host_ms_per_request(t, spans.GLUE, spans.spans(t, spans.KERNEL) + spans.syncs(t))
