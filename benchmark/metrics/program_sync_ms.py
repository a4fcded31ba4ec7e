"""program_sync_ms: host milliseconds a request blocked in calls that
wait for the device (``trace.SYNC_CALLS``) inside the decode call's span
(``tm.entry.decode``): the program's own waits for the card, the
harness's readback left out.  Nothing to read without the span."""

from harness import spans
from harness.stats import union_seconds


def read(ctx):
    t = ctx.trace
    entry = spans.spans(t, spans.ENTRY)
    if not entry:
        return None
    return union_seconds(spans.intersect(spans.syncs(t), entry)) * 1e3 / t.requests
