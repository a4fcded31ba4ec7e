"""fallback_rows_per_request: rows the exact scan decoded again
(``tm.exact.row`` spans) over the traced requests; about 43 ms a row on
the card.  Nothing to read without the decode call's span
(``tm.entry.decode``)."""

from harness import spans


def read(ctx):
    t = ctx.trace
    if not spans.spans(t, spans.ENTRY):
        return None
    return len(spans.spans(t, spans.EXACT_ROW)) / t.requests
