"""Named spans of the port's work, on the profiler's clock.

``span(name)`` marks a stretch of the host's work as a record-function
event while a ``torch.profiler`` (or autograd profiler) session is
recording, and is a shared no-op context otherwise: no switch, no
environment variable.  The events land in the session's trace beside the
CUDA runtime calls, kernels and copies, on one clock, so a device idle gap
falls inside the span that held the host then.  ``spanned(name)`` makes
each call of a function such a span; unlike a ``with`` block inside the
function, it also covers the release of the function's locals at its
return, which between two phases can hold the host for tens of us.

Spans are named ``tm.<layer>.<phase>``:

* ``tm.entry.*``: ``phy/decoder.py:decode_capture_fast`` (``decode``, and
  the read of the rows not ``ok``: ``ok_sync``) and ``tm.exact.row``, one a
  row the exact scan decodes in ``decode_captures``;
* ``tm.glue.*``: ``phy/spec_decode.py``'s PyTorch operators between the
  kernels: ``spec``, the whole ``decode_capture_spec``, and in it
  ``upload``, ``compact_hits``, ``epilogue``, ``compact`` and ``ok``;
* ``tm.kernel.<wrapper>``: a kernel wrapper's whole call (argument checks,
  the library's entry, the launch; on a CPU tensor its plain version).

A span costs one check of the profiler's state when no session records
(about 0.1 us on a CPU); a recorded one, a record-function event.
"""

from __future__ import annotations

import contextlib
import functools

import torch

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context that records `name` as a span while a profiler session
    records, else one shared no-op context."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF


def spanned(name: str):
    """Decorate a function so that each call of it, the release of its
    locals at its return included, is the span `name` while a profiler
    session records; otherwise the call costs one check more."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if torch._C._autograd._profiler_enabled():
                with torch.profiler.record_function(name):
                    return fn(*args, **kwargs)
            return fn(*args, **kwargs)
        return call
    return wrap
