"""The port's tracer: named spans on the host's clock, and counters.

    with telemetry.span("dispatch", block_no):
        ...
    telemetry.count("uploads")

Spans record only while the tracer is on (`enable(True)`; the command
line's `--profile` turns it on).  Off, the default, `span` returns one
shared no-op context after a flag test, and records nothing.  On, a span
records (name, block, parent's name, start ns, end ns) on
`time.perf_counter_ns()`; a span opened without a block takes its
parent's, so the spans of one block share its number.  The tracer keeps
each name's total and count, and the newest `RAW_SPANS` raw spans.  While
a torch.profiler is recording, an open span is also a `record_function`
range named "hacktv.<name>", so it lands on the profiler's timeline beside
the device's work.

Counters always count, on or off: plain integer adds that nothing
clears, so a reader takes the difference of two readings.  `take()`
returns what was recorded and clears the spans.

The tracer is one per process and not thread-safe: spans are opened on
the thread that encodes (the command line's loop, the benchmark's).
Importing this module imports nothing heavy.
"""

from __future__ import annotations

import contextlib
import functools
import sys
import time
from collections import deque

RAW_SPANS = 1 << 16          # raw spans kept for export, the newest
PREFIX = "hacktv."           # the spans' names on the profiler's timeline

_on = False
_off = contextlib.nullcontext()
_stack: list = []            # the open spans, innermost last
_totals: dict = {}           # name -> [ns, count]
_raw: deque = deque(maxlen=RAW_SPANS)
_counters: dict = {}


class _Span:
    __slots__ = ("name", "block", "parent", "t0", "rf")

    def __init__(self, name: str, block):
        self.name, self.block = name, block

    def __enter__(self):
        parent = _stack[-1] if _stack else None
        self.parent = None
        if parent is not None:
            self.parent = parent.name
            if self.block is None:
                self.block = parent.block
        _stack.append(self)
        self.rf = None
        torch = sys.modules.get("torch")
        if torch is not None and torch.autograd._profiler_enabled():
            self.rf = torch.profiler.record_function(PREFIX + self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        _stack.pop()
        tot = _totals.get(self.name)
        if tot is None:
            _totals[self.name] = [t1 - self.t0, 1]
        else:
            tot[0] += t1 - self.t0
            tot[1] += 1
        _raw.append((self.name, self.block, self.parent, self.t0, t1))
        return False


def enable(on: bool = True) -> None:
    """Turn span recording on or off (counters always count)."""
    global _on
    _on = bool(on)


def enabled() -> bool:
    return _on


def span(name: str, block=None):
    """A context that records one span named `name` while the tracer is
    on; `block` is the block it serves (default: its parent's)."""
    if not _on:
        return _off
    return _Span(name, block)


def spanned(name: str):
    """A decorator: each call of the function is a span `name`."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*a, **kw):
            with span(name):
                return fn(*a, **kw)
        return call
    return wrap


def count(name: str, n: int = 1) -> None:
    """Add `n` to the counter `name`."""
    _counters[name] = _counters.get(name, 0) + n


def counters() -> dict:
    """The counters now (they only grow)."""
    return dict(_counters)


def totals() -> dict:
    """Seconds spent in each span name so far, without clearing."""
    return {k: v[0] / 1e9 for k, v in _totals.items()}


def take() -> dict:
    """The spans recorded since the last take or reset, then clear them:
    `totals` (seconds by span name), `counts` (spans by name), `spans`,
    the newest raw spans as (name, block, parent, start ns, end ns); and
    `counters`, which stay as they are."""
    out = {"totals": totals(),
           "counts": {k: v[1] for k, v in _totals.items()},
           "counters": dict(_counters), "spans": list(_raw)}
    reset()
    return out


def reset() -> None:
    """Clear the spans recorded so far (spans still open record when
    they close); the counters stay."""
    _totals.clear()
    _raw.clear()
