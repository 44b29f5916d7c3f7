"""The timed path: the block loop of the CLI (`hacktv_tpu_torch.cli`),
made of the port's public calls in the CLI's order.  Block b + 1 is
queued on the device before block b is copied back and written, so the
copy and the sink overlap the device's work:

    encode_block_device(b + 1); collect_block(b); sink.write(...)

Each call goes through a host-clock span (`Spans`); under the profiler
the spans are also record_function ranges, `bench.<name>`."""

from __future__ import annotations

import time
import warnings
from collections import defaultdict

import numpy as np


class Spans:
    """Host-clock totals of named calls, and their count."""

    def __init__(self):
        self.total = defaultdict(float)
        self.profiling = False

    def reset(self) -> None:
        self.total.clear()

    def wrap(self, name: str, fn):
        def timed(*a, **k):
            if self.profiling:
                from torch.profiler import record_function
                with record_function("bench." + name):
                    return self._timed(name, fn, a, k)
            return self._timed(name, fn, a, k)
        return timed

    def _timed(self, name, fn, a, k):
        t = time.perf_counter()
        try:
            return fn(*a, **k)
        finally:
            self.total[name] += time.perf_counter() - t


class BlockLoop:
    """One encoder streaming into one sink.  `chain` (check.Chain) reads
    the serial host states the check follows, before and after the call
    that advances each, by block."""

    def __init__(self, enc, sink, spans: Spans, chain):
        self.enc, self.sink, self.spans = enc, sink, spans
        self.encode = spans.wrap("enqueue", enc.encode_block_device)
        self.collect = spans.wrap("collect", enc.collect_block)
        self.write = spans.wrap("sink_write", sink.write)
        self.chain = chain
        self.next_block = 0
        self.pending = None
        self.pairs = 0                  # sample pairs handed to the sink
        self.sync_warnings = None       # a list while syncs are counted

    def _dispatch(self, b: int):
        if self.sync_warnings is None:
            return self.encode(b)
        import torch
        with warnings.catch_warnings(record=True) as ws:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                return self.encode(b)
            finally:
                torch.cuda.set_sync_debug_mode("default")
                self.sync_warnings.extend(
                    w for w in ws if "synchroniz" in str(w.message))

    def step(self):
        """Queue the next block, then copy back and write the one before
        it.  Returns (block written, its samples, the host clock when the
        write returned), or None on the first step."""
        b, enc, chain = self.next_block, self.enc, self.chain
        before = chain.read(enc, "dispatch")
        dev = self._dispatch(b)
        chain.link(enc, "dispatch", b, before)
        self.next_block += 1
        done, self.pending = self.pending, (b, dev)
        if done is None:
            return None
        b0, dev0 = done
        before = chain.read(enc, "collect")
        out = self.collect(b0, dev0)
        chain.link(enc, "collect", b0, before)
        if out.ndim == 1:
            out = np.stack([out, np.zeros_like(out)], axis=-1)
        self.write(out)
        self.pairs += len(out)
        return b0, out, time.perf_counter()

    def drop_pending(self) -> None:
        self.pending = None
