"""Reduction of a torch.profiler trace of a stretch of blocks: the
device's busy time (the union of its kernels' and copies' intervals), its
operations by total time, and its idle time by the host span open through
it (the harness's record_function spans, `bench.<name>`)."""

from __future__ import annotations

from bisect import bisect_left
from collections import defaultdict

SPAN_PREFIX = "bench."
WINDOW_SPAN = "bench.window"


def _union(intervals: list) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _split(a: float, b: float, spans: list, idle: dict) -> None:
    """Add the idle interval [a, b] to `idle`, each part of it under the
    innermost span open there ("other" where none is)."""
    cuts = sorted({a, b} | {x for s, t, _ in spans for x in (s, t)
                            if a < x < b})
    for u, v in zip(cuts, cuts[1:]):
        inner = [(t - s, n) for s, t, n in spans if s <= u and v <= t]
        idle[min(inner)[1] if inner else "other"] += (v - u) / 1e6


def reduce_events(events: list, blocks: int) -> dict:
    """`events`: (name, is_device, start_us, end_us) of the profiled
    stretch.  Returns busy_s, window_s, the device operations by name
    (name -> [seconds, count]), and the idle time's seconds by the
    innermost host span open through it ("other" where none is)."""
    win = [e for e in events if not e[1] and e[0] == WINDOW_SPAN]
    if len(win) != 1:
        raise ValueError(f"want one {WINDOW_SPAN} span, got {len(win)}")
    w0, w1 = win[0][2], win[0][3]
    # the spans' mirrors on the device's timeline are not device work
    dev = [(max(s, w0), min(t, w1), n) for n, d, s, t in events
           if d and t > w0 and s < w1 and not n.startswith(SPAN_PREFIX)]
    ops = defaultdict(lambda: [0.0, 0])
    for s, t, n in dev:
        ops[n][0] += (t - s) / 1e6
        ops[n][1] += 1
    busy = _union([(s, t) for s, t, _ in dev])
    busy_us = sum(b - a for a, b in busy)
    spans = sorted((s, t, n[len(SPAN_PREFIX):]) for n, d, s, t in events
                   if not d and n.startswith(SPAN_PREFIX)
                   and n != WINDOW_SPAN)
    starts = [s for s, _, _ in spans]
    longest = max((t - s for s, t, _ in spans), default=0.0)
    idle = defaultdict(float)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for a, b in zip(edges[::2], edges[1::2]):
        if b > a:
            near = spans[bisect_left(starts, a - longest):
                         bisect_left(starts, b)]
            _split(a, b, [x for x in near if x[1] > a], idle)
    return {"busy_s": busy_us / 1e6, "window_s": (w1 - w0) / 1e6,
            "blocks": blocks, "ops": dict(ops), "idle": dict(idle)}


def profiler_events(prof) -> list:
    """(name, is_device, start_us, end_us) of every event of a finished
    torch.profiler.profile."""
    from torch.autograd import DeviceType
    return [(e.name, e.device_type == DeviceType.CUDA,
             float(e.time_range.start), float(e.time_range.end))
            for e in prof.events()]


def breakdown(red: dict) -> dict:
    """The result line's `breakdown`: the ten device operations that took
    most time, and the ten largest idle totals by host span."""
    ops = sorted(((n, v[0]) for n, v in red["ops"].items()),
                 key=lambda x: -x[1])[:10]
    idle = sorted(red["idle"].items(), key=lambda x: -x[1])[:10]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in idle]}
