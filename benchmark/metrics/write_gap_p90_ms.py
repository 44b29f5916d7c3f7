"""The gap a transmitter's FIFO has to cover: the 90th percentile, over
every block of the window, of the time from one sink write's return to
the next, by the host clock, in ms.  Per layer and not end to end: it
follows the host's speed too closely for a bound (PERF.md §2)."""

from harness.stats import percentile


def read(ctx):
    gaps = ctx.get("gaps_ms")
    if not gaps:
        return None
    return percentile(gaps, 90)
