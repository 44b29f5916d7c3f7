"""The check that decides `correct`: the samples the timed path handed to
the sink, for blocks of the window drawn from the seed, as the sink
writes them, against the plain reference (reference/codec), computed once
the window has closed.

Numbers compared, each against the limit its configuration's file
states:
  max_abs_diff  the largest |program - reference| over every sample of
                the drawn blocks, in int16 steps; 65536 where a block's
                length differs, or where the window's sink wrote fewer
                bytes than it was handed (a sample never written differs
                from every value).  The program's blocks are copied when
                drawn, then written through a fresh sink of the program
                into a file and read back (`through_sink`); what the
                window's sink wrote is counted by /proc/self/io's wchar
                (`bytes_short`)
  state_gap     for the serial host recurrences the reference follows
                from the program's state at the block's start (the
                FM-video modes' carriers): the components of their
                (phase I, phase Q, counter, sample) in which the program
                and the reference differ at a drawn block's end, plus
                those in which a block's start differs from the end of
                the block before it (block 0's: from the reference's
                initial state), over every block the run streamed
"""

from __future__ import annotations

import os
import tempfile

import numpy as np

SHAPE_MISMATCH = 65536


class Reservoir:
    """A uniform sample of k of the window's blocks, drawn from the seed
    as the blocks go by.  Each kept block is a copy, since the program may
    hand out a buffer it writes again."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = np.random.default_rng([int(seed) & (2**63 - 1), 2])
        self.seen = 0
        self.kept: dict = {}

    def offer(self, block: int, samples: np.ndarray) -> None:
        self.seen += 1
        if len(self.kept) < self.k:
            self.kept[block] = np.array(samples)
            return
        j = int(self.rng.integers(0, self.seen))
        if j < self.k:
            del self.kept[sorted(self.kept)[j]]
            self.kept[block] = np.array(samples)


def as_pairs(x: np.ndarray) -> np.ndarray:
    """Samples as the sink takes them: (I, Q), real output as (I, 0)."""
    if x.ndim == 1:
        return np.stack([x, np.zeros_like(x)], axis=-1)
    return x


def bytes_written() -> int | None:
    """The bytes this process has passed to write calls (every thread's),
    or None where the system does not say."""
    try:
        with open("/proc/self/io") as f:
            for line in f:
                key, _, value = line.partition(":")
                if key == "wchar":
                    return int(value)
    except OSError:
        pass
    return None


def bytes_short(handed: int, before: int | None,
                after: int | None) -> int:
    """Of `handed` bytes, those that the writes between the readings
    `before` and `after` of bytes_written cannot hold (all of them where
    either reading is missing)."""
    if before is None or after is None:
        return handed
    return max(0, handed - (after - before))


def through_sink(kept: dict, sink_cls, complex_out: bool) -> dict:
    """The kept blocks as `sink_cls` (the program's sink) writes them: in
    order through one fresh sink into a file under the temporary
    directory, read back and cut at the blocks' lengths (a short file
    leaves the last blocks short)."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "sink.s16")
        sink = sink_cls(path, "int16", complex_out)
        for b in sorted(kept):
            sink.write(as_pairs(kept[b]))
        sink.close()
        raw = np.fromfile(path, np.int16)
    out, i = {}, 0
    per = 2 if complex_out else 1
    for b in sorted(kept):
        n = len(kept[b]) * per
        blk = raw[i:i + n]
        i += n
        out[b] = blk.reshape(-1, 2) if complex_out else blk
    return out


def _components(state) -> tuple:
    s, n = state
    return tuple(int(v) for v in s) + (int(n),)


def _differ(a, b) -> int:
    """Components of two (state, sample) pairs that differ."""
    a, b = _components(a), _components(b)
    return sum(int(x != y) for x, y in zip(a, b)) + abs(len(a) - len(b))


def continuity_gap(states: dict, initial: dict) -> int:
    """Components in which a block's start state differs from the end
    state of the block before it (block 0's from `initial`), for every
    recurrence and every block in `states` ((name, block) -> (start,
    end)); a block whose predecessor is missing counts every component."""
    gap = 0
    for (n, b), (start, _) in states.items():
        if b == 0:
            gap += _differ(start, initial[n])
        elif (n, b - 1) in states:
            gap += _differ(start, states[(n, b - 1)][1])
        else:
            gap += len(_components(start))
    return gap


def compare(kept: dict, states: dict, reference, probes: dict,
            control=None, sink_short: int = 0) -> dict:
    """max_abs_diff and state_gap over the kept blocks.  `reference` is
    the plain reference encoder; `states` the program's recurrence states
    by (name, block); `control`, an encoder put in the program's place
    (its samples and end states replace the program's); `sink_short`,
    the bytes the window's sink did not write (bytes_short)."""
    diff = SHAPE_MISMATCH if sink_short else 0
    gap = continuity_gap(states, reference.initial_states())
    for b in sorted(kept):
        start = {n: states[(n, b)][0] for n in probes}
        want, ref_end = reference.encode_block(b, start)
        got = kept[b]
        got_end = {n: states[(n, b)][1] for n in probes}
        if control is not None:
            got, got_end = control.encode_block(b, start)
        want, got = as_pairs(want), as_pairs(got)
        if want.shape != got.shape:
            diff = max(diff, SHAPE_MISMATCH)
        else:
            d = np.abs(got.astype(np.int32) - want.astype(np.int32))
            diff = max(diff, int(d.max()))
        for n in probes:
            gap += _differ(got_end[n], ref_end[n])
    out = {"max_abs_diff": diff}
    if probes:
        out["state_gap"] = gap
    return out
