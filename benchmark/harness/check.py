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
  state_gap     for the serial host states the reference follows from
                the program's state at the block's start (`Chain`: those
                the configuration's `check.follows` names, or else the
                FM-video modes' carriers): the components of their
                (state, n) in which the program and the reference differ
                at a drawn block's end, plus those in which a block's
                start differs from the end of the block before it (block
                0's: from the reference's initial state), over every
                block the run streamed.  Reported only where a cell
                follows a state
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


STAGES = ("dispatch", "collect")


def _ints(name: str, x) -> tuple:
    """`x`, an integer array or a sequence of integers, as a tuple of
    ints; a ValueError naming follow `name` where it is or holds anything
    else, such as a torch.Tensor."""
    if isinstance(x, np.ndarray) and x.dtype.kind in "biu":
        return tuple(x.ravel().tolist())
    if isinstance(x, (list, tuple)):
        bad = [v for v in x if not isinstance(v, (int, np.integer))]
        if not bad:
            return tuple(int(v) for v in x)
        x = bad[0]
    kind = f"{type(x).__module__}.{type(x).__qualname__}"
    raise ValueError(
        f"follow {name!r}: its state is or holds a {kind}, not integers on "
        "the host (the harness reads no device tensor: a program whose "
        "state lives on the card mirrors it on the host)")


def host_state(name: str, fx) -> tuple:
    """Follow `name`'s (state, n), read from the object `fx` that holds
    it (its `_state` and `n`) as a tuple of ints and an int."""
    n, = _ints(name, [fx.n])
    return _ints(name, fx._state), n


def _components(state) -> tuple:
    s, n = state
    return _ints("reference", s) + (int(n),)


def _differ(a, b) -> int:
    """Components of two (state, n) pairs that differ."""
    a, b = _components(a), _components(b)
    if a == b:
        return 0
    return sum(int(x != y) for x, y in zip(a, b)) + abs(len(a) - len(b))


class Chain:
    """The serial host states that the reference takes from the program
    at a drawn block's start.  `follows` names them: {name: (encoder
    attribute, "dispatch" | "collect")}; the object at the attribute holds
    the state as `_state` (integers) and `n`, and the named call of the
    block loop advances it.  The loop reads each before and after that call
    (`read`, `link`).  The chain is checked as the blocks go by: a
    block's start against the end of the block before it, into `gap`.
    Whole states are held only for the blocks the reservoir holds and
    the block in flight (`keep`), and block 0's start (`first`), so the
    memory is bounded by the reservoir, not the window.

    Made before the warm-up: a follow that the encoder lacks, or whose
    state is or holds a torch.Tensor, is refused with a ValueError that
    names it."""

    def __init__(self, follows: dict, enc):
        self.follows = {n: tuple(f) for n, f in follows.items()}
        for name, f in self.follows.items():
            if len(f) != 2 or f[1] not in STAGES:
                raise ValueError(f"follow {name!r}: {list(f)} is not "
                                 f"[encoder attribute, {' | '.join(STAGES)}]")
        self.gap = 0            # components of starts that break the chain
        self.first: dict = {}   # name -> block 0's start
        self.last: dict = {}    # name -> (block, end) of the block read last
        self.recent: dict = {}  # (name, block) -> (start, end), not offered
        self.kept: dict = {}    # (name, block) -> (start, end), drawn
        for name in self.follows:
            host_state(name, self._holder(name, enc))

    def _holder(self, name: str, enc):
        attr = self.follows[name][0]
        fx = getattr(enc, attr, None)
        if fx is None or not (hasattr(fx, "_state") and hasattr(fx, "n")):
            raise ValueError(f"follow {name!r}: the encoder has no {attr} "
                             "with a `_state` and an `n`")
        return fx

    def read(self, enc, stage: str) -> dict:
        """{name: (state, n)} of the follows that call `stage` advances."""
        return {n: host_state(n, self._holder(n, enc))
                for n, (_, st) in self.follows.items() if st == stage}

    def link(self, enc, stage: str, b: int, before: dict) -> None:
        """After call `stage` of block b: `before` was read before it."""
        for name, end in self.read(enc, stage).items():
            self._link(name, b, before[name], end)

    def _link(self, name: str, b: int, start, end) -> None:
        prev = self.last.get(name)
        if b == 0:
            self.first[name] = start
        elif prev is not None and prev[0] == b - 1:
            self.gap += _differ(start, prev[1])
        else:                   # no predecessor: every component counts
            self.gap += len(_components(start))
        self.last[name] = (b, end)
        self.recent.pop((name, b - 2), None)
        self.recent[(name, b)] = (start, end)

    def keep(self, blocks, b: int) -> None:
        """After the reservoir's offer of block b: hold the states of the
        blocks in `blocks` (those it holds) and none other up to b."""
        for key in [k for k in self.recent if k[1] <= b]:
            start_end = self.recent.pop(key)
            if key[1] in blocks:
                self.kept[key] = start_end
        for key in [k for k in self.kept if k[1] not in blocks]:
            del self.kept[key]

    def initial_gap(self, initial: dict) -> int:
        """Components of block 0's starts that differ from `initial`."""
        return sum(_differ(s, initial[n]) for n, s in self.first.items())


def compare(kept: dict, chain: Chain, reference, control=None,
            sink_short: int = 0) -> dict:
    """max_abs_diff and state_gap over the kept blocks.  `reference` is
    the plain reference encoder, whose `encode_block(b, start)` takes
    every follow of `chain` in `start`; `chain` holds the program's
    followed states; `control`, an encoder put in the program's place
    (its samples and end states replace the program's); `sink_short`,
    the bytes the window's sink did not write (bytes_short)."""
    diff = SHAPE_MISMATCH if sink_short else 0
    gap = chain.gap + chain.initial_gap(reference.initial_states())
    for b in sorted(kept):
        start = {n: chain.kept[(n, b)][0] for n in chain.follows}
        want, ref_end = reference.encode_block(b, start)
        got = kept[b]
        got_end = {n: chain.kept[(n, b)][1] for n in chain.follows}
        if control is not None:
            got, got_end = control.encode_block(b, start)
        want, got = as_pairs(want), as_pairs(got)
        if want.shape != got.shape:
            diff = max(diff, SHAPE_MISMATCH)
        else:
            d = np.abs(got.astype(np.int32) - want.astype(np.int32))
            diff = max(diff, int(d.max()))
        for n in chain.follows:
            gap += _differ(got_end[n], ref_end[n])
    out = {"max_abs_diff": diff}
    if chain.follows:
        out["state_gap"] = gap
    return out
