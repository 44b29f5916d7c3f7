"""The block step replayed as a CUDA graph.

An unsharded encoder's step on a card (`Encoder._step`: the block stage
and the whole-block row stage) is some 1,300 launches of small kernels,
and their host time, not the card, sets the pace of a block.  `StepGraphs`
captures the step once as a `torch.cuda.CUDAGraph` and then launches it
as one replay, wherever what the step reads from the host repeats:

- `signature(args)` keys a step's arguments by everything a graph would
  freeze: every non-tensor leaf by value (Python numbers by type and
  value, numpy arrays by content) and every tensor leaf by shape,
  strides, dtype and device.  A tensor's content is not keyed: it is an
  input of the graph.
- A signature seen for the first time runs eagerly, as without a graph,
  which also builds whatever the step builds at first use (index grids,
  the resampler's bank on the device).  The second time the step is
  captured, then replayed; after that it is replayed.  A signature that
  never repeats stays eager and costs only its key.
- Before each replay every tensor argument is copied into the graph's
  static input; after it the outputs are cloned out of the graph's
  memory, so a block's samples and carries outlive the next replay.
- At most `MAX_GRAPHS` graphs are kept (the least recently replayed is
  dropped).  They share one memory pool: their replays run one after
  another on one stream, and nothing reads the pool between them.

Counters (telemetry.py): "step.graph_replays", "step.graph_captures",
and "step.eager" (steps run eagerly, captures included).  A replay adds
the work counts its capture counted (`WORK_COUNTERS`: the stream FIR's
launches, the SECAM windows and its kernel's), so they stay per block;
host-time counts (SECAM's "secam.step_ns") grow only where the step's
host code ran.  A
step that cannot be captured (a wait for the card or an upload inside
it) or keyed (a leaf of another type, a tensor on another device) runs
eagerly from then on for that encoder, counted in
"step.graph_failures", with one warning.
"""

from __future__ import annotations

import sys
from collections import OrderedDict

import numpy as np
import torch

from . import telemetry

MAX_GRAPHS = 8       # graphs an encoder keeps
MAX_SEEN = 64        # signatures remembered as run once
# counts of the step's work, added again at each replay
WORK_COUNTERS = ("fir_cplx.launches", "fir_real.launches", "secam.windows",
                 "secam.kernel_windows")

_SCALARS = (bool, int, float, str, bytes, type(None))


class Unkeyable(TypeError):
    """A step argument that `signature` cannot key; `path` names it."""

    def __init__(self, what: str):
        super().__init__(what)
        self.what, self.path = what, []

    def __str__(self):
        return "args" + "".join(f"[{p!r}]" for p in self.path) + ": " \
            + self.what


def signature(args, device=None) -> tuple:
    """(key, tensors): a hashable key of `args` (nested dicts, tuples and
    lists) by every non-tensor leaf's value and every tensor leaf's
    shape, strides, dtype and device, and the tensor leaves in walk
    order.  Raises Unkeyable, naming the leaf, for a leaf of another type
    or (with `device`) a tensor on another device."""
    tensors: list = []
    return _key(args, tensors, device), tensors


def _key(x, tensors: list, device):
    if isinstance(x, torch.Tensor):
        if device is not None and x.device != device:
            raise Unkeyable(f"a tensor on {x.device}, not {device}")
        tensors.append(x)
        return ("T", x.shape, x.stride(), x.dtype, x.device)
    if isinstance(x, dict):
        out = ["D"]
        for k, v in x.items():
            try:
                out += (k, _key(v, tensors, device))
            except Unkeyable as e:
                e.path.insert(0, k)
                raise
        return tuple(out)
    if isinstance(x, (tuple, list)):
        out = ["L"]
        for i, v in enumerate(x):
            try:
                out.append(_key(v, tensors, device))
            except Unkeyable as e:
                e.path.insert(0, i)
                raise
        return tuple(out)
    if isinstance(x, np.ndarray):
        return ("A", x.shape, x.dtype.str, x.tobytes())
    if isinstance(x, np.generic):
        return ("G", x.dtype.str, x.tobytes())
    if isinstance(x, float):
        # by bits: -0.0 and 0.0 differ, and a NaN equals itself
        return ("F", x.hex())
    if isinstance(x, _SCALARS):
        return (type(x).__name__, x)
    raise Unkeyable(f"a {type(x).__name__}")


def _map(x, f):
    """`x` with each tensor leaf t replaced by f(t)."""
    if isinstance(x, torch.Tensor):
        return f(x)
    if isinstance(x, dict):
        return {k: _map(v, f) for k, v in x.items()}
    if isinstance(x, tuple):
        return tuple(_map(v, f) for v in x)
    if isinstance(x, list):
        return [_map(v, f) for v in x]
    return x


class _Graph:
    """One captured step: its static inputs, its outputs in the pool, and
    the work counts its capture counted."""

    def __init__(self, fn, args, tensors: list, steps: "StepGraphs"):
        # the static inputs hold this block's arguments
        self.static = [t.clone() for t in tensors]
        c0 = telemetry.counters()
        it = iter(self.static)
        self.out = self._capture(fn, _map(args, lambda t: next(it)), steps)
        c1 = telemetry.counters()
        self.work = {k: c1.get(k, 0) - c0.get(k, 0) for k in WORK_COUNTERS
                     if c1.get(k, 0) != c0.get(k, 0)}

    def _capture(self, fn, args, steps: "StepGraphs"):
        """Capture fn(*args) on the graphs' side stream, into their pool;
        returns its outputs (in the pool, written by each replay)."""
        if steps.pool is None:
            steps.pool = torch.cuda.graph_pool_handle()
            steps.stream = torch.cuda.Stream(steps.device)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(steps.device), \
                torch.cuda.stream(steps.stream):
            self.graph.capture_begin(pool=steps.pool)
            try:
                return fn(*args)
            finally:
                self.graph.capture_end()

    def _replay(self) -> None:
        self.graph.replay()

    def run(self, tensors: list | None):
        """Copy `tensors` into the static inputs (None: they hold them
        already), replay, and return the outputs cloned."""
        if tensors is not None:
            for s, t in zip(self.static, tensors, strict=True):
                s.copy_(t)
        self._replay()
        return _map(self.out, torch.Tensor.clone)


class StepGraphs:
    """A block step on the card `device` run through captured graphs
    keyed by `signature` (module docstring).  `limit` is the most graphs
    kept; 0 runs every step eagerly."""

    def __init__(self, device, limit: int = MAX_GRAPHS):
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device, self.limit = dev, limit
        self.pool = self.stream = None      # made at the first capture
        self._seen: OrderedDict = OrderedDict()
        self._graphs: OrderedDict = OrderedDict()

    def __call__(self, fn, *args):
        """fn(*args): replayed, captured or run eagerly."""
        key = None
        if self.limit > 0:
            try:
                key, tensors = signature(args, self.device)
            except Unkeyable as e:
                self._fail(e)
            else:
                key = (torch.backends.cuda.matmul.allow_tf32, key)
        g = self._graphs.get(key) if key is not None else None
        if g is not None:
            self._graphs.move_to_end(key)
            telemetry.count("step.graph_replays")
            for k, n in g.work.items():
                telemetry.count(k, n)
            return g.run(tensors)
        telemetry.count("step.eager")
        if key is None:
            return fn(*args)
        if self._seen.pop(key, None) is None:
            self._seen[key] = True
            while len(self._seen) > MAX_SEEN:
                self._seen.popitem(last=False)
            return fn(*args)
        try:
            g = _Graph(fn, args, tensors, self)
        except RuntimeError as e:
            self._fail(e)
            return fn(*args)
        telemetry.count("step.graph_captures")
        self._graphs[key] = g
        while len(self._graphs) > self.limit:
            self._graphs.popitem(last=False)
        return g.run(None)

    def _fail(self, err: Exception) -> None:
        """Run every later step eagerly, and say why once."""
        telemetry.count("step.graph_failures")
        self.limit = 0
        self._seen.clear()
        self._graphs.clear()
        print("hacktv_tpu_torch: the block step runs without a CUDA "
              f"graph: {err}", file=sys.stderr)
