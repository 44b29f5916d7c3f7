"""Line-axis sharding of a block over a list of devices, from one process.

The JAX package partitions the output timeline of a block (its
`nlines = frames_per_block * lines` lines) over a 1-D device mesh and
lets GSPMD shard the [nlines, W] row chain while the inputs and the
small [nlines]-vector math stay replicated (hacktv_tpu/encoder.py:303-340).
The port does the same by hand:

  - the host state is built once, and each distinct device holds one
    replica of the encoder's device statics (`replicate`);
  - the block stage, the replicated [nlines]-vector and bit-pipeline
    math, runs once per distinct device;
  - the row stage runs once per shard on the shard's lines plus the halo
    rows its stages read (`ShardPlan.windows`), on the shard's device;
  - the few values that cross a shard edge serially (the SECAM IIR's z,
    the FM-video phase sum) are handed from shard to shard as device
    scalars, and the block's carries come from the last shard.

A device may repeat: N shards on one card, or `["cpu"] * N` in the tests,
run the same program one shard after the other.  Nothing waits for a card
between the shards.
"""

from __future__ import annotations

import copy
import dataclasses
from dataclasses import dataclass

import numpy as np
import torch


def resolve_devices(devices) -> list[torch.device]:
    """`devices` (strings or torch.devices, repeats allowed) as
    torch.devices; a CUDA device must be present, and nothing falls back
    to the CPU."""
    out = [torch.device(d) for d in devices]
    if not out:
        raise ValueError("devices: an empty device list")
    for d in out:
        if d.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "no CUDA device is available; pass devices=['cpu', "
                    "...] to run the shards on the CPU")
            if (d.index or 0) >= torch.cuda.device_count():
                raise RuntimeError(
                    f"{d}: only {torch.cuda.device_count()} CUDA devices "
                    "are present")
    return out


def device_key(dev: torch.device) -> str:
    """The key of a distinct device: `cuda` is `cuda:0`."""
    if dev.type == "cuda" and dev.index is None:
        return "cuda:0"
    return str(dev)


@dataclass(frozen=True)
class Window:
    """Shard d of a block: output lines [a, b), and the rows [r0, r1) of
    the block's synthesised rows (row 0 = the halo line before the block)
    that its row stage computes.  `last` marks the shard at the block's
    end, whose rows end where the block's do."""
    index: int
    device: torch.device
    a: int
    b: int
    r1: int
    last: bool

    @property
    def r0(self) -> int:
        """Row a: a shard starts with the line before its first, as the
        block does."""
        return self.a

    @property
    def nlines(self) -> int:
        return self.b - self.a

    @property
    def whole(self) -> bool:
        """The window is the block itself (one shard)."""
        return self.a == 0 and self.last


@dataclass(frozen=True)
class ShardPlan:
    """N contiguous line ranges of a block of `nlines` lines, one per
    device."""
    devices: tuple
    nlines: int

    @classmethod
    def create(cls, devices, nlines: int) -> "ShardPlan":
        devs = resolve_devices(devices)
        if nlines % len(devs):
            # hacktv_tpu's message (encoder.py:318-321, video/mac.py)
            raise ValueError(
                f"block of {nlines} lines does not divide "
                f"over {len(devs)} devices; adjust frames_per_block")
        return cls(tuple(devs), nlines)

    @property
    def n(self) -> int:
        return len(self.devices)

    @property
    def lines_per_shard(self) -> int:
        return self.nlines // self.n

    def bounds(self) -> list[tuple[int, int]]:
        """[a_d, b_d) for each shard."""
        s = self.lines_per_shard
        return [(d * s, (d + 1) * s) for d in range(self.n)]

    def distinct(self) -> list[torch.device]:
        """The distinct devices, in first-use order."""
        seen = {}
        for d in self.devices:
            seen.setdefault(device_key(d), d)
        return list(seen.values())

    def windows(self, rows: int, need_after: int, lookahead: int
                ) -> list[Window]:
        """Each shard's window over a block of `rows` synthesised rows
        (row 0 = the line before the block).  Shard [a, b) starts at row
        a, the line before its first, and must compute rows up to
        b + need_after exactly: its own lines, the halo line after them,
        and whatever more its resampler reads.  A row gathers rows up to
        `lookahead` lines after it (the scramblers' shuffles), so an
        inner shard computes `lookahead` rows past that; the last one
        ends where the block does, and so clamps its gathers as the
        block's own rows do."""
        out = []
        for d, (a, b) in enumerate(self.bounds()):
            last = d == self.n - 1
            r1 = rows if last else min(rows, b + need_after + lookahead)
            out.append(Window(d, self.devices[d], a, b, r1, last))
        return out


def whole_window(nlines: int, rows: int, device) -> Window:
    """The window of an unsharded block."""
    return Window(0, device, 0, nlines, rows, True)


def to_shard(x, device: torch.device):
    """A device value (a tensor, or a dict, list or tuple of them) on
    `device`, enqueued without waiting (`non_blocking`); other values are
    returned as they are."""
    if isinstance(x, torch.Tensor):
        if x.device == device or (device.type == x.device.type == "cpu"):
            return x
        return x.to(device, non_blocking=True)
    if isinstance(x, dict):
        return {k: to_shard(v, device) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(to_shard(v, device) for v in x)
    return x


def _has_tensor(x, depth: int = 0) -> bool:
    if isinstance(x, torch.Tensor):
        return True
    if depth > 3:
        return False
    if isinstance(x, (tuple, list)):
        return any(_has_tensor(v, depth + 1) for v in x)
    if isinstance(x, dict):
        return any(_has_tensor(v, depth + 1) for v in x.values())
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return any(_has_tensor(getattr(x, f.name), depth + 1)
                   for f in dataclasses.fields(x))
    return False


def replicate(x, device: torch.device, depth: int = 0):
    """A copy of a statics value with every tensor in it on `device`:
    tensors, and the dataclasses, dicts, lists and tuples that hold them,
    are copied (so that a cache of device tensors is per device); anything
    else is shared."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if depth > 3 or not _has_tensor(x):
        return x
    if isinstance(x, dict):
        return {k: replicate(v, device, depth + 1) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(replicate(v, device, depth + 1) for v in x)
    out = copy.copy(x)
    for f in dataclasses.fields(x):
        object.__setattr__(out, f.name,
                           replicate(getattr(x, f.name), device, depth + 1))
    return out


def replicate_attrs(obj, device: torch.device, names=None):
    """A shallow copy of `obj` (an encoder or a service) whose attributes
    `names` (default: every attribute that holds a device tensor) are
    replicas on `device`; the host state is shared."""
    out = copy.copy(obj)
    for k, v in vars(obj).items():
        if (k in names) if names is not None else _has_tensor(v):
            setattr(out, k, replicate(v, device))
    return out


def replica(owner, dev: torch.device, names, services: bool = False):
    """An encoder on `dev`: itself on its own device, else a shallow copy
    holding replicas of its device statics `names` (and of its services'
    tensors), built once and kept in `owner._replicas`; the host state
    stays the owner's."""
    key = device_key(dev)
    if key == device_key(owner.device):
        return owner
    rep = owner._replicas.get(key)
    if rep is None:
        rep = replicate_attrs(owner, dev,
                              [k for k in names if hasattr(owner, k)])
        rep.device = dev
        if services:
            rep.services = [replicate_attrs(s, dev) for s in owner.services]
        owner._replicas[key] = rep
    return rep


def on(owner, dev: torch.device, kind: str, value):
    """A block input that the owner caches (its picture, its line
    metadata) on `dev`, copied once per distinct object and kept in
    `owner._moved`."""
    if device_key(dev) == device_key(owner.device):
        return value
    key = (kind, device_key(dev))
    hit = owner._moved.get(key)
    if hit is None or hit[0] is not value:
        hit = (value, to_shard(value, dev))
        owner._moved[key] = hit
    return hit[1]


def timed(owner, win: Window, fn):
    """fn(), a shard's row stage; where `owner.shard_timing` is on and the
    shard is on a card, bracketed by CUDA events kept in
    `owner.shard_events` as (shard, start, end)."""
    if not owner.shard_timing or win.device.type != "cuda":
        return fn()
    with torch.cuda.device(win.device):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = fn()
        ev[1].record()
    owner.shard_events.append((win.index,) + ev)
    return out


def period_window(tab: torch.Tensor, a: int, n: int) -> torch.Tensor:
    """A per-line table of period P (line b reads tab[b % P], as
    synth.tile_rows tiles it) for the lines [a, a + n): the same table
    for a = 0, else its rows from line a on."""
    if a == 0:
        return tab
    P = tab.shape[0]
    idx = (a + np.arange(min(n, P), dtype=np.int64)) % P
    return tab[torch.as_tensor(idx, device=tab.device)]


class ShardedBlock(tuple):
    """A block's output as the shards' tensors in line order, each on its
    shard's device (what `encode_block_device` of a sharded encoder
    returns); `transfer.join` copies them into one host array."""
