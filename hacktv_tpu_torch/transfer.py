"""Every per-block copy between the host and a device, for the three
encoders (`Encoder`, `MacEncoder`, `MuxEncoder`): a block's host arrays
go up through `upload`, pageable and counted; its samples come back
through `collect_block`, in page-locked memory, on a copy stream that
waits only on the event `mark_done` recorded after the block's step.
Set-up copies (statics, the services' `upload`) do not come here.
"""

from __future__ import annotations

import numpy as np
import torch

from . import telemetry
from .shard import ShardedBlock


def resolve_device(device) -> torch.device:
    """The torch device for `device`; a CUDA device must be present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the plain PyTorch versions on the CPU")
    return dev


def upload(a, device) -> torch.Tensor:
    """`torch.as_tensor(a, device=device)`, counted in "uploads": a host
    array of the block path copied to the encoder's device (pageable,
    blocking, the array's dtype)."""
    telemetry.count("uploads")
    return torch.as_tensor(a, device=device)


def arrays_to_device(arrays: dict, device) -> dict:
    """A dict of host arrays (a service's block arrays for its `apply`):
    numpy arrays uploaded, numpy scalars as Python numbers, anything else
    as it is."""
    out = {}
    for k, v in arrays.items():
        if isinstance(v, np.ndarray):
            out[k] = upload(np.ascontiguousarray(v), device)
        elif isinstance(v, np.generic):
            out[k] = v.item()
        else:
            out[k] = v
    return out


def mark_done(out):
    """Record on the current stream, after the step that made `out` (a
    card's tensor), the event its copy back waits on, kept on the tensor
    as `_step_done`; returns `out`."""
    if isinstance(out, torch.Tensor) and out.is_cuda:
        out._step_done = torch.cuda.Event()
        out._step_done.record(torch.cuda.current_stream(out.device))
    return out


def _wait_queued(out) -> None:
    """Wait for what a copy of `out` issued now (`to_host`) waits
    behind: the event recorded after the step that made `out`, or for a
    sharded block everything queued so far on the stream of each card
    that holds a shard."""
    if isinstance(out, ShardedBlock):
        for t in out:
            if t.is_cuda:
                torch.cuda.current_stream(t.device).synchronize()
    elif out.is_cuda:
        out._step_done.synchronize()


def join(block: ShardedBlock) -> np.ndarray:
    """A sharded block's shards copied back (pageable) and joined in line
    order into one host array."""
    return np.concatenate([t.cpu().numpy() for t in block], axis=0)


def to_host(out) -> np.ndarray:
    """A block's device output as a host array that owns its memory.

    A card's tensor is copied into page-locked memory from torch's
    caching host allocator, which reuses it only after the array is
    gone, on a pool stream that waits on `out._step_done` alone, so not
    on blocks queued after it; the call returns once the copy has ended
    and counts it ("collect.pinned", "collect.pinned_bytes").  A CPU
    tensor's memory is returned as it is; a sharded block is `join`ed."""
    if isinstance(out, ShardedBlock):
        return join(out)
    if out.device.type != "cuda":
        return out.cpu().numpy()
    copy = torch.cuda.Stream(out.device)      # from torch's stream pool
    copy.wait_event(out._step_done)
    host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
    with torch.cuda.stream(copy):
        host.copy_(out, non_blocking=True)
    # the caching allocator hands out's memory to later work only once
    # the copy has read it
    out.record_stream(copy)
    copy.synchronize()
    telemetry.count("collect.pinned")
    telemetry.count("collect.pinned_bytes", host.nbytes)
    return host.numpy()


def collect_block(enc, block_no: int, dev, finish=None) -> np.ndarray:
    """An encoder's `collect_block`: its block `dev` as host int16
    samples, [n] for real output, interleaved [n, 2] I/Q for complex.
    `finish(block_no, a)`, where given, makes the samples of the copied
    array (the host-exact FM-video recurrence).  With the tracer on, span
    `collect` first waits for what the copy waits behind
    (`collect.wait`), so that `collect.copy` holds the copy alone;
    `finish` is `collect.fm_video`."""
    span = telemetry.span
    with span("collect", block_no):
        if telemetry.enabled():
            with span("collect.wait"):
                _wait_queued(dev)
        with span("collect.copy"):
            a = to_host(dev)
        if finish is not None:
            with span("collect.fm_video"):
                return finish(block_no, a)
    if a.ndim == 3:
        return a.reshape(-1, 2)
    return a.reshape(-1)


def encode_block(enc, block_no: int) -> np.ndarray:
    """An encoder's `encode_block`: host int16 samples for one block, its
    `encode_block_device` then its `collect_block`."""
    return enc.collect_block(block_no, enc.encode_block_device(block_no))
