"""Multi-transmitter mux on the device.

Port of hacktv_tpu/mux.py.  The reference mixes transmitters by chaining
runs through --passthru capture files (src/video.c:3517-3541): channel 1
renders to disk and channel 2 adds it back sample by sample with int16
wraparound.  Here every channel is a full encoder with its own frequency
offset and level, and their blocks are wrap-added on the device: the
two-channel 20 MS/s mux with offsets, without a host round trip or a
capture file.
"""

from __future__ import annotations

import torch

from . import transfer
from .shard import ShardedBlock


def _sum_wrap(outs) -> torch.Tensor:
    """Wrap-add int16 blocks (real [nlines, W] or I/Q [nlines, W, 2]):
    the int32 sum wrapped to int16 once, which equals wrapping after each
    addition."""
    s = sum(o.to(torch.int32) for o in outs)
    return (((s + 0x8000) & 0xFFFF) - 0x8000).to(torch.int16)


class MuxEncoder:
    """N encoders sharing a sample rate, summed on the device per block.

    Each channel is an `Encoder` (typically with `offset=` set); blocks
    combine with the reference's int16 wraparound addition, as a
    --passthru chain of the same channels does.  A channel whose FM video
    runs on the host (it finishes in its own collect_block) cannot be
    summed on the device and is refused."""

    def __init__(self, channels):
        self.channels = list(channels)
        if not self.channels:
            raise ValueError("mux needs at least one channel")
        c0 = self.channels[0]
        for c in self.channels:
            if c.frames_per_block != c0.frames_per_block:
                raise ValueError("mux channels must share frames_per_block")
            if c.fm_video_exact is not None:
                raise ValueError("mux channels cannot run FM video on the "
                                 "host (give them an offset or swap_iq)")
        for c in self.channels:
            # the channels' steps run eagerly: graphed, each channel
            # would hold a graph pool of its own beside the sum's blocks
            c._graphs = None
        self.frames_per_block = c0.frames_per_block
        self.params = c0.params
        self.complex_out = c0.complex_out

    @property
    def frame_samples(self) -> int:
        return self.channels[0].frame_samples

    def encode_block_device(self, block_no: int):
        """The channels' blocks wrap-added on the device; channels sharded
        alike (`devices=`) are added shard by shard.  On a card the sum
        carries the event its copy back waits on (transfer.mark_done)."""
        outs = [c.encode_block_device(block_no) for c in self.channels]
        if isinstance(outs[0], ShardedBlock):
            return ShardedBlock(self._sum(parts) for parts in zip(*outs))
        return transfer.mark_done(self._sum(outs))

    @staticmethod
    def _sum(outs) -> torch.Tensor:
        shapes = {(tuple(o.shape), o.dtype, o.device) for o in outs}
        if len(shapes) != 1:
            raise ValueError(f"mux channel blocks differ: {shapes}")
        return _sum_wrap(outs)

    collect_block = transfer.collect_block
    encode_block = transfer.encode_block
