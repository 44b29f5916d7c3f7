"""The PAL-I full chain's host share against its full wall time a block.

    python -m hacktv_tpu_torch.tools.profile_bench [FPB] [--device cuda]

Blocks are a stream (their carries chain block to block), so the host's
arguments are built in stream order, interleaved with dispatch, and
their share is timed inline around the calls that build them
(`_device_rgb`, `_block_meta`, `_audio_args`), as encode_block_device
makes them; the full time runs from the first block's host work to the
card's end of the last block.  Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from ..bench import device_fields, wait
from ..encoder import Encoder, resolve_device


def profile(fpb: int = 32, *, device="cuda", warm: int = 5, n: int = 8):
    """(report, blocks): `n` blocks of Encoder("i", 16 MS/s) after `warm`,
    their host share and full time a block, and the blocks themselves
    (device tensors, blocks warm .. warm + n - 1)."""
    dev = resolve_device(device)
    enc = Encoder("i", 16_000_000, frames_per_block=fpb, device=dev)
    for b in range(warm):
        wait(enc.encode_block_device(b))
    t_host = 0.0
    outs = []
    t0 = time.perf_counter()
    for b in range(warm, warm + n):
        th = time.perf_counter()
        yuv = enc._device_rgb(b)
        m = enc._block_meta(b)
        audio = enc._audio_args(b)
        t_host += time.perf_counter() - th
        out, carry = enc._step(yuv, m, 0.0 if b == 0 else 1.0, audio)
        enc._take_carry(b, carry)
        outs.append(out)
    wait(outs[-1])
    t_full = (time.perf_counter() - t0) / n
    t_host /= n
    sps = fpb * enc.frame_samples
    return {"metric": "PAL-I (i) full-chain host share",
            "fpb": fpb, "block_samples": sps,
            "full_ms": round(t_full * 1e3, 3),
            "host_ms": round(t_host * 1e3, 3),
            "samples_per_s": round(sps / t_full),
            "x_realtime": round(sps / t_full / 16e6, 1),
            **device_fields(dev)}, outs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m hacktv_tpu_torch.tools.profile_bench")
    ap.add_argument("fpb", nargs="?", type=int, default=32,
                    help="frames a block (default 32)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "PyTorch versions)")
    args = ap.parse_args(argv)
    print(json.dumps(profile(args.fpb, device=args.device)[0]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
