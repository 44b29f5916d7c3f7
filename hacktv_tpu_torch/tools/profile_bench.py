"""The PAL-I full chain's host share against its full wall time a block.

    python -m hacktv_tpu_torch.tools.profile_bench [FPB] [--device cuda]

The host's share is what the program's tracer (telemetry.py) records
under encode_block_device's spans `dispatch.rgb`, `dispatch.meta` and
`dispatch.audio`, the calls that build the block's arguments; the full
time runs from the first timed block's dispatch to the card's end of the
last block.  Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from .. import telemetry
from ..bench import device_fields, wait
from ..encoder import Encoder
from ..transfer import resolve_device

HOST_SPANS = ("dispatch.rgb", "dispatch.meta", "dispatch.audio")


def profile(fpb: int = 32, *, device="cuda", warm: int = 5, n: int = 8):
    """(report, blocks): `n` blocks of Encoder("i", 16 MS/s) after `warm`,
    their host share and full time a block, and the blocks themselves
    (device tensors, blocks warm .. warm + n - 1)."""
    dev = resolve_device(device)
    enc = Encoder("i", 16_000_000, frames_per_block=fpb, device=dev)
    for b in range(warm):
        wait(enc.encode_block_device(b))
    was_on = telemetry.enabled()
    before = telemetry.totals()
    telemetry.enable(True)
    try:
        t0 = time.perf_counter()
        outs = [enc.encode_block_device(b) for b in range(warm, warm + n)]
        wait(outs[-1])
        t_full = (time.perf_counter() - t0) / n
    finally:
        telemetry.enable(was_on)
    after = telemetry.totals()
    t_host = sum(after.get(k, 0.0) - before.get(k, 0.0)
                 for k in HOST_SPANS) / n
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
