"""Time SECAM's chroma program and render on the card, the kernel of
csrc/secam_chroma.cu against the plain torch program it replaces:

    python3 tests/torch_secam_timing.py [--fpb 16] [--trains 5]

Both run over one block of SECAM-L at 16 MS/s (`fpb`-frame blocks and
their 2 halo rows, the test card's planes, a seeded luma block), timed as
tests/torch_fir_timing.py times the FIR: CUDA events around trains of 20
back-to-back calls, the median train over `--trains`, divided by 20.  The
kernel's rows and next z are checked byte for byte against the plain
program's first.  Prints the card, one line per version and one JSON
line with the bytes bound (the block in and out, the U/V planes, at
3.35 TB/s)."""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from hacktv_tpu_torch import Encoder  # noqa: E402
from hacktv_tpu_torch.video import raster, secam  # noqa: E402

TRAIN = 20
HBM_BYTES_S = 3.35e12


def train_ms(fn, trains: int) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(trains):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(TRAIN):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / TRAIN)
    return statistics.median(times)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fpb", type=int, default=16)
    ap.add_argument("--trains", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", flush=True)
        return 1
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip(), flush=True)

    e = Encoder("l", 16_000_000, vfilter=True, frames_per_block=args.fpb,
                device=dev)
    p = e.params
    nl = args.fpb * p.lines
    nm = secam.block_meta(p, nl - 1, nl + 2, nl, e.vframe_y, e.source.height)
    md = secam.meta_to_device(nm, dev)
    _, u, v = raster.rgb_to_yuv_host(p, e.source.read_video(0), True)
    u, v = (torch.as_tensor(a, device=dev) for a in (u, v))
    B = md["dr"].shape[0]
    rng = np.random.default_rng(29)
    blk = torch.as_tensor(np.clip(np.round(rng.standard_normal(
        (B, p.width)) * 9000), -32768, 32767).astype(np.float32), device=dev)
    z0 = torch.tensor(-1234.5, device=dev)

    def kernel():
        return secam.chroma_render(e.secam, md, u, v, z0, blk)

    def plain():
        add, z = secam.device_chroma_carrier(e.secam, md, u, v, z0)
        return secam.render(e.secam, blk, add, md), z

    got, want = kernel(), plain()
    torch.cuda.synchronize()
    same = all(a.cpu().numpy().tobytes() == b.cpu().numpy().tobytes()
               for a, b in zip(got, want, strict=True))
    nbytes = 4 * (2 * blk.numel() + u.numel() + v.numel())
    res = {"card": card.strip(), "fpb": args.fpb, "rows": B,
           "width": p.width, "byte_equal": same,
           "kernel_ms": train_ms(kernel, args.trains),
           "plain_ms": train_ms(plain, args.trains),
           "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_S * 1e3}
    for name in ("kernel", "plain"):
        print(f"{name}: {res[name + '_ms']:.4f} ms a {args.fpb}-frame block "
              f"({B} rows of {p.width})", flush=True)
    print(json.dumps(res), flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
