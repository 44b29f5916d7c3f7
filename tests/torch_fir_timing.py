"""Time the port's stream-FIR kernels on the card with one method, for the
port in any checkout, so that two kernel designs are compared like for
like in one run:

    python3 tests/torch_fir_timing.py [--root DIR] [--trains 5]

DIR is the root of a checkout that holds hacktv_tpu_torch/ (default: the
one this file is in).  Each kernel runs at chip_smoke.py's main-path
shapes and layout (64-frame blocks, the stream offset as the encoder's),
with the mode's own taps, and is timed as chip_smoke.py times it: CUDA
events around trains of 20 back-to-back launches, the median train over
`--trains`, divided by 20.  Its output is checked bit for bit against the
plain version first.  Prints the card, one line per kernel and one JSON
line.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
from dataclasses import replace

import numpy as np
import torch

FPB = 64
TRAIN = 20
PATHS = {"fir_cplx": ("m", 13_500_000), "fir_real": ("pal", 16_000_000)}


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
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--trains", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", flush=True)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from hacktv_tpu_torch.config import get_mode
    from hacktv_tpu_torch.ops import cuda_build
    from hacktv_tpu_torch.ops import stream_fir as sf
    from hacktv_tpu_torch.video.params import VideoParams

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    cuda_build.build_all()
    gen = torch.Generator(device="cuda").manual_seed(2024)
    out = {}
    for name, (mode, rate) in PATHS.items():
        p = VideoParams.create(replace(get_mode(mode), vfilter=True), rate, 0)
        W = p.width
        n = FPB * p.conf.lines * W
        host = ([p.vfilter_ctaps.real, p.vfilter_ctaps.imag]
                if name == "fir_cplx" else [p.vfilter_taps])
        taps = [torch.as_tensor(np.ascontiguousarray(a, np.float32))
                for a in host]
        half = taps[0].shape[0] // 2
        x = torch.randn(n + 2 * W, generator=gen, device="cuda") * 8000.0
        xs = x[W - half: W - half + n + taps[0].shape[0] - 1]
        fn = getattr(sf, name)
        try:            # taps from the host, as the kernels take them now
            fn(xs, *taps, n)
        except ValueError:  # an older wrapper that wants them on the card
            taps = [t.cuda() for t in taps]
        got = fn(xs, *taps, n)
        got = got if isinstance(got, tuple) else (got,)
        plain = sf.stream_fir_plain(
            xs, taps[0], taps[1] if len(taps) > 1 else None, n)
        plain = plain if isinstance(plain, tuple) else (plain,)
        mism = sum(int((a != b).sum()) for a, b in zip(got, plain))
        del got, plain
        ms = train_ms(lambda: fn(xs, *taps, n), args.trains)
        out[name] = dict(ms=ms, n=n, mismatches=mism)
        print(f"[fir] root={root} kernel={name} n={n} mismatches={mism} "
              f"ms={ms:.4f}", flush=True)
        del x, xs
        torch.cuda.empty_cache()
    print(json.dumps({"card": smi, "root": root, "kernels": out}))
    return 1 if any(v["mismatches"] for v in out.values()) else 0


if __name__ == "__main__":
    sys.exit(main())
