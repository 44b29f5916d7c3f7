"""Service and scrambler throughput table on the card.

    python -m hacktv_tpu_torch.tools.service_bench [--out FILE]
        [--only teletext,sis] [--blocks N] [--device cuda]

Measures the full-chain throughput of the JAX package's ten service
configurations (tools/service_bench.py), the host bit pipelines running
interleaved with dispatch as in the CLI's block loop, and prints one
JSON line per configuration.  With `--out` it also writes them to FILE
(merged into it with `--only`).  Run it from the repository's root: the
teletext configuration reads tests/data/demo.tti.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from .. import create_encoder
from ..bench import device_fields, stream_trials
from ..services.eurocrypt import Eurocrypt
from ..transfer import resolve_device

CONFIGS = {
    # label -> (mode, rate, encoder kwargs)
    "teletext": ("i", 16_000_000, dict(teletext="tests/data/demo.tti")),
    "sis": ("g", 16_000_000, dict(sis="dcsis")),
    "stacked": ("i", 16_000_000, dict(wss="16:9", vits=True, vitc=True,
                                      acp=True, cc608=True)),
    "videocrypt": ("i", 16_000_000, dict(videocrypt="free")),
    "videocrypt2": ("i", 16_000_000, dict(videocrypt2="free")),
    "videocrypts": ("i", 16_000_000, dict(videocrypts="free")),
    "syster": ("l", 16_000_000, dict(syster="premiere-fa", systeraudio=True)),
    "systercnr": ("l", 16_000_000, dict(systercnr="premiere-fa")),
    "d11": ("l", 16_000_000, dict(d11="premiere-fa")),
    "eurocrypt": ("d2mac-fm", 20_250_000, dict(eurocrypt="filmnet")),
}


def bench_one(label, mode, rate, kw, fpb=32, blocks=8, trials=3, warm=8,
              *, device="cuda"):
    """One configuration timed as bench.stream_trials times a stream:
    the median rate of `trials` streams of `blocks` blocks after `warm`,
    and the trials' spread."""
    enc_kw = dict(kw)
    if "eurocrypt" in kw:
        enc_kw["eurocrypt"] = Eurocrypt(kw["eurocrypt"])
        enc_kw["scramble_audio"] = True
    enc = create_encoder(mode, rate, frames_per_block=fpb,
                         device=resolve_device(device), **enc_kw)
    block_samples = fpb * enc.frame_samples
    rates = [blocks * block_samples / dt for dt in stream_trials(
        enc.encode_block_device, warm, blocks, trials)]
    sps = float(np.median(rates))
    rt = sps / rate
    return {"metric": f"PAL+{label} full-chain device IQ samples/s/chip",
            "value": int(sps), "unit": "samples/s",
            "x_realtime": round(rt, 1),
            "spread_pct": round(100 * (max(rates) - min(rates))
                                / sps, 1)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m hacktv_tpu_torch.tools.service_bench")
    ap.add_argument("--out", default=None,
                    help="also write the results to this JSON file")
    ap.add_argument("--only", default=None)
    ap.add_argument("--blocks", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "PyTorch versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    names = (args.only.split(",") if args.only else list(CONFIGS))
    results = []
    for name in names:
        mode, rate, kw = CONFIGS[name]
        r = bench_one(name, mode, rate, kw, blocks=args.blocks, device=dev)
        print(json.dumps(r), flush=True)
        results.append(r)
    if args.out is None:
        return 0
    if args.only and os.path.exists(args.out):
        # merge a partial run into the existing file instead of
        # clobbering the other configs' results
        with open(args.out) as f:
            prev = json.load(f).get("results", [])
        fresh = {r["metric"] for r in results}
        results = [r for r in prev if r["metric"] not in fresh] + results
    out = {**device_fields(dev),
           "note": "median of 3 trials of an 8-block sequential stream "
                   "per config; host bit pipelines overlap device "
                   "compute as in the CLI block loop",
           "results": results}
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
