"""Time end-to-end paths of the port in any checkout with chip_smoke.py's
method, so that a parent and a change are compared on one card in one
call:

    python3 tests/torch_e2e_timing.py --root DIR [--blocks 12] [PATH ...]

DIR is the root of a checkout that holds hacktv_tpu_torch/ and
chip_smoke.py (default: the one this file is in); each PATH is a key of
that chip_smoke.py's PATHS (default: pal-i, pal-i-vsb, i-pixelrate,
mux-i-offset, m-vsb).  It builds the checkout's kernels and runtime and
runs its chip_smoke `e2e_phase` on each path: 2 warm-up blocks, then
`--blocks` timed, each to the card's end; one `[e2e]` line a path.  Run
it once per checkout, each in its own process, in turns (parent, change,
change, parent).
"""

from __future__ import annotations

import argparse
import os
import sys
import threading

DEFAULT_PATHS = ("pal-i", "pal-i-vsb", "i-pixelrate", "mux-i-offset",
                 "m-vsb")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--blocks", type=int, default=12)
    ap.add_argument("paths", nargs="*", default=list(DEFAULT_PATHS))
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    os.chdir(root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", flush=True)
        return 1
    import chip_smoke as cs
    from hacktv_tpu_torch import runtime
    from hacktv_tpu_torch.ops import cuda_build
    cs.card()
    rt = threading.Thread(target=runtime.build)
    rt.start()
    cuda_build.build_all()
    rt.join()
    runtime.load()
    cs.TIMED_BLOCKS = args.blocks
    print(f"[root] {root}", flush=True)
    for path in args.paths:
        cs.e2e_phase(path, None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
