"""The control of the check: the plain reference with its stream FIR in
bfloat16 (the precision below the configurations' float32) put in the
program's place, judged by the same comparison at the cell's own size.
Its numbers are the upper readings the limits are set below; the
benchmark's own runs never run it.  `--workload` names a cell of
BENCHMARK.json or <config>.<traffic> of a configuration kept in configs/.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3
        [--seconds 5]
"""

import argparse
import json
import sys

import run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    run._env()
    import torch
    from harness.manifest import cell, kept_cell, load_manifest
    man = load_manifest()
    if args.workload in {w["name"] for w in man["workloads"]}:
        c = cell(man, args.workload)
    else:
        c = kept_cell(man, *args.workload.rsplit(".", 1))
    for seed in (int(s) for s in args.seeds.split(",")):
        out = run.run_cell(c, seed, args.seconds, False,
                           control_dtype=torch.bfloat16)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": out["correct"],
                          "blocks": out["_blocks_checked"],
                          "check": out["check"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
