"""Benchmark: sustained IQ sample throughput of the full encoder chain.

    python -m hacktv_tpu_torch.bench [--mode i|secam|dmac|ntsc-vsb|mux2|all]
        [--e2e [null|mem|file]] [--dynamic] [--d2h] [--device cuda]

Prints ONE JSON line per configuration:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N,
   "x_realtime": N, "device": ..., "card": ...}

The same configurations, frames a block, warm-up, trials, median, keys
and metric strings as the JAX package's bench.py, so that the two sides
match by name.  vs_baseline is the achieved realtime factor divided by
BASELINE.md's target of 100x realtime per chip: a ratio to a target.
`device` is the card's name (torch.cuda.get_device_name) and `card` the
card's name and power limit as nvidia-smi reports them (null on the
CPU).  A trial is a stream of blocks with one synchronisation at its
end.  Runs on the card; `--device cpu` runs the plain PyTorch versions
on the CPU (no figure of such a run is a device figure).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from . import runtime
from .av.testcard import TestCardSource
from .config.standards import get_mode
from .encoder import Encoder
from .mux import MuxEncoder
from .transfer import resolve_device
from .video.mac import MacEncoder

# secondary configs: python -m hacktv_tpu_torch.bench --mode dmac / secam
# / ntsc-vsb
_CONFIGS = {
    "i": dict(mode="i", rate=16_000_000, label="PAL-I (i) full-chain"),
    "secam": dict(mode="l", rate=16_000_000, label="SECAM-L (l) full-chain"),
    "dmac": dict(mode="dmac-fm", rate=20_250_000,
                 label="D-MAC FM (dmac-fm) full-chain"),
    "ntsc-vsb": dict(mode="m", rate=13_500_000, vfilter=True,
                     label="NTSC-M+VSB (m) full-chain"),
    "mux2": dict(mode="i", rate=20_000_000, mux=True,
                 label="2-channel PAL-I mux (+/-2.25 MHz) full-chain"),
}
# --mode all: the four single-channel configurations on the device, then
# PAL-I end to end through each sink
ALL_RUNS = (("i", None), ("secam", None), ("dmac", None),
            ("ntsc-vsb", None), ("i", "null"), ("i", "mem"), ("i", "file"))
_E2E_LABEL = {None: "device",
              "null": "end-to-end (D2H + null sink)",
              "mem": "end-to-end (D2H + tmpfs sink)",
              "file": "end-to-end (D2H + file sink)"}


def card_line() -> str:
    """The card's name and power limit, as `nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader` prints them: the line every
    figure of the card is kept beside."""
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return smi.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError) as e:
        raise RuntimeError("nvidia-smi did not report the card's name and "
                           "power limit") from e


def device_fields(dev: torch.device) -> dict:
    """The result's `device` and `card` keys for a run on `dev`."""
    if dev.type != "cuda":
        return {"device": str(dev), "card": None}
    return {"device": torch.cuda.get_device_name(dev), "card": card_line()}


def wait(out) -> None:
    """Wait for the card to finish the block `out` (bench.py's
    block_until_ready); nothing to wait for on the CPU."""
    if out.device.type == "cuda":
        torch.cuda.synchronize(out.device)


def frames_per_block(mode: str) -> int:
    """bench.py's block: 32 frames for MAC, 16 for SECAM, 64 for the
    PAL/NTSC chains, which amortise dispatch best at 64."""
    if mode.startswith(("dmac", "d2mac")):
        return 32
    return 16 if mode.startswith(("l", "secam")) else 64


class DynamicSource(TestCardSource):
    """The test card with sound that does not repeat within a trial
    (bench.py's `_Dyn`): seeded noise, made before any timing, served by
    absolute sample index.  Defeats any caching of recurring identical
    blocks (the static card's periodic tone makes blocks recur)."""

    def __init__(self, width: int, height: int):
        super().__init__(width, height)
        self.noise = np.random.default_rng(11).integers(
            -20000, 20000, (120 * 32000, 2)).astype(np.int16)

    def read_audio(self, start: int, count: int) -> np.ndarray:
        n = len(self.noise)
        i = start % n
        if i + count <= n:
            return self.noise[i:i + count]
        return np.concatenate([self.noise[i:], self.noise[:i + count - n]])


def make_encoder(name: str, dynamic: bool = False, *, device="cuda",
                 fpb: int | None = None):
    """Configuration `name`'s encoder, as bench.py builds it."""
    cfg = _CONFIGS[name]
    mode, rate = cfg["mode"], cfg["rate"]
    fpb = fpb or frames_per_block(mode)
    kw = {"vfilter": True} if cfg.get("vfilter") else {}
    if dynamic:
        kw["source"] = DynamicSource(922, 576)
    if mode.startswith(("dmac", "d2mac")):
        return MacEncoder(get_mode(mode), rate, 0, frames_per_block=fpb,
                          pipeline_mux=True, device=device)
    if cfg.get("mux"):
        # BASELINE config #5: two transmitters with offsets, summed on
        # the device with int16 wraparound
        return MuxEncoder([
            Encoder(mode, rate, frames_per_block=fpb, offset=-2_250_000,
                    device=device, **kw),
            Encoder(mode, rate, frames_per_block=fpb, offset=2_250_000,
                    device=device, **kw)])
    return Encoder(mode, rate, frames_per_block=fpb, device=device, **kw)


def _sink_path(e2e: str) -> tuple[str, bool]:
    """(path, made here) for an e2e sink: /dev/null, a new file in tmpfs
    (/dev/shm, or the temporary directory where there is none) or in the
    temporary directory."""
    if e2e == "null":
        return os.devnull, False
    where = tempfile.gettempdir()
    if e2e == "mem" and os.path.isdir("/dev/shm"):
        where = "/dev/shm"
    fd, path = tempfile.mkstemp(prefix="hacktv_bench_e2e_", suffix=".bin",
                                dir=where)
    os.close(fd)
    return path, True


def stop_mux_worker(enc) -> None:
    """Read the pipelined multiplex's prefetch of the block after the
    last (raising the worker's error, if any) and stop its thread."""
    pipe = getattr(enc, "_pipe", None)
    pool = getattr(enc, "_pipe_pool", None)
    try:
        if pipe is not None:
            enc._pipe = None
            pipe[1].result()
    finally:
        if pool is not None:
            pool.shutdown(wait=True)


def stream_trials(run_block, warm: int = 5, n_blocks: int = 8,
                  trials: int = 3) -> list:
    """bench.py's timing of a block stream: `run_block(b)` for b = 0 ..
    warm - 1, each block waited for, then `trials` streams of `n_blocks`
    blocks continuing the stream, each ending in one synchronisation on
    the last block (when run_block returns one).  The trials' seconds."""
    for b in range(warm):
        r = run_block(b)
        if r is not None:
            wait(r)
    trial_s = []
    b = warm               # continue past warm-up: blocks are a stream
    for _ in range(trials):
        t0 = time.perf_counter()
        last = None
        for _ in range(n_blocks):
            last = run_block(b)
            b += 1
        if last is not None:
            wait(last)
        trial_s.append(time.perf_counter() - t0)
    return trial_s


def bench_config(name: str, e2e: str | None = None, dynamic: bool = False,
                 *, device="cuda", fpb: int | None = None, warm: int = 5,
                 n_blocks: int = 8, trials: int = 3,
                 sink_path: str | None = None) -> dict:
    """bench.py's figure for configuration `name`: `warm` blocks, then
    `trials` streams of `n_blocks` blocks, each ending in one
    synchronisation; the median trial.  `e2e` ("null", "mem", "file")
    adds the copy back and the native threaded sink with the CLI's
    one-block lag: block b is dispatched, then b - 1 collected and
    written; the last block dispatched is never collected, and a trial
    ends when its last write returns.  The sink's close (its drain) is
    timed apart and printed on its own line.  A file the sink writes is
    deleted afterwards, unless the caller named it (`sink_path`)."""
    dev = resolve_device(device)
    cfg = _CONFIGS[name]
    rate = cfg["rate"]
    enc = make_encoder(name, dynamic, device=dev, fpb=fpb)
    fpb = enc.frames_per_block
    sink = None
    made = False
    if e2e:
        if sink_path is None:
            sink_path, made = _sink_path(e2e)
        sink = runtime.NativeFileSink(sink_path, "int16", enc.complex_out)
    pend = {}

    def run_block(b):
        if not e2e:
            return enc.encode_block_device(b)
        pend[b] = enc.encode_block_device(b)
        out = pend.pop(b - 1, None)
        if out is not None:
            out = enc.collect_block(b - 1, out)
            if out.ndim == 1:
                out = np.stack([out, np.zeros_like(out)], axis=-1)
            sink.write(out)
        return None

    try:
        trial_s = stream_trials(run_block, warm, n_blocks, trials)
    finally:
        if sink is not None:
            t0 = time.perf_counter()
            sink.close()
            close_s = time.perf_counter() - t0
        if made:
            os.remove(sink_path)
    if sink is not None:
        print(f"[bench] {name} e2e={e2e} sink={sink_path} "
              f"close_s={close_s:.4f}", flush=True)
    stop_mux_worker(enc)
    dt = sorted(trial_s)[len(trial_s) // 2]
    sps = n_blocks * fpb * enc.frame_samples / dt
    x_rt = sps / rate
    return {
        "metric": (f"{cfg['label']} {_E2E_LABEL[e2e]}"
                   f"{' dynamic-source' if dynamic else ''} "
                   "IQ samples/s/chip"),
        "value": round(sps),
        "unit": "samples/s",
        "vs_baseline": round(x_rt / 100.0, 3),
        "x_realtime": round(x_rt, 1),
        **device_fields(dev),
    }


def d2h_bandwidth(device="cuda") -> dict:
    """The raw copy-back bandwidth: four distinct seeded random int32
    payloads of 2^22 elements, the first copied once to warm up, then
    three `.cpu()` copies timed."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(0)
    xs = [torch.randint(-2**31, 2**31 - 1, (1 << 22,), generator=g,
                        dtype=torch.int32, device=dev) for _ in range(4)]
    wait(xs[-1])
    xs[0].cpu()
    t0 = time.perf_counter()
    for x in xs[1:]:
        x.cpu()
    bw = 3 * xs[0].nbytes / (time.perf_counter() - t0)
    return {"metric": "raw D2H bandwidth", "value": round(bw),
            "unit": "bytes/s", "card": device_fields(dev)["card"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m hacktv_tpu_torch.bench")
    ap.add_argument("--mode", default="i",
                    choices=sorted(_CONFIGS) + ["all"])
    ap.add_argument("--e2e", nargs="?", const="null", default=None,
                    choices=["null", "mem", "file"],
                    help="include the copy back and the native threaded "
                         "sink (null=/dev/null, mem=tmpfs, file=real file)")
    ap.add_argument("--d2h", action="store_true",
                    help="measure the raw device->host bandwidth")
    ap.add_argument("--dynamic", action="store_true",
                    help="non-repeating source (defeats any caching of "
                         "recurring identical blocks)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "PyTorch versions)")
    ns = ap.parse_args(argv)
    if ns.d2h:
        print(json.dumps(d2h_bandwidth(ns.device)), flush=True)
        return 0
    # as bench.py: --mode all runs ALL_RUNS, whatever --e2e and --dynamic
    runs = (((name, e2e, False) for name, e2e in ALL_RUNS)
            if ns.mode == "all" else ((ns.mode, ns.e2e, ns.dynamic),))
    for name, e2e, dynamic in runs:
        print(json.dumps(bench_config(name, e2e, dynamic,
                                      device=ns.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
