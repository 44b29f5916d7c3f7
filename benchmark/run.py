"""Run one cell of the benchmark of hacktv_tpu_torch once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Builds the cell's encoder as the CLI would from its configuration (mode,
sample rate, filter and the deployment's switches) and its source from
the traffic mix, warms up, streams blocks through the CLI's block loop
into the native sink (writing to the null device) for `--seconds`
seconds, checks blocks of the window against the plain reference that
the configuration names, and prints one JSON line.  With --trace 0 it
reports the cell's end-to-end metrics (over the window); with --trace 1
the per-layer metrics: the host-clock spans over a window of
`--seconds`, then a few blocks under torch's sync debug mode, then a
profiled stretch.  The cells, their configurations, traffic mixes and
metrics are in BENCHMARK.json and the files it names.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "hacktv_tpu")
# the profiled stretch: at least this many blocks and seconds
PROFILE_BLOCKS, PROFILE_SECONDS = 6, 2.0
SYNC_BLOCKS = 4
# the plain reference of a configuration that names none
DEFAULT_REFERENCE = "codec.make"
# the follows of an encoder whose configuration names none under
# `check.follows`: its host-exact FM carriers, by the encoder's attribute
# that holds each and the call that advances it, those it has
PROBES = {"fm_sound": ("fm_exact", "dispatch"),
          "fm_video": ("fm_video_exact", "collect")}


def _env() -> None:
    """The benchmark's folder and the repo's root on the import path (the
    port builds its native code inside the checkout by itself)."""
    for p in (HERE, ROOT):
        if p not in sys.path:
            sys.path.insert(0, p)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is jax's, jaxlib's, flax's or
    the JAX package's (hacktv_tpu_torch is the port, and allowed)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def build(config: dict, mix: dict, seed: int, device):
    """The program's encoder and source for a cell, built as the CLI
    builds them: its parser given the configuration's switches
    (harness/program.py), its overrides and service checks, and its MAC
    or raster encoder; the source is the traffic mix's, at the mode's
    active geometry, and the blocks the mix's."""
    import torch
    from hacktv_tpu_torch import cli
    from hacktv_tpu_torch.av.testcard import test_card_rgb
    from hacktv_tpu_torch.config.standards import get_mode
    from harness.program import cli_args
    from harness.sources import make_source
    args = cli_args(config, torch.device(device).type)
    conf = cli._apply_overrides(get_mode(args.mode), args)
    cli._check_services(args, conf)
    rate, pixel_rate = int(args.samplerate), int(args.pixelrate)
    if conf.mac_mode is not None:
        from hacktv_tpu_torch.video.mac import MacEncoder
        width, _ = MacEncoder.active_geometry(conf, rate, pixel_rate)
        make = cli._mac_encoder
    else:
        from hacktv_tpu_torch.video.params import VideoParams
        width = VideoParams.create(conf, rate, pixel_rate).active_width
        make = cli._encoder
    src = make_source(mix, seed, width, conf.active_lines, test_card_rgb)
    enc = make(args, conf, rate, pixel_rate, mix["frames_per_block"], src)
    return enc, src


def follows(config: dict, enc) -> dict:
    """The serial host states the check follows for encoder `enc`: {name:
    (encoder attribute, "dispatch" | "collect")}, those the
    configuration's `check.follows` names (check.Chain refuses one the
    encoder lacks), or else PROBES' FM carriers that it has."""
    named = config["check"].get("follows")
    if named is not None:
        return dict(named)
    return {n: p for n, p in PROBES.items()
            if getattr(enc, p[0], None) is not None}


def reference_module(config: dict):
    """The module under reference/ that configuration `config` names
    under `reference` (reference/codec/make.py where it names none)."""
    import importlib
    return importlib.import_module(
        "reference." + config.get("reference", DEFAULT_REFERENCE))


def reference(config: dict, mix: dict, seed: int, device, fir_dtype=None):
    """The plain reference's encoder for a cell, with its own source:
    the `make` of the configuration's reference module, given the
    configuration as it stands (switches and all).  `fir_dtype` computes
    the reference's stream FIR in a lower precision (the control)."""
    return reference_module(config).make(config, mix, seed, device,
                                         fir_dtype=fir_dtype)


def run_cell(c: dict, seed: int, seconds: float, trace: bool,
             device="cuda", control_dtype=None, t_start=None) -> dict:
    """One run of cell `c` (manifest.cell): the result line's fields, and
    `check`, the numbers compared with their limits.  `control_dtype`
    puts the reference in that precision in the program's place (the
    control; never in the benchmark's own runs)."""
    import torch
    from hacktv_tpu_torch import runtime
    from harness import check, loop, stats
    from harness import trace as trace_mod
    from harness.manifest import reader

    t_start = T_START if t_start is None else t_start
    config, mix = c["config"], c["mix"]
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    enc, src = build(config, mix, seed, dev)
    chain = check.Chain(follows(config, enc), enc)
    wchar0 = check.bytes_written()
    sink = runtime.NativeFileSink(os.devnull, "int16", enc.complex_out)
    spans = loop.Spans()
    for attr, _ in PROBES.values():
        fx = getattr(enc, attr, None)
        if fx is not None:
            fx.process = spans.wrap("fm_carrier", fx.process)
    bl = loop.BlockLoop(enc, sink, spans, chain)
    res = check.Reservoir(config["check"]["blocks"], seed)

    # set-up: every shape the window uses, both block parities
    written = 0
    while written < mix["warmup_blocks"]:
        r = bl.step()
        if r is not None:
            written += 1
            t0 = r[2]
    setup_s = time.perf_counter() - t_start

    # the window: closes when the write that passes `seconds` returns
    spans.reset()
    returns, samples = [], 0
    while True:
        b, out, t = bl.step()
        returns.append(t)
        samples += len(out)
        res.offer(b, out)
        chain.keep(res.kept, b)
        if t - t0 >= seconds:
            break
    blocks = len(returns)
    ctx = {"kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
           "blocks": blocks, "spans": dict(spans.total),
           "gaps_ms": [g * 1e3 for g in stats.gaps(t0, returns)],
           "fir": _fir_shape(enc)}
    device_info = {}
    if trace and cuda:
        bl.sync_warnings = []
        for _ in range(SYNC_BLOCKS):
            bl.step()
        ctx["syncs"] = {"count": len(bl.sync_warnings),
                        "blocks": SYNC_BLOCKS}
        bl.sync_warnings = None
        red = _profile(bl, spans)
        ctx["trace"] = red
        device_info = {"busy_s": red["busy_s"], "window_s": red["window_s"]}
    bl.drop_pending()
    if cuda:
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev)
    else:
        peak = 0
    sink.close()
    handed = bl.pairs * (4 if enc.complex_out else 2)
    short = check.bytes_short(handed, wchar0, check.bytes_written())
    kept = check.through_sink(res.kept, runtime.NativeFileSink,
                              enc.complex_out)
    del bl, enc, src, sink, res
    if cuda:
        torch.cuda.empty_cache()

    # the check, on the device once the program's state is freed
    ref = reference(config, mix, seed, dev)
    ctl = (reference(config, mix, seed, dev, fir_dtype=control_dtype)
           if control_dtype is not None else None)
    numbers = check.compare(kept, chain, ref, control=ctl,
                            sink_short=short)
    limits = config["check"]["limits"]
    correct = all(numbers[k] <= limits[k] for k in numbers)

    if trace:
        metrics = {}
        for m in c["per_layer"]:
            v = reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = {"samples_per_s": stats.window_rate(samples, t0,
                                                     returns[-1]),
                  "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in c["end_to_end"]}
    out = {"correct": correct, "attempted": blocks,
           "failed": 0 if correct else len(kept), "metrics": metrics,
           "device": {"platform": "gpu" if cuda else "cpu",
                      "kind": ctx["kind"], "count": 1,
                      "memory_peak_bytes": int(peak), **device_info}}
    if "trace" in ctx:
        out["breakdown"] = trace_mod.breakdown(ctx["trace"])
    out["check"] = {k: {"value": numbers[k], "limit": limits[k]}
                    for k in numbers}
    out["_blocks_checked"] = sorted(kept)
    out["_sink_bytes"] = (handed - short, handed)
    return out


def _fir_shape(enc) -> dict | None:
    """The stream FIR's shape on this encoder's path: outputs per launch,
    taps and channels; None where the encoder has no stream FIR (the
    MAC encoder, the mux)."""
    taps = getattr(enc, "vf_taps", None)
    params = getattr(enc, "params", None)
    out_params = getattr(enc, "out_params", None)
    if taps is None or params is None or out_params is None:
        return None
    taps_r, taps_i = taps
    n = enc.frames_per_block * params.lines * out_params.width
    return {"n": n, "taps": int(taps_r.shape[0]),
            "nout": 1 if taps_i is None else 2}


def _profile(bl, spans) -> dict:
    """A stretch of blocks under torch.profiler, reduced (trace.py)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from harness import trace as trace_mod
    spans.profiling = True
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        with record_function(trace_mod.WINDOW_SPAN):
            t0, n = time.perf_counter(), 0
            while (n < PROFILE_BLOCKS
                   or time.perf_counter() - t0 < PROFILE_SECONDS):
                bl.step()
                n += 1
        torch.cuda.synchronize()
    spans.profiling = False
    return trace_mod.reduce_events(trace_mod.profiler_events(prof), n)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _env()
    from harness.manifest import cell, load_manifest
    c = cell(load_manifest(), args.workload)
    import torch
    chips = c["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out = run_cell(c, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"loaded modules of the JAX side: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    print("sink wrote {} of {} bytes".format(*out.pop("_sink_bytes")),
          file=sys.stderr)
    print(f"check blocks {out.pop('_blocks_checked')}", file=sys.stderr)
    for k, v in out["check"].items():
        print(f"check {k} {v['value']} limit {v['limit']}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
