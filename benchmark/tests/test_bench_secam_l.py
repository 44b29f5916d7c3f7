"""The SECAM-L reference (reference/secam_l/) on the CPU at one frame a
block: the port's blocks lie within the configuration's limit of it; it
computes any block cold exactly as it computes the block streamed from
block 0 (the chroma IIR's one carry, set by the last active line before
the block); its side-by-side IIR is the serial float64 recurrence; it
refuses, by name, what it does not run; a run of the cell is correct
(on the card too, at its size); and the cell's program-counter metric
reads the SECAM counters."""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from bench_common import BENCH, SEED, card, run_small, small_cell  # noqa: F401
import run
from reference.codec.video import raster
from reference.secam_l import secam

NAME = "secam-l-vsb.testcard"
BLOCKS = 4


def _config_and_mix(**keys):
    c = small_cell(NAME)
    return dict(c["config"], **keys), c["mix"]


@pytest.mark.parametrize("seed", [SEED, 2**31 + 4_000_033])
def test_port_within_the_limit_of_the_reference(seed):
    config, mix = _config_and_mix()
    limit = config["check"]["limits"]["max_abs_diff"]
    enc, _ = run.build(config, mix, seed, torch.device("cpu"))
    ref = run.reference(config, mix, seed, "cpu")
    for b in range(BLOCKS):
        got = enc.encode_block(b)
        want, _ = ref.encode_block(b)
        assert got.shape == want.shape
        d = np.abs(got.astype(np.int32) - want.astype(np.int32))
        assert d.max() <= limit, (b, int(d.max()))


def test_reference_computes_a_block_cold_as_streamed():
    config, mix = _config_and_mix()
    ref = run.reference(config, mix, SEED, "cpu")
    streamed, states = [], None
    for b in range(BLOCKS):
        out, states = ref.encode_block(b, states)
        streamed.append(out)
    for b in (3, 0, 2):
        cold, _ = run.reference(config, mix, SEED, "cpu").encode_block(b)
        np.testing.assert_array_equal(cold, streamed[b])


def test_side_by_side_iir_is_the_serial_recurrence():
    # block 1's active lines through the IIR side by side (two passes)
    # against one float64 loop over them in stream order, from the state
    # at the end of the last active line before the block
    config, mix = _config_and_mix()
    ref = run.reference(config, mix, SEED, "cpu")
    sc = ref.secam
    _, u, v = (torch.as_tensor(a) for a in raster.rgb_to_yuv_host(
        ref.params, ref.source.read_video(0), True))
    k0 = ref.params.lines - 1
    infos = [sc.line(k) for k in range(0, k0 + ref.params.lines)]
    act = [k for k, i in enumerate(infos) if i["active"]]
    x = sc.chroma_fir([infos[k] for k in act], u, v)
    first = sum(1 for k in act if k < k0)
    _, ends = sc.iir(x, None)
    start = torch.cat([ends[first - 1:first], ends[first:-1]])
    got, _ = sc.iir(x[first:], start)

    xs = x.numpy().astype(np.float64)
    b0, b1 = secam.IIR_B
    ix = iy = 0.0
    want = np.empty(xs.shape)
    for r in range(xs.shape[0]):
        for i in range(xs.shape[1]):
            iy = xs[r, i] * b0 + ix * b1 - iy * secam.IIR_A1
            ix = xs[r, i]
            want[r, i] = iy
    want = secam.lround(np.clip(want[first:], -32768.0, 32767.0))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("switches", [["--secam-field-id"],
                                      ["--volume", "0.5"]])
def test_reference_refuses_switches_by_name(switches):
    config, mix = _config_and_mix(switches=switches)
    with pytest.raises(NotImplementedError, match=switches[0]):
        run.reference(config, mix, SEED, "cpu")


@pytest.mark.parametrize("mode", ["i", "secam", "d", "secam-fm"])
def test_reference_refuses_other_modes(mode):
    config, mix = _config_and_mix(mode=mode)
    with pytest.raises(NotImplementedError, match=f"does not run {mode}$"):
        run.reference(config, mix, SEED, "cpu")


def test_small_run_is_correct():
    out = run_small(NAME)
    assert out["correct"], out["check"]
    assert out["_sink_bytes"][0] == out["_sink_bytes"][1]


@pytest.mark.cuda
def test_run_on_the_card(card, capsys):
    # the benchmark's command at the cell's size, a short window, traced:
    # correct, and the SECAM counters read
    assert run.main(["--workload", NAME, "--seed", str(SEED),
                     "--seconds", "2", "--trace", "1"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"
    assert out["metrics"]["secam_step_ms"]["value"] > 0


def _reader():
    path = os.path.join(BENCH, "metrics", "secam_step_ms.py")
    spec = importlib.util.spec_from_file_location("secam_step_ms", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_secam_step_ms_arithmetic():
    m = _reader()
    assert m.from_counters({"secam.step_ns": 30_000_000,
                            "secam.windows": 4}) == 7.5
    assert m.from_counters({"uploads": 7}) is None
    assert m.from_counters({"secam.step_ns": 0, "secam.windows": 0}) is None
    assert m.from_counters({"secam.windows": 3}) is None
