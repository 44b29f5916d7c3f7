"""A configuration builds the program as the CLI would (its parser, its
overrides and checks, its MAC or raster encoder), with the deployment's
own switches; the switches the harness owns, or that follow the wall
clock, are refused by name; and a configuration's own reference module
gets the configuration as it stands."""

import sys
import types

import numpy as np
import pytest
import torch

from bench_common import SEED, small_cell
import run
from harness import program
from harness.sources import make_source
from hacktv_tpu_torch.av import testcard
from hacktv_tpu_torch.encoder import Encoder
from hacktv_tpu_torch.video.params import VideoParams

CPU = torch.device("cpu")


def _with(name: str, **keys) -> tuple:
    """The configuration and the one-frame mix of cell `name`, the
    configuration with `keys` changed (a copy, never written)."""
    c = small_cell(name)
    return dict(c["config"], **keys), c["mix"]


@pytest.mark.parametrize("name", ["pal-i-vsb.testcard",
                                  "pal-fm-preemph.testcard"])
def test_build_is_the_direct_encoder(name):
    # the CLI's path gives the encoder the direct constructor gives
    config, mix = _with(name)
    enc, _ = run.build(config, mix, SEED, CPU)
    p = VideoParams.create(enc.conf, config["sample_rate"], 0)
    src = make_source(mix, SEED, p.active_width, p.conf.active_lines,
                      testcard.test_card_rgb)
    direct = Encoder(config["mode"], config["sample_rate"], source=src,
                     frames_per_block=mix["frames_per_block"],
                     vfilter=config["vfilter"], device=CPU)
    assert enc.conf == direct.conf
    for a, b in zip(enc.vf_taps, direct.vf_taps):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b)
    for b in range(2):
        got, want = enc.encode_block(b), direct.encode_block(b)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def _videocrypt_on(enc):
    from hacktv_tpu_torch.services.videocrypt import Videocrypt
    assert any(isinstance(s, Videocrypt) for s in enc.services)
    assert run._fir_shape(enc)["nout"] == 2


def _mac(enc):
    from hacktv_tpu_torch.video.mac import MacEncoder
    assert isinstance(enc, MacEncoder)
    assert run._fir_shape(enc) is None      # no stream FIR: silent


@pytest.mark.parametrize("keys,check", [
    ({"switches": ["--videocrypt", "free"]}, _videocrypt_on),
    ({"mode": "d2mac-fm", "sample_rate": 20250000, "vfilter": False}, _mac),
], ids=["videocrypt", "d2mac-fm"])
def test_build_takes_the_deployment(keys, check):
    config, mix = _with("pal-i-vsb.testcard", **keys)
    enc, src = run.build(config, mix, SEED, CPU)
    check(enc)


@pytest.mark.parametrize("module", [None, "bench_test_probe"])
def test_reference_is_the_configurations_own(monkeypatch, module):
    config, mix = _with("pal-i-vsb.testcard",
                        switches=["--videocrypt", "free"])
    if module is None:
        # no `reference` key: the codec reference, which runs no switch
        mod = run.reference_module(config)
        assert mod.__name__ == "reference.codec.make"
        with pytest.raises(NotImplementedError, match="--videocrypt free"):
            run.reference(config, mix, SEED, CPU)
        return
    got = []
    probe = types.ModuleType("reference." + module)
    probe.make = lambda *a, **k: got.append((a, k)) or "made"
    monkeypatch.setitem(sys.modules, probe.__name__, probe)
    config["reference"] = module
    assert run.reference(config, mix, SEED, CPU,
                         fir_dtype=torch.bfloat16) == "made"
    (a, k), = got
    assert a == (config, mix, SEED, CPU) and a[0] is config
    assert a[0]["switches"] == ["--videocrypt", "free"]
    assert k == {"fir_dtype": torch.bfloat16}


@pytest.mark.parametrize("switches,named", [
    (["-m", "l"], "--mode"),
    (["-ml"], "--mode"),
    (["-s", "20250000"], "--samplerate"),
    (["--filter"], "--filter"),
    (["test"], "input"),
    (["-o", "out.bin"], "--output"),
    (["-t", "float"], "--type"),
    (["--letterbox"], "--letterbox"),
    (["--passthru", "x.bin"], "--passthru"),
    (["--device", "cpu"], "--device"),
    (["--devices", "2"], "--devices"),
    (["--hosts", "2"], "--hosts"),
    (["--host", "1"], "--host"),
    (["--frames", "4"], "--frames"),
    (["--frames=4"], "--frames"),
    (["--seconds", "1"], "--seconds"),
    (["--frames-per-block", "2"], "--frames-per-block"),
    (["--profile", "d"], "--profile"),
    (["--prof", "d"], "--profile"),
    (["--teletext", "demo.tti"], "--teletext"),
    (["--eurocrypt", "ctv"], "--eurocrypt without --nodate"),
    (["--eurocrypt", "filmnet", "--nodate"], "--eurocrypt filmnet"),
    (["--eurocrypt", "ctv", "--nodate", "--ec-ppv"], "--ec-ppv"),
])
def test_refused_switch_is_named(switches, named):
    config, mix = _with("pal-i-vsb.testcard", switches=switches)
    with pytest.raises(ValueError, match="switch .*" + named):
        run.build(config, mix, SEED, CPU)


@pytest.mark.parametrize("switches", [
    [], ["--videocrypt", "free"], ["--nonicam", "-v"], ["--wss", "16:9"],
    ["--eurocrypt", "ctv", "--nodate"],
])
def test_accepted_switches_reach_the_parser(switches):
    args = program.cli_args({"mode": "i", "sample_rate": 16000000,
                             "vfilter": True, "switches": switches}, "cpu")
    assert (args.mode, args.samplerate, args.vfilter, args.device) == \
        ("i", 16e6, True, "cpu")
    assert args.input == ["test"] and args.frames == 0


def test_switches_that_do_not_parse_are_refused():
    with pytest.raises(ValueError, match="do not parse"):
        program.refuse(["--no-such-switch"])
