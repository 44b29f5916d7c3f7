"""The free-access Videocrypt I reference (reference/videocrypt/) on the
CPU at one frame a block: the port's blocks, built as the CLI builds them
(`run.build`), equal it, across the frame counter's wrap at frame 256 and
with the reference's blocks drawn out of order; its bitwise PRBS equals
the port's plain one (`_VCState._clock16`) and its VBI packets the port's;
the reference without the scrambler fails the configuration's limit
against the program with it; the configuration builds through
harness/program.py; it refuses other switches and modes by name; a run
of the cell is correct (on the card too, at its size, with the
Videocrypt counters read; tests/test_torch_telemetry.py holds the
reader's arithmetic)."""

import json

import numpy as np
import pytest
import torch

from bench_common import SEED, card, run_small, small_cell  # noqa: F401
import run
from harness.program import cli_args
from reference.videocrypt import videocrypt as vc

NAME = "i-videocrypt-vsb.testcard"


def _config_and_mix(**keys):
    c = small_cell(NAME)
    return dict(c["config"], **keys), c["mix"]


def _diff(a, b) -> int:
    assert a.shape == b.shape
    return int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max())


@pytest.fixture(scope="module")
def streamed():
    """The program's blocks 0-2 and 255-257 (frames 1-3 and 256-258, the
    counter wrapping to 0 at frame 257), streamed from block 0 as the
    program must stream them."""
    config, mix = _config_and_mix()
    enc, _ = run.build(config, mix, SEED, torch.device("cpu"))
    keep = {0, 1, 2, 255, 256, 257}
    out = {}
    for b in range(max(keep) + 1):
        block = enc.encode_block(b)
        if b in keep:
            out[b] = block
    return out


def test_port_equals_the_reference_across_the_wrap(streamed):
    config, mix = _config_and_mix()
    limit = config["check"]["limits"]["max_abs_diff"]
    ref = run.reference(config, mix, SEED, "cpu")
    # out of order: each block computed on its own from its frame numbers
    for b in (257, 1, 255, 0, 256, 2):
        want, _ = ref.encode_block(b)
        assert _diff(streamed[b], want) <= limit, b


def test_reference_without_the_scrambler_fails_the_limit(streamed):
    config, mix = _config_and_mix()
    limit = config["check"]["limits"]["max_abs_diff"]
    plain = dict(config, switches=[], reference="codec.make")
    ref = run.reference(plain, mix, SEED, "cpu")
    for b in (0, 256):
        want, _ = ref.encode_block(b)
        assert _diff(streamed[b], want) > limit, b


def _port_state(counter: int, c: int):
    from hacktv_tpu_torch.services import videocrypt as port
    st = port._VCState(port._FA_BLOCKS, ())
    iw = port._generate_iw(port.VC_PRBS_CW_FA, counter)
    st.sr1, st.sr2, st.c = iw & ((1 << 31) - 1), (iw >> 31) & (
        (1 << 29) - 1), c
    return st


@pytest.mark.parametrize("counter,c", [(0, 0), (1, 0xBEEF), (127, 0x1234),
                                       (255, 0xFFFF)])
def test_prbs_equals_the_ports_plain_clock(counter, c):
    from hacktv_tpu_torch.services import videocrypt as port
    cuts, c_end = vc.prbs_frame(counter, c)
    st = _port_state(counter, c)
    want = [st._clock16() for _ in port._CUT_LINES]
    assert list(cuts) == [int(x) for x in port._CUT_LINES]
    assert list(cuts.values()) == want
    assert c_end == st.c


def test_frames_equal_the_ports_state():
    # frames 1-20 and, past the wrap, 255-260: VBI packets and cut bytes
    # (the port's line 23 reads -1, left for WSS)
    from hacktv_tpu_torch.services import videocrypt as port
    st = port._VCState(port._FA_BLOCKS, ())
    for f0, f1 in ((1, 20), (255, 260)):
        got = vc.frames(f0, f1)
        for f in range(f0, f1 + 1):
            vbi, _, cuts = st.frame(f)
            packet, want_cuts = got[f]
            assert packet == bytes(vbi), f
            lines = np.nonzero(cuts >= 0)[0]
            assert sorted(set(want_cuts) - {vc.WSS_LINE}) == list(lines)
            assert [want_cuts[int(k)] for k in lines] == list(cuts[lines])


def test_configuration_builds_through_the_program():
    config, mix = _config_and_mix()
    args = cli_args(config, "cpu")
    assert (args.mode, args.vfilter, args.videocrypt) == ("i", True, "free")
    from hacktv_tpu_torch.services.videocrypt import _FA_BLOCKS, Videocrypt
    enc, _ = run.build(config, mix, SEED, torch.device("cpu"))
    (svc,) = enc.services
    assert isinstance(svc, Videocrypt)
    assert svc.blocks == _FA_BLOCKS and not svc.blocks2


@pytest.mark.parametrize("switches", [[], ["--videocrypt", "conditional"],
                                      ["--videocrypt", "free", "--wss",
                                       "auto"]])
def test_reference_refuses_other_switches(switches):
    config, mix = _config_and_mix(switches=switches)
    with pytest.raises(NotImplementedError, match="--videocrypt free"):
        run.reference(config, mix, SEED, "cpu")


@pytest.mark.parametrize("mode", ["m", "l", "pal-fm"])
def test_reference_refuses_other_modes(mode):
    config, mix = _config_and_mix(mode=mode)
    with pytest.raises(NotImplementedError, match=f"does not run {mode}$"):
        run.reference(config, mix, SEED, "cpu")


def test_small_run_is_correct():
    out = run_small(NAME, seed=2**31 + 4_000_033)
    assert out["correct"], out["check"]
    assert out["check"]["max_abs_diff"]["value"] == 0
    assert out["_sink_bytes"][0] == out["_sink_bytes"][1]


@pytest.mark.cuda
def test_run_on_the_card(card, capsys):
    # the benchmark's command at the cell's size, a short window, traced:
    # correct, and the Videocrypt counters read
    assert run.main(["--workload", NAME, "--seed", str(SEED),
                     "--seconds", "2", "--trace", "1"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"
    assert out["metrics"]["videocrypt_host_ms"]["value"] > 0
