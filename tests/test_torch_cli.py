"""The port's command line (python -m hacktv_tpu_torch): its file output
equals Encoder.encode_block byte for byte, PAL-I with NICAM included, and
the JAX package's command line byte for byte on each switch that changes
the mode's configuration, S-Video and --pixelrate among them, and on
each scrambler switch and ntsc-bs, on the D/D2-MAC switches (Eurocrypt,
the cuts, scrambled audio, the MAC audio modes), and on the moving
inputs (raw: files through the fit switches, --repeat/--shuffle, ffmpeg:
through a fake binary with --ffmt/--fopts, an .avi through OpenCV, MAC
from a raw: file) and -v; the scramblers' and MAC's checks exit with the
JAX command line's messages; the hardware sinks (-o hackrf and -o fl2k
with -f, -g, -A and --fl2k-audio) give a mock vendor library the JAX
command line's calls and bytes, and -o hackrf with no library exits
naming it and writes no file; it refuses what it does not cover."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from dataclasses import replace

import numpy as np
import pytest
import torch

import _torch_common as tc
from hacktv_tpu import cli as jcli
from hacktv_tpu_torch import Encoder
from hacktv_tpu_torch import cli
from hacktv_tpu_torch.config import get_mode

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("mode,rate", [("m", 13_500_000),
                                       ("pal", 16_000_000)])
def test_cli_file_matches_encoder(tmp_path, mode, rate):
    out = tmp_path / "out.bin"
    assert cli.main(["-m", mode, "-s", str(rate), "--filter", "--frames",
                     "1", "--device", "cpu", "-o", str(out), "test"]) == 0
    ref = Encoder(mode, rate, vfilter=True, device="cpu").encode_block(0)
    if ref.ndim == 1:                  # real output: the I channel
        ref = ref.reshape(-1)
    assert out.read_bytes() == ref.tobytes()


def test_cli_module_writes_frames(tmp_path):
    """Two frames through `python -m`, as one two-frame block.  The
    child runs torch with this process's thread count: on the CPU, where a
    vectorised cos/sin and its scalar tail differ in the last bit, the
    split of an op across threads can move a floor by one LSB."""
    out = tmp_path / "out.bin"
    r = subprocess.run(
        [sys.executable, "-m", "hacktv_tpu_torch", "-m", "m", "--filter",
         "-s", "13500000", "--frames", "2", "--device", "cpu", "-o", str(out), "test"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": str(torch.get_num_threads())})
    assert r.returncode == 0, r.stderr
    assert out.stat().st_size == 2 * 450450 * 2 * 2
    ref = Encoder("m", 13_500_000, vfilter=True, frames_per_block=2,
                  device="cpu").encode_block(0)
    assert out.read_bytes() == ref.tobytes()


def test_cli_pal_i_matches_encoder(tmp_path):
    """The default mode, PAL-I with FM and NICAM sound: 4 frames, one
    4-frame block."""
    out = tmp_path / "out.bin"
    assert cli.main(["-m", "i", "--frames", "4", "--device", "cpu", "-o",
                     str(out), "test"]) == 0
    ref = Encoder("i", 16_000_000, frames_per_block=4,
                  device="cpu").encode_block(0)
    assert out.stat().st_size == 4 * 640_000 * 2 * 2
    assert out.read_bytes() == ref.tobytes()


def test_cli_nonicam(tmp_path):
    out = tmp_path / "out.bin"
    assert cli.main(["-m", "i", "--nonicam", "--frames", "1", "--device",
                     "cpu", "-o", str(out), "test"]) == 0
    ref = Encoder(replace(get_mode("i"), nicam_level=0.0), 16_000_000,
                  device="cpu").encode_block(0)
    assert out.read_bytes() == ref.tobytes()
    with_nicam = Encoder("i", 16_000_000, device="cpu").encode_block(0)
    assert out.read_bytes() != with_nicam.tobytes()


def test_cli_noaudio_and_type(tmp_path):
    out = tmp_path / "out.bin"
    cli.main(["-m", "m", "-s", "13500000", "--noaudio", "-t", "uint8",
              "--frames", "1", "--device", "cpu", "-o", str(out), "test"])
    data = np.fromfile(out, np.uint8)
    assert data.size == 450450 * 2


@pytest.mark.parametrize("argv,exc", [
    (["--eurocrypt", "filmnet"], SystemExit),   # without a MAC mode
    (["-m", "d2mac-fm", "clip.mp4"], SystemExit),  # a missing input file
    (["-m", "pal", "clip.mp4"], SystemExit),
])
def test_cli_refuses(argv, exc, tmp_path, monkeypatch):
    """A missing input file exits with the JAX command line's message."""
    monkeypatch.chdir(tmp_path)
    with pytest.raises(exc) as e:
        cli.main(argv + ["--frames", "1", "--device", "cpu", "-o",
                         str(tmp_path / "x.bin")])
    if "clip.mp4" in argv:
        with pytest.raises(SystemExit) as ej:
            jcli.main(argv + ["--frames", "1", "-o", str(tmp_path / "j")])
        assert str(e.value.code) == str(ej.value.code)


@pytest.mark.parametrize("argv", [
    ["-m", "pal", "--s-video", "--filter"],
    ["-m", "i", "--pixelrate", "14750000"],
    ["-m", "pal-fm", "-D", "12000000", "--fm-energy-dispersal", "0.0625"],
    ["-m", "pal", "-s", "4000000", "-l", "0.8", "-G", "1.2"],
    ["-m", "i", "--volume", "0.5", "-i"],
    ["-m", "pal", "-s", "4000000", "--nocolour", "--invert-video"],
    ["-m", "ntsc", "-s", "13500000", "--nocolor"],
    ["-m", "pal", "-s", "4000000", "--seconds", "0.08",
     "--frames-per-block", "0"],
    ["-m", "apollo-fsc", "-s", "14000000", "--frames", "3",
     "--frames-per-block", "2"],
], ids=lambda a: "".join(a[1:4]))
def test_cli_matches_jax_cli(tmp_path, argv):
    """The port's and the JAX package's command lines on the same switches
    write the same bytes (one frame per block unless the case says)."""
    if "-D" in argv:
        tc.jax_runtime()
    tail = [] if "--frames-per-block" in argv else ["--frames-per-block",
                                                    "1"]
    if "--frames" not in argv and "--seconds" not in argv:
        tail += ["--frames", "1"]
    out_t, out_j = tmp_path / "t.bin", tmp_path / "j.bin"
    assert cli.main(argv + tail + ["--device", "cpu", "-o", str(out_t),
                                   "test"]) == 0
    assert jcli.main(argv + tail + ["-o", str(out_j), "test"]) == 0
    got, ref = out_t.read_bytes(), out_j.read_bytes()
    assert len(got) == len(ref) > 0
    ndiff = np.count_nonzero(np.frombuffer(got, np.int16)
                             != np.frombuffer(ref, np.int16))
    assert got == ref, f"{ndiff} samples differ"


@pytest.mark.parametrize("argv", [
    ["-m", "i", "--teletext", "tests/data/demo.tti", "--wss", "16:9",
     "--vits", "--vitc"],
    ["-m", "pal", "--teletext", "raw:tests/data/raw_tt_packets.bin"],
    ["-m", "pal", "--wss", "auto"],
    ["-m", "ntsc", "-s", "13500000", "--vits", "--vitc"],
    ["-m", "ntsc", "-s", "13500000", "--cc608", "--acp"],
    ["-m", "pal", "--acp", "--cc608"],
    ["-m", "pal", "--sis", "dcsis"],
], ids=lambda a: "".join(a[1:6]))
def test_cli_services_match_jax_cli(tmp_path, monkeypatch, argv):
    """Each service switch: the port's and the JAX package's command lines
    write the same bytes over two one-frame blocks, the teletext clock
    fixed by HACKTV_TPU_TELETEXT_TIME as for hacktv_tpu."""
    monkeypatch.setenv("HACKTV_TPU_TELETEXT_TIME", "1200000000")
    monkeypatch.chdir(REPO)
    if "--sis" in argv or argv[1] == "i":
        # the JAX package's NICAM frame coder runs in its native runtime
        tc.jax_runtime()
    tail = ["--frames-per-block", "1", "--frames", "2"]
    out_t, out_j = tmp_path / "t.bin", tmp_path / "j.bin"
    assert cli.main(argv + tail + ["--device", "cpu", "-o", str(out_t),
                                   "test"]) == 0
    assert jcli.main(argv + tail + ["-o", str(out_j), "test"]) == 0
    got, ref = out_t.read_bytes(), out_j.read_bytes()
    assert len(got) == len(ref) > 0
    ndiff = np.count_nonzero(np.frombuffer(got, np.int16)
                             != np.frombuffer(ref, np.int16))
    assert got == ref, f"{ndiff} samples differ"


@pytest.mark.parametrize("argv", [
    ["-m", "m", "--teletext", "tests/data/demo.tti"],
    ["-m", "ntsc", "--wss", "4:3"],
    ["-m", "405", "--vits"],
    ["-m", "819", "--vitc"],
    ["-m", "405", "--cc608"],
    ["-m", "240", "--acp"],
    ["-m", "m", "--sis", "dcsis"],
], ids=lambda a: "".join(a[1:4]))
def test_cli_service_exits_match_jax(tmp_path, capsys, argv):
    """The JAX command line's compatibility exits: each service on a mode
    it does not support exits with the same message."""
    msgs = []
    for main in (cli.main, jcli.main):
        with pytest.raises(SystemExit) as e:
            main(argv + ["--frames", "1", "-o", str(tmp_path / "x.bin"),
                         "test"] + (["--device", "cpu"]
                                    if main is cli.main else []))
        msgs.append(str(e.value.code))
    assert msgs[0] == msgs[1] and "only" in msgs[0]


@pytest.mark.parametrize("extra", [[], ["--json"]])
def test_list_modes_matches_jax(capsys, extra):
    assert cli.main(["--list-modes"] + extra) == 0
    got = capsys.readouterr().out
    assert jcli.main(["--list-modes"] + extra) == 0
    assert got == capsys.readouterr().out
    assert "apollo-fsc" in got and "nbtv" in got


def test_cli_pixel_rate_warning(tmp_path, capsys):
    """A rate without whole samples per line is warned about, as the
    reference does, with the next valid rates; a valid one is not."""
    cli.main(["-m", "pal", "-s", "8000000", "--pixelrate", "16000000",
              "--frames", "1", "--device", "cpu", "-o",
              str(tmp_path / "a.bin"), "test"])
    assert "Warning" not in capsys.readouterr().err
    cli.main(["-m", "pal", "-s", "4000100", "--frames", "1", "--device",
              "cpu", "-o", str(tmp_path / "b.bin"), "test"])
    err = capsys.readouterr().err
    assert "Pixel rate 4000100 may not work well" in err
    assert "Next valid pixel rates: 4000000, 4015625" in err


@pytest.mark.parametrize("argv", [
    ["-m", "i", "--filter", "--videocrypt", "free"],
    ["-m", "pal", "--videocrypt", "free", "--videocrypt2", "free"],
    ["-m", "pal", "--videocrypts", "conditional"],
    ["-m", "l", "--syster", "premiere-fa", "--systeraudio"],
    ["-m", "pal", "--syster", "cfrfa", "--systercnr", "cfrfa",
     "--key-table-1"],
    ["-m", "pal", "--systercnr", "premiere-fa", "--key-table-2"],
    ["-m", "l", "--d11", "premiere-fa"],
    ["-m", "ntsc-bs"],
], ids=lambda a: "".join(a[1:6]))
def test_cli_scramblers_match_jax_cli(tmp_path, argv):
    """Each scrambler switch, and ntsc-bs with DANCE: the port's and the
    JAX package's command lines write the same bytes over two one-frame
    blocks."""
    tc.jax_runtime()
    tail = ["--frames-per-block", "1", "--frames", "2"]
    out_t, out_j = tmp_path / "t.bin", tmp_path / "j.bin"
    assert cli.main(argv + tail + ["--device", "cpu", "-o", str(out_t),
                                   "test"]) == 0
    assert jcli.main(argv + tail + ["-o", str(out_j), "test"]) == 0
    got, ref = out_t.read_bytes(), out_j.read_bytes()
    assert len(got) == len(ref) > 0
    ndiff = np.count_nonzero(np.frombuffer(got, np.int16)
                             != np.frombuffer(ref, np.int16))
    assert got == ref, f"{ndiff} samples differ"


@pytest.mark.parametrize("argv", [
    ["-m", "l", "--videocrypt", "free"],
    ["-m", "pal", "--videocrypt", "free", "--videocrypt2", "conditional"],
    ["-m", "pal", "--videocrypt", "free", "--syster", "premiere-fa"],
    ["-m", "m", "--videocrypts", "free"],
    ["-m", "m", "--syster", "premiere-fa"],
    ["-m", "m", "--d11", "premiere-fa"],
    ["-m", "pal", "--acp", "--d11", "premiere-fa"],
], ids=lambda a: "".join(a[1:6]))
def test_cli_scrambler_exits_match_jax(tmp_path, argv):
    """The JAX command line's scrambler checks: the same exit message."""
    msgs = []
    for main in (cli.main, jcli.main):
        with pytest.raises(SystemExit) as e:
            main(argv + ["--frames", "1", "-o", str(tmp_path / "x.bin"),
                         "test"] + (["--device", "cpu"]
                                    if main is cli.main else []))
        msgs.append(str(e.value.code))
    assert msgs[0] == msgs[1] and msgs[0]


@pytest.mark.parametrize("argv", [
    ["-m", "d2mac-fm", "--eurocrypt", "ctv"],
    ["-m", "dmac", "--double-cut", "--scramble-audio"],
    ["-m", "d2mac-am", "--mac-audio-mono"],
    ["-m", "d2mac", "--single-cut", "--eurocrypt", "tv2", "--nodate",
     "--ec-mat-rating", "13", "--chid", "0x1234", "--mac-audio-linear",
     "--mac-audio-l2-protection", "--mac-audio-medium-quality"],
], ids=lambda a: "".join(a[1:5]))
def test_cli_mac_matches_jax_cli(tmp_path, argv):
    """The D/D2-MAC switches: the port's and the JAX package's command
    lines write the same bytes over two one-frame blocks at 20.25 MS/s
    (ctv and tv2 have fixed broadcast dates; the current day is read from
    the clock by both, back to back)."""
    tc.jax_runtime()
    tail = ["-s", "20250000", "--frames-per-block", "1", "--frames", "2"]
    out_t, out_j = tmp_path / "t.bin", tmp_path / "j.bin"
    assert cli.main(argv + tail + ["--device", "cpu", "-o", str(out_t),
                                   "test"]) == 0
    assert jcli.main(argv + tail + ["-o", str(out_j), "test"]) == 0
    got, ref = out_t.read_bytes(), out_j.read_bytes()
    assert len(got) == len(ref) > 0
    ndiff = np.count_nonzero(np.frombuffer(got, np.int16)
                             != np.frombuffer(ref, np.int16))
    assert got == ref, f"{ndiff} samples differ"


@pytest.mark.parametrize("argv", [
    ["-m", "pal", "--single-cut"],
    ["-m", "i", "--double-cut"],
    ["-m", "pal", "--eurocrypt", "filmnet"],
    ["-m", "d2mac", "--ec-mat-rating", "13"],
    ["-m", "d2mac", "--ec-ppv"],
    ["-m", "d2mac-fm", "--a2stereo"],
], ids=lambda a: "".join(a[1:4]))
def test_cli_mac_exits_match_jax(tmp_path, argv):
    """The JAX command line's MAC checks: the same exit message."""
    msgs = []
    for main in (cli.main, jcli.main):
        with pytest.raises(SystemExit) as e:
            main(argv + ["--frames", "1", "-o", str(tmp_path / "x.bin"),
                         "test"] + (["--device", "cpu"]
                                    if main is cli.main else []))
        msgs.append(str(e.value.code))
    assert msgs[0] == msgs[1] and msgs[0]


# -- moving inputs --------------------------------------------------------
FAKE = os.path.join(REPO, "tests", "data", "fake_ffmpeg.py")


def raw_clip(tmp_path, w=120, h=90, n=5):
    """A raw RGB32 file of n seeded moving frames with its .pcm sound;
    returns its raw: input spec."""
    src = tc.MovingSource(w, h, nframes=n, seed=9)
    px = np.stack([(f.astype(np.uint32) << np.array([16, 8, 0], np.uint32)
                    ).sum(-1, dtype=np.uint32) for f in src.frames])
    path = tmp_path / "clip.raw"
    px.tofile(path)
    src.noise[:40000].tofile(str(path) + ".pcm")
    return f"raw:{path}:{w}x{h}"


def both_clis(tmp_path, argv, inputs):
    """The port's and the JAX package's command lines on the same
    arguments and inputs; returns both outputs' bytes."""
    out_t, out_j = tmp_path / "t.bin", tmp_path / "j.bin"
    assert cli.main(argv + ["--device", "cpu", "-o", str(out_t)]
                    + inputs) == 0
    assert jcli.main(argv + ["-o", str(out_j)] + inputs) == 0
    return out_t.read_bytes(), out_j.read_bytes()


def assert_same_bytes(got, ref):
    assert len(got) == len(ref) > 0, (len(got), len(ref))
    ndiff = np.count_nonzero(np.frombuffer(got, np.int16)
                             != np.frombuffer(ref, np.int16))
    assert got == ref, f"{ndiff} samples differ"


@pytest.mark.parametrize("argv", [
    ["-m", "pal", "-s", "4000000", "--frames", "3"],
    ["-m", "pal", "-s", "4000000", "--fit", "fit", "--frames", "2",
     "--frames-per-block", "2"],
    ["-m", "pal", "-s", "4000000", "--letterbox", "--frames-per-block",
     "2"],
    ["-m", "pal", "-s", "4000000", "--pillarbox", "--fit", "fill",
     "--frames", "2"],
    ["-m", "pal", "-s", "4000000", "--fit", "fill", "--min-aspect",
     "14:9", "--max-aspect", "1.6", "--frames", "2"],
    ["-m", "i", "--filter", "--fit", "none", "--frames", "2",
     "--frames-per-block", "2"],
    ["-m", "secam", "-s", "4000000", "--frames", "2"],
], ids=["default", "fit", "letterbox-to-eof", "pillarbox-fill",
        "aspect-limits", "i-filter-none", "secam-one-frame-blocks"])
def test_cli_raw_input_matches_jax_cli(tmp_path, argv):
    """A raw: file (120x90, 5 frames, with sound) through the fit
    switches; without --frames the stream runs to the file's end (6
    frames in 2-frame blocks)."""
    if argv[1] == "i":
        tc.jax_runtime()
    got, ref = both_clis(tmp_path, argv, [raw_clip(tmp_path)])
    assert_same_bytes(got, ref)
    if "--frames" not in argv:
        # real output (no sound carrier at 4 MS/s): one int16 a sample
        assert len(got) == 6 * 160_000 * 2


@pytest.mark.parametrize("flags", [["-r"], ["--shuffle"],
                                   ["--repeat", "--shuffle"]])
def test_cli_repeat_shuffle_matches_jax_cli(tmp_path, flags):
    """Two raw: inputs of 3 and 2 frames, one-frame blocks, sequenced and
    looped or shuffled (RandomState(1)) over 12 frames."""
    for d in ("a", "b"):
        (tmp_path / d).mkdir()
    a = raw_clip(tmp_path / "a", n=3)
    b = raw_clip(tmp_path / "b", w=64, h=64, n=2)
    argv = ["-m", "pal", "-s", "4000000", "--frames", "12",
            "--frames-per-block", "1"] + flags
    got, ref = both_clis(tmp_path, argv, [a, b])
    assert_same_bytes(got, ref)


def test_cli_ffmpeg_input_matches_jax_cli(tmp_path, monkeypatch):
    """ffmpeg:PATH through a fake ffmpeg binary on PATH (probe, video and
    audio pipes, the in-stream A53 captions for --cc608) with --ffmt and
    --fopts: the same bytes, and the same ffmpeg calls."""
    bindir = tmp_path / "bin"
    bindir.mkdir()
    wrap = bindir / "ffmpeg"
    wrap.write_text(f"#!{sys.executable}\n" + open(FAKE).read())
    wrap.chmod(0o755)
    monkeypatch.setenv("PATH", f"{bindir}:{os.environ['PATH']}")
    calls = []
    outs = []
    for i, main in enumerate((cli.main, jcli.main)):
        d = tmp_path / str(i)
        d.mkdir()
        inp = d / "captioned.avi"
        inp.write_bytes(b"fake")
        out = d / "out.bin"
        argv = ["-m", "ntsc", "-s", "13500000", "--cc608", "--frames", "4",
                "--frames-per-block", "2", "--ffmt", "avi", "--fopts",
                "probesize=32", "-o", str(out), f"ffmpeg:{inp}"]
        assert main(argv + (["--device", "cpu"] if i == 0 else [])) == 0
        outs.append(out.read_bytes())
        calls.append(sorted((d / "captioned.avi.calls").read_text()
                            .replace(str(d), "").splitlines()))
    assert calls[0] == calls[1]
    assert any("-f avi -probesize 32 -i" in c for c in calls[0])
    assert_same_bytes(*outs)


def test_cli_avi_input_matches_jax_cli(tmp_path):
    """An MJPEG .avi as a bare path, decoded by OpenCV (no ffmpeg binary
    on PATH here), fitted with --fit fit."""
    cv2 = pytest.importorskip("cv2")
    import shutil
    if shutil.which("ffmpeg"):
        pytest.skip("an ffmpeg binary on PATH would take the input")
    avi = tmp_path / "m.avi"
    wr = cv2.VideoWriter(str(avi), cv2.VideoWriter_fourcc(*"MJPG"), 25,
                         (64, 48))
    for f in range(4):
        img = np.zeros((48, 64, 3), np.uint8)
        img[:, :, 2] = 50 * f + 20
        img[:, :32, 1] = 200
        wr.write(img)
    wr.release()
    got, ref = both_clis(tmp_path, ["-m", "pal", "-s", "4000000", "--fit",
                                    "fit", "--frames", "3"], [str(avi)])
    assert_same_bytes(got, ref)


def test_cli_mac_raw_input_matches_jax_cli(tmp_path):
    """D2-MAC from a raw: file: one-frame blocks, the MAC display pair
    4:3/16:9 in the fit."""
    tc.jax_runtime()
    got, ref = both_clis(tmp_path, ["-m", "d2mac", "-s", "20250000",
                                    "--frames", "2"], [raw_clip(tmp_path)])
    assert_same_bytes(got, ref)


def test_cli_verbose_version_profile(tmp_path, capsys):
    """-v prints the JAX command line's mode report and the file sink's
    counts; --version names the port; --profile writes a torch.profiler
    trace that names the program's spans, and the spans' record;
    --threads is accepted."""
    argv = ["-m", "pal", "-s", "4000000", "--frames", "1", "-v",
            "--threads"]
    assert cli.main(argv + ["--device", "cpu", "--profile",
                            str(tmp_path / "prof"), "-o",
                            str(tmp_path / "t.bin"), "test"]) == 0
    err_t = capsys.readouterr().err
    assert jcli.main(argv + ["-o", str(tmp_path / "j.bin"), "test"]) == 0
    err_j = capsys.readouterr().err
    head = lambda e: [ln for ln in e.splitlines()
                      if ln.split(":")[0] in ("Mode", "Video",
                                              "Sample rate")]
    assert head(err_t) == head(err_j) and len(head(err_t)) == 3
    assert "realtime" in err_t
    size = (tmp_path / "t.bin").stat().st_size
    assert f"file sink: {size} bytes in; converting " in err_t
    trace = (tmp_path / "prof" / "hacktv_tpu_torch_trace.json").read_text()
    assert "hacktv.dispatch.audio" in trace
    rec = json.loads((tmp_path / "prof" /
                      "hacktv_tpu_torch_spans.json").read_text())
    assert rec["counts"]["setup.encoder"] == 1
    assert rec["counts"]["dispatch"] == rec["counts"]["collect"] == 1
    assert rec["counters"]["uploads"] > 0
    assert rec["sink"]["bytes_in"] == size
    assert cli.main(["--version"]) == 0
    assert "hacktv_tpu_torch" in capsys.readouterr().out


@pytest.mark.parametrize("argv", [["--devices", "99"],
                                  ["--hosts", "2", "--host", "2",
                                   "--device", "cpu"]],
                         ids=lambda a: a[0].lstrip("-"))
def test_cli_unported_switches_refused(tmp_path, argv):
    """--devices past the cards present, and a --host index past
    --hosts, are refused with a message naming the switch, before any
    file is written (tests/test_torch_hosts.py holds the switches'
    output)."""
    with pytest.raises(SystemExit) as e:
        cli.main(argv + ["--frames", "1", "-o", str(tmp_path / "x.bin"),
                         "test"])
    assert isinstance(e.value.code, str) and argv[0] in e.value.code
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("argv", [["-f", "855250000", "-g", "47", "-A",
                                   "--antenna", "TX"],
                                  ["--fl2k-audio", "stereo"]],
                         ids=lambda a: a[0].lstrip("-"))
def test_cli_hw_switches_accepted(tmp_path, argv):
    """The hardware sinks' switches are accepted, and to a file they
    change nothing."""
    out = [tmp_path / "a.bin", tmp_path / "b.bin"]
    base = ["-m", "pal", "-s", "4000000", "--frames", "1", "--device",
            "cpu", "test"]
    assert cli.main(argv + base + ["-o", str(out[0])]) == 0
    assert cli.main(base + ["-o", str(out[1])]) == 0
    assert out[0].read_bytes() == out[1].read_bytes()


def test_cli_hackrf_without_library(tmp_path, monkeypatch):
    """-o hackrf where libhackrf cannot be found exits with the JAX
    command line's message and leaves no file named hackrf (it used to
    write one)."""
    from hacktv_tpu_torch.rf import hardware
    monkeypatch.setattr(hardware, "_find_lib", lambda names: None)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit) as e:
        cli.main(["-o", "hackrf", "-m", "pal", "-s", "4000000", "--frames",
                  "1", "--device", "cpu", "test"])
    assert "libhackrf" in str(e.value.code)
    assert not (tmp_path / "hackrf").exists()


def test_cli_module_hackrf_refused(tmp_path):
    """python -m hacktv_tpu_torch -o hackrf on a host with no HackRF
    exits non-zero naming libhackrf (or, where the library is installed,
    the device that did not answer), and writes no file."""
    r = subprocess.run(
        [sys.executable, "-m", "hacktv_tpu_torch", "-o", "hackrf", "-m",
         "i", "--frames", "1", "--device", "cpu", "test"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": REPO})
    assert r.returncode != 0
    assert "libhackrf" in r.stderr or "hackrf:" in r.stderr, r.stderr
    assert not (tmp_path / "hackrf").exists()
    assert os.listdir(tmp_path) == []


def _hw_clis(monkeypatch, argv, inputs=("test",), **lib_kw):
    """The port's and the JAX package's command lines on the same
    arguments and inputs, each with its own loop-back mock vendor library
    in place of the installed one: (port lib, JAX lib)."""
    from hacktv_tpu.rf import hardware as jhw
    from hacktv_tpu_torch.rf import hardware as thw
    libs = [tc.MockVendorLib(**lib_kw), tc.MockVendorLib(**lib_kw)]
    monkeypatch.setattr(thw, "_find_lib", lambda names: libs[0])
    monkeypatch.setattr(jhw, "_find_lib", lambda names: libs[1])
    assert cli.main(argv + ["--device", "cpu", *inputs]) == 0
    assert jcli.main(argv + [*inputs]) == 0
    return libs


def test_cli_hackrf_matches_jax_cli(monkeypatch, capsys):
    """-o hackrf:SERIAL with -f, -g, -A and -v: the same vendor calls and
    the same bytes pulled from the sink as the JAX command line, the
    whole stream of int8 pairs, then the zero-filled end of the last
    transfer; the same sink line at the end."""
    tc.jax_runtime()
    libs = _hw_clis(monkeypatch, [
        "-m", "i", "--frames", "2", "-o", "hackrf:0000", "-f", "855250000",
        "-g", "47", "-A", "-v"], transfer=262_144, max_transfers=64)
    # the sink writes a U for each underrun, with no newline
    sink_lines = [ln[ln.index("sink:"):] for ln in
                  capsys.readouterr().err.splitlines() if "sink:" in ln]
    # 2 frames are 2,560,000 bytes: the tenth transfer is 61,440 short
    assert sink_lines == ["sink: 1 underrun, longest 61440 bytes"] * 2
    assert libs[0].called == libs[1].called
    assert "hackrf_set_amp_enable" in libs[0].called
    got, ref = b"".join(libs[0].pulled), b"".join(libs[1].pulled)
    assert got == ref
    n = 2 * 640_000 * 2
    assert len(got) == -(-n // 262_144) * 262_144
    ref_iq = Encoder("i", 16_000_000, frames_per_block=2,
                     device="cpu").encode_block(0)
    assert got[:n] == (ref_iq.reshape(-1) >> 8).astype(np.int8).tobytes()
    assert got[n:] == bytes(len(got) - n)


def test_cli_fl2k_stereo_matches_jax_cli(tmp_path, monkeypatch):
    """-o fl2k --fl2k-audio stereo on a mode with sound, from a raw: file
    with its .pcm noise: the same vendor calls and the same R (video), G
    and B (the held, dithered 32 kHz sound) as the JAX command line."""
    tc.jax_runtime()
    libs = _hw_clis(monkeypatch, [
        "-m", "b", "-s", "2000000", "--frames", "3", "--frames-per-block",
        "1", "-o", "fl2k", "--fl2k-audio", "stereo"], [raw_clip(tmp_path)],
        transfer=100_000, max_transfers=4)
    assert libs[0].called == libs[1].called
    assert libs[0].pulled == libs[1].pulled
    for ch in range(3):
        assert len(set(b"".join(t[ch] for t in libs[0].pulled))) > 2
