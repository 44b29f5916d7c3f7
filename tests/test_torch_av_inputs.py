"""The port's moving-video inputs (av/) against hacktv_tpu's on the same
inputs: frames, audio and caption pairs equal.  The ffmpeg source runs
its whole probe-and-pipe path through tests/data/fake_ffmpeg.py (PAR,
native size, the video and audio pipes, --ffmt/--fopts, the .cc608
side-car, in-stream A53 captions); the three A53 parsers (MPEG-2, H.264,
H.265); the OpenCV source on an MJPEG .avi (where cv2 is installed); the
raw RGB32 file source with its side-cars and last-frame clamp; and the
input sequence with --repeat, --shuffle and the audio splice."""

from __future__ import annotations

import os
import sys
from fractions import Fraction

import numpy as np
import pytest

import _torch_common as tc
from hacktv_tpu.av import a53 as ja53
from hacktv_tpu.av import ffmpeg as jff
from hacktv_tpu.av import rawfile as jraw
from hacktv_tpu.av import sequence as jseq
from hacktv_tpu_torch.av import a53 as ta53
from hacktv_tpu_torch.av import ffmpeg as tff
from hacktv_tpu_torch.av import rawfile as traw
from hacktv_tpu_torch.av import sequence as tseq

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")
FAKE = os.path.join(DATA, "fake_ffmpeg.py")
sys.path.insert(0, DATA)
from fake_ffmpeg import mpeg2_es_fixture  # noqa: E402


def ff_pair(tmp_path, name="in.avi", **kw):
    """The port's FFmpegSource and the JAX package's on one fake input."""
    inp = tmp_path / name
    inp.write_bytes(b"fake")
    return [mod.FFmpegSource(str(inp), 702, 576,
                             binary=[sys.executable, FAKE], **kw)
            for mod in (tff, jff)]


def drain(src, frames=7, pairs=(0, 1000, 1280, 4000)):
    """Frames 0..frames-1 (past the end), audio windows and caption
    pairs of a source, with its eof flags."""
    out = {"frames": [], "eof": [], "cc": []}
    for n in range(frames):
        out["frames"].append(np.array(src.read_video(n)))
        out["eof"].append(bool(src.eof(n)))
    out["audio"] = [np.array(src.read_audio(s, 200)) for s in pairs]
    out["cc"] = [src.read_cc608(n) for n in range(frames)]
    return out


def test_ffmpeg_probe(tmp_path):
    """One probe run: PAR 16:11, audio present, native 64x48, MPEG-2 for
    the captioned input; and the input options."""
    b = [sys.executable, FAKE]
    for name in ("in.avi", "captioned.avi"):
        inp = tmp_path / name
        inp.write_bytes(b"fake")
        got = tff._probe(b, str(inp))
        assert got == jff._probe(b, str(inp))
        assert got[:4] == (Fraction(16, 11), True, 64, 48)
    assert got[4] == "mpeg2video"
    assert tff._input_args("x", "mpegts", "a=1:b=2") == \
        jff._input_args("x", "mpegts", "a=1:b=2")
    t, j = ff_pair(tmp_path)
    assert t.pixel_aspect_ratio == j.pixel_aspect_ratio
    assert (t.width, t.height) == (j.width, j.height) == (64, 48)
    t.close()
    j.close()


def test_ffmpeg_pipes_match(tmp_path):
    t, j = ff_pair(tmp_path)
    tc.assert_same(drain(t), drain(j))
    t.close()
    j.close()


def test_ffmpeg_ffmt_fopts(tmp_path):
    """--ffmt/--fopts reach every ffmpeg call as input options, the same
    calls the JAX package makes.  The video and audio children append to
    the .calls file in whichever order they run, so the lines are
    compared sorted."""
    calls = []
    for i, mod in enumerate((tff, jff)):
        d = tmp_path / str(i)
        d.mkdir()
        inp = d / "in.avi"
        inp.write_bytes(b"fake")
        src = mod.FFmpegSource(str(inp), 702, 576,
                               binary=[sys.executable, FAKE],
                               ffmt="rawvideo",
                               fopts="video_size=64x48:pixel_format=bgra")
        src.read_video(0)
        src.read_audio(0, 10)
        src.close()
        calls.append(sorted((d / "in.avi.calls").read_text()
                            .replace(str(d), "").splitlines()))
    assert calls[0] == calls[1]
    assert any("-f rawvideo -video_size 64x48 -pixel_format bgra -i" in c
               for c in calls[0])


def test_ffmpeg_cc608_sidecar(tmp_path):
    (tmp_path / "in.avi.cc608").write_bytes(bytes([0x14, 0x2C, 0x80,
                                                   0x80, 0x21]))
    t, j = ff_pair(tmp_path)
    got = [t.read_cc608(n) for n in range(4)]
    assert got == [j.read_cc608(n) for n in range(4)]
    assert got[:3] == [(0x14, 0x2C), (0x80, 0x80), (0, 0)]
    t.close()
    j.close()


def test_ffmpeg_in_stream_a53(tmp_path):
    """No side-car: captions from the codec-copied elementary stream,
    one pair a frame, as the reference's FIFO drains."""
    t, j = ff_pair(tmp_path, "captioned.avi")
    got = [t.read_cc608(n) for n in range(7)]
    assert got == [j.read_cc608(n) for n in range(7)]
    assert got[:5] == [(0x20 + n, 0x40 + n) for n in range(5)]
    t.close()
    j.close()


def test_open_video_source_fallback(tmp_path, monkeypatch):
    """Without an ffmpeg binary, --ffmt/--fopts exit with the JAX
    package's message."""
    for mod in (tff, jff):
        monkeypatch.setattr(mod.shutil, "which", lambda _: None)
    msgs = []
    for mod in (tff, jff):
        with pytest.raises(SystemExit) as e:
            mod.open_video_source(str(tmp_path / "x.avi"), 702, 576,
                                  ffmt="mpegts")
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def _sei(nal_head: bytes, cc: bytes) -> bytes:
    t35 = bytes([0xB5, 0x00, 0x31]) + b"GA94\x03" + bytes([0x41, 0xFF]) + cc
    return b"\x00\x00\x01" + nal_head + bytes([4, len(t35)]) + t35 + b"\x80"


@pytest.mark.parametrize("codec", ["mpeg2video", "h264", "hevc"])
def test_a53_parsers(codec):
    """Each codec's stream, fed in awkward chunks and whole: the same
    pairs and picture counts from both parsers."""
    if codec == "mpeg2video":
        es = mpeg2_es_fixture()
    elif codec == "h264":
        es = (_sei(b"\x06", bytes([0xFC, 0x31, 0x51]))
              + b"\x00\x00\x01\x65" + b"\xAA" * 6
              + _sei(b"\x06", bytes([0xFC, 0x32, 0x52, 0xFD, 0x01, 0x02]))
              + b"\x00\x00\x01\x41" + b"\x00\x00\x03\x01" * 3)
    else:
        es = (_sei(bytes([39 << 1, 0x01]), bytes([0xFC, 0x33, 0x53]))
              + b"\x00\x00\x01" + bytes([19 << 1, 0x01]) + b"\xAA" * 6
              + b"\x00\x00\x01" + bytes([19 << 1, 0x01]) + b"\x2A" * 6
              + b"\x00\x00\x01" + bytes([1 << 1, 0x01]) + b"\xBB" * 4)
    for step in (7, len(es)):
        res = []
        for mod in (ta53, ja53):
            p = mod.A53ESParser(codec)
            pairs = []
            for i in range(0, len(es), step):
                pairs += p.feed(es[i:i + step])
            pairs += p.feed(b"", final=True)
            res.append((pairs, p.pictures))
        assert res[0] == res[1]
        assert res[0][0], "no caption pairs"
    with pytest.raises(ValueError):
        ta53.A53ESParser("vp9")


def test_opencv_source(tmp_path):
    cv2 = pytest.importorskip("cv2")
    from hacktv_tpu.av.videofile import OpenCVSource as JCV
    from hacktv_tpu_torch.av.videofile import OpenCVSource as TCV
    avi = tmp_path / "m.avi"
    wr = cv2.VideoWriter(str(avi), cv2.VideoWriter_fourcc(*"MJPG"), 25,
                         (64, 48))
    for f in range(6):
        img = np.zeros((48, 64, 3), np.uint8)
        img[:, :, 2] = 40 * f + 20
        img[:, :, 0] = np.arange(64, dtype=np.uint8)[None, :] * 3
        wr.write(img)
    wr.release()
    np.arange(4000, dtype=np.int16).tofile(str(avi) + ".pcm")
    (tmp_path / "m.avi.cc608").write_bytes(bytes([0x14, 0x20, 0x41, 0x42]))
    for rate in ((25, 1), (50, 1), (30000, 1001)):
        t = TCV(str(avi), 702, 576, frame_rate=rate)
        j = JCV(str(avi), 702, 576, frame_rate=rate)
        assert (t.width, t.height) == (j.width, j.height) == (64, 48)
        assert t.pixel_aspect_ratio == j.pixel_aspect_ratio
        tc.assert_same(drain(t, 9), drain(j, 9))
        t.close()
        j.close()


def _raw_file(tmp_path, n=4, w=40, h=30, pcm=True, cc=True):
    rng = np.random.default_rng(3)
    px = rng.integers(0, 1 << 32, (n, h, w), dtype=np.uint64
                      ).astype(np.uint32)
    path = tmp_path / "clip.raw"
    px.tofile(path)
    if pcm:
        rng.integers(-30000, 30000, 2 * 3000 + 1, dtype=np.int16
                     ).tofile(str(path) + ".pcm")
    if cc:
        (tmp_path / "clip.raw.cc608").write_bytes(bytes([0x14, 0x20, 0x41]))
    return str(path), px


@pytest.mark.parametrize("spec", ["sized", "default"])
def test_raw_file_source(tmp_path, spec):
    """raw:PATH[:WxH]: frames unpacked from 0xAARRGGBB, clamped to the
    last frame, the .pcm side-car (odd sample dropped) and the .cc608
    pairs."""
    path, px = _raw_file(tmp_path)
    arg = f"{path}:40x30" if spec == "sized" else path
    size = (702, 576) if spec == "sized" else (40, 30)
    t = traw.RawFileSource(arg, *size)
    j = jraw.RawFileSource(arg, *size)
    assert (t.width, t.height, t.n_frames) == (j.width, j.height,
                                               j.n_frames) == (40, 30, 4)
    got = drain(t)
    tc.assert_same(got, drain(j))
    assert got["frames"][6][0, 0, 0] == (px[3, 0, 0] >> 16) & 0xFF
    assert got["eof"] == [False] * 4 + [True] * 3
    t.close()
    j.close()


class _Clip:
    """An index-addressed clip of n frames that knows its end."""

    interlaced = 0

    def __init__(self, tag, n, w=16, h=8):
        self.width, self.height, self.n = w, h, n
        self.tag = tag

    def read_video(self, k):
        return np.full((self.height, self.width, 3), 10 * self.tag + k,
                       np.uint8)

    def read_audio(self, start, count):
        return np.full((count, 2), 1000 * self.tag, np.int16) + \
            np.arange(start, start + count, dtype=np.int16)[:, None]

    def read_cc608(self, k):
        return (self.tag, k)

    def eof(self, k):
        return k >= self.n

    def close(self):
        pass


@pytest.mark.parametrize("repeat,shuffle", [(False, False), (True, False),
                                            (True, True), (False, True)])
def test_sequence_source(repeat, shuffle):
    """Three inputs of 3, 2 and 4 frames: the frame timeline across the
    switches, the audio spliced where each input starts, the caption
    pairs of the active input, the shuffle's RandomState order and the
    held last frame after the list ends."""
    res = []
    for mod in (tseq, jseq):
        s = mod.SequenceSource([lambda i=i, n=n: _Clip(i, n)
                                for i, n in ((1, 3), (2, 2), (3, 4))],
                               repeat=repeat, shuffle=shuffle, seed=4)
        out = []
        for k in range(20):
            f = s.read_video(k)
            out.append((int(f[0, 0, 0]), s.read_cc608(k), bool(s.eof(k)),
                        s.read_audio(k * 1280, 3).tolist()))
        s.close()
        res.append(out)
    assert res[0] == res[1]
