"""The port's command line (python -m hacktv_tpu_torch): its file output
equals Encoder.encode_block byte for byte, PAL-I with NICAM included, and
it refuses what it does not cover."""

from __future__ import annotations

import os
import subprocess
import sys
from dataclasses import replace

import numpy as np
import pytest
import torch

import _torch_common  # noqa: F401  (thread cap)
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
    (["--teletext", "x"], SystemExit),          # switch not in the subset
    (["-m", "d2mac-fm"], NotImplementedError),  # MAC
    (["-m", "pal", "clip.mp4"], NotImplementedError),
])
def test_cli_refuses(argv, exc, tmp_path):
    with pytest.raises(exc):
        cli.main(argv + ["--frames", "1", "--device", "cpu", "-o",
                         str(tmp_path / "x.bin")])
