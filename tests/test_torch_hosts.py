"""The port's command line with --devices and --hosts/--host on the CPU,
as tests/test_multichip.py holds hacktv_tpu's: `--devices 2 --device
cpu` writes the bytes of one device; two `--hosts 2` processes (the
index from --host or from $HACKTV_HOST_ID) write, once process 0 has
joined their parts, the bytes of one process, and leave no part behind;
each refusal exits with hacktv_tpu's message."""

from __future__ import annotations

import os
import subprocess
import sys

import pytest
import torch

from hacktv_tpu import cli as jcli
from hacktv_tpu_torch import cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = ["-m", "i", "-s", "1000000", "--frames", "6", "--frames-per-block",
        "2", "--device", "cpu", "test"]


def test_cli_devices_byte_identical(tmp_path):
    outs = []
    for flag in ([], ["--devices", "2"]):
        out = tmp_path / f"pal{len(flag)}.c16"
        assert cli.main(["-o", str(out)] + flag + BASE) == 0
        outs.append(out.read_bytes())
    assert len(outs[0]) == 6 * 40000 * 4
    assert outs[0] == outs[1], "sharded CLI output differs"


@pytest.mark.parametrize("index", ["flag", "env"])
def test_cli_hosts_byte_identical(tmp_path, index):
    """Two processes, one block range each; the index of each from
    --host, or from $HACKTV_HOST_ID."""
    env = {**os.environ, "PYTHONPATH": REPO,
           "OMP_NUM_THREADS": str(torch.get_num_threads())}
    single = tmp_path / "single.c16"
    assert cli.main(["-o", str(single)] + BASE) == 0
    multi = tmp_path / "multi.c16"
    procs = []
    for i in range(2):
        argv = [sys.executable, "-m", "hacktv_tpu_torch", "-o", str(multi),
                "--hosts", "2"] + BASE
        penv = dict(env)
        if index == "flag":
            argv[-len(BASE):-len(BASE)] = ["--host", str(i)]
        else:
            penv["HACKTV_HOST_ID"] = str(i)
        procs.append(subprocess.Popen(argv, cwd=tmp_path, env=penv,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"host {i} failed:\n{out}"
    assert single.read_bytes() == multi.read_bytes(), \
        "multi-host stream differs from the single-process run"
    assert sorted(os.listdir(tmp_path)) == ["multi.c16", "single.c16"]


@pytest.mark.parametrize("argv", [
    ["-m", "i", "-s", "1000000", "--hosts", "2", "-o", "{}", "test"],
    ["-m", "i", "-s", "1000000", "--frames", "2", "--hosts", "2",
     "--host", "2", "-o", "{}", "test"],
    ["-m", "i", "-s", "1000000", "--frames", "2", "--hosts", "2", "-o",
     "-", "test"],
    ["-m", "i", "-s", "1000000", "--frames", "2", "--hosts", "2", "-o",
     "hackrf", "test"],
    ["-m", "d2mac", "-s", "20250000", "--frames", "2", "--hosts", "2",
     "-o", "{}", "test"],
], ids=["no-finite-stream", "host-out-of-range", "stdout", "hackrf",
        "mac"])
def test_cli_hosts_refusals_match_jax(tmp_path, argv):
    """Each refusal exits non-zero with hacktv_tpu's message, and no
    file is written."""
    argv = [a.replace("{}", str(tmp_path / "x.bin")) for a in argv]
    msgs = []
    for main, extra in ((cli.main, ["--device", "cpu"]), (jcli.main, [])):
        with pytest.raises(SystemExit) as e:
            main(extra + argv)
        msgs.append(e.value.code)
    assert isinstance(msgs[0], str) and msgs[0] == msgs[1], msgs
    assert os.listdir(tmp_path) == []
