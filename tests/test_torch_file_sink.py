"""The port's file sink (runtime.NativeFileSink) borrows the arrays it is
handed: its writer thread writes them after `write` has returned, so each
array must outlive its caller's reference.  Seeded arrays dropped at once
while new ones are allocated and overwritten still reach the file whole
and in order; an IO error on the writer thread raises OSError at a later
write or at close; the bytes in flight stay within the bound plus one
write; int16 complex output is written from the caller's array with no
conversion, and every other type or real output is converted on the
writer thread.  On the CPU."""

from __future__ import annotations

import os
import sys
import threading

import numpy as np
import pytest

from hacktv_tpu_torch import runtime, telemetry

WRITES = 50


def _file_bytes(arrays, dtype: str, complex_out: bool) -> bytes:
    return b"".join(runtime.convert_iq(a, dtype, complex_out).tobytes()
                    for a in arrays)


@pytest.mark.parametrize("dtype,complex_out", [("int16", True),
                                               ("float", False)])
def test_borrowed_arrays_outlive_their_caller(tmp_path, monkeypatch, dtype,
                                              complex_out):
    """50 seeded arrays, each handed to `write` and dropped at once, while
    arrays of the same sizes are allocated and overwritten between the
    writes and on another thread (a short switch interval), under a 1-MB
    bound so that writes wait for room: the file is their concatenation.
    Every fifth array is a strided view, which the sink copies."""
    monkeypatch.setattr(runtime, "SINK_FIFO_BYTES", 1 << 20)
    rng = np.random.default_rng(27)
    sizes = rng.integers(1, 300_000, WRITES)
    seeds = rng.integers(0, 2**32, WRITES)
    make = lambda i: np.random.default_rng(seeds[i]).integers(
        -32768, 32768, (sizes[i], 2)).astype(np.int16)
    stop = threading.Event()

    def churn():
        while not stop.is_set():
            for n in sizes[:8]:
                np.full((n, 2), -1, np.int16)
    path = tmp_path / "out.bin"
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    th = threading.Thread(target=churn)
    th.start()
    try:
        s = runtime.NativeFileSink(str(path), dtype, complex_out)
        for i in range(WRITES):
            if i % 5 == 4:
                wide = np.repeat(make(i), 2, axis=0)
                s.write(wide[::2])
                wide[:] = 7
                del wide
            else:
                s.write(make(i))
            junk = np.empty((sizes[i], 2), np.int16)
            junk.fill(12345)
            del junk
        s.close()
    finally:
        stop.set()
        th.join(timeout=30)
        sys.setswitchinterval(switch)
    assert not th.is_alive()
    want = _file_bytes([make(i) for i in range(WRITES)], dtype, complex_out)
    got = path.read_bytes()
    assert len(got) == len(want)
    assert got == want
    st = s.stats()
    largest = max(sizes) * (8 if dtype == "float" and complex_out else 4)
    assert st["peak_bytes"] <= (1 << 20) + largest


def test_io_error_raises_at_a_later_write_or_close():
    """Writes to /dev/full fail on the writer thread: OSError at a later
    `write` or at `close`, and the sink is closed either way."""
    if not os.path.exists("/dev/full"):
        pytest.skip("no /dev/full on this system")
    a = np.ones((300_000, 2), np.int16)
    s = runtime.NativeFileSink("/dev/full")

    def drain():
        try:
            for _ in range(8):
                s.write(a)
        finally:
            s.close()
    with pytest.raises(OSError):
        drain()
    assert s._h is None and not s._held


@pytest.mark.parametrize("dtype,complex_out", [("int16", True),
                                               ("int16", False),
                                               ("float", True),
                                               ("float", False)])
def test_counts_by_output_type(tmp_path, dtype, complex_out):
    """int16 complex output borrows every write and converts nothing; any
    other output converts every write on the writer thread.  The most
    bytes in flight stay within the bound plus the largest write, the
    telemetry counters count the writes by kind, and the arrays are
    released once written."""
    rng = np.random.default_rng(3)
    blocks = [rng.integers(-32768, 32768, (n, 2)).astype(np.int16)
              for n in (200_000, 5, 90_001)]
    c0 = telemetry.counters()
    s = runtime.NativeFileSink(str(tmp_path / "o.bin"), dtype, complex_out)
    for b in blocks:
        s.write(b)
    s.close()
    st = s.stats()
    c1 = telemetry.counters()
    grew = {k: c1.get(k, 0) - c0.get(k, 0)
            for k in ("sink.borrowed", "sink.converted")}
    borrowed = dtype == "int16" and complex_out
    assert st["borrowed"] == (len(blocks) if borrowed else 0)
    assert grew == ({"sink.borrowed": 3, "sink.converted": 0} if borrowed
                    else {"sink.borrowed": 0, "sink.converted": 3})
    assert (st["convert_ns"] == 0) if borrowed else (st["convert_ns"] > 0)
    size = (tmp_path / "o.bin").stat().st_size
    assert st["bytes_in"] == size
    assert (tmp_path / "o.bin").read_bytes() == _file_bytes(
        blocks, dtype, complex_out)
    per = (2 if complex_out else 1) * (4 if dtype == "float" else 2)
    assert 0 < st["peak_bytes"] <= runtime.SINK_FIFO_BYTES + 200_000 * per
    assert not s._held
