"""The sinks' native plumbing and host helpers in the port against the JAX
package on the same seeded inputs: the six converters (every file type,
complex and real; HackRF int8, HackDAC 10-bit, FL2K channels), the FIFO's
prefill, EOF, abort and nowait reads, the FL2K dither over uneven
chunkings, StreamResampler fed in random chunks against the JAX one fed
whole, and the plain FileSink.  Tolerance: none, every comparison is
byte for byte."""

from __future__ import annotations

import numpy as np
import pytest

import _torch_common as tc
from hacktv_tpu.ops import resampler as jrs
from hacktv_tpu.rf import file as jfile
from hacktv_tpu_torch import runtime as trt
from hacktv_tpu_torch.ops import resampler as trs
from hacktv_tpu_torch.rf import file as tfile

DTYPES = ["uint8", "int8", "uint16", "int16", "int32", "float"]


def _iq(n=5000, seed=7):
    rng = np.random.default_rng(seed)
    iq = rng.integers(-32768, 32768, (n, 2)).astype(np.int16)
    # the extremes and the values around the conversions' edges
    iq[:8, 0] = [-32768, -32767, -1, 0, 1, 255, 256, 32767]
    iq[:8, 1] = [32767, 32766, -257, -256, -9000, -9001, -8999, 0]
    return iq


@pytest.fixture(scope="module")
def jrt():
    """The JAX package's runtime module, its library loaded."""
    tc.jax_runtime()
    from hacktv_tpu import runtime
    return runtime


@pytest.mark.parametrize("complex_out", [True, False],
                         ids=["complex", "real"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_convert_iq(jrt, dtype, complex_out):
    iq = _iq()
    got = trt.convert_iq(iq, dtype, complex_out)
    tc.assert_same(got, jrt.convert_iq(iq, dtype, complex_out))
    assert got.dtype == trt.TYPE_NP[dtype]


@pytest.mark.parametrize("sync_level", [-9000, 0, -32768])
def test_convert_hackrf_hackdac(jrt, sync_level):
    iq = _iq(seed=sync_level & 0xFF)
    tc.assert_same(trt.convert_hackrf_iq8(iq), jrt.convert_hackrf_iq8(iq))
    tc.assert_same(trt.convert_hackrf_iq8(iq.reshape(-1)),
                   jrt.convert_hackrf_iq8(iq.reshape(-1)))
    tc.assert_same(trt.convert_hackdac_bb(iq, sync_level),
                   jrt.convert_hackdac_bb(iq, sync_level))


@pytest.mark.parametrize("channel", [0, 1], ids=["I", "Q"])
def test_convert_fl2k(jrt, channel):
    iq = _iq(seed=3 + channel)
    tc.assert_same(trt.convert_fl2k_u8(iq, channel),
                   jrt.convert_fl2k_u8(iq, channel))


def _fifo_script(rt):
    """One sequence of FIFO calls and what each returned: nowait reads
    before the prefill, a crossing write, partial and whole reads, EOF on
    both read kinds, and an abort that unblocks and refuses."""
    out = []
    f = rt.Fifo(1024, 512)
    out.append(f.read(10, nowait=True))          # before the prefill
    out.append(f.write(b"a" * 300))
    out.append(f.read(10, nowait=True))          # still short of it
    out.append(f.level())
    out.append(f.write(np.arange(300, dtype=np.int16)))
    out.append(f.level())
    out.append(f.read(700, nowait=True))
    out.append(f.read(50, nowait=True))
    out.append(f.read(200))
    out.append(f.read(10, nowait=True))          # underrun, not EOF
    f.write(bytes(range(256)) * 3)
    f.close_writer()
    out.append(f.read(1000))
    out.append(f.read(10))                       # EOF
    out.append(f.read(10, nowait=True))          # nowait EOF: None
    g = rt.Fifo(64, 0)
    out.append(g.write(b"ab"))
    g.abort()
    out.append(g.read(2))                        # abort: None
    out.append(g.read(2, nowait=True))
    out.append(g.write(b"c"))                    # the writer refused
    return out


def test_fifo_prefill_eof_abort_nowait(jrt):
    got, ref = _fifo_script(trt), _fifo_script(jrt)
    assert got == ref
    assert got[0] == b"" and got[12] is None and got[14] is None


def test_fifo_blocking_writer_and_reader_threads():
    """A writer blocked on a full FIFO and a reader in another thread:
    every byte arrives in order, and the native calls release the
    interpreter lock (the reader runs while the writer waits)."""
    import threading
    f = trt.Fifo(1 << 12, 0)
    data = np.random.default_rng(1).integers(0, 256, 1 << 16,
                                             dtype=np.uint8).tobytes()
    got = []

    def reader():
        while True:
            b = f.read(700)
            if not b:
                return
            got.append(b)
    t = threading.Thread(target=reader)
    t.start()
    assert f.write(data) == len(data)
    f.close_writer()
    t.join(timeout=30)
    assert not t.is_alive()
    assert b"".join(got) == data


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fl2k_dither_uneven_chunks(jrt, seed):
    """The port's dither fed in random chunk sizes equals the JAX one fed
    the whole stream: the error carries across calls."""
    rng = np.random.default_rng(seed)
    pcm = rng.integers(-32768, 32768, 20_000).astype(np.int16)
    ref = jrt.Fl2kDither().process(pcm)
    d = trt.Fl2kDither()
    cuts = np.sort(rng.choice(np.arange(1, len(pcm)), 40, replace=False))
    got = np.concatenate([d.process(c) for c in np.split(pcm, cuts)])
    tc.assert_same(got, ref)
    # interleaved stereo through the stride
    st = rng.integers(-32768, 32768, (3000, 2)).astype(np.int16)
    tc.assert_same(trt.Fl2kDither().process(st.reshape(-1), 2),
                   jrt.Fl2kDither().process(st.reshape(-1), 2))


# (out rate, in rate): HackDAC's audio (rate/64 from 32 kHz) and FL2K's
# S/PDIF bitstream (the DAC rate from 5 x 4.096 MHz)
RATES = {"hackdac-2m": ((2_000_000, 64), (32000, 1)),
         "hackdac-16m": ((16_000_000, 64), (32000, 1)),
         "spdif-16m": ((16_000_000, 1), (32000 * 128 * 5, 1)),
         "spdif-4096k": ((4_096_000, 1), (32000 * 128 * 5, 1))}


@pytest.mark.parametrize("name", list(RATES))
def test_stream_resampler_chunks(name):
    """StreamResampler fed in random chunk sizes (empty chunks and
    chunks shorter than a window among them) equals the JAX package's
    fed the whole input at once."""
    out_rate, in_rate = RATES[name]
    rng = np.random.default_rng(len(name))
    x = rng.integers(-32768, 32768, 6000).astype(np.int16)
    jr = jrs.StreamResampler(jrs.Resampler.create(out_rate, in_rate))
    ref = jr.process(x)
    rs = trs.Resampler.create(out_rate, in_rate)
    assert (rs.L, rs.M, rs.A) == (jr.rs.L, jr.rs.M, jr.rs.A)
    tr = trs.StreamResampler(rs)
    sizes = rng.integers(0, 300, 60)
    cuts = np.cumsum(sizes)
    cuts = cuts[cuts < len(x)]
    got = np.concatenate([tr.process(c) for c in np.split(x, cuts)])
    tc.assert_same(got, ref)
    assert (tr.n_in, tr.m) == (jr.n_in, jr.m)


@pytest.mark.parametrize("complex_out", [True, False],
                         ids=["complex", "real"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_file_sink(tmp_path, dtype, complex_out):
    """The port's plain FileSink writes the JAX FileSink's bytes, and
    the native sink's (what the command line writes)."""
    iq = _iq(seed=11)
    paths = []
    for i, sink in enumerate((tfile.FileSink, jfile.FileSink,
                              trt.NativeFileSink)):
        p = tmp_path / f"{i}.bin"
        s = sink(str(p), dtype, complex_out)
        s.write(iq)
        s.write(iq[:77])
        s.close()
        paths.append(p.read_bytes())
    assert paths[0] == paths[1] == paths[2]
    assert len(paths[0]) == (5077 * (2 if complex_out else 1)
                             * np.dtype(trt.TYPE_NP[dtype]).itemsize)


def test_file_sink_refuses_unknown_type(tmp_path):
    with pytest.raises(ValueError):
        tfile.FileSink(str(tmp_path / "x.bin"), "int12")
