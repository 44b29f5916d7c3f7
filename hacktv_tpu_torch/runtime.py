"""The native host runtime (native/hacktv_rt.cpp), built and bound by the
port itself.

Port of the parts of hacktv_tpu/runtime that the port calls: the exact
serial FM carrier (`FmCarrierExact`, the reference's int32 phasor
recurrence), the SECAM host-exact chroma kernels (`rt_fir_block_i16`,
`rt_iir1_exact_i16`, `rt_secam_carrier_exact`, called from
video/secam.py), the scramblers' PRBS recurrences (`vc_clock16`, the
Videocrypt cut bytes, and `ng_event`, the Syster shuffle's PRBS event and
permutation, called from services/), the MAC host coders (`rt_mac_prbs1`
and `rt_mac_prbs2`, the CA keystreams, and `rt_mac_encode_packet`, called
from ops/mac_bits.py; `rt_mac_audio_blocks`, the sound coding blocks,
from audio/mac_audio.py; `rt_mac_mux_replay_packed` and
`rt_mac_materialize_packed`, the packet multiplex and the line bits, from
video/mac.py), the NICAM-728 frame coder (`rt_nicam_encode_frames`, SiS's
coder, from audio/nicam.py), the threaded file sink (`NativeFileSink`,
which borrows each block its caller writes and writes it from its own
thread), and the hardware sinks' plumbing (rf/hardware.py): the byte
FIFO with its prefill and EOF (`Fifo`, the reference's src/fifo.c), the
sample-format converters (`convert_iq`, `convert_hackrf_iq8`,
`convert_hackdac_bb`, `convert_fl2k_u8`) and the FL2K audio dither
(`Fl2kDither`).

The library is compiled with g++ (the flags of native/Makefile) from
the port's `csrc/hacktv_rt_port.cpp`, which includes the repo's
`native/hacktv_rt.cpp` whole and adds the port's file sink
(`rt_port_sink_*`), into `hacktv_tpu_torch/_build/` at first use, to a
temporary file renamed into place so that concurrent processes never
load a half-written library, and rebuilt when older than either
source.  Nothing is written into `native/`.  A missing compiler, a failed
build or a failed load raises: no caller falls back to another path.

`$HACKTV_RT_DIR`, read at import, points the loader at another build (a
TSAN or ASAN one): the directory's `libhacktv_rt.so` is loaded, and
compiled there from `csrc/hacktv_rt_port.cpp` over the directory's
`hacktv_rt.cpp` only when missing or older than those sources, so a
library made there from `hacktv_rt.cpp` alone lacks the port's file sink
and fails to load.  A directory that holds neither file raises, naming it.
"""

from __future__ import annotations

import collections
import ctypes
import fcntl
import os
import shutil
import subprocess
import tempfile
import threading

import numpy as np

from . import telemetry
from .ops.cuda_build import BUILD_DIR

RT_DIR = os.environ.get("HACKTV_RT_DIR") or None
if RT_DIR:
    SRC_PATH = os.path.abspath(os.path.join(RT_DIR, "hacktv_rt.cpp"))
    LIB_PATH = os.path.abspath(os.path.join(RT_DIR, "libhacktv_rt.so"))
else:
    SRC_PATH = os.path.abspath(os.path.join(
        os.path.dirname(os.path.abspath(__file__)), os.pardir, "native",
        "hacktv_rt.cpp"))
    LIB_PATH = os.path.join(BUILD_DIR, "libhacktv_rt.so")
PORT_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                        "hacktv_rt_port.cpp")
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-pthread"]

SINK_FIFO_BYTES = 64 << 20     # the file sink's bytes in flight between threads
# rt_type enum (native/hacktv_rt.cpp)
TYPE_IDS = {"uint8": 0, "int8": 1, "uint16": 2, "int16": 3, "int32": 4,
            "float": 5}
TYPE_NP = {"uint8": np.uint8, "int8": np.int8, "uint16": np.uint16,
           "int16": np.int16, "int32": np.int32, "float": np.float32}

_lock = threading.Lock()
_lib = None


def _stale() -> bool:
    if not (os.path.exists(LIB_PATH) or os.path.exists(SRC_PATH)):
        raise RuntimeError(
            f"native runtime: neither {LIB_PATH} nor {SRC_PATH} exists"
            + (f" (HACKTV_RT_DIR={RT_DIR})" if RT_DIR else ""))
    return not (os.path.exists(LIB_PATH)
                and os.path.getmtime(LIB_PATH) >= max(
                    os.path.getmtime(SRC_PATH), os.path.getmtime(PORT_SRC)))


def build() -> bool:
    """Compile the library if it is missing or older than its source;
    True if this call compiled it.  One process compiles at a time (a lock
    file beside the library); the result is renamed into place."""
    if not _stale():
        return False
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError(f"g++ not found: the native runtime is built "
                           f"from {SRC_PATH} at first use")
    lib_dir = os.path.dirname(LIB_PATH)
    os.makedirs(lib_dir, exist_ok=True)
    with open(os.path.join(lib_dir, ".hacktv_rt.lock"), "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        if not _stale():             # another process built it meanwhile
            return False
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=lib_dir)
        os.close(fd)
        try:
            r = subprocess.run([cxx, *CXX_FLAGS, "-I",
                                os.path.dirname(SRC_PATH), "-o", tmp,
                                PORT_SRC], capture_output=True, text=True)
            if r.returncode != 0:
                raise RuntimeError(f"g++ failed on {PORT_SRC} over "
                                   f"{SRC_PATH}:\n"
                                   + r.stderr[-4000:])
            os.replace(tmp, LIB_PATH)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return True


def load() -> ctypes.CDLL:
    """The loaded native runtime, built if needed; raises on failure."""
    global _lib
    with _lock:
        if _lib is None:
            with telemetry.span("setup.native"):
                build()
                lib = ctypes.CDLL(LIB_PATH)
                _declare(lib)
            _lib = lib
        return _lib


def _declare(lib) -> None:
    c = ctypes
    p = c.c_void_p
    lib.rt_fm_carrier_exact.restype = None
    lib.rt_fm_carrier_exact.argtypes = [p, p, c.c_size_t, p, c.c_int32, p]
    lib.rt_fir_block_i16.restype = None
    lib.rt_fir_block_i16.argtypes = [p, c.c_long, c.c_long, p, c.c_long, p,
                                     c.c_int]
    lib.rt_iir1_exact_i16.restype = None
    lib.rt_iir1_exact_i16.argtypes = [p, c.c_size_t, c.c_double,
                                      c.c_double, c.c_double, p, p]
    lib.rt_secam_carrier_exact.restype = None
    lib.rt_secam_carrier_exact.argtypes = [
        p, c.c_long, c.c_long, c.c_long, p, p, p, p, c.c_int32, p, p,
        c.c_int]
    lib.rt_vc_clock16.restype = None
    lib.rt_vc_clock16.argtypes = [p, c.c_long, p]
    lib.rt_ng_event.restype = None
    lib.rt_ng_event.argtypes = [p, p, p]
    for name in ("rt_mac_prbs1", "rt_mac_prbs2"):
        getattr(lib, name).restype = None
        getattr(lib, name).argtypes = [p, c.c_long, p]
    lib.rt_mac_encode_packet.restype = None
    lib.rt_mac_encode_packet.argtypes = [c.c_int, c.c_int, p, c.c_int,
                                         c.c_uint64, p]
    lib.rt_mac_audio_blocks.restype = None
    lib.rt_mac_audio_blocks.argtypes = [
        p, c.c_long, c.c_long, c.c_int, c.c_int, c.c_int, p, c.c_int,
        c.c_int, p, p, p, p, p]
    lib.rt_mac_mux_replay_packed.restype = None
    lib.rt_mac_mux_replay_packed.argtypes = [
        c.c_long, p, p, p, p, p, p, p, p, p, p, p, p, c.c_int64, p,
        c.c_int64, p, p, c.c_int]
    lib.rt_nicam_encode_frames.restype = None
    lib.rt_nicam_encode_frames.argtypes = [
        p, c.c_long, p, c.c_int, p, p, p, p, c.c_long, c.c_int, c.c_int, p]
    lib.rt_mac_materialize_packed.restype = None
    lib.rt_mac_materialize_packed.argtypes = [
        c.c_long, c.c_long, c.c_long, p, p, c.c_int, p, p, p, p, p, p, p,
        p, c.c_int]
    lib.rt_port_sink_open.restype = p
    lib.rt_port_sink_open.argtypes = [c.c_char_p, c.c_int, c.c_int,
                                      c.c_size_t]
    lib.rt_port_sink_submit.restype = c.c_int64
    lib.rt_port_sink_submit.argtypes = [p, p, c.c_size_t]
    lib.rt_port_sink_done.restype = c.c_int64
    lib.rt_port_sink_done.argtypes = [p]
    lib.rt_port_sink_counts.restype = None
    lib.rt_port_sink_counts.argtypes = [p, p]
    lib.rt_port_sink_close.restype = c.c_long
    lib.rt_port_sink_close.argtypes = [p, p]
    lib.rt_fifo_create.restype = p
    lib.rt_fifo_create.argtypes = [c.c_size_t, c.c_size_t]
    for name in ("rt_fifo_destroy", "rt_fifo_close_writer",
                 "rt_fifo_abort"):
        getattr(lib, name).restype = None
        getattr(lib, name).argtypes = [p]
    for name in ("rt_fifo_write", "rt_fifo_read", "rt_fifo_read_nowait"):
        getattr(lib, name).restype = c.c_long
        getattr(lib, name).argtypes = [p, p, c.c_size_t]
    lib.rt_fifo_level.restype = c.c_long
    lib.rt_fifo_level.argtypes = [p]
    lib.rt_convert_iq.restype = c.c_size_t
    lib.rt_convert_iq.argtypes = [p, c.c_size_t, p, c.c_int, c.c_int]
    lib.rt_convert_hackrf_iq8.restype = None
    lib.rt_convert_hackrf_iq8.argtypes = [p, c.c_size_t, p]
    lib.rt_convert_hackdac_bb.restype = None
    lib.rt_convert_hackdac_bb.argtypes = [p, c.c_size_t, p, c.c_int16]
    lib.rt_convert_fl2k_u8.restype = None
    lib.rt_convert_fl2k_u8.argtypes = [p, c.c_size_t, p, c.c_int]
    lib.rt_fl2k_dither_u8.restype = None
    lib.rt_fl2k_dither_u8.argtypes = [p, c.c_size_t, c.c_size_t, p, p]


def ptr(a: np.ndarray):
    """A contiguous numpy array's data pointer for a ctypes call."""
    return a.ctypes.data_as(ctypes.c_void_p)


def vc_clock16(state: np.ndarray, n: int) -> np.ndarray:
    """n Videocrypt cut bytes (src/videocrypt.c:456-472): each is the
    current (c >> 8) byte, then 16 clocks of the dual-LFSR multiplexer.
    `state` is uint64 [sr1, sr2, c], advanced in place."""
    _check(state, np.uint64, (3,))
    out = np.empty(n, dtype=np.uint8)
    load().rt_vc_clock16(ptr(state), n, ptr(out))
    return out


def ng_event(state: np.ndarray, table: np.ndarray,
             order: np.ndarray) -> None:
    """One Syster PRBS event (src/syster.c:706-724, 305-327): 16 clocks of
    the dual LFSR give (s, r), and Kuhn's expansion of them over the key
    table updates `order` (int32 [287]) in place.  `state` is uint64
    [sr1, sr2, s, r]: sr1 and sr2 are read and advanced, s and r
    written."""
    _check(state, np.uint64, (4,))
    _check(table, np.uint8, (256,))
    _check(order, np.int32, (287,))
    load().rt_ng_event(ptr(state), ptr(table), ptr(order))


def _check(a: np.ndarray, dtype, shape: tuple) -> None:
    """A buffer handed to a native call: its dtype, shape and layout."""
    if a.dtype != dtype or a.shape != shape or not a.flags.c_contiguous:
        raise ValueError(f"native buffer: want {np.dtype(dtype)} {shape} "
                         f"contiguous, got {a.dtype} {a.shape}")


def threads() -> int:
    """Worker threads for the native row-parallel kernels."""
    return min(8, os.cpu_count() or 1)


class FmCarrierExact:
    """The reference's exact FM carrier generator (src/video.c:2218-2276):
    the int32 phase times a quantised per-sample-value LUT phasor,
    truncating >>31 multiplies, an atan2 renormalisation every 32767
    samples.  Stateful and strictly sequential in the absolute
    output-sample index."""

    def __init__(self, frequency: float, deviation: float,
                 sample_rate: int, level_int: int):
        self._lib = load()
        r = np.arange(-32768, 32768, dtype=np.float64)
        d = 2.0 * np.pi / sample_rate * (frequency + r / 32767.0
                                         * deviation)
        M = 2147483647.0

        def lround(x):
            return np.where(x >= 0, np.floor(x + 0.5),
                            -np.floor(-x + 0.5))
        lut = np.empty((65536, 2), np.int32)
        lut[:, 0] = lround(np.cos(d) * M)
        lut[:, 1] = lround(np.sin(d) * M)
        self._lut = np.ascontiguousarray(lut)
        self.level = int(level_int)
        # [phase_i, phase_q, counter] (src/video.c:2223-2226)
        self._state = np.array([2147483647, 0, 32767], np.int64)
        self.n = 0           # absolute sample index of the state

    @telemetry.spanned("fm.recur")
    def process(self, samples: np.ndarray, n0: int,
                emit: bool = True) -> np.ndarray | None:
        """The packed int32 (i | q << 16) carrier for output samples
        [n0, n0 + len).  n0 must continue the stream; a rewind restarts
        from sample 0 (the caller re-feeds the prefix with emit=False)."""
        if n0 != self.n:
            raise ValueError(f"carrier stream discontinuity: {n0} != "
                             f"{self.n}")
        samples = np.ascontiguousarray(samples, np.int16)
        out = np.empty(len(samples), np.int32) if emit else None
        self._lib.rt_fm_carrier_exact(
            ptr(self._state), ptr(samples), len(samples), ptr(self._lut),
            self.level, ptr(out) if emit else None)
        self.n += len(samples)
        return out

    def reset(self) -> None:
        self._state[:] = (2147483647, 0, 32767)
        self.n = 0


class NativeFileSink:
    """Threaded file sink that borrows the caller's arrays (rt_port_sink_*
    in csrc/hacktv_rt_port.cpp): `write` queues the array to the sink's
    writer thread and returns; that thread writes int16 complex output
    straight from the array, and converts any other type, or real
    output, into its own buffer first.  Writes wait while
    SINK_FIFO_BYTES of output are in flight."""

    # rt_port_sink_counts' order
    STATS = ("convert_ns", "wait_ns", "bytes_in", "peak_bytes", "borrowed")

    def __init__(self, path: str, dtype: str = "int16",
                 complex_out: bool = True):
        self._lib = load()
        self._counts = np.zeros(len(self.STATS), np.int64)
        self._held = collections.deque()     # (sequence, array) in flight
        self._borrows = dtype == "int16" and complex_out
        self._h = self._lib.rt_port_sink_open(
            path.encode(), TYPE_IDS[dtype], 1 if complex_out else 0,
            SINK_FIFO_BYTES)
        if not self._h:
            raise OSError(f"cannot open sink {path!r}")

    @telemetry.spanned("sink.write")
    def write(self, iq: np.ndarray) -> None:
        """Queue `iq`, int16 [n, 2] interleaved I/Q, for the file.  The
        sink reads `iq` until its writer thread has written it, after
        `write` returns: the caller must not write into `iq` afterwards
        (an array that is not int16 and contiguous is copied first, and
        the copy is held instead).  An IO error of an earlier write
        raises OSError here or at `close`."""
        iq = np.ascontiguousarray(iq, np.int16)
        seq = self._lib.rt_port_sink_submit(self._h, ptr(iq), iq.size // 2)
        if seq < 0:
            raise OSError("sink write failed")
        self._held.append((seq, iq))
        telemetry.count("sink.borrowed" if self._borrows
                        else "sink.converted")
        # drop the arrays the writer thread has written
        done = self._lib.rt_port_sink_done(self._h)
        while self._held and self._held[0][0] <= done:
            self._held.popleft()

    def stats(self) -> dict:
        """Over every write so far: ns the writer thread spent converting
        (0 for int16 complex output), ns writes waited for room, bytes
        handed to the file, the most bytes in flight, and the writes
        written straight from the caller's array."""
        if self._h:
            self._lib.rt_port_sink_counts(self._h, ptr(self._counts))
        return dict(zip(self.STATS, self._counts.tolist()))

    def close(self) -> None:
        """Write out what is queued, join the writer thread and close the
        file; OSError after an IO error."""
        if self._h:
            r = self._lib.rt_port_sink_close(self._h, ptr(self._counts))
            self._h = None
            self._held.clear()
            if r < 0:
                raise OSError("sink close reported IO error")

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class Fifo:
    """Bounded byte FIFO with prefill and EOF (the reference's src/fifo.c):
    reads wait until `prefill` bytes were buffered once, writes wait while
    it is full, and a closed, drained FIFO reads as EOF.  The native calls
    release the interpreter lock, so a writer blocked on a full FIFO does
    not hold up the reader's thread."""

    def __init__(self, capacity: int, prefill: int = 0):
        self._lib = load()
        self._h = self._lib.rt_fifo_create(capacity, prefill)
        if not self._h:
            raise MemoryError("rt_fifo_create failed")

    def write(self, data: bytes | np.ndarray) -> int:
        """Write all of `data`, waiting for room: its length, or -1 when
        the reader aborted."""
        a = (np.frombuffer(data, np.uint8)
             if isinstance(data, (bytes, bytearray))
             else np.ascontiguousarray(data).view(np.uint8).ravel())
        return self._lib.rt_fifo_write(self._h, ptr(a), a.nbytes)

    def read(self, n: int, nowait: bool = False) -> bytes | None:
        """Up to n bytes.  b"" is EOF for a waiting read and an underrun
        for a nowait read; None is an abort, or EOF for a nowait read
        (the native -1), which callers must tell apart from b""."""
        out = np.empty(n, np.uint8)
        fn = (self._lib.rt_fifo_read_nowait if nowait
              else self._lib.rt_fifo_read)
        r = fn(self._h, ptr(out), n)
        if r < 0:
            return None
        return out[:r].tobytes()

    def close_writer(self) -> None:
        self._lib.rt_fifo_close_writer(self._h)

    def abort(self) -> None:
        self._lib.rt_fifo_abort(self._h)

    def level(self) -> int:
        """Bytes buffered now."""
        return self._lib.rt_fifo_level(self._h)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.rt_fifo_destroy(self._h)
            self._h = None


def convert_iq(iq: np.ndarray, dtype: str, complex_out: bool) -> np.ndarray:
    """Interleaved int16 I/Q in a file sample format (src/rf_file.c:34-277);
    real output keeps I only."""
    iq = np.ascontiguousarray(iq, np.int16)
    samples = iq.size // 2
    out = np.empty(samples * (2 if complex_out else 1), TYPE_NP[dtype])
    load().rt_convert_iq(ptr(iq), samples, ptr(out), TYPE_IDS[dtype],
                         1 if complex_out else 0)
    return out


def convert_hackrf_iq8(iq: np.ndarray) -> np.ndarray:
    """HackRF RF mode: int16 I/Q to int8 pairs, the top 8 bits
    (src/rf_hackrf.c:246-276)."""
    iq = np.ascontiguousarray(iq, np.int16)
    out = np.empty(iq.size, np.int8)
    load().rt_convert_hackrf_iq8(ptr(iq), iq.size // 2, ptr(out))
    return out


def convert_hackdac_bb(iq: np.ndarray, sync_level: int = -9000
                       ) -> np.ndarray:
    """HackDAC baseband: the I channel as a 10-bit code over two bytes,
    the sync flag in the top bit (src/rf_hackrf.c:278-308)."""
    iq = np.ascontiguousarray(iq, np.int16)
    samples = iq.size // 2
    out = np.empty(samples * 2, np.uint8)
    load().rt_convert_hackdac_bb(ptr(iq), samples, ptr(out), sync_level)
    return out


def convert_fl2k_u8(iq: np.ndarray, channel: int) -> np.ndarray:
    """FL2K video: one channel (0 = I, 1 = Q) as unsigned 8-bit DAC
    codes (src/rf_fl2k.c:96-133)."""
    iq = np.ascontiguousarray(iq, np.int16)
    samples = iq.size // 2
    out = np.empty(samples, np.uint8)
    load().rt_convert_fl2k_u8(ptr(iq), samples, ptr(out), channel)
    return out


class Fl2kDither:
    """One channel's first-order delta-sigma dither of 16-bit PCM to the
    FL2K's 8-bit DAC (src/rf_fl2k.c:157-183); the error carries from
    call to call."""

    def __init__(self):
        self._lib = load()
        self._err = np.zeros(1, np.int32)

    def process(self, pcm: np.ndarray, stride: int = 1) -> np.ndarray:
        pcm = np.ascontiguousarray(pcm, np.int16)
        n = pcm.size // stride
        out = np.empty(n, np.uint8)
        self._lib.rt_fl2k_dither_u8(ptr(pcm), n, stride, ptr(out),
                                    ptr(self._err))
        return out
