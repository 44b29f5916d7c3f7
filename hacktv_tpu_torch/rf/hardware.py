"""Hardware RF sinks: HackRF (RF + HackDAC baseband), SoapySDR, FL2K.

Port of hacktv_tpu/rf/hardware.py, host code that the encoder's blocks
reach after `collect_block`; the bytes on the wire are the JAX
package's.  Re-implements the reference's sink layer (src/rf_hackrf.c:379-561,
src/rf_soapysdr.c:98-213, src/rf_fl2k.c:280-390) around the native
runtime's byte FIFO and conversion kernels: the synthesis loop enqueues
int16 IQ blocks; a realtime consumer (USB callback in the real drivers,
the loopback driver in tests) drains fixed-size transfers with underrun
zero-fill, exactly like the reference's FIFO discipline.

Device access is via ctypes against the vendor libraries when present
(libhackrf, libSoapySDR, libosmo-fl2k); without them `open_sink` raises
HardwareUnavailable with a clear message, but the full sink logic is
importable and loopback-testable.  No sink falls back to a file.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import sys

import numpy as np

from .. import runtime

# HackDAC constants (rf_hackrf.c:33-50)
HACKDAC_USB_AUDIO_BUFFER_SIZE = 512
HACKDAC_SYNC_MAGIC_1 = 0x87654321
HACKDAC_SYNC_MAGIC_2 = 0x12345678
HACKRF_AHB_BUFFER_SIZE = 16384
HACKDAC_PHASE_SIZE = HACKRF_AHB_BUFFER_SIZE + HACKDAC_USB_AUDIO_BUFFER_SIZE


class HardwareUnavailable(RuntimeError):
    pass


def _find_lib(names):
    for n in names:
        path = ctypes.util.find_library(n)
        if path:
            try:
                return ctypes.CDLL(path)
            except OSError:
                continue
    return None


class HackRFSink:
    """HackRF TX sink.  RF mode: int16 IQ -> int8 pairs; HackDAC
    baseband mode: real channel -> 10-bit packed with sync flag and
    interleaved audio phases (rf_hackrf.c:114-218, 246-308).

    `driver` provides start(callback)/stop(); the callback contract is
    fill(nbytes) -> bytes (zero-filled on underrun, b'' at EOF)."""

    def __init__(self, driver, sample_rate: int, baseband: bool = False,
                 buffer_seconds: float = 0.4):
        self.driver = driver
        self.baseband = baseband
        bps = 2                       # bytes per sample on the wire
        cap = int(sample_rate * buffer_seconds * bps)
        self.fifo = runtime.Fifo(cap, cap // 2)
        self.audio_fifo = runtime.Fifo(1 << 20, 0) if baseband else None
        if baseband:
            # 32 kHz stereo -> sample_rate/64 rational resample
            # (src/rf_hackrf.c:456-472)
            from ..ops.resampler import Resampler, StreamResampler
            rs = Resampler.create((sample_rate, 64), (32000, 1))
            self._audio_rs = (StreamResampler(rs), StreamResampler(rs))
        self._sync_frames = 0
        self._frame_phase = 0
        self._frame_padding = 0
        self.underruns = 0
        self.longest_shortfall = 0    # bytes, local FIFO view
        self._sample_rate = int(sample_rate)
        self._stats_counter = 0
        self._m0_shortfalls = 0
        self._m0_longest = 0
        driver.start(self._fill)

    # -- producer side --------------------------------------------------
    def write(self, iq: np.ndarray) -> None:
        """iq: int16 [n, 2]."""
        iq = np.ascontiguousarray(iq, np.int16)
        if self.baseband:
            data = runtime.convert_hackdac_bb(iq.reshape(-1))
        else:
            data = runtime.convert_hackrf_iq8(iq.reshape(-1))
        if self.fifo.write(data) < 0:
            raise OSError("hackrf: transfer aborted")
        self._print_stats(len(iq))

    def _print_stats(self, samples: int) -> None:
        """Once per second of samples, poll the device's M0 shortfall
        counters and warn when they advance
        (src/rf_hackrf.c:220-244)."""
        self._stats_counter += samples
        if self._stats_counter < self._sample_rate:
            return
        self._stats_counter -= self._sample_rate
        get = getattr(self.driver, "get_m0_state", None)
        if get is None:
            return
        st = get()
        if st is None:
            return
        num, longest = st
        if num != self._m0_shortfalls:
            sys.stderr.write(
                f"hackrf: {num} underrun{'s' if num != 1 else ''}, "
                f"longest {longest} bytes\n")
            self._m0_shortfalls = num
            self._m0_longest = longest

    def stats(self) -> dict:
        """Sink telemetry: local FIFO underruns plus the device's M0
        counters when available."""
        return {"underruns": self.underruns,
                "longest_shortfall_bytes": self.longest_shortfall,
                "m0_shortfalls": self._m0_shortfalls,
                "m0_longest_shortfall": self._m0_longest,
                "fifo_level": self.fifo.level()}

    def write_audio(self, pcm: np.ndarray) -> None:
        """HackDAC interleaved audio: int16 stereo pairs at 32 kHz,
        resampled here to sample_rate/64 (src/rf_hackrf.c:456-472)."""
        if self.audio_fifo is None:
            return
        pcm = np.ascontiguousarray(pcm, np.int16).reshape(-1, 2)
        left = self._audio_rs[0].process(pcm[:, 0])
        right = self._audio_rs[1].process(pcm[:, 1])
        out = np.empty((len(left), 2), np.int16)
        out[:, 0] = left
        out[:, 1] = right
        self.audio_fifo.write(out)

    # -- realtime consumer ----------------------------------------------
    def _fill(self, n: int) -> bytes:
        if not self.baseband:
            got = self.fifo.read(n, nowait=True)
            if got is None:
                return b""                 # EOF: stop transfer
            if len(got) < n:
                self.underruns += 1
                self.longest_shortfall = max(self.longest_shortfall,
                                             n - len(got))
                sys.stderr.write("U")
                got += b"\x00" * (n - len(got))
            return got
        return self._fill_hackdac(n)

    def _fill_hackdac(self, n: int) -> bytes:
        out = bytearray()
        # three blank frames, then the sync frame (rf_hackrf.c:122-146)
        if self._sync_frames < 3:
            self._sync_frames += 1
            return bytes(n)
        if self._sync_frames == 3:
            hdr = np.zeros(HACKDAC_USB_AUDIO_BUFFER_SIZE, np.uint8)
            hdr[:12] = np.array(
                [HACKDAC_SYNC_MAGIC_1, HACKDAC_SYNC_MAGIC_2,
                 HACKDAC_USB_AUDIO_BUFFER_SIZE],
                dtype=np.uint32).view(np.uint8)
            out += hdr.tobytes()
            self._sync_frames += 1
            self._frame_phase = 0
        while len(out) < n:
            want = n - len(out)
            if self._frame_padding > 0:
                r = min(self._frame_padding, want)
                out += bytes(r)
                self._frame_padding -= r
                continue
            if self._frame_phase < HACKRF_AHB_BUFFER_SIZE:
                fifo = self.fifo
                r = HACKRF_AHB_BUFFER_SIZE - self._frame_phase
            else:
                fifo = self.audio_fifo
                r = HACKDAC_PHASE_SIZE - self._frame_phase
            r = min(r, want)
            got = fifo.read(r, nowait=True)
            if got is None:
                return bytes(out) if out else b""
            if got:
                self._frame_phase += len(got)
                if self._frame_phase == HACKDAC_PHASE_SIZE:
                    self._frame_phase = 0
                out += got
            else:
                # underrun: pad to a whole number of AV phases
                self.underruns += 1
                self.longest_shortfall = max(self.longest_shortfall,
                                             want)
                sys.stderr.write("U")
                pads = -(-want // HACKDAC_PHASE_SIZE) * HACKDAC_PHASE_SIZE
                self._frame_padding = pads
        return bytes(out[:n])

    def close(self) -> None:
        self.fifo.close_writer()
        if self.audio_fifo is not None:
            self.audio_fifo.close_writer()
        self.driver.stop()


class SoapySDRSink:
    """Synchronous CS16 writeStream sink (rf_soapysdr.c:98-213); scales
    to the device's native full scale when below int16."""

    def __init__(self, driver, full_scale: float = 32767.0):
        self.driver = driver
        self.scale = (full_scale / 32767.0
                      if full_scale < 32767.0 else 1.0)

    def write(self, iq: np.ndarray) -> None:
        iq = np.ascontiguousarray(iq, np.int16)
        if self.scale != 1.0:
            iq = np.clip(iq.astype(np.float32) * self.scale,
                         -32768, 32767).astype(np.int16)
        self.driver.write_stream(iq)

    def close(self) -> None:
        self.driver.stop()


class FL2KSink:
    """FL2K VGA DAC sink: R = video/I, G = Q or left audio, B = right
    audio or S/PDIF (rf_fl2k.c:280-390).  8-bit audio uses first-order
    delta-sigma dither (native kernel)."""

    def __init__(self, driver, sample_rate: int, audio: str = "none",
                 buffer_seconds: float = 0.4):
        if audio not in ("none", "stereo", "spdif"):
            raise ValueError(f"unknown FL2K audio mode {audio!r}")
        self.driver = driver
        self.audio = audio
        self.sample_rate = int(sample_rate)
        cap = int(sample_rate * buffer_seconds)
        self.fifo_r = runtime.Fifo(cap, cap // 2)
        self.fifo_g = runtime.Fifo(cap, 0)
        self.fifo_b = runtime.Fifo(cap, 0)
        self.dither = (runtime.Fl2kDither(), runtime.Fl2kDither())
        # stereo: 32 kHz hold-interpolation state (src/rf_fl2k.c:150-167)
        self._dac_k = 0               # DAC samples generated so far
        self._held = np.zeros(2, np.int16)
        # spdif: PCM block accumulator + bitstream resampler
        # (src/rf_fl2k.c:192-248)
        if audio == "spdif":
            from ..audio import spdif as spdif_mod
            from ..ops.resampler import Resampler, StreamResampler
            self._spdif_mod = spdif_mod
            self._spdif_pcm = np.zeros(0, np.int16)
            self._spdif_rs = StreamResampler(Resampler.create(
                (self.sample_rate, 1),
                (spdif_mod.bitrate(32000) * 5, 1)))
        self.underruns = 0
        driver.start(self._fill)

    def write(self, iq: np.ndarray) -> None:
        iq = np.ascontiguousarray(iq, np.int16).reshape(-1)
        self.fifo_r.write(runtime.convert_fl2k_u8(iq, 0))
        if self.audio == "none":
            self.fifo_g.write(runtime.convert_fl2k_u8(iq, 1))

    def write_audio(self, pcm: np.ndarray) -> None:
        """pcm: int16 stereo pairs at 32 kHz.  Stereo mode holds each
        pair for sample_rate/32000 DAC samples and delta-sigma dithers
        to 8 bits (src/rf_fl2k.c:150-183); spdif mode biphase-encodes
        32 kHz S/PDIF blocks and FIR-resamples the bitstream to the DAC
        rate (src/rf_fl2k.c:192-248)."""
        pcm = np.ascontiguousarray(pcm, np.int16).reshape(-1, 2)
        if self.audio == "stereo":
            self._write_audio_stereo(pcm)
        elif self.audio == "spdif":
            self._write_audio_spdif(pcm)

    def _write_audio_stereo(self, pcm: np.ndarray) -> None:
        # pairs consumed after k DAC samples = floor(k * 32000 / rate);
        # generate DAC samples until these pairs are all consumed
        S, A = self.sample_rate, 32000
        p1 = self._dac_k * A // S + len(pcm)
        k1 = -(-p1 * S // A)          # ceil: last k with p1 pairs used
        k = np.arange(self._dac_k + 1, k1 + 1, dtype=np.int64)
        if len(k) == 0:
            return
        held = k * A // S - 1 - (self._dac_k * A // S)  # into pcm; -1 pre
        vals = np.concatenate([self._held[None, :], pcm])
        hv = vals[np.clip(held + 1, 0, len(pcm))]
        self.fifo_g.write(self.dither[0].process(
            np.ascontiguousarray(hv[:, 0])))
        self.fifo_b.write(self.dither[1].process(
            np.ascontiguousarray(hv[:, 1])))
        self._dac_k = int(k1)
        self._held = pcm[-1].copy()

    def _write_audio_spdif(self, pcm: np.ndarray) -> None:
        sp = self._spdif_mod
        buf = np.concatenate([self._spdif_pcm, pcm.reshape(-1)])
        nblk = len(buf) // sp.SPDIF_BLOCK_SAMPLES
        for b in range(nblk):
            blk = buf[b * sp.SPDIF_BLOCK_SAMPLES:
                      (b + 1) * sp.SPDIF_BLOCK_SAMPLES]
            bits = np.unpackbits(sp.spdif_block(blk).reshape(-1))
            sym = np.where(bits, 23405, -23405).astype(np.int16)
            sym5 = np.repeat(sym, 5)
            out = self._spdif_rs.process(sym5)
            self.fifo_b.write(((out.astype(np.int32) + 32768) >> 8
                               ).astype(np.uint8))
        self._spdif_pcm = buf[nblk * sp.SPDIF_BLOCK_SAMPLES:]

    def _fill(self, n: int):
        """Returns (r, g, b) byte buffers of length n each."""
        out = []
        for fifo in (self.fifo_r, self.fifo_g, self.fifo_b):
            got = fifo.read(n, nowait=True)
            if got is None:
                got = b""
            if len(got) < n:
                if fifo is self.fifo_r:
                    self.underruns += 1
                got += b"\x80" * (n - len(got))
            out.append(got)
        return tuple(out)

    def close(self) -> None:
        for f in (self.fifo_r, self.fifo_g, self.fifo_b):
            f.close_writer()
        self.driver.stop()


# ---------------------------------------------------------------------------
# Real drivers (gated on vendor libraries)

def open_sink(kind: str, serial, sample_rate: int, frequency: int = 0,
              gain: int = 0, amp: bool = False, antenna=None,
              complex_out: bool = True, baseband: bool = False,
              fl2k_audio: str = "none", lib=None):
    """Open a hardware sink with the real ctypes driver (rf.drivers).
    `lib` injects a library object for tests; otherwise the vendor
    library is located with ctypes.util.find_library."""
    from . import drivers

    if kind == "hackrf":
        lib = lib or _find_lib(["hackrf"])
        if lib is None:
            raise HardwareUnavailable(
                "hackrf output requires libhackrf, which is not "
                "installed on this host; use file:<path> or -")
        try:
            drv = drivers.HackRFDriver(
                lib, serial=serial, sample_rate=sample_rate,
                frequency=frequency, txvga_gain=gain, amp=amp,
                baseband=baseband)
        except drivers.DriverError as e:
            raise HardwareUnavailable(f"hackrf: {e}")
        return HackRFSink(drv, sample_rate, baseband=baseband)
    if kind == "soapysdr":
        lib = lib or _find_lib(["SoapySDR"])
        if lib is None:
            raise HardwareUnavailable(
                "soapysdr output requires libSoapySDR, which is not "
                "installed on this host; use file:<path> or -")
        try:
            drv = drivers.SoapySDRDriver(
                lib, device=serial, sample_rate=sample_rate,
                frequency=frequency, gain=gain, antenna=antenna)
        except drivers.DriverError as e:
            raise HardwareUnavailable(f"soapysdr: {e}")
        return SoapySDRSink(drv)
    if kind == "fl2k":
        lib = lib or _find_lib(["osmo-fl2k"])
        if lib is None:
            raise HardwareUnavailable(
                "fl2k output requires libosmo-fl2k, which is not "
                "installed on this host; use file:<path> or -")
        try:
            drv = drivers.FL2KDriver(lib, device=serial,
                                     sample_rate=sample_rate)
        except drivers.DriverError as e:
            raise HardwareUnavailable(f"fl2k: {e}")
        return FL2KSink(drv, sample_rate, audio=fl2k_audio)
    raise HardwareUnavailable(f"unknown hardware sink {kind!r}")
