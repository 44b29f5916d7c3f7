"""ctypes device drivers for the hardware sinks.

Port of hacktv_tpu/rf/drivers.py: the same call sequences and the same
`calls` traces, call for call.  Each driver reproduces the reference's
vendor-library call sequence:

  - HackRFDriver: src/rf_hackrf.c:379-561 (init/open_by_serial/
    set_sample_rate_manual/filter/freq/txvga_gain/amp/start_tx with the
    USB TX callback pumping the sink FIFO, HackDAC firmware detection);
  - SoapySDRDriver: src/rf_soapysdr.c:98-213 (make/setSampleRate/
    setFrequency/setGain/setAntenna/setupStream CS16/activate/
    writeStream);
  - FL2KDriver: src/rf_fl2k.c:280-390 (open/start_tx callback/
    set_sample_rate).

The classes take the loaded library as a constructor argument so the
call sequence is unit-testable with a mock; rf.hardware locates the real
vendor library.  The data path (FIFOs, converters, underrun
discipline) lives in rf.hardware — the drivers only move bytes between
the sink's fill() callback and the device."""

from __future__ import annotations

import ctypes as C

import numpy as np

HACKRF_SUCCESS = 0
HACKDAC_FIRMWARE_SUFFIX = b"hackdac"

# HackDAC mode flags (src/hackdac.h via rf_hackrf.c:480-497)
HACKDAC_MODE_RF = 0x00
HACKDAC_MODE_BASEBAND = 0x01
HACKDAC_NO_AUDIO = 0
HACKDAC_SYNC_AUDIO = 2


def _audio_mode(m):
    return (m & 3) << 1


class DriverError(RuntimeError):
    pass


class _hackrf_transfer(C.Structure):
    # src/libhackrf/hackrf.h hackrf_transfer layout
    _fields_ = [
        ("device", C.c_void_p),
        ("buffer", C.POINTER(C.c_uint8)),
        ("buffer_length", C.c_int),
        ("valid_length", C.c_int),
        ("rx_ctx", C.c_void_p),
        ("tx_ctx", C.c_void_p),
    ]


_TX_CB = C.CFUNCTYPE(C.c_int, C.POINTER(_hackrf_transfer))


class _hackrf_m0_state(C.Structure):
    # src/libhackrf/hackrf.h hackrf_m0_state layout
    _fields_ = [
        ("requested_mode", C.c_uint16),
        ("request_flag", C.c_uint16),
        ("active_mode", C.c_uint32),
        ("m0_count", C.c_uint32),
        ("m4_count", C.c_uint32),
        ("num_shortfalls", C.c_uint32),
        ("longest_shortfall", C.c_uint32),
        ("shortfall_limit", C.c_uint32),
        ("threshold", C.c_uint32),
        ("next_mode", C.c_uint32),
        ("error", C.c_uint32),
    ]


class HackRFDriver:
    """start(fill) arms hackrf_start_tx with a callback that requests
    `valid_length` bytes from fill() per USB transfer; fill returning
    b'' ends the stream (reference returns -1 on FIFO EOF,
    src/rf_hackrf.c:78-112)."""

    def __init__(self, lib, serial=None, sample_rate=16_000_000,
                 frequency=0, txvga_gain=0, amp=False, baseband=False):
        self.lib = lib
        self.dev = C.c_void_p()
        self.hackdac_version = 0
        self._cb_ref = None
        self.calls = []               # call-order trace (for tests)

        def ck(name, *args):
            self.calls.append(name)
            r = getattr(lib, name)(*args)
            if r != HACKRF_SUCCESS:
                raise DriverError(f"{name}() failed ({r})")
            return r

        ck("hackrf_init")
        ser = serial.encode() if isinstance(serial, str) else serial
        ck("hackrf_open_by_serial", ser, C.byref(self.dev))

        # HackDAC firmware detection (src/rf_hackrf.c:424-438)
        buf = C.create_string_buffer(256)
        self.calls.append("hackrf_version_string_read")
        if lib.hackrf_version_string_read(self.dev, buf, 255) \
                == HACKRF_SUCCESS:
            s = buf.value
            i = s.find(HACKDAC_FIRMWARE_SUFFIX)
            if i >= 0:
                part = s[i + len(HACKDAC_FIRMWARE_SUFFIX):].split(b"-")
                if len(part) >= 3:
                    try:
                        self.hackdac_version = int(part[2])
                    except ValueError:
                        pass

        if baseband:
            if self.hackdac_version == 0:
                raise DriverError(
                    "HackDAC firmware required for baseband output")
            frequency, txvga_gain, amp = 0, 0, False
        if self.hackdac_version > 0:
            flags = (HACKDAC_MODE_BASEBAND |
                     _audio_mode(HACKDAC_SYNC_AUDIO)) if baseband else \
                    (HACKDAC_MODE_RF | _audio_mode(HACKDAC_NO_AUDIO))
            ck("hackrf_set_hackdac_mode", self.dev, flags)

        ck("hackrf_set_sample_rate_manual", self.dev,
           C.c_uint32(int(sample_rate)), 1)
        self.calls.append("hackrf_compute_baseband_filter_bw")
        bw = lib.hackrf_compute_baseband_filter_bw(
            C.c_uint32(int(sample_rate)))
        ck("hackrf_set_baseband_filter_bandwidth", self.dev,
           C.c_uint32(bw))
        ck("hackrf_set_freq", self.dev, C.c_uint64(int(frequency)))
        ck("hackrf_set_txvga_gain", self.dev, C.c_uint32(int(txvga_gain)))
        ck("hackrf_set_amp_enable", self.dev, 1 if amp else 0)

    def get_m0_state(self):
        """Poll the device's M0 shortfall statistics
        (hackrf_get_m0_state, src/rf_hackrf.c:220-244).  Returns
        (num_shortfalls, longest_shortfall) or None when the library
        lacks the call (older libhackrf) or it fails."""
        fn = getattr(self.lib, "hackrf_get_m0_state", None)
        if fn is None:
            return None
        state = _hackrf_m0_state()
        self.calls.append("hackrf_get_m0_state")
        try:
            r = fn(self.dev, C.byref(state))
        except Exception:
            return None
        if r != HACKRF_SUCCESS:
            return None
        return int(state.num_shortfalls), int(state.longest_shortfall)

    def start(self, fill) -> None:
        def _cb(transfer_p):
            t = transfer_p.contents
            n = t.valid_length or t.buffer_length
            data = fill(n)
            if not data:
                return -1
            C.memmove(t.buffer, data, min(len(data), n))
            if len(data) < n:
                C.memset(C.addressof(t.buffer.contents) + len(data), 0,
                         n - len(data))
            return 0

        # the callback object lives as long as the driver: one collected
        # while the vendor thread still calls it crashes the process
        self._cb_ref = _TX_CB(_cb)
        self.calls.append("hackrf_start_tx")
        r = self.lib.hackrf_start_tx(self.dev, self._cb_ref, None)
        if r != HACKRF_SUCCESS:
            raise DriverError(f"hackrf_start_tx() failed ({r})")

    def stop(self) -> None:
        for name in ("hackrf_stop_tx", "hackrf_close", "hackrf_exit"):
            self.calls.append(name)
            try:
                getattr(self.lib, name)(*(() if name == "hackrf_exit"
                                          else (self.dev,)))
            except Exception:
                pass


SOAPY_SDR_TX = 0


class SoapySDRDriver:
    """Synchronous CS16 TX stream via the SoapySDR C API
    (src/rf_soapysdr.c:98-213)."""

    # ctypes prototypes: handle-returning calls must be c_void_p (the
    # default c_int restype truncates 64-bit pointers), and writeStream's
    # timeout is a long long.  Applied only to real ctypes libraries —
    # test doubles don't carry FUNCFLAG attributes.
    _PROTOTYPES = {
        "SoapySDRDevice_makeStrArgs": (C.c_void_p, [C.c_char_p]),
        "SoapySDRDevice_setSampleRate":
            (C.c_int, [C.c_void_p, C.c_int, C.c_size_t, C.c_double]),
        "SoapySDRDevice_setFrequency":
            (C.c_int, [C.c_void_p, C.c_int, C.c_size_t, C.c_double,
                       C.c_void_p]),
        "SoapySDRDevice_setGain":
            (C.c_int, [C.c_void_p, C.c_int, C.c_size_t, C.c_double]),
        "SoapySDRDevice_setAntenna":
            (C.c_int, [C.c_void_p, C.c_int, C.c_size_t, C.c_char_p]),
        "SoapySDRDevice_setupStream":
            (C.c_void_p, [C.c_void_p, C.c_int, C.c_char_p, C.c_void_p,
                          C.c_size_t, C.c_void_p]),
        "SoapySDRDevice_activateStream":
            (C.c_int, [C.c_void_p, C.c_void_p, C.c_int, C.c_longlong,
                       C.c_size_t]),
        "SoapySDRDevice_writeStream":
            (C.c_int, [C.c_void_p, C.c_void_p, C.POINTER(C.c_void_p),
                       C.c_size_t, C.POINTER(C.c_int), C.c_longlong,
                       C.c_long]),
        "SoapySDRDevice_deactivateStream":
            (C.c_int, [C.c_void_p, C.c_void_p, C.c_int, C.c_longlong]),
        "SoapySDRDevice_closeStream": (C.c_int, [C.c_void_p, C.c_void_p]),
        "SoapySDRDevice_unmake": (C.c_int, [C.c_void_p]),
    }

    @classmethod
    def _declare(cls, lib):
        if not isinstance(lib, C.CDLL):
            return
        for name, (restype, argtypes) in cls._PROTOTYPES.items():
            try:
                fn = getattr(lib, name)
            except AttributeError:
                continue
            fn.restype = restype
            fn.argtypes = argtypes

    def __init__(self, lib, device=None, sample_rate=16_000_000,
                 frequency=0, gain=0, antenna=None):
        self.lib = lib
        self._declare(lib)
        self.calls = []
        self.calls.append("SoapySDRDevice_makeStrArgs")
        dev = lib.SoapySDRDevice_makeStrArgs(
            device.encode() if isinstance(device, str) else (device or b""))
        if not dev:
            raise DriverError("SoapySDRDevice_make failed")
        self.dev = dev

        def ck(name, *args):
            self.calls.append(name)
            r = getattr(lib, name)(*args)
            if r not in (0, None):
                raise DriverError(f"{name}() failed ({r})")
            return r

        ck("SoapySDRDevice_setSampleRate", dev, SOAPY_SDR_TX, 0,
           C.c_double(sample_rate))
        ck("SoapySDRDevice_setFrequency", dev, SOAPY_SDR_TX, 0,
           C.c_double(frequency), None)
        ck("SoapySDRDevice_setGain", dev, SOAPY_SDR_TX, 0,
           C.c_double(gain))
        if antenna:
            ck("SoapySDRDevice_setAntenna", dev, SOAPY_SDR_TX, 0,
               antenna.encode() if isinstance(antenna, str) else antenna)
        self.calls.append("SoapySDRDevice_setupStream")
        self.stream = lib.SoapySDRDevice_setupStream(
            dev, SOAPY_SDR_TX, b"CS16", None, 0, None)
        if not self.stream:
            raise DriverError("SoapySDRDevice_setupStream failed")
        ck("SoapySDRDevice_activateStream", dev, self.stream, 0, 0, 0)

    def write_stream(self, iq: np.ndarray) -> None:
        iq = np.ascontiguousarray(iq, np.int16)
        n = len(iq) if iq.ndim == 2 else len(iq) // 2
        bufs = (C.c_void_p * 1)(iq.ctypes.data)
        flags = C.c_int(0)
        done = 0
        while done < n:
            self.calls.append("SoapySDRDevice_writeStream")
            r = self.lib.SoapySDRDevice_writeStream(
                self.dev, self.stream, bufs, n - done,
                C.byref(flags), 0, 100000)
            if r < 0:
                raise DriverError(f"writeStream failed ({r})")
            done += r
            bufs[0] = iq.ctypes.data + done * 4

    def stop(self) -> None:
        for name, args in (
                ("SoapySDRDevice_deactivateStream",
                 (self.dev, self.stream, 0, 0)),
                ("SoapySDRDevice_closeStream", (self.dev, self.stream)),
                ("SoapySDRDevice_unmake", (self.dev,))):
            self.calls.append(name)
            try:
                getattr(self.lib, name)(*args)
            except Exception:
                pass


class _fl2k_data_info(C.Structure):
    # libosmo-fl2k fl2k.h fl2k_data_info_t layout
    _fields_ = [
        ("ctx", C.c_void_p),
        ("underflow_cnt", C.c_uint32),
        ("len", C.c_uint32),
        ("using_zerocopy", C.c_int),
        ("device_error", C.c_int),
        ("sampletype_signed", C.c_int),
        ("r_buf", C.c_char_p),
        ("g_buf", C.c_char_p),
        ("b_buf", C.c_char_p),
    ]


_FL2K_CB = C.CFUNCTYPE(None, C.POINTER(_fl2k_data_info))


class FL2KDriver:
    """fl2k_start_tx callback filling the R/G/B buffers from the sink's
    fill() (src/rf_fl2k.c:56-85, 280-390)."""

    def __init__(self, lib, device=None, sample_rate=16_000_000):
        self.lib = lib
        self.calls = []
        self.dev = C.c_void_p()
        self.sample_rate = int(sample_rate)
        idx = int(device) if device else 0
        self.calls.append("fl2k_open")
        lib.fl2k_open(C.byref(self.dev), idx)
        if not self.dev:
            raise DriverError(f"fl2k_open() failed for device {idx}")
        self._bufs = None
        self._cb_ref = None

    def start(self, fill) -> None:
        def _cb(info_p):
            info = info_p.contents
            n = info.len
            r, g, b = fill(n)
            self._bufs = (C.create_string_buffer(r, n),
                          C.create_string_buffer(g, n),
                          C.create_string_buffer(b, n))
            info.sampletype_signed = 0
            info.r_buf = C.cast(self._bufs[0], C.c_char_p)
            info.g_buf = C.cast(self._bufs[1], C.c_char_p)
            info.b_buf = C.cast(self._bufs[2], C.c_char_p)

        self._cb_ref = _FL2K_CB(_cb)
        self.calls.append("fl2k_start_tx")
        r = self.lib.fl2k_start_tx(self.dev, self._cb_ref, None, 0)
        if r < 0:
            raise DriverError(f"fl2k_start_tx() failed ({r})")
        self.calls.append("fl2k_set_sample_rate")
        r = self.lib.fl2k_set_sample_rate(self.dev,
                                          C.c_uint32(self.sample_rate))
        if r < 0:
            raise DriverError(f"fl2k_set_sample_rate() failed ({r})")

    def stop(self) -> None:
        for name in ("fl2k_stop_tx", "fl2k_close"):
            self.calls.append(name)
            try:
                getattr(self.lib, name)(self.dev)
            except Exception:
                pass
