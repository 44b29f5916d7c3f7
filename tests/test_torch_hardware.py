"""The port's hardware sinks (rf/hardware.py, rf/drivers.py) against the
JAX package's: the three drivers' vendor-library call traces with one mock
library, the callbacks' buffers, each sink pumped by a loop-back driver
(HackRF RF and HackDAC baseband with its audio phases and underrun
padding, FL2K with no audio, stereo and S/PDIF, SoapySDR at full and
reduced scale), the M0 warning line, open_sink with an injected library,
a 30 s realtime soak, and the encoders' sink audio tap
(Encoder.block_audio_pcm) with the older frame APIs.  Tolerance: none,
every pull, trace and sample is compared byte for byte."""

from __future__ import annotations

import ctypes as C
import hashlib
import time

import numpy as np
import pytest

import _torch_common as tc
from hacktv_tpu.rf import drivers as jdrv
from hacktv_tpu.rf import hardware as jhw
from hacktv_tpu_torch import runtime as trt
from hacktv_tpu_torch.rf import drivers as tdrv
from hacktv_tpu_torch.rf import hardware as thw


@pytest.fixture(autouse=True, scope="module")
def _jax_runtime():
    tc.jax_runtime()


MockLib = tc.MockVendorLib


HACKRF_CASES = {
    "rf": (b"git-abcdef (2024)", dict(serial="0000", sample_rate=16_000_000,
                                      frequency=855_250_000, txvga_gain=47,
                                      amp=True)),
    "rf-default": (b"git-abcdef (2024)", {}),
    "hackdac-rf": (b"2024.02.1 hackdac-h-42", dict(frequency=471_250_000)),
    "hackdac-baseband": (b"2024.02.1 hackdac-h-42",
                         dict(baseband=True, frequency=471_250_000,
                              txvga_gain=20, amp=True)),
    "hackdac-bad-version": (b"x hackdac-h-beta", dict(amp=True)),
}


@pytest.mark.parametrize("case", list(HACKRF_CASES))
def test_hackrf_driver_calls(case):
    version, kw = HACKRF_CASES[case]
    res = []
    for mod in (tdrv, jdrv):
        lib = MockLib(version=version)
        drv = mod.HackRFDriver(lib, **kw)
        drv.get_m0_state()
        drv.start(lambda n: b"\x01" * n)
        drv.stop()
        res.append((drv.calls, lib.called, drv.hackdac_version))
    assert res[0] == res[1]
    assert res[0][0] == res[0][1]


def test_hackrf_driver_baseband_needs_hackdac():
    for mod in (tdrv, jdrv):
        with pytest.raises(mod.DriverError, match="HackDAC firmware"):
            mod.HackRFDriver(MockLib(), baseband=True)


def test_hackrf_driver_callback():
    """The TX callback: a full transfer, a short fill zero-padded, EOF
    (-1); valid_length 0 falls back to buffer_length."""
    bufs = []
    for mod in (tdrv, jdrv):
        drv = mod.HackRFDriver(MockLib())
        data = iter([b"\x01" * 64, b"\x02" * 10, b"\x03" * 64, b""])
        drv.start(lambda n: next(data))
        t = mod._hackrf_transfer()
        buf = (C.c_uint8 * 64)()
        t.buffer = C.cast(buf, C.POINTER(C.c_uint8))
        t.buffer_length = 64
        rets = []
        for valid in (64, 64, 0, 64):
            t.valid_length = valid
            rets.append(drv._cb_ref(C.pointer(t)))
            bufs.append(bytes(buf))
        assert rets == [0, 0, 0, -1]
    assert bufs[:4] == bufs[4:]
    assert bufs[1] == b"\x02" * 10 + bytes(54)


@pytest.mark.parametrize("antenna", [None, "BAND1"])
def test_soapysdr_driver_calls(antenna):
    iq = np.random.default_rng(2).integers(-32768, 32768, (2500, 2)
                                            ).astype(np.int16)
    res = []
    for mod in (tdrv, jdrv):
        lib = MockLib()
        drv = mod.SoapySDRDriver(lib, device="driver=lime",
                                 sample_rate=16_000_000,
                                 frequency=471_250_000, gain=30,
                                 antenna=antenna)
        drv.write_stream(iq)
        drv.stop()
        res.append((drv.calls, lib.called, b"".join(lib.written)))
    assert res[0] == res[1]
    assert res[0][2] == iq.tobytes()
    assert res[0][0].count("SoapySDRDevice_writeStream") == 3


def test_fl2k_driver_calls_and_callback():
    res = []
    for mod in (tdrv, jdrv):
        lib = MockLib()
        drv = mod.FL2KDriver(lib, device="1", sample_rate=13_500_000)
        drv.start(lambda n: (b"\x10" * n, b"\x20" * n, b"\x30" * n))
        info = mod._fl2k_data_info()
        info.len = 32
        drv._cb_ref(C.pointer(info))
        got = [C.string_at(getattr(info, f), 32)
               for f in ("r_buf", "g_buf", "b_buf")]
        drv.stop()
        res.append((drv.calls, lib.called, got, info.sampletype_signed))
    assert res[0] == res[1]
    assert res[0][2] == [b"\x10" * 32, b"\x20" * 32, b"\x30" * 32]


class LoopDriver:
    """Pulls fixed transfers from the sink's fill callback on demand."""

    def __init__(self, transfer=4096):
        self.transfer = transfer
        self.pulled = []

    def start(self, fill):
        self.fill = fill

    def pump(self, n):
        for _ in range(n):
            b = self.fill(self.transfer)
            if not b:
                return
            self.pulled.append(b)

    def stop(self):
        pass


def _pump_script(hw, script, sink_kw, transfer, baseband=False,
                 kind="hackrf"):
    """Run one script of ("write", iq) / ("audio", pcm) / ("pump", n)
    steps against a sink of the given package; its pulls and counters."""
    drv = LoopDriver(transfer)
    if kind == "hackrf":
        s = hw.HackRFSink(drv, baseband=baseband, **sink_kw)
    else:
        s = hw.FL2KSink(drv, **sink_kw)
    for op, arg in script:
        if op == "write":
            s.write(arg)
        elif op == "audio":
            s.write_audio(arg)
        else:
            drv.pump(arg)
    s.close()
    drv.pump(4)             # past EOF
    st = s.stats() if kind == "hackrf" else None
    return drv.pulled, s.underruns, st


def _script(seed, n_blocks, block, pumps, audio_pairs=0):
    rng = np.random.default_rng(seed)
    out = []
    for b in range(n_blocks):
        out.append(("write", rng.integers(-32768, 32768, (block, 2)
                                          ).astype(np.int16)))
        if audio_pairs:
            out.append(("audio", rng.integers(
                -32768, 32768, (audio_pairs + 7 * b, 2)).astype(np.int16)))
        out.append(("pump", pumps[b % len(pumps)]))
    return out


def test_hackrf_sink_rf_loopback(capsys):
    """RF mode: int8 pairs; transfers before the prefill and past the
    FIFO's end are zero-filled underruns, each counted."""
    script = _script(5, 6, 1500, [1, 2, 3, 2, 9, 1])
    kw = dict(sample_rate=10_000)           # FIFO 8,000 bytes
    got = _pump_script(thw, script, kw, 1024)
    ref = _pump_script(jhw, script, kw, 1024)
    assert got == ref
    pulled, under, st = got
    assert under > 1 and st["longest_shortfall_bytes"] > 0
    assert pulled[0] == bytes(1024)         # before the prefill
    assert capsys.readouterr().err.count("U") == 2 * under


def test_hackdac_sink_baseband_loopback():
    """HackDAC: three blank frames, the sync header, video and audio
    phases interleaved, whole-phase padding on an underrun."""
    P = thw.HACKDAC_PHASE_SIZE
    script = _script(9, 5, 9000, [2, 1, 4, 3, 6], audio_pairs=700)
    kw = dict(sample_rate=2_000_000)
    got = _pump_script(thw, script, kw, P // 2 + 100, baseband=True)
    ref = _pump_script(jhw, script, kw, P // 2 + 100, baseband=True)
    assert got == ref
    pulled = b"".join(got[0])
    assert pulled[:3 * (P // 2 + 100)] == bytes(3 * (P // 2 + 100))
    assert got[1] > 0


@pytest.mark.parametrize("audio", ["none", "stereo", "spdif"])
def test_fl2k_sink_loopback(audio):
    """FL2K: R = I, G = Q with no audio; with stereo the 32 kHz pairs
    held to the DAC rate and dithered on G and B; with S/PDIF the biphase
    blocks resampled to the DAC rate on B (blocks split across writes)."""
    rate = 1_024_000 if audio == "spdif" else 320_000
    script = _script(13, 4, 3000, [1, 2, 0, 3],
                     audio_pairs=250 if audio != "none" else 0)
    kw = dict(sample_rate=rate, audio=audio)
    got = _pump_script(thw, script, kw, 1000, kind="fl2k")
    ref = _pump_script(jhw, script, kw, 1000, kind="fl2k")
    assert got == ref
    g = b"".join(t[1] for t in got[0])
    b = b"".join(t[2] for t in got[0])
    if audio != "none":
        assert len(set(b)) > 2
    if audio == "stereo":
        assert len(set(g)) > 2


@pytest.mark.parametrize("full_scale", [32767.0, 2047.0])
def test_soapysdr_sink(full_scale):
    iq = np.random.default_rng(4).integers(-32768, 32768, (3000, 2)
                                            ).astype(np.int16)
    res = []
    for mod, hw in ((tdrv, thw), (jdrv, jhw)):
        lib = MockLib(chunk=700)
        s = hw.SoapySDRSink(mod.SoapySDRDriver(lib), full_scale=full_scale)
        s.write(iq)
        s.write(iq[:5])
        s.close()
        res.append((lib.called, b"".join(lib.written), s.scale))
    assert res[0] == res[1]
    if full_scale == 32767.0:
        assert res[0][1] == iq.tobytes() + iq[:5].tobytes()


def test_hackrf_m0_state_warning(capsys):
    """The once-a-second M0 poll prints the reference's warning line when
    the device's shortfall counter moves (src/rf_hackrf.c:220-244)."""
    errs, stats = [], []
    for hw in (thw, jhw):
        class M0Driver(LoopDriver):
            polls = 0

            def get_m0_state(self):
                self.polls += 1
                return (3, 8192) if self.polls >= 2 else (0, 0)
        drv = M0Driver()
        sink = hw.HackRFSink(drv, sample_rate=100_000, buffer_seconds=10.0)
        blk = np.zeros((50_000, 2), np.int16)
        for _ in range(5):                   # 2.5 s of samples
            sink.write(blk)
            drv.pump(2)
        errs.append(capsys.readouterr().err)
        stats.append(sink.stats())
        sink.close()
    assert errs[0] == errs[1]
    assert "hackrf: 3 underruns, longest 8192 bytes" in errs[0]
    assert stats[0] == stats[1]
    assert stats[0]["m0_shortfalls"] == 3


def test_open_sink_injected_lib():
    """open_sink with an injected library: the sink types, the drivers'
    traces equal the JAX package's; no library raises naming it."""
    for kind, kw, cls in (
            ("hackrf", dict(frequency=855_250_000, gain=47, amp=True),
             "HackRFSink"),
            ("soapysdr", dict(antenna="TX"), "SoapySDRSink"),
            ("fl2k", dict(complex_out=False, fl2k_audio="stereo"),
             "FL2KSink")):
        libs = [MockLib(), MockLib()]
        sinks = [hw.open_sink(kind, "0", sample_rate=1_000_000, lib=lib,
                              **kw) for hw, lib in zip((thw, jhw), libs)]
        assert type(sinks[0]).__name__ == cls
        for s in sinks:
            s.close()
        assert libs[0].called == libs[1].called
    with pytest.raises(thw.HardwareUnavailable, match="unknown"):
        thw.open_sink("usrp", None, 1_000_000, lib=MockLib())


@pytest.mark.parametrize("kind,libname", [("hackrf", "libhackrf"),
                                          ("soapysdr", "libSoapySDR"),
                                          ("fl2k", "libosmo-fl2k")])
def test_open_sink_without_library(monkeypatch, kind, libname):
    monkeypatch.setattr(thw, "_find_lib", lambda names: None)
    with pytest.raises(thw.HardwareUnavailable, match=libname):
        thw.open_sink(kind, None, 16_000_000)


def test_hackrf_realtime_soak_30s():
    """30 seconds of signal through the sink's FIFO at a realtime
    producer/consumer balance: no underrun, the FIFO never past its 0.4
    s, every byte delivered in order; in under 10 s of wall time."""
    t0 = time.monotonic()
    rate = 1_000_000
    drv = LoopDriver(transfer=131_072)
    sink = thw.HackRFSink(drv, sample_rate=rate, buffer_seconds=0.4)
    chunk = 65_536
    total = rate * 30
    rng = np.random.default_rng(7)
    sent = hashlib.sha256()
    produced = 0
    max_level = 0
    pulled = 0
    while produced < total:
        iq = rng.integers(-2048, 2048, (chunk, 2)).astype(np.int16)
        sink.write(iq)
        produced += chunk
        sent.update(trt.convert_hackrf_iq8(iq.reshape(-1)))
        # the consumer half a buffer behind: a realtime device never
        # reads ahead of its clock
        while pulled + drv.transfer <= produced * 2 - 400_000:
            drv.pump(1)
            pulled += drv.transfer
        max_level = max(max_level, sink.fifo.level())
    sink.close()
    drv.pump(10**6)
    got = b"".join(drv.pulled)[: produced * 2]
    assert sink.underruns == 0 and sink.longest_shortfall == 0
    assert max_level <= int(rate * 0.4 * 2)
    assert len(got) == produced * 2
    assert hashlib.sha256(got).hexdigest() == sent.hexdigest()
    assert time.monotonic() - t0 < 10.0


# the sink audio tap: (mode, sample rate, Encoder arguments)
PCM_CASES = {"b": ("b", 2_000_000, {}),
             "i-nicam": ("i", 8_000_000, {}),
             "l-systeraudio": ("l", 8_000_000, {"systeraudio": True}),
             "pal-none": ("pal", 2_000_000, {})}


@pytest.mark.parametrize("case", list(PCM_CASES))
def test_block_audio_pcm(case):
    """Encoder.block_audio_pcm, blocks 0-2 of one and of three frames:
    the 32 kHz pairs of each block, volume-scaled and after the Syster
    inversion, equal the JAX encoder's; None where the mode has no
    sound."""
    from hacktv_tpu import Encoder as JEncoder
    from hacktv_tpu_torch import Encoder as TEncoder
    from hacktv_tpu_torch.av.noise import NoiseSource
    mode, rate, kw = PCM_CASES[case]
    p = TEncoder(mode, rate, device="cpu").params
    src = NoiseSource(p.active_width, p.conf.active_lines, seed=3)
    for fpb in (1, 3):
        j = JEncoder(mode, rate, source=src, frames_per_block=fpb, **kw)
        t = TEncoder(mode, rate, source=src, frames_per_block=fpb,
                     device="cpu", **kw)
        for b in range(3):
            got, ref = t.block_audio_pcm(b), j.block_audio_pcm(b)
            if ref is None:
                assert got is None and case == "pal-none"
                continue
            tc.assert_same(got, ref)
            assert len(got) == fpb * 32000 // 25


def test_frame_apis():
    """iter_frames, encode_frame_device and _encode_frame_dev: the JAX
    encoder's older frame APIs, the same samples."""
    from hacktv_tpu import Encoder as JEncoder
    from hacktv_tpu_torch import Encoder as TEncoder
    t = TEncoder("pal", 2_000_000, device="cpu")
    j = JEncoder("pal", 2_000_000)
    got = list(t.iter_frames(2))
    ref = list(j.iter_frames(2))
    assert len(got) == len(ref) == 2
    for a, b in zip(got, ref):
        tc.assert_same(a, b)
    for name in ("encode_frame_device", "_encode_frame_dev"):
        dev = getattr(TEncoder("pal", 2_000_000, device="cpu"), name)(0)
        tc.assert_same(t.collect_block(0, dev), ref[0])
