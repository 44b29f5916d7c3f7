"""The VBI services (hacktv_tpu_torch/services) against hacktv_tpu on the
CPU, byte for byte (tolerance 0): the host coders (WSS groups, the VITC
payload, CEA-608 characters, the teletext CRC, parity, TTI pages, the
magazine scheduler with its packet 8/30 clock and the raw packet reader,
ACP's AGC schedule, SiS's symbol queue and warm-up spill); each service's
block arrays (with the shared claimed mask) and its device `apply` on the
same seeded block; the ring lines each service adds to the warm-up spill;
and the constructor's refusals."""

from __future__ import annotations

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_common as tc
from _torch_vbi import CLOCK, COMBO, DEMO, RAW, check_blocks, clock, encoders
from hacktv_tpu import Encoder as JEncoder
from hacktv_tpu.services import cc608 as jcc
from hacktv_tpu.services import teletext as jtt
from hacktv_tpu.services import vitc as jvitc
from hacktv_tpu.services import wss as jwss
from hacktv_tpu_torch import Encoder as TEncoder
from hacktv_tpu_torch.transfer import arrays_to_device
from hacktv_tpu_torch.services import cc608 as tcc
from hacktv_tpu_torch.services import teletext as ttt
from hacktv_tpu_torch.services import vitc as tvitc
from hacktv_tpu_torch.services import wss as twss

# -- host coders ---------------------------------------------------------

def test_wss_modes_and_bytes_match_jax():
    tc.assert_same({k: v[0] for k, v in twss.MODES.items()},
                   {k: v[0] for k, v in jwss.MODES.items()}, "codes")
    tc.assert_same({k: list(v[1]) for k, v in twss.MODES.items()},
                   {k: list(v[1]) for k, v in jwss.MODES.items()}, "aspects")
    for code in range(256):
        assert twss.wss_vbi_bytes(code) == jwss.wss_vbi_bytes(code)


@pytest.mark.parametrize("fps,drop,is625", [(25, False, True),
                                            (30, True, False),
                                            (30, False, False)])
def test_vitc_payload_matches_jax(fps, drop, is625):
    frames = [0, 1, 2, 3, 1799, 1800, 1801, 17981, 17982, 17983, 107891,
              2_000_000]
    frames += np.random.default_rng(fps).integers(0, 3_000_000, 40).tolist()
    for f in frames:
        for second in (False, True):
            assert tvitc.vitc_payload(f, fps, drop, second, is625) == \
                jvitc.vitc_payload(f, fps, drop, second, is625), f


def test_cc608_chars_match_jax():
    for c1 in range(0, 256, 3):
        for c2 in range(0, 256, 5):
            assert tcc.encode_chars(c1, c2) == jcc.encode_chars(c1, c2)


def test_teletext_coders_match_jax():
    rng = np.random.default_rng(7)
    for n in (0, 1, 40, 1000):
        data = rng.integers(0, 256, n).astype(np.uint8).tobytes()
        assert ttt.crc16(data) == jtt.crc16(data)
        assert ttt.crc16(data, 0x1234) == jtt.crc16(data, 0x1234)
    tc.assert_same(ttt.HAMMING84, jtt.HAMMING84, "hamming")
    tc.assert_same(ttt._PARITY, jtt._PARITY, "parity")
    for src in (b"HELLO", b"AB\x00CD", bytes(range(1, 60))):
        a, b = bytearray(45), bytearray(45)
        ttt._paritycpy(a, 5, src, 40)
        jtt._paritycpy(b, 5, src, 40)
        assert a == b
    for y, m, d in ((2009, 2, 13), (2026, 10, 17), (1970, 1, 1)):
        assert ttt._mjd(y, m, d) == jtt._mjd(y, m, d)


def _pages(svc):
    out = []
    for mag in svc.magazines:
        for num in mag.pages:
            for pg in mag.subpages[num]:
                out.append((pg.page, pg.subpage, pg.subcode, pg.page_status,
                            pg.cycle_time, pg.cycle_mode, pg.links,
                            [bytes(x) for x in pg.packets]))
    return out


def test_tti_pages_match_jax(tmp_path):
    """demo.tti, and a directory holding it, a second page with fastext
    links and subpages, and a file that is not TTI (skipped)."""
    (tmp_path / "a.tti").write_bytes(open(DEMO, "rb").read())
    (tmp_path / "b.tti").write_bytes(
        b"PN,20001\r\nSC,0001\nPS,8000\nCT,4,C\nFL,100,200,300,400,8ff,"
        b"12345\nOL,3,\x1bASUB ONE\nPN,20002\nOL,5,SUB TWO\n")
    (tmp_path / "c.txt").write_bytes(b"not a page\n")
    (tmp_path / ".hidden").write_bytes(b"PN,30000\n")
    for path in (DEMO, str(tmp_path)):
        t = ttt.TeletextService(625, 25, clock)
        j = jtt.TeletextService(625, 25, clock)
        if os.path.isdir(path):
            for name in sorted(os.listdir(path)):
                if not name.startswith("."):
                    for mod, svc in ((ttt, t), (jtt, j)):
                        try:
                            mod.load_tti(svc, os.path.join(path, name))
                        except ValueError:
                            pass
        else:
            ttt.load_tti(t, path)
            jtt.load_tti(j, path)
        tc.assert_same(_pages(t), _pages(j), path)


@pytest.mark.parametrize("ticks", [False, True])
def test_teletext_scheduler_matches_jax(tmp_path, ticks):
    """5,000 lines of packets from the magazine scheduler: headers, the
    20 ms header-to-row rule, fillers, cycling subpages and, with a clock
    that ticks every 1,000 calls, the packet 8/30 time packets."""
    (tmp_path / "b.tti").write_bytes(
        b"PN,20001\nCT,1,T\nOL,3,SUB ONE\nPN,20002\nOL,5,SUB TWO\n"
        b"PN,12300\nOL,1,MAG ONE\n")
    calls = {"t": 0, "j": 0}

    def mk(key):
        def c():
            calls[key] += 1
            return CLOCK + (calls[key] // 1000 if ticks else 0)
        return c
    t = ttt.TeletextService(625, 25, mk("t"))
    j = jtt.TeletextService(625, 25, mk("j"))
    for mod, svc in ((ttt, t), (jtt, j)):
        mod.load_tti(svc, DEMO)
        mod.load_tti(svc, str(tmp_path / "b.tti"))
    for tcode in range(0, 50_000, 10):
        a, b = t.next_packet(tcode), j.next_packet(tcode)
        assert (None if a is None else bytes(a)) == \
            (None if b is None else bytes(b)), tcode


def test_raw_packet_reader_matches_jax():
    """The raw: stream's feof semantics: 7 packets and a short tail, a
    missing packet on the line after EOF, then the rewind."""
    path = RAW[4:]
    st_t, st_j = [False], [False]
    with open(path, "rb") as ft, open(path, "rb") as fj:
        for _ in range(40):
            assert ttt._read_raw_packet(ft, st_t) == \
                jtt._read_raw_packet(fj, st_j)


def test_acp_agc_schedule_matches_jax():
    j, t = encoders("pal", 16_000_000, {"acp": True})
    for f in list(range(0, 900, 7)) + [1712, 5000, 123_456]:
        assert t.services[0]._agc_level(f) == j.services[0]._agc_level(f)


def test_sis_symbols_and_spill_match_jax():
    """SiS's symbol queue over 20,000 lines (NICAM frames from its own
    audio chain, refilled 256 frames at a time and pruned) and its
    warm-up spill; the constructor's ValueError from 18.2 MS/s, in both
    packages."""
    j, t = encoders("pal", 16_000_000, {"sis": "dcsis"})
    js, ts = j.services[0], t.services[0]
    tc.assert_same(ts.warmup_spill, js.warmup_spill, "warmup_spill")
    for lo, hi in ((0, 500), (480, 9000), (9000, 480_000)):
        tc.assert_same(ts.state.syms_range(lo, hi),
                       js.state.syms_range(lo, hi), f"syms {lo}:{hi}")
        ts.state.prune_syms(lo)
        js.state.prune_syms(lo)
        assert ts.state._symq_base == js.state._symq_base
    for cls in (JEncoder, TEncoder):
        kw = {} if cls is JEncoder else {"device": "cpu"}
        with pytest.raises(ValueError):
            cls("pal", 20_250_000, sis="dcsis", **kw)


def test_vits_fused_mix():
    """VITS's chroma mix as the JAX encoder's step compiles it with exact
    carrier rows: fma(lut.i, cs.q / 2^15, lut.q * cs.i / 2^15), one
    rounding, against the same sum in f64 rounded once; unfused, the
    cs.q product rounds first, and the two differ on seeded carriers."""
    _, t = encoders("pal", 16_000_000, {"vits": True})
    v = t.services[0]
    assert v.fused_mix and v.cs == (16384, 28377)
    rng = np.random.default_rng(8)
    lut = [rng.integers(-32767, 32768, (625, 64)).astype(np.float32)
           for _ in range(2)]
    c = rng.integers(-6000, 6000, (625, 64)).astype(np.float32)
    v.d_c_tpl = torch.as_tensor(np.concatenate([np.zeros((1, 64)), c[:4]])
                                .astype(np.float32))
    v.d_r_tpl = torch.zeros(5, 64)
    idx = torch.as_tensor(np.arange(625) % 5)
    out = torch.zeros(625, 64)
    got = v.apply(out, {"idx": idx}, tuple(map(torch.as_tensor, lut)))
    exact = (lut[0].astype(np.float64) * (28377 / 32768)
             + lut[1].astype(np.float64) * 0.5).astype(np.float32)
    cc = v.d_c_tpl[idx].numpy()
    want = np.floor(np.floor(exact) * cc * np.float32(1 / 32768))
    tc.assert_same(got.numpy(), np.float32(0) + want, "fused mix")
    v.fused_mix = False
    unfused = v.apply(out, {"idx": idx}, tuple(map(torch.as_tensor, lut)))
    assert not torch.equal(unfused, got)


def test_wss_auto_aspect_matches_jax():
    j, t = encoders("pal", 16_000_000, {"wss": "auto"})
    for wide in (True, False, True):
        j.services[0].set_auto_aspect(wide)
        t.services[0].set_auto_aspect(wide)
        tc.assert_same(t.services[0].bits, j.services[0].bits, "bits")
        check_blocks(f"wss auto {wide}", j, t, [0])


# -- block arrays and apply ------------------------------------------------

@pytest.mark.parametrize("name", sorted(COMBO))
def test_block_arrays_and_apply_match_jax(name):
    """Every service's block_arrays (blocks 0 and 1, one shared claimed
    mask) and its apply on a seeded block with a seeded carrier, in the
    registration order.  The JAX applies run op by op here, each product
    rounded, so VITS's chroma mix is compared unfused; the product that
    the JAX encoder's compiled step fuses is held by the encoder tests
    (tests/test_torch_services_encoder.py, PAL at 13.5 MS/s)."""
    mode, rate, kw = COMBO[name]
    j, t = encoders(mode, rate, kw)
    for ts in t.services:
        if hasattr(ts, "fused_mix"):
            ts.fused_mix = False
    n = t.conf.lines + 1 + t.halo_after
    W = t.params.width
    rng = np.random.default_rng(len(name))
    for k0 in (-1, t.conf.lines - 1):
        cj, ct = np.zeros(n, bool), np.zeros(n, bool)
        block = rng.integers(-12000, 24000, (n, W)).astype(np.float32)
        lut = tuple(rng.integers(-32767, 32768, (n, W)).astype(np.float32)
                    for _ in range(2))
        oj = jnp.asarray(block)
        ot = torch.as_tensor(block)
        for js, ts in zip(j.services, t.services):
            aj = js.block_arrays(k0, n, cj)
            at = ts.block_arrays(k0, n, ct)
            tc.assert_same(at, aj, f"{type(ts).__name__} arrays k0={k0}")
            tc.assert_same(ct, cj, f"{type(ts).__name__} claimed")
            oj = js.apply(oj, aj, tuple(jnp.asarray(x) for x in lut))
            ot = ts.apply(ot, arrays_to_device(at, "cpu"),
                          tuple(torch.as_tensor(x) for x in lut))
            tc.assert_same(ot.numpy(), np.asarray(oj),
                           f"{type(ts).__name__} apply k0={k0}")
