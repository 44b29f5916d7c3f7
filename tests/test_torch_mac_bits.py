"""The D/D2-MAC host coders against hacktv_tpu, byte for byte: every
function of ops/mac_bits.py (bit packing, PRBS15 and the line seeds, the
CA keystreams PRBS1/PRBS2, the PRBS3 packet scrambler, CRC, BCH, Golay,
the packet interleave and encoder, UDT, the SI DG0/DG3 packets, the sync
words, lines 624 and 625), the native calls against their plain Python
versions, and the MAC audio coder (audio/mac_audio.py) in all sixteen
quality, stereo, protection and companding combinations, native against
Python and against the JAX package.  Inputs come from numpy seeds."""

from __future__ import annotations

import itertools

import numpy as np
import pytest

import _torch_common as tc
from hacktv_tpu.audio import mac_audio as jma
from hacktv_tpu.ops import mac_bits as jmb
from hacktv_tpu_torch.audio import mac_audio as tma
from hacktv_tpu_torch.ops import mac_bits as tmb

RNG = np.random.default_rng(20250)


def _payload(rng, n=91):
    return bytes(rng.integers(0, 256, n, dtype=np.uint8))


def test_constants_match_jax():
    for name in ("MAC_WIDTH", "MAC_LINES", "MAC_PACKET_BITS",
                 "MAC_PAYLOAD_BYTES", "MAC_CLAMP", "MAC_LSW", "MAC_CRI",
                 "MAC_FSW", "PRBS_CW_FA", "HAMMING", "RDF_D", "RDF_D2",
                 "_INTERLEAVE"):
        tc.assert_same(getattr(tmb, name), getattr(jmb, name), name)


def test_bit_helpers_match_jax():
    rng = np.random.default_rng(1)
    for v, n in zip(rng.integers(0, 2**62, 20), rng.integers(1, 63, 20)):
        v, n = int(v), int(n)
        tc.assert_same(tmb.bits_lsb(v, n), jmb.bits_lsb(v, n), "bits_lsb")
        tc.assert_same(tmb.rbits_msb(v, n), jmb.rbits_msb(v, n),
                       "rbits_msb")
        assert tmb.parity(v) == jmb.parity(v)
    data = _payload(rng, 37)
    tc.assert_same(tmb.bytes_to_bits_lsb(data), jmb.bytes_to_bits_lsb(data),
                   "bytes_to_bits_lsb")
    bits = rng.integers(0, 2, 45, dtype=np.uint8)
    assert tmb.bits_to_bytes_lsb(bits) == jmb.bits_to_bytes_lsb(bits)


@pytest.mark.parametrize("mode_d", [False, True])
def test_prbs15_and_line_seeds_match_jax(mode_d):
    tg, jg = tmb.prbs15(), jmb.prbs15()
    tc.assert_same(tg.outs, jg.outs, "outs")
    tc.assert_same(tg.states, jg.states, "states")
    seeds = tmb.line_prbs_seeds(mode_d)
    tc.assert_same(seeds, jmb.line_prbs_seeds(mode_d), "seeds")
    for s in seeds[::97]:
        tc.assert_same(tg.seq(int(s), 40000), jg.seq(int(s), 40000), "seq")
        assert tg.advance(int(s), 1296) == jg.advance(int(s), 1296)


def test_reversal_and_iw_match_jax():
    rng = np.random.default_rng(2)
    for v in rng.integers(0, 2**61, 50):
        v = int(v)
        for x in (29, 31, 61):
            assert tmb._rev(v & ((1 << x) - 1), x) == \
                jmb._rev(v & ((1 << x) - 1), x)
        assert tmb.prbs_generate_iw(v & (2**60 - 1), v & 0xFF) == \
            jmb.prbs_generate_iw(v & (2**60 - 1), v & 0xFF)
    a = rng.integers(0, 2**31, 64)
    tc.assert_same(tmb._rev_arr(a, 31), jmb._rev_arr(a, 31), "_rev_arr")


@pytest.mark.parametrize("cls", ["CaPrbs1", "CaPrbs2"])
def test_ca_prbs_native_matches_python_and_jax(cls):
    """The keystreams from the native runtime, from the port's Python
    recurrence and from the JAX package, over resets with the free-access
    word and a seeded control word, through single updates and bulk
    takes."""
    tc.jax_runtime()
    rng = np.random.default_rng(3)
    gens = [getattr(tmb, cls)(True), getattr(tmb, cls)(False),
            getattr(jmb, cls)()]
    for cw, fcnt in [(tmb.PRBS_CW_FA, 0), (int(rng.integers(0, 2**60)), 17),
                     (int(rng.integers(0, 2**60)), 255)]:
        for g in gens:
            g.reset(cw, fcnt)
        outs = [[int(g.update()) for _ in range(5)] + g.take(150).tolist()
                + [int(g.update())] for g in gens]
        assert outs[0] == outs[1] == outs[2], (cls, cw, fcnt)


def test_scramble_packet_and_codes_match_jax():
    rng = np.random.default_rng(4)
    for _ in range(4):
        pkt = bytearray(_payload(rng))
        iw = int(rng.integers(0, 2**61))
        a, b = bytearray(pkt), bytearray(pkt)
        tmb.scramble_packet(a, iw)
        jmb.scramble_packet(b, iw)
        assert a == b
        assert tmb.crc16(bytes(pkt)) == jmb.crc16(bytes(pkt))
        assert tmb.golay_encode(bytes(pkt[:45]), 30) == \
            jmb.golay_encode(bytes(pkt[:45]), 30)
    for n, k in ((23, 12), (71, 57)):
        bits = rng.integers(0, 2, (16, k), dtype=np.uint8)
        tc.assert_same(tmb.bch_encode(bits[0], n, k),
                       jmb.bch_encode(bits[0], n, k), "bch_encode")
        tc.assert_same(tmb.bch_encode_batch(bits, n, k),
                       jmb.bch_encode_batch(bits, n, k), "bch_encode_batch")
        tc.assert_same(tmb.bch_encode_batch(bits, n, k)[3],
                       tmb.bch_encode(bits[3], n, k), "batch row")


@pytest.mark.parametrize("scramble", [False, True])
def test_encode_packet_native_matches_python_and_jax(scramble):
    """rt_mac_encode_packet against the plain encoder (BCH header,
    interleave, PRBS3 scramble) and the JAX package's, with and without a
    payload, short payloads zero-padded."""
    rng = np.random.default_rng(5 + scramble)
    for i in range(12):
        addr = int(rng.integers(0, 1024))
        cont = int(rng.integers(0, 4))
        iw = int(rng.integers(0, 2**61))
        pl = None if i == 0 else _payload(rng, 91 if i % 3 else 60)
        if scramble and pl is not None and len(pl) != 91:
            continue
        nat = tmb.encode_packet_fast(addr, cont, pl, scramble, iw)
        py = tmb.encode_packet_fast(addr, cont, pl, scramble, iw,
                                    native=False)
        ref = jmb.encode_packet_fast(addr, cont, pl, scramble, iw)
        tc.assert_same(nat, py, f"packet {i} native/python")
        tc.assert_same(nat, ref, f"packet {i} port/jax")
        if not scramble:
            tc.assert_same(tmb.encode_packet(addr, cont, pl),
                           jmb.encode_packet(addr, cont, pl), "plain")


@pytest.mark.parametrize("ts", [1_200_000_000, 946_684_799, 1_700_000_123])
def test_udt_matches_jax(ts):
    tc.assert_same(tmb.build_udt(ts), jmb.build_udt(ts), "udt")
    tc.assert_same(tmb.build_udt(ts, 3600), jmb.build_udt(ts, 3600), "gmt")


@pytest.mark.parametrize("mode_d", [False, True])
def test_si_packets_and_sync_lines_match_jax(mode_d):
    for addr in (0xE0, 128, 0xB8):
        assert tmb.si_dg0_packet(addr) == jmb.si_dg0_packet(addr)
        for vsam, ratio, tt, ec in itertools.product(
                (0, 1, 2, 6), (0, 1), (False, True),
                (None, {"ecm_addr": 346, "packet_type": 0x20})):
            assert tmb.si_dg3_packet(addr, vsam, ratio, tt, ec) == \
                jmb.si_dg3_packet(addr, vsam, ratio, tt, ec)
    for frame, line in ((1, 1), (2, 623), (7, 625), (8, 624)):
        tc.assert_same(tmb.hsync_word_bits(frame, line),
                       jmb.hsync_word_bits(frame, line), "hsync")
    tc.assert_same(tmb.line_624_bits(mode_d), jmb.line_624_bits(mode_d),
                   "line 624")


@pytest.mark.parametrize("mode_d", [False, True])
def test_line_625_state_matches_jax(mode_d):
    """Line 625's content (UDT digit, SDF, the RDF cycle with its LINKS
    toggles), one frame at a time and batched, the state carried on."""
    udt = tmb.build_udt(1_200_000_000)
    ts, js = tmb.Line625State(mode_d), jmb.Line625State(mode_d)
    for f in range(1, 9):
        tc.assert_same(ts.content_bits(f, udt, 0xE8B5, 6, 1),
                       js.content_bits(f, udt, 0xE8B5, 6, 1), f"frame {f}")
    frames = np.arange(9, 40)
    tc.assert_same(ts.content_bits_batch(frames, udt, 0x1234, 1, 0),
                   js.content_bits_batch(frames, udt, 0x1234, 1, 0),
                   "batch")
    tc.assert_same((ts.rdf, ts.links), (js.rdf, js.links), "state")


AUDIO = list(itertools.product((True, False), repeat=4))


@pytest.mark.parametrize("hq,stereo,prot,comp", AUDIO,
                         ids=lambda v: "x" if v else "o")
def test_mac_audio_native_matches_python_and_jax(hq, stereo, prot, comp):
    """MacAudioEnc in one quality/stereo/protection/companding mode: the
    packets of seeded PCM chunks through write_audio and the batched
    write_audio_batch (packed and as lists), rt_mac_audio_blocks against
    the numpy coder and against the JAX package."""
    tc.jax_runtime()
    rng = np.random.default_rng(int(hq) | int(stereo) << 1
                                | int(prot) << 2 | int(comp) << 3)
    cfg = dict(high_quality=hq, stereo=stereo, protection=prot,
               linear=not comp, scramble=True, conditional=False)
    encs = [tma.MacAudioEnc(**cfg), tma.MacAudioEnc(**cfg, native=False),
            jma.MacAudioEnc(**cfg)]
    pcm = rng.integers(-32768, 32768, (4096, 2)).astype(np.int16)
    pcm[:512] //= 64                     # quiet stretch: small scale factors
    chunks = [pcm[i:i + 32] for i in range(0, 1024, 32)]
    for ch in chunks[:8]:
        outs = [e.write_audio(ch) for e in encs]
        tc.assert_same(outs[0], outs[1], "write_audio native/python")
        tc.assert_same(outs[0], outs[2], "write_audio port/jax")
    outs = [e.write_audio_batch(chunks[8:]) for e in encs]
    tc.assert_same(outs[0], outs[1], "batch native/python")
    tc.assert_same(outs[0], outs[2], "batch port/jax")
    rest = pcm[1024:]
    big = [rest[i:i + 32] for i in range(0, len(rest), 32)]
    outs = [e.write_audio_batch(big, packed=True, contig=rest)
            for e in encs]
    tc.assert_same(outs[0], outs[1], "packed native/python")
    tc.assert_same(outs[0], outs[2], "packed port/jax")
    assert [e.address for e in encs[:2]] == [encs[2].address] * 2
    assert encs[0].si_pkt == encs[2].si_pkt
