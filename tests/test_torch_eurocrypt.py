"""Eurocrypt (services/eurocrypt.py) against hacktv_tpu, byte for byte:
the cipher (ec_des in every mode and algorithm, System S), glibc's rand,
every provider's first ECM with the wall clock pinned, and the D/D2-MAC
multiplex through frame 260 (the CW toggles at frames 1 and 257, ECMs
every 64 frames, the EMM round one frame after 0x7F) for EC-M
(filmnet), S2 (tv2), System S (teletv) and 3DES (cplus), and with a
maturity rating and pay-per-view.  Inputs come from numpy seeds."""

from __future__ import annotations

import numpy as np
import pytest

import _torch_common as tc
from _torch_mac import NOW, check_mux, muxes
from hacktv_tpu.services import eurocrypt as jec
from hacktv_tpu_torch.services import eurocrypt as tec


def test_tables_match_jax():
    tc.assert_same(sorted(tec.EC_MODES), sorted(jec.EC_MODES), "EC_MODES")
    for k in jec.EC_MODES:
        tc.assert_same(tec.EC_MODES[k], jec.EC_MODES[k], k)
    for k in jec.EM_MODES:
        tc.assert_same(tec.EM_MODES[k], jec.EM_MODES[k], k)


@pytest.mark.parametrize("algo", ["EC_M", "EC_S", "EC_S2", "EC_3DES"])
def test_ec_des_matches_jax(algo):
    rng = np.random.default_rng(len(algo))
    a = getattr(tec, algo)
    for desmode in (tec._ECM, tec._HASH):
        for rnd in (1, 2, 3):
            key = bytes(rng.integers(0, 256, 8, dtype=np.uint8))
            data = bytearray(rng.integers(0, 256, 8, dtype=np.uint8))
            x, y = bytearray(data), bytearray(data)
            tec.ec_des(x, key, desmode, a, rnd)
            jec.ec_des(y, key, desmode, a, rnd)
            assert x == y, (algo, desmode, rnd)


def test_system_s_and_hash_match_jax():
    rng = np.random.default_rng(7)
    for _ in range(3):
        key = bytes(rng.integers(0, 256, 8, dtype=np.uint8))
        buf = bytearray(rng.integers(0, 256, 45, dtype=np.uint8))
        x, y = bytearray(buf), bytearray(buf)
        tec.system_s_encrypt(x, key)
        jec.system_s_encrypt(y, key)
        assert x == y
        for mode in (tec.EC_M, tec.EC_S2, tec.EC_3DES):
            k = key * 2 if mode == tec.EC_3DES else key
            assert tec._calc_hash(bytes(buf[:27]), mode, k) == \
                jec._calc_hash(bytes(buf[:27]), mode, k)
    for d, m, y in ((1, 1, 1990), (31, 12, 1999), (19, 11, 2024)):
        for mode in (tec.EC_M, tec.EC_S2, tec.EC_3DES):
            assert tec.pack_date(d, m, y, mode) == \
                jec.pack_date(d, m, y, mode)


@pytest.mark.parametrize("seed", [1, 12345, 2**32 - 1])
def test_glibc_rand_matches_jax(seed):
    t, j = tec.GlibcRand(seed), jec.GlibcRand(seed)
    assert [t() for _ in range(500)] == [j() for _ in range(500)]
    if seed == 1:       # glibc random() with seed 1
        assert tec.GlibcRand(1)() == 1804289383


@pytest.mark.parametrize("provider", sorted(jec.EC_MODES))
def test_provider_ecm_matches_jax(provider):
    """Each provider, constructed with the clock pinned: its control
    words, first ECM and SI entry; with --nodate, a maturity rating and
    pay-per-view too."""
    for kw in ({}, {"nodate": True, "mat_rating": 13, "ppv": "1234,5"}):
        t = tec.Eurocrypt(provider, now=NOW, **kw)
        j = jec.Eurocrypt(provider, now=NOW, **kw)
        assert (t.ecm_pkt, t.ecm_cont) == (j.ecm_pkt, j.ecm_cont), kw
        assert (t.cw, t.ecw) == (j.cw, j.ecw)
        assert t.si_info() == j.si_info()
        for tog in (0, 1):
            assert t._build_ecm(tog) == j._build_ecm(tog)


def test_unknown_provider_raises_as_jax():
    for mod in (tec, jec):
        with pytest.raises(ValueError, match="unknown Eurocrypt mode"):
            mod.Eurocrypt("nosuchprovider")


@pytest.mark.parametrize("mode,provider,vsam", [
    ("d2mac", "filmnet", 6),     # EC-M, EMM-G; single cut
    ("d2mac", "tv2", 6),         # EC-S2 algorithm, EMM-U
    ("dmac", "teletv", 6),       # System S
    ("d2mac", "cplus", 4),       # 3DES; double cut
])
def test_multiplex_through_frame_260_matches_jax(mode, provider, vsam):
    """The multiplex with Eurocrypt and scrambled audio through frame 260:
    the packed line bits, the cut points keyed by the control word, the
    ECM/EMM packets in the queues."""
    j, t = muxes(mode, vsam=vsam, provider=provider, scramble_audio=True)
    check_mux(f"{mode} {provider}", j, t, 260, step_frames=20)


@pytest.mark.parametrize("ec_kwargs", [{"mat_rating": 13},
                                       {"ppv": "1234,5"}],
                         ids=["mat-rating", "ppv"])
def test_multiplex_access_criteria_match_jax(ec_kwargs):
    """--ec-mat-rating and --ec-ppv in the ECMs (ctv), through frame 130:
    two ECM rounds and the EMM round."""
    j, t = muxes("d2mac", vsam=6, provider="ctv", ec_kwargs=ec_kwargs)
    check_mux("ctv", j, t, 130, step_frames=26)
