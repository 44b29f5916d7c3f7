"""The scramblers' host state and device applies against hacktv_tpu on the
CPU, byte for byte: Videocrypt's per-frame VBI bytes and cut bytes (free,
conditional, Videocrypt II free) over 16 frames, Videocrypt S's over the
full 260-frame table period, Syster's shuffle sources and VBI lines over
52 frames (the PRBS resets of frames 6 and 31), the Syster control-word
DES, the cut-and-rotate column table, Discret 11's delay table, the
Syster audio inversion on the test tone and on seeded int16, and each
scrambler's apply on a seeded random block against the JAX apply."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_common as tc
from hacktv_tpu.config.standards import get_mode as jget_mode
from hacktv_tpu.services import syster as jsyster
from hacktv_tpu.services import syster_ca as jca
from hacktv_tpu.services import videocrypt as jvc
from hacktv_tpu.services import videocrypts as jvcs
from hacktv_tpu.video.params import VideoParams as JParams
from hacktv_tpu_torch.av.testcard import TestCardSource as _Card
from hacktv_tpu_torch.config import get_mode
from hacktv_tpu_torch.transfer import arrays_to_device
from hacktv_tpu_torch.services import syster as tsyster
from hacktv_tpu_torch.services import syster_ca as tca
from hacktv_tpu_torch.services import videocrypt as tvc
from hacktv_tpu_torch.services import videocrypts as tvcs
from hacktv_tpu_torch.video.params import VideoParams as TParams


@pytest.mark.parametrize("mode,mode2", [("free", None),
                                        ("conditional", None),
                                        (None, "free"), ("free", "free")])
def test_vc_state_matches_jax(mode, mode2):
    """Frames 1-16 (two message cycles of VC1, the VC2 codeword switch at
    16), then frame 12 again from the 8-frame cache."""
    tb = (tvc._FA_BLOCKS if mode == "free" else tvc._MTV_BLOCKS
          if mode else ())
    jb = (jvc._FA_BLOCKS if mode == "free" else jvc._MTV_BLOCKS
          if mode else ())
    t = tvc._VCState(tb, tvc._FA2_BLOCKS if mode2 else ())
    j = jvc._VCState(jb, jvc._FA2_BLOCKS if mode2 else ())
    for f in list(range(1, 17)) + [12]:
        tc.assert_same(t.frame(f), j.frame(f), f"frame {f}")
    assert (t.sr1, t.sr2, t.c, t.cw) == (j.sr1, j.sr2, j.c, j.cw)


@pytest.mark.parametrize("mode", ["free", "conditional"])
def test_vcs_state_matches_jax(mode):
    t = tvcs._VCSState(tvcs._FA_BLOCKS if mode == "free"
                       else tvcs._BBC_BLOCKS)
    j = jvcs._VCSState(jvcs._FA_BLOCKS if mode == "free"
                       else jvcs._BBC_BLOCKS)
    for f in range(1, 261):
        tc.assert_same(t.frame(f), j.frame(f), f"frame {f}")


def test_scramble_tables_match_jax():
    """The port's own copy of the sequence file holds the JAX package's
    tables."""
    tz = np.load(tvcs._SEQ_FILE)
    jz = np.load(jvcs._SEQ_FILE)
    assert tvcs._SEQ_FILE != jvcs._SEQ_FILE
    assert sorted(tz.files) == sorted(jz.files)
    for k in jz.files:
        tc.assert_same(tz[k], jz[k], k)


@pytest.mark.parametrize("mode,kw", [
    ("premiere-fa", {"syster": True, "systercnr": False}),
    ("cfrca", {"syster": True, "systercnr": True}),
    ("premiere-ca", {"syster": False, "systercnr": True}),
    ("ntvfa", {"syster": True, "systercnr": False, "key_table": 1}),
    ("premiere-fa", {"syster": False, "systercnr": False, "d11": True}),
])
def test_ng_state_matches_jax(mode, kw):
    """shuffle_src and vbi_for_line over 52 frames, the PRBS resets of
    frames 6 and 31 among them, and the ECM's control word."""
    t = tsyster._NGState(mode, **kw)
    j = jsyster._NGState(mode, **kw)
    t.retain = j.retain = 60
    assert (t.ecm, t.ecm_cw, t.flags, t.table) == \
        (j.ecm, j.ecm_cw, j.flags, j.table)
    off = t.vbioffset
    for f in range(1, 53):
        tc.assert_same(t.shuffle_src(f), j.shuffle_src(f), f"src {f}")
        for line in (14 + off, 15 + off, 327 + off, 328 + off):
            k = (f - 1) * 625 + line - 1
            assert t.vbi_for_line(k) == j.vbi_for_line(k), (f, line)
    assert (t.sr1, t.sr2, t.s, t.r) == (j.sr1, j.sr2, j.s, j.r)
    tc.assert_same(np.asarray(t.order), np.asarray(j.order), "order")


@pytest.mark.parametrize("seed", range(4))
def test_encrypt_syster_cw_matches_jax(seed):
    rng = np.random.default_rng(seed)
    ecm = [int(x) for x in rng.integers(0, 256, 16)]
    key = [int(x) for x in rng.integers(0, 256, 8)]
    for m in (tca.NG_ENCRYPT, tca.NG_DECRYPT):
        te, je = list(ecm), list(ecm)
        assert tca.encrypt_syster_cw(te, key, m) == \
            jca.encrypt_syster_cw(je, key, m)
        assert te == je


@pytest.mark.parametrize("mode,rate", [("pal", 16_000_000),
                                       ("l", 20_000_000),
                                       ("pal", 13_500_000)])
def test_rotate_columns_match_jax(mode, rate):
    tp = TParams.create(get_mode(mode), rate, 0)
    jp = JParams.create(jget_mode(mode), rate, 0)
    tc.assert_same(tsyster._video_scale(tp), jsyster._video_scale(jp),
                   "video scale")
    tc.assert_same(tsyster._rotate_columns(tp, tsyster._video_scale(tp)),
                   jsyster._rotate_columns(jp, jsyster._video_scale(jp)),
                   "columns")


def test_d11_delay_table_matches_jax():
    tc.assert_same(tsyster._d11_delay_table(), jsyster._d11_delay_table(),
                   "delays")


class _Seeded:
    def __init__(self, seed):
        self.seed = seed

    def read_audio(self, start, count):
        rng = np.random.default_rng(self.seed + start)
        return rng.integers(-32768, 32768, (count, 2)).astype(np.int16)


@pytest.mark.parametrize("src", ["tone", "seeded"])
def test_audio_inverter_matches_jax(src):
    """SysterAudioInverter.process on the test card's tone and on seeded
    int16, from before the stream start and in the middle of it."""
    feed = (_Card(702, 576).read_audio if src == "tone"
            else _Seeded(3).read_audio)
    t, j = tsyster.SysterAudioInverter(), jsyster.SysterAudioInverter()
    for start, count in ((-500, 1200), (0, 20000), (31_999, 4096)):
        tc.assert_same(t.process(feed, start, count),
                       j.process(feed, start, count), f"{start}+{count}")


def _services(name, p_t, p_j):
    """The port's scrambler and the JAX package's, on PAL params."""
    if name == "videocrypt":
        return (tvc.Videocrypt(p_t, "free", "free", device="cpu"),
                jvc.Videocrypt(p_j, "free", "free"))
    if name == "videocrypts":
        return (tvcs.VideocryptS(p_t, "free", device="cpu"),
                jvcs.VideocryptS(p_j, "free"))
    if name == "syster":
        return (tsyster.Syster(p_t, "premiere-fa", device="cpu"),
                jsyster.Syster(p_j, "premiere-fa"))
    if name == "syster-cnr":
        return (tsyster.Syster(p_t, "cfrfa", cnr=True, device="cpu"),
                jsyster.Syster(p_j, "cfrfa", cnr=True))
    if name == "systercnr":
        return (tsyster.SysterCNR(p_t, "premiere-fa", device="cpu"),
                jsyster.SysterCNR(p_j, "premiere-fa"))
    return (tsyster.D11(p_t, "premiere-fa", device="cpu"),
            jsyster.D11(p_j, "premiere-fa"))


@pytest.mark.parametrize("name", ["videocrypt", "videocrypts", "syster",
                                  "syster-cnr", "systercnr", "d11"])
def test_apply_matches_jax(name):
    """block_arrays of blocks 0 and 2 (one frame, with the service's
    halo) and apply on a seeded random block, against the JAX service."""
    p_t = TParams.create(get_mode("pal"), 16_000_000, 0)
    p_j = JParams.create(jget_mode("pal"), 16_000_000, 0)
    ts, js = _services(name, p_t, p_j)
    tc.assert_same(ts.basis, js.basis, "basis")
    n = 625 + 1 + getattr(ts, "lookahead", 1)
    rng = np.random.default_rng(17)
    for b in (0, 2):
        ct, cj = np.zeros(n, bool), np.zeros(n, bool)
        at = ts.block_arrays(b * 625 - 1, n, ct)
        aj = js.block_arrays(b * 625 - 1, n, cj)
        tc.assert_same(at, aj, f"arrays {b}")
        tc.assert_same(ct, cj, f"claimed {b}")
        block = rng.integers(-20000, 30000, (n, p_t.width)).astype(
            np.float32)
        got = ts.apply(torch.as_tensor(block), arrays_to_device(at, "cpu"))
        ref = js.apply(jnp.asarray(block),
                       {k: jnp.asarray(v) for k, v in aj.items()})
        tc.assert_same(got.numpy(), np.asarray(ref), f"apply {b}")
