"""Encoder configurations with the VBI services, shared by the tests
that hold them against hacktv_tpu (tests/test_torch_services*.py)."""

from __future__ import annotations

import os

import _torch_common as tc
from hacktv_tpu import Encoder as JEncoder
from hacktv_tpu_torch import Encoder as TEncoder
from hacktv_tpu_torch.av.noise import NoiseSource

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
DEMO = os.path.join(DATA, "demo.tti")
RAW = "raw:" + os.path.join(DATA, "raw_tt_packets.bin")
CLOCK = 1_200_000_000


def clock():
    return CLOCK


# name: (mode, sample rate, Encoder arguments): one service at a time, on
# 625- and 525-line modes where the service allows it
ALONE = {
    "pal-vits": ("pal", 16_000_000, {"vits": True}),
    "ntsc-vits": ("ntsc", 13_500_000, {"vits": True}),
    "pal-vits-13.5": ("pal", 13_500_000, {"vits": True}),
    "pal-vits-angle": ("pal", 13_513_500, {"vits": True}),
    "m-vits-angle": ("m", 13_513_500, {"vits": True}),
    "pal-wss-auto": ("pal", 16_000_000, {"wss": "auto"}),
    "pal-wss-16:9": ("pal", 16_000_000, {"wss": "16:9"}),
    "pal-vitc": ("pal", 16_000_000, {"vitc": True}),
    "ntsc-vitc": ("ntsc", 13_500_000, {"vitc": True}),
    "pal-cc608": ("pal", 16_000_000, {"cc608": True}),
    "ntsc-cc608": ("ntsc", 13_500_000, {"cc608": True}),
    "pal-acp": ("pal", 16_000_000, {"acp": True}),
    "ntsc-acp": ("ntsc", 13_500_000, {"acp": True}),
    "pal-teletext": ("pal", 16_000_000, {"teletext": DEMO}),
    "pal-teletext-raw": ("pal", 16_000_000, {"teletext": RAW}),
    "pal-sis": ("pal", 16_000_000, {"sis": "dcsis"}),
}
# everything at once on one 625-line signal (the claimed mask: VITS
# takes lines 17-18 from ACP, ACP lines 9-16 from teletext, ...)
COMBO = {
    "pal-vits-wss-vitc-teletext": ("pal", 16_000_000, {
        "vits": True, "wss": "16:9", "vitc": True, "teletext": DEMO}),
    "pal-all": ("pal", 16_000_000, {
        "vits": True, "wss": "auto", "acp": True, "vitc": True,
        "cc608": True, "sis": "dcsis", "teletext": DEMO}),
    "ntsc-all": ("ntsc", 13_500_000, {
        "vits": True, "acp": True, "vitc": True, "cc608": True}),
}
# blocks held (one frame each) where two are not enough: SiS's symbol
# queue; the first block in which XLA's fused VITS mix and a rounded one
# differ (block 2 at 13.5 MS/s with exact carrier rows, block 3 at
# 13.5135 MS/s with the angle addition, where XLA rounds both products)
BLOCKS = {"pal-sis": 3, "pal-vits-13.5": 3, "pal-vits-angle": 4}
CAPTIONS = [(0x14, 0x20), (0x48, 0x49), (0x00, 0x00), (0x21, 0x7F)]


def _kw(kw):
    kw = dict(kw)
    if "teletext" in kw:
        kw["teletext_clock"] = clock
    return kw


def encoders(mode, rate, kw, fpb=1, seed=5):
    """The JAX encoder and the port's on the same noise source, with the
    same caption pairs queued: the warm-up spill (ring lines) must
    agree."""
    if mode == "i" or "sis" in kw:
        # the JAX package's NICAM frame coder runs in its native runtime
        tc.jax_runtime()
    p = TEncoder(mode, rate, device="cpu").params
    src = NoiseSource(p.active_width, p.conf.active_lines, seed=seed)
    j = JEncoder(mode, rate, source=src, frames_per_block=fpb, **_kw(kw))
    t = TEncoder(mode, rate, source=src, frames_per_block=fpb,
                 device="cpu", **_kw(kw))
    assert t._spill_warmup == j._spill_warmup
    assert t.halo_after == j.halo_after
    assert [type(s).__name__ for s in t.services] == \
        [type(s).__name__ for s in j.services]
    for js, ts in zip(j.services, t.services):
        if hasattr(ts, "write_pair"):
            for pair in CAPTIONS:
                js.write_pair(*pair)
                ts.write_pair(*pair)
    return j, t


def check_blocks(name, j, t, blocks):
    for b in blocks:
        ref, got = j.encode_block(b), t.encode_block(b)
        assert got.shape == ref.shape and got.dtype == ref.dtype
        snr, maxerr, ndiff = tc.error_report(got, ref)
        assert ndiff == 0, (f"{name} block {b}: {ndiff} of {ref.size} "
                            f"samples differ, max {maxerr}, {snr:.1f} dB")
