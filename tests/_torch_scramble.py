"""Encoder configurations with the scramblers, shared by the tests that
hold them against hacktv_tpu (tests/test_torch_scramble_encoder_*.py)."""

from __future__ import annotations

import _torch_common as tc
from _torch_vbi import check_blocks  # noqa: F401 (shared with the tests)
from hacktv_tpu import Encoder as JEncoder
from hacktv_tpu_torch import Encoder as TEncoder
from hacktv_tpu_torch.av.noise import NoiseSource

RATE = 16_000_000
# name: (mode, Encoder arguments), 16 MS/s, one-frame blocks
VIDEOCRYPT = {
    "i-videocrypt": ("i", {"videocrypt": "free"}),
    "pal-videocrypt-conditional": ("pal", {"videocrypt": "conditional"}),
    "pal-videocrypt2": ("pal", {"videocrypt2": "free"}),
    "pal-videocrypt-1-2": ("pal", {"videocrypt": "free",
                                   "videocrypt2": "free"}),
    "i-videocrypts": ("i", {"videocrypts": "free"}),
}
SYSTER = {
    "pal-syster": ("pal", {"syster": "premiere-fa"}),
    "l-syster-audio-vsb": ("l", {"syster": "premiere-fa",
                                 "systeraudio": True, "vfilter": True}),
    "pal-systercnr": ("pal", {"systercnr": "premiere-fa"}),
    "pal-syster-systercnr": ("pal", {"syster": "premiere-fa",
                                     "systercnr": "premiere-fa"}),
    "l-d11": ("l", {"d11": "premiere-fa"}),
    "i-sis-systeraudio": ("i", {"sis": "dcsis", "systeraudio": True}),
}
# blocks held where three are not enough: Syster's 345-line halo with
# SECAM's IIR carry and the VSB filter's stream crosses every boundary
BLOCKS = {"l-syster-audio-vsb": 4}


def encoders(mode, kw, fpb=1, seed=5):
    """The JAX encoder and the port's on the same noise source; the
    warm-up spill (ring lines), the bottom halo and the services agree."""
    if mode in ("i", "l"):
        # the JAX package's NICAM frame coder runs in its native runtime
        tc.jax_runtime()
    p = TEncoder(mode, RATE, device="cpu").params
    src = NoiseSource(p.active_width, p.conf.active_lines, seed=seed)
    j = JEncoder(mode, RATE, source=src, frames_per_block=fpb, **kw)
    t = TEncoder(mode, RATE, source=src, frames_per_block=fpb,
                 device="cpu", **kw)
    assert t._spill_warmup == j._spill_warmup
    assert t.halo_after == j.halo_after
    assert [type(s).__name__ for s in t.services] == \
        [type(s).__name__ for s in j.services]
    return j, t
