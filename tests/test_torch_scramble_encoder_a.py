"""Encoders with Videocrypt I, II and S against hacktv_tpu on the CPU, byte
for byte, over one-frame blocks 0-2: PAL-I with Videocrypt free (the
common hacktv use, to Sky decoders), PAL with Videocrypt conditional,
with Videocrypt II free, with I and II free together, PAL-I with
Videocrypt S; PAL-I with Videocrypt over two-frame blocks; the
scramblers' arrays carried over from the JAX encoder (convert.py); and
the JAX package's refusals."""

from __future__ import annotations

import numpy as np
import pytest

import _torch_common as tc
from _torch_scramble import RATE, VIDEOCRYPT, check_blocks, encoders
from hacktv_tpu_torch import Encoder as TEncoder
from hacktv_tpu_torch import convert


@pytest.mark.parametrize("name", sorted(VIDEOCRYPT))
def test_videocrypt_matches_jax(name):
    mode, kw = VIDEOCRYPT[name]
    j, t = encoders(mode, kw)
    check_blocks(name, j, t, range(3))


def test_videocrypt_two_frame_blocks_match_jax():
    """Two-frame blocks 0-2: the per-frame cut bytes and VBI packets
    across a block's two frames and its halo line."""
    j, t = encoders("pal", {"videocrypt": "free"}, fpb=2)
    check_blocks("pal-videocrypt (2 frames)", j, t, range(3))


@pytest.mark.parametrize("name", ["pal-videocrypt-1-2", "i-videocrypts"])
def test_scrambler_statics_carry_over(name):
    """The scramblers' arrays, read from the JAX encoder's service objects
    under convert.py's names, equal the port's; installed on a second port
    encoder they give the JAX encoder's bytes."""
    mode, kw = VIDEOCRYPT[name]
    j, t = encoders(mode, kw)
    arrays = convert.statics_to_numpy(t)
    want = {}
    for js, ts in zip(j.services, t.services):
        for f in ts.STATICS:
            want[convert.service_key(ts, f)] = np.asarray(getattr(js, f))
    tc.assert_same({k: arrays[k] for k in want}, want, "scrambler statics")
    _, other = encoders(mode, kw)
    convert.statics_from_numpy(other, {**arrays, **want})
    tc.assert_same(convert.statics_to_numpy(other), arrays, "installed")
    check_blocks(f"{name} (carried)", j, other, range(2))


@pytest.mark.parametrize("mode,kw", [
    ("m", {"videocrypt": "free"}),
    ("pal", {"videocrypt": "sky"}),
    ("pal", {"videocrypt2": "conditional"}),
    ("ntsc", {"videocrypts": "free"}),
    ("pal", {"videocrypts": "bbc"}),
])
def test_videocrypt_refusals_match_jax(mode, kw):
    """A 525-line mode or an unknown access mode: the JAX package's
    ValueError and message."""
    from hacktv_tpu import Encoder as JEncoder
    msgs = []
    for make in (lambda: JEncoder(mode, RATE, **kw),
                 lambda: TEncoder(mode, RATE, device="cpu", **kw)):
        with pytest.raises(ValueError) as e:
            make()
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
