"""Encoder.checkpoint and load_checkpoint of the port: a fresh encoder
resumed at block 2 writes the JAX package's continuous stream byte for
byte (PAL-I with and without the VSB filter, PAL-B/G with A2 stereo,
SECAM-L with NICAM on the device chroma and on the host-exact one,
PAL-FM), the numpy carries equal the JAX package's checkpoint's, the
blob holds no torch tensor, and the JAX package's refusals are raised.
The services and D/D2-MAC are in test_torch_checkpoint_b.py."""

from __future__ import annotations

import pytest

import _torch_ckpt as ck
import _torch_common as tc
from hacktv_tpu_torch.encoder import Encoder

CASES = {
    "pal-i": ("i", 16_000_000, {}),
    "pal-i-filter": ("i", 16_000_000, {"vfilter": True}),
    "g-a2": ("g", 16_000_000, {"a2stereo": True}),
    "l-nicam": ("l", 16_000_000, {}),
    "l-nicam-exact": ("l", 16_000_000, {"secam_exact": True}),
    "pal-fm": ("pal-fm", 16_000_000, {}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_checkpoint_resumes_to_jax_stream(case):
    if case in ("pal-fm", "l-nicam-exact"):
        tc.jax_runtime()
    ck.round_trip(*CASES[case])


def test_checkpoint_refusals(tmp_path):
    """--passthru, a moving source and a raw: teletext stream, with the
    JAX package's messages."""
    pt = tmp_path / "pt.bin"
    pt.write_bytes(bytes(4 * 1000))
    enc = Encoder("pal", 16_000_000, passthru=str(pt), device="cpu")
    enc.encode_block(0)
    with pytest.raises(NotImplementedError, match="passthru"):
        enc.checkpoint(1)
    enc = Encoder("pal", 16_000_000, source=tc.MovingSource(64, 48),
                  device="cpu")
    enc.encode_block(0)
    with pytest.raises(NotImplementedError, match="index-addressable"):
        enc.checkpoint(1)
    enc = Encoder("pal", 16_000_000, teletext=ck.vbi.RAW, device="cpu")
    enc.encode_block(0)
    with pytest.raises(NotImplementedError, match="raw: packet stream"):
        enc.checkpoint(1)


def test_checkpoint_before_the_block():
    """A device-held FM anchor needs the block before the checkpoint."""
    enc = Encoder("i", 16_000_000, device="cpu")
    enc.encode_block(0)
    enc._audio_args(1)
    with pytest.raises(RuntimeError, match="before checkpointing"):
        enc.checkpoint(2)
