"""Checkpoints of the port, continued (test_torch_checkpoint.py has the
raster modes): each VBI service and scrambler whose state crosses blocks
(WSS, CEA-608, Videocrypt, Videocrypt S, Syster, SiS, teletext) resumed
at block 2 to the JAX package's continuous stream, and MacEncoder's
checkpoint (D2-MAC FM with Eurocrypt, D-MAC) with its refusals."""

from __future__ import annotations

import pickle

import numpy as np
import pytest

import _torch_ckpt as ck
import _torch_common as tc
import _torch_mac as tm
from hacktv_tpu_torch.services.eurocrypt import Eurocrypt
from hacktv_tpu_torch.video.mac import MacEncoder

CASES = {
    "pal-wss-auto": ("pal", 16_000_000, {"wss": "auto"}),
    "ntsc-cc608": ("ntsc", 13_500_000, {"cc608": True}),
    "pal-videocrypt": ("pal", 16_000_000, {"videocrypt": "conditional"}),
    "pal-videocrypts": ("pal", 16_000_000, {"videocrypts": "free"}),
    "pal-syster": ("pal", 16_000_000, {"syster": "premiere-fa"}),
    "i-sis": ("i", 16_000_000, {"sis": "dcsis"}),
    "pal-teletext": ("pal", 16_000_000, {"teletext": ck.vbi.DEMO}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_services_checkpoint_resumes_to_jax_stream(case):
    ck.round_trip(*CASES[case])


@pytest.mark.parametrize("mode,kw", [
    ("d2mac-fm", {"provider": "filmnet", "scramble_audio": True}),
    ("dmac", {}),
], ids=["d2mac-fm-ec", "dmac"])
def test_mac_checkpoint_resumes_to_jax_stream(mode, kw):
    """MacEncoder at 20.25 MS/s: the pickled multiplex (packet queues, CA,
    audio coder, cut PRBS), the FM phase and the line polarity carry;
    a fresh encoder resumed at block 2 writes the JAX package's
    stream."""
    kw = dict(kw)
    provider = kw.pop("provider", None)
    tc.jax_runtime()

    def mk(cls, ec_cls, src):
        ec = ec_cls(provider, now=tm.NOW) if provider else None
        return cls(tm.jget_mode(mode) if cls is tm.JMacEncoder
                   else tm.tget_mode(mode), tm.RATE, source=src,
                   eurocrypt=ec, **kw,
                   **({} if cls is tm.JMacEncoder else {"device": "cpu"}))
    j = mk(tm.JMacEncoder, tm.JEurocrypt, tm.JTestCard(702, 576))
    ref = [j.encode_block(b) for b in range(ck.BLOCKS)]
    t = mk(MacEncoder, Eurocrypt, tm.TTestCard(702, 576))
    for b in range(ck.K):
        assert np.array_equal(t.encode_block(b), ref[b]), b
    blob = t.checkpoint(ck.K)
    tc.assert_no_torch(blob)
    st = pickle.loads(blob)
    assert ("fm_r" in st) == mode.endswith("-fm") and "pol_c" in st
    fresh = mk(MacEncoder, Eurocrypt, tm.TTestCard(702, 576))
    assert fresh.load_checkpoint(blob) == ck.K
    for b in range(ck.K, ck.BLOCKS):
        _, mx, nd = tc.error_report(fresh.encode_block(b), ref[b])
        assert nd == 0, f"resumed block {b}: {nd} samples differ ({mx})"


def test_mac_checkpoint_refusals():
    """The JAX package's refusals: a moving source, a raw: teletext
    stream, pipeline_mux, a block other than the stream's next, and a
    host-materialise checkpoint resumed into a device_mat encoder."""
    mk = lambda **kw: MacEncoder("d2mac", tm.RATE, device="cpu", **kw)
    e = mk(source=tc.MovingSource(64, 48))
    e.encode_block(0)
    with pytest.raises(NotImplementedError, match="index-addressable"):
        e.checkpoint(1)
    e = mk(teletext=ck.vbi.RAW)
    e.encode_block(0)
    with pytest.raises(NotImplementedError, match="raw: packet stream"):
        e.checkpoint(1)
    e = mk(pipeline_mux=True)
    e.encode_block(0)
    with pytest.raises(NotImplementedError, match="pipeline_mux"):
        e.checkpoint(1)
    e = mk()
    e.encode_block(0)
    with pytest.raises(RuntimeError, match="stream is at 1"):
        e.checkpoint(2)
    host = mk(teletext=ck.vbi.DEMO, teletext_clock=ck.vbi.clock)
    assert not host.device_mat
    host.encode_block(0)
    blob = host.checkpoint(1)
    dev = mk()
    assert dev.device_mat
    with pytest.raises(ValueError, match="host-materialise"):
        dev.load_checkpoint(blob)
