"""Checkpoint round trips shared by tests/test_torch_checkpoint*.py: the
port checkpoints at block K, a fresh port encoder resumes from the blob,
and blocks K.. equal the JAX package's continuous stream; the numpy
carries in the port's blob equal those of the JAX package's checkpoint
at the same block."""

from __future__ import annotations

import pickle

import numpy as np

import _torch_common as tc
import _torch_vbi as vbi
from hacktv_tpu_torch import Encoder as TEncoder

K = 2           # the block checkpointed at
BLOCKS = 4      # one-frame blocks 0-3


def round_trip(mode, rate, kw):
    """Encoder checkpoint at K against the JAX package's stream."""
    j, t = vbi.encoders(mode, rate, kw)
    ref = [j.encode_block(b) for b in range(K)]
    jblob = j.checkpoint(K)
    ref += [j.encode_block(b) for b in range(K, BLOCKS)]
    for b in range(K):
        assert np.array_equal(t.encode_block(b), ref[b]), ("continuous", b)
    blob = t.checkpoint(K)
    tc.assert_no_torch(blob)
    # a fresh encoder on the same source, without the caption pairs
    # queued: they come from the blob
    fresh = TEncoder(mode, rate, source=t.source, device="cpu",
                     **vbi._kw(kw))
    assert fresh.load_checkpoint(blob) == K
    for b in range(K, BLOCKS):
        got = fresh.encode_block(b)
        _, mx, nd = tc.error_report(got, ref[b])
        assert nd == 0, f"resumed block {b}: {nd} samples differ ({mx})"
    carries(pickle.loads(blob), pickle.loads(jblob), t)


def carries(st, jst, t):
    """The port's numpy carries against the JAX package's at the same
    block.  The port's FM-video phase is int64 where the JAX package's
    is int32; the JAX chain's `_dsym_anchor` belongs to its host NICAM
    coder, which the port has not (its NICAM anchor is
    `_nicam_dev_anchor`); where the A2 pilot's sums come from the exact
    period table, the port's pilot block is stateless and leaves its
    `_pilot_anchor` at the start, which the JAX package advances
    unused."""
    keys = ("fm_r", "fm_xa", "secam_z", "secam_iir", "fm_exact",
            "fm_video_exact")
    assert {k for k in keys if k in st} == {k for k in keys if k in jst}
    for k in keys:
        if k == "fm_r" and k in st:
            assert st[k].astype(np.int64) == jst[k].astype(np.int64)
        elif k in st:
            tc.assert_same(st[k], jst[k], k)
    ja = dict(jst["audio"])
    ja.pop("_dsym_anchor", None)
    ta = dict(st["audio"])
    if getattr(t.audio, "_pilot_prefix", None) is not None:
        ta.pop("_pilot_anchor")
        ja.pop("_pilot_anchor")
    tc.assert_same(ta, ja, "audio")
