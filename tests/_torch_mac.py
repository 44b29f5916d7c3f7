"""D/D2-MAC configurations and checks shared by the tests that hold the
port's MAC path against hacktv_tpu (tests/test_torch_mac_*.py,
tests/test_torch_eurocrypt.py)."""

from __future__ import annotations

import numpy as np

import _torch_common as tc
from hacktv_tpu.av.testcard import TestCardSource as JTestCard
from hacktv_tpu.config.standards import get_mode as jget_mode
from hacktv_tpu.services.eurocrypt import Eurocrypt as JEurocrypt
from hacktv_tpu.video.mac import MacEncoder as JMacEncoder
from hacktv_tpu.video.mac import MacMux as JMacMux
from hacktv_tpu_torch.av.testcard import TestCardSource as TTestCard
from hacktv_tpu_torch.config.standards import get_mode as tget_mode
from hacktv_tpu_torch.services.eurocrypt import Eurocrypt as TEurocrypt
from hacktv_tpu_torch.video.mac import MacEncoder as TMacEncoder
from hacktv_tpu_torch.video.mac import MacMux as TMacMux

RATE = 20_250_000
# the wall clock Eurocrypt's dates read, pinned for both packages
NOW = 1_200_000_000


def muxes(mode, vsam=1, provider=None, ec_kwargs=None, native=True, **kw):
    """The JAX package's MacMux and the port's on the test card at
    20.25 MS/s, with the same Eurocrypt provider if one is named."""
    tc.jax_runtime()
    ecs = [None, None]
    if provider is not None:
        ecs = [cls(provider, now=NOW, **(ec_kwargs or {}))
               for cls in (JEurocrypt, TEurocrypt)]
    j = JMacMux(jget_mode(mode), 1296, RATE, JTestCard(702, 576),
                vsam=vsam, timestamp=NOW, aspect_43=1, eurocrypt=ecs[0],
                **kw)
    t = TMacMux(tget_mode(mode), 1296, RATE, TTestCard(702, 576),
                vsam=vsam, timestamp=NOW, aspect_43=1, eurocrypt=ecs[1],
                native=native, **kw)
    return j, t


def check_mux(name, j, t, frames, step_frames=5):
    """Advance both multiplexes `step_frames` frames at a time through
    `frames` frames; each window's packed line bits, start polarities and
    scramble arrays, the control word and the queues agree."""
    step = step_frames * 625
    for hi in range(step, frames * 625 + 1, step):
        j.ensure(hi)
        t.ensure(hi)
        where = f"{name}, lines {hi - step}-{hi - 1}"
        tc.assert_same(t.bits_block(hi - step, hi),
                       j.bits_block(hi - step, hi), where)
        tc.assert_same(t.scramble_block(hi - step, hi),
                       j.scramble_block(hi - step, hi), where)
        assert t.cw == j.cw, where
        assert t.polarity == j.polarity, where
        assert t.queues == j.queues, where
        j.prune(hi - 1)
        t.prune(hi - 1)


def encoders(mode, kw=None, jkw=None, rate=RATE, **tkw):
    """The JAX package's MacEncoder and the port's (on the CPU) with the
    same arguments; `jkw` and `tkw` add arguments to one side only."""
    tc.jax_runtime()
    kw = dict(kw or {})
    j = JMacEncoder(mode, rate, **kw, **(jkw or {}))
    t = TMacEncoder(mode, rate, device="cpu", **kw, **tkw)
    return j, t


def check_blocks(name, j, t, blocks):
    """Blocks `blocks` of both encoders, in order, byte for byte."""
    for b in blocks:
        ref = j.encode_block(b)
        got = t.encode_block(b)
        assert got.dtype == ref.dtype and got.shape == ref.shape, \
            f"{name} block {b}: {got.dtype}{got.shape} != " \
            f"{ref.dtype}{ref.shape}"
        ndiff = np.count_nonzero(got != ref)
        assert ndiff == 0, f"{name} block {b}: {ndiff} samples differ"

