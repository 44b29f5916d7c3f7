"""Line-axis sharding of the port's encoders (`devices=`) against
hacktv_tpu, shared by tests/test_torch_devices_*.py: each configuration's
blocks from the JAX package's single-device encoder are the oracle, and
the port's single-device and sharded encoders (N CPU shards) must give
them byte for byte."""

from __future__ import annotations

import numpy as np

import _torch_common as tc
from hacktv_tpu import Encoder as JEncoder
from hacktv_tpu.video.mac import MacEncoder as JMacEncoder
from hacktv_tpu_torch import Encoder as TEncoder
from hacktv_tpu_torch.video.mac import MacEncoder as TMacEncoder

# name: (MAC?, mode, sample rate, keyword arguments, blocks)
CONFIGS = {
    # __graft_entry__.dryrun_multichip's configurations, at its sizes
    "i": (False, "i", 1_000_000, {"frames_per_block": 8}, (0, 1)),
    "m-vsb": (False, "m", 1_000_000, {"frames_per_block": 8,
                                      "vfilter": True}, (0, 1)),
    "l": (False, "l", 1_000_000, {"frames_per_block": 8}, (0, 1)),
    "i-syster": (False, "i", 1_000_000, {"frames_per_block": 8,
                                         "syster": "premiere-fa"}, (0, 1)),
    "d2mac": (True, "d2mac", 2_025_000, {"frames_per_block": 8}, (0, 1)),
    # FM video with swap-IQ: the closed form's phase sum handed from
    # shard to shard
    "pal-fm-swap": (False, "pal-fm", 20_250_000,
                    {"frames_per_block": 4, "swap_iq": True}, (0, 1)),
    # the decimating resampler (L/M = 1/2): its windows cross rows
    "pal-pixelrate": (False, "pal", 8_000_000,
                      {"frames_per_block": 4, "pixel_rate": 16_000_000},
                      (0, 1)),
    "i-offset": (False, "i", 8_000_000,
                 {"frames_per_block": 4, "offset": -2_250_000}, (0, 1)),
    # NICAM's differential state and the FM anchor across two blocks,
    # through the VSB filter
    "i-nicam-vsb": (False, "i", 4_000_000,
                    {"frames_per_block": 4, "vfilter": True}, (0, 1)),
}
_REF: dict = {}


def make(name: str, devices=None, **extra):
    """The port's encoder of configuration `name` on the CPU, sharded
    over `devices` when given."""
    mac, mode, rate, kw, _ = CONFIGS[name]
    cls = TMacEncoder if mac else TEncoder
    kw = dict(kw, **extra)
    if not mac:
        # as dryrun_multichip: cos/sin of the FM phase at every sample
        kw["fm_direct_trig"] = True
    return cls(mode, rate, device="cpu", devices=devices, **kw)


def reference(name: str) -> list:
    """The JAX package's single-device blocks of configuration `name`
    (computed once a process)."""
    hit = _REF.get(name)
    if hit is None:
        tc.jax_runtime()
        mac, mode, rate, kw, blocks = CONFIGS[name]
        kw = dict(kw)
        if not mac:
            kw["fm_direct_trig"] = True
        j = (JMacEncoder if mac else JEncoder)(mode, rate, **kw)
        hit = _REF[name] = [np.asarray(j.encode_block(b)) for b in blocks]
    return hit


def check(name: str, n: int) -> None:
    """Configuration `name` in n CPU shards: byte for byte the JAX
    package's single-device blocks and the port's own."""
    ref = reference(name)
    blocks = CONFIGS[name][4]
    one = make(name)
    sharded = make(name, devices=["cpu"] * n)
    for b, r in zip(blocks, ref):
        single = one.encode_block(b)
        got = sharded.encode_block(b)
        for what, x in (("single-device", single), (f"{n} shards", got)):
            assert x.shape == r.shape and x.dtype == r.dtype, (name, what)
            _, mx, nd = tc.error_report(x, r)
            assert nd == 0, (f"{name} block {b}, {what}: {nd} of {r.size} "
                             f"samples differ from hacktv_tpu (max {mx})")
