"""Encoder(devices=...) on the CPU, continued: FM video with swap-IQ,
the decimating pixel-rate resampler, the frequency offset and NICAM's
carries over two blocks, in 2 and 4 shards, byte for byte hacktv_tpu's
single-device encoder and the port's own; each shard's row stage sees
only its lines and its declared halo; replicas of the device statics on
a second device key; checkpoints move between sharded and single-device
encoders."""

from __future__ import annotations

import numpy as np
import pytest

import _torch_devices as td
from hacktv_tpu_torch.ops import stream_fir
from hacktv_tpu_torch.video import raster


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", ["pal-fm-swap", "pal-pixelrate",
                                  "i-offset", "i-nicam-vsb"])
def test_sharded_matches_jax(name, n):
    td.check(name, n)


@pytest.mark.parametrize("name", ["i-syster", "pal-pixelrate", "m-vsb"])
def test_row_stage_sees_its_window(name, monkeypatch):
    """The raster of each shard is synthesised over its own rows only:
    the line before its first, its lines, the halo line after them (and
    the resampler's two more, for an inner shard), and the scramblers'
    lookahead; the stream FIR reads its lines and half a filter each
    side."""
    n = 4
    enc = td.make(name, devices=["cpu"] * n)
    rows, fir = [], []
    synth, fir_plain = raster.synth_block, stream_fir.stream_fir_plain
    monkeypatch.setattr(raster, "synth_block", lambda st, yuv, base, *a,
                        **k: rows.append(base.shape[0]) or
                        synth(st, yuv, base, *a, **k))
    monkeypatch.setattr(stream_fir, "stream_fir_plain", lambda xs, *a:
                        fir.append(xs.shape[0]) or fir_plain(xs, *a))
    enc.encode_block(0)
    enc.encode_block(1)
    nl = enc.frames_per_block * enc.conf.lines // n
    extra = 2 if enc.resampler is not None else 0
    halo = enc.halo_after
    want = [nl + 2 + extra + halo] * (n - 1) + [nl + 1 + halo]
    assert [w.r1 - w.r0 for w in enc._windows] == want
    assert rows == want * 2
    if enc.vf_taps is not None:
        nt = enc.vf_taps[0].shape[0]
        assert fir == [nl * enc.out_params.width + nt - 1] * (2 * n)


@pytest.mark.parametrize("name", ["l", "i-syster", "d2mac"])
def test_replicas_on_a_second_device(name):
    """Shards on two distinct device keys ("cpu" and "cpu:0") take the
    replica path: the device statics and the services copied for the
    second device, the block stage run once per device, the inputs moved
    between them; the bytes stay those of one device."""
    ref = td.reference(name)
    t = td.make(name, devices=["cpu", "cpu:0", "cpu", "cpu:0"])
    for b, r in zip(td.CONFIGS[name][4], ref):
        assert np.array_equal(t.encode_block(b), r), (name, b)
    assert list(t._replicas) == ["cpu:0"]


@pytest.mark.parametrize("direction", ["sharded-to-single",
                                       "single-to-sharded"])
@pytest.mark.parametrize("name", ["i-nicam-vsb", "l", "pal-fm-swap",
                                  "d2mac"])
def test_checkpoint_between_shardings(name, direction):
    """A checkpoint taken at block 2 of a 2-shard encoder resumes on a
    single-device one, and the other way round; blocks 2-3 equal the
    continuous run."""
    shards = ["cpu", "cpu"]
    a, b = ((shards, None) if direction == "sharded-to-single"
            else (None, shards))
    cont = td.make(name)
    ref = [cont.encode_block(k) for k in range(4)]
    first = td.make(name, devices=a)
    for k in range(2):
        assert np.array_equal(first.encode_block(k), ref[k]), k
    blob = first.checkpoint(2)
    second = td.make(name, devices=b)
    assert second.load_checkpoint(blob) == 2
    for k in (2, 3):
        assert np.array_equal(second.encode_block(k), ref[k]), k


def test_mux_of_sharded_channels():
    """Two PAL-I transmitters at -/+2.25 MHz, each in 2 shards: the
    mux adds them shard by shard, to the bytes of the unsharded mux."""
    from hacktv_tpu_torch import Encoder
    from hacktv_tpu_torch.mux import MuxEncoder
    mk = lambda devices: MuxEncoder([
        Encoder("i", 8_000_000, offset=o, frames_per_block=4, device="cpu",
                devices=devices) for o in (-2_250_000, 2_250_000)])
    one, two = mk(None), mk(["cpu", "cpu"])
    for b in range(2):
        assert np.array_equal(two.encode_block(b), one.encode_block(b)), b
