"""Card-only checks of the port: the CUDA kernels against their plain
versions (bit for bit, the FM pre-emphasis filter's 67 and 71 taps
included); the NICAM coder and pulse synthesis, the SECAM chroma program,
the AM carrier, the A2 pilot phase, FM video's closed form, the offset
rotation, the video resampler, the VBI services' render under TF32 and
the encoder (the legacy raster modes, S-Video, --pixelrate, the VBI
services, the scramblers and DANCE among its configurations), DANCE's
two-part pulse product under TF32, the scramblers' applies and the
D/D2-MAC encoders (their f64 duobinary products with TF32 on and off,
the cuts, Eurocrypt, teletext, the resampler, the pipelined multiplex),
moving sources in 4-frame blocks and the LUT gather, checkpoints
written on one device and resumed on the other, and the encoders sharded
over 2 and 4 shards of the card (`devices=`), on the card against their
CPU path (byte for byte); the tracer's events and launch counts on the
card; the pinned copy back of the raster encoder, D2-MAC and the mux,
and its page-locked blocks written by the file sink's own thread; the
block step replayed as CUDA graphs against eager steps (Videocrypt I's
among them).
They skip without an NVIDIA card.  The file imports
neither jax nor hacktv_tpu, so on a machine without JAX it runs alone:

    python -m pytest --noconftest tests/test_torch_cuda.py -q -m cuda
"""

from __future__ import annotations

import os
from dataclasses import replace

import numpy as np
import pytest
import torch

import _torch_common as tc
from hacktv_tpu_torch import Encoder, get_mode, runtime, telemetry
from hacktv_tpu_torch.audio import nicam_dev, synth
from hacktv_tpu_torch.av.noise import NoiseSource
from hacktv_tpu_torch.mux import MuxEncoder
from hacktv_tpu_torch.ops import resampler as rs_mod
from hacktv_tpu_torch.ops import stream_fir as sf
from hacktv_tpu_torch.rf import ops as rf_ops
from hacktv_tpu_torch.video import raster
from hacktv_tpu_torch.video import secam
from hacktv_tpu_torch.video.params import VideoParams

pytestmark = pytest.mark.cuda


def _launches() -> tuple:
    """(fir_cplx, fir_real) launches so far, the tracer's counters."""
    c = telemetry.counters()
    return c.get("fir_cplx.launches", 0), c.get("fir_real.launches", 0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.parametrize("seed,nt,n", [(0, 51, 49229), (1, 51, 2048),
                                       (2, 7, 5003), (3, 1, 100),
                                       (4, 51, 28_828_800)])
def test_kernels_equal_plain(cuda, seed, nt, n):
    g = torch.Generator(device=cuda).manual_seed(seed)
    xs = torch.randn(n + nt - 1, generator=g, device=cuda) * 8000.0
    # taps from the host: the kernel takes them by value
    gh = torch.Generator().manual_seed(seed)
    tr = torch.randn(nt, generator=gh)
    ti = torch.randn(nt, generator=gh)
    c0, r0 = _launches()
    yi, yq = sf.stream_fir(xs, tr, ti, n)
    y = sf.stream_fir(xs, tr, None, n)
    torch.cuda.synchronize()
    assert _launches() == (c0 + 1, r0 + 1)
    pi, pq = sf.stream_fir_plain(xs, tr, ti, n)
    assert torch.equal(yi, pi) and torch.equal(yq, pq)
    assert torch.equal(y, sf.stream_fir_plain(xs, tr, None, n))


@pytest.mark.parametrize("shards", [None, 2])
def test_tracing_on_the_card(cuda, shards):
    """PAL-I with the VSB filter, two-frame blocks 0-2 (whole and in two
    shards) dispatched ahead of their collect as the command line does,
    the tracer off and on: the same bytes; on, each block's copy back
    waits for what the copy waits behind (collect.wait: the block's
    step, or the work queued on its cards) before it copies
    (collect.copy), and each block launches fir_cplx once a shard."""
    def run(on: bool):
        telemetry.take()
        telemetry.enable(on)
        try:
            enc = Encoder("i", 16_000_000, vfilter=True, device=cuda,
                          frames_per_block=2,
                          devices=None if shards is None else
                          [cuda] * shards)
            c0, _ = _launches()
            pending, out = enc.encode_block_device(0), []
            for b in range(1, 4):
                nxt = enc.encode_block_device(b) if b < 3 else None
                out.append(enc.collect_block(b - 1, pending))
                pending = nxt
            launches = _launches()[0] - c0
        finally:
            telemetry.enable(False)
        return out, launches, telemetry.take()["spans"]
    off, n_off, _ = run(False)
    on, n_on, spans = run(True)
    for a, b in zip(off, on, strict=True):
        assert np.array_equal(a, b)
    assert n_off == n_on == 3 * (shards or 1)
    for b in range(3):
        (w,) = [s for s in spans if s[0] == "collect.wait" and s[1] == b]
        (c,) = [s for s in spans if s[0] == "collect.copy" and s[1] == b]
        assert w[2] == c[2] == "collect" and w[4] <= c[3]


def _copy_back_encoder(name, device):
    """PAL-I with the VSB filter in 16-frame blocks, D2-MAC with FM or
    two PAL-I transmitters 4.5 MHz apart at 20 MS/s, in 4-frame
    blocks."""
    if name == "i":
        return Encoder("i", 16_000_000, vfilter=True, frames_per_block=16,
                       device=device)
    if name == "d2mac-fm":
        return _mac("d2mac-fm", {}, device, fpb=4)
    return MuxEncoder([Encoder("i", 20_000_000, offset=o,
                               frames_per_block=4, device=device)
                       for o in (-2_250_000, 2_250_000)])


@pytest.mark.parametrize("name", ["i", "d2mac-fm", "mux-i"])
def test_pinned_copy_back_keeps_every_block(cuda, name):
    """Six blocks of PAL-I, D2-MAC and the two-channel mux streamed as
    the command line does (block b + 1 dispatched before block b is
    collected), every returned array kept: each block carries its step's
    event, and each array equals the CPU encoder's block byte for byte,
    is unchanged after the later blocks were collected and went back
    through page-locked memory once."""
    nblocks = 6
    g, c = (_copy_back_encoder(name, d) for d in (cuda, "cpu"))
    n0 = telemetry.counters()
    kept, copies = [], []
    pending = g.encode_block_device(0)
    for b in range(1, nblocks + 1):
        nxt = g.encode_block_device(b) if b < nblocks else None
        assert isinstance(pending._step_done, torch.cuda.Event), b - 1
        kept.append(g.collect_block(b - 1, pending))
        copies.append(kept[-1].copy())
        pending = nxt
    n1 = telemetry.counters()
    assert n1["collect.pinned"] - n0.get("collect.pinned", 0) == nblocks
    assert n1["collect.pinned_bytes"] - n0.get("collect.pinned_bytes", 0) \
        == sum(a.nbytes for a in kept)
    # a later block overwriting an earlier one's memory would show
    assert not np.array_equal(kept[0], kept[1])
    for b, (a, cp) in enumerate(zip(kept, copies, strict=True)):
        assert np.array_equal(a, cp), f"block {b} changed after its collect"
        want = c.encode_block(b)
        assert a.dtype == want.dtype and a.tobytes() == want.tobytes(), b


def test_file_sink_holds_pinned_blocks(cuda, tmp_path):
    """Twelve one-frame pal-i-vsb blocks (`-m i --filter`, 16 MS/s, the
    test card with noise for sound) streamed as the command line streams
    them into the file sink, each page-locked array dropped as soon as it
    is written: the sink writes them from its own thread after `write`
    returns, and the file holds a fresh encoder's `encode_block` bytes."""
    def make():
        probe = Encoder("i", 16_000_000, device="cpu")
        src = NoiseSource(probe.params.active_width,
                          probe.conf.active_lines)
        return Encoder("i", 16_000_000, vfilter=True, source=src,
                       device=cuda)
    nblocks = 12
    enc, fresh = make(), make()
    path = tmp_path / "out.s16"
    sink = runtime.NativeFileSink(str(path), "int16", True)
    pending = enc.encode_block_device(0)
    for b in range(1, nblocks + 1):
        nxt = enc.encode_block_device(b) if b < nblocks else None
        sink.write(enc.collect_block(b - 1, pending))
        pending = nxt
    sink.close()
    assert sink.stats()["borrowed"] == nblocks
    want = b"".join(fresh.encode_block(b).tobytes() for b in range(nblocks))
    got = path.read_bytes()
    assert len(got) == len(want) and got == want


GRAPH_COUNTERS = ("step.eager","step.graph_captures", "step.graph_replays",
                  "step.graph_failures", "fir_cplx.launches",
                  "secam.windows", "secam.kernel_windows")


def _stream_counted(enc, nblocks: int):
    """nblocks blocks streamed as the command line streams them (block b
    + 1 dispatched before block b is collected): the host samples, and
    each block's dispatch's growth of GRAPH_COUNTERS."""
    out, grew = [], []
    pending = None
    for b in range(nblocks + 1):
        if b < nblocks:
            c0 = telemetry.counters()
            nxt = enc.encode_block_device(b)
            c1 = telemetry.counters()
            grew.append(tuple(c1.get(k, 0) - c0.get(k, 0)
                              for k in GRAPH_COUNTERS))
        if pending is not None:
            out.append(enc.collect_block(b - 1, pending))
        pending = nxt if b < nblocks else None
    return out, grew


@pytest.mark.parametrize("mode", ["i", "l"])
def test_step_graphs_equal_eager_steps(cuda, mode):
    """pal-i-vsb and secam-l-vsb as the benchmark builds them (`-m i` or
    `-m l`, `--filter`, 16 MS/s, 16-frame blocks, the test card with
    noise for sound), twelve blocks through the step's CUDA graphs and
    through an eager twin (no graphs kept): byte for byte, every
    metadata key twice and the NICAM, FM and SECAM carries chained
    through the replays.  The graphs engage at the second sight of a
    signature: blocks 0 and 1 eager, block 2 captured, the rest
    replayed; the stream FIR's launches, SECAM's windows and its
    kernel's still count one a block."""
    _graphs_against_eager(cuda, mode, secam=1 if mode == "l" else 0)


def test_step_graphs_equal_eager_videocrypt_steps(cuda):
    """i-videocrypt-vsb as the benchmark builds it (`-m i --filter
    --videocrypt free`, 16 MS/s, 16-frame blocks, the test card with
    noise for sound): twelve blocks through the graphs and through an
    eager twin, byte for byte, with the scrambler's four arrays uploaded
    each block into the captured step; the same pattern of captures and
    replays as pal-i-vsb's, and no capture fails."""
    _graphs_against_eager(cuda, "i", secam=0, videocrypt="free")


def _graphs_against_eager(cuda, mode: str, secam: int, **kw):
    def make():
        probe = Encoder(mode, 16_000_000, device="cpu")
        src = NoiseSource(probe.params.active_width,
                          probe.conf.active_lines)
        return Encoder(mode, 16_000_000, vfilter=True, frames_per_block=16,
                       source=src, device=cuda, **kw)
    graphed, eager = make(), make()
    eager._graphs.limit = 0
    nblocks = 12
    got, grew = _stream_counted(graphed, nblocks)
    want, grew_eager = _stream_counted(eager, nblocks)
    assert grew[:3] == [(1, 0, 0, 0, 1, secam, secam),
                        (1, 0, 0, 0, 1, secam, secam),
                        (1, 1, 0, 0, 1, secam, secam)]
    assert grew[3:] == [(0, 0, 1, 0, 1, secam, secam)] * (nblocks - 3)
    assert grew_eager == [(1, 0, 0, 0, 1, secam, secam)] * nblocks
    for b, (a, w) in enumerate(zip(got, want, strict=True)):
        assert a.tobytes() == w.tobytes(), \
            f"block {b}: {np.count_nonzero(a != w)} of {a.size} differ"


@pytest.mark.parametrize("kw", [{"wss": "auto", "vits": True},
                                {"sis": "dcsis"}],
                         ids=["wss-vits", "sis"])
def test_step_graphs_with_changing_signatures(cuda, kw):
    """One-frame PAL-I blocks with VBI services whose block arrays vary
    from block to block and follow no wall clock: through the graphs and
    through an eager twin, byte for byte; it reports how many of its
    blocks replayed."""
    make = lambda: Encoder("i", 16_000_000, vfilter=True, device=cuda,
                           **kw)
    graphed, eager = make(), make()
    eager._graphs.limit = 0
    nblocks = 10
    got, grew = _stream_counted(graphed, nblocks)
    want, _ = _stream_counted(eager, nblocks)
    replays = sum(g[2] for g in grew)
    print(f"{sorted(kw)}: {replays} of {nblocks} blocks replayed, "
          f"{sum(g[1] for g in grew)} captured")
    assert sum(g[3] for g in grew) == 0
    assert all(g[0] + g[2] == 1 for g in grew)
    for b, (a, w) in enumerate(zip(got, want, strict=True)):
        assert a.tobytes() == w.tobytes(), \
            f"block {b}: {np.count_nonzero(a != w)} of {a.size} differ"


@pytest.mark.parametrize("branch", ["fuse1", "fuse2"])
@pytest.mark.parametrize("nt", [51, 7, 2])
@pytest.mark.parametrize("offset", [0, 1, 2, 3])
def test_kernels_unaligned_equal_plain(cuda, offset, nt, branch):
    """xs 0-3 floats past a 16-byte boundary, as the encoder's stream is;
    both first-step branches; the compile-time tap count (51) and the
    run-time loop (7, 2); n not a multiple of the 2,816-output tile.
    Taps come from the host, as the encoder passes them."""
    n = 5 * 2816 + 123
    rng = np.random.default_rng(100 * nt + 10 * offset + len(branch))
    x = torch.as_tensor((rng.standard_normal(n + nt + 7) * 8000).astype(
        np.float32), device=cuda)
    xs = x[offset: offset + n + nt - 1]
    assert xs.data_ptr() % 16 == 4 * offset
    taps = []
    for _ in range(2):
        t = rng.standard_normal(nt).astype(np.float32)
        # r[0] = t[-1], r[1] = t[-2]: fuse2 is r[0] < 0 < r[1]
        t[-1] = -abs(t[-1]) if branch == "fuse2" else abs(t[-1])
        t[-2] = abs(t[-2])
        taps.append(torch.from_numpy(t))
    tr, ti = taps
    assert sf.fuse_second(float(tr[-1]), float(tr[-2])) == (branch == "fuse2")
    yi, yq = sf.stream_fir(xs, tr, ti, n)
    y = sf.stream_fir(xs, tr, None, n)
    torch.cuda.synchronize()
    pi, pq = sf.stream_fir_plain(xs, tr, ti, n)
    assert torch.equal(yi, pi) and torch.equal(yq, pq)
    assert torch.equal(y, sf.stream_fir_plain(xs, tr, None, n))


def test_wrapper_refuses_bad_input(cuda):
    xs = torch.zeros(100, device=cuda, dtype=torch.float64)
    with pytest.raises(ValueError):
        sf.stream_fir(xs, torch.ones(5, device=cuda, dtype=torch.float64),
                      None, 50)
    with pytest.raises(ValueError):      # taps of the wrong type
        sf.stream_fir(xs.float(), torch.ones(5, dtype=torch.float64), None,
                      50)
    with pytest.raises(ValueError):      # taps on the card
        sf.stream_fir(xs.float(), torch.ones(5, device=cuda), None, 50)
    with pytest.raises(ValueError):      # more taps than a launch passes
        sf.stream_fir(torch.zeros(400, device=cuda), torch.ones(257), None,
                      50)


@pytest.mark.parametrize("fpb", [1, 64])
def test_nicam_card_matches_cpu(cuda, fpb):
    """signs_device and nicam_add of PAL-I's first block on the card and
    on the CPU, from the same seeded PCM and video: byte-equal."""
    encs = {d: Encoder("i", 16_000_000, frames_per_block=fpb, device=d)
            for d in ("cpu", cuda)}
    nlines = fpb * 625
    out = {}
    for d, e in encs.items():
        nc = e.audio.nicam_device_block(0, nlines, e.nicam_statics,
                                        e.nicam_dev_statics, None)
        dst = e.nicam_dev_statics
        rng = np.random.default_rng(fpb)
        pcm = rng.integers(-32768, 32768, (dst.nf_max * 32 + 82, 2))
        y = torch.as_tensor(np.round(rng.standard_normal(
            (2, nlines, 1024)) * 8000).astype(np.float32), device=d)
        si, sq, ds = nicam_dev.signs_device(
            dst, torch.as_tensor(pcm.astype(np.int16), device=d),
            torch.tensor(1, dtype=torch.int32, device=d), 5,
            nc["base_off"], nc["nkeep"])
        oi, oq = synth.nicam_add(e.nicam_statics, y[0], y[1], si, sq,
                                 nc["offq"], nc["offr"],
                                 torch.as_tensor(nc["cc_off"], device=d),
                                 1)
        out[d] = [t.cpu().numpy() for t in (si, sq, ds, oi, oq)]
    for name, a, b in zip(("signs_i", "signs_q", "dsym", "out_i", "out_q"),
                          out[cuda], out["cpu"]):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), \
            f"{name}: {np.count_nonzero(a != b)} of {a.size} differ"


@pytest.mark.parametrize("mode,rate", [("m", 13_500_000),
                                       ("pal", 16_000_000),
                                       ("i", 16_000_000)])
def test_encoder_card_matches_cpu(cuda, mode, rate):
    probe = Encoder(mode, rate, device="cpu")
    src = NoiseSource(probe.params.active_width, probe.conf.active_lines)
    g = Encoder(mode, rate, vfilter=True, source=src, device=cuda)
    c = Encoder(mode, rate, vfilter=True, source=src, device="cpu")
    for b in range(2):
        snr, maxerr, ndiff = tc.error_report(g.encode_block(b),
                                             c.encode_block(b))
        msg = f"{mode} block {b}: {snr:.1f} dB, max {maxerr}, {ndiff} differ"
        assert ndiff == 0, msg


def _secam_rows(cuda, mode, fpb: int, luma: bool = True, window=None,
                **kw) -> tuple:
    """chroma_render over block 1's rows (the test card, a carried z of
    -1234.5) of `mode` with `fpb`-frame blocks, on a seeded block of int16
    samples (zeros without `luma`), on the card and on the CPU; `window`
    = (r0, r1, t): that shard's window of the block (window_meta).
    Returns {device: (rows, z)} and the kernel windows the card counted."""
    out = {}
    k0 = telemetry.counters().get("secam.kernel_windows", 0)
    for d in ("cpu", cuda):
        e = Encoder(mode, 16_000_000, frames_per_block=fpb, device=d, **kw)
        p = e.params
        nl = fpb * p.lines
        nm = secam.block_meta(p, nl - 1, nl + 2, nl, e.vframe_y,
                              e.source.height)
        md = secam.meta_to_device(nm, d)
        if window is not None:
            md = secam.window_meta(md, nm, *window)
        B = md["dr"].shape[0]
        rng = np.random.default_rng(29 + fpb)
        blk = (np.clip(np.round(rng.standard_normal((B, p.width)) * 9000),
                       -32768, 32767) if luma else np.zeros((B, p.width)))
        _, u, v = raster.rgb_to_yuv_host(p, e.source.read_video(0), True)
        rows, z = secam.chroma_render(
            e.secam, md, torch.as_tensor(u, device=d),
            torch.as_tensor(v, device=d), torch.tensor(-1234.5, device=d),
            torch.as_tensor(blk.astype(np.float32), device=d), luma=luma)
        out[d] = (rows.cpu().numpy(), z.cpu().numpy())
    torch.cuda.synchronize()
    return out, telemetry.counters().get("secam.kernel_windows", 0) - k0


def _assert_rows_equal(out: dict, cuda) -> None:
    for name, a, b in zip(("rows", "z"), out[cuda], out["cpu"]):
        assert a.tobytes() == b.tobytes(), \
            f"{name}: {np.count_nonzero(a != b)} of {a.size} differ"


@pytest.mark.parametrize("fpb", [1, 64])
def test_secam_chroma_card_matches_cpu(cuda, fpb):
    """SECAM-L's chroma program and render (chroma_render) over block 1's
    rows on the card, through the kernel, and on the CPU, the plain
    program: the rendered rows and the next z byte-equal; and the
    carrier alone (a block of zeros, no band-reject) too."""
    for luma in (True, False):
        out, kernels = _secam_rows(cuda, "l", fpb, luma=luma)
        assert kernels == 1
        _assert_rows_equal(out, cuda)


def test_secam_chroma_card_field_id(cuda):
    """SECAM-L with the field-identification lines (their full-span
    sawtooth takes the carrier phase past 120 rad, where glibc's
    reduce_large runs): the kernel byte-equal to the plain program."""
    seen = []

    def spy(x, large=False):
        seen.append(float(x.abs().max()) if x.device.type == "cpu" else 0)
        return synth._sincosf_glibc(x, large=large)
    mp = pytest.MonkeyPatch()
    mp.setattr(secam, "_sincosf_glibc", spy)
    try:
        out, kernels = _secam_rows(
            cuda, replace(get_mode("l"), secam_field_id=True), 1)
    finally:
        mp.undo()
    assert kernels == 1 and max(seen) > synth.SINCOSF_MAX
    _assert_rows_equal(out, cuda)


def test_secam_chroma_card_window(cuda):
    """A shard's window of a 2-frame block (window_meta, rows from 300 on)
    whose IIR chain starts from the carried z and whose snapshot row lies
    before it (snap_row -1): the kernel byte-equal to the plain program."""
    out, kernels = _secam_rows(cuda, "l", 2, window=(300, 1252, 300))
    assert kernels == 1
    _assert_rows_equal(out, cuda)


def test_secam_chroma_card_s_video(cuda):
    """SECAM with S-Video: the carrier added to the C channel's rows, no
    band-reject, through the kernel, byte-equal to the plain program."""
    out, kernels = _secam_rows(cuda, replace(get_mode("secam"), s_video=True),
                               1, luma=False)
    assert kernels == 1
    _assert_rows_equal(out, cuda)


def test_am_and_a2_pilot_card_match_cpu(cuda):
    """am_add (SECAM-L's AM carrier) and a2_pilot_phase (PAL-B/G's A2
    pilot) on seeded blocks, on the card and on the CPU: byte-equal."""
    out = {}
    for d in ("cpu", cuda):
        e = Encoder("l", 16_000_000, device=d)
        a = Encoder("g", 16_000_000, a2stereo=True, device=d)
        rng = np.random.default_rng(6)
        y = torch.as_tensor(np.round(rng.standard_normal(
            (2, 625, 1024)) * 8000).astype(np.float32), device=d)
        am = {k: torch.as_tensor(np.ascontiguousarray(v), device=d)
              for k, v in e.audio.am_block(e.audio.am_mono, 1, 625).items()}
        ai, aq = synth.am_add(e.am_statics, y[0], y[1], am["seg_val"],
                              am["seg_col"], am["c0"], am["s0"])
        pb = {k: torch.as_tensor(v, device=d)
              for k, v in a.audio.pilot_block(3 * 625, 625).items()}
        ph = synth.a2_pilot_phase(a.a2_statics, pb["c1"], pb["s1"],
                                  pb["c2"], pb["s2"], pb["base_phase"])
        out[d] = [t.cpu().numpy() for t in (ai, aq, ph)]
    for name, a, b in zip(("am I", "am Q", "pilot phase"), out[cuda],
                          out["cpu"]):
        assert a.tobytes() == b.tobytes(), \
            f"{name}: {np.count_nonzero(a != b)} of {a.size} differ"


@pytest.mark.parametrize("mode,kw", [("l", {}), ("g", {"a2stereo": True})])
def test_secam_a2_encoder_card_matches_cpu(cuda, mode, kw):
    """SECAM-L (SECAM, AM, NICAM) and PAL-B/G with A2, one-frame blocks
    0-2 (the SECAM carry crossed twice), card against CPU."""
    probe = Encoder(mode, 16_000_000, device="cpu")
    src = NoiseSource(probe.params.active_width, probe.conf.active_lines)
    g = Encoder(mode, 16_000_000, source=src, device=cuda, **kw)
    c = Encoder(mode, 16_000_000, source=src, device="cpu", **kw)
    for b in range(3):
        snr, maxerr, ndiff = tc.error_report(g.encode_block(b),
                                             c.encode_block(b))
        msg = f"{mode} block {b}: {snr:.1f} dB, max {maxerr}, {ndiff} differ"
        assert ndiff == 0, msg


@pytest.mark.parametrize("branch", ["taps", "other"])
@pytest.mark.parametrize("mode,nt", [("pal-fm", 67), ("ntsc-fm", 71)])
def test_preemph_fir_real_equal_plain(cuda, mode, nt, branch):
    """fir_real with the CCIR-405 pre-emphasis taps at 20.25 MS/s (the
    kernel's run-time tap loop) on two frames of an encoder-like stream,
    and with the first tap pair changed to take the other first-step
    branch: equal to its plain version."""
    p = VideoParams.create(replace(get_mode(mode), vfilter=True),
                           20_250_000, 0)
    taps = torch.as_tensor(p.vfilter_taps).clone()
    assert taps.shape[0] == nt
    if branch == "other":
        r0, r1 = float(taps[-1]), float(taps[-2])
        taps[-1] = -abs(r0) if not sf.fuse_second(r0, r1) else abs(r0)
        taps[-2] = abs(r1) or 0.01
    W, half = p.width, nt // 2
    n = 2 * p.conf.lines * W
    g = torch.Generator(device=cuda).manual_seed(nt)
    x = torch.randn(n + 2 * W, generator=g, device=cuda) * 8000.0
    xs = x[W - half: W - half + n + nt - 1]
    y = sf.fir_real(xs, taps, n)
    assert torch.equal(y, sf.stream_fir_plain(xs, taps, None, n))


def test_fm_video_and_offset_card_match_cpu(cuda):
    """fm_video_modulate (with the energy-dispersal triangle and a phase
    carry; phases of thousands of radians) and offset_rotate (at the
    intro and after it) on seeded blocks, on the card and on the CPU:
    byte-equal."""
    out = {}
    for d in ("cpu", cuda):
        rng = np.random.default_rng(77)
        st = rf_ops.make_fm_video_statics(16e6, 1.0, 20_250_000, 625)
        x = torch.as_tensor((rng.standard_normal((625, 1296)) * 12000)
                            .astype(np.float32), device=d)
        tri = torch.as_tensor(rng.integers(-2048, 2048, (625, 1296))
                              .astype(np.int32), device=d)
        fi, fq, r = rf_ops.fm_video_modulate(
            st, x, torch.tensor(98765, device=d), tri)
        ost = rf_ops.make_offset_statics(-2_250_000, 20_000_000, 1280,
                                         device=d)
        rot = []
        for k0 in (0, 777):
            c0, s0, nz = rf_ops.offset_rotation(-2_250_000, 20_000_000, k0,
                                                1280, 64)
            k = np.maximum(np.arange(k0, k0 + 64), 0).astype(np.int32)
            t = lambda a: torch.as_tensor(a, device=d)
            rot += rf_ops.offset_rotate(ost, x[:64, :1280], x[64:128, :1280],
                                        t(c0), t(s0), t(nz), t(k))
        out[d] = [v.cpu().numpy() for v in (fi, fq, r, *rot)]
    for i, (a, b) in enumerate(zip(out[cuda], out["cpu"])):
        assert a.tobytes() == b.tobytes(), \
            f"output {i}: {np.count_nonzero(a != b)} of {a.size} differ"


@pytest.mark.parametrize("mode,rate,kw", [
    ("pal-fm", 20_250_000, {"vfilter": True}),
    ("pal-fm", 16_000_000, {"swap_iq": True}),
    ("secam-fm", 16_000_000, {}),
    ("i", 20_000_000, {"offset": -2_250_000}),
    ("mux", 20_000_000, {})])
def test_rf_encoder_card_matches_cpu(cuda, mode, rate, kw):
    """FM video (host-exact, and the device closed form with swap-IQ),
    SECAM-FM, PAL-I with an offset and the two-channel mux, one-frame
    blocks 0-2, card against CPU."""
    def make(d):
        if mode == "mux":
            return MuxEncoder([Encoder("i", rate, offset=o, device=d)
                               for o in (-2_250_000, 2_250_000)])
        return Encoder(mode, rate, device=d, **kw)
    g, c = make(cuda), make("cpu")
    for b in range(3):
        snr, maxerr, ndiff = tc.error_report(g.encode_block(b),
                                             c.encode_block(b))
        msg = f"{mode} block {b}: {snr:.1f} dB, max {maxerr}, {ndiff} differ"
        assert ndiff == 0, msg


def _card_vs_cpu(cuda, name, make, blocks):
    g, c = make(cuda), make("cpu")
    for b in range(blocks):
        snr, maxerr, ndiff = tc.error_report(g.encode_block(b),
                                             c.encode_block(b))
        msg = f"{name} block {b}: {snr:.1f} dB, max {maxerr}, {ndiff} differ"
        assert ndiff == 0, msg


def test_svideo_lowpass_card_matches_cpu(cuda):
    """PAL S-Video with the low-pass: the stream FIR kernel runs twice a
    block, on Y and on C; blocks 0-2 card against CPU."""
    conf = replace(get_mode("pal"), s_video=True)
    c0, r0 = _launches()
    _card_vs_cpu(cuda, "pal S-Video", lambda d: Encoder(
        conf, 16_000_000, vfilter=True, device=d), 3)
    assert _launches() == (c0, r0 + 6)


@pytest.mark.parametrize("mode,rate,kw", [
    ("30", 100_000, {}),
    ("nbtv-am", 100_000, {}),
    ("apollo-fsc", 14_000_000, {}),
    ("apollo-fsc-fm", 13_500_000, {}),
    ("cbs405", 9_000_000, {}),
    ("m-cbs405", 14_000_000, {}),
    ("secam", 16_000_000, {"s_video": True}),
    ("i", 16_000_000, {"s_video": True, "vfilter": True}),
    ("i", 16_000_000, {"pixel_rate": 14_750_000}),
    ("pal", 8_000_000, {"pixel_rate": 16_000_000}),
    ("pal-fm", 20_250_000, {"pixel_rate": 13_500_000})])
def test_raster_family_card_matches_cpu(cuda, mode, rate, kw):
    """The rotated and field-sequential modes, S-Video and the resampler,
    one-frame blocks 0-3 (every colour field), card against CPU."""
    kw = dict(kw)
    conf = get_mode(mode)
    if kw.pop("s_video", False):
        conf = replace(conf, s_video=True)
    _card_vs_cpu(cuda, mode, lambda d: Encoder(conf, rate, device=d, **kw),
                 4)


@pytest.mark.parametrize("fpb", [1, 64])
@pytest.mark.parametrize("mode,rate,px", [("i", 16_000_000, 14_750_000),
                                          ("pal", 8_000_000, 16_000_000)])
def test_resample_card_matches_cpu(cuda, mode, rate, px, fpb):
    """device_resample_block on a seeded stream, both branches, one and
    64 frames: the card equals the CPU byte for byte."""
    conf = get_mode(mode)
    w_px = VideoParams.create(conf, rate, px).width
    w_out = VideoParams.create(conf, rate, 0).width
    nlines = fpb * conf.lines
    st = rs_mod.make_block_statics(rs_mod.Resampler.create(rate, px), w_px,
                                   w_out, nlines)
    flat = (np.random.default_rng(fpb).standard_normal(
        (nlines + 2) * w_px) * 15000).astype(np.float32)
    got = rs_mod.device_resample_block(st, torch.as_tensor(flat,
                                                           device=cuda))
    ref = rs_mod.device_resample_block(st, torch.as_tensor(flat))
    assert torch.equal(got.cpu(), ref)


TT_DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def _tt_clock():
    return 1_200_000_000


# name: (mode, sample rate, Encoder arguments)
SERVICE_CASES = {
    "pal-i-teletext-vsb": ("i", 16_000_000, {
        "vfilter": True, "teletext": "demo.tti", "wss": "16:9",
        "vits": True, "vitc": True}),
    "m-cc608-acp": ("m", 13_500_000, {
        "cc608": True, "acp": True, "vits": True, "vitc": True}),
    "pal-wss-auto": ("pal", 16_000_000, {"wss": "auto"}),
    "pal-vits-angle": ("pal", 13_513_500, {"vits": True}),
    "m-vits-angle": ("m", 13_513_500, {"vits": True}),
    "ntsc-acp": ("ntsc", 13_500_000, {"acp": True}),
    "pal-teletext-raw": ("pal", 16_000_000, {
        "teletext": "raw:raw_tt_packets.bin"}),
    "i-sis-vsb": ("i", 16_000_000, {"sis": "dcsis", "vfilter": True})}


@pytest.mark.parametrize("name", sorted(SERVICE_CASES))
def test_services_card_match_cpu(cuda, name):
    """The VBI services, one-frame blocks 0-3, card against CPU (caption
    pairs queued on both, teletext's clock fixed)."""
    mode, rate, kw = SERVICE_CASES[name]
    kw = dict(kw)
    if "teletext" in kw:
        tt = kw["teletext"]
        kw["teletext"] = (("raw:" + os.path.join(TT_DATA, tt[4:]))
                          if tt.startswith("raw:")
                          else os.path.join(TT_DATA, tt))
        kw["teletext_clock"] = _tt_clock

    def make(d):
        enc = Encoder(mode, rate, device=d, **kw)
        for svc in enc.services:
            if hasattr(svc, "write_pair"):
                for pair in ((0x14, 0x20), (0x48, 0x49)):
                    svc.write_pair(*pair)
        return enc
    _card_vs_cpu(cuda, name, make, 4)


@pytest.mark.parametrize("tf32", [False, True])
def test_render_exact_under_tf32(cuda, tf32):
    """vbidata.render on the card equals the CPU's whether TF32 is on or
    off: it sums in f64 (teletext's pulses reach about 15,000, past TF32's
    11 bits)."""
    from hacktv_tpu_torch.services import vbidata
    from hacktv_tpu_torch.services.teletext import Teletext
    p = VideoParams.create(get_mode("i"), 16_000_000, 0)
    basis = torch.as_tensor(Teletext(p, os.path.join(TT_DATA, "demo.tti"),
                                     device=cuda).basis)
    bits = torch.as_tensor((np.random.default_rng(4).random(
        (2048, 360)) < 0.4).astype(np.float32))
    ref = vbidata.render(bits, basis)
    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        got = vbidata.render(bits.to(cuda), basis.to(cuda)).cpu()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was
    assert torch.equal(got, ref)


# the scramblers and DANCE, one-frame blocks: (mode, rate, arguments)
SCRAMBLE_CASES = {
    "i-videocrypt-vsb": ("i", 16_000_000, {"videocrypt": "free",
                                           "vfilter": True}),
    "pal-videocrypt-1-2": ("pal", 16_000_000, {"videocrypt": "free",
                                               "videocrypt2": "free"}),
    "pal-videocrypt-conditional": ("pal", 16_000_000,
                                   {"videocrypt": "conditional"}),
    "i-videocrypts": ("i", 16_000_000, {"videocrypts": "free"}),
    "l-syster-vsb": ("l", 16_000_000, {"syster": "premiere-fa",
                                       "systeraudio": True,
                                       "vfilter": True}),
    "pal-syster-systercnr": ("pal", 16_000_000,
                             {"syster": "premiere-fa",
                              "systercnr": "premiere-fa"}),
    "pal-systercnr": ("pal", 16_000_000, {"systercnr": "premiere-fa"}),
    "l-d11": ("l", 16_000_000, {"d11": "premiere-fa"}),
    "i-sis-systeraudio": ("i", 16_000_000, {"sis": "dcsis",
                                            "systeraudio": True}),
    "ntsc-bs": ("ntsc-bs", 16_000_000, {}),
}


@pytest.mark.parametrize("name", sorted(SCRAMBLE_CASES))
def test_scramblers_card_match_cpu(cuda, name):
    """The scramblers and DANCE, one-frame blocks 0-3, card against CPU:
    Syster's 345-line halo crosses every block boundary."""
    mode, rate, kw = SCRAMBLE_CASES[name]
    _card_vs_cpu(cuda, name, lambda d: Encoder(mode, rate, device=d, **kw),
                 4)


@pytest.mark.parametrize("tf32", [False, True])
def test_dance_product_card_matches_cpu(cuda, tf32):
    """DANCE's two-part pulse product (taps up to |5,605|) on the card
    equals the CPU's at a 64-frame block's shapes, with TF32 on and off;
    a one-part f32 product of the same taps under TF32 would round."""
    e = {d: Encoder("ntsc-bs", 16_000_000, frames_per_block=64, device=d)
         for d in ("cpu", "cuda")}
    nl = 64 * 525
    dc = e["cpu"].audio.dance_block(0, nl, e["cpu"].dance_statics)
    res = {}
    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        for d, enc in e.items():
            zero = torch.zeros((nl, enc.params.width), device=d)
            out = synth.nicam_add(
                enc.dance_statics, zero, zero,
                torch.as_tensor(dc["signs_i"], device=d),
                torch.as_tensor(dc["signs_q"], device=d), dc["offq"],
                dc["offr"], torch.as_tensor(dc["cc_off"], device=d), 0)
            res[d] = [t.cpu() for t in out]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was
    assert all(torch.equal(a, b) for a, b in zip(res["cuda"], res["cpu"]))


@pytest.mark.parametrize("name", ["i-videocrypt-vsb", "l-syster-vsb"])
def test_scrambler_applies_card_match_cpu(cuda, name):
    """Each scrambler's apply at the 64-frame block's shape (its halo
    included) on a seeded block, card against CPU."""
    from hacktv_tpu_torch.transfer import arrays_to_device
    mode, rate, kw = SCRAMBLE_CASES[name]
    g = Encoder(mode, rate, frames_per_block=64, device=cuda, **kw)
    c = Encoder(mode, rate, frames_per_block=64, device="cpu", **kw)
    nl = 64 * g.params.lines
    n = nl + 1 + g.halo_after
    rng = np.random.default_rng(8)
    block = rng.integers(-12000, 24000, (n, g.params.width)).astype(
        np.float32)
    for sg, sc in zip(g.services, c.services):
        ag = sg.block_arrays(nl - 1, n, np.zeros(n, bool))
        ac = sc.block_arrays(nl - 1, n, np.zeros(n, bool))
        got = sg.apply(torch.as_tensor(block, device=cuda),
                       arrays_to_device(ag, cuda)).cpu()
        ref = sc.apply(torch.as_tensor(block), arrays_to_device(ac, "cpu"))
        assert torch.equal(got, ref), type(sg).__name__


MAC_CASES = {
    "d2mac": ("d2mac", {}),
    "d2mac-am-dcut": ("d2mac-am", {"scramble_video": 2}),
    "dmac-fm": ("dmac-fm", {}),
    "dmac-scut-audio": ("dmac", {"scramble_video": 1,
                                 "scramble_audio": True}),
    "d2mac-fm-ec": ("d2mac-fm", {"eurocrypt": "filmnet",
                                 "scramble_audio": True}),
    "d2mac-teletext": ("d2mac", {"teletext": os.path.join(TT_DATA,
                                                          "demo.tti"),
                                 "teletext_clock": _tt_clock}),
    "d2mac-pixelrate": ("d2mac", {"pixel_rate": 13_500_000}),
    "dmac-pipelined": ("dmac-am", {"pipeline_mux": True}),
}


def _mac(mode, kw, device, fpb=1):
    from hacktv_tpu_torch.services.eurocrypt import Eurocrypt
    from hacktv_tpu_torch.video.mac import MacEncoder
    kw = dict(kw)
    if "eurocrypt" in kw:
        kw["eurocrypt"] = Eurocrypt(kw["eurocrypt"], now=1_200_000_000)
    return MacEncoder(mode, 20_250_000, frames_per_block=fpb,
                      device=device, **kw)


@pytest.mark.parametrize("tf32", [False, True])
@pytest.mark.parametrize("name", sorted(MAC_CASES))
def test_mac_card_matches_cpu(cuda, name, tf32):
    """Each MAC configuration, one-frame blocks 0-3, card against CPU,
    with TF32 on and off: the f64 duobinary products are exact either
    way."""
    mode, kw = MAC_CASES[name]
    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        _card_vs_cpu(cuda, name, lambda d: _mac(mode, kw, d), 4)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was


@pytest.mark.parametrize("mode", ["d2mac-fm", "dmac"])
def test_mac_64_frame_blocks_card_match_cpu(cuda, mode):
    """64-frame blocks 0-1 (the shapes chip_smoke.py runs), TF32 on,
    card against CPU."""
    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        _card_vs_cpu(cuda, mode, lambda d: _mac(mode, {}, d, fpb=64), 2)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was


def test_mac_products_card_exact(cuda):
    """The duobinary products on the card with TF32 on equal the CPU's
    and the f32 products on the CPU; one-part f32 products under TF32
    would round."""
    from hacktv_tpu_torch.video import mac as tmac
    t = tmac.MacEncoder("d2mac", 20_250_000, device=cuda)
    rng = np.random.default_rng(4)
    bits = rng.integers(0, 2, (4098, t.mux.nbits))
    sym = torch.as_tensor(bits * rng.choice([-1, 1], (4098, 1)),
                          dtype=torch.float64)
    ref = tmac.duobinary_products(tuple(b.cpu() for b in t.d_bases), sym)
    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = tmac.duobinary_products(t.d_bases, sym.to(cuda))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was
    s32 = sym.float()
    f32 = [torch.as_tensor(B) for B in (t.Bm, t.B0, t.Bp)]
    plain = (s32[1:4097] @ f32[1] + s32[0:4096] @ f32[2],
             s32[2:4098] @ f32[0])
    for g, r, p in zip(got, ref, plain):
        assert torch.equal(g.cpu(), r) and torch.equal(r, p)


MOVING_CASES = {
    "i-filter": ("i", 16_000_000, {"vfilter": True}),
    "pal": ("pal", 16_000_000, {}),
    "l-filter": ("l", 16_000_000, {"vfilter": True}),
    "pal-fm": ("pal-fm", 20_250_000, {}),
    "i-pixelrate": ("i", 16_000_000, {"pixel_rate": 14_750_000}),
    "pal-svideo": ("pal", 16_000_000, {"s_video": True}),
    "ntsc-cc608": ("ntsc", 13_500_000, {"cc608": True}),
}


@pytest.mark.parametrize("name", sorted(MOVING_CASES))
def test_moving_card_matches_cpu(cuda, name):
    """A moving source (seeded frames, saturated for SECAM), 4-frame
    blocks 0-1: the frames stack and convert through the LUT on the card
    (SECAM on one frame a block, with glibc's large-argument sin/cos),
    card against CPU."""
    mode, rate, kw = MOVING_CASES[name]
    kw = dict(kw)
    conf = get_mode(mode)
    if kw.pop("s_video", False):
        conf = replace(conf, s_video=True)
    p = VideoParams.create(conf, rate, kw.get("pixel_rate", 0))
    src = tc.MovingSource(p.active_width, conf.active_lines,
                          saturated=mode == "l")
    _card_vs_cpu(cuda, name, lambda d: Encoder(
        conf, rate, source=src, frames_per_block=4, device=d, **kw), 2)


def test_moving_lut_gather_card(cuda):
    """The LUT gather of a 6-frame stack on the card against the host
    conversion, value for value."""
    p = VideoParams.create(get_mode("i"), 16_000_000)
    lut = torch.as_tensor(raster.build_yuv_lut(p), device=cuda)
    src = tc.MovingSource(p.active_width, 576)
    stack = np.stack([src.read_video(f) for f in range(6)])
    got = raster.yuv_convert_device(lut, torch.as_tensor(stack,
                                                         device=cuda))
    ref = raster.rgb_to_yuv_host(p, stack)
    for g, r in zip(got, ref):
        assert np.array_equal(g.cpu().numpy(), r)


CHECKPOINT_CASES = {
    "pal-i": ("i", 16_000_000, {}),
    "secam-l-vsb": ("l", 16_000_000, {"vfilter": True}),
    "pal-fm-preemph": ("pal-fm", 20_250_000, {"vfilter": True}),
    "i-videocrypt-vsb": ("i", 16_000_000, {"vfilter": True,
                                           "videocrypt": "free"}),
    "i-sis": ("i", 16_000_000, {"sis": "dcsis"}),
    "pal-i-teletext-vsb": ("i", 16_000_000, {
        "vfilter": True, "wss": "16:9", "vits": True, "vitc": True,
        "teletext": os.path.join(os.path.dirname(__file__), "data",
                                 "demo.tti"), "teletext_clock": _tt_clock}),
}


@pytest.mark.parametrize("name", sorted(CHECKPOINT_CASES))
def test_checkpoint_card_resumes_on_cpu(cuda, name):
    """4-frame blocks: a checkpoint at block 2 written on the card
    resumes on the CPU and one written on the CPU resumes on the card,
    each to the continuous stream (blocks 2-3)."""
    mode, rate, kw = CHECKPOINT_CASES[name]
    mk = lambda d: Encoder(mode, rate, frames_per_block=4, device=d, **kw)
    for writer, reader in ((cuda, "cpu"), ("cpu", cuda)):
        full = mk(writer)
        ref = [full.encode_block(b) for b in range(4)]
        a = mk(writer)
        for b in range(2):
            a.encode_block(b)
        blob = a.checkpoint(2)
        tc.assert_no_torch(blob)
        r = mk(reader)
        assert r.load_checkpoint(blob) == 2
        for b in (2, 3):
            _, mx, nd = tc.error_report(r.encode_block(b), ref[b])
            assert nd == 0, f"{name} {writer}->{reader} block {b}: {nd}"


def test_mac_checkpoint_card_resumes_on_cpu(cuda):
    """D2-MAC FM with Eurocrypt: the card's checkpoint resumes on the CPU
    to the card's continuous stream."""
    kw = {"eurocrypt": "filmnet", "scramble_audio": True}
    full = _mac("d2mac-fm", kw, cuda, fpb=4)
    ref = [full.encode_block(b) for b in range(4)]
    a = _mac("d2mac-fm", kw, cuda, fpb=4)
    for b in range(2):
        a.encode_block(b)
    blob = a.checkpoint(2)
    tc.assert_no_torch(blob)
    r = _mac("d2mac-fm", kw, "cpu", fpb=4)
    assert r.load_checkpoint(blob) == 2
    for b in (2, 3):
        assert np.array_equal(r.encode_block(b), ref[b]), b


SHARDED_CASES = {
    "i-vsb": ("i", 4_000_000, {"vfilter": True}),
    "l-syster-vsb": ("l", 4_000_000, {"vfilter": True,
                                      "syster": "premiere-fa"}),
    "pal-8-from-16": ("pal", 8_000_000, {"pixel_rate": 16_000_000}),
    "pal-fm-swap": ("pal-fm", 16_000_000, {"swap_iq": True}),
}


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", sorted(SHARDED_CASES))
def test_sharded_card_matches_cpu(cuda, name, n):
    """4-frame blocks 0-2 in n shards on the card against one device on
    the CPU, byte for byte."""
    mode, rate, kw = SHARDED_CASES[name]
    c = Encoder(mode, rate, frames_per_block=4, device="cpu", **kw)
    g = Encoder(mode, rate, frames_per_block=4, devices=[cuda] * n, **kw)
    for b in range(3):
        _, mx, nd = tc.error_report(g.encode_block(b), c.encode_block(b))
        assert nd == 0, f"{name} x{n} block {b}: {nd} samples differ"


def test_sharded_mac_card_matches_cpu(cuda):
    """D2-MAC FM with Eurocrypt, 4-frame blocks 0-2 in 2 shards on the
    card against one device on the CPU."""
    kw = {"eurocrypt": "filmnet", "scramble_audio": True}
    c = _mac("d2mac-fm", kw, "cpu", fpb=4)
    g = _mac("d2mac-fm", dict(kw, devices=[cuda] * 2), cuda, fpb=4)
    for b in range(3):
        assert np.array_equal(g.encode_block(b), c.encode_block(b)), b
