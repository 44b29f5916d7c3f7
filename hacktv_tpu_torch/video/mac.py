"""D/D2-MAC encoder: host bit-domain multiplex + batched waveform synthesis
on the device.

Port of hacktv_tpu/video/mac.py.  Architecture (vs the reference's
per-line mac_next_line, src/mac.c:1622-1873): the serial bit domain —
packet multiplex, frame sync, PRBS whitening, audio coding — runs on the
host as a sequential state machine (`MacMux`, numpy as in the JAX
package, its queue replay, line-bit assembly and coders in the native
runtime) that emits per-line packet-stream slices and scrambling cut
points; the waveform is then synthesised on the device as a batch of
whole frames in torch: the line bits are assembled from the stream
(base-row gather, stream XOR, the start-polarity scan), duobinary pulse
shaping becomes three basis products (own line + spill into the
previous/next line), luma/chroma time multiplex becomes masked row
gathers, and the single/double-cut rotations become per-line modular
gathers.

The basis products are exact whatever the matmul precision: the bases
are integers up to |13,107| (past TF32's 11 significant bits) and the
symbols -1, 0 or +1, and the three products run in f64, which has no
reduced-precision mode: every product and partial sum is an integer far
below 2^53, so the sum is exact in any order, and cast to f32 (below
2^24, exact) it is the JAX package's f32 matmul at HIGHEST precision.
On an NVIDIA H100 80GB HBM3 at 700 W the f64 products took 4.0 and 7.1
ms for a 64-frame D2-MAC and D-MAC block, against 10.2 and 19.0 ms for
the other exact way, each basis split as 64 * hi + lo in two f32
products with TF32 off (chip_smoke.py's `mac` phase; PERF.md).
"""

from __future__ import annotations

import copy
import math
import pickle
from fractions import Fraction

import numpy as np
import torch

from .. import runtime, shard, telemetry, transfer
from ..audio.mac_audio import MacAudioEnc
from ..config.standards import MacMode, Modulation, OutputType, VidConfig, \
    get_mode
from ..ops import mac_bits as mb
from ..ops import resampler
from ..ops.shapes import rrc
from ..rf import ops as rf_ops
from ..services.vbidata import device_unpack_bits

INT16_MAX = 32767
MAC_CLOCK_RATE = 20_250_000
AUDIO_RATE = 32_000
NICAM_AUDIO_LEN = 32   # NICAM_AUDIO_RATE/1000 (src/nicam728.h:37)
MAC_QUEUE_LEN = 12


def _lround(x):
    x = np.asarray(x, dtype=np.float64)
    return np.where(x >= 0, np.floor(x + 0.5), np.ceil(x - 0.5)
                    ).astype(np.int64)


# ----------------------------------------------------------------------
# Duobinary basis (src/mac.c:153-191, 205-253)

def duobinary_bases(mode_d: bool, width: int, level: float):
    """Per-bit pulse-shape rows split by destination line.

    Returns (Bm, B0, Bp) float32 [nbits, width]: contribution of line
    j's symbols to lines j-1, j, j+1 (the reference renders across a
    3-line window, negative tap offsets landing at the end of the
    previous line, src/mac.c:227-232).
    """
    bits = 1296 if mode_d else 648
    sps = width / bits
    offset = width / 1296 * (-1 if mode_d else -3)
    ntaps = int(sps * 16) | 1
    htaps = ntaps // 2

    Bm = np.zeros((bits, width), dtype=np.float64)
    B0 = np.zeros((bits, width), dtype=np.float64)
    Bp = np.zeros((bits, width), dtype=np.float64)
    xs = np.arange(ntaps)
    for i in range(bits):
        pos0 = int(_lround(offset + sps * i))
        err = offset + sps * i - pos0
        start = pos0 - htaps
        vals = _lround(rrc((xs - htaps - err) / sps, 0, 1) * level)
        p = start + xs
        prev = p < 0
        cur = (p >= 0) & (p < width)
        nxt = p >= width
        Bm[i, p[prev] + width] = vals[prev]
        B0[i, p[cur]] = vals[cur]
        Bp[i, p[nxt] - width] = vals[nxt]
    return (np.asarray(Bm, dtype=np.float32),
            np.asarray(B0, dtype=np.float32),
            np.asarray(Bp, dtype=np.float32))


# ----------------------------------------------------------------------
# Host YUV conversion with the MAC chroma clamp (src/video.c:3920-3958)

def mac_yuv_host(conf: VidConfig, rgb: np.ndarray, level: float):
    gamma = conf.gamma if conf.gamma > 0 else 1.0
    rw = conf.rw_co if conf.rw_co > 0 else 0.299
    gw = conf.gw_co if conf.gw_co > 0 else 0.587
    bw = conf.bw_co if conf.bw_co > 0 else 0.114
    f = rgb.astype(np.float64) / 255.0
    if gamma != 1.0:
        f = np.power(f, 1.0 / gamma)
    r, g, b = f[..., 0], f[..., 1], f[..., 2]
    y = r * rw + g * gw + b * bw
    u = (b - y) * conf.eu_co
    v = (r - y) * conf.ev_co
    d = np.maximum(np.abs(u), np.abs(v))
    scale = np.where(d > 0.5, 0.5 / np.maximum(d, 1e-12), 1.0)
    u *= scale
    v *= scale
    wb = conf.white_level - conf.black_level
    y = (conf.black_level + y * wb) * level
    u *= wb * level
    v *= wb * level
    q = lambda a: _lround(np.clip(a, -1, 1) * INT16_MAX)
    return q(y), q(u), q(v)


# ----------------------------------------------------------------------
# The sequential bit-domain multiplex

class _PolView:
    """Read-only mapping k -> duobinary start polarity, backed by the
    packed-window cache (the eager dict cost ~1.5 ms/32-frame window
    to fill and prune)."""

    def __init__(self, mux):
        self._m = mux

    def get(self, k, default=None):
        for base, _pk, pl in getattr(self._m, "_packed_wins", ()):
            if base <= k < base + len(pl):
                return int(pl[k - base])
        return default

    def __getitem__(self, k):
        v = self.get(k)
        if v is None:
            raise KeyError(k)
        return v

    def __contains__(self, k):
        return self.get(k) is not None


class _LineBitsView:
    """Read-only mapping k -> unpacked line bits, backed by the mux's
    packed window cache (lines are materialised packed; this view
    exists for the parity tests and bits_block's uncovered rows)."""

    def __init__(self, mux):
        self._m = mux

    def get(self, k, default=None):
        for base, pk, _pl in getattr(self._m, "_packed_wins", ()):
            if base <= k < base + len(pk):
                return np.unpackbits(
                    pk[k - base], bitorder="little")[:self._m.nbits]
        return default

    def __getitem__(self, k):
        v = self.get(k)
        if v is None:
            raise KeyError(k)
        return v

    def __contains__(self, k):
        return self.get(k) is not None


class _PackedChunk:
    """One audio chunk's packets as rows of a shared payload matrix
    (write_audio_batch(packed=True)): the optional SI packet's
    continuity, then nrow BC1 payloads pm[row0:row0+nrow] with
    continuity cont0, cont0+1, ..."""
    __slots__ = ("si_cont", "pm", "row0", "nrow", "cont0")

    def __init__(self, si_cont, pm, row0, nrow, cont0):
        self.si_cont = si_cont
        self.pm = pm
        self.row0 = row0
        self.nrow = nrow
        self.cont0 = cont0


class _PushCollector:
    """Ordered push sink for the native replay: plain tuples from
    _write_packet plus whole audio segments (a _PackedChunk slice), so
    audio payloads never round-trip through per-packet bytes objects."""
    __slots__ = ("items", "count")

    def __init__(self):
        self.items = []
        self.count = 0

    def append(self, tup):
        # (subframe, address, continuity, payload, scramble)
        self.items.append(tup)
        self.count += 1

    def append_seg(self, chunk, address, scramble):
        self.items.append((chunk, address, scramble))
        self.count += chunk.nrow


class MacMux:
    """Replays the reference's per-line packet multiplex deterministically
    (golden build: audio lineprocess synchronous, trailing the raster by
    2 lines).

    `ensure(k)` advances through stream line k; `line_bits[k]` /
    `line_sym[k]` / `scramble[k]` are then available for all lines ≤ k-1
    (a line's scramble is decided one iteration later).

    `native`: the queue replay, the line-bit assembly, the audio coder
    and the CA keystreams go through the native runtime, which raises if
    it does not load.  `native=False` runs their plain Python versions
    (`_replay_python`, the Python branch of `_materialize`, the Python
    PRBS recurrences, packet encoder and audio coder), the reference the
    tests hold the native calls against; nothing switches to it on its
    own.
    """

    def __init__(self, conf: VidConfig, width: int, sample_rate: int,
                 source, vsam: int, scramble_audio: bool = False,
                 timestamp: int = 1_200_000_000, aspect_43: int = 1,
                 eurocrypt=None, volume: float = 1.0, teletext=None,
                 native: bool = True):
        self.conf = conf
        self.native = bool(native)
        self.mode_d = conf.mac_mode == MacMode.D
        self.nbits = 1296 if self.mode_d else 648
        self.W = width
        self.S = sample_rate
        self.source = source
        self.vsam = vsam
        self.volume_int = int(volume * 256 + 0.5)

        self.prbs15 = mb.prbs15()
        self.teletext = teletext    # optional MacTeletext feed
        self.seeds = mb.line_prbs_seeds(self.mode_d)
        self.udt = mb.build_udt(timestamp)
        self.l625 = mb.Line625State(self.mode_d)
        self.aspect_43 = aspect_43
        self.ratio = 0 if aspect_43 else 1

        self.cw = mb.PRBS_CW_FA
        self.prbs1 = mb.CaPrbs1(self.native)
        self.prbs2 = mb.CaPrbs2(self.native)
        self.eurocrypt = eurocrypt  # optional Eurocrypt instance

        # packet queues: per subframe list of (addr, cont, payload, scr)
        self.queues = [[], []]
        self.dummy_continuity = [0, 0]
        # per-subframe encoded packet bit stream: appended on demand by
        # the queue simulation, consumed sequentially (pos/len); the
        # per-line bit assembly is deferred and batched (_materialize)
        self._stream = [[], []]
        self._slen = [0, 0]       # appended bits
        self._spos = [0, 0]       # consumed bits
        self._sbase = [0, 0]      # absolute offset of _stream[c][0]
        # native mode keeps the streams PACKED in one buffer per
        # subframe (bit i of _pbuf[c] = absolute bit _sbase[c] + i);
        # _stream is used only by the Python replay
        self._pbuf = [np.zeros(1 << 14, np.uint8),
                      np.zeros(1 << 14, np.uint8)]
        self._packed_stream = False
        self._pb = 0           # batch base line (set per ensure window)
        self._pn = 0           # rows pending materialisation
        self._ppos = np.zeros((0, 2), dtype=np.int64)
        self._plen = np.zeros((0, 2), dtype=np.int64)
        self._pfull_rows: dict[int, np.ndarray] = {}
        self._ptt_rows: dict[int, tuple] = {}
        self._dummy_cycle: np.ndarray | None = None
        nsub = 2 if self.mode_d else 1
        self._wh_all = np.stack([
            self.prbs15.seq(int(self.seeds[l]), 99 * nsub)
            for l in range(mb.MAC_LINES)])
        self._hs = np.stack([
            mb.rbits_msb((~mb.MAC_LSW) & 0x3F, 6),
            mb.rbits_msb(mb.MAC_LSW, 6)]).astype(np.uint8)

        self.audio = MacAudioEnc(
            high_quality=conf.mac_audio_quality,
            stereo=conf.mac_audio_stereo,
            protection=conf.mac_audio_protection,
            linear=not conf.mac_audio_companded,
            scramble=scramble_audio,
            conditional=eurocrypt is not None, native=self.native)
        if self.mode_d:
            # BSB receivers expect audio at address 128 (src/mac.c:930-935)
            self.audio.address = 128
        self.audio_pairs = 0   # pairs consumed so far
        self._audio_pkts: dict[int, list] = {}
        self._audio_batches: list[tuple] = []   # native-path schedule
        self._audio_m = 0      # chunks batch-encoded so far
        self.nicam_buf_pairs = 0
        self.audio_lag = 1     # lines the audio process trails macraster

        self.polarity = -1
        self.k = 0             # next iteration (stream line index)
        self.pol_start = _PolView(self)
        self.line_bits = _LineBitsView(self)
        # per line: (apply, xc_colour_or_single, xc_luma)
        self.scramble: dict[int, tuple] = {}
        # device materialisation (MacEncoder sets device_mode=True):
        # _materialize only records the read schedule + packed frame
        # rows; the base-row gather / stream XOR / polarity scan run on
        # device from device_bits_block()'s bundle
        self.device_mode = False
        self._sched_wins: list[tuple] = []
        self._full_abs: dict[int, np.ndarray] = {}

    # -- packet queue ---------------------------------------------------
    def _write_packet(self, subframe, address, continuity, payload, scr):
        col = getattr(self, "_push_sink", None)
        if col is not None:
            # native replay: collect pushes in order; the queue-full
            # drop rule is applied inside rt_mac_mux_replay
            col.append((subframe, address, continuity, payload, scr))
            return True
        q = self.queues[subframe]
        if len(q) == MAC_QUEUE_LEN:
            return False
        q.append((address, continuity, payload, scr))
        return True

    # -- event bodies shared by the python and native replays ----------
    def _event_frame(self, frame):
        if self.eurocrypt is not None:
            self.eurocrypt.next_frame(self, frame)
        self.prbs1.reset(self.cw, frame - 1)
        self._cw_hist[frame] = self.cw
        if len(self._cw_hist) > 8:
            for f in sorted(self._cw_hist)[:-4]:
                del self._cw_hist[f]
        if (frame & 3) == 0:
            pkt = getattr(self, "_si_dg0", None)
            if pkt is None:
                pkt = self._si_dg0 = mb.si_dg0_packet(
                    self.audio.address)
            self._write_packet(0, 0x000, 0, pkt, False)
            if self.mode_d:
                self._write_packet(1, 0x000, 0, pkt, False)
        elif (frame & 3) == 1:
            ec = None
            if self.eurocrypt is not None:
                ec = self.eurocrypt.si_info()
            key = (self.audio.address, self.vsam, self.ratio,
                   self.teletext is not None,
                   tuple(sorted(ec.items())) if ec else None)
            cached = getattr(self, "_si_dg3", None)
            if cached is None or cached[0] != key:
                cached = self._si_dg3 = (
                    key, mb.si_dg3_packet(self.audio.address, self.vsam,
                                          self.ratio,
                                          self.teletext is not None,
                                          ec))
            self._write_packet(0, 0x000, 0, cached[1], False)

    def _event_audio(self, m):
        pkts = self._audio_pkts.pop(m, None)
        if pkts is None:
            pkts = self.audio.write_audio(
                self._pcm(m * NICAM_AUDIO_LEN, NICAM_AUDIO_LEN))
        if isinstance(pkts, _PackedChunk):
            a = self.audio
            if pkts.si_cont is not None:
                self._write_packet(0, a.address, pkts.si_cont,
                                   a.si_pkt, False)
            if not pkts.nrow:
                return
            col = self._push_sink
            if isinstance(col, _PushCollector):
                col.append_seg(pkts, a.address, a.scramble)
            else:
                for j in range(pkts.nrow):
                    self._write_packet(
                        0, a.address, (pkts.cont0 + j) & 3,
                        pkts.pm[pkts.row0 + j].tobytes(), a.scramble)
            return
        for addr, cont, payload, scr in pkts:
            self._write_packet(0, addr, cont, payload, scr)

    def _event_audio_slow(self, m, pkts):
        """Non-packed audio event: list-of-tuples entry or an
        on-demand encode (prefetch miss)."""
        if pkts is None:
            pkts = self.audio.write_audio(
                self._pcm(m * NICAM_AUDIO_LEN, NICAM_AUDIO_LEN))
        for addr, cont, payload, scr in pkts:
            self._write_packet(0, addr, cont, payload, scr)

    def _replay_python(self, events, his, read_ks, spans, ri, _drain,
                       nsub):
        """Reference replay: per-event drains + pushes (the plain version
        of rt_mac_mux_replay_packed, `native=False`)."""
        self._iw = [self.prbs1.take(int(next(spans, 0))), 0]
        his = [h.tolist() for h in his]   # python ints: fast indexing
        h0 = his[0]
        for ei, (k_e, phase, kind, arg) in enumerate(events):
            if h0[ei] > ri[0]:
                _drain(0, h0[ei])
            # subframe 1 is only ever pushed to at frame events (SI
            # dg0, src/mac.c:930-935), so its reads can drain lazily:
            # the dummy/real split only depends on the queue state at
            # push boundaries
            if kind == "f":
                if nsub > 1 and his[1][ei] > ri[1]:
                    _drain(1, his[1][ei])
                self._event_frame(arg)
                self._iw = [self.prbs1.take(int(next(spans, 0))), 0]
            else:
                self._event_audio(arg)
        for c in range(nsub):
            _drain(c, len(read_ks[c]))

    def _replay_native(self, events, his, read_ks, spans, lib):
        """One native call runs the queue simulation and encodes every
        packet directly into the window's stream bit buffers."""
        nsub = 2 if self.mode_d else 1
        n0 = len(read_ks[0])
        n1 = len(read_ks[1]) if nsub > 1 else 0
        ne = len(events)
        col = _PushCollector()
        for c in range(nsub):
            for (a, ct, pl, sc) in self.queues[c]:
                col.append((c, a, ct, pl, sc))
        off = [0, col.count]
        iw_parts = [self.prbs1.take(int(next(spans, 0)))]
        self._push_sink = col
        # audio chunks push rows of shared payload matrices; the whole
        # schedule is array-valued (_audio_batches), so each gap
        # between frame events resolves vectorised: off counts by
        # cumsum, items as contiguous row runs split at SI packets
        a_addr = self.audio.address
        a_scr = self.audio.scramble
        a_si = self.audio.si_pkt
        items = col.items

        def emit_audio(ms_lo: int, ms_hi: int):
            """Push chunks [ms_lo, ms_hi) and extend off per chunk."""
            self._audio_done = ms_hi
            cnt = col.count
            for b_m0, b_m1, pm, si, row0, nrow, cont0 in \
                    self._audio_batches:
                lo = max(ms_lo, b_m0)
                hi = min(ms_hi, b_m1)
                if lo >= hi:
                    continue
                s = slice(lo - b_m0, hi - b_m0)
                siv, r0v = si[s], row0[s]
                nrv, c0v = nrow[s], cont0[s]
                off.extend((cnt + np.cumsum(nrv + (siv >= 0))
                            ).tolist())
                # runs split where an SI packet interleaves
                cuts = np.nonzero(siv >= 0)[0]
                seg_lo = np.concatenate([[0], cuts])
                seg_hi = np.concatenate([cuts, [hi - lo]])
                for i, (a, b) in enumerate(zip(seg_lo, seg_hi)):
                    a, b = int(a), int(b)
                    if i > 0:          # SI packet before chunk `a`
                        self._write_packet(0, a_addr, int(siv[a]),
                                           a_si, False)
                    nr = int(nrv[a:b].sum()) if b > a else 0
                    if nr:
                        items.append((_PackedChunk(
                            None, pm, int(r0v[a]), nr,
                            int(c0v[a])), a_addr, a_scr))
                cnt += int(nrv.sum()) + len(cuts)
                col.count = cnt
                ms_lo = hi
            while ms_lo < ms_hi:       # prefetch miss: encode inline
                self._event_audio_slow(ms_lo, None)
                ms_lo += 1
                off.append(col.count)
        try:
            pend_a = None              # [ms_lo, ms_hi) pending chunks
            for k_e, phase, kind, arg in events:
                if kind == "a":
                    if pend_a is None:
                        pend_a = [arg, arg + 1]
                    else:
                        pend_a[1] = arg + 1
                    continue
                if pend_a is not None:
                    emit_audio(*pend_a)
                    pend_a = None
                self._event_frame(arg)
                iw_parts.append(
                    self.prbs1.take(int(next(spans, 0))))
                off.append(col.count)
            if pend_a is not None:
                emit_audio(*pend_a)
        finally:
            self._push_sink = None

        R = col.count
        push_q = np.zeros(R, np.uint8)
        addr = np.zeros(R, np.int32)
        cont = np.zeros(R, np.int32)
        pays = np.zeros((R, mb.MAC_PAYLOAD_BYTES), np.uint8)
        hasp = np.zeros(R, np.uint8)
        scrs = np.zeros(R, np.uint8)
        keep = [None] * R
        # audio segments, grouped by payload matrix so each group's
        # rows move in one fancy-index copy (~640 tiny chunks/block
        # made a per-segment loop overhead-bound)
        segs = {}
        i = 0
        for it in col.items:
            if len(it) == 3:                  # audio segment
                ch, a, sc = it
                g = segs.setdefault(id(ch.pm), (ch.pm, [], [], [], [],
                                                [], []))
                g[1].append(i)
                g[2].append(ch.row0)
                g[3].append(ch.nrow)
                g[4].append(ch.cont0)
                g[5].append(a)
                g[6].append(1 if sc else 0)
                i += ch.nrow
                continue
            c, a, ct, pl, sc = it
            push_q[i] = c
            addr[i] = a
            cont[i] = ct & 3
            if pl is not None:
                b = np.frombuffer(pl, np.uint8)
                pays[i, :len(b)] = b[:mb.MAC_PAYLOAD_BYTES]
                hasp[i] = 1
            if sc:
                if c != 0:
                    raise NotImplementedError(
                        "scrambled packet on subframe 1")
                scrs[i] = 1
            keep[i] = (a, ct, pl, sc)
            i += 1
        for pm, dsts, row0s, nrows, cont0s, addrs, sflags in \
                segs.values():
            nr = np.asarray(nrows, dtype=np.int64)
            tot = int(nr.sum())
            if not tot:
                continue
            j = np.arange(tot) - np.repeat(np.cumsum(nr) - nr, nr)
            src = np.repeat(np.asarray(row0s, np.int64), nr) + j
            dst = np.repeat(np.asarray(dsts, np.int64), nr) + j
            pays[dst] = pm[src]
            cont[dst] = (np.repeat(np.asarray(cont0s, np.int64), nr)
                         + j) & 3
            addr[dst] = np.repeat(np.asarray(addrs, np.int32), nr)
            hasp[dst] = 1
            scrs[dst] = np.repeat(
                np.asarray(sflags, np.uint8), nr)
        iw0 = (np.concatenate(iw_parts).astype(np.uint64)
               & np.uint64((1 << 61) - 1))
        assert len(iw0) == n0
        his0 = np.ascontiguousarray(
            np.concatenate([his[0], [n0]]).astype(np.int64))
        his1 = np.ascontiguousarray(np.concatenate(
            [his[1] if nsub > 1 else np.zeros(ne, np.int64), [n1]]
        ).astype(np.int64))
        off_a = np.ascontiguousarray(off, dtype=np.int32)
        dumc = np.ascontiguousarray(self.dummy_continuity[:2],
                                    dtype=np.int32)
        surv = np.zeros(2 * MAC_QUEUE_LEN, np.int32)
        n_surv = np.zeros(2, np.int32)
        import os as _os
        # packets land PACKED, head-to-tail, in the per-subframe stream
        # buffers (bit i of _pbuf[c] = absolute stream bit _sbase[c]+i)
        nbits0 = n0 * mb.MAC_PACKET_BITS
        nbits1 = n1 * mb.MAC_PACKET_BITS
        tail0 = self._slen[0] - self._sbase[0]
        tail1 = self._slen[1] - self._sbase[1]
        b0 = self._grow_pbuf(0, tail0 + nbits0)
        b1 = self._grow_pbuf(1, tail1 + nbits1)
        lib.rt_mac_mux_replay_packed(
            ne, his0.ctypes.data, his1.ctypes.data, off_a.ctypes.data,
            push_q.ctypes.data, addr.ctypes.data, cont.ctypes.data,
            pays.ctypes.data, hasp.ctypes.data, scrs.ctypes.data,
            iw0.ctypes.data, dumc.ctypes.data,
            b0.ctypes.data, tail0, b1.ctypes.data, tail1,
            surv.ctypes.data, n_surv.ctypes.data,
            min(2, _os.cpu_count() or 1))
        self._packed_stream = True
        self.dummy_continuity = [int(dumc[0]), int(dumc[1])]
        self._slen[0] += nbits0
        self._slen[1] += nbits1
        k = 0
        newq = [[], []]
        for c in range(2):
            for _ in range(int(n_surv[c])):
                si = int(surv[k])
                k += 1
                t = keep[si]
                if t is None:     # packed audio row: rebuild the tuple
                    t = (int(addr[si]), int(cont[si]),
                         pays[si].tobytes(), bool(scrs[si]))
                newq[c].append(t)
        self.queues = newq

    def _grow_pbuf(self, c: int, need_bits: int) -> np.ndarray:
        """Packed stream buffer for subframe c, grown (zero-filled) to
        hold need_bits plus the 16 spare readable bytes the native
        extractors require."""
        need = (need_bits + 7 >> 3) + 16
        buf = self._pbuf[c]
        if len(buf) < need:
            nb = np.zeros(max(2 * len(buf), need), np.uint8)
            nb[:len(buf)] = buf
            self._pbuf[c] = buf = nb
        return buf

    def _read_packet(self, subframe):
        q = self.queues[subframe]
        if not q:
            addr = 0x3FF
            cont = self.dummy_continuity[subframe]
            self.dummy_continuity[subframe] += 1
            return (addr, cont, None, False)
        return q.pop(0)

    # -- audio timeline ---------------------------------------------------
    def _audio_pairs_through_line(self, j: int) -> int:
        """Pairs consumed once audio-line j is processed
        (src/video.c:3273-3277 accumulator)."""
        if j < 0:
            return 0
        return (j + 1) * self.W * AUDIO_RATE // self.S

    def _pcm(self, start: int, count: int) -> np.ndarray:
        raw = self.source.read_audio(start, count)
        # int32 holds the Q8 product for any sane volume (<= 2^15)
        dt = np.int32 if self.volume_int < 32768 else np.int64
        v = (raw.astype(dt) * dt(self.volume_int) + dt(128)) >> dt(8)
        return np.clip(v, -32768, 32767)

    def _prefetch_audio(self, k_through: int):
        """Batch-encode every 728-pair chunk whose packets will be
        pushed while iterating through stream line k_through; exact
        (write_audio_batch replays the per-chunk schedule) and much
        cheaper than per-chunk calls."""
        j_hi = k_through - self.audio_lag
        if j_hi < 0:
            return
        m_hi = self._audio_pairs_through_line(j_hi) // NICAM_AUDIO_LEN
        m0 = self._audio_m
        if m_hi <= m0:
            return
        pcm = self._pcm(m0 * NICAM_AUDIO_LEN,
                        (m_hi - m0) * NICAM_AUDIO_LEN)
        chunks = [pcm[i * NICAM_AUDIO_LEN:(i + 1) * NICAM_AUDIO_LEN]
                  for i in range(m_hi - m0)]
        if self.native:
            pm, si, row0, nrow, cont0 = self.audio.write_audio_batch(
                chunks, packed=True, contig=pcm)
            self._audio_batches.append(
                (m0, m_hi, pm, si, row0, nrow, cont0))
            lo = getattr(self, "_audio_done", 0) - 8
            self._audio_batches = [b for b in self._audio_batches
                                   if b[1] > lo]
        else:
            for m, o in zip(range(m0, m_hi),
                            self.audio.write_audio_batch(chunks)):
                self._audio_pkts[m] = o
        self._audio_m = m_hi

    def _line_625(self, frame: int, line: int) -> np.ndarray:
        out = np.zeros(self.nbits, dtype=np.uint8)
        x = 0
        if self.mode_d:
            out[0] = 1
            x = 1
        out[x:x + 6] = mb.hsync_word_bits(frame, line)
        x += 6
        cri = mb.MAC_CRI if frame & 1 else (~mb.MAC_CRI) & 0xFFFFFFFF
        fsw = mb.MAC_FSW if frame & 1 else \
            (~mb.MAC_FSW) & 0xFFFFFFFFFFFFFFFF
        out[x:x + 32] = mb.rbits_msb(cri, 32)
        x += 32
        out[x:x + 64] = mb.rbits_msb(fsw, 64)
        x += 64
        il = self.l625.content_bits(frame, self.udt, self.conf.chid,
                                    self.vsam, self.aspect_43)
        if not self.mode_d:
            out[x:x + len(il)] = il
        else:
            g = self.prbs15
            n = len(il)
            rem = self.nbits - (x + 2 * n)
            wh = g.seq(int(self.seeds[line - 1]), 96 + 2 * n + rem)[96:]
            # per source bit: one PRBS bit is discarded, the source bit
            # is written, then a PRBS bit (src/mac.c:411-423, 1536-1551)
            out[x:x + 2 * n:2] = il
            out[x + 1:x + 2 * n:2] = wh[1:2 * n:2]
            x += 2 * n
            out[x:] = wh[2 * n:]
        return out

    def _line_624(self, frame: int, line: int) -> np.ndarray:
        # the body is static and the sync word only depends on parity
        par = (frame + line) & 1
        cache = getattr(self, "_l624_cache", None)
        if cache is None:
            cache = self._l624_cache = {}
        row = cache.get(par)
        if row is not None:
            return row
        out = np.zeros(self.nbits, dtype=np.uint8)
        x = 0
        if self.mode_d:
            out[0] = 1
            x = 1
        out[x:x + 6] = mb.hsync_word_bits(frame, line)
        x += 6
        body = mb.line_624_bits(self.mode_d)
        out[x:x + len(body)] = body
        cache[par] = out
        return out

    def _lines_625_batch(self, frames: np.ndarray) -> np.ndarray:
        """All of a window's frame-sync lines in one vectorised pass;
        row j == _line_625(frames[j], 625) exactly (parity-tested)."""
        frames = np.asarray(frames, dtype=np.int64)
        F = len(frames)
        out = np.zeros((F, self.nbits), dtype=np.uint8)
        x = 0
        if self.mode_d:
            out[:, 0] = 1
            x = 1
        hs = np.stack([mb.hsync_word_bits(0, 625),
                       mb.hsync_word_bits(1, 625)])
        out[:, x:x + 6] = hs[frames & 1]
        x += 6
        cri_t = np.stack([mb.rbits_msb((~mb.MAC_CRI) & 0xFFFFFFFF, 32),
                          mb.rbits_msb(mb.MAC_CRI, 32)])
        fsw_t = np.stack(
            [mb.rbits_msb((~mb.MAC_FSW) & 0xFFFFFFFFFFFFFFFF, 64),
             mb.rbits_msb(mb.MAC_FSW, 64)])
        fpar = (frames & 1).astype(np.int64)
        out[:, x:x + 32] = cri_t[fpar]
        x += 32
        out[:, x:x + 64] = fsw_t[fpar]
        x += 64
        il = self.l625.content_bits_batch(frames, self.udt,
                                          self.conf.chid, self.vsam,
                                          self.aspect_43)
        n = il.shape[1]
        if not self.mode_d:
            out[:, x:x + n] = il
            return out
        wh = getattr(self, "_wh625", None)
        if wh is None:
            rem = self.nbits - (x + 2 * n)
            wh = self.prbs15.seq(int(self.seeds[624]),
                                 96 + 2 * n + rem)[96:]
            self._wh625 = wh
        out[:, x:x + 2 * n:2] = il
        out[:, x + 1:x + 2 * n:2] = wh[None, 1:2 * n:2]
        out[:, x + 2 * n:] = wh[None, 2 * n:]
        return out

    # -- main advance -------------------------------------------------------
    def ensure(self, k_through: int):
        """Advance the multiplex through stream line k_through.

        The reference iterates a per-line state machine
        (src/mac.c:1622-1873).  Here the advance is split into three
        phases (a per-line Python walk would bound D-MAC's throughput):

        A. *read scheduling* — packet-read times are fully deterministic
           (every data line consumes exactly 99 bits per subframe, line
           623 drains without refill), so per-line (pos, len) and the
           line of every packet read come from closed-form arithmetic;
        B. *queue replay* — pushes (frame SI/Eurocrypt at line 1, audio
           packets at line ends) and reads are merged in line order;
           between push events the queue can only drain, so each gap's
           reads resolve to a FIFO prefix plus a run of dummies;
        C. *batched side state* — scramble cut points (PRBS2 in bulk),
           teletext rows, 624/625 frame rows.
        """
        self._prefetch_audio(k_through)
        if k_through < self.k:
            self._materialize()
            return
        k0 = self.k
        n = k_through - k0 + 1
        nsub = 2 if self.mode_d else 1
        self._pb = k0
        self._pn = n
        self._ppos = np.zeros((n, nsub), dtype=np.int64)
        self._plen = np.zeros((n, nsub), dtype=np.int64)
        self._pfull_rows = {}
        self._ptt_rows = {}

        ks = np.arange(k0, k0 + n, dtype=np.int64)
        lines = (ks % mb.MAC_LINES + 1).astype(np.int64)
        ML = mb.MAC_LINES

        # ---- phase A: deterministic consumption / read schedule ----
        read_ks = []
        self._pruns = []       # per subframe: full-99 runs (row0, nrows)
        self._ppart = []       # per subframe: partial (line-623) rows
        for c in range(nsub):
            avail = self._slen[c] - self._spos[c]
            pos0 = self._spos[c]
            cons = np.zeros(n, dtype=np.int64)
            rl = []
            runs = []
            parts = []
            j = 0
            while j < n:
                line = int(lines[j])
                if line <= 622:
                    run = min(623 - line, n - j)
                    need = 99 * run
                    if avail < need:
                        R = -((avail - need) // mb.MAC_PACKET_BITS)
                        r = np.arange(R, dtype=np.int64)
                        rl.append(ks[j] + (avail + mb.MAC_PACKET_BITS
                                           * r) // 99)
                        avail += mb.MAC_PACKET_BITS * R
                    avail -= need
                    cons[j:j + run] = 99
                    runs.append((j, run))
                    j += run
                elif line == 623:
                    c623 = min(99, avail)
                    avail -= c623
                    cons[j] = c623
                    if c623:
                        parts.append(j)
                    j += 1
                else:
                    j += 1
            read_ks.append(np.concatenate(rl) if rl
                           else np.zeros(0, np.int64))
            self._pruns.append(runs)
            self._ppart.append(parts)
            cum = np.cumsum(cons)
            self._ppos[:, c] = pos0 + cum - cons
            self._plen[:, c] = cons
            self._spos[c] = pos0 + int(cum[-1])

        # ---- phase B: event-ordered queue replay ----
        # events: (k, phase, kind, arg); phase 0 = frame pushes (before
        # the line's reads), phase 2 = audio pushes (after them)
        events = [(int(k), 0, "f", 1 + int(k) // ML)
                  for k in ks[lines == 1]]
        lag = self.audio_lag
        j_lo, j_hi = k0 - lag, k_through - lag
        if j_hi >= 0:
            jarr = np.arange(max(j_lo, 0), j_hi + 1, dtype=np.int64)
            PT = (jarr + 1) * self.W * AUDIO_RATE // self.S
            m0 = self._audio_pairs_through_line(j_lo - 1) \
                // NICAM_AUDIO_LEN
            m1 = int(PT[-1]) // NICAM_AUDIO_LEN
            if m1 > m0:
                ms = np.arange(m0, m1, dtype=np.int64)
                jm = jarr[np.searchsorted(
                    PT, (ms + 1) * NICAM_AUDIO_LEN, side="left")]
                events += [(int(j) + lag, 2, "a", int(m))
                           for j, m in zip(jm, ms)]
        events.sort(key=lambda e: (e[0], e[1]))

        ri = [0] * nsub
        pend = []              # deferred packet encodes (batched below)
        # PRBS1 IWs are pre-drawn per inter-reset span (one bulk take
        # per frame instead of one per drain); _iw holds (array, pos)
        self._iw = [np.zeros(0, np.uint64), 0]

        def _drain(c, hi):
            """Resolve reads ri[c]..hi of subframe c: FIFO prefix, then
            dummies (no push can occur inside the gap)."""
            q = hi - ri[c]
            if q <= 0:
                return
            ri[c] = hi
            queue = self.queues[c]
            nreal = min(len(queue), q)
            st = self._stream[c]
            if c == 0:
                buf, pos = self._iw
                iws = buf[pos:pos + q]     # one update per read
                self._iw[1] = pos + q
            for t in range(nreal):
                addr, cont, payload, scr = queue.pop(0)
                if scr and c != 0:
                    # sr5 for a subframe-1 read comes from the same
                    # line's last subframe-0 read; no scrambled
                    # packet is ever queued on subframe 1 (SI/dummy
                    # only, src/mac.c:930-935)
                    raise NotImplementedError(
                        "scrambled packet on subframe 1")
                st.append(None)
                pend.append((c, len(st) - 1, addr, cont, payload, scr,
                             int(iws[t]) if c == 0 else 0))
            ndum = q - nreal
            if ndum:
                cont0 = self.dummy_continuity[c]
                self.dummy_continuity[c] += ndum
                cyc = self._dummy_cycle
                if cyc is None:
                    cyc = np.concatenate([
                        mb.encode_packet_fast(0x3FF, t, None, False, 0,
                                              native=False)
                        for t in range(4)] * 2)
                    self._dummy_cycle = cyc
                # dummies cycle with period 4; append one entry for the
                # whole run (stream entries may hold several packets)
                o = (cont0 & 3) * mb.MAC_PACKET_BITS
                if ndum <= 8 - (cont0 & 3):
                    st.append(cyc[o:o + ndum * mb.MAC_PACKET_BITS])
                else:
                    st.append(np.resize(
                        np.roll(cyc[:4 * mb.MAC_PACKET_BITS], -o),
                        ndum * mb.MAC_PACKET_BITS))
            self._slen[c] += q * mb.MAC_PACKET_BITS

        if not hasattr(self, "_cw_hist"):
            self._cw_hist = {}
        # precompute every event's drain boundary per subframe (the
        # per-event searchsorted calls dominated the event loop)
        ev_ks = np.array([e[0] for e in events], dtype=np.int64)
        ev_ph2 = np.array([e[1] == 2 for e in events])
        his = []
        for c in range(nsub):
            lo = np.searchsorted(read_ks[c], ev_ks, side="left")
            hi2 = np.searchsorted(read_ks[c], ev_ks, side="right")
            his.append(np.where(ev_ph2, hi2, lo).astype(np.int64))
        # c0 read counts per inter-reset span (resets fire at frame
        # events, after that event's drain)
        fidx = [i for i, e in enumerate(events) if e[2] == "f"]
        r_pos = [int(his[0][i]) for i in fidx] + [len(read_ks[0])]
        spans = iter(np.diff([0] + r_pos) if r_pos else [])

        if self.native:
            self._replay_native(events, his, read_ks, spans,
                                runtime.load())
        else:
            self._replay_python(events, his, read_ks, spans, ri,
                                _drain, nsub)
            # the deferred packet encodes, with the plain packet coder
            for c, si, a, ct, pl, sc, iw in pend:
                self._stream[c][si] = mb.encode_packet_fast(
                    a, ct, pl, sc, iw, native=False)

        # ---- phase C: scramble cut points, teletext, frame rows ----
        # one PRBS2 code is drawn per iteration; the entry applies to
        # line k-1 and resets happen when that line is a frame's line 1
        # (src/mac.c:1836-1864 via _iterate's prev-line handling)
        if (self.vsam & 1) == 0:
            vals = np.empty(n, dtype=np.uint16)
            resets = np.nonzero((ks >= 1) & ((ks - 1) % ML == 0))[0]
            start = 0
            for p in resets:
                p = int(p)
                if p > start:
                    vals[start:p] = self.prbs2.take(p - start)
                pf = 1 + (int(ks[p]) - 1) // ML
                self.prbs2.reset(self._cw_hist.get(pf, self.cw),
                                 pf - 1)
                start = p
            if n > start:
                vals[start:] = self.prbs2.take(n - start)
            y_valid = ((lines >= 24) & (lines <= 310)) \
                | ((lines >= 336) & (lines <= 622))
            xc1 = (282 + ((vals.astype(np.int64) & 0xFF00) >> 8)
                   ).astype(np.int32)
            xc2 = (682 + ((vals.astype(np.int64) & 0x00FF) << 1)
                   ).astype(np.int32)
            win = (k0 - 1, y_valid.astype(np.float32), xc1, xc2)
        else:
            win = (k0 - 1,
                   np.zeros(n, np.float32),
                   np.full(n, 282, np.int32),
                   np.full(n, 682, np.int32))
        self._scr_wins = ([win]
                          + getattr(self, "_scr_wins", []))[:2]

        if self.teletext is not None:
            tsel = np.nonzero(((lines >= 1) & (lines <= 22))
                              | ((lines >= 313) & (lines <= 334)))[0]
            for j in tsel:
                j = int(j)
                v = self.teletext.next_vbi_bits(
                    1 + int(ks[j]) // ML, int(lines[j]))
                if v is not None:
                    self._ptt_rows[j] = (int(lines[j]), v)

        sel = np.nonzero(lines >= 624)[0]
        j625 = [int(j) for j in sel if int(lines[j]) == 625]
        if j625:
            rows = self._lines_625_batch(
                1 + ks[np.asarray(j625)] // ML)
            for i, j in enumerate(j625):
                self._pfull_rows[j] = rows[i]
        for j in sel:
            j = int(j)
            if int(lines[j]) == 624:
                self._pfull_rows[j] = self._line_624(
                    1 + int(ks[j]) // ML, 624)

        self.k = k_through + 1
        self._materialize()

    def _materialize(self):
        """Batch-assemble the bit rows of all newly simulated lines
        directly in PACKED form: static heads + sequential packet-stream
        slices XOR the per-line PRBS whitening (src/mac.c:1375-1439),
        teletext overlays, and the running duobinary start polarity.

        A regular line's content is only the x0 + 99*nsub (+spare)
        data-burst bits — 206 of 1296 for D-MAC — so only that prefix
        is assembled and packed; the wide rows (624/625 frame rows,
        teletext overlays into the vision region) are packed
        individually.  line_bits stays available as a lazy unpacking
        view for the parity tests."""
        n = self._pn
        if n <= 0:
            return
        base = self._pb
        nsub = 2 if self.mode_d else 1
        x0 = 7 if self.mode_d else 6
        nbytes = self.nbits // 8
        sb = x0 + 99 * nsub + (1 if self.mode_d else 0)
        sbb = (sb + 7) // 8

        kk = base + np.arange(n, dtype=np.int64)
        frames = 1 + kk // mb.MAC_LINES
        dlines = kk % mb.MAC_LINES + 1
        hs = ((frames + dlines) & 1) ^ (dlines == 623)

        if self.device_mode and self._packed_stream:
            # record the window's read schedule (row lens are <= 99;
            # positions are contiguous so the device recovers them by
            # cumsum from the window-start positions) and the packed
            # frame rows, then only compact the stream buffers
            nsub_w = self._plen.shape[1]
            plen = np.zeros((n, 2), np.uint8)
            plen[:, :nsub_w] = self._plen
            self._sched_wins = ([(base, plen,
                                  self._ppos[0, :].copy())]
                                + self._sched_wins)[:2]
            for i, payload in self._pfull_rows.items():
                self._full_abs[base + i] = np.packbits(
                    payload, bitorder="little")
            self._pn = 0
            # consumed bits stay alive until their rows leave the
            # retained schedule windows (device_bits_block re-slices
            # them); drop only below the oldest window, with a small
            # margin for the upload's leading boundary rows
            oldest = min(self._sched_wins, key=lambda w: w[0])[2]
            for c in range(nsub):
                keep = int(oldest[c]) - 8 * 16 if c < len(oldest) \
                    else self._spos[c]
                drop = (keep - self._sbase[c]) >> 3
                if drop >= 4096:
                    buf = self._pbuf[c]
                    used = min(len(buf),
                               (self._slen[c] - self._sbase[c]
                                + 7 >> 3) + 16)
                    tail = buf[drop:used].copy()
                    nb = np.zeros(len(buf), np.uint8)
                    nb[:len(tail)] = tail
                    self._pbuf[c] = nb
                    self._sbase[c] += drop << 3
            return
        native = self.native and self._packed_stream
        ones = None
        if native:
            lib = runtime.load()
            if not hasattr(self, "_base_tbl"):
                # packed (sync word + whitening) prefix for every
                # (sync polarity, line) pair; the per-window rows are a
                # gather from this table, stream XOR happens in native
                B = np.zeros((2, mb.MAC_LINES, sbb * 8), dtype=np.uint8)
                if self.mode_d:
                    B[:, :, 0] = 1
                    B[:, :, x0 + 99 * nsub] = 1
                B[0, :, x0 - 6:x0] = self._hs[0]
                B[1, :, x0 - 6:x0] = self._hs[1]
                B[:, :, x0:x0 + 99 * nsub] = \
                    self._wh_all[None, :, :99 * nsub]
                self._base_tbl = np.ascontiguousarray(
                    np.packbits(B, axis=2, bitorder="little"))
                self._seg_offs = np.array(
                    [x0, x0 + 99], dtype=np.int64)
            streams, pos, lens = [], [], []
            for c in range(nsub):
                streams.append(self._pbuf[c])
                pos.append(np.ascontiguousarray(
                    self._ppos[:, c] - self._sbase[c]))
                lens.append(np.ascontiguousarray(self._plen[:, c]))
            if nsub == 1:
                streams.append(self._pbuf[1])
                pos.append(np.zeros(n, np.int64))
                lens.append(np.zeros(n, np.int64))
            base_rows = np.ascontiguousarray(
                self._base_tbl[hs.astype(np.int64), dlines - 1])
            packed = np.zeros((n, nbytes), dtype=np.uint8)
            ones = np.zeros(n, dtype=np.int64)
            lib.rt_mac_materialize_packed(
                n, nbytes, sbb, base_rows.ctypes.data,
                self._seg_offs.ctypes.data, nsub,
                streams[0].ctypes.data, pos[0].ctypes.data,
                lens[0].ctypes.data, streams[1].ctypes.data,
                pos[1].ctypes.data, lens[1].ctypes.data,
                packed.ctypes.data, ones.ctypes.data, 2)
            S = None
        else:
            S = np.zeros((n, sbb * 8), dtype=np.uint8)
            if self.mode_d:
                S[:, 0] = 1
                S[:, x0 + 99 * nsub] = 1              # spare bit
            S[:, x0 - 6:x0] = self._hs[hs]
            # the consumed stream range is CONTIGUOUS and lines
            # partition it sequentially, so the body is whitening XOR
            # reshaped slices of the concatenated packet stream (no
            # per-bit gather)
            for c in range(nsub):
                seg = S[:, x0 + 99 * c:x0 + 99 * (c + 1)]
                seg[:] = self._wh_all[dlines - 1, 99 * c:99 * (c + 1)]
                stream = (np.concatenate(self._stream[c])
                          if self._stream[c] else np.zeros(0, np.uint8))
                sbase = self._sbase[c]
                for j0, nrows in self._pruns[c]:
                    a = int(self._ppos[j0, c]) - sbase
                    seg[j0:j0 + nrows] ^= \
                        stream[a:a + 99 * nrows].reshape(nrows, 99)
                for j in self._ppart[c]:
                    a = int(self._ppos[j, c]) - sbase
                    ln = int(self._plen[j, c])
                    seg[j, :ln] ^= stream[a:a + ln]
            packed = np.zeros((n, nbytes), dtype=np.uint8)
            packed[:, :sbb] = np.packbits(S, axis=1, bitorder="little")

        # wide rows: teletext overlays + 624/625 frame rows
        tt = self._ptt_rows
        if tt:
            rows = sorted(tt)
            F = np.zeros((len(rows), self.nbits), dtype=np.uint8)
            F[:, :sbb * 8] = (np.unpackbits(
                packed[rows, :sbb], axis=1, bitorder="little")
                if S is None else S[rows])
            for t, i in enumerate(rows):
                line, v = tt[i]
                if not self.mode_d:
                    F[t, 116:116 + 360] = v
                else:
                    pr = self.prbs15.seq(int(self.seeds[line - 1]),
                                         360 + 344)
                    F[t, 230:230 + 720:2] = v
                    F[t, 231:230 + 720:2] = pr[:360]
                    F[t, 950:950 + 344] = pr[360:]
            packed[rows] = np.packbits(F, axis=1, bitorder="little")
        for i, payload in self._pfull_rows.items():
            packed[i] = np.packbits(payload, bitorder="little")

        # running start polarity (flips on every 0 bit, src/mac.c:193):
        # a line flips the carry iff its zero-bit count is odd; counted
        # on the packed bytes (nbits is byte-aligned, so no pad bits)
        if ones is not None:
            ov = sorted(set(tt) | set(self._pfull_rows))
            if ov:
                ones[ov] = np.bitwise_count(packed[ov]) \
                    .sum(axis=1, dtype=np.int64)
        else:
            ones = np.bitwise_count(packed).sum(axis=1, dtype=np.int64)
        sign = np.where((self.nbits - ones) & 1, -1, 1)
        pol = self.polarity * np.concatenate(
            [[1], np.cumprod(sign)])
        self.polarity = int(pol[-1])
        # keep the two most recent packed windows: bits_block requests
        # span one window plus a couple of rows from the previous one
        self._packed_wins = ([(base, packed,
                               pol[:-1].astype(np.int8))]
                             + getattr(self, "_packed_wins", []))[:2]
        self._pn = 0
        if self._packed_stream:
            # compact the packed buffers: drop consumed whole bytes once
            # the dead prefix passes 4 KB (the unconsumed tail is tiny)
            for c in range(nsub):
                drop = (self._spos[c] - self._sbase[c]) >> 3
                if drop >= 4096:
                    buf = self._pbuf[c]
                    used = min(len(buf),
                               (self._slen[c] - self._sbase[c]
                                + 7 >> 3) + 16)
                    tail = buf[drop:used].copy()
                    nb = np.zeros(len(buf), np.uint8)
                    nb[:len(tail)] = tail
                    self._pbuf[c] = nb
                    self._sbase[c] += drop << 3
        else:
            # drop fully consumed stream chunks (entries may hold
            # several packets — dummy runs are appended as one array)
            for c in range(nsub):
                st = self._stream[c]
                k = 0
                off = self._sbase[c]
                while k < len(st) and off + len(st[k]) <= self._spos[c]:
                    off += len(st[k])
                    k += 1
                if k:
                    self._sbase[c] = off
                    del st[:k]      # one O(n) shift, not k pop(0)s

    def bits_block(self, k_lo: int, k_hi: int):
        """Packed line bits + start polarity for stream lines
        [k_lo, k_hi); missing lines are zero rows (their symbols expand
        to zero regardless of polarity).  The duobinary symbol
        expansion itself runs on device (mac_symbols)."""
        n = k_hi - k_lo
        packed = np.zeros((n, (self.nbits + 7) // 8), dtype=np.uint8)
        pol0 = np.zeros(n, dtype=np.int8)
        # fast path: slice the cached packed windows
        covered = np.zeros(n, dtype=bool)
        for base, pk, pl in getattr(self, "_packed_wins", ()):
            lo = max(k_lo, base)
            hi = min(k_hi, base + len(pk))
            if lo >= hi:
                continue
            sel = slice(lo - k_lo, hi - k_lo)
            packed[sel] = pk[lo - base:hi - base]
            pol0[sel] = pl[lo - base:hi - base]
            covered[sel] = True
        rows = [int(j) for j in np.nonzero(~covered)[0]
                if self.line_bits.get(k_lo + int(j)) is not None]
        if rows:
            bits = np.stack([self.line_bits[k_lo + j] for j in rows])
            packed[rows] = np.packbits(bits, axis=1, bitorder="little")
            pol0[rows] = [self.pol_start[k_lo + j] for j in rows]
        return packed, pol0

    def device_bits_block(self, k_lo: int, k_hi: int):
        """Upload bundle for on-device line-bit assembly (device_mode):
        per-row consumed-bit lengths, the packed packet-stream slices
        they index (positions recovered by cumsum from p0), and the
        packed 624/625 frame rows.  Replaces the 1.6 MB/block packed
        line upload with ~150 KB of stream bytes."""
        n = k_hi - k_lo
        nsub = 2 if self.mode_d else 1
        lens = np.zeros((n, 2), np.uint8)
        p0_abs = [None] * nsub
        for base, plen, pos0 in sorted(self._sched_wins,
                                       key=lambda w: w[0]):
            lo = max(k_lo, base)
            hi = min(k_hi, base + len(plen))
            if lo >= hi:
                continue
            lens[lo - k_lo:hi - k_lo] = plen[lo - base:hi - base]
            for c in range(min(nsub, len(pos0))):
                if p0_abs[c] is None:
                    # abs position of row k_lo's data: rows before the
                    # first covering window consumed nothing
                    p0_abs[c] = int(pos0[c]) + int(
                        plen[:lo - base, c].astype(np.int64).sum())
        streams, p0_rel = [], []
        for c in range(nsub):
            pa = p0_abs[c] if p0_abs[c] is not None else self._sbase[c]
            total = int(lens[:, c].astype(np.int64).sum())
            rel = pa - self._sbase[c]
            assert rel >= 0, "stream slice already compacted away"
            b0 = rel >> 3
            b1 = min(len(self._pbuf[c]), ((rel + total + 7) >> 3) + 8)
            streams.append(self._pbuf[c][b0:b1])
            p0_rel.append(rel - (b0 << 3))
        fks = sorted(k for k in self._full_abs
                     if k_lo <= k < k_hi)
        fr = (np.stack([self._full_abs[k] for k in fks])
              if fks else np.zeros((0, self.nbits // 8), np.uint8))
        fr_idx = np.asarray([k - k_lo for k in fks], np.int32)
        return dict(streams=streams, p0=p0_rel, lens=lens,
                    full_rows=fr, full_idx=fr_idx)

    def scramble_block(self, k_lo: int, k_hi: int):
        """(apply f32, xc1 i32, xc2 i32) arrays for stream lines
        [k_lo, k_hi), from the cached per-window arrays; lines outside
        the cache default to the no-scramble tuple."""
        n = k_hi - k_lo
        ap = np.zeros(n, np.float32)
        x1 = np.full(n, 282, np.int32)
        x2 = np.full(n, 682, np.int32)
        for base, a, b, c in getattr(self, "_scr_wins", ()):
            lo = max(k_lo, base)
            hi = min(k_hi, base + len(a))
            if lo >= hi:
                continue
            sel = slice(lo - k_lo, hi - k_lo)
            ap[sel] = a[lo - base:hi - base]
            x1[sel] = b[lo - base:hi - base]
            x2[sel] = c[lo - base:hi - base]
        return ap, x1, x2

    def prune(self, below_k: int):
        for key in [x for x in self.scramble if x < below_k]:
            del self.scramble[key]
        for key in [x for x in self._full_abs if x < below_k]:
            del self._full_abs[key]


# ----------------------------------------------------------------------
# Encoder

def duobinary_products(bases, sym: torch.Tensor):
    """The three duobinary basis products for the block's rows, from the
    f64 symbols [nrows + 2, nbits] of those rows and one row each side:
    (own bits + the previous line's forward spill, the next line's
    backward spill), each f32 [nrows, W] and exact.  `bases`: the f64
    (Bm, B0, Bp)."""
    nrows = sym.shape[0] - 2
    Bm, B0, Bp = bases
    duo = sym[1:nrows + 1] @ B0 + sym[0:nrows] @ Bp
    return duo.float(), (sym[2:nrows + 2] @ Bm).float()


class MacEncoder:
    """Block encoder for D/D2-MAC modes with the same device API as
    `Encoder` (encode_block_device / collect_block); blocks must be
    encoded sequentially (the packet multiplex is a stream).

    `native=False` runs the multiplex's plain Python versions (MacMux)
    and the host-bits step; the default runs the native runtime, which
    raises if it does not load.  `device` as for `Encoder`."""

    @staticmethod
    def active_geometry(conf, sample_rate: int, pixel_rate: int = 0
                        ) -> tuple[int, int]:
        """(active_width, active_lines) for source fitting, without
        constructing an encoder (src/video.c:3843-3853 geometry)."""
        P = int(pixel_rate) or int(sample_rate)
        line_dur = conf.frame_rate.den / (conf.frame_rate.num * conf.lines)
        W = round(P * line_dur)
        aw = min(math.ceil(P * conf.active_width), W) & ~1
        return aw, conf.active_lines

    @telemetry.spanned("setup.encoder")
    def __init__(self, mode: str | VidConfig, sample_rate: int,
                 pixel_rate: int = 0, source=None,
                 frames_per_block: int = 1,
                 scramble_video: int = 0, scramble_audio: bool = False,
                 eurocrypt=None, timestamp: int = 1_200_000_000,
                 teletext: str | None = None, teletext_clock=None,
                 devices=None, pipeline_mux: bool = False,
                 device="cuda", native: bool = True):
        if devices is not None:
            # the first shard's device holds the host state's tensors
            devices = shard.resolve_devices(devices)
            device = devices[0]
        self.device = transfer.resolve_device(device)
        conf = get_mode(mode) if isinstance(mode, str) else mode
        if conf.mac_mode is None:
            raise ValueError("MacEncoder takes a D/D2-MAC mode; use "
                             "Encoder (or create_encoder) for the others")
        self.conf = conf
        self.S = int(sample_rate)
        self.P = int(pixel_rate) or self.S
        self.frames_per_block = frames_per_block
        # line-axis sharding over `devices` (shard.py): the multiplex
        # and the line-bit assembly run once per block (per device), the
        # raster per shard
        self._plan = None
        if devices is not None and len(devices) > 1:
            self._plan = shard.ShardPlan.create(
                devices, frames_per_block * mb.MAC_LINES)
        self._replicas: dict = {}
        self._moved: dict = {}
        self.shard_timing = False
        self.shard_events: list = []

        line_dur = conf.frame_rate.den / (conf.frame_rate.num * conf.lines)
        self.width = W = round(self.P * line_dur)
        # levels (src/video.c:3855-3881)
        slevel = 1.0 if conf.modulation == Modulation.FM else conf.level
        self.level = conf.video_level * slevel
        q = lambda l: int(round(l * self.level * INT16_MAX))
        self.white_level = q(conf.white_level)
        self.black_level = q(conf.black_level)
        self.blanking_level = q(conf.blanking_level)

        self.active_left = round(self.P * conf.active_left)
        aw = min(math.ceil(self.P * conf.active_width), W)
        self.active_width = aw & ~1   # (src/mac.c:963)
        self.chrominance_width = self.active_width // 2
        r = lambda x: round(self.P * (x / MAC_CLOCK_RATE))
        self.chrominance_left = r(233.0)
        self.white_ref_left = r(371.0)
        self.black_ref_left = r(533.0)
        self.black_ref_right = r(695.0)
        self.video_scale = _lround(np.arange(mb.MAC_WIDTH) * W /
                                   mb.MAC_WIDTH).astype(np.int32)

        if source is None:
            from ..av.testcard import TestCardSource
            source = TestCardSource(self.active_width, conf.active_lines)
        self.source = source
        self.vframe_x = (self.active_width - source.width) // 2
        self.vframe_y = (conf.active_lines - source.height) // 2

        # VSAM (src/mac.c:889-918); Eurocrypt without an explicit cut
        # mode defaults to single-cut (src/hacktv.c:1332-1336)
        if eurocrypt is not None and scramble_video == 0:
            scramble_video = 1
        vsam = 4 if eurocrypt is not None else 0
        vsam |= {0: 1, 1: 2, 2: 0}[scramble_video]
        self.vsam = vsam

        # aspect ratio threshold (src/mac.c:893-897): PAR 1:1 test card
        thr = Fraction(14, 9) / Fraction(self.active_width,
                                         conf.active_lines)
        par = getattr(source, "pixel_aspect_ratio", Fraction(1, 1))
        self.aspect_43 = 1 if par <= thr else 0

        tt = None
        if teletext:
            from ..services.teletext import MacTeletext
            tt = MacTeletext(teletext, conf.lines,
                             round(float(conf.frame_rate)),
                             clock=teletext_clock)

        # pixel-rate -> sample-rate rational resample of the synthesized
        # stream (src/video.c:3627-3651 registers the vresampler between
        # the MAC raster and the FM modulator)
        self.resampler = None
        self.out_width = W
        if self.P != self.S:
            self.out_width = round(self.S * line_dur)
            rs = resampler.Resampler.create(self.S, self.P)
            self.resampler = resampler.make_block_statics(
                rs, W, self.out_width,
                frames_per_block * mb.MAC_LINES, halo_lines=1)
            if self._plan is not None:
                # as Encoder's: an inner shard resamples a line further
                ns = self._plan.lines_per_shard
                self._rs_shard = tuple(resampler.make_block_statics(
                    rs, W, self.out_width, ns, halo_lines=h)
                    for h in (1, 2))
        if self._plan is not None:
            # the raster's rows: the block's lines and, with the
            # resampler, a halo line each side
            halo = 1 if self.resampler is not None else 0
            self._windows = self._plan.windows(
                frames_per_block * mb.MAC_LINES + 2 * halo, 3 * halo, 0)

        # the audio lineprocess runs on *output* lines (post-resampler,
        # src/video.c:3273-3277), so pair timing uses the output width
        self.mux = MacMux(conf, self.out_width, self.S, source, vsam,
                          scramble_audio=scramble_audio,
                          timestamp=timestamp,
                          aspect_43=self.aspect_43, eurocrypt=eurocrypt,
                          volume=conf.volume, teletext=tt, native=native)
        if self.resampler is not None:
            # the vresampler's 2-line window shifts every later process
            # (incl. audio) two lines back (src/video.c:4675-4688)
            self.mux.audio_lag = 3

        duo_level = (self.white_level - self.black_level) * 0.4
        self.Bm, self.B0, self.Bp = duobinary_bases(
            conf.mac_mode == MacMode.D, W, duo_level)

        # black padding level: the LUT value of RGB 0 (not 0)
        yb, _, _ = mac_yuv_host(conf, np.zeros((1, 1, 3), np.uint8),
                                self.level)
        self.y_black = float(yb[0, 0])
        # per-frame source planes are uploaded in _device_planes (the
        # reference renders the *current* frame every line,
        # src/mac.c:1758-1834 + frame advance src/video.c:4873-4903)
        self._plane_cache = None
        self._plane_shape = None

        self.complex_out = conf.output_type == OutputType.COMPLEX
        self.fm_video_statics = None
        if conf.modulation == Modulation.FM:
            self.fm_video_statics = rf_ops.make_fm_video_statics(
                conf.fm_deviation, conf.fm_level * conf.level,
                self.S, conf.lines)
            self._fm_r = {0: torch.zeros((), dtype=torch.int64,
                                         device=self.device)}

        self._meta = None
        # device materialisation: assemble the line bits on the device
        # from the packet stream (device_bits_block) instead of uploading
        # host-assembled packed rows every block.  The host-bits step
        # stays for teletext (vision-region overlays) and for the plain
        # Python multiplex (native=False).
        self.device_mat = tt is None and self.mux.native
        n_l = frames_per_block * mb.MAC_LINES
        halo = 1 if self.resampler is not None else 0
        nrows2 = n_l + 2 + 2 * halo
        self._base_bits = None
        if self.device_mat:
            # device_mode flips on at the first encode_block_device
            # call: the host bits_block/line_bits APIs (parity oracles)
            # stay usable on a mux that is only driven directly
            nsub = 2 if self.mux.mode_d else 1
            x0 = 7 if self.mux.mode_d else 6
            nbits = self.mux.nbits
            B = np.zeros((2, mb.MAC_LINES, nbits), np.int8)
            if self.mux.mode_d:
                B[:, :, 0] = 1
                B[:, :, x0 + 99 * nsub] = 1
            B[0, :, x0 - 6:x0] = self.mux._hs[0]
            B[1, :, x0 - 6:x0] = self.mux._hs[1]
            B[:, :, x0:x0 + 99 * nsub] = \
                self.mux._wh_all[None, :, :99 * nsub]
            self._base_bits = B.reshape(2 * mb.MAC_LINES, nbits)
            self._scap = (99 * nrows2) // 8 + 24
            self._fcap = 2 * (frames_per_block + 2)
            self._pol_c = {0: torch.tensor(self.mux.polarity,
                                           dtype=torch.int32,
                                           device=self.device)}
            # everything the block needs travels in ONE uint8 buffer:
            # static byte offsets, the int32 and f32 fields 4-byte
            # aligned for their device views
            nwin = n_l + 2 * halo
            o = 0
            lay = {}

            def put(name, nbytes_, align=1):
                nonlocal o
                o = (o + align - 1) // align * align
                lay[name] = o
                o += nbytes_
            put("s0", self._scap)
            put("s1", self._scap if (self.mux.mode_d) else 1)
            put("lens", nrows2 * 2)
            put("fr", self._fcap * (nbits // 8))
            put("fidx", self._fcap * 4, 4)
            put("scr", nwin * 4, 4)
            put("xc1", nwin * 4, 4)
            put("xc2", nwin * 4, 4)
            put("ints", 4 * 4, 4)     # p00, p01, k0p, first
            lay["total"] = (o + 3) // 4 * 4
            self._lay = lay
            self._nwin = nwin
        self.upload()
        self._device_planes(0)

        # opt-in one-block-ahead mux pipelining: the worker thread owns
        # the mux; native calls release the GIL, overlapping the main
        # thread's uploads and dispatch
        self.pipeline_mux = bool(pipeline_mux)
        self._pipe = None
        self._pipe_pool = None
        if self.pipeline_mux:
            from concurrent.futures import ThreadPoolExecutor
            self._pipe_pool = ThreadPoolExecutor(max_workers=1)
        self._next_block = 0

    def upload(self):
        """The bases (f64), the base bit rows and the video scale on the
        device."""
        dev = self.device
        self.d_bases = tuple(torch.as_tensor(B, dtype=torch.float64,
                                             device=dev)
                             for B in (self.Bm, self.B0, self.Bp))
        self.d_base_bits = (None if self._base_bits is None else
                            torch.as_tensor(self._base_bits, device=dev))
        self.d_video_scale = torch.as_tensor(
            self.video_scale.astype(np.int64), device=dev)

    # ------------------------------------------------------------------
    def _device_planes(self, frame_no: int):
        """Upload the source frame's luma/chroma planes, once per
        distinct frame object (test card reads return the same array)."""
        rgb = self.source.read_video(frame_no)
        if self._plane_cache is not None and self._plane_cache[0] is rgb:
            return self._plane_cache[1]
        y, u, v = mac_yuv_host(self.conf, rgb, self.level)
        pad_y = np.full((1, y.shape[1]), self.y_black, dtype=np.float32)
        y_img = np.concatenate([y.astype(np.float32), pad_y])
        u2 = u[:, ::2].astype(np.float32)
        v2 = v[:, ::2].astype(np.float32)
        zpad = np.zeros((1, u2.shape[1]), dtype=np.float32)
        u_img = np.concatenate([u2, zpad])
        v_img = np.concatenate([v2, zpad])
        shape = (y_img.shape, u_img.shape)
        if self._plane_shape is None:
            self._plane_shape = shape
        elif shape != self._plane_shape:
            raise ValueError("source frame size changed mid-stream")
        dev = tuple(transfer.upload(a, self.device)
                    for a in (y_img, u_img, v_img))
        self._plane_cache = (rgb, dev)
        return dev

    # ------------------------------------------------------------------
    def _line_meta(self):
        """Per-line (line-number periodic) metadata for one block."""
        if self._meta is not None:
            return self._meta
        n = self.frames_per_block * mb.MAC_LINES
        # with the pixel->sample resampler the step synthesizes one halo
        # row each side of the block (rows j = -1 .. n)
        halo = 1 if self.resampler is not None else 0
        conf = self.conf
        H = conf.active_lines
        lines = np.arange(-halo, n + halo) % mb.MAC_LINES + 1

        def luma_y(l):
            if 24 <= l <= 310:
                y = (l - 24) * 2 + 2
            elif 336 <= l <= 622:
                y = (l - 336) * 2 + 1
            else:
                return -1
            if conf.interlaced and \
                    getattr(self.source, "interlaced", 0) == 2:
                y += 1
            return y if 0 <= y < H else -1

        ys = np.array([luma_y(int(l)) for l in lines], dtype=np.int64)
        vy = ys - self.vframe_y
        vy[(vy < 0) | (vy >= self.source.height) | (ys < 0)] = -1
        # vy of the NEXT line (chroma transmitted one line early)
        l_next = np.arange(-halo + 1, n + halo + 1) % mb.MAC_LINES + 1
        ys_n = np.array([luma_y(int(l)) for l in l_next], dtype=np.int64)
        vy_n = ys_n - self.vframe_y
        vy_n[(vy_n < 0) | (vy_n >= self.source.height) | (ys_n < 0)] = -1

        t = lambda a: torch.as_tensor(a, device=self.device)
        meta = dict(
            vy=t(np.where(vy < 0, self.source.height, vy)),
            # the luma overwrite happens whenever the LINE is in luma
            # range (out-of-frame rows render black, src/mac.c:1781-1813)
            luma_mask=t(ys >= 0),
            vy_next=t(np.where(vy_n < 0, self.source.height, vy_n)),
            vy_next_valid=t((vy_n >= 0).astype(np.float32)),
            chroma_u=t(lines % 2 == 1),
            black_ref=t(np.isin(lines, (23, 335))),
            refs_624=t(lines == 624),
        )
        self._meta = meta
        return meta

    # ------------------------------------------------------------------
    def _step_impl(self, packed, pol0, planes, meta, scr_apply, xc1,
                   xc2, fm_r0, first):
        """The host-bits step: packed line bits and start polarities
        from MacMux.bits_block."""
        bits = device_unpack_bits(packed, self.mux.nbits, torch.int32)
        p0 = pol0.to(torch.int32)[:, None]
        return self._synth(bits, p0, planes, meta, scr_apply, xc1,
                           xc2, fm_r0, first)

    def _step_impl_dev(self, buf, pol_c, planes, meta, fm_r0):
        """The device-bits step: the line bits assembled on the device
        (`_bits_dev`), then the raster.  Returns (samples, the FM carry
        or None, the polarity carry)."""
        bits, p0, scr_apply, xc1, xc2, first, carry = self._bits_dev(
            buf, pol_c)
        out, fm_carry = self._synth(bits, p0, planes, meta, scr_apply, xc1,
                                    xc2, fm_r0, first)
        return out, fm_carry, carry

    def _bits_dev(self, buf, pol_c):
        """Device-side line-bit assembly (mux.device_mode): gather the
        static (sync + whitening) base row per line, XOR the consumed
        packet-stream slices in at the data-burst columns
        (src/mac.c:1375-1439), overwrite the packed 624/625 frame rows,
        and run the duobinary start-polarity scan with a cross-block
        carry (src/mac.c:193-203).  All per-block host data arrives in
        the single packed uint8 buffer laid out by self._lay.  Returns
        (the line bits, their start polarities [rows, 1], scr_apply, xc1,
        xc2, first, the polarity carry)."""
        nbits = self.mux.nbits
        nsub = 2 if self.mux.mode_d else 1
        x0 = 7 if self.mux.mode_d else 6
        lay = self._lay
        n_l = self.frames_per_block * mb.MAC_LINES
        halo = 1 if self.resampler is not None else 0
        nrows2 = n_l + 2 + 2 * halo
        nwin = self._nwin
        dev = buf.device

        def field(name, count, dtype=torch.uint8):
            a = lay[name]
            size = torch.empty(0, dtype=dtype).element_size()
            return buf[a:a + size * count].view(dtype)

        stream0 = field("s0", self._scap)
        stream1 = field("s1", self._scap if self.mux.mode_d else 1)
        lens = field("lens", nrows2 * 2).reshape(nrows2, 2)
        full_rows = field("fr", self._fcap * (nbits // 8)).reshape(
            self._fcap, nbits // 8)
        full_idx = field("fidx", self._fcap, torch.int32)
        scr_apply = field("scr", nwin, torch.float32)
        xc1 = field("xc1", nwin, torch.int32)
        xc2 = field("xc2", nwin, torch.int32)
        ints = field("ints", 4, torch.int32).to(torch.int64)
        p00, p01, k0p = ints[0], ints[1], ints[2]
        first = ints[3].to(torch.float32)
        rows = k0p + torch.arange(nrows2, dtype=torch.int64, device=dev)
        valid = rows >= 0
        rr = torch.where(valid, rows, 0)
        line0 = rr % mb.MAC_LINES              # line-1
        frame = rr // mb.MAC_LINES + 1
        hsp = ((frame + line0 + 1) & 1) ^ (line0 == 622).to(torch.int64)
        base = self.d_base_bits[hsp * mb.MAC_LINES + line0]
        bits = base.to(torch.int32) * valid[:, None].to(torch.int32)

        co = torch.arange(99, dtype=torch.int64, device=dev)[None, :]
        for c, (sbytes, p0c) in enumerate(
                ((stream0, p00), (stream1, p01))[:nsub]):
            sb = device_unpack_bits(sbytes[None], 8 * sbytes.shape[0],
                                    torch.int32)[0]
            lc = lens[:, c].to(torch.int64)
            pos = p0c + torch.cumsum(lc, 0) - lc
            idx = pos[:, None] + co
            d = sb[idx.clamp(0, sb.shape[0] - 1)] * (co < lc[:, None])
            bits[:, x0 + 99 * c:x0 + 99 * (c + 1)] ^= d

        # the packed 624/625 frame rows; unused slots index row nrows2,
        # one past the block, which is dropped
        frb = device_unpack_bits(full_rows, nbits, torch.int32)
        ext = torch.cat([bits, bits.new_zeros(1, nbits)])
        ext.index_copy_(0, full_idx.to(torch.int64), frb)
        bits = ext[:nrows2]

        ones = bits.sum(1, dtype=torch.int64)
        neg = (nbits - ones) & 1
        cum_ex = torch.cumsum(neg, 0) - neg
        polrow = pol_c * (1 - 2 * (cum_ex & 1))
        n = self.frames_per_block * mb.MAC_LINES
        # next block's first row is this upload's row n; cum_ex[n] is
        # the inclusive flip count of rows 0..n-1
        carry = (pol_c * (1 - 2 * (cum_ex[n] & 1))).to(torch.int32)
        return bits, polrow[:, None], scr_apply, xc1, xc2, first, carry

    def symbols(self, bits, p0):
        """Duobinary symbols f64 [rows, nbits]: the polarity flips on
        every 0 bit (src/mac.c:193-203) from the row's start polarity
        p0 [rows, 1]; a 1 bit sends the polarity, a 0 bit nothing."""
        zeros = 1 - bits
        flips = torch.cumsum(zeros, 1)
        pol_before = torch.where(((flips - zeros) & 1).bool(), -p0, p0)
        return (bits * pol_before).to(torch.float64)

    def products(self, sym):
        """duobinary_products with this encoder's bases."""
        return duobinary_products(self.d_bases, sym)

    def cut(self, canvas, scr_apply, xc1, xc2):
        """The single or double cut-and-rotate (src/mac.c:1604-1620,
        1836-1864) as a gather over the modular index, on the lines
        whose scr_apply is set."""
        if self.vsam & 1:
            return canvas
        W = canvas.shape[1]
        x = torch.arange(W, device=canvas.device)
        sc = self.video_scale
        if (self.vsam & 2) == 0:
            segs = [(229, 580, xc1), (586, 1285, xc2)]
        else:
            segs = [(230, 1285, xc1)]
        for x1, x2, xc in segs:
            s1 = int(sc[x1])
            s2 = int(sc[x2])
            w1 = int(sc[x1 - 2])
            w2 = int(sc[x2 + 2])
            span = s2 - s1 + 1
            xc0 = self.d_video_scale[xc.to(torch.int64) - 2]
            idx = s1 + (xc0[:, None] - s1 + x[None, :] - w1) % span
            gathered = torch.gather(canvas, 1, idx)
            seg = (x >= w1) & (x <= w2)
            canvas = torch.where(seg[None, :] & (scr_apply[:, None] > 0),
                                 gathered, canvas)
        return canvas

    def _synth(self, bits, p0, planes, meta, scr_apply, xc1, xc2,
               fm_r0, first, win: shard.Window | None = None):
        """Line bits -> samples; returns (samples, the FM carry or
        None).  With `win`, one shard's lines [win.a, win.b) of the
        block's: its rows [win.r0, win.r1) with the resampler's halo (an
        inner shard's one row more, as Encoder's), and the bits' row
        each side."""
        y_img, u_img, v_img = planes
        n = self.frames_per_block * mb.MAC_LINES
        W = self.width
        rs = self.resampler
        c0 = 0
        if win is not None and not win.whole:
            c0, c1 = win.r0, win.r1
            bits, p0 = bits[c0:c1 + 2], p0[c0:c1 + 2]
            meta = {k: v[c0:c1] for k, v in meta.items()}
            scr_apply, xc1, xc2 = (t[c0:c1] for t in (scr_apply, xc1, xc2))
            n = win.nlines
            if rs is not None:
                rs = self._rs_shard[0 if win.last else 1]
        sym = self.symbols(bits, p0)
        # duobinary laid down before this line's overwrites: own bits +
        # the previous line's forward spill.  The NEXT line's backward
        # spill (Bm) is rendered one call later in the reference
        # (src/mac.c:227-232), i.e. after this line's luma/reference
        # overwrites — added below, post-overwrite.
        duo, spill = self.products(sym)
        canvas = torch.clamp(duo + float(self.blanking_level),
                             -32768, 32767)

        al, aw = self.active_left, self.active_width
        # luma rows (vy==height row is the black-pad row)
        lum = y_img[meta["vy"]]
        if self.vframe_x > 0 or lum.shape[1] < aw:
            pad_l = self.vframe_x
            pad_r = aw - pad_l - lum.shape[1]
            lum = torch.nn.functional.pad(lum, (pad_l, pad_r),
                                          value=self.y_black)
        act = canvas[:, al:al + aw]
        act = torch.where(meta["luma_mask"][:, None], lum, act)
        act = torch.where(meta["black_ref"][:, None],
                          float(self.black_level), act)
        canvas[:, al:al + aw] = act

        # line 624 reference areas
        x = torch.arange(W, device=canvas.device)
        white_cols = ((x >= self.white_ref_left) &
                      (x < self.black_ref_left))
        black_cols = ((x >= self.black_ref_left) &
                      (x < self.black_ref_right))
        m624 = meta["refs_624"][:, None]
        canvas = torch.where(m624 & white_cols[None, :],
                             float(self.white_level), canvas)
        canvas = torch.where(m624 & black_cols[None, :],
                             float(self.black_level), canvas)

        # the next line's backward duobinary spill, post-overwrite
        canvas = canvas + spill

        # chrominance, one line ahead of its luma (src/mac.c:1815-1834)
        vyn = meta["vy_next"]
        crow = torch.where(meta["chroma_u"][:, None], u_img[vyn],
                           v_img[vyn])
        crow = crow * meta["vy_next_valid"][:, None]
        cl, cw = self.chrominance_left, int(u_img.shape[1])
        cx0 = self.vframe_x // 2
        canvas[:, cl + cx0:cl + cx0 + cw] += crow

        # vision scrambling rotations (src/mac.c:1604-1620, 1836-1864)
        canvas = self.cut(canvas, scr_apply, xc1, xc2)

        if rs is not None:
            # pixel -> sample rate polyphase resample (block 0's leading
            # halo row is zeroed: the reference's FIR window starts
            # zero-filled, src/fir.c:263-313)
            if c0 == 0:
                canvas[0] *= first
            y = resampler.device_resample_block(rs, canvas.reshape(-1))
            wo = self.out_width
            canvas = y[wo:wo * (n + 1)].reshape(n, wo)

        if self.fm_video_statics is not None:
            out_i, out_q, fm_carry = rf_ops.fm_video_modulate(
                self.fm_video_statics, canvas, fm_r0)
            return _pack(out_i, out_q), fm_carry
        if self.complex_out:
            return _pack(canvas, torch.zeros_like(canvas)), None
        return torch.clamp(torch.round(canvas), -32768, 32767
                           ).to(torch.int16), None

    # ------------------------------------------------------------------
    def _prepare_host(self, block_no: int):
        """Host-side block prep: advance the mux and build the upload
        arrays.  Runs on the pipeline worker thread when pipeline_mux
        is on (the mux is then touched only by that thread)."""
        n = self.frames_per_block * mb.MAC_LINES
        halo = 1 if self.resampler is not None else 0
        k0 = block_no * n
        if self.device_mat:
            self.mux.device_mode = True
        self.mux.ensure(k0 + n + halo)
        scr_apply, xc1, xc2 = self.mux.scramble_block(k0 - halo,
                                                      k0 + n + halo)
        if self.device_mat:
            bundle = self.mux.device_bits_block(k0 - 1 - halo,
                                                k0 + n + 1 + halo)
            self.mux.prune(k0 + n - 2)
            nsub = 2 if self.mux.mode_d else 1
            nrows2 = n + 2 + 2 * halo
            lay = self._lay
            buf = np.zeros(lay["total"], np.uint8)

            def put(name, a):
                a = np.ascontiguousarray(a)
                v = a.view(np.uint8).reshape(-1)
                buf[lay[name]:lay[name] + len(v)] = v
            put("s0", bundle["streams"][0])
            if nsub > 1:
                put("s1", bundle["streams"][1])
            put("lens", bundle["lens"])
            nf = len(bundle["full_idx"])
            if nf:
                fr = np.zeros((self._fcap, self.mux.nbits // 8),
                              np.uint8)
                fr[:nf] = bundle["full_rows"]
                put("fr", fr)
            fidx = np.full(self._fcap, nrows2, np.int32)
            fidx[:nf] = bundle["full_idx"]
            put("fidx", fidx)
            put("scr", np.ascontiguousarray(scr_apply, np.float32))
            put("xc1", np.ascontiguousarray(xc1, np.int32))
            put("xc2", np.ascontiguousarray(xc2, np.int32))
            put("ints", np.array(
                [bundle["p0"][0],
                 bundle["p0"][1] if nsub > 1 else 0,
                 k0 - 1 - halo,
                 0 if block_no == 0 else 1], np.int32))
            return ("dev", buf)
        packed, pol0 = self.mux.bits_block(k0 - 1 - halo,
                                           k0 + n + 1 + halo)
        self.mux.prune(k0 + n - 2)
        return ("host", packed, pol0, scr_apply, xc1, xc2)

    def encode_block_device(self, block_no: int):
        """Block `block_no`'s samples as a device tensor: int16 [n, W, 2]
        (I, Q) for complex and FM modes, int16 [n, W] for baseband."""
        if block_no != self._next_block:
            raise RuntimeError("MAC blocks must be encoded sequentially")
        self._next_block += 1

        if self.pipeline_mux:
            if self._pipe is not None and self._pipe[0] == block_no:
                prep = self._pipe[1].result()
            else:
                prep = self._prepare_host(block_no)
            # overlap the next block's mux with this block's uploads,
            # dispatch and device compute
            self._pipe = (block_no + 1,
                          self._pipe_pool.submit(self._prepare_host,
                                                 block_no + 1))
        else:
            prep = self._prepare_host(block_no)

        planes = self._device_planes(block_no * self.frames_per_block)
        meta = self._line_meta()
        fm_r0 = (self._fm_r[block_no] if self.fm_video_statics is not None
                 else None)
        if self._plan is not None:
            out, fm_carry = self._encode_sharded(block_no, prep, planes,
                                                 meta, fm_r0)
            if fm_carry is not None:
                self._fm_r[block_no + 1] = fm_carry
                self._fm_r.pop(block_no - 2, None)
            return out
        t = lambda a: transfer.upload(a, self.device)
        if prep[0] == "dev":
            out, fm_carry, pol_carry = self._step_impl_dev(
                t(prep[1]), self._pol_c[block_no], planes, meta, fm_r0)
            self._pol_c[block_no + 1] = pol_carry
            self._pol_c.pop(block_no - 2, None)
        else:
            _, packed, pol0, scr_apply, xc1, xc2 = prep
            first = t(0.0 if block_no == 0 else 1.0)
            out, fm_carry = self._step_impl(
                t(packed), t(pol0), planes, meta, t(scr_apply), t(xc1),
                t(xc2), fm_r0, first)
        transfer.mark_done(out)
        if fm_carry is not None:
            # the carry stays a device scalar: no host sync, the next
            # block's dispatch chains on it
            self._fm_r[block_no + 1] = fm_carry
            self._fm_r.pop(block_no - 2, None)
        return out

    # names of the device statics, replicated on each further device of
    # a sharded encoder
    _DEVICE_STATICS = ("d_bases", "d_base_bits", "d_video_scale",
                       "fm_video_statics")

    def _encode_sharded(self, block_no: int, prep, planes, meta, fm_r0):
        """One block over the shard plan: the line bits once per distinct
        device, then each shard's raster on its device, the FM-video
        phase sum handed from shard to shard.  Returns
        (shard.ShardedBlock, the FM carry or None)."""
        stages = {}
        for dev in self._plan.distinct():
            rep = shard.replica(self, dev, self._DEVICE_STATICS)
            t = lambda a: transfer.upload(a, dev)
            if prep[0] == "dev":
                bits, p0, scr, xc1, xc2, first, pol = rep._bits_dev(
                    t(prep[1]), shard.to_shard(self._pol_c[block_no], dev))
            else:
                _, packed, pol0, scr, xc1, xc2 = prep
                bits = device_unpack_bits(t(packed), self.mux.nbits,
                                          torch.int32)
                p0 = t(pol0).to(torch.int32)[:, None]
                scr, xc1, xc2 = t(scr), t(xc1), t(xc2)
                first = t(0.0 if block_no == 0 else 1.0)
                pol = None
            stages[shard.device_key(dev)] = (
                rep, (bits, p0, shard.on(self, dev, "planes", planes),
                      shard.on(self, dev, "meta", meta), scr, xc1, xc2),
                first, pol)
        outs = []
        self.shard_events = []
        for win in self._windows:
            rep, args, first, pol = stages[shard.device_key(win.device)]
            fm_r0 = shard.to_shard(fm_r0, win.device)
            out, fm_r0 = shard.timed(self, win, lambda: rep._synth(
                *args, fm_r0, first, win))
            outs.append(out)
        if pol is not None:
            self._pol_c[block_no + 1] = shard.to_shard(pol, self.device)
            self._pol_c.pop(block_no - 2, None)
        return shard.ShardedBlock(outs), shard.to_shard(fm_r0, self.device)

    # ------------------------------------------------------------------
    # Stream checkpoint/resume: the packet multiplex, CA, audio-coder and
    # scramble state all live in the host MacMux, so the checkpoint is
    # the mux with its source and teletext clock detached, plus the FM
    # phase and the line polarity carries as numpy (a checkpoint written
    # on the card resumes on the CPU and the other way round).
    def checkpoint(self, next_block: int) -> bytes:
        if not getattr(self.source, "stateless", False):
            raise NotImplementedError(
                "checkpoint requires an index-addressable source")
        tt = self.mux.teletext
        if tt is not None and getattr(tt, "raw", None) is not None:
            raise NotImplementedError(
                "checkpoint with a raw: packet stream")
        b = int(next_block)
        if self.pipeline_mux:
            raise NotImplementedError(
                "checkpoint with pipeline_mux=True: the mux runs one "
                "block ahead of the dispatched stream")
        if self._next_block != b:
            raise RuntimeError(
                f"checkpoint at block {b} but stream is at "
                f"{self._next_block}")
        mux = self.mux
        src, mux.source = mux.source, None
        clock = None
        if tt is not None:
            clock = tt.service.clock
            tt.service.clock = None
        try:
            snap = copy.deepcopy(mux)
        finally:
            mux.source = src
            if tt is not None:
                tt.service.clock = clock
        st = {"version": 1, "next_block": b, "mux": snap}
        if self.fm_video_statics is not None:
            st["fm_r"] = self._fm_r[b].cpu().numpy()
        if self.device_mat:
            st["pol_c"] = self._pol_c[b].cpu().numpy()
        return pickle.dumps(st)

    def load_checkpoint(self, blob: bytes) -> int:
        """Restore checkpoint() state into this (freshly built,
        identically configured) encoder; returns the block to encode
        next.  The blob must come from this program: unpickling runs
        code."""
        st = pickle.loads(blob)
        b = st["next_block"]
        clock = (self.mux.teletext.service.clock
                 if self.mux.teletext is not None else None)
        self.mux = st["mux"]
        self.mux.source = self.source
        if self.mux.teletext is not None:
            self.mux.teletext.service.clock = clock
        if "fm_r" in st:
            self._fm_r = {b: torch.as_tensor(st["fm_r"],
                                             device=self.device)}
        if self.device_mat:
            if "pol_c" not in st:
                raise ValueError(
                    "checkpoint was written by a host-materialise "
                    "encoder; resume with device_mat disabled")
            self._pol_c = {b: torch.as_tensor(st["pol_c"],
                                              device=self.device)}
        self._next_block = b
        return b

    collect_block = transfer.collect_block
    encode_block = transfer.encode_block

    def block_audio_pcm(self, block_no: int):
        """32 kHz int16 stereo pairs consumed during this block — the
        sink audio side-channel (src/video.c:3306-3310)."""
        n = self.frames_per_block * mb.MAC_LINES
        k0 = block_no * n
        p0 = self.mux._audio_pairs_through_line(k0 - 1)
        p1 = self.mux._audio_pairs_through_line(k0 + n - 1)
        return self.mux._pcm(p0, p1 - p0).astype(np.int16)

    @property
    def frame_samples(self) -> int:
        """Output samples per frame (at sample_rate, post-resampler)."""
        return self.out_width * self.conf.lines


def _pack(i: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """I and Q rounded and clipped to int16, interleaved: [..., 2]."""
    return torch.stack([torch.clamp(torch.round(a), -32768, 32767)
                        for a in (i, q)], -1).to(torch.int16)
