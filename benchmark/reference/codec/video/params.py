"""Derived, device-ready parameters for a video mode.

This is the analogue of the reference's `vid_init()` (src/video.c:3812-4704)
recast for whole-field batch synthesis: instead of incremental LUT state it
produces immutable template arrays (sync shapes, burst envelope, filter
taps) and exact integer carrier descriptions that the batched raster kernel
consumes.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..config.standards import (ColourMode, Modulation, OutputType,
                                RasterType, VidConfig)
from ..ops import firdes
from ..ops.shapes import IRT1090, rc_window
from . import sequence

INT16_MAX = 32767


def _quant(level: float) -> int:
    return int(round(level * INT16_MAX))


@dataclass
class SyncTemplates:
    """Per line-code base waveforms including sync pulses.

    `main[i]` covers samples [0, width); `left_tail[i]` the M samples a
    line's leading pulse spills into the *previous* line (the reference
    renders these via vbidata's negative offsets, src/vbidata.c:211-224).
    """
    codes: list
    main: np.ndarray       # [n_codes, width] float32
    left_tail: np.ndarray  # [n_codes, margin] float32
    margin: int
    # a line's own pulses spilling PAST its end into the next line
    # (Baird 240: the mid-line 166.7us vsync spills half a line)
    right_head: np.ndarray = None   # [n_codes, width] float32


@dataclass
class VideoParams:
    conf: VidConfig
    sample_rate: int
    pixel_rate: int

    # geometry
    width: int = 0
    half_width: int = 0
    active_left: int = 0
    active_width: int = 0

    # int16 levels
    white_level: int = 0
    black_level: int = 0
    blanking_level: int = 0
    sync_level: int = 0
    level: float = 1.0       # video_level * slevel (scales YUV)

    syncs: Optional[SyncTemplates] = None

    # colour subcarrier: pixel_rate / fsc = cl_num / cl_den exactly
    cl_num: int = 0
    cl_den: int = 0

    # chroma gaussian FIR taps (Q15-quantised, centred) or None
    chroma_taps: Optional[np.ndarray] = None

    # burst: precomputed U/V insert arrays (already includes burst phase)
    burst_left: int = 0
    burst_u: Optional[np.ndarray] = None
    burst_v: Optional[np.ndarray] = None

    # video output filter (low-pass for baseband, or complex VSB taps)
    vfilter_taps: Optional[np.ndarray] = None          # real
    vfilter_ctaps: Optional[np.ndarray] = None         # complex (VSB)

    # YUV conversion constants
    yuv_mat: Optional[np.ndarray] = None   # not used directly; see raster
    gamma_lut: Optional[np.ndarray] = None  # [256] float32

    @property
    def lines(self) -> int:
        return self.conf.lines

    @property
    def frame_samples(self) -> int:
        return self.width * self.conf.lines

    # ------------------------------------------------------------------
    @classmethod
    def create(cls, conf: VidConfig, sample_rate: int,
               pixel_rate: int = 0) -> "VideoParams":
        p = cls(conf=conf, sample_rate=int(sample_rate),
                pixel_rate=int(pixel_rate) or int(sample_rate))

        # Defaults (src/video.c:3832-3836)
        gamma = conf.gamma if conf.gamma > 0 else 1.0
        rw = conf.rw_co if conf.rw_co > 0 else 0.299
        gw = conf.gw_co if conf.gw_co > 0 else 0.587
        bw = conf.bw_co if conf.bw_co > 0 else 0.114
        p.rw_co, p.gw_co, p.bw_co, p.gamma = rw, gw, bw, gamma

        # Samples per line (src/video.c:3843-3853)
        line_dur = conf.frame_rate.den / (conf.frame_rate.num * conf.lines)
        p.width = round(p.pixel_rate * line_dur)
        p.half_width = round(p.pixel_rate * line_dur / 2)
        p.active_left = round(p.pixel_rate * conf.active_left)
        p.active_width = min(math.ceil(p.pixel_rate * conf.active_width),
                             p.width)

        # Levels (src/video.c:3855-3881)
        slevel = 1.0 if conf.modulation == Modulation.FM else conf.level
        level = conf.video_level * slevel
        p.level = level
        if conf.invert_video:
            # swap sync and white, then mirror blanking/black through
            # the new levels (src/video.c:3863-3876: computed after the
            # swap, so the offsets use the OLD white as the new sync)
            from dataclasses import replace as _replace
            w, sy = conf.white_level, conf.sync_level
            conf = _replace(
                conf, white_level=sy, sync_level=w,
                blanking_level=w - (conf.blanking_level - sy),
                black_level=w - (conf.black_level - sy))
            p.conf = conf
        p.white_level = _quant(conf.white_level * level)
        p.black_level = _quant(conf.black_level * level)
        p.blanking_level = _quant(conf.blanking_level * level)
        p.sync_level = _quant(conf.sync_level * level)

        p.gamma_lut = np.power(np.arange(256) / 255.0, 1.0 / gamma
                               ).astype(np.float64)

        p.syncs = p._build_sync_templates(line_dur, level)

        if conf.colour_mode in (ColourMode.PAL, ColourMode.NTSC):
            # pixel_rate / fsc as an exact normalised rational
            # (src/video.c:3961-3969)
            fsc = conf.colour_carrier
            num = p.pixel_rate * fsc.den
            den = fsc.num
            g = math.gcd(num, den)
            p.cl_num, p.cl_den = num // g, den // g

            if conf.colour_bw > 0:
                ntaps = firdes.gaussian_low_pass_ntaps(p.pixel_rate,
                                                       conf.colour_bw)
                taps = firdes.gaussian_low_pass(ntaps, p.pixel_rate,
                                                conf.colour_bw, 1.0)
                p.chroma_taps = firdes.quantise_taps(taps).astype(np.float32)

            if conf.burst_level > 0:
                p._build_burst(level)

        p._build_vfilter()
        return p

    # ------------------------------------------------------------------
    def _build_sync_templates(self, line_dur: float, level: float
                              ) -> SyncTemplates:
        """Pre-render one base line per distinct sequence code.

        Mirrors `_render_sync_pulses` + vbidata step rendering
        (src/video.c:3766-3810, src/vbidata.c:62-81): each pulse is an
        integer-rounded integrated-raised-cosine step at a fractional
        sample offset.
        """
        conf = self.conf
        # vbidata_update_step takes the level as an int — C truncation
        # toward zero (src/vbidata.c:62, src/video.c:3884)
        d = math.trunc((conf.sync_level - conf.blanking_level)
                       * level * INT16_MAX)
        rise = conf.sync_rise * IRT1090 * self.pixel_rate

        # [offset, width] in samples for the 5 pulse slots of the reference
        pulses = {
            'h': (0.0, conf.hsync_width * self.pixel_rate),
            'v': (0.0, conf.vsync_short_width * self.pixel_rate),
            'V': (0.0, conf.vsync_long_width * self.pixel_rate),
            'mv': (line_dur / 2 * self.pixel_rate,
                   conf.vsync_short_width * self.pixel_rate),
            'mV': (line_dur / 2 * self.pixel_rate,
                   conf.vsync_long_width * self.pixel_rate),
        }

        margin = max(4, int(math.ceil(rise / 2)) + 2)

        def render_pulse(offset, pwidth):
            """Integer samples x in [floor(offset-rise/2), ceil(offset+width+rise/2)]."""
            x1 = math.floor(offset - rise / 2)
            x2 = math.ceil(offset + pwidth + rise / 2)
            xs = np.arange(x1, x2 + 1)
            vals = np.round(rc_window(xs.astype(np.float64), offset, pwidth,
                                      rise) * d)
            return x1, vals

        # collect distinct codes used by this raster type
        codes = sorted({sequence.line_sequence(conf.type, n)
                        for n in range(0, conf.lines + 1)})

        width = self.width
        main = np.zeros((len(codes), width), dtype=np.float64)
        tail = np.zeros((len(codes), margin), dtype=np.float64)
        head = np.zeros((len(codes), width), dtype=np.float64)

        for i, code in enumerate(codes):
            acc = np.zeros(2 * width + 2 * margin, dtype=np.float64)
            sel = []
            if code[0] == 'h':
                sel.append('h')
            elif code[0] == 'v':
                sel.append('v')
            elif code[0] == 'V':
                sel.append('V')
            if code[3] == 'v':
                sel.append('mv')
            elif code[3] == 'V':
                sel.append('mV')
            for s in sel:
                off, w = pulses[s]
                if w <= 0:
                    continue
                x1, vals = render_pulse(off, w)
                lo = x1 + margin
                # clip: at very low sample rates (Baird 240/30) the
                # long vsync pulse can reach the end of the line
                lo2, hi2 = max(lo, 0), min(lo + len(vals), len(acc))
                acc[lo2:hi2] += vals[lo2 - lo:hi2 - lo]
            main[i] = acc[margin:margin + width]
            tail[i] = acc[:margin]
            head[i] = acc[margin + width:margin + 2 * width]

        main += self.blanking_level
        # one extra all-zero right_head row (index len(codes)): selected
        # for startup lines whose forward spill the reference truncates
        head = np.concatenate([head, np.zeros((1, head.shape[1]))])
        return SyncTemplates(codes=codes,
                             main=main.astype(np.float32),
                             left_tail=tail.astype(np.float32),
                             margin=margin,
                             right_head=head.astype(np.float32))

    # ------------------------------------------------------------------
    def _build_burst(self, level: float):
        """Burst envelope x phase, exactly as the reference computes it in
        integer space (src/video.c:4017-4048, 3023-3029)."""
        conf = self.conf
        rise = conf.burst_rise * IRT1090
        self.burst_left = round(self.pixel_rate *
                                (conf.burst_left - conf.burst_rise / 2))
        blen = math.ceil(self.pixel_rate * (conf.burst_width + rise))
        t = np.arange(blen) / self.pixel_rate
        blevel = (conf.burst_level *
                  (conf.white_level - conf.blanking_level) / 2 * level)
        win = np.round(rc_window(t, rise / 2, conf.burst_width, rise)
                       * blevel * INT16_MAX).astype(np.int64)

        if conf.colour_mode == ColourMode.PAL:
            ph = 135.0 * math.pi / 180.0
            bi = int(round(math.cos(ph) * INT16_MAX))
            bq = int(round(math.sin(ph) * INT16_MAX))
        else:  # NTSC: 180 degrees
            bi, bq = -INT16_MAX, 0

        # (phase * win) >> 15 in int space, matching C arithmetic-shift floor
        self.burst_u = (bi * win >> 15).astype(np.float32)
        self.burst_v = (bq * win >> 15).astype(np.float32)

    # ------------------------------------------------------------------
    def _build_vfilter(self):
        """Output video filter taps (src/video.c:3653-3764).

        Only built when conf.vfilter is set — the reference applies the
        video filter only with the `--filter` CLI flag
        (src/video.c:4370-4373).
        """
        conf = self.conf
        if not conf.vfilter:
            return
        if conf.modulation == Modulation.VSB:
            ctaps = firdes.complex_band_pass(
                51, self.sample_rate, -conf.vsb_lower_bw, conf.vsb_upper_bw,
                750000.0, 1.0)
            self.vfilter_ctaps = (
                (np.round(ctaps.real * 32767) +
                 1j * np.round(ctaps.imag * 32767)) / 32768.0
            ).astype(np.complex64)
        elif conf.modulation == Modulation.FM:
            from ..rf.vpreemph import select_fm_taps
            taps = select_fm_taps(conf.type == RasterType.MAC, conf.lines,
                                  self.sample_rate)
            self.vfilter_taps = firdes.quantise_taps(taps).astype(np.float32)
        elif conf.modulation in (Modulation.AM, Modulation.NONE):
            if conf.video_bw > 0:
                taps = firdes.low_pass(51, self.sample_rate, conf.video_bw,
                                       0.75e6, 1.0)
                self.vfilter_taps = firdes.quantise_taps(taps
                                                         ).astype(np.float32)

    # ------------------------------------------------------------------
    # Per-line metadata for a range of stream line indices.
    def line_meta(self, k0: int, n: int, vframe_interlaced: int = 0,
                  vframe_x: int = 0, vframe_y: int = 0,
                  vframe_w: Optional[int] = None,
                  vframe_h: Optional[int] = None,
                  spill_warmup: int = 0) -> dict:
        """Host-side computation of everything that varies per line.

        `k` is the absolute stream line counter: k=0 is the first rendered
        line, (frame 1, line 1) — the reference starts its counters at
        bline=1, bframe=1 (src/video.c:4166) and outputs every rendered
        line; the first line's filter history is zeros.
        """
        conf = self.conf
        W = vframe_w if vframe_w is not None else self.active_width
        H = vframe_h if vframe_h is not None else conf.active_lines

        codes = self.syncs.codes
        code_idx = {c: i for i, c in enumerate(codes)}
        # row index len(codes) of right_head is all-zero: used to drop
        # the forward sync spill of the first ring-cycle lines (the
        # reference's un-rendered next slots still have width 0 at
        # startup, so vbidata_render truncates there,
        # src/vbidata.c:225-236 + src/video.c:4665)
        zero_head = len(codes)

        base = np.zeros(n, dtype=np.int32)
        nxt = np.zeros(n, dtype=np.int32)
        prv = np.zeros(n, dtype=np.int32)
        burst = np.zeros(n, dtype=np.float32)
        vsw = np.ones(n, dtype=np.float32)
        vy = np.full(n, -1, dtype=np.int32)
        al = np.full(n, -1, dtype=np.int32)
        ar = np.full(n, -1, dtype=np.int32)
        ph0 = np.zeros(n, dtype=np.int64)
        cos0 = np.ones(n, dtype=np.float64)
        sin0 = np.zeros(n, dtype=np.float64)
        lut_row = np.zeros(n, dtype=np.int32)
        frame_no = np.zeros(n, dtype=np.int64)
        line_no = np.zeros(n, dtype=np.int64)
        fsc = np.zeros(n, dtype=np.int32)
        fscf = np.zeros(n, dtype=np.int32)

        for j in range(n):
            k = max(k0 + j, 0)
            frame = 1 + k // conf.lines
            line = k % conf.lines + 1
            frame_no[j] = frame
            line_no[j] = line
            code = sequence.line_sequence(conf.type, line)
            base[j] = code_idx[code]
            ncode = sequence.line_sequence(
                conf.type, 1 if line >= conf.lines else line + 1)
            nxt[j] = code_idx[ncode]
            pcode = sequence.line_sequence(
                conf.type, conf.lines if line == 1 else line - 1)
            # the previous line's forward spill is dropped for the first
            # ring cycle: the reference's next-line buffers keep width 0
            # until first rendered, truncating vbidata's continuation
            # (observed: Baird 240 lines 2..olines lack the previous
            # mid-line vsync spill; src/vbidata.c:225-236)
            if 1 <= k <= spill_warmup:
                prv[j] = zero_head
            else:
                prv[j] = code_idx[pcode]

            if conf.colour_mode in (ColourMode.PAL, ColourMode.NTSC):
                pal = (code[1] == '0'
                       or (code[1] == '1' and (frame & 1) == 0)
                       or (code[1] == '2' and (frame & 1) == 1))
                burst[j] = 1.0 if pal else 0.0
                if (conf.colour_mode == ColourMode.PAL and pal
                        and ((frame + line) & 1)):
                    vsw[j] = -1.0
                ph0[j] = (k * self.width % self.cl_num) * self.cl_den \
                    % self.cl_num
                ang = 2.0 * np.pi * ph0[j] / self.cl_num
                cos0[j] = np.cos(ang)
                sin0[j] = np.sin(ang)
                if self.cl_num // math.gcd(self.width, self.cl_num) \
                        <= 4096:
                    lut_row[j] = (k * self.width % self.cl_num) \
                        // math.gcd(self.width, self.cl_num)

            if conf.colour_mode == ColourMode.APOLLO_FSC:
                # one colour per field, green flagged on field line 18
                # (src/video.c:2921-2926, 3043-3055)
                fsc[j] = (frame * 2 + (0 if line < 264 else 1)) % 3
                if fsc[j] == 1 and line in (18, 281):
                    fscf[j] = 1
            elif conf.colour_mode == ColourMode.CBS_FSC:
                fsc[j] = (frame * 2 + (0 if line < 202 else 1)) % 3
                if fsc[j] == 2 and line == 1:
                    fscf[j] = 1
                elif fsc[j] == 2 and line == 203:
                    fscf[j] = 2

            v = sequence.active_video_line(conf.type, line)
            if v >= 0 and conf.interlaced != 0 and \
                    vframe_interlaced != conf.interlaced:
                v += 1
            v -= vframe_y
            if v < 0 or v >= H:
                v = -1
            vy[j] = v

            if code[2] == 'a' or code[3] == 'a':
                al[j] = (self.active_left if code[2] == 'a'
                         else (self.half_width if code[3] == 'a' else -1))
                ar[j] = (self.active_left + self.active_width
                         if code[3] == 'a'
                         else (self.half_width if code[2] == 'a' else -1))

        return dict(base=base, nxt=nxt, prv=prv, burst=burst,
                    vswitch=vsw, vy=vy,
                    al=al, ar=ar, ph0=ph0, cos0=cos0, sin0=sin0,
                    lut_row=lut_row, frame=frame_no, line=line_no,
                    fsc=fsc, fscf=fscf)
