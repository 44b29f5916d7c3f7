"""Batched raster synthesis: whole blocks of scan lines as tensor ops.

Port of hacktv_tpu/video/raster.py.  The host side (`make_statics`,
`rgb_to_yuv_host`) stays numpy and builds the same constants; `to_device` moves them onto the encoder's device, and
`synth_block` renders a [n_lines, width] block there:

  sync templates (gather) -> luma placement (where) -> chroma FIR
  -> burst insert -> subcarrier mix (exact int32)

The colour carrier comes from exact per-line LUT rows when the carrier
cycle is a whole number of lines (the standard rates), else from angle
addition against a per-column table.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..audio.synth import fma32
from ..config.standards import ColourMode
from ..ops.stream_fir import fuse_second
from .params import VideoParams


@dataclass
class RasterStatics:
    """Constants of the raster (numpy on the host, tensors after
    `to_device`)."""
    width: int
    margin: int
    col0: int                  # active_left + vframe_x: first source column
    frame_w: int
    blanking: float
    black_y: float
    sync_main: np.ndarray      # [n_codes, width]
    sync_tail: np.ndarray      # [n_codes, margin]
    sync_head: np.ndarray      # [n_codes, width]: spill past line end
    chroma_taps: np.ndarray | None
    burst_left: int
    burst_u: np.ndarray | None
    burst_v: np.ndarray | None
    colour: bool
    # Colour carrier: exact LUT rows ([P, width] cos, [P, width] sin) and a
    # per-line row index, or the angle-addition column tables.
    carrier_rows: tuple | None
    carrier_cos: np.ndarray | None   # [width]
    carrier_sin: np.ndarray | None   # [width]
    # YUV conversion
    gamma: float
    rw: float
    gw: float
    bw: float
    eu: float
    ev: float
    y_scale: float             # (white - black) * level   (fractions)
    y_offset: float            # black * level
    uv_scale: float
    fsc_mode: str | None = None        # 'apollo' | 'cbs'
    fsc_tpl: np.ndarray | None = None  # [3, W] flag pulse templates
    # first step of the chroma FIR chain (see _chroma_filter), decided on
    # the host so that the device path never reads the taps back
    chroma_fuse_second: bool = False


# RasterStatics fields that hold arrays (carrier_rows: a pair of them)
ARRAY_FIELDS = ("sync_main", "sync_tail", "sync_head", "chroma_taps",
                "burst_u", "burst_v", "carrier_rows", "carrier_cos",
                "carrier_sin", "fsc_tpl")


def make_statics(p: VideoParams, vframe_x: int = 0,
                 frame_w: int | None = None) -> RasterStatics:
    conf = p.conf
    colour = conf.colour_mode in (ColourMode.PAL, ColourMode.NTSC)
    ccos = csin = rows = None
    if colour and p.cl_num:
        import math as _m
        g = _m.gcd(p.width, p.cl_num)
        P = p.cl_num // g
        if P <= 4096:
            # exact LUT rows: line k starts at offset (k*W) mod cl_num,
            # always a multiple of g, so P distinct rows cover every
            # line.  The reference LUT entry is round(cos(d*c)*32767)
            # with d*c accumulating f64 drift over the UNWRAPPED index c
            # (the table is extended by one line rather than wrapped,
            # src/video.c:3961-3985) — reproduce that exactly, with C's
            # half-away-from-zero lround.
            off = (np.arange(P, dtype=np.int64)[:, None] * g
                   + np.arange(p.width, dtype=np.int64)[None, :]
                   ).astype(np.float64)
            d = 2.0 * np.pi * (p.cl_den / p.cl_num)
            lr = lambda a: np.where(a >= 0, np.floor(a + 0.5),
                                    np.ceil(a - 0.5))
            rows = (
                lr(np.cos(d * off) * 32767.0).astype(np.float32),
                lr(np.sin(d * off) * 32767.0).astype(np.float32))
        else:
            # angle(x) = 2*pi*((x*cl_den) mod cl_num)/cl_num, exact ints
            # evaluated in float64 on the host.
            x = np.arange(p.width, dtype=np.int64)
            v = (x * p.cl_den) % p.cl_num
            ang = 2.0 * np.pi * v / p.cl_num
            ccos = np.cos(ang).astype(np.float32)
            csin = np.sin(ang).astype(np.float32)
    fsc_mode = None
    fsc_tpl = None
    if conf.colour_mode in (ColourMode.APOLLO_FSC, ColourMode.CBS_FSC):
        # FSC ID flag pulses (src/video.c:4049-4072, 3043-3063)
        import math as _math
        from ..ops.shapes import IRT1090, rc_window
        fsc_mode = ("apollo" if conf.colour_mode == ColourMode.APOLLO_FSC
                    else "cbs")
        d = _math.trunc((conf.fsc_flag_level - conf.blanking_level)
                        * p.level * 32767)
        rise = conf.sync_rise * IRT1090 * p.pixel_rate
        x = np.arange(p.width, dtype=np.float64)
        left = conf.fsc_flag_left * p.pixel_rate
        wid = conf.fsc_flag_width * p.pixel_rate
        p1 = np.round(rc_window(x, left, wid, rise) * d)
        tpl = np.zeros((3, p.width), dtype=np.float32)
        tpl[1] = p1
        if fsc_mode == "cbs":
            p2 = np.round(rc_window(x, p.width / 2 + left, wid, rise) * d)
            tpl[2] = p2
        fsc_tpl = tpl
    return RasterStatics(
        width=p.width,
        margin=p.syncs.margin,
        col0=p.active_left + vframe_x,
        frame_w=frame_w if frame_w is not None else p.active_width,
        blanking=float(p.blanking_level),
        black_y=float(_black_y_level(p)),
        sync_main=np.asarray(p.syncs.main),
        sync_tail=np.asarray(p.syncs.left_tail),
        sync_head=np.asarray(p.syncs.right_head),
        chroma_taps=(np.asarray(p.chroma_taps)
                     if p.chroma_taps is not None else None),
        burst_left=p.burst_left,
        burst_u=np.asarray(p.burst_u) if p.burst_u is not None else None,
        burst_v=np.asarray(p.burst_v) if p.burst_v is not None else None,
        colour=colour,
        carrier_rows=rows,
        carrier_cos=ccos,
        carrier_sin=csin,
        gamma=p.gamma,
        rw=p.rw_co, gw=p.gw_co, bw=p.bw_co,
        eu=conf.eu_co, ev=conf.ev_co,
        y_scale=(conf.white_level - conf.black_level) * p.level,
        y_offset=conf.black_level * p.level,
        uv_scale=(conf.white_level - conf.black_level) * p.level,
        fsc_mode=fsc_mode,
        fsc_tpl=fsc_tpl,
        chroma_fuse_second=(p.chroma_taps is not None
                            and len(p.chroma_taps) > 1
                            and fuse_second(float(p.chroma_taps[-1]),
                                            float(p.chroma_taps[-2]))),
    )


def _black_y_level(p: VideoParams) -> int:
    """yuv_level_lookup[0x000000].y: quantised black (src/video.c:3942-3956)."""
    conf = p.conf
    y = conf.black_level * p.level
    y = min(max(y, -1.0), 1.0)
    return int(round(y * 32767))


def rgb_to_yuv_host(p, rgb: np.ndarray, secam: bool = False):
    """RGB u8 [H, W, 3] -> quantised (Y, U, V) int16-valued f32 [H, W].

    Matches the reference's 16M-entry LUT build (src/video.c:3897-3959)
    bit-exactly: the conversion runs in float64 on the host (boundary
    rounding in f32 would systematically shift whole colour regions,
    which FM modes integrate into phase drift).  Cached per source frame
    by the encoder.
    """
    from ..config.standards import (SECAM_CB_FREQ, SECAM_CR_FREQ,
                                    SECAM_FM_DEV, SECAM_FM_FREQ)
    conf = p.conf
    glut = np.power(np.arange(256) / 255.0, 1.0 / p.gamma)
    r = glut[rgb[..., 0]]
    g = glut[rgb[..., 1]]
    b = glut[rgb[..., 2]]
    y = r * p.rw_co + g * p.gw_co + b * p.bw_co
    u = (b - y) * conf.eu_co
    v = (r - y) * conf.ev_co
    yl = (conf.black_level + y * (conf.white_level - conf.black_level)) \
        * p.level
    if not secam:
        scale = (conf.white_level - conf.black_level) * p.level
        ul = u * scale
        vl = v * scale
    else:
        ul = (u + (SECAM_CB_FREQ - SECAM_FM_FREQ)) / SECAM_FM_DEV
        vl = (v + (SECAM_CR_FREQ - SECAM_FM_FREQ)) / SECAM_FM_DEV
    q = lambda a: np.round(np.clip(a, -1.0, 1.0) * 32767.0
                           ).astype(np.float32)
    return q(yl), q(ul), q(vl)


_YUV_LUT_CACHE: dict = {}


def to_device(st: RasterStatics, device) -> RasterStatics:
    """The same statics with every array field a tensor on `device`."""
    def conv(a):
        if a is None:
            return None
        if isinstance(a, tuple):
            return tuple(conv(x) for x in a)
        return torch.as_tensor(np.ascontiguousarray(a), device=device)
    return dataclasses.replace(
        st, **{f: conv(getattr(st, f)) for f in ARRAY_FIELDS})


def _chroma_filter(taps: torch.Tensor, x: torch.Tensor,
                   fuse2: bool) -> torch.Tensor:
    """Per-line 'same' convolution with zero-padded line edges (the
    reference's per-line block FIR on the chrominance buffer,
    src/video.c:3017-3021).

    The sum runs in tap order as fused multiply-adds, with two steps
    that match what the JAX reference's CPU backend emits for its
    shifted-slice chain inside the synthesis graph: the first step fuses
    one of its two products (the second when `fuse2`, as ops.stream_fir
    documents), and the centre tap's product is rounded before it is
    added.  The centre slice is the masked chroma itself, and XLA turns
    `tap * where(mask, u, 0)` into `where(mask, tap * u, 0)`, so the
    select between the multiply and the add keeps that step unfused."""
    n = taps.shape[0]
    W = x.shape[1]
    pad = n // 2
    xp = F.pad(x, (pad, n - 1 - pad))
    rt = taps.flip(0)
    if n == 1:
        out = rt[0] * xp[:, 0:W]
    elif fuse2:
        out = torch.addcmul(rt[0] * xp[:, 0:W], xp[:, 1:1 + W], rt[1])
    else:
        out = torch.addcmul(rt[1] * xp[:, 1:1 + W], xp[:, 0:W], rt[0])
    for k in range(2, n):
        if k == pad:
            out = out + rt[k] * xp[:, k:k + W]
        else:
            out = torch.addcmul(out, xp[:, k:k + W], rt[k])
    # the reference's integer FIR truncates the >>15 accumulator and
    # clamps to int16 (src/fir.c:347-348); FM modes integrate the
    # baseband so even sub-LSB bias matters
    return torch.clamp(torch.floor(out), -32768, 32767)


def synth_block(st: RasterStatics,
                yuv,                    # (Y, U, V) f32 [H, frame_w] each
                base: torch.Tensor,     # long [B]
                nxt: torch.Tensor,      # long [B]
                burst: torch.Tensor,    # f32 [B] 0/1
                vswitch: torch.Tensor,  # f32 [B] +-1
                vy: torch.Tensor,       # long [B]
                al: torch.Tensor,       # long [B]
                ar: torch.Tensor,       # long [B]
                cos0: torch.Tensor,     # f32 [B] carrier phase at line start
                sin0: torch.Tensor,     # f32 [B]
                lut_row: torch.Tensor = None,   # long [B] carrier LUT row
                prv: torch.Tensor = None,       # long [B] previous line code
                fsc: torch.Tensor = None,       # long [B] FSC field channel
                fscf: torch.Tensor = None,      # long [B] FSC flag selector
                split_chroma: bool = False,
                stacked_h: int = 0,
                ):
    """Synthesise a block of lines -> f32 [B, width] (luma+chroma
    composite, int16-scaled).  Lines are independent; the only cross-line
    term is the next line's leading sync tail.  With split_chroma
    (S-Video) the subcarrier is not added but returned as a second
    [B, width] channel: (composite without chroma, chroma).  With
    stacked_h = H + 1 the planes are a block of frames from stack_planes
    and vy is already the absolute row (f (H + 1) + row, or + H for the
    fallback row)."""
    y_img, u_img, v_img = yuv
    if stacked_h:
        return _synth_rows(st, y_img[vy], u_img[vy], v_img[vy],
                           (vy % stacked_h) != (stacked_h - 1), base, nxt,
                           burst, vswitch, al, ar, cos0, sin0, lut_row, prv,
                           fscf, split_chroma)
    H = y_img.shape[-2]

    # Row gather with black fallback (row H)
    black_row = torch.full((1, y_img.shape[-1]), st.black_y,
                           dtype=y_img.dtype, device=y_img.device)
    zero_row = torch.zeros((1, u_img.shape[-1]), dtype=u_img.dtype,
                           device=u_img.device)
    vy_safe = torch.where(vy >= 0, vy, H)
    if st.fsc_mode is not None:
        # field-sequential colour: y_img is [3, H, W], one grey plane per
        # B/G/R field (src/video.c:2989-2994), each followed by its black
        # row; the line's field channel picks the plane
        planes = torch.cat([torch.cat([y_img[c], black_row])
                            for c in range(3)])
        y_rows = planes[fsc * (H + 1) + vy_safe]
    else:
        y_rows = torch.cat([y_img, black_row])[vy_safe]    # [B, frame_w]
    u_rows = torch.cat([u_img, zero_row])[vy_safe]
    v_rows = torch.cat([v_img, zero_row])[vy_safe]
    return _synth_rows(st, y_rows, u_rows, v_rows, vy >= 0, base, nxt,
                       burst, vswitch, al, ar, cos0, sin0, lut_row, prv,
                       fscf, split_chroma)


def carrier_lut(st: RasterStatics, cos0, sin0, lut_row):
    """The colour subcarrier of each line, (cos, sin) [B, W] at 32767
    scale: the exact LUT row per line when there is one, otherwise angle
    addition against the static per-column table; None without a colour
    carrier."""
    if st.carrier_rows is not None:
        return st.carrier_rows[0][lut_row], st.carrier_rows[1][lut_row]
    if st.carrier_cos is None:
        return None
    # mirrors XLA's CPU contraction: of a*b +- c*d, c*d is rounded and
    # a*b fused into the add or subtract
    c0, s0 = cos0[:, None], sin0[:, None]
    cos_t = torch.round(fma32(c0, st.carrier_cos,
                              -(s0 * st.carrier_sin)) * 32767.0)
    sin_t = torch.round(fma32(s0, st.carrier_cos,
                              c0 * st.carrier_sin) * 32767.0)
    return cos_t, sin_t


def _synth_rows(st, y_rows, u_rows, v_rows, has_video_rows, base, nxt,
                burst, vswitch, al, ar, cos0, sin0, lut_row, prv, fscf,
                split_chroma):
    """Shared synthesis tail: source rows -> composite lines (and the
    chroma channel with split_chroma)."""
    W = st.width

    # Place source columns into the line; at very low rates the active
    # region can round past the end of the line, so trim columns
    pad_r = W - st.col0 - st.frame_w
    if pad_r < 0:
        y_rows = y_rows[:, :st.frame_w + pad_r]
        u_rows = u_rows[:, :st.frame_w + pad_r]
        v_rows = v_rows[:, :st.frame_w + pad_r]
        pad_r = 0
    y_full = F.pad(y_rows, (st.col0, pad_r), value=st.black_y)
    u_full = F.pad(u_rows, (st.col0, pad_r))
    v_full = F.pad(v_rows, (st.col0, pad_r))

    cols = torch.arange(W, device=base.device)[None, :]
    active = (cols >= al[:, None]) & (cols < ar[:, None])
    in_frame = (cols >= st.col0) & (cols < st.col0 + st.frame_w)

    # Base line: blanking + syncs, plus next line's leading-pulse tail
    out = st.sync_main[base]
    out[:, W - st.margin:] += st.sync_tail[nxt]
    if prv is not None:
        # previous line's pulses spilling past its end (Baird 240); the
        # caller passes prv only when sync_head has any nonzero entry
        out = out + st.sync_head[prv]

    out = torch.where(active, y_full, out)

    if st.colour:
        has_video = in_frame & has_video_rows[:, None]
        uc = torch.where(active & has_video, u_full, 0.0)
        vc = torch.where(active & has_video, v_full, 0.0)
        if st.chroma_taps is not None:
            uc = _chroma_filter(st.chroma_taps, uc, st.chroma_fuse_second)
            vc = _chroma_filter(st.chroma_taps, vc, st.chroma_fuse_second)
        # Burst overwrite (src/video.c:3023-3029)
        if st.burst_u is not None:
            bl = st.burst_left
            bn = st.burst_u.shape[0]
            uc[:, bl:bl + bn] = st.burst_u[None, :]
            vc[:, bl:bl + bn] = st.burst_v[None, :]
        cos_t, sin_t = carrier_lut(st, cos0, sin0, lut_row)
        # The reference's mix is integer: (lut.i*V*pal + lut.q*U) >> 15
        # (src/video.c:3031-3041).  The products reach ~2^30, beyond
        # f32's 24-bit mantissa, so the multiply-accumulate-shift runs in
        # int32 exactly.
        i32 = torch.int32
        sub = ((cos_t.to(i32) * (vc * vswitch[:, None]).to(i32)
                + sin_t.to(i32) * uc.to(i32)) >> 15).to(torch.float32)
        chroma = torch.where(burst[:, None] > 0, sub, 0.0)
        if not split_chroma:
            out = out + chroma
    elif split_chroma:
        chroma = torch.zeros_like(out)

    if st.fsc_mode is not None:
        # FSC ID flag pulses (src/video.c:3043-3063)
        out = out + st.fsc_tpl[fscf]
    if split_chroma:
        return out, chroma
    return out
