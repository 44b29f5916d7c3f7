"""SECAM chrominance on the device: the chroma program and the line render.

Port of the device path of hacktv_tpu/video/secam.py (the reference's
threaded SECAM line process, src/video.c:3068-3233, init :4075-4162).
The host side (`make_statics`, `line_meta`, the constant tables) stays
numpy and builds the same values; `device_chroma_carrier` and `render`
run as tensor ops on the encoder's device:

  - line-alternating D'r/D'b rows with vertical averaging (row gathers)
    and the static field-identification rows;
  - the Q15 chroma low-pass, exact in int32;
  - the HF pre-emphasis IIR as a log-depth doubling scan, with the single
    scalar `z` at the previous active line's end carried across lines and
    blocks;
  - the deviation clamps, the closed-form FM carrier phase and the
    analytic anti-cloche bell;
  - the luma band-reject over the active segment (`render`).

Bit for bit the JAX encoder on its CPU backend, where this program runs
inside the encoder's one compiled step: cos/sin are glibc's
(`synth._sincosf_glibc`), and each product that XLA's CPU compiler fuses
into the following add is fused here (`synth.fma32`); every other
product is rounded on its own.  With the field-identification lines the
carrier phase passes 120 rad, where glibc's large-argument reduction
runs (`SecamDevice.large`).

`chroma_render` is what the encoder calls: on the CPU the two plain
functions above, on a card the hand-written kernel of
csrc/secam_chroma.cu, which runs both for each row at once, byte for byte
the plain version (counted in the tracer's "secam.kernel_windows").

The host-exact path (`chroma_block_host`, `carrier_addin_host`) runs the
reference's serial stages in the native runtime (runtime.py): the
encoder's `secam_exact`, and the default of the FM-video SECAM modes,
where a 1-LSB chroma difference would integrate into the FM phase.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from .. import runtime, telemetry
from ..audio import synth
from ..audio.synth import _sincosf_glibc, fma32
from ..config.standards import (SECAM_CB_FREQ, SECAM_CR_FREQ, SECAM_FM_DEV,
                                SECAM_FM_FREQ)
from ..ops import cuda_build, firdes
from ..ops.shapes import IRT1090, rc_window
from . import sequence

INT16_MAX = 32767
_IIR_TAIL = 320     # samples of the truncated impulse response (iir_h)


@dataclass
class SecamStatics:
    width: int
    active_left: int
    active_width: int
    half_width: int
    col0: int               # active_left + vframe_x
    frame_w: int
    burst_left: int
    burst_len: int
    burst_win: np.ndarray       # [burst_len] int-valued envelope
    luma_taps: np.ndarray       # [51] band-reject + bypass (Q15)
    chroma_taps: np.ndarray     # [15] low-pass (Q15)
    iir_h: np.ndarray           # [_IIR_TAIL] truncated impulse response
    dmin: tuple                 # per dr
    dmax: tuple
    level_int: int              # FM level
    kd: float                   # rad/sample per unit
    w0: float                   # rad/sample at centre frequency
    u_black: float
    v_black: float
    # centre-frequency phase per in-span sample count, exact mod 2pi
    w0_tab: np.ndarray = None   # f32 [width+1]
    # anti-cloche bell gain per chroma value, quantised exactly as the
    # reference's 65536-entry cint16 LUT (src/video.c:4122-4128)
    bell_i: np.ndarray = None   # int16 [65536], index chroma + 32768
    bell_q: np.ndarray = None
    _win_q: np.ndarray = None   # int16 [width]: burst window, zero tail
    fsync_level: int = 0        # field-ID sawtooth deviation
    pixel_rate: int = 0


def make_statics(p, vframe_x: int, frame_w: int) -> SecamStatics:
    conf = p.conf
    level = p.level
    secam_level = (conf.white_level - conf.blanking_level) * level

    # luma filter: band reject around the subcarrier + 0.5 bypass,
    # renormalised (src/video.c:4100-4107)
    taps = firdes.band_reject(51, p.pixel_rate, SECAM_FM_FREQ - 1e6,
                              SECAM_FM_FREQ + 1e6, 1e6, 1.0)
    taps[51 // 2] += 0.5
    taps = taps / taps.sum()
    luma_taps = firdes.quantise_taps(taps).astype(np.float32)

    ctaps = firdes.low_pass(15, p.pixel_rate, 1.70e6, 0.50e6, 1.0)
    chroma_taps = firdes.quantise_taps(ctaps).astype(np.float32)

    # IIR b = {2.90456054, -2.80912108}, a = {1, -0.90456054}
    # (src/video.c:4087-4090): y[n] = b0 x[n] + b1 x[n-1] + 0.90456054 y[n-1]
    b0, b1, a1 = _IIR_B0, _IIR_B1, _IIR_A1
    h = np.zeros(_IIR_TAIL)
    h[0] = b0
    h[1] = b1 - a1 * b0
    for i in range(2, _IIR_TAIL):
        h[i] = -a1 * h[i - 1]

    # envelope (level 1.0, src/video.c:4139-4147)
    rise = conf.burst_rise * IRT1090
    burst_left = round(p.pixel_rate * (conf.burst_left - conf.burst_rise / 2))
    blen = math.ceil(p.pixel_rate * (conf.burst_width + rise))
    t = np.arange(blen) / p.pixel_rate
    win = np.round(rc_window(t, rise / 2, conf.burst_width, rise)
                   * INT16_MAX).astype(np.float32)

    dmin = (round((SECAM_CB_FREQ - SECAM_FM_FREQ - 350e3) / SECAM_FM_DEV
                  * INT16_MAX),
            round((SECAM_CR_FREQ - SECAM_FM_FREQ - 506e3) / SECAM_FM_DEV
                  * INT16_MAX))
    dmax = (round((SECAM_CB_FREQ - SECAM_FM_FREQ + 506e3) / SECAM_FM_DEV
                  * INT16_MAX),
            round((SECAM_CR_FREQ - SECAM_FM_FREQ + 350e3) / SECAM_FM_DEV
                  * INT16_MAX))

    # black-level chroma values (the yuv lookup for rgb=0): y=0 so
    # u = (0 + CB-FM)/DEV, v = (0 + CR-FM)/DEV (src/video.c:3949-3953)
    u_black = round(np.clip((SECAM_CB_FREQ - SECAM_FM_FREQ) / SECAM_FM_DEV,
                            -1, 1) * INT16_MAX)
    v_black = round(np.clip((SECAM_CR_FREQ - SECAM_FM_FREQ) / SECAM_FM_DEV,
                            -1, 1) * INT16_MAX)

    return SecamStatics(
        width=p.width, active_left=p.active_left,
        active_width=p.active_width, half_width=p.half_width,
        col0=p.active_left + vframe_x, frame_w=frame_w,
        burst_left=burst_left, burst_len=blen,
        burst_win=win,
        luma_taps=luma_taps,
        chroma_taps=chroma_taps,
        iir_h=h.astype(np.float32),
        dmin=dmin, dmax=dmax,
        level_int=int(round(INT16_MAX * secam_level)),
        kd=2.0 * np.pi * SECAM_FM_DEV / (p.pixel_rate * INT16_MAX),
        w0=2.0 * np.pi * SECAM_FM_FREQ / p.pixel_rate,
        u_black=float(u_black), v_black=float(v_black),
        w0_tab=_w0_table(p.pixel_rate, p.width),
        bell_i=_bell_table(0), bell_q=_bell_table(1),
        _win_q=_win_int16(win, p.width),
        fsync_level=round(350e3 / SECAM_FM_DEV * INT16_MAX),
        pixel_rate=p.pixel_rate)


def _win_int16(win: np.ndarray, width: int) -> np.ndarray:
    wq = np.zeros(width, np.int16)
    n = min(len(win), width)
    wq[:n] = np.asarray(win[:n], np.int64).astype(np.int16)
    return wq


def _bell_table(comp: int) -> np.ndarray:
    """The reference's fm_secam_bell LUT entry `comp` for every int16
    chroma value (double math + lround, src/video.c:2172-2185,
    4122-4128).  The device program evaluates the bell analytically;
    the host-exact carrier (carrier_addin_host) looks it up here."""
    r = np.arange(-32768, 32768, dtype=np.float64)
    f = SECAM_FM_FREQ + r * SECAM_FM_DEV / INT16_MAX
    f0 = 4.286e6
    ff = f / f0 - f0 / f
    lq = 16.0 * ff
    rq = 1.26 * ff
    d = 1.0 + rq * rq
    g = (0.115 * (1.0 + lq * rq) / d if comp == 0
         else 0.115 * (lq - rq) / d)
    v = g * INT16_MAX
    q = np.where(v >= 0, np.floor(v + 0.5), -np.floor(-v + 0.5))
    return q.astype(np.int16)


def _w0_table(pixel_rate: int, width: int) -> np.ndarray:
    """Exact centre-frequency phase (mod 2pi) after c in-span samples."""
    from fractions import Fraction
    fr = Fraction(SECAM_FM_FREQ).limit_denominator(1 << 24) / pixel_rate
    c = np.arange(width + 1, dtype=np.int64)
    ang = 2.0 * np.pi * ((c * fr.numerator) % fr.denominator
                         ) / fr.denominator
    return ang.astype(np.float32)


def line_meta(p, k0: int, n: int, vframe_y: int, vframe_h: int) -> dict:
    """Host-side per-line SECAM metadata for stream lines [k0, k0+n)."""
    conf = p.conf
    dr = np.zeros(n, dtype=np.float32)
    active = np.zeros(n, dtype=bool)
    half_only = np.zeros(n, dtype=bool)
    vy = np.full(n, -1, dtype=np.int32)
    vy_prev = np.full(n, -1, dtype=np.int32)
    prev_has = np.zeros(n, dtype=bool)
    phase_pos = np.zeros(n, dtype=np.float32)   # +1 / -1 initial phase
    prev_row = np.full(n, -1, dtype=np.int32)   # index of prev secam row

    def line_of(k):
        return k % conf.lines + 1, 1 + k // conf.lines

    def active_of(k):
        line, frame = line_of(max(k, 0))
        code = sequence.line_sequence(conf.type, line)
        act = code[2] == 'a' or code[3] == 'a'
        v = sequence.active_video_line(conf.type, line)
        if v >= 0 and conf.interlaced:
            v += 1        # progressive source vs interlaced output
        v -= vframe_y
        if v < 0 or v >= vframe_h:
            v = -1
        return act, v, code, line, frame

    last_secam = -10**9
    # look back for the previous secam row before the block
    for k in range(max(k0 - 8, 0), k0):
        act, _, _, _, _ = active_of(k)
        if act:
            last_secam = k

    nfid = conf.secam_field_id_lines
    if conf.secam_field_id and not (1 <= nfid <= 9):
        nfid = 9        # src/video.c:4131-4137
    field_id = np.zeros(n, dtype=bool)

    for j in range(n):
        k = max(k0 + j, 0)
        act, v, code, line, frame = active_of(k)
        dr[j] = ((frame * conf.lines) + line) & 1
        phase_pos[j] = 1.0 if ((frame * conf.lines) + line) % 3 == 0 else -1.0
        if conf.secam_field_id and (7 <= line < 7 + nfid
                                    or 320 <= line < 320 + nfid):
            # field-identification "bottle" lines: full-span sawtooth
            # chroma, processed like active lines (src/video.c:3101-3136)
            field_id[j] = True
            active[j] = True
            half_only[j] = False
        elif act:
            active[j] = True
            half_only[j] = code[3] != 'a'
            vy[j] = v
            # previous active line of the same field (buffer cleared at
            # line 1 and hline)
            pact, pv, pcode, pline, pframe = active_of(k - 1)
            hline = (conf.lines + 1) // 2
            if pact and line not in (1, hline):
                vy_prev[j] = pv
                prev_has[j] = True
            prev_row[j] = last_secam - k0 if last_secam > -10**8 else -1
            last_secam = k
    return dict(dr=dr, active=active.astype(np.float32),
                half_only=half_only.astype(np.float32),
                vy=vy, vy_prev=vy_prev,
                prev_has=prev_has.astype(np.float32),
                phase_pos=phase_pos, prev_row=prev_row,
                field_id=field_id)


def window_meta(meta: dict, nm: dict, r0: int, r1: int, t: int) -> dict:
    """The device metadata (meta_to_device) of the block rows [r0, r1),
    one shard's window, from the block's (`nm`, its host block_meta).
    The IIR chain's rows before the window read the carried z, which
    is the end state of the last active row before r0; the window's
    `snap_row` is the last active row before block row `t` (the next
    window's first row, or the block's end), -1 for the carried z
    where that row lies before the window."""
    out = {k: v[r0:r1] for k, v in meta.items() if k != "snap_row"}
    ip = out["iir_prev"]
    out["iir_prev"] = torch.where(ip >= r0, ip - r0, -1)
    act = np.flatnonzero((nm["active"][:t] > 0) & (nm["valid"][:t] > 0))
    snap = int(act[-1]) if len(act) else -1
    out["snap_row"] = snap - r0 if snap >= r0 else -1
    return out


def block_meta(p, k0: int, n: int, nlines: int, vframe_y: int,
               vframe_h: int) -> dict:
    """`line_meta` for the rows [k0, k0+n) of a block whose first stream
    line is k0 + 1, plus the IIR chain (hacktv_tpu/encoder.py:1060-1079):
    `valid` marks rows at or after the stream start; `iir_prev[j]` is the
    active row whose end state starts row j (-1: the block's carried z);
    `snap_row` is the last active row before stream line k0 + 1 + nlines,
    whose end state seeds the next block (-1: the carried z again)."""
    nm = line_meta(p, k0, n, vframe_y, vframe_h)
    ks = k0 + np.arange(n)
    nm["valid"] = (ks >= 0).astype(np.float32)
    iir_prev = np.full(n, -1, np.int32)
    snap_row = -1
    last = -1
    for j in range(n):
        if nm["active"][j] > 0 and ks[j] >= 0:
            iir_prev[j] = last
            last = j
            if j < nlines:
                snap_row = j
    nm["iir_prev"] = iir_prev
    nm["snap_row"] = np.int32(snap_row)
    return nm


_IIR_B0, _IIR_B1, _IIR_A1 = 2.90456054, -2.80912108, -0.90456054
_IIR_R = -_IIR_A1                      # y[n] = b0 x[n] + c1 z[n-1]
_IIR_C1 = _IIR_B1 - _IIR_A1 * _IIR_B0  # z[n] = x[n] + r z[n-1]
# the f32 constants of the IIR, the carrier and the bell, as both versions
# of the device program take them
_B0_32 = float(np.float32(_IIR_B0))
_C1_32 = float(np.float32(_IIR_C1))
_K_DEV = float(np.float32(SECAM_FM_DEV / INT16_MAX))
_FM_FREQ_32 = float(np.float32(SECAM_FM_FREQ))
_INV_F0 = float(np.float32(1.0 / 4.286e6))
_F0_32 = float(np.float32(4.286e6))
_K126 = float(np.float32(1.26))
_DEN_NUM = float(np.float32(np.float32(0.115) * INT16_MAX))


def _scan_steps(W: int) -> list:
    """(shift, f32 factor r^shift) of each step of the IIR's doubling
    scan over rows of width W."""
    steps, shift, rr = [], 1, _IIR_R
    while shift < min(W, 1024) and rr > 1e-30:
        steps.append((shift, float(np.float32(rr))))
        rr *= rr
        shift *= 2
    return steps


def _fid_rows(st: SecamStatics, W: int) -> np.ndarray:
    """Static field-ID sawtooth rows [2, W] (f64-exact): row 0 = D'b
    (18 us ramp down), row 1 = D'r (15 us ramp up)
    (src/video.c:3101-3136)."""
    x = np.arange(W, dtype=np.float64) - st.active_left
    rows = np.empty((2, W), np.float32)
    for comp, rw in ((False, 18e-6), (True, 15e-6)):
        t = np.clip(x / st.pixel_rate / rw, 0.0, 1.0)
        level = st.v_black if comp else st.u_black
        dev = st.fsync_level if comp else -st.fsync_level
        rows[int(comp)] = np.trunc(level + dev * t).astype(np.float32)
    return rows


def device_consts(st: SecamStatics, W: int) -> dict:
    """Host numpy constants of the device chroma program
    (hacktv_tpu's `_device_consts`): the IIR's powers r^1..r^W, the
    centre-frequency phase and the burst window per column, the field-ID
    rows."""
    sl = st.burst_left
    r_pow = np.power(np.float64(_IIR_R),
                     np.arange(1, W + 1, dtype=np.float64))
    r_pow[r_pow < 1e-38] = 0.0
    w0_col = np.zeros(W, np.float32)
    n = np.arange(sl, W) - sl + 1
    w0_col[sl:] = st.w0_tab[n]
    win_col = np.zeros(W, np.float32)
    win_col[sl:] = np.asarray(st._win_q[: W - sl], np.float32)
    return dict(r_pow=r_pow.astype(np.float32), w0_col=w0_col,
                win_col=win_col, fid=_fid_rows(st, W))


@dataclass
class SecamDevice:
    """The statics that the device program reads, as tensors on the
    encoder's device, and its host constants."""
    st: SecamStatics
    chroma_tq: tuple            # int Q15 chroma taps (host ints)
    luma_w: torch.Tensor        # f64 [1, 1, 51] luma taps, reversed
    r_pow: torch.Tensor         # f32 [W]
    w0_col: torch.Tensor        # f32 [W]
    win_col: torch.Tensor       # f32 [W]
    fid: torch.Tensor           # f32 [2, W]
    # the carrier phase can pass 120 rad (the field-ID lines): cos/sin
    # take glibc's large-argument reduction too
    large: bool = False
    # the kernel's host constants (kernel_consts)
    kconst: tuple = None


def to_device(st: SecamStatics, device, consts: dict | None = None,
              large: bool = False) -> SecamDevice:
    """The device program's statics on `device`; `consts` replaces the
    constants that device_consts(st) would build (convert.py); `large`
    marks phases past 120 rad (SecamDevice.large)."""
    dc = consts if consts is not None else device_consts(st, st.width)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)
    tq = np.round(np.asarray(st.chroma_taps, np.float64) * 32768.0
                  ).astype(np.int64)
    lq = np.round(np.asarray(st.luma_taps, np.float64) * 32768.0)
    # _line_conv's sums stay inside int32 as the reference's (and the JAX
    # package's) int32 accumulator has them: |sum| <= sum|tap| * 32768
    assert np.abs(lq).sum() * 32768 < 2 ** 31
    return SecamDevice(
        st=st, chroma_tq=tuple(int(v) for v in tq),
        luma_w=t(lq[::-1].astype(np.float64)).view(1, 1, -1),
        r_pow=t(dc["r_pow"]), w0_col=t(dc["w0_col"]),
        win_col=t(dc["win_col"]), fid=t(dc["fid"]), large=large,
        kconst=kernel_consts(st, tq, lq))


def meta_to_device(nm: dict, device) -> dict:
    """A block's SECAM metadata (block_meta) as tensors; `snap_row`
    stays a host int."""
    out = {k: torch.as_tensor(np.ascontiguousarray(v), device=device)
           for k, v in nm.items() if k != "snap_row"}
    out["snap_row"] = int(nm["snap_row"])
    return out


def _slice_fir_int(x: torch.Tensor, taps: tuple) -> torch.Tensor:
    """Q15 FIR over each row with zero edges: int32 accumulate of the
    shifted slices, arithmetic >> 15, int16 saturate (the reference's
    fir_int16, src/fir.c:342-346)."""
    B, W = x.shape
    nt = len(taps)
    pad = nt // 2
    xp = F.pad(x, (pad, pad))
    acc = torch.zeros((B, W), dtype=torch.int32, device=x.device)
    for t in range(nt):
        # out[i] = sum_k x[k] * taps[i + pad - k]  ->  slice offset
        acc += taps[nt - 1 - t] * xp[:, t: t + W]
    return torch.clamp(acc >> 15, -32768, 32767)


def device_chroma_carrier(sd: SecamDevice, meta: dict, u: torch.Tensor,
                          v: torch.Tensor, z_prev: torch.Tensor):
    """SECAM chroma + FM carrier for one block of rows [B, W].

      - vertical averaging / field-ID bottles: row gathers + static rows
      - chroma low-pass: exact int32 Q15 FIR (shifted slices)
      - HF pre-emphasis IIR (f64 serial in the reference,
        src/fir.c:710-740): y[n] = b0 x[n] + c1 z[n-1] with
        z[n] = x[n] + r z[n-1], an order-1 linear recurrence computed as
        a log-depth doubling scan; the cross-line/cross-block carry is
        the single scalar z at the previous active line's end (r^W
        underflows to 0, so row ends are local)
      - FM carrier (int32 phasor LUT walk, src/video.c:2278-2297): closed
        form, phase = w0*(n+1) [exact mod-2pi table] + kd*cumsum(chroma)
        [exact int32], with the reference's >>16/>>15 floor chain in f32
      - anti-cloche bell: evaluated per sample (the reference's
        65536-entry LUT is a function of the chroma value,
        src/video.c:2172-2185)

    `z_prev` is an f32 device scalar.  Returns (carrier add f32 [B, W],
    the next block's z as an f32 device scalar); nothing waits for the
    card."""
    st = sd.st
    W = st.width
    dev = u.device
    f32 = torch.float32
    B = meta["dr"].shape[0]
    H, fw = u.shape
    dr = meta["dr"] > 0
    act = (meta["active"] > 0) & (meta["valid"] > 0)

    # ---- vertical average (trunc) --------------------------------------
    P = torch.cat([u, torch.full((1, fw), st.u_black, dtype=f32, device=dev),
                   v, torch.full((1, fw), st.v_black, dtype=f32, device=dev)])
    off = torch.where(dr, H + 1, 0)
    vy, vyp = meta["vy"].long(), meta["vy_prev"].long()
    vy_s = torch.where((vy >= 0) & (vy < H), vy, H) + off
    vyp_s = torch.where((vyp >= 0) & (vyp < H), vyp, H) + off
    cur = P[vy_s]
    prv = P[vyp_s] * meta["prev_has"][:, None]
    avg = torch.trunc((cur + prv) * 0.5)

    blackv = torch.where(dr, st.v_black, st.u_black).to(f32)[:, None]
    pad_r = W - st.col0 - fw
    if pad_r < 0:
        avg = avg[:, : fw + pad_r]
        pad_r = 0
    lines = F.pad(avg - blackv, (st.col0, pad_r)) + blackv
    lines = torch.where(meta["field_id"][:, None], sd.fid[dr.long()], lines)

    # ---- chroma low-pass FIR (exact int32) -----------------------------
    x = _slice_fir_int(lines.to(torch.int32), sd.chroma_tq).to(f32)

    # ---- HF pre-emphasis IIR as a doubling scan ------------------------
    # each step z + rr * shift(z) is one fused multiply-add, as XLA's CPU
    # compiler emits it; the shifted-in zeros leave z as it is
    z = x
    for shift, rr in _scan_steps(W):
        zs = F.pad(z[:, :W - shift], (shift, 0))
        z = fma32(zs, rr, z)
    z_end = z[:, -1]
    iir_prev = meta["iir_prev"].long()
    zp = torch.where(iir_prev >= 0, z_end[torch.clamp(iir_prev, 0, B - 1)],
                     z_prev)
    # zc = z + r_pow * zp, fused
    zc = fma32(sd.r_pow[None, :], zp[:, None], z)
    z_nm1 = torch.cat([zp[:, None], zc[:, :-1]], dim=1)
    # y = b0*x + c1*z[n-1]: the first product fused, the second rounded
    y = fma32(x, _B0_32, z_nm1 * _C1_32)
    y = torch.clamp(y, -32768.0, 32767.0)
    y = torch.where(y >= 0, torch.floor(y + 0.5), -torch.floor(0.5 - y))
    dmin = torch.where(dr, st.dmin[1], st.dmin[0]).to(f32)[:, None]
    dmax = torch.where(dr, st.dmax[1], st.dmax[0]).to(f32)[:, None]
    c = torch.minimum(torch.maximum(y, dmin), dmax)

    snap = meta["snap_row"]
    z_snap = z_end[snap] if snap >= 0 else z_prev

    # ---- FM carrier (closed-form phase) --------------------------------
    sl = st.burst_left
    cols = torch.arange(W, device=dev)[None, :]
    sr = torch.where(act, torch.where(meta["half_only"] > 0, st.half_width,
                                      min(sl + st.burst_len, W)), 0)
    span = (cols >= sl) & (cols < sr[:, None])
    ci = c.to(torch.int32)
    S = torch.cumsum(torch.where(cols >= sl, ci, 0), dim=1,
                     dtype=torch.int32)
    # w0_col + kd*S, fused; S < 2^24 is exact in f32
    phase = fma32(S.to(f32), float(np.float32(st.kd)), sd.w0_col[None, :])
    sin, cos = _sincosf_glibc(phase, large=sd.large)
    sign = torch.where(meta["phase_pos"] > 0, 1.0, -1.0)[:, None]
    pi_ = torch.clamp(torch.floor(sign * cos * 32768.0), max=32767.0)
    pq_ = torch.clamp(torch.floor(sign * sin * 32768.0), max=32767.0)
    lvl = float(np.float32(st.level_int / 32768.0))
    vi = torch.floor(pi_ * lvl)
    vq = torch.floor(pq_ * lvl)
    # analytic anti-cloche bell, lround-quantised like the LUT.  A
    # constant over a tensor is written as a division of two tensors:
    # torch computes `float / tensor` as a reciprocal times the constant,
    # which rounds twice
    const = lambda a: torch.full_like(c, a)
    f = fma32(c, _K_DEV, const(_FM_FREQ_32))
    ff = fma32(f, _INV_F0, -torch.div(const(_F0_32), f))
    rq = ff * _K126
    den = torch.div(const(_DEN_NUM), fma32(rq, rq, torch.ones_like(rq)))
    ff16 = ff * 16.0
    gi_f = fma32(ff16, rq, torch.ones_like(rq)) * den
    gq_f = (ff16 - rq) * den
    lround = lambda a: torch.where(a >= 0, torch.floor(a + 0.5),
                                   -torch.floor(0.5 - a))
    gi = lround(gi_f)
    gq = lround(gq_f)
    inv15 = 1.0 / 32768.0
    m = torch.floor(vi * gi * inv15) - torch.floor(vq * gq * inv15)
    o = torch.floor(m * sd.win_col[None, :] * inv15)
    return torch.where(span, o, 0.0), z_snap


def chroma_block_host(st: SecamStatics, W: int, meta: dict,
                      u: np.ndarray, v: np.ndarray, k_first: int,
                      k_snapshot: int, state, cache: dict | None = None):
    """Host-exact SECAM chroma baseband for one block's rows, through the
    native runtime.

    The reference bit for bit: vertical averaging with C truncation
    (src/video.c:3149-3196), the Q15 chroma FIR with int32 accumulate
    >>15 (src/fir.c:342-346, rt_fir_block_i16), the order-1 HF
    pre-emphasis IIR in f64 with the stream-carried (ix, iy) state
    (src/fir.c:710-740, rt_iir1_exact_i16), lround and the deviation
    clamps.  Rows with stream index < 0 (block 0's leading halo) emit
    zeros and do not advance the IIR.  The stage before the IIR depends
    only on the source planes and the line-number phase, so with `cache`
    it is kept per (planes, phase).  Returns (chroma int16 [B, W], the
    IIR state at stream line k_snapshot, the state after the block)."""
    B = len(meta["dr"])
    H, fw = u.shape
    ks = k_first + np.arange(B)
    rows = np.nonzero((meta["active"] > 0) & (ks >= 0))[0]
    out = np.zeros((B, W), dtype=np.int16)
    if len(rows) == 0:
        return out, state, state

    ckey = None
    if cache is not None:
        ckey = (id(u), id(v), k_first % (2 * 625), B)
        hit = cache.get(ckey)
        if hit is not None:
            return _chroma_iir_finish(st, out, rows, ks, hit[0], hit[1],
                                      k_snapshot, state)

    # gather + vertical average for all active rows at once (one index
    # into the stacked U/V planes; f32 is exact for int16 values)
    dr = meta["dr"][rows] > 0
    blackv = np.where(dr, st.v_black, st.u_black).astype(np.float32)
    P = np.concatenate([
        np.asarray(u, np.float32), np.full((1, fw), st.u_black, np.float32),
        np.asarray(v, np.float32), np.full((1, fw), st.v_black, np.float32)])
    off = np.where(dr, H + 1, 0)
    vy, vyp = meta["vy"][rows], meta["vy_prev"][rows]
    cur = P[np.where((vy >= 0) & (vy < H), vy, H) + off]
    prv = P[np.where((vyp >= 0) & (vyp < H), vyp, H) + off] \
        * (meta["prev_has"][rows] > 0)[:, None].astype(np.float32)
    avg = np.trunc((cur + prv) * np.float32(0.5))

    lines = np.empty((len(rows), W), np.int16)
    lines[:] = blackv[:, None].astype(np.int16)
    lines[:, st.col0:st.col0 + fw] = avg
    fid = meta["field_id"][rows]
    if fid.any():
        # field-ID sawtooth (src/video.c:3101-3136): level + dev*t with
        # t = clip((x - active_left)/rate/rw, 0, 1); C assignment to int16
        # truncates toward zero
        x = np.arange(W, dtype=np.float64) - st.active_left
        for comp, rw in ((True, 15e-6), (False, 18e-6)):
            rsel = fid & (dr == comp)
            if not rsel.any():
                continue
            t = np.clip(x / st.pixel_rate / rw, 0.0, 1.0)
            level = st.v_black if comp else st.u_black
            dev = st.fsync_level if comp else -st.fsync_level
            lines[rsel] = np.trunc(level + dev * t).astype(np.int16)
    # the Q15 FIR with zero edges, threaded over the rows
    taps = np.ascontiguousarray(np.round(
        np.asarray(st.chroma_taps, np.float64) * 32768.0).astype(np.int32))
    f = np.empty((len(rows), W), np.int16)
    runtime.load().rt_fir_block_i16(
        runtime.ptr(lines), len(rows), W, runtime.ptr(taps), len(taps),
        runtime.ptr(f), runtime.threads())
    if ckey is not None:
        if len(cache) > 4:
            cache.clear()
        # the planes stay referenced so that their ids are not reused
        # while the entry lives
        cache[ckey] = (f, dr, u, v)
    return _chroma_iir_finish(st, out, rows, ks, f, dr, k_snapshot, state)


def _chroma_iir_finish(st, out, rows, ks, f, dr, k_snapshot, state):
    """The serial f64 IIR over the FIR output of the active rows, in
    stream order, snapshotting its state before stream line k_snapshot;
    then the deviation clamps."""
    lib = runtime.load()
    W = out.shape[1]
    n_act = len(rows)
    iir_state = np.array(state, np.float64)
    yq = np.empty((n_act, W), np.int16)
    n_before = int(np.searchsorted(ks[rows], k_snapshot))
    if n_before:
        lib.rt_iir1_exact_i16(runtime.ptr(f), n_before * W, _IIR_B0,
                              _IIR_B1, _IIR_A1, runtime.ptr(iir_state),
                              runtime.ptr(yq))
    snap = (float(iir_state[0]), float(iir_state[1]))
    if n_before < n_act:
        f2 = f.reshape(-1)[n_before * W:]
        y2 = yq.reshape(-1)[n_before * W:]
        lib.rt_iir1_exact_i16(runtime.ptr(f2), (n_act - n_before) * W,
                              _IIR_B0, _IIR_B1, _IIR_A1,
                              runtime.ptr(iir_state), runtime.ptr(y2))
    dmin = np.where(dr, st.dmin[1], st.dmin[0]).astype(np.int16)
    dmax = np.where(dr, st.dmax[1], st.dmax[0]).astype(np.int16)
    np.clip(yq, dmin[:, None], dmax[:, None], out=yq)
    out[rows] = yq
    return out, snap, (float(iir_state[0]), float(iir_state[1]))


def carrier_lut(st: SecamStatics, pixel_rate: int) -> np.ndarray:
    """The reference's per-chroma-value int32 phasor LUT
    (src/video.c:2234-2240, built for the SECAM cgain modulator)."""
    r = np.arange(-32768, 32768, dtype=np.float64)
    d = 2.0 * np.pi / pixel_rate * (SECAM_FM_FREQ
                                    + r * SECAM_FM_DEV / INT16_MAX)
    M = 2147483647.0
    q = lambda x: np.where(x >= 0, np.floor(x + 0.5), -np.floor(-x + 0.5))
    lut = np.empty((65536, 2), np.int32)
    lut[:, 0] = q(np.cos(d) * M)
    lut[:, 1] = q(np.sin(d) * M)
    return np.ascontiguousarray(lut)


def carrier_addin_host(st: SecamStatics, W: int, meta: dict,
                       chroma: np.ndarray, lut: np.ndarray) -> np.ndarray:
    """The exact SECAM chroma carrier add-in, int16 [B, W], from the
    native per-line int32 recurrence (rt_secam_carrier_exact)."""
    B = chroma.shape[0]
    sl = st.burst_left
    sr = np.where(meta["active"] > 0,
                  np.where(meta["half_only"] > 0, st.half_width,
                           sl + st.burst_len), 0).astype(np.int32)
    sign = np.where(meta["phase_pos"] > 0, 1, -1).astype(np.int8)
    bell = np.ascontiguousarray(np.stack([st.bell_i, st.bell_q], axis=-1))
    ch = np.ascontiguousarray(chroma, dtype=np.int16)
    win = np.ascontiguousarray(st._win_q, dtype=np.int16)
    out = np.empty((B, W), np.int16)
    p = runtime.ptr
    runtime.load().rt_secam_carrier_exact(
        p(ch), B, W, sl, p(sr), p(sign), p(lut), p(bell), st.level_int,
        p(win), p(out), runtime.threads())
    return out


def _line_conv(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Q15 FIR over each row, bit-exact against the reference's
    fir_int16 (src/fir.c:342-346): int32 accumulate of int16 x int16
    products, arithmetic >> 15.  As one f64 conv1d: every product is an
    integer below 2^31 and every partial sum below 2^31 (to_device checks
    sum|tap| * 32768 < 2^31), far inside f64's 2^53, so any summation
    order gives the exact sum; round() guards against an algorithm (an
    FFT) that is not exact.  `w` holds the integer taps reversed."""
    pad = w.shape[-1] // 2
    xp = F.pad(x.to(torch.int32).to(torch.float64)[:, None, :], (pad, pad))
    acc = torch.round(F.conv1d(xp, w)[:, 0]).to(torch.int64)
    return torch.clamp(acc >> 15, -32768, 32767).to(torch.float32)


def render(sd: SecamDevice, out: torch.Tensor, carrier_add: torch.Tensor,
           meta: dict, luma: bool = True) -> torch.Tensor:
    """SECAM line processing: the luma band-reject over the active
    segment (where `luma`; not on S-Video's C channel), plus the chroma
    carrier."""
    if not luma:
        return out + carrier_add
    st = sd.st
    B, W = out.shape
    cols = torch.arange(W, device=out.device)[None, :]
    act = meta["active"][:, None] > 0

    # luma band-reject over the active segment (zero history at segment
    # start, real samples beyond its end: src/video.c:3206)
    seg = (cols >= st.active_left) & (cols < st.active_left + st.active_width)
    luma_masked = torch.where(cols >= st.active_left, out, 0.0)
    luma_f = _line_conv(sd.luma_w, luma_masked)
    out = torch.where(seg & act, luma_f, out)
    return out + carrier_add


# ---- the chroma program and render as one kernel (csrc/secam_chroma.cu) --
# the kernel's constants, in the order of its FConst and IConst enums
_N_STEPS = 16           # kMaxSteps
_I_H, _I_FW = 1, 2      # set at each launch from the planes' shape
_N_FC, _N_IC, _N_PTRS = 44, 116, 20
_kfn = None             # secam_chroma_launch, bound at the first call


def kernel_consts(st: SecamStatics, chroma_tq, luma_q) -> tuple:
    """(f64 [_N_FC], int64 [_N_IC]) host arrays of the kernel's constants:
    the f32 constants exactly as the plain program rounds them, the scan's
    steps, the integer taps in accumulation order (reversed) and glibc's
    tables."""
    W = st.width
    steps = _scan_steps(W)
    pad = [0.0] * (_N_STEPS - len(steps))
    fc = np.array([
        st.u_black, st.v_black, st.dmin[0], st.dmin[1], st.dmax[0],
        st.dmax[1], _B0_32, _C1_32, float(np.float32(st.kd)),
        float(np.float32(st.level_int / 32768.0)), _K_DEV, _FM_FREQ_32,
        _INV_F0, _F0_32, _K126, _DEN_NUM, synth._SC_HPI_INV,
        synth._SC_HPI_HI, synth._SC_HPI_LO, synth._SC_PI63, *synth._SC_C,
        *synth._SC_S, *(rr for _, rr in steps), *pad], np.float64)
    ic = np.array([
        W, 0, 0, st.col0, st.active_left, st.active_left + st.active_width,
        st.half_width, st.burst_left, min(st.burst_left + st.burst_len, W),
        len(steps), *(sh for sh, _ in steps), *[0] * len(pad),
        *chroma_tq[::-1], *np.asarray(luma_q, np.int64)[::-1],
        *synth._INV_PIO4], np.int64)
    assert len(fc) == _N_FC and len(ic) == _N_IC
    return fc, ic


def bind():
    """The kernel's launch function, built and bound at the first call
    (an encoder on a card calls it at set-up)."""
    global _kfn
    if _kfn is None:
        fn = cuda_build.load("secam_chroma").secam_chroma_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _kfn = fn
    return _kfn


# the kernel's pointers (its Ptr enum): (where, key, dtype)
_F32, _I32 = torch.float32, torch.int32
_KERNEL_META = (("dr", _F32), ("active", _F32), ("valid", _F32),
                ("half_only", _F32), ("vy", _I32), ("vy_prev", _I32),
                ("prev_has", _F32), ("phase_pos", _F32),
                ("field_id", torch.bool), ("iir_prev", _I32))


def _chroma_kernel(sd: SecamDevice, meta: dict, u, v, z_prev, block,
                   luma: bool):
    st = sd.st
    B, W = block.shape
    if W != st.width or u.shape != v.shape or u.dim() != 2:
        raise ValueError(f"secam kernel: rows of {W} samples (needs "
                         f"{st.width}) or planes {tuple(u.shape)} and "
                         f"{tuple(v.shape)}")
    ts = [u.contiguous(), v.contiguous(), sd.fid, sd.r_pow, sd.w0_col,
          sd.win_col]
    want = [_F32] * 6
    for k, dt in _KERNEL_META:
        if meta[k].shape != (B,):
            raise ValueError(f"secam kernel: meta[{k!r}] has shape "
                             f"{tuple(meta[k].shape)}, not ({B},)")
        ts.append(meta[k].contiguous())
        want.append(dt)
    out = torch.empty_like(block, memory_format=torch.contiguous_format)
    z_end = torch.empty(B, dtype=_F32, device=block.device)
    ts += [z_prev, block.contiguous(), out, z_end]
    want += [_F32] * 4
    for i, (t, dt) in enumerate(zip(ts, want, strict=True)):
        if t.dtype != dt or t.device != block.device:
            raise ValueError(f"secam kernel: pointer {i} is {t.dtype} on "
                             f"{t.device}, needs {dt} on {block.device}")
    fc, ic = sd.kconst
    ic = ic.copy()
    ic[_I_H], ic[_I_FW] = u.shape
    ptrs = (ctypes.c_void_p * _N_PTRS)(*(t.data_ptr() for t in ts))
    fn = bind()
    with torch.cuda.device(block.device):
        stream = torch.cuda.current_stream(block.device).cuda_stream
        err = fn(ptrs, _N_PTRS, fc.ctypes.data, _N_FC, ic.ctypes.data,
                 _N_IC, B, int(luma), stream)
    if err:
        raise RuntimeError(f"secam kernel launch failed: CUDA error {err}")
    snap = meta["snap_row"]
    return out, (z_end[snap] if snap >= 0 else z_prev)


def chroma_render(sd: SecamDevice, meta: dict, u: torch.Tensor,
                  v: torch.Tensor, z_prev: torch.Tensor, block: torch.Tensor,
                  luma: bool = True):
    """The device chroma program over one window's rows, added to `block`
    [B, W] as `render` adds it.  Returns (the rows, the next z).  On
    the CPU the plain version (device_chroma_carrier, then render); on a
    card the kernel of csrc/secam_chroma.cu, byte for byte the same,
    counted in "secam.kernel_windows"; any other device raises."""
    if block.device.type == "cpu":
        with telemetry.span("dispatch.step.secam.chroma"):
            add, z = device_chroma_carrier(sd, meta, u, v, z_prev)
        with telemetry.span("dispatch.step.secam.render"):
            return render(sd, block, add, meta, luma), z
    if block.device.type != "cuda":
        raise ValueError(f"secam kernel: unsupported device {block.device}")
    with telemetry.span("dispatch.step.secam.chroma"):
        out = _chroma_kernel(sd, meta, u, v, z_prev, block, luma)
    telemetry.count("secam.kernel_windows")
    return out
