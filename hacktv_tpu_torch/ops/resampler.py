"""Rational polyphase int16 resampler (src/fir.c:263-428): the video
resampler of `--pixelrate`, and (StreamResampler, on the host) the
hardware sinks' audio side-channels.

Port of hacktv_tpu/ops/resampler.py.  Output m (0-based, stream-absolute)
reads the A most recent inputs after i(m) = floor(m*M / L) + 1 inputs
have been consumed, with the polyphase bank row d(m) = (m*M) mod L:

    y[m] = clamp( ( sum_y  x[i(m) - A + y] * T[d(m), y] ) >> 15 )

(x[<0] = 0: the reference starts with a zeroed window).  i(m) and d(m)
are periodic in m with period P = L/gcd(L, M), so a block's outputs fall
into P classes, each a strided window over the input.

The device step computes what the JAX package's does: the composite is
rounded (half to even) and clipped to int16, each window sum accumulates
in int32 with wraparound (XLA's integer dot and its per-tap adds), then
the arithmetic >> 15 and the clip.  Here the sums run in int64, where
they are exact (|sum| < 22 * 2^30), one tap at a time over every class
at once, and are wrapped to int32 at the end: modular addition gives the
same result in any order.  No [P, G, A] window stack is built: at 64
frames of PAL-I it would hold 40.96 M x 22 entries.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

from . import firdes


@dataclass
class Resampler:
    L: int                 # interpolation
    M: int                 # decimation
    A: int                 # ataps (window length)
    T: np.ndarray          # [L, A] int16-valued polyphase bank (int64)

    @classmethod
    def create(cls, out_rate, in_rate) -> "Resampler":
        """out_rate/in_rate as (num, den) tuples or ints
        (src/fir.c:392-428)."""
        on, od = out_rate if isinstance(out_rate, tuple) else (int(out_rate), 1)
        inn, ind = in_rate if isinstance(in_rate, tuple) else (int(in_rate), 1)
        num, den = on * ind, inn * od
        g = math.gcd(num, den)
        L, M = num // g, den // g

        ntaps = (21 * L) | 1
        if L > M:
            taps = firdes.low_pass(ntaps, L, 0.45, 0.1, L)
        else:
            taps = firdes.low_pass(ntaps, L, 0.45 * L / M, 0.1 * L / M, L)
        return cls(L=L, M=M, A=-(-ntaps // L),
                   T=_polyphase_bank(taps, ntaps, L))

    def output_size(self, samples: int) -> int:
        """Max outputs from `samples` inputs (src/fir.c:381-386)."""
        return (samples * self.L + self.M - 1) // self.M

    def n_outputs_exact(self, n_in: int) -> int:
        """Outputs the stream has produced once exactly n_in inputs have
        been consumed from its start: #{m : i(m) <= n_in}."""
        if n_in <= 0:
            return 0
        return (n_in * self.L - 1) // self.M + 1

    def resample_block(self, x: np.ndarray, m0: int = 0,
                       n_out: int | None = None) -> np.ndarray:
        """Host reference: outputs [m0, m0+n_out) of the stream whose
        inputs are x (x[0] = stream input 0)."""
        if n_out is None:
            n_out = self.n_outputs_exact(len(x)) - m0
        m = m0 + np.arange(n_out, dtype=np.int64)
        i = (m * self.M) // self.L + 1
        d = (m * self.M) % self.L
        idx = i[:, None] - self.A + np.arange(self.A)[None, :]
        xx = np.concatenate([np.zeros(self.A, np.int64),
                             np.asarray(x, np.int64)])
        win = xx[np.clip(idx + self.A, 0, len(xx) - 1)]
        win[idx + self.A >= len(xx)] = 0
        acc = np.sum(win * self.T[d].astype(np.int64), axis=1)
        return np.clip(acc >> 15, -32768, 32767).astype(np.int16)


class StreamResampler:
    """Stateful host-side streaming wrapper with the reference's
    fir_int16 feed/process semantics (src/fir.c:298-352): feed chunks of
    int16 inputs, receive every output whose window is complete, exact in
    int64 whatever the chunking.  The sinks' audio side-channels use it
    (32 kHz to rate/64 for HackDAC, the S/PDIF bitstream to the DAC rate;
    src/rf_hackrf.c:456-472, src/rf_fl2k.c:192-248)."""

    def __init__(self, rs: Resampler):
        self.rs = rs
        self._hist = np.zeros(rs.A, np.int64)   # the last A inputs fed
        self.n_in = 0
        self.m = 0

    def process(self, x: np.ndarray) -> np.ndarray:
        rs = self.rs
        x = np.asarray(x, np.int64).reshape(-1)
        n1 = self.n_in + len(x)
        m1 = rs.n_outputs_exact(n1)
        n_out = m1 - self.m
        if n_out <= 0:
            self._hist = np.concatenate([self._hist, x])[-rs.A:]
            self.n_in = n1
            return np.zeros(0, np.int16)
        m = self.m + np.arange(n_out, dtype=np.int64)
        i = (m * rs.M) // rs.L + 1
        d = (m * rs.M) % rs.L
        # window inputs [i - A, i) of buf = the history (inputs
        # n_in - A .. n_in) and the new chunk
        buf = np.concatenate([self._hist, x])
        base = self.n_in - rs.A                  # buf[0]'s input index
        idx = i[:, None] - rs.A + np.arange(rs.A)[None, :] - base
        win = buf[np.clip(idx, 0, len(buf) - 1)]
        win[idx < 0] = 0                         # the pre-stream zeros
        acc = np.sum(win * rs.T[d].astype(np.int64), axis=1)
        self._hist = buf[-rs.A:]
        self.n_in = n1
        self.m = m1
        return np.clip(acc >> 15, -32768, 32767).astype(np.int16)


def _polyphase_bank(taps: np.ndarray, ntaps: int, L: int) -> np.ndarray:
    """Tap placement of fir_int16_init (src/fir.c:276-287): the integer
    taps laid out as [L, A] rows applied window-oldest-first."""
    A = -(-ntaps // L)
    flat = np.zeros(L * A, dtype=np.int64)
    j = L * A - A
    for i in range(ntaps - 1, -1, -1):
        flat[j] = int(np.round(taps[i] * 32767.0))
        j -= A
        if j < 0:
            j += L * A + 1
    return flat.reshape(L, A)


@dataclass
class BlockResampleStatics:
    """Per-encoder constants of the block resample.  With aligned widths
    (W_out * M == W_px * L, and L dividing a block's outputs) the class
    window offsets and bank rows are the same for every block."""
    rs: Resampler
    x_lo: int            # start of the slice of the pixel-domain flat
    x_len: int
    n_out: int
    stride: int
    G: int
    offq: np.ndarray     # [P] window offsets: row (of `stride` inputs)
    offr: np.ndarray     # [P] and column
    Td: np.ndarray       # [P, A] int32 bank row of each class
    # the window starts and bank rows as tensors, per device
    _dev: dict = field(default_factory=dict, repr=False, compare=False)


def make_block_statics(rs: Resampler, w_px: int, w_out: int,
                       nlines: int, halo_lines: int = 1
                       ) -> BlockResampleStatics:
    """Resample statics for blocks of `nlines` lines with one leading and
    `halo_lines` trailing halo lines in both domains.  The flat
    pixel-domain input starts at line k0-1."""
    L, M, A = rs.L, rs.M, rs.A
    if w_out * M != w_px * L:
        raise ValueError(
            f"pixel/sample widths {w_px}/{w_out} are not in the exact "
            f"rational ratio {M}/{L}; block resampling needs aligned "
            "line widths")
    n_out = (nlines + 1 + halo_lines) * w_out     # incl. halo lines
    if (nlines * w_out) % L:
        raise ValueError("block output size must be a multiple of the "
                         "interpolation factor for stable phase")
    P = L // math.gcd(L, M)
    stride = P * M // L
    G = -(-n_out // P)

    # The reference's vresampler line window delays its output by one
    # line, and vid_next_line swallows that warm-up line
    # (src/video.c:4941-4947): stream output sample g is polyphase output
    # m = g + w_out.  Block b's leading halo line (stream line k0-1) so
    # starts at m = k0 * w_out; with x[0] = pixel input (k0-1)*w_px and
    # the alignment conditions the class offsets below are the same for
    # every block (computed here for b = 0).
    m = np.arange(P, dtype=np.int64)
    iP = (m * M) // L + 1
    dP = (m * M) % L
    base = 1 - A
    start0 = iP - A - base
    assert start0.min() >= 0
    x_lo = int(base + w_px)         # index into the flat starting at -w_px
    rows = -(-(int(start0.max()) + (G - 1) * stride + A) // stride) + 1
    return BlockResampleStatics(
        rs=rs, x_lo=x_lo, x_len=rows * stride, n_out=n_out, stride=stride,
        G=G, offq=(start0 // stride).astype(np.int64),
        offr=(start0 % stride).astype(np.int64),
        Td=rs.T[dP].astype(np.int32))


def _device_consts(st: BlockResampleStatics, device):
    """(window start of each class, bank as int64 [P, A]) on `device`."""
    key = str(device)
    hit = st._dev.get(key)
    if hit is None:
        b0 = st.offq * st.stride + st.offr
        hit = (torch.as_tensor(b0.astype(np.int64), device=device),
               torch.as_tensor(st.Td.astype(np.int64), device=device))
        st._dev[key] = hit
    return hit


def device_resample_block(st: BlockResampleStatics,
                          flat: torch.Tensor) -> torch.Tensor:
    """flat: f32 pixel-domain stream starting at line k0-1.  Returns the
    int16-valued f32 [st.n_out] stream at the output rate, starting at
    output line k0-1."""
    x = torch.clamp(torch.round(flat), -32768, 32767).to(torch.int32)
    x = x[st.x_lo: st.x_lo + st.x_len]
    A, stride, G = st.rs.A, st.stride, st.G
    need = st.x_len
    if A > stride:
        # windows overlap across rows (a decimating resample with a small
        # interpolation factor, e.g. L/M = 1/2): the per-tap reads run
        # up to a row and a window past the slice, over zeros
        need += stride + A
    if x.shape[0] < need:
        x = torch.cat([x, x.new_zeros(need - x.shape[0])])
    b0, taps = _device_consts(st, flat.device)
    # class c's window at row g starts at input g * stride + b0[c]: as
    # rows of `stride` inputs, the classes are columns of one strided view
    span = int((st.offq * stride + st.offr).max()) + A
    assert (G - 1) * stride + span <= x.shape[0]
    rows = x.as_strided((G, span), (stride, 1))
    acc = None
    for a in range(A):
        term = rows.index_select(1, b0 + a) * taps[:, a]      # int64 [G, P]
        acc = term if acc is None else acc.add_(term)
    # the int32 accumulator's wraparound, then the arithmetic shift
    acc = ((acc + 2 ** 31) & 0xFFFFFFFF) - 2 ** 31
    y = torch.clamp(acc.reshape(-1)[:st.n_out] >> 15, -32768, 32767)
    return y.to(torch.float32)
