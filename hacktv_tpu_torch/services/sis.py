"""SiS (Sound-in-Syncs, "dcsis") encoder (src/sis.c; port of
hacktv_tpu/services/sis.py).

NICAM-728 frame bits are sent as 4-level "quits" inside the horizontal
sync of every line: the sync floor is blanked with a raised-cosine window
and 23-25 two-bit symbols are added as paired large/small cosine pulses.
The per-line burst length alternates 48/44 bits (rate adaptation
accumulator, src/sis.c:173-178), and a new NICAM frame is encoded from
the most recent 32-pair audio buffer whenever the bit counter wraps.

Host side simulates the per-line bit stream (tiny) and codes the NICAM
frames 256 at a time through the native runtime's coder (`native=False`:
the numpy coder); the device blends the blank window and adds the quit
pulses as a basis matmul.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from . import vbidata

from ..audio import nicam
from ..audio.synth import fma32
from ..ops.shapes import rc_window

# grey-code tables (src/sis.c:167)
_GC = ((3, 0, 2, 1), (0, 3, 1, 2))
_GC_ARR = np.array(_GC, dtype=np.uint8)


def _cos_bell(x: np.ndarray) -> np.ndarray:
    """(1+cos(pi x))/2 inside |x|<1 (src/sis.c:26-30)."""
    return np.where(np.abs(x) < 1.0, (1.0 + np.cos(np.pi * x)) / 2, 0.0)


class _SiSState:
    """Sequential per-line burst generator.  Iteration 0 is the pipeline
    warm-up line the reference's sis process sees before stream line 0
    (its window trails the raster by one slot, src/video.c:4675-4688)."""

    def __init__(self, chain, audio_lag_lines: int, width: int,
                 native: bool = True):
        self.chain = chain
        self.lag = audio_lag_lines
        self.W = width
        self.native = native
        self.fnum = 0
        self.hist = np.zeros((nicam.J17_NTAPS - 1, 2), dtype=np.int64)

        # First iteration state matches the reference exactly: the
        # symbol queue starts with one zeroed frame (the reference's
        # zeroed frame bytes with frame_bit = 0).  _symq_base is the
        # absolute symbol index of _symq[0].
        self._symq = np.zeros(nicam.NICAM_FRAME_BITS // 2, dtype=np.uint8)
        self._symq_base = 0
        self._sim = (0, 0, 0)      # (line J, re, cumulative bits)
        self._sim_e = 0            # encode events simulated so far

    def _visible_buffer(self, k: int) -> int:
        """Index (1-based) of the latest 32-pair buffer delivered before
        the sis process runs on stream line k: the audio process trails by
        `lag` lines, so events in lines <= k-lag-1 are visible."""
        limit = (k - self.lag) * self.W
        if limit <= 0:
            return 0
        # largest m with hold_start(32m-1) < limit: ceil(32mS/A) <= limit
        # <=> 32mS <= limit*A  =>  m = (limit*A) // (32*S)
        A, S = self.chain.A, self.chain.S
        return (limit * A) // (32 * S)

    def _trigger_lines(self, count: int) -> list:
        """Line indices at which the next `count` frame encodes fire:
        encode event e fires in the line consuming absolute bit
        728*(e+1) (frame 0 is the initial zero frame).  The 48/44-bit
        line schedule has the closed form cum(c) = cum0 + 48c -
        2*floor((re0 + 44c)/125), strictly increasing, so the events
        resolve by searchsorted instead of a per-line replay."""
        J, re, cum = self._sim
        targets = nicam.NICAM_FRAME_BITS * (
            self._sim_e + 1 + np.arange(count, dtype=np.int64))
        nmax = int((int(targets[-1]) - cum) // 46 + 2)
        c = np.arange(1, nmax + 1, dtype=np.int64)
        cums = cum + 48 * c - 2 * ((re + 44 * c) // 125)
        idx = np.searchsorted(cums, targets, side="right")
        out = (J + idx).tolist()
        cl = int(idx[-1]) + 1
        self._sim = (J + cl, int((re + 44 * cl) % 125),
                     int(cums[cl - 1]))
        self._sim_e += count
        return out

    def _refill_syms(self):
        """Batch-encode the next 256 NICAM frames into the symbol queue:
        the J.17 stream over the concatenated consumption-order buffers
        is exactly the sequential per-frame encode with carried
        history."""
        ks = self._trigger_lines(256)
        A, S = self.chain.A, self.chain.S
        lim = (np.maximum(np.asarray(ks, dtype=np.int64) - 1, 0)
               - self.lag) * self.W
        ms = np.where(lim > 0, (lim * A) // (32 * S), 0)
        # consecutive frames advance the visible buffer index by <= a
        # few, so fetch the whole span once and slice per frame
        pos = ms[ms > 0]
        if len(pos):
            lo, hi = int(pos.min()), int(pos.max())
            span = self.chain._pcm(32 * (lo - 1), 32 * (hi - lo + 1))
        zero = np.zeros((32, 2), dtype=np.int64)
        bufs = [zero if m <= 0
                else span[32 * (m - lo):32 * (m - lo) + 32]
                for m in ms]
        pcm = np.concatenate([self.hist] + bufs)
        frames = np.asarray(nicam.encode_frames(
            pcm, self.fnum, nicam.MODE_STEREO, reserve=0,
            native=self.native), dtype=np.uint8)
        self.hist = pcm[-(nicam.J17_NTAPS - 1):]
        self.fnum += len(ks)
        syms = ((frames[:, :, None] >> np.array([6, 4, 2, 0])) & 3
                ).astype(np.uint8).reshape(-1)
        self._symq = np.concatenate([self._symq, syms])

    # -- absolute-index symbol access (device bit-matrix path) ---------
    # Iteration i (from stream epoch, re0 = 0) has previous residue
    # rprev(i) = 44 i mod 125 and consumes 22 symbols when rprev >= 81
    # else 24 (rate adaptation, src/sis.c:173-178); the cumulative
    # count has the closed form S(i) = 24 i - 2 floor(44 i / 125), so
    # each block's symbol span is a plain queue slice and the bit
    # matrix itself is built on device (SiS.apply).
    @staticmethod
    def syms_before(i: int) -> int:
        return 24 * i - 2 * ((44 * i) // 125)

    def syms_range(self, lo: int, hi: int) -> np.ndarray:
        while self._symq_base + len(self._symq) < hi:
            self._refill_syms()
        return self._symq[lo - self._symq_base:hi - self._symq_base]

    def prune_syms(self, below: int):
        drop = below - self._symq_base
        if drop > 1 << 16:
            self._symq = self._symq[drop:]
            self._symq_base += drop


class SiS:
    """Batched SiS line process."""

    lookahead = 1
    STATICS = ("basis", "blank_win", "warmup_spill")
    # checkpoint: the generator state minus its chain/source references
    _SIS_FIELDS = ("fnum", "hist", "_symq", "_symq_base", "_sim",
                   "_sim_e")

    @property
    def native(self) -> bool:
        """SiS's NICAM frame coder is the native runtime's (which raises
        if it does not load); False: the numpy coder."""
        return self.state.native

    @native.setter
    def native(self, value: bool) -> None:
        self.state.native = bool(value)

    def ckpt_state(self):
        return {f: copy.deepcopy(getattr(self.state, f))
                for f in self._SIS_FIELDS}

    def ckpt_load(self, d):
        for f, v in d.items():
            setattr(self.state, f, copy.deepcopy(v))

    def __init__(self, params, mode: str, chain, audio_lag_lines: int,
                 device="cuda", native: bool = True):
        if mode != "dcsis":
            raise ValueError(f"sis: unrecognised mode {mode!r}")
        p = params
        if p.conf.lines != 625:
            raise ValueError("sis: requires a 625-line mode")
        self.p = p
        self.state = _SiSState(chain, audio_lag_lines, p.width,
                               bool(native))

        # Quit pulse basis: 25 symbol positions x 2 levels (src/sis.c:32-75)
        level = int(p.white_level - p.black_level)
        levels = (int((level // 2) / 0.75), int((level // 4) / 0.75))
        bw = p.width / 382.0
        offset = bw * 3.32
        basis = np.zeros((50, p.width), dtype=np.float32)
        x = np.arange(p.width, dtype=np.float64)
        for e in range(50):
            t = -bw * (e // 2) - offset
            basis[e] = np.round(_cos_bell((t + x) / bw) * levels[e & 1])
        self.basis = basis

        # Blank window (src/sis.c:125-146)
        left, rise, width_s = 0.2e-6, 80e-9, 4.56e-6
        pr = p.pixel_rate
        self.blank_left = int(np.floor(pr * (left - rise / 2)))
        self.blank_width = int(np.ceil(pr * (width_s + rise)))
        i = np.arange(self.blank_left, self.blank_left + self.blank_width)
        self.blank_win = np.round(
            rc_window(i / pr, left, width_s, rise) * 32767.0
        ).astype(np.float32)
        self.blank_level = float(p.sync_level)
        self.warmup_spill = self._warmup_spill()
        self.device = torch.device(device)
        self.upload()

    def upload(self):
        """The basis, the blank window and the warm-up spill on the
        device, and the index tables of the quit-bit matrix."""
        dev = self.device
        self.d_basis = torch.as_tensor(self.basis, device=dev)
        self.d_win = torch.as_tensor(self.blank_win, device=dev)
        # the reference's integer window (src/sis.c:203-208)
        self.d_win_i = torch.round(self.d_win).to(torch.int32)
        self.d_spill = torch.as_tensor(self.warmup_spill, device=dev)
        self.d_gc = torch.as_tensor(_GC_ARR.reshape(-1).astype(np.int32),
                                    device=dev)

    def _warmup_spill(self) -> np.ndarray:
        """The reference's warm-up burst, as it actually lands on the
        first output line.

        At stream start the sis process's first invocation runs on the
        un-rendered warm-up slot (width 0), so vbidata_render's zero-
        width boundary branch (src/vbidata.c:218-223) redirects every
        set bit of that burst onto output line 1 starting at sample 0
        with the lut read cursor at -offset: the first `offset` reads
        of each symbol index BEFORE its value array — through the
        previous symbols' value/length/offset int16s and, for the
        first two symbols, through the five int16s preceding the lut
        allocation (the glibc malloc chunk header: prev_size tail 0,
        size = align16(bytes+8)|PREV_INUSE, high size bytes 0).  The
        result is a deterministic ~77-sample waveform added (int16
        wrapping) to the start of line 1 before that line's own blank
        blend runs.  Verified value-exact against an instrumented
        reference build; the blend then erases all but the window-edge
        samples, which is why unemulated output differed from the
        golden only at samples 0-3."""
        flat, entries = [], []
        for e in range(50):
            row = self.basis[e].astype(np.int64)
            nz = np.nonzero(row)[0]
            first, last = int(nz[0]), int(nz[-1])
            entries.append((len(flat), last - first + 1, first))
            flat += [last - first + 1, first] + row[first:last + 1].tolist()
        flat.append(-1)
        chunk = max(32, ((2 * len(flat) + 8 + 15) // 16) * 16) | 1
        arr = np.array([0, chunk & 0xffff, 0, 0, 0] + flat,
                       dtype=np.int64)
        # warm-up burst bits: iteration 0 reads the initial zeroed
        # NICAM frame (nb = 50): 0xC0 run-in + grey-coded zero symbols
        bits = np.zeros(50, dtype=np.uint8)
        bits[0] = bits[1] = 1
        for x in range(2, 50, 2):
            sym = int(_GC_ARR[1 if (x & 4) else 0][0])
            bits[x] = sym >> 1
            if x + 1 < 50:
                bits[x + 1] = sym & 1
        J = np.zeros(self.p.width, dtype=np.int64)
        for b in np.nonzero(bits)[0]:
            pos, ln, off = entries[b]
            J[:ln + off] += arr[5 + pos + 2 - off: 5 + pos + 2 + ln]
        n = int(np.nonzero(J)[0][-1]) + 1 if J.any() else 0
        return J[:n].astype(np.float32)

    def block_arrays(self, k0: int, nlines: int, claimed=None) -> dict:
        # line k is burst iteration k + 1 (the sis process window
        # trails the raster by one slot, src/video.c:4675-4688)
        st = self.state
        i0 = k0 + 1
        assert i0 >= 0
        s_lo = st.syms_before(i0)
        s_hi = st.syms_before(i0 + nlines)
        syms = st.syms_range(s_lo, s_hi)
        st.prune_syms(s_lo)
        cap = 24 * nlines
        pad = np.zeros(cap, dtype=np.uint8)
        pad[:len(syms)] = syms
        # k0 == -1: block 0's leading halo row is the warm-up slot, so
        # row 1 is stream line 0 (reference line 1) — the line that
        # receives the warm-up burst spill
        return {"syms": pad, "r0": int((44 * i0) % 125),
                "warm": np.float32(1.0 if k0 == -1 else 0.0)}

    def window_arrays(self, arrays, r0: int, r1: int) -> dict:
        """The block arrays for the block rows [r0, r1) (one shard's
        window): the rows' symbols start where those of the rows before
        r0 end, and the warm-up row is the block's row 1 where the
        window holds it."""
        j = np.arange(r0, dtype=np.int64)
        skip = int(np.sum(24 - np.where((arrays["r0"] + 44 * j) % 125 >= 81,
                                        2, 0)))
        out = dict(arrays)
        out["syms"] = arrays["syms"][skip:]
        out["r0"] = (arrays["r0"] + 44 * r0) % 125
        out["row1"] = 1 - r0 if r0 <= 1 < r1 else None
        return out

    def apply(self, out, arrays, lut=None):
        out = out.clone()
        # stream start: the reference's warm-up burst lands on line 1
        # pre-blend with int16 wraparound (see _warmup_spill); the wrap
        # is the identity for in-range composite when warm == 0
        row1_pre = None
        nw = len(self.warmup_spill)
        w1 = arrays.get("row1", 1)
        if nw and w1 is not None:
            r0 = out[w1, :nw] + arrays["warm"] * self.d_spill
            out[w1, :nw] = torch.remainder(r0 + 32768.0, 65536.0) - 32768.0
            row1_pre = out[w1].clone()
        L, N = self.blank_left, self.blank_width
        win = self.d_win[None, :]
        region = out[:, L:L + N]
        # (v*(32767-win) + blank*win) >> 15, rearranged to keep the f32
        # products small (src/sis.c:203-208); XLA's CPU step fuses the
        # product into the subtraction
        out[:, L:L + N] = region + torch.floor(
            fma32(win, self.blank_level - region, -region) * (1.0 / 32768.0))
        if row1_pre is not None:
            # the wrapped warm-up values put row 1 outside the range
            # where the f32 rearrangement is exact; redo its blend in
            # the reference's int32 arithmetic (src/sis.c:203-208)
            a = torch.round(row1_pre[L:L + N]).to(torch.int32)
            w = self.d_win_i
            t = a * (32767 - w) + int(round(self.blank_level)) * w
            out[w1, L:L + N] = (t >> 15).to(out.dtype)
        # device-side quit-bit matrix: run-in + grey-coded symbol bits
        # at per-row offset (0/4 for the 48/44-bit rate adaptation)
        n = out.shape[0]
        dev = out.device
        syms = arrays["syms"].to(torch.int32)
        i32 = torch.int32
        rprev = (arrays["r0"] + 44 * torch.arange(n, dtype=i32, device=dev)
                 ) % 125
        off = torch.where(rprev >= 81, 4, 0).to(i32)[:, None]
        counts = 24 - (off[:, 0] >> 1)
        starts = torch.cumsum(counts, 0).to(i32) - counts
        jj = torch.arange(50, dtype=i32, device=dev)[None, :]
        q = jj - off
        p = (q - 2) >> 1
        valid = (q >= 2) & (p < counts[:, None])
        idx = starts[:, None] + torch.where(valid, p, 0)
        S = syms[torch.clamp(idx, 0, syms.shape[0] - 1).long()]
        # grey-code row ((2 + 2p) & 4) >> 2 = 0,1,1,0,0,1,1,0,...
        S = self.d_gc[(((((p + 1) >> 1) & 1) << 2) | S).long()]
        bits = torch.where(valid, torch.where((q & 1) == 1, S & 1, S >> 1),
                           ((q == 0) | (q == 1)).to(i32))
        return out + vbidata.render(bits.to(torch.float32), self.d_basis)
