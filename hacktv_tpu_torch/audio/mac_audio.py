"""D/D2-MAC packetised audio encoder (host side).

Port of hacktv_tpu/audio/mac_audio.py, numpy as there.  The sound coding
blocks go through the native runtime (`rt_mac_audio_blocks`), which raises
if it does not load; `MacAudioEnc(native=False)` runs the numpy coder (the
plain version the tests hold the native one against).

Bit-exact port of the reference's `mac_audioenc_*` (src/mac.c:1064-1361):
J.17 pre-emphasis in int16 Q15 arithmetic, near-instantaneous companding
with per-27-sample scale-factor signalling, first/second-level
protection, and streaming of 90/120-byte sound coding blocks into
91-byte packet payloads.  Runs on the host at 32 kHz, the serial bit
domain, feeding the batched waveform synthesis.
"""

from __future__ import annotations

import numpy as np

from .. import runtime
from ..ops.mac_bits import HAMMING, parity

MAC_PAYLOAD_BYTES = 91

# J.17 filter taps (src/mac.c:81-132)
J17_HQ_TAPS = [
    -4.0638183114837725e-05, -6.0025586949698855e-05,
    -5.564043110245245e-05, -7.947984626961884e-05, -7.647905950877803e-05,
    -0.00010634219837159823, -0.00010573530630851049,
    -0.0001439262656801037, -0.0001473418005545947, -0.00019733025737867933,
    -0.00020744600452448253, -0.00027462470991584573,
    -0.0002959626579938912, -0.00038903864897297304,
    -0.00042951430210921436, -0.0005632229082537514, -0.0006373725671138244,
    -0.0008381833027058537, -0.0009744643521200177, -0.0012937307193290994,
    -0.001552751532064818, -0.0021004781086707324, -0.002625860940471562,
    -0.003668275121553212, -0.004845513644185225, -0.007121819711885047,
    -0.010127737762890622, -0.01599147906480894, -0.024853521327126284,
    -0.04278009416709207, -0.07239348501988721, -0.13738444727018054,
    0.7809561590505447, -0.1373844472702732, -0.07239348501983206,
    -0.04278009416712298, -0.02485352132710135, -0.01599147906482651,
    -0.010127737762873385, -0.007121819711900977, -0.0048455136441711835,
    -0.0036682751215641306, -0.0026258609404633286, -0.0021004781086770207,
    -0.0015527515320562413, -0.0012937307193406264, -0.0009744643521089602,
    -0.0008381833027124772, -0.0006373725671163757, -0.000563222908240734,
    -0.00042951430212660697, -0.00038903864895887066,
    -0.0002959626579998339, -0.0002746247099202026, -0.00020744600451413447,
    -0.00019733025738687381, -0.00014734180055051493,
    -0.0001439262656806838, -0.0001057353063093944, -0.00010634219837524443,
    -7.647905950078356e-05, -7.947984627567915e-05, -5.564043109916536e-05,
    -6.0025586949491874e-05, -4.063818311961655e-05,
]

J17_MQ_TAPS = [
    -0.0023983764740491817, 0.0005372369031780615, 0.0029088459406962433,
    -0.0006808310346680438, -0.0038400522316643093, 0.0003905164235471325,
    0.004598081791062745, -0.0003030199522471644, -0.005996593890780044,
    -0.0006099393949867584, 0.006900939227982249, 0.0011126454561315397,
    -0.008845190642068847, -0.0031512342941305426, 0.009594941549957162,
    0.0042182070235715335, -0.012261809244109948, -0.008289287373445343,
    0.012146295526980532, 0.009903710389951048, -0.016223088515771884,
    -0.018241246604564477, 0.013268559591784575, 0.019670208896615235,
    -0.02196471821546391, -0.040897915745289205, 0.007376815392497354,
    0.03632945551391454, -0.04261000237464269, -0.13505868867468723,
    -0.05987965058731034, 0.164415182169897, 0.29045946882740054,
    0.16441518216987408, -0.059879650587328914, -0.13505868867468418,
    -0.04261000237463042, 0.03632945551391707, 0.007376815392491072,
    -0.04089791574529129, -0.02196471821545942, 0.019670208896617532,
    0.013268559591781671, -0.01824124660456619, -0.016223088515769372,
    0.009903710389952778, 0.01214629552697836, -0.00828928737344731,
    -0.01226180924410831, 0.004218207023573651, 0.009594941549956208,
    -0.003151234294132517, -0.008845190642068512, 0.0011126454561330129,
    0.006900939227982167, -0.0006099393949875143, -0.005996593890779387,
    -0.00030301995224640626, 0.004598081791061394, 0.0003905164235454991,
    -0.0038400522316629185, -0.0006808310346651593, 0.002908845940695833,
    0.0005372369031742542, -0.0023983764740508006,
]

# scale factors: index -> (factor, shift, coding_range, protection_range)
# (src/mac.c:135-151)
_SCALE_FACTORS = [
    (0, 2, 5, 7), (1, 2, 5, 7), (2, 2, 5, 6), (4, 2, 5, 5),
    (3, 3, 4, 4), (5, 4, 3, 3), (6, 5, 2, 2), (7, 6, 1, 1),
]


def _lround(x):
    return np.where(x >= 0, np.floor(x + 0.5), np.ceil(x - 0.5)
                    ).astype(np.int64)


class _FirInt16:
    """Streaming int16 FIR matching fir_int16_* (src/fir.c:263-390):
    int16 Q15 taps, int32 accumulate, arithmetic >>15, clip."""

    def __init__(self, taps, decimation: int = 1):
        self.taps = _lround(np.asarray(taps, dtype=np.float64) * 32767.0)
        self.dec = decimation
        self.hist = np.zeros(len(self.taps) - 1, dtype=np.int64)
        # decimation phase: the reference's `d` starts at interpolation
        # (=1) so the first input sample always produces an output
        self.phase = 0

    def process(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, dtype=np.int64)
        buf = np.concatenate([self.hist, x])
        n = len(x)
        nt = len(self.taps)
        # y[t] = sum_j taps[j] * in[t-j]: one C-level convolve call
        acc = np.convolve(buf, self.taps, "valid")
        y = np.clip(acc >> 15, -32768, 32767)
        self.hist = buf[-(nt - 1):]
        if self.dec > 1:
            sel = (np.arange(n) + self.phase) % self.dec == 0
            self.phase = (self.phase + n) % self.dec
            y = y[sel]
        return y


def _l2_hamming(b: np.ndarray) -> np.ndarray:
    """(src/mac.c:1187-1198)."""
    b = b.astype(np.int64)
    g = lambda *ks: np.bitwise_xor.reduce([(b >> k) & 1 for k in ks])
    p = g(0, 3, 4, 6, 7, 8, 10)
    p |= g(0, 1, 3, 5, 6, 8, 9) << 1
    p |= g(0, 1, 2, 4, 6, 7, 9) << 2
    p |= g(1, 2, 4, 5, 6, 8, 10) << 3
    p |= g(2, 3, 5, 6, 7, 9, 10) << 4
    return p


def _parity_bits(v: np.ndarray) -> np.ndarray:
    # parity over the low 20 bits = popcount parity (values are masked
    # to < 2^20 by the callers)
    return (np.bitwise_count(v.astype(np.uint64)) & 1).astype(np.int64)


def calculate_audio_address(stereo, quality, protection, linear, index=0):
    """(src/mac.c:855-880)."""
    return (1 << 7) | (int(stereo) << 6) | (int(quality) << 5) | \
        (int(protection) << 4) | (int(linear) << 3) | (index & 7)


class MacAudioEnc:
    """Streaming MAC audio encoder; `write()` takes int16 stereo pairs,
    `read_packets()` drains complete 91-byte packet payloads."""

    def __init__(self, high_quality=True, stereo=True, protection=False,
                 linear=False, scramble=False, conditional=False,
                 native=True):
        self.native = bool(native)
        self.high_quality = bool(high_quality)
        self.stereo = bool(stereo)
        self.linear = bool(linear)
        self.protection = bool(protection)
        self.scramble = bool(scramble)
        self.conditional = bool(conditional) and self.scramble
        self.address = calculate_audio_address(
            self.stereo, self.high_quality, self.protection, self.linear)
        self.continuity = 0

        taps = J17_HQ_TAPS if self.high_quality else J17_MQ_TAPS
        dec = 1 if self.high_quality else 2
        self.fir = [_FirInt16(taps, dec), _FirInt16(taps, dec)]

        self.samples_per_block = 36 if self.linear and self.protection \
            else 64
        self.src_samples_per_block = self.samples_per_block * \
            (1 if self.high_quality else 2)
        spb = self.samples_per_block
        self.ch_len = spb // 2
        self.ch_offset = [0, 1 if self.stereo else self.ch_len]
        self.ch_sf_len = 18 if self.linear and self.protection else 27
        self.ch_sf_offset = [0, 1 if self.stereo else self.ch_sf_len]
        self.bits_per_sample = (14 if self.linear else 10) + \
            (5 if self.protection else 1)
        self.block_len = 120 if self.linear ^ self.protection else 90

        # streaming state
        self.j17 = np.zeros(self.src_samples_per_block, dtype=np.int64)
        self.j17x = 0
        self.pkt = bytearray(MAC_PAYLOAD_BYTES)
        self.pkt[0] = 0xC7       # BC1 sound coding block
        self.si_timer = 0
        self.si_pkt = self._si_packet()
        self._bytes = bytearray()    # encoded coding-block byte stream

    # ------------------------------------------------------------------
    def _si_packet(self) -> bytes:
        """Sound Interpretation packet (src/mac.c:1064-1102)."""
        pkt = bytearray(MAC_PAYLOAD_BYTES)
        pkt[0] = 0x00
        pkt[1] = HAMMING[0]
        pkt[2] = HAMMING[1]
        pkt[3] = HAMMING[0]
        pkt[4] = HAMMING[12]
        pkt[5] = HAMMING[1]
        pkt[6] = HAMMING[10]
        b = (1 << 11)
        b |= (1 if self.protection else 0) << 7
        b |= (0 if self.linear else 1) << 6
        b |= int(self.conditional) << 5
        b |= int(self.scramble) << 4
        b |= (1 if self.stereo else 0) << 2
        b |= (0 if self.high_quality else 1) << 1
        b |= parity(b) << 8
        for x in range(5):
            pkt[7 + x * 2] = (b >> 8) & 0xFF
            pkt[8 + x * 2] = b & 0xFF
        return bytes(pkt)

    # ------------------------------------------------------------------
    def _scale_factor(self, pcm: np.ndarray) -> tuple:
        """(src/mac.c:990-1014): smallest range covering the block."""
        s = np.where(pcm < 0, ~pcm, pcm)
        m = int(s.max()) if len(s) else 0
        # smallest b >= 1 with m >> (b + 8) == 0, capped at 7
        b = max(1, min(7, m.bit_length() - 8))
        return _SCALE_FACTORS[b]

    def _encode_block(self, samples: np.ndarray) -> bytes:
        """One sound coding block (kept for direct use/tests)."""
        return self._encode_blocks(
            np.asarray(samples, dtype=np.int64).reshape(1, -1))

    def _encode_blocks_native(self, S: np.ndarray) -> bytes:
        """_encode_blocks through `rt_mac_audio_blocks` (bit-exact with
        the numpy path below, the plain version)."""
        lib = runtime.load()
        import ctypes as c
        nblk = S.shape[0]
        if nblk == 0:
            return b""
        Sx = np.ascontiguousarray(S, dtype=np.int32)
        taps = np.ascontiguousarray(self.fir[0].taps, dtype=np.int32)
        hp = []
        for f in self.fir:
            h = np.ascontiguousarray(f.hist, dtype=np.int32)
            p = c.c_int32(f.phase)
            hp.append((f, h, p))
        out = np.zeros(nblk * self.block_len, dtype=np.uint8)
        lib.rt_mac_audio_blocks(
            Sx.ctypes.data, nblk, S.shape[1], int(self.stereo),
            int(self.linear), int(self.protection),
            taps.ctypes.data, len(taps), self.fir[0].dec,
            hp[0][1].ctypes.data, c.byref(hp[0][2]),
            hp[1][1].ctypes.data, c.byref(hp[1][2]),
            out.ctypes.data)
        used = [0] if not self.stereo else [0, 1]
        for b in used:
            f, h, p = hp[b]
            f.hist = h.astype(np.int64)
            f.phase = int(p.value)
        return out.tobytes()

    def _encode_blocks(self, S: np.ndarray) -> bytes:
        """Vectorised sound-coding-block encoder over S [nblk,
        src_samples_per_block] (interleaved stereo or sequential mono
        halves per row); returns nblk*block_len bytes in stream order.
        The per-channel J.17 FIRs are stream-continuous, so feeding the
        whole channel sample stream at once is exactly equivalent to the
        reference's block-at-a-time loop (src/mac.c:1200-1354)."""
        nblk = S.shape[0]
        spb = self.samples_per_block
        if self.native:
            return self._encode_blocks_native(S)
        # the numpy path accumulates J.17 products past int32 range
        S = np.asarray(S, dtype=np.int64)
        bps = self.bits_per_sample
        step = 2 if self.stereo else 1
        out_buf = np.zeros((nblk, spb), dtype=np.int64)
        sfc = np.zeros(nblk, dtype=np.int64)
        if self.stereo:
            ys_ch = [self.fir[b].process(S[:, b::2].reshape(-1))
                     .reshape(nblk, self.ch_len) for b in range(2)]
        else:
            # mono halves are sequential within each block, so the flat
            # stream through the single FIR preserves sample order
            y = self.fir[0].process(S.reshape(-1)).reshape(
                nblk, 2, self.ch_len)
            ys_ch = [y[:, 0, :], y[:, 1, :]]
        fac_t = np.array([f[0] for f in _SCALE_FACTORS], np.int64)
        shf_t = np.array([f[1] for f in _SCALE_FACTORS], np.int64)
        sfl = self.ch_sf_len
        sfb_shift = (2 - np.arange(sfl) % 3)[None, :]
        factors = []
        for b in range(2):
            ys = ys_ch[b]
            s = np.where(ys < 0, ~ys, ys)
            m = s.max(axis=1) if ys.shape[1] else np.zeros(nblk, np.int64)
            # frexp exponent == bit_length for the int16-range maxima
            e = np.frexp(m.astype(np.float64))[1]
            idx = np.clip(e - 8, 1, 7)
            factor = fac_t[idx]
            shift = shf_t[idx]
            sfc = ((sfc << 9) | (factor << 6) | (factor << 3) | factor) \
                & 0x3FFFF
            if self.linear:
                enc = (ys >> 2) & 0x3FFF
            else:
                enc = (ys >> shift[:, None]) & 0x3FF
            if self.protection:
                h = _l2_hamming(enc >> 3 if self.linear
                                else (enc << 1) & 0x7E0)
                enc = enc | (h << (bps - 5))
            else:
                p = _parity_bits(enc >> (3 if self.linear else 4))
                enc = enc | (p << (bps - 1))
            factors.append(factor)
            out_buf[:, self.ch_offset[b]::step][:, :self.ch_len] = enc
        # scale-factor signalling XOR on the protection bit, in ABSOLUTE
        # sample positions: sf_offset is 0/1 (stereo) or 0/sf_len (mono)
        # — the mono channel-1 region crosses the channel boundary and
        # flips the last protection bits of channel 0's samples
        # (src/mac.c:1151-1156, 1319-1323)
        for b in range(2):
            idx = self.ch_sf_offset[b] + step * np.arange(sfl)
            sfb = (factors[b][:, None] >> sfb_shift) & 1
            out_buf[:, idx] ^= sfb << (bps - 1)
        # pack
        parts = []
        if not self.linear and not self.protection:
            parts.append(np.zeros((nblk, 16), dtype=np.uint8))
        if self.linear and self.protection:
            parts.append(np.zeros((nblk, 18), dtype=np.uint8))
            parts.append(((sfc[:, None] >> (17 - np.arange(18))[None, :])
                          & 1).astype(np.uint8))
        sample_bits = ((out_buf[:, :, None] >> np.arange(bps)[None, None])
                       & 1).astype(np.uint8).reshape(nblk, -1)
        parts.append(sample_bits)
        bits = np.concatenate(parts, axis=1)
        pad = (-bits.shape[1]) % 8
        if pad:
            bits = np.concatenate(
                [bits, np.zeros((nblk, pad), np.uint8)], axis=1)
        return np.packbits(bits, axis=1, bitorder="little").tobytes()

    # ------------------------------------------------------------------
    def write_audio(self, pairs: np.ndarray) -> list:
        """`mac_write_audio` (src/mac.c:1041-1062): returns the packets
        pushed, each (address, continuity, payload91, scramble).  All
        complete coding blocks available after this chunk are encoded in
        one vectorised pass; the byte stream is then chopped into 90-byte
        BC1 payloads exactly as the reference's incremental
        mac_audioenc_read loop would (src/mac.c:1200-1354)."""
        out = []
        if self.si_timer <= 0:
            out.append((self.address, (self.continuity - 2) & 3,
                        self.si_pkt, False))
            self.si_timer = (32000 if self.high_quality else 16000) // 3

        # queue source samples (int16 units, stereo interleaved)
        if self.stereo:
            samples = pairs.reshape(-1).astype(np.int64)
        else:
            t = pairs[:, 0].astype(np.int64) + pairs[:, 1].astype(np.int64)
            # C integer division truncates toward zero
            samples = np.where(t < 0, -((-t) // 2), t // 2)

        sspb = self.src_samples_per_block
        buf = np.concatenate([self.j17[:self.j17x], samples])
        nblk = len(buf) // sspb
        if nblk:
            self._bytes += self._encode_blocks(
                buf[:nblk * sspb].reshape(nblk, sspb))
            self.si_timer -= nblk * (self.samples_per_block if self.stereo
                                     else self.samples_per_block // 2)
        rem = buf[nblk * sspb:]
        self.j17[:len(rem)] = rem
        self.j17x = len(rem)

        npkt = len(self._bytes) // (MAC_PAYLOAD_BYTES - 1)
        for i in range(npkt):
            self.pkt[1:] = self._bytes[i * 90:i * 90 + 90]
            out.append((self.address, self.continuity & 3,
                        bytes(self.pkt), self.scramble))
            self.continuity += 1
        del self._bytes[:npkt * 90]
        return out

    def write_audio_batch(self, chunks: list, packed: bool = False,
                          contig: np.ndarray | None = None):
        """Batched write_audio over consecutive chunks: one vectorised
        block-encode for the whole span, then an exact replay of the
        per-chunk SI-timer / packet-emission schedule.  Returns one
        packet list per chunk, identical to calling write_audio(chunk)
        in sequence.

        With packed=True the BC1 payloads stay in one [npkt, 91] uint8
        matrix and each chunk yields (si_cont | None, row0, nrow,
        cont0); building ~300 payload bytes objects per D-MAC block and
        re-parsing them in the mux replay marshal cost ~1 ms/block."""
        if not chunks:
            return ([], np.zeros((0, MAC_PAYLOAD_BYTES), np.uint8)) \
                if packed else []
        if contig is not None:
            allp = contig            # chunks are views of this buffer
        else:
            allp = (np.concatenate(chunks) if len(chunks) > 1
                    else np.asarray(chunks[0]))
        # the native block encoder takes int32; stay narrow until the
        # numpy path needs int64
        wdt = np.int64 if allp.dtype == np.int64 else np.int32
        if self.stereo:
            samples = np.ascontiguousarray(allp.reshape(-1), dtype=wdt)
            lens = [2 * len(c) for c in chunks]
        else:
            t = allp[:, 0].astype(wdt) + allp[:, 1].astype(wdt)
            # C integer division truncates toward zero
            samples = np.where(t < 0, -((-t) // 2), t // 2)
            lens = [len(c) for c in chunks]
        sspb = self.src_samples_per_block
        buf = np.concatenate(
            [self.j17[:self.j17x].astype(samples.dtype), samples])
        nblk = len(buf) // sspb
        enc = self._encode_blocks(
            buf[:nblk * sspb].reshape(nblk, sspb)) if nblk else b""
        per_blk = self.samples_per_block if self.stereo \
            else self.samples_per_block // 2
        bl = self.block_len
        nch = len(lens)
        lens_a = np.asarray(lens, dtype=np.int64)
        # closed-form replay of the per-chunk schedule: cumulative new
        # coding blocks after chunk t, and from them the SI emissions
        # and packet boundaries (the python per-chunk loop cost ~3 ms
        # per 32-frame D-MAC window at 1000 chunks)
        avail_t = self.j17x + np.cumsum(lens_a)
        Bt = avail_t // sspb
        Bprev = np.concatenate([[0], Bt[:-1]])
        K = (32000 if self.high_quality else 16000) // 3
        si_at = np.zeros(nch, dtype=bool)
        timer = self.si_timer
        baseB = 0
        t = 0
        while t < nch:
            if timer - (int(Bprev[t]) - baseB) * per_blk <= 0:
                si_at[t] = True
                timer = K
                baseB = int(Bprev[t])
                t += 1
                continue
            need = -(-timer // per_blk)     # blocks to reach <= 0
            t2 = int(np.searchsorted(Bprev, baseB + need, side="left"))
            t = max(t2, t + 1)
        self.si_timer = timer - (int(Bt[-1]) - baseB) * per_blk

        len0 = len(self._bytes)
        allb = bytes(self._bytes) + enc
        npkt_t = (len0 + Bt * bl) // (MAC_PAYLOAD_BYTES - 1)
        npkt_prev = 0
        c0 = self.continuity
        addr = self.address
        if packed:
            ntot = int(npkt_t[-1])
            pm = np.empty((ntot, MAC_PAYLOAD_BYTES), np.uint8)
            pm[:, 0] = 0xC7
            pm[:, 1:] = np.frombuffer(
                allb[:ntot * 90], np.uint8).reshape(-1, 90)
            row0 = np.concatenate([[0], npkt_t[:-1]]).astype(np.int64)
            nrow = npkt_t - row0
            cont0 = ((c0 + row0) & 3).astype(np.int32)
            si_cont = np.where(si_at, (c0 + row0 - 2) & 3,
                               -1).astype(np.int32)
            npkt_prev = ntot
            out_all = (pm, si_cont, row0.astype(np.int64),
                       nrow.astype(np.int64), cont0)
        else:
            out_all = []
            for t in range(nch):
                out = []
                if si_at[t]:
                    out.append((addr, (c0 + npkt_prev - 2) & 3,
                                self.si_pkt, False))
                for p in range(npkt_prev, int(npkt_t[t])):
                    out.append((addr, (c0 + p) & 3,
                                b"\xc7" + allb[p * 90:p * 90 + 90],
                                self.scramble))
                npkt_prev = int(npkt_t[t])
                out_all.append(out)
        self.continuity = c0 + npkt_prev
        self._bytes = bytearray(allb[npkt_prev * 90:])
        rem = int(avail_t[-1] - Bt[-1] * sspb)
        if rem:
            self.j17[:rem] = buf[len(buf) - rem:]
        self.j17x = rem
        return out_all
