"""In-stream EIA-608 (A53/GA94) caption extraction.

The reference reads A53 byte pairs from libav's decoded-frame side data
(src/av_ffmpeg.c:566-581: every 3-byte cc packet with
(b0 & 0x07) == 0x04 — cc_valid, NTSC field 1 — feeds the cc608 FIFO).
The ffmpeg *binary* cannot expose frame side data, so this module
recovers the same pairs from the codec-copied elementary stream
(`ffmpeg -map 0:v:0 -c:v copy -f mpeg2video|h264 -`):

  - MPEG-2: ATSC user-data blocks (start code 0x000001B2, "GA94",
    user_data_type 0x03) attach to the preceding picture; pictures are
    re-ordered to display order inside each GOP via the picture
    header's temporal_reference (the decoder emits display order).
  - H.264: SEI NAL units (type 6), payload type 4
    (user_data_registered_itu_t_t35) with the GA94 identifier; the
    Annex-B emulation-prevention bytes are stripped.  Pictures are
    taken in bitstream order (B-frame reordering would need full POC
    tracking; streams without B-frames are unaffected).
  - H.265: prefix SEI NAL units (type 39) carry the same ITU-T T.35
    payload; pictures are counted at each VCL NAL whose
    first_slice_segment_in_pic_flag is set.  The reference's libav
    side-data path is codec-agnostic (src/av_ffmpeg.c:566-581), so
    the ES recovery covers the same codecs it would in practice.
"""

from __future__ import annotations


def _cc_pairs_from_atsc(payload: bytes) -> list:
    """GA94 type-3 cc_data block -> [(c1, c2)] for the valid NTSC
    field-1 packets, matching the reference's (b0 & 0x07) == 0x04
    filter."""
    # payload starts after "GA94" 0x03: em_data flag byte + cc_count
    if len(payload) < 2:
        return []
    cc_count = payload[0] & 0x1F
    out = []
    p = 2                       # skip em_data
    for _ in range(cc_count):
        if p + 3 > len(payload):
            break
        b0, c1, c2 = payload[p], payload[p + 1], payload[p + 2]
        p += 3
        if (b0 & 0x07) == 0x04:
            out.append((c1, c2))
    return out


class A53ESParser:
    """Incremental ES parser; feed() returns newly flushed caption
    pairs in display order and counts flushed pictures."""

    def __init__(self, codec: str):
        if codec not in ("mpeg2video", "h264", "hevc"):
            raise ValueError(f"a53: unsupported codec {codec!r}")
        self.codec = codec
        self._buf = b""
        self._gop: list = []        # (temporal_ref, [pairs]) per picture
        self._cur = None            # current picture entry
        self.pictures = 0           # flushed pictures (display order)
        self._pairs: list = []      # flushed caption pairs
        self._pending: list = []    # h264: SEI pairs before their slice

    # -- common start-code scan -----------------------------------------
    def _units(self, final: bool):
        """Yield (code, payload) start-code units from the buffer,
        keeping a trailing partial unit for the next feed."""
        buf = self._buf
        pos = buf.find(b"\x00\x00\x01")
        units = []
        while pos >= 0:
            nxt = buf.find(b"\x00\x00\x01", pos + 3)
            if nxt < 0 and not final:
                break
            end = nxt if nxt >= 0 else len(buf)
            units.append((buf[pos + 3], buf[pos + 4:end]))
            pos = nxt
        self._buf = b"" if (pos < 0 or final) else buf[pos:]
        if pos < 0 and not final:
            # no (complete) unit yet: keep a bounded tail
            self._buf = buf[-(1 << 20):]
        return units

    def _flush_gop(self):
        for _ref, pairs in sorted(self._gop, key=lambda e: e[0]):
            self._pairs.extend(pairs)
            self.pictures += 1
        self._gop = []
        self._cur = None

    def feed(self, data: bytes, final: bool = False) -> list:
        self._buf += data
        if self.codec == "mpeg2video":
            for code, payload in self._units(final):
                if code == 0x00 and len(payload) >= 2:   # picture
                    tref = (payload[0] << 2) | (payload[1] >> 6)
                    self._cur = (tref, [])
                    self._gop.append(self._cur)
                elif code == 0xB8 or code == 0xB3:       # GOP / seq hdr
                    self._flush_gop()
                elif code == 0xB2 and self._cur is not None:
                    if payload[:5] == b"GA94\x03":
                        self._cur[1].extend(
                            _cc_pairs_from_atsc(payload[5:]))
                elif code == 0xB7:                       # sequence end
                    self._flush_gop()
        elif self.codec == "h264":
            for code, payload in self._units(final):
                nal_type = code & 0x1F
                if nal_type == 6:                        # SEI
                    self._sei(payload)
                elif nal_type in (1, 5):                 # coded slice
                    self._pairs.extend(self._pending)
                    self._pending = []
                    self.pictures += 1
        else:                                            # hevc
            for code, payload in self._units(final):
                nut = (code >> 1) & 0x3F     # 2-byte NAL header
                if nut == 39 and payload:                # prefix SEI
                    self._sei(payload[1:])
                elif nut <= 31 and len(payload) >= 2:    # VCL slice
                    if payload[1] >> 7:  # first_slice_segment_in_pic
                        self._pairs.extend(self._pending)
                        self._pending = []
                        self.pictures += 1
        if final:
            self._flush_gop()
        out = self._pairs
        self._pairs = []
        return out

    def _sei(self, raw: bytes):
        # strip Annex-B emulation prevention (00 00 03 xx -> 00 00 xx)
        data = raw.replace(b"\x00\x00\x03", b"\x00\x00")
        p = 0
        while p + 1 < len(data):
            ptype = 0
            while p < len(data) and data[p] == 0xFF:
                ptype += 255
                p += 1
            if p >= len(data):
                break
            ptype += data[p]
            p += 1
            size = 0
            while p < len(data) and data[p] == 0xFF:
                size += 255
                p += 1
            if p >= len(data):
                break
            size += data[p]
            p += 1
            payload = data[p:p + size]
            p += size
            if ptype == 4 and payload[3:8] == b"GA94\x03":
                # itu_t_t35: country (1) + provider (2) + "GA94" + type
                self._pending.extend(_cc_pairs_from_atsc(payload[8:]))
