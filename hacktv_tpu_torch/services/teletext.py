"""Teletext (ETS 300 706) service: TTI page loader, magazine scheduler,
packet coder and batched line renderer (port of
hacktv_tpu/services/teletext.py).

Re-implementation of src/teletext.c for the batch encoder: the bit-domain
work (page rings, parallel-mode magazine scheduling with the 20 ms
header-to-row rule, Hamming 8/4 + odd parity + page CRC, fastext links,
packet 8/30 clock) runs on the host; the waveform is rendered on the
device as bits @ raised-cosine basis at 444xfH (16 VBI lines per field,
lines 7-22 / 320-335).  `MacTeletext` feeds the same packets into the
D/D2-MAC line bits instead (video/mac.py).

The clock source is injectable so output can be made deterministic for
testing; the reference uses wall time (src/teletext.c:605, 1183).
"""

from __future__ import annotations

import copy
import os
import sys
import time as _time

import numpy as np
import torch

from . import vbidata

TT_OK = 0
TT_NO_PACKET = 1

# Hamming 8/4 code words (ETS 300 706, src/teletext.c:65-68)
HAMMING84 = np.array([
    0x15, 0x02, 0x49, 0x5E, 0x64, 0x73, 0x38, 0x2F,
    0xD0, 0xC7, 0x8C, 0x9B, 0xA1, 0xB6, 0xFD, 0xEA], dtype=np.uint8)

# Odd parity for 7-bit values
_PARITY = np.zeros(0x80, dtype=np.uint8)
for _i in range(0x80):
    _PARITY[_i] = _i | (0 if bin(_i).count("1") & 1 else 0x80)

_WEEKDAYS = ["Sun", "Mon", "Tue", "Wed", "Thu", "Fri", "Sat"]
_MONTHS = ["Jan", "Feb", "Mar", "Apr", "May", "Jun",
           "Jul", "Aug", "Sep", "Oct", "Nov", "Dec"]


def _crc16_byte(crc: int, byte: int) -> int:
    """One byte of the ETS 300 706 9.6.1 page CRC, bit by bit
    (src/teletext.c:89-107)."""
    b = byte
    for _ in range(8):
        bit = ((crc >> 15) ^ (crc >> 11) ^ (crc >> 8) ^ (crc >> 6)
               ^ (b >> 7)) & 1
        crc = ((crc << 1) | bit) & 0xFFFF
        b = (b << 1) & 0xFF
    return crc


# the per-byte step is linear over GF(2) in (crc, byte): decompose into
# three 256-entry tables (high/low crc byte and data byte contributions)
_CRC_HI = [_crc16_byte(h << 8, 0) for h in range(256)]
_CRC_LO = [_crc16_byte(l, 0) for l in range(256)]
_CRC_IN = [_crc16_byte(0, b) for b in range(256)]


def _read_raw_packet(raw, state: list) -> bytes | None:
    """42-byte raw packet read with the reference's feof semantics
    (src/teletext.c:1185-1201): a rewind happens only on the call AFTER
    end-of-file is hit, and a short read yields no packet for that line
    (the stream's EOF line renders empty once per wrap).  state is a
    1-element [eof_flag] list.  Unseekable streams (stdin) simply stop
    at EOF like the reference's fseek(stdin) no-op."""
    if state[0]:
        try:
            raw.seek(0)
        except (OSError, ValueError):
            pass
        state[0] = False
    data = raw.read(42)
    if len(data) < 42:
        state[0] = True
        return None
    return b"\x55\x55\x27" + data


def crc16(data: bytes, crc: int = 0) -> int:
    """Page CRC per ETS 300 706 9.6.1 (src/teletext.c:89-107)."""
    for byte in data:
        crc = _CRC_HI[crc >> 8] ^ _CRC_LO[crc & 0xFF] ^ _CRC_IN[byte]
    return crc


def _paritycpy(dest: bytearray, off: int, src: bytes, n: int,
               pad: int = 0x20):
    i = 0
    for ch in src[:n]:
        if ch == 0:
            break
        dest[off + i] = _PARITY[ch & 0x7F]
        i += 1
    while i < n:
        dest[off + i] = _PARITY[pad & 0x7F]
        i += 1


def _mjd(year: int, month: int, day: int) -> int:
    return int(367.0 * year
               - int(7.0 * (year + int((month + 9.0) / 12.0)) / 4.0)
               + int(275.0 * month / 9.0) + day - 678987.0)


class Page:
    def __init__(self):
        self.page = 0           # 0xMPP
        self.subpage = 0
        self.subcode = 0
        self.page_status = 0
        self.cycle_time = 0
        self.cycle_mode = 0     # 0 = timer, 1 = cycle
        self.cycle_count = 0
        self.links = [-1] * 6
        self.erase = 1
        self.packets: list[bytearray] = []   # each 45 bytes
        self.nodelay_packets = 0

    def mkpackets(self, lines: np.ndarray):
        """lines: [25][40] uint8 (row 0 unused).  The fastext packet goes
        first (Annex B.2), then non-empty rows (src/teletext.c:647-679)."""
        self.packets = [self._fastext_line()]
        for i in range(1, 25):
            row = bytes(lines[i])
            if any(c not in (0x20, 0) for c in row):
                self.packets.append(self._row_line(i, row))
        self.nodelay_packets = 0

    def _addr(self, packet_number: int) -> bytes:
        mag = (self.page >> 8) & 7
        return bytes([HAMMING84[((packet_number & 1) << 3) | mag],
                      HAMMING84[(packet_number >> 1) & 15]])

    def _row_line(self, row: int, data: bytes) -> bytearray:
        line = bytearray(45)
        line[0:3] = b"\x55\x55\x27"
        line[3:5] = self._addr(row)
        _paritycpy(line, 5, data, 40)
        return line

    def _fastext_line(self) -> bytearray:
        """Packet 27 with fastext links (src/teletext.c:320-383)."""
        line = bytearray(45)
        line[0:3] = b"\x55\x55\x27"
        line[3:5] = self._addr(27)
        line[5] = HAMMING84[0]
        mag = (self.page >> 8) & 7
        for i, lk in enumerate(self.links):
            if lk < 0x100:
                page, subcode = 0x8FF, 0x3F7F
            elif lk < 0x10000:
                page, subcode = lk, 0x3F7F
            else:
                page, subcode = lk >> 8, lk & 0xFF
            page ^= mag << 8
            o = 6 + 6 * i
            line[o + 0] = HAMMING84[page & 0x0F]
            line[o + 1] = HAMMING84[(page >> 4) & 0x0F]
            line[o + 2] = HAMMING84[subcode & 0x0F]
            line[o + 3] = HAMMING84[(((page >> 8) & 1) << 3)
                                    | ((subcode >> 4) & 7)]
            line[o + 4] = HAMMING84[(subcode >> 8) & 0x0F]
            line[o + 5] = HAMMING84[(((page >> 9) & 3) << 2)
                                    | ((subcode >> 12) & 3)]
        line[42] = HAMMING84[0x0F]
        line[43] = 0x12
        line[44] = 0x34
        return line

    def packet_number(self, idx: int) -> int:
        line = self.packets[idx]
        h = {int(v): i for i, v in enumerate(HAMMING84)}
        return (h.get(line[4], 0) << 1) | (h.get(line[3], 0) >> 3)

    def update_crc(self, header: bytearray):
        """Page CRC over header tail + rows 1..25 (src/teletext.c:450-487).
        The rows are static after load and the header tail only changes
        with the clock second, so the full fold is cached per header."""
        key = bytes(header[13:37])
        hit = getattr(self, "_crc_cache", None)
        if hit is not None and hit[0] == key:
            crc = hit[1]
        else:
            crc = crc16(key)
            blank = bytes(_PARITY[0x20:0x21]) * 40
            by_num = {self.packet_number(i): p
                      for i, p in enumerate(self.packets)}
            for l in range(1, 26):
                p = by_num.get(l)
                crc = crc16(bytes(p[5:45]) if p is not None else blank,
                            crc)
            self._crc_cache = (key, crc)
            self._by_num_27 = by_num.get(27)
        p27 = getattr(self, "_by_num_27", None)
        if p27 is not None:
            p27[43] = (crc >> 8) & 0xFF
            p27[44] = crc & 0xFF


class Magazine:
    def __init__(self, number: int):
        self.magazine = number
        self.pages: list[Page] = []    # ordered ring of top-level pages
        self.page_idx = 0
        self.row = 0
        self.delay = 0
        self.filler = False
        # subpage rings: page number -> list of Page, current index
        self.subpages: dict[int, list[Page]] = {}
        self.subidx: dict[int, int] = {}

    def current(self) -> Page:
        num = self.pages[self.page_idx]
        return self.subpages[num][self.subidx[num]]


class TeletextService:
    """Parallel-mode service (src/teletext.c:489-633)."""

    def __init__(self, lines_per_frame: int = 625, frame_rate: int = 25,
                 clock=None):
        self.magazines = [Magazine(8 if i == 0 else i) for i in range(8)]
        self.magazine = 1
        self.second_delay = frame_rate * lines_per_frame
        self.header_delay = int(20e-3 * self.second_delay + 0.5)
        self.timestamp = 0
        self.clock = clock or (lambda: int(_time.time()))

    # -- page management ------------------------------------------------
    def add_page(self, page: Page):
        mag = self.magazines[(page.page >> 8) & 7]
        page.erase = 1
        if page.page not in mag.subpages:
            mag.subpages[page.page] = []
            mag.subidx[page.page] = 0
            mag.pages.append(page.page)
            mag.pages.sort()
        ring = mag.subpages[page.page]
        for i, sp in enumerate(ring):
            if sp.subpage == page.subpage:
                ring[i] = page
                return
        ring.append(page)
        ring.sort(key=lambda p: p.subpage)

    # -- scheduling -----------------------------------------------------
    def _mk_header(self, page_num: int) -> bytes:
        t = _time.localtime(self.timestamp)
        s = ("hacktv   %03X %s %02d %s\x03%02d:%02d/%02d" % (
            page_num, _WEEKDAYS[t.tm_wday + 1 if t.tm_wday < 6 else 0],
            t.tm_mday, _MONTHS[t.tm_mon - 1], t.tm_hour, t.tm_min,
            t.tm_sec))
        return s.encode("latin-1")[:32]

    def _header_packet(self, magazine: int, page: int, subcode: int,
                       status: int, data: bytes) -> bytearray:
        line = bytearray(45)
        line[0:3] = b"\x55\x55\x27"
        line[3] = HAMMING84[((0 & 1) << 3) | (magazine & 7)]
        line[4] = HAMMING84[0]
        erase = (status >> 14) & 1
        newsflash = status & 1
        subtitle = (status >> 1) & 1
        suppress = (status >> 2) & 1
        update = (status >> 3) & 1
        interrupted = (status >> 4) & 1
        inhibit = (status >> 5) & 1
        charset = (status >> 7) & 7
        line[5] = HAMMING84[page & 0x0F]
        line[6] = HAMMING84[(page >> 4) & 0x0F]
        line[7] = HAMMING84[subcode & 0x0F]
        line[8] = HAMMING84[(erase << 3) | ((subcode >> 4) & 7)]
        line[9] = HAMMING84[(subcode >> 8) & 0x0F]
        line[10] = HAMMING84[(subtitle << 3) | (newsflash << 2)
                             | ((subcode >> 12) & 3)]
        line[11] = HAMMING84[(inhibit << 3) | (interrupted << 2)
                             | (update << 1) | suppress]
        line[12] = HAMMING84[charset << 1]
        _paritycpy(line, 13, data, 32)
        return line

    def _packet830(self) -> bytearray:
        """Broadcast service data packet 8/30 (src/teletext.c:188-257)."""
        line = bytearray(45)
        line[0:3] = b"\x55\x55\x27"
        line[3] = HAMMING84[((30 & 1) << 3) | (8 & 7)]
        line[4] = HAMMING84[(30 >> 1) & 15]
        line[5] = HAMMING84[0]
        initial_page, initial_subcode = 0x100, 0x3F7F
        line[6] = HAMMING84[initial_page & 0x0F]
        line[7] = HAMMING84[(initial_page >> 4) & 0x0F]
        line[8] = HAMMING84[initial_subcode & 0x0F]
        line[9] = HAMMING84[(((initial_page >> 8) & 1) << 3)
                            | ((initial_subcode >> 4) & 7)]
        line[10] = HAMMING84[(initial_subcode >> 8) & 0x0F]
        line[11] = HAMMING84[(((initial_page >> 9) & 3) << 2)
                             | ((initial_subcode >> 12) & 3)]
        t = _time.gmtime(self.timestamp)
        mjd = _mjd(t.tm_year, t.tm_mon, t.tm_mday)
        line[15] = mjd % 100000 // 10000 + 1
        line[16] = ((mjd % 10000 // 1000 + 1) << 4) | (mjd % 1000 // 100 + 1)
        line[17] = ((mjd % 100 // 10 + 1) << 4) | (mjd % 10 + 1)
        line[18] = ((t.tm_hour // 10 + 1) << 4) | (t.tm_hour % 10 + 1)
        line[19] = ((t.tm_min // 10 + 1) << 4) | (t.tm_min % 10 + 1)
        line[20] = ((t.tm_sec // 10 + 1) << 4) | (t.tm_sec % 10 + 1)
        _paritycpy(line, 25, b"hacktv", 20)
        return line

    def _next_magazine_packet(self, mag: Magazine, timecode: int):
        if mag.filler:
            header = self._mk_header(0x8FF)
            mag.filler = False
            return self._header_packet(mag.magazine & 7, 0xFF, 0x3F7F,
                                       0x8000, header)
        if not mag.pages:
            return None
        page = mag.current()
        if mag.row == 0:
            status = page.page_status & ~(1 << 14)
            status |= page.erase << 14
            page.erase = 0
            header = self._mk_header(page.page)
            line = self._header_packet(mag.magazine & 7, page.page & 0xFF,
                                       page.subcode, status, header)
            page.update_crc(line)
            mag.delay = timecode + self.header_delay
            mag.row += 1
        else:
            if (mag.row - 1 == page.nodelay_packets
                    and timecode < mag.delay):
                return None
            line = bytearray(page.packets[mag.row - 1])
            mag.row += 1

        if mag.row - 1 == len(page.packets):
            # advance the *next* page's subpage ring if it cycles
            nidx = (mag.page_idx + 1) % len(mag.pages)
            nnum = mag.pages[nidx]
            nring = mag.subpages[nnum]
            npage = nring[mag.subidx[nnum]]
            if npage.cycle_time and len(nring) > 1:
                adv = False
                if npage.cycle_mode == 0:
                    if timecode >= npage.cycle_count:
                        npage.cycle_count = (timecode + npage.cycle_time
                                             * self.second_delay)
                        adv = True
                else:
                    npage.cycle_count += 1
                    if npage.cycle_count == npage.cycle_time:
                        npage.cycle_count = 0
                        adv = True
                if adv:
                    ni = (mag.subidx[nnum] + 1) % len(nring)
                    nring[ni].cycle_count = npage.cycle_count
                    nring[ni].erase = 1
                    mag.subidx[nnum] = ni
            mag.page_idx = nidx
            mag.row = 0
            # single top-level page: send a filler header to end the page
            # (src/teletext.c:587-593)
            if len(mag.pages) == 1:
                mag.filler = True
        return line

    def next_packet(self, timecode: int):
        ts = self.clock()
        if self.timestamp != ts:
            self.timestamp = ts
            return self._packet830()
        for _ in range(8):
            mag = self.magazines[self.magazine]
            self.magazine = (self.magazine + 1) & 7
            line = self._next_magazine_packet(mag, timecode)
            if line is not None:
                return line
        return None


def load_tti(service: TeletextService, filename: str):
    """TTI page file loader (src/teletext.c:771-990)."""
    with open(filename, "rb") as f:
        data = f.read()
    if len(data) < 3 or not (65 <= data[0] <= 90 and 65 <= data[1] <= 90
                             and data[2:3] == b","):
        raise ValueError(f"{filename}: not a TTI file")

    page = Page()
    lines = np.full((25, 40), 0x20, dtype=np.uint8)

    def flush():
        nonlocal page, lines
        if page.page > 0:
            page.mkpackets(lines)
            service.add_page(page)
            old = page
            page = Page()
            page.subcode = old.subcode
            page.page_status = old.page_status
            page.cycle_time = old.cycle_time
            page.cycle_mode = old.cycle_mode
            page.links = list(old.links)
            page.page = old.page
            page.subpage = old.subpage
        lines = np.full((25, 40), 0x20, dtype=np.uint8)

    for raw in data.replace(b"\r", b"\n").split(b"\n"):
        if not raw:
            continue
        tag, _, rest = raw.partition(b",")
        tag = tag.decode("latin-1", "replace")
        if tag == "PN":
            flush()
            x = int(rest, 16)
            if x < 0x10000:
                page.page, page.subpage = x, 0
            else:
                page.page, page.subpage = x >> 8, x & 0xFF
        elif tag == "CT":
            parts = rest.split(b",")
            page.cycle_time = int(parts[0])
            page.cycle_mode = 1 if (len(parts) > 1 and
                                    parts[1][:1] in (b"C", b"c")) else 0
        elif tag == "PS":
            page.page_status = int(rest, 16)
        elif tag == "SC":
            page.subcode = int(rest, 16)
        elif tag == "OL":
            num, _, text = rest.partition(b",")
            x = int(num)
            if 0 < x < 25:
                esc = False
                c = 0
                for ch in text:
                    if ch == 0x1B:
                        esc = True
                        continue
                    if c >= 40:
                        break
                    lines[x][c] = ((ch - 0x40) if esc else ch) & 0x7F
                    c += 1
                    esc = False
        elif tag in ("DE", "FL") or len(tag) == 2:
            if tag == "FL":
                for c, v in enumerate(rest.split(b",")[:6]):
                    try:
                        page.links[c] = int(v, 16)
                    except ValueError:
                        pass
    flush()


def _open_source(service: TeletextService, path: str):
    """Load the pages of `path` (a .tti file or a directory of them) into
    `service`; for `raw:FILE` (or `raw:-`, standard input) of 42-byte
    packets, the open stream instead, else None."""
    if path.startswith("raw:"):
        return (sys.stdin.buffer if path[4:] == "-"
                else open(path[4:], "rb"))
    if os.path.isdir(path):
        for name in sorted(os.listdir(path)):
            if not name.startswith("."):
                try:
                    load_tti(service, os.path.join(path, name))
                except ValueError:
                    pass
    else:
        load_tti(service, path)
    return None


class Teletext:
    """Batch-encoder service wrapper."""

    STATICS = ("basis",)

    def ckpt_state(self):
        """Scheduler and page-ring state; the clock callable (which may
        not pickle) stays with the live encoder."""
        if self.raw is not None:
            raise NotImplementedError(
                "checkpoint with a raw: packet stream")
        svc = self.service
        clock = svc.clock
        svc.clock = None
        try:
            snap = copy.deepcopy(svc)
        finally:
            svc.clock = clock
        return {"service": snap,
                "pkt_cache": copy.deepcopy(self._pkt_cache)}

    def ckpt_load(self, d):
        clock = self.service.clock
        self.service = d["service"]
        self.service.clock = clock
        self._pkt_cache = dict(d["pkt_cache"])

    def __init__(self, params, path: str, clock=None, device="cuda"):
        p = params
        level = round((p.white_level - p.black_level) * 0.66)
        self.basis = vbidata.basis_rc(
            360, p.width, level, p.width / 444.0, 0.7,
            p.pixel_rate * (12e-6 - (64e-6 / 444 * 12)))
        self.lines_total = p.conf.lines
        self.service = TeletextService(p.conf.lines,
                                       round(float(p.conf.frame_rate)),
                                       clock)
        self.raw = _open_source(self.service, path)
        self._raw_eof = [False]
        # The scheduler is stateful per stream line; consecutive blocks
        # overlap on the halo lines, so packets are cached by absolute
        # line index and reused on the second visit.
        self._pkt_cache: dict[int, bytes | None] = {}
        self.device = torch.device(device)
        self.upload()

    def upload(self):
        """The basis on the device."""
        self.d_basis = torch.as_tensor(self.basis, device=self.device)

    def _eligible(self, line: int) -> bool:
        return 7 <= line <= 22 or 320 <= line <= 335

    def _row_packet(self, k: int):
        """Packet bytes for eligible stream line k (None = filler),
        advancing the scheduler exactly once per line."""
        if k in self._pkt_cache:
            return self._pkt_cache[k]
        frame = 1 + k // self.lines_total
        line = k % self.lines_total + 1
        timecode = (frame - 1) * self.lines_total + line - 1
        if self.raw is not None:
            pkt = _read_raw_packet(self.raw, self._raw_eof)
        else:
            pkt = self.service.next_packet(timecode)
        pkt = bytes(pkt) if pkt is not None else None
        self._pkt_cache[k] = pkt
        for old in [key for key in self._pkt_cache if key < k - 4]:
            del self._pkt_cache[old]
        return pkt

    def _row_bits(self, k: int) -> np.ndarray | None:
        """Single-line view (tests); production uses block_arrays."""
        line = k % self.lines_total + 1
        if not self._eligible(line):
            return None
        pkt = self._row_packet(k)
        return (vbidata.bytes_to_bits(pkt, 360, lsb_first=True)
                if pkt is not None else np.zeros(360, dtype=np.float32))

    def block_arrays(self, k0: int, nlines: int, claimed=None) -> dict:
        """Teletext bit rows for the block: eligibility is vectorised
        (32 of 625 lines carry packets) and the packet bytes unpack in
        one batch; only the stateful scheduler runs per eligible line."""
        ks = k0 + np.arange(nlines, dtype=np.int64)
        lines = ks % self.lines_total + 1
        elig = (((lines >= 7) & (lines <= 22))
                | ((lines >= 320) & (lines <= 335))) & (ks >= 0)
        if claimed is not None:
            elig &= ~np.asarray(claimed[:nlines], dtype=bool)
        rows = np.nonzero(elig)[0]
        packed = np.zeros((nlines, 45), dtype=np.uint8)
        for b in rows:
            pkt = self._row_packet(int(ks[b]))
            if pkt is not None:
                a = np.frombuffer(pkt, np.uint8)
                packed[b, :len(a)] = a[:45]
        return {"packed": packed}

    def apply(self, out, arrays, lut=None):
        bits = vbidata.device_unpack_bits(arrays["packed"], 360)
        return out + vbidata.render(bits, self.d_basis)


class MacTeletext:
    """Teletext packet feed for D/D2-MAC lines (src/mac.c:1556-1602):
    the same TTI service/scheduler, but packets are packed into the MAC
    line bit buffer instead of a VBI waveform."""

    def __init__(self, path: str, lines_per_frame: int = 625,
                 frame_rate: int = 25, clock=None):
        self.lines_total = lines_per_frame
        self.service = TeletextService(lines_per_frame, frame_rate, clock)
        self.raw = _open_source(self.service, path)
        self._raw_eof = [False]

    def next_vbi_bits(self, frame: int, line: int) -> np.ndarray | None:
        """360 bits (LSB-first per byte) of the next 45-byte packet, or
        None when no packet is ready."""
        timecode = (frame - 1) * self.lines_total + line - 1
        if self.raw is not None:
            pkt = _read_raw_packet(self.raw, self._raw_eof)
        else:
            pkt = self.service.next_packet(timecode)
        if pkt is None:
            return None
        return np.unpackbits(np.frombuffer(bytes(pkt), np.uint8),
                             bitorder="little")[:360]
