"""Nagravision Syster / Discret 11 / Syster cut-and-rotate scramblers
(src/syster.c; port of hacktv_tpu/services/syster.py).

Three PAL scrambling modes sharing one VBI/CA state machine:

* **Syster shuffle**: field-wide line permutation.  The permutation for
  each field segment comes from a dual-LFSR PRBS seeded by the 64-bit
  control word, expanded by Kuhn's algorithm over a 256-entry key table
  (src/syster.c:305-327).  In batch form the shuffle is one gather over
  the line axis with a per-line source index (lines can be pulled from up
  to ~344 lines ahead, so the service declares `lookahead`).
* **Cut-and-rotate (systercnr)**: per-line rotation of the active region
  by a shift from a 25-frame × 576-line table, applied alone (source =
  next line, like the decoder's 1-line delay) or combined with the
  shuffle (in place, before the shuffle gathers).
* **Discret 11**: one of three per-line delays (0/1/2 × ~902 ns) from an
  11-bit LFSR sequence over a 6-field cycle (src/syster.c:781-819).

All bit/PRBS/crypto work runs on the host per frame (the shuffle's PRBS
events through the native runtime's `rt_ng_event`, whose plain Python
versions are `_NGState._prbs_update` and `_update_field_order`); the
device applies per-line gathers (rotates, delays and shuffles as
`torch.gather` and row indexing) and adds the VBI waveform as a basis
product.  The audio inversion (`SysterAudioInverter`) is host numpy.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .. import runtime
from . import vbidata
from .syster_ca import encrypt_syster_cw

# ---------------------------------------------------------------------------
# Constants (src/syster.h:26-57)

NG_VBI_WIDTH = 284
NG_VBI_BYTES = 28
NG_MSG_BYTES = 84
NG_FIELD_1_START = 23
NG_FIELD_2_START = 336
NG_LINES_PER_FIELD = 287

D11_FIELD_1_START = 23
D11_FIELD_2_START = 335
D11_LINES_PER_FIELD = 286
D11_FIELDS = 6

NG_SAMPLE_RATE = 4_437_500
SCNR_WIDTH = NG_SAMPLE_RATE // 25 // 625      # 284
SCNR_LEFT = 46
SCNR_TOTAL_CUTS = 230

NG_DELAY_LINES = (625 + NG_FIELD_1_START + NG_LINES_PER_FIELD
                  - (NG_FIELD_2_START + NG_LINES_PER_FIELD - 32))  # 344

_PRBS_SR1_MASK = (1 << 31) - 1
_PRBS_SR2_MASK = (1 << 29) - 1

# Provider table (src/syster.c:75-85): id -> (key, data, date, vbioffset,
# key table).  data[4..7] are patched with the encoded broadcast date at
# init (src/syster.c:490-505 — note the reference's assignment-in-if bug
# makes the PPV-date branch unconditional, so bytes 4..7 all carry it).
_NG_MODES = {
    "premiere-fa": ((0xC4, 0xA5, 0xA8, 0x18, 0x74, 0x93, 0xC7, 0x65),
                    (0xFF, 0x01, 0x11, 0x00), "01/01/1999", 0, 1),
    "premiere-ca": ((0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x12, 0x34),
                    (0x7F, 0x01, 0x00, 0x00), "01/01/1999", 0, 1),
    "cplfa":       ((0xC4, 0xA5, 0xA8, 0x18, 0x74, 0x93, 0xC7, 0x65),
                    (0xFF, 0x05, 0x11, 0x00), "01/01/1997", -4, 1),
    "cfrca":       ((0x00, 0xAE, 0x52, 0x90, 0x49, 0xF1, 0xF1, 0xBB),
                    (0xFF, 0x01, 0x01, 0x00), "01/01/1997", -1, 2),
    "cfrfa":       ((0xC4, 0xA5, 0xA8, 0x18, 0x74, 0x93, 0xC7, 0x65),
                    (0xFF, 0x01, 0x11, 0x00), "01/01/1997", -1, 2),
    "cesfa":       ((0xC4, 0xA5, 0xA8, 0x18, 0x74, 0x93, 0xC7, 0x65),
                    (0x80, 0x01, 0x11, 0x00), "01/01/1997", -4, 1),
    "ntvfa":       ((0xC4, 0xA5, 0xA8, 0x18, 0x74, 0x93, 0xC7, 0x65),
                    (0x80, 0x08, 0x11, 0x00), "01/01/1997", 1, 2),
    "chorfa":      ((0xC4, 0xA5, 0xA8, 0x18, 0x74, 0x93, 0xC7, 0x65),
                    (0xFF, 0x01, 0x11, 0x00), "01/01/1997", -5, 2),
}

# Standard and Canal+ FR (Oct 1997) substitution tables
# (src/syster.c:109-146)
_KEY_TABLE1 = (
    10, 11, 12, 13, 16, 17, 18, 19, 13, 14, 15, 16, 0, 1, 2, 3,
    21, 22, 23, 24, 18, 19, 20, 21, 23, 24, 25, 26, 26, 27, 28, 29,
    19, 20, 21, 22, 11, 12, 13, 14, 28, 29, 30, 31, 4, 5, 6, 7,
    22, 23, 24, 25, 5, 6, 7, 8, 31, 0, 1, 2, 27, 28, 29, 30,
    3, 4, 5, 6, 8, 9, 10, 11, 14, 15, 16, 17, 25, 26, 27, 28,
    15, 16, 17, 18, 7, 8, 9, 10, 17, 18, 19, 20, 29, 30, 31, 0,
    24, 25, 26, 27, 20, 21, 22, 23, 1, 2, 3, 4, 6, 7, 8, 9,
    12, 13, 14, 15, 9, 10, 11, 12, 2, 3, 4, 5, 30, 31, 0, 1,
    24, 25, 26, 27, 2, 3, 4, 5, 31, 0, 1, 2, 7, 8, 9, 10,
    13, 14, 15, 16, 26, 27, 28, 29, 14, 15, 16, 17, 18, 19, 20, 21,
    22, 23, 24, 25, 5, 6, 7, 8, 19, 20, 21, 22, 12, 13, 14, 15,
    17, 18, 19, 20, 27, 28, 29, 30, 10, 11, 12, 13, 11, 12, 13, 14,
    6, 7, 8, 9, 1, 2, 3, 4, 0, 1, 2, 3, 4, 5, 6, 7,
    3, 4, 5, 6, 8, 9, 10, 11, 15, 16, 17, 18, 23, 24, 25, 26,
    29, 30, 31, 0, 25, 26, 27, 28, 9, 10, 11, 12, 21, 22, 23, 24,
    20, 21, 22, 23, 30, 31, 0, 1, 16, 17, 18, 19, 28, 29, 30, 31,
)
_KEY_TABLE2 = (
    10, 11, 12, 13, 16, 17, 18, 19, 12, 15, 14, 17, 0, 1, 2, 3,
    20, 23, 22, 25, 18, 19, 20, 21, 22, 25, 24, 27, 26, 27, 28, 29,
    18, 21, 20, 23, 10, 13, 12, 15, 28, 29, 30, 31, 4, 5, 6, 7,
    22, 23, 24, 25, 4, 7, 6, 9, 30, 1, 0, 3, 26, 29, 28, 31,
    2, 5, 4, 7, 8, 9, 10, 11, 14, 15, 16, 17, 24, 27, 26, 29,
    14, 17, 16, 19, 6, 9, 8, 11, 16, 19, 18, 21, 28, 31, 30, 1,
    24, 25, 26, 27, 20, 21, 22, 23, 0, 3, 2, 5, 6, 7, 8, 9,
    12, 13, 14, 15, 8, 11, 10, 13, 2, 3, 4, 5, 30, 31, 0, 1,
    24, 25, 26, 27, 2, 3, 4, 5, 30, 1, 0, 3, 6, 9, 8, 11,
    12, 15, 14, 17, 26, 27, 28, 29, 14, 15, 16, 17, 18, 19, 20, 21,
    22, 23, 24, 25, 4, 7, 6, 9, 18, 21, 20, 23, 12, 13, 14, 15,
    16, 19, 18, 21, 26, 29, 28, 31, 10, 11, 12, 13, 10, 13, 12, 15,
    6, 7, 8, 9, 0, 3, 2, 5, 0, 1, 2, 3, 4, 5, 6, 7,
    2, 5, 4, 7, 8, 9, 10, 11, 14, 17, 16, 19, 22, 25, 24, 27,
    28, 31, 30, 1, 24, 27, 26, 29, 8, 11, 10, 13, 20, 23, 22, 25,
    20, 21, 22, 23, 30, 31, 0, 1, 16, 17, 18, 19, 28, 29, 30, 31,
)

_VBI_SEQUENCE = (0x73, 0x9B, 0x5E, 0xB6, 0x49, 0xA1, 0x02, 0xEA, 0x15, 0xFD)

_DUMMY_EMM = (b"\xFF\xFF\xFF\xFF" + b"DUMMYEMM" * 8 + b"\x9E\x4D\xDC\xF0")
_PPUA_EMM = bytes((
    0x00, 0x40, 0x00, 0x00, 0x43, 0x43, 0x41, 0x80, 0x69, 0x4A, 0x10, 0x22,
    0xE3, 0xA9, 0x9A, 0xF8, 0xB9, 0x0F, 0xD4, 0xEF, 0x6E, 0x8A, 0x30, 0xCF,
    0xA4, 0xCD, 0xAD, 0x83, 0x4D, 0xA3, 0x1C, 0xB0, 0x2F, 0x78, 0xCE, 0xE9,
    0xA8, 0xDE, 0xBB, 0x4A, 0x06, 0xF0, 0x27, 0x4C, 0xA6, 0xBD, 0xAD, 0x67,
    0x9C, 0xEB, 0xAD, 0xAE, 0xD2, 0xA5, 0x31, 0xC9, 0x51, 0x58, 0x0D, 0x72,
    0xF5, 0x7B, 0xF4, 0x74, 0x2D, 0x45, 0x3D, 0xB1, 0x87, 0x78, 0x21, 0x69))

# ECM table interleave / parameter sequences (src/syster.c:260-267)
_ECM_IL = (0x00, 0x01, 0x30, 0x31, 0x40, 0x41, 0x20, 0x21, 0x60, 0x61,
           0x00, 0x01, 0x7E, 0x7F, 0x50, 0x51, 0x70, 0x71, 0x10, 0x11)
_ECM_AP = (0x01, 0x0F, 0x05, 0x05, 0x05, 0x05, 0x05, 0x05, 0x05, 0x05,
           0x01, 0x00, 0x05, 0x05, 0x05, 0x05, 0x05, 0x05, 0x05, 0x05)

_SEQ_FILE = os.path.join(os.path.dirname(__file__), "data",
                         "scramble_sequences.npz")


def _crc16_table() -> list:
    tab = []
    for b in range(256):
        crc = b
        for _ in range(8):
            crc = (crc >> 1) ^ 0xC003 if crc & 1 else crc >> 1
            crc &= 0xFFFF
        tab.append(crc)
    return tab


_CRC16_TAB = _crc16_table()


def _crc16(data) -> int:
    """CRC-16, poly 0xC003 reflected (src/syster.c:191-208)."""
    crc = 0
    tab = _CRC16_TAB
    for byte in data:
        crc = (crc >> 8) ^ tab[(crc ^ byte) & 0xFF]
    return crc


def _get_date(dtm: str) -> int:
    """Broadcast-date encoding (src/syster.c:460-465)."""
    day, mon, year = (int(x) for x in dtm.split("/"))
    h = 1 if mon > 6 else 0
    return 0x8000 | (year - 1990) << 9 | h << 8 | ((h + mon % 7) << 5) | day


class _NGState:
    """Host-side sequential state shared by Syster/D11: static ECM table,
    VBI block assembly, shuffle PRBS (src/syster.c:158-189, 258-327,
    353-421)."""

    def __init__(self, mode: str, *, syster: bool, systercnr: bool,
                 d11: bool = False, key_table: int = 0):
        if mode not in _NG_MODES:
            raise ValueError(f"unrecognised Syster mode {mode!r}")
        key, data4, date, vbioffset, t = _NG_MODES[mode]
        d = _get_date(date)
        self.data = list(data4) + [d & 0xFF, d >> 8, d & 0xFF, d >> 8]
        self.key = list(key)
        self.vbioffset = vbioffset
        # --key-table-1/2 overrides the provider default
        # (src/hacktv.c:801-807, src/syster.c:509-514)
        self.table = _KEY_TABLE1 if (key_table or t) == 1 else _KEY_TABLE2

        # STATIC_ECM table: all 64 entries identical (src/syster.c:443-458)
        ecm = [(i if (i < 4 or i > 11) else self.data[i - 4])
               for i in range(16)]
        self.ecm_cw = encrypt_syster_cw(ecm, self.key)  # encrypts in place
        self.ecm = bytes(ecm)

        if d11:
            flags = 0x30
        else:
            flags = (0x60 | 1 << 4 | (0 if t == 1 else 1) << 3
                     | (1 if systercnr else 0) << 2
                     | (1 if syster else 0) << 1)
        self.flags = flags

        self.syster = syster
        self.vbi_seq = 0
        self.block_seq = 0
        self.next_ppua = 0
        self.vbi = [bytes(NG_VBI_BYTES)] * 10

        # PRBS / field order state
        self.cw = 0
        self.sr1 = 0
        self.sr2 = 0
        self.s = 0
        self.r = 0
        self.order = [0] * NG_LINES_PER_FIELD
        self._update_field_order()

        # caches: per stream frame
        self._vbi_lines: dict[int, bytes] = {}   # key: stream line index k
        self._src_rel: dict[int, np.ndarray] = {}
        self._done_frame = 0
        self.retain = 8        # frames kept; widened per consumer block

    # -- PRBS ------------------------------------------------------------
    def _prbs_reset(self):
        self.sr1 = self.cw & _PRBS_SR1_MASK
        self.sr2 = (self.cw >> 32) & _PRBS_SR2_MASK

    def _prbs_update(self) -> int:
        code = 0
        sr1, sr2 = self.sr1, self.sr2
        for _ in range(16):
            sr1 = (sr1 >> 1) ^ (0x7BB88888 if sr1 & 1 else 0)
            sr2 = (sr2 >> 1) ^ (0x17A2C100 if sr2 & 1 else 0)
            a = (sr2 >> 24) & 0x1F
            if a == 31:
                a = 30
            code = ((code << 1) | ((sr1 >> a) & 1)) & 0xFFFF
        self.sr1, self.sr2 = sr1, sr2
        return code >> 1

    def _update_field_order(self):
        """Kuhn's expansion of (s, r) into the 287-line permutation
        (src/syster.c:305-327).  The loop's only cross-iteration state
        is the per-bucket previous index b[j], so a stable sort by
        bucket turns it into groupwise predecessor links."""
        s2 = 2 * self.s + 1
        i = np.arange(NG_LINES_PER_FIELD, dtype=np.int64)
        js = np.where(i <= 254,
                      np.asarray(self.table)[(self.r + s2 * i) & 0xFF],
                      i - 255)
        perm = np.argsort(js, kind="stable")
        js_s = js[perm]
        prev = np.empty(NG_LINES_PER_FIELD, dtype=np.int64)
        same = np.zeros(NG_LINES_PER_FIELD, dtype=bool)
        same[1:] = js_s[1:] == js_s[:-1]
        prev[~same] = js_s[~same] - 32        # initial b[j] = j - 32
        prev[np.nonzero(same)[0]] = perm[np.nonzero(same)[0] - 1]
        # entries whose bucket sees no later element keep their previous
        # value, exactly like the reference's persistent order[] array
        order = np.asarray(self.order, dtype=np.int64)
        order[prev + 32] = perm
        self.order = order.tolist()

    # -- VBI -------------------------------------------------------------
    def _ecm_part(self) -> bytes:
        """10 bytes of ECM addressing + payload (src/syster.c:258-303)."""
        bs = self.block_seq
        c = (bs // 20 * 2 + _ECM_IL[bs % 20]) & 0x7F
        d = self.ecm[8:16] if c & 1 else self.ecm[0:8]
        if _ECM_AP[bs % 20] == 0x00:
            self.cw = self.ecm_cw
        c = (c << 4) | _ECM_AP[bs % 20]
        return bytes((c >> 8, c & 0xFF)) + d

    def _pack_vbi_block(self, msg1: bytes, msg2: bytes):
        """Layout + XOR parity lines + CRC (src/syster.c:210-256)."""
        vbi = [bytearray(NG_VBI_BYTES) for _ in range(10)]
        for row, msg, off in ((4, msg2, 0), (5, msg2, 21), (2, msg2, 42),
                              (3, msg2, 63), (8, msg1, 0), (9, msg1, 21),
                              (6, msg1, 42), (7, msg1, 63)):
            vbi[row][5:26] = msg[off:off + 21]
        for x in range(5, 26):
            for i in range(2, 10):
                vbi[i & 1][x] ^= vbi[i][x]
        for i in range(10):
            vbi[i][0:4] = b"\x55\xD0\x18\x6C"
            vbi[i][4] = _VBI_SEQUENCE[i]
            crc = _crc16(vbi[i][4:26])
            vbi[i][26] = crc & 0xFF
            vbi[i][27] = crc >> 8
        self.vbi = [bytes(v) for v in vbi]

    def _build_vbi_block(self, frame: int):
        """(src/syster.c:366-410)"""
        emm1 = _DUMMY_EMM
        if frame > self.next_ppua:
            emm1 = _PPUA_EMM
            self.next_ppua = frame + 1000
        msg1 = bytearray(NG_MSG_BYTES)
        msg1[0] = self.flags | ((self.data[2] >> 5) & 1)
        msg1[1:11] = self._ecm_part()
        msg1[1] |= (self.data[2] << 3) & 0xFF
        chk = 0xFF
        for x in range(11):
            chk ^= msg1[x]
        msg1[11] = chk
        msg1[12:84] = emm1
        msg2 = bytearray(NG_MSG_BYTES)
        msg2[0] = 0xFE
        msg2[1] = 0x28 | ((self.flags >> 2) & 1)
        msg2[2] = 0xB1
        msg2[3] = 0x01 if emm1 is _PPUA_EMM else 0x00
        msg2[12:84] = _DUMMY_EMM
        self._pack_vbi_block(bytes(msg1), bytes(msg2))
        self.block_seq += 1

    # -- per-frame generation ---------------------------------------------
    _LS_GRID = None     # class-level cached per-line geometry

    @classmethod
    def _ls_grid(cls):
        if cls._LS_GRID is None:
            ls = np.arange(1, 626, dtype=np.int64)
            f = np.where(ls < NG_FIELD_2_START, 1, 2)
            i = ls - np.where(f == 1, NG_FIELD_1_START,
                              NG_FIELD_2_START)
            inband = (i >= 0) & (i < NG_LINES_PER_FIELD)
            i2 = i + 32
            swap = i2 >= NG_LINES_PER_FIELD
            i2 = np.where(swap, i2 - NG_LINES_PER_FIELD, i2)
            f2 = np.where(swap, 3 - f, f)
            base = np.where(f2 == 1, NG_FIELD_1_START,
                            NG_FIELD_2_START)
            e1 = NG_FIELD_1_START + NG_LINES_PER_FIELD - 32
            e2 = NG_FIELD_2_START + NG_LINES_PER_FIELD - 32
            seg = (ls >= e1).astype(np.int64) + (ls >= e2)
            cls._LS_GRID = (ls, inband,
                            np.clip(i2, 0, NG_LINES_PER_FIELD - 1),
                            base, seg, e1, e2)
        return cls._LS_GRID

    def _event(self, frame: int, field: int):
        """PRBS event at the line whose wrapped field index is 0
        (src/syster.c:706-724); `field` is the post-swap field.  Runs in
        the native runtime (runtime.ng_event); `_event_plain` is the same
        step in Python."""
        sf = frame % 50
        if (sf == 6 or sf == 31) and field == 1:
            self._prbs_reset()
        st = getattr(self, "_ng_st", None)
        if st is None:
            st = self._ng_st = np.zeros(4, dtype=np.uint64)
            self._ng_tab = np.ascontiguousarray(self.table, dtype=np.uint8)
            self._ng_ord = np.ascontiguousarray(self.order, dtype=np.int32)
        st[0] = self.sr1
        st[1] = self.sr2
        runtime.ng_event(st, self._ng_tab, self._ng_ord)
        self.sr1, self.sr2 = int(st[0]), int(st[1])
        self.s, self.r = int(st[2]), int(st[3])
        self.order = self._ng_ord

    def _event_plain(self):
        """One PRBS event in Python: the plain version of
        runtime.ng_event."""
        x = self._prbs_update()
        self.s = x & 0x7F
        self.r = x >> 7
        self._update_field_order()

    def _vbi_line(self, frame: int, line: int):
        if self.vbi_seq == 0:
            self._build_vbi_block(frame)
        k = (frame - 1) * 625 + (line - 1)
        self._vbi_lines[k] = self.vbi[self.vbi_seq]
        self.vbi_seq = (self.vbi_seq + 1) % 10

    def _gen_frame(self, frame: int):
        """Advance all sequential state across frame `frame` (1-based),
        caching VBI bytes per line and the shuffle source offsets.
        The reference's per-line loop (src/syster.c:692-748) reduces to
        one vectorised pass: the shuffle order only changes at the two
        PRBS-event lines, so three order snapshots cover the frame; the
        VBI-carrier lines run in stream order between the events."""
        ls, inband, i2, base, seg, e1, e2 = self._ls_grid()
        src = np.zeros(626, dtype=np.int32)
        voff = self.vbioffset
        vlines = (14 + voff, 15 + voff, 327 + voff, 328 + voff)
        if not self.syster:
            for line in vlines:
                self._vbi_line(frame, line)
        else:
            orders = np.empty((3, NG_LINES_PER_FIELD), dtype=np.int64)
            orders[0] = self.order
            for line in vlines:
                if line < e1:
                    self._vbi_line(frame, line)
            self._event(frame, 2)
            orders[1] = self.order
            for line in vlines:
                if e1 <= line < e2:
                    self._vbi_line(frame, line)
            self._event(frame, 1)
            orders[2] = self.order
            for line in vlines:
                if line >= e2:
                    self._vbi_line(frame, line)
            j = base + orders[seg, i2]
            j = np.where(j < ls, j + 625, j)
            src[1:] = np.where(inband, j - ls, 0)
        self._src_rel[frame] = src
        self._done_frame = frame
        # retain enough frames for the consumer's whole block: the
        # encoder's lookahead advances generation past the block end
        # before the early lines' VBI bytes are gathered
        old = frame - self.retain
        for f in [f for f in self._src_rel if f <= old]:
            del self._src_rel[f]
        for k in [k for k in self._vbi_lines if k < (old - 1) * 625]:
            del self._vbi_lines[k]

    def advance_to(self, frame: int):
        while self._done_frame < frame:
            self._gen_frame(self._done_frame + 1)

    def shuffle_src(self, frame: int) -> np.ndarray:
        self.advance_to(frame)
        return self._src_rel[frame]

    def vbi_for_line(self, k: int):
        self.advance_to(k // 625 + 1)
        return self._vbi_lines.get(k)


def _load_sequences():
    z = np.load(_SEQ_FILE)
    return (z["systercnr"].astype(np.int32),
            z["systercnr_shuffle"].astype(np.int32))


def _ng_vbi_basis(p) -> np.ndarray:
    """284-symbol RC basis at 66% white (src/syster.c:329-351); the data
    bits start at symbol 45 (render offset, src/syster.c:414)."""
    level = round((p.white_level - p.black_level) * 0.66)
    basis = vbidata.basis_rc(NG_VBI_WIDTH, p.width, level,
                             p.width / NG_VBI_WIDTH, 0.7, 0.0)
    return basis[45:45 + NG_VBI_BYTES * 8]


def _video_scale(p) -> np.ndarray:
    """Nearest-sample map from 284-pixel NG timing to the device line
    (src/syster.c:563-567)."""
    return np.round(np.arange(8520) * p.width / NG_VBI_WIDTH
                    ).astype(np.int64)


def _rotate_columns(p, vs: np.ndarray) -> tuple[np.ndarray, int, int]:
    """Per-shift source-column table for the cut-and-rotate region
    (src/syster.c:642-666).  Returns (src_cols[shift, R-L], L, R)."""
    ng_delay = int((1.0 / 4433618.75) * 4 * p.pixel_rate)
    L = int(vs[SCNR_LEFT])
    R = int(vs[SCNR_LEFT + SCNR_TOTAL_CUTS])
    wrap = int(vs[SCNR_LEFT + 5])
    n = R - L
    # table shift values are 1..225, well inside the cut width
    cols = np.zeros((SCNR_TOTAL_CUTS + 1, n), dtype=np.int32)
    for shift in range(SCNR_TOTAL_CUTS + 1):
        y = int(vs[SCNR_LEFT + SCNR_TOTAL_CUTS - shift])
        for x in range(n):
            cols[shift, x] = y - ng_delay
            if y >= R:
                y = wrap
            y += 1
    return cols, L, R


class SysterBase:
    """Shared pieces: VBI arrays + basis."""

    _CKPT_ATTRS = ("state",)

    def __init__(self, p, mode: str, device="cuda", **flags):
        if p.conf.lines != 625:
            raise ValueError("syster: requires a 625-line mode")
        self.p = p
        self.state = _NGState(mode, **flags)
        self.basis = _ng_vbi_basis(p)
        self.width = p.width
        self.device = torch.device(device)

    def upload(self):
        """The basis (and a cut-and-rotate's column table) on the
        device."""
        self.d_basis = torch.as_tensor(self.basis, device=self.device)
        if getattr(self, "cols", None) is not None:
            self.d_cols = torch.as_tensor(self.cols.astype(np.int64),
                                          device=self.device)
        cols = torch.arange(self.width, dtype=torch.int64,
                            device=self.device)
        self.d_colidx = cols[None, :]

    def _grid(self, k0: int, nlines: int):
        ks = k0 + np.arange(nlines, dtype=np.int64)
        valid = ks >= 0
        lines = np.where(valid, ks % 625 + 1, 0)
        frames = np.where(valid, ks // 625 + 1, 0)
        return ks, valid, lines, frames

    def _vbi_arrays(self, k0: int, nlines: int, claimed):
        """Packed VBI message bytes per line (4 carrier lines per
        frame; all other rows stay zero)."""
        st = self.state
        st.retain = max(st.retain, nlines // 625 + 9)
        ks, valid, lines, frames = self._grid(k0, nlines)
        packed = np.zeros((nlines, NG_VBI_BYTES), dtype=np.uint8)
        off = st.vbioffset
        vbis = np.isin(lines, (14 + off, 15 + off, 327 + off,
                               328 + off)) & valid
        for i in np.nonzero(vbis)[0]:
            by = st.vbi_for_line(int(ks[i]))
            if by is not None:
                packed[i] = np.frombuffer(bytes(by),
                                          np.uint8)[:NG_VBI_BYTES]
                if claimed is not None:
                    claimed[i] = True
        return packed

    def _vbi_render(self, arrays):
        bits = vbidata.device_unpack_bits(arrays["vbi_packed"],
                                          NG_VBI_BYTES * 8)
        return vbidata.render(bits, self.d_basis)


class Syster(SysterBase):
    """Line-shuffle scrambler, optionally combined with cut-and-rotate
    (src/syster.c:668-766)."""

    lookahead = NG_DELAY_LINES

    def __init__(self, p, mode: str = "premiere-fa", cnr: bool = False,
                 key_table: int = 0, device="cuda"):
        super().__init__(p, mode, device, syster=True, systercnr=cnr,
                         key_table=key_table)
        self.cnr = cnr
        self.cols = None
        self.STATICS = ("basis",)
        if cnr:
            vs = _video_scale(p)
            seq, seq_shuffle = _load_sequences()
            self.seq = seq_shuffle
            self.cols, self.rot_l, self.rot_r = _rotate_columns(p, vs)
            self.STATICS = ("basis", "cols", "seq")
        self.upload()

    def upload(self):
        super().upload()
        cols = self.d_colidx[0]
        self.d_right = (cols >= self.p.active_left)[None, :]

    def block_arrays(self, k0: int, nlines: int, claimed=None) -> dict:
        st = self.state
        st.retain = max(st.retain, nlines // 625 + 9)
        ks, valid, lines, frames = self._grid(k0, nlines)
        src = np.zeros(nlines, dtype=np.int32)
        if valid.any():
            fmax = int(frames.max())
            st.advance_to(fmax)
            fmin = int(frames[valid].min())
            F = np.stack([st._src_rel[f]
                          for f in range(fmin, fmax + 1)])
            rel = F[np.where(valid, frames - fmin, 0), lines]
            src = np.minimum(
                rel, nlines - 1 - np.arange(nlines)).astype(np.int32)
            src[~valid] = 0
        rot_shift = np.full(nlines, -1, dtype=np.int32)
        rot_blank = np.zeros(nlines, dtype=np.float32)
        if self.cnr:
            act = (((lines >= 23) & (lines <= 310))
                   | ((lines >= 336) & (lines <= 623))) & valid
            # The in-window rotate of line k runs while the encoder's
            # frame counter still reads the output line 346 earlier
            # (src/syster.c:684-689 passes s->frame, which trails
            # lines[nlines-1] by the pipeline stagger; 0 during the
            # initial warm-up, src/video.c:4948).
            kf = ks - 346
            row = np.where(kf < 0, 0, (kf // 625 + 1) % 25)
            cidx = np.clip(np.where(lines < 336, lines - 23,
                                    lines - 336 + 288),
                           0, self.seq.shape[1] - 1)
            rot_shift = np.where(act, self.seq[row, cidx],
                                 -1).astype(np.int32)
            rot_blank = (act & ((lines == 310) | (lines == 622))
                         ).astype(np.float32)
        vbi = self._vbi_arrays(k0, nlines, claimed)
        return {"vbi_packed": vbi, "src": src, "rot_shift": rot_shift,
                "rot_blank": rot_blank}

    def apply(self, out, arrays, lut=None):
        """Device: the cut-and-rotate in place first (with cnr), then the
        row gather of the shuffle from column active_left on, then the
        VBI bits."""
        B = out.shape[0]
        if self.cnr:
            out = _apply_rotate(out, arrays, self.d_cols, self.rot_l,
                                self.rot_r, out)
        src = arrays["src"].to(torch.int64)
        rows = torch.arange(B, dtype=torch.int64, device=out.device)
        gathered = out[torch.clamp(rows + src, 0, B - 1)]
        # the 0/1 blend out * (1 - mask) + gathered * mask, as a select
        out = torch.where(self.d_right & (src > 0)[:, None], gathered, out)
        return out + self._vbi_render(arrays)


def _apply_rotate(src_block, arrays, cols_tab, L, R, dst_block):
    """Rotate the active cut region of each flagged line.  `src_block`
    provides source content (the line itself, or the next line for
    cnr-alone); `dst_block` is what the result overwrites.  The 0/1
    blends of the reference's form are selects."""
    W = dst_block.shape[1]
    shift = arrays["rot_shift"].to(torch.int64)
    active = (shift >= 0)[:, None]
    cols = cols_tab[shift.clamp(0, cols_tab.shape[0] - 1)]   # [B, R-L]
    rot = torch.gather(src_block, 1, cols.clamp(0, W - 1))
    # the blanked lines' level (src/syster.c:663)
    rot = torch.where((arrays["rot_blank"] > 0)[:, None], 16056.0, rot)
    region = torch.where(active, rot, dst_block[:, L:R])
    return torch.cat([dst_block[:, :L], region, dst_block[:, R:]], dim=1)


class SysterCNR(SysterBase):
    """Cut-and-rotate alone: source is the next line (src/syster.c:753-761
    reads lines[1])."""

    STATICS = ("basis", "cols", "seq")
    lookahead = 2

    def __init__(self, p, mode: str = "premiere-fa",
                 key_table: int = 0, device="cuda"):
        super().__init__(p, mode, device, syster=False, systercnr=True,
                         key_table=key_table)
        vs = _video_scale(p)
        seq, _seq_shuffle = _load_sequences()
        self.seq = seq
        self.cols, self.rot_l, self.rot_r = _rotate_columns(p, vs)
        self.upload()

    def block_arrays(self, k0: int, nlines: int, claimed=None) -> dict:
        st = self.state
        st.retain = max(st.retain, nlines // 625 + 9)
        ks, valid, lines, frames = self._grid(k0, nlines)
        if valid.any():
            st.advance_to(int(frames.max()))
        act = (((lines >= 23) & (lines <= 310))
               | ((lines >= 336) & (lines <= 623))) & valid
        cidx = np.clip(np.where(lines < 336, lines - 23,
                                lines - 336 + 288),
                       0, self.seq.shape[1] - 1)
        rot_shift = np.where(act, self.seq[frames % 25, cidx],
                             -1).astype(np.int32)
        rot_blank = (act & ((lines == 310) | (lines == 622))
                     ).astype(np.float32)
        vbi = self._vbi_arrays(k0, nlines, claimed)
        return {"vbi_packed": vbi, "rot_shift": rot_shift,
                "rot_blank": rot_blank}

    def apply(self, out, arrays, lut=None):
        nxt = torch.cat([out[1:], out[-1:]], dim=0)
        out = _apply_rotate(nxt, arrays, self.d_cols, self.rot_l,
                            self.rot_r, out)
        return out + self._vbi_render(arrays)


class SysterAudioInverter:
    """Audio spectrum inversion below 12.8 kHz (src/syster.c:582-639):
    complex mix with a period-5 12.8 kHz carrier LUT, 771-tap one-sideband
    FIR, real part out — reproduced bit-exactly including the reference's
    int16 wraparounds at each store."""

    NTAPS = 771

    def __init__(self):
        z = np.load(_SEQ_FILE)
        self.firi = z["ng_firi"].astype(np.int64)
        self.firq = z["ng_firq"].astype(np.int64)
        self.mixi = z["ng_mixi"].astype(np.int64)
        self.mixq = z["ng_mixq"].astype(np.int64)

    @staticmethod
    def _wrap16(a: np.ndarray) -> np.ndarray:
        return ((a + 32768) & 0xFFFF) - 32768

    @staticmethod
    def _wrap32(a: np.ndarray) -> np.ndarray:
        return ((a + 2**31) & 0xFFFFFFFF) - 2**31

    def process(self, read_audio, start: int, count: int) -> np.ndarray:
        """Inverted stereo pairs for absolute audio indices
        [start, start+count); indices < 0 read as silence."""
        nt = self.NTAPS
        h0 = start - (nt - 1)
        raw = np.zeros((count + nt - 1, 2), dtype=np.int64)
        lo = max(h0, 0)
        if lo < start + count:
            raw[lo - h0:] = read_audio(lo, start + count - lo)
        phase = np.arange(h0, start + count, dtype=np.int64) % 5
        mi = self.mixi[phase][:, None]
        mq = self.mixq[phase][:, None]
        xi = self._wrap16((raw * (mi - mq)) >> 15)
        xq = self._wrap16((raw * (mq + mi)) >> 15)
        out = np.empty((count, 2), dtype=np.int64)
        # The true accumulator is an integer with |acc| <= 771 * 32767^2
        # ~ 8.3e11 < 2^53, and overlap-add FFT convolution's absolute
        # error here is ~1e-3 — far below the 0.5 needed for round() to
        # recover the exact integer, and ~100x faster than the direct
        # int64 path.
        # xi*ri - xq*rq = Re((xi + j xq) * (ri + j rq)): one complex
        # convolution replaces four real ones, both channels batched.
        # Fixed-size overlap-save with the tap spectrum cached: the
        # block sizes repeat every call, so scipy's oaconvolve planning
        # and per-call tap FFT are pure overhead.
        x = xi.astype(np.float64) + 1j * xq.astype(np.float64)
        N = 1 << 14
        R = getattr(self, "_R", None)
        if R is None:
            r = (self.firi[::-1] + 1j * self.firq[::-1]
                 ).astype(np.complex128)
            R = self._R = np.fft.fft(r, N)
        step = N - (nt - 1)
        nseg = -(-count // step)
        xp = np.zeros((nseg * step + nt - 1, 2), dtype=np.complex128)
        xp[:len(x)] = x
        segs = np.stack([xp[s * step:s * step + N] for s in range(nseg)])
        Y = np.fft.fft(segs, axis=1) * R[None, :, None]
        y = np.fft.ifft(Y, axis=1)[:, nt - 1:].reshape(-1, 2)[:count]
        acc = np.round(y.real).astype(np.int64)
        out[:, :] = self._wrap16(self._wrap32(acc) >> 15)
        return out


def _d11_delay_table() -> np.ndarray:
    """Per-line delay indices over the 6-field D11 cycle
    (src/syster.c:781-819)."""
    lookup = (0x00, 0x01, 0x02, 0x02, 0x02, 0x00, 0x00, 0x01)
    table = np.zeros(D11_LINES_PER_FIELD * D11_FIELDS, dtype=np.int32)
    seed = 0x672
    field = -1
    for line in range(D11_LINES_PER_FIELD * D11_FIELDS):
        if line % D11_LINES_PER_FIELD == 0:
            field += 1
        b10 = (seed >> 10) & 1
        b8 = (seed >> 8) & 1
        idx = (((field // 3) & 1) << 2) | ((seed & 1) << 1) | b10
        table[line] = lookup[idx]
        seed = ((seed << 1) | (b10 ^ b8)) & 0x7FF
    return table


class D11(SysterBase):
    """Discret 11 free-access scrambler (src/syster.c:821-909)."""

    STATICS = ("basis", "table")
    lookahead = 1

    def __init__(self, p, mode: str = "premiere-fa", device="cuda"):
        super().__init__(p, mode, device, syster=False, systercnr=False,
                         d11=True)
        self.table = _d11_delay_table()
        self.ng_delay = int((1.0 / 4433618.75) * 4 * p.pixel_rate)
        self.upload()

    def upload(self):
        super().upload()
        cols = self.d_colidx[0]
        al, aw = self.p.active_left, self.p.active_width
        self.d_active = ((cols >= al) & (cols < al + aw))[None, :]

    def block_arrays(self, k0: int, nlines: int, claimed=None) -> dict:
        st = self.state
        st.retain = max(st.retain, nlines // 625 + 9)
        ks, valid, lines, frames = self._grid(k0, nlines)
        if valid.any():
            st.advance_to(int(frames.max()))
        f = (lines >= D11_FIELD_2_START).astype(np.int64)
        fl = lines - np.where(f == 0, D11_FIELD_1_START,
                              D11_FIELD_2_START)
        in_field = (fl > 0) & (fl < D11_LINES_PER_FIELD) & valid
        d11_field = (frames % 3) * 2 + f
        idx = (np.where(d11_field == 5, 0, d11_field + 1)
               * D11_LINES_PER_FIELD + np.clip(fl, 0, None))
        delay = np.where(in_field,
                         self.table[np.clip(idx, 0,
                                            len(self.table) - 1)],
                         -1).astype(np.int32)
        sync_on = (valid & ((lines == 622) | (lines == 310))
                   ).astype(np.float32)
        sync = np.where(
            lines == 622, self.p.white_level,
            np.where(frames % 3 == 2, self.p.white_level,
                     self.p.black_level)).astype(np.float32) * sync_on
        bits = self._vbi_arrays(k0, nlines, claimed)
        return {"vbi_packed": bits, "delay": delay, "sync": sync,
                "sync_on": sync_on}

    def apply(self, out, arrays, lut=None):
        """Device: each delayed line read 0-2 delay steps back over the
        active width, then the sync levels of lines 310 and 622, then the
        VBI bits.  The 0/1 blends of the reference's form are selects."""
        p = self.p
        al, aw, D = p.active_left, p.active_width, self.ng_delay
        cols = self.d_colidx
        delay = arrays["delay"].to(torch.int64)
        # src col = x + 2D - delay while x + D < al+aw, else x
        # (src/syster.c:870-886)
        src = torch.where(cols + D < al + aw, cols + 2 * D - delay[:, None]
                          * D, cols)
        delayed = torch.gather(out, 1, src.clamp(0, out.shape[1] - 1))
        out = torch.where(self.d_active & (delay >= 0)[:, None], delayed,
                          out)
        smask = self.d_active & (arrays["sync_on"] > 0)[:, None]
        out = torch.where(smask, arrays["sync"][:, None], out)
        return out + self._vbi_render(arrays)
