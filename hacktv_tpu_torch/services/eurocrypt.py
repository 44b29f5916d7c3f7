"""Eurocrypt conditional access for D/D2-MAC.

Port of hacktv_tpu/services/eurocrypt.py, pure Python as there.  Host-side
bit/crypto domain: generates the encrypted control words, ECM packets
(sent every 64 frames on address 346) and EMM Global/Shared/Unique
packets (every 256 frames on address 347), and rotates the MAC scrambler
control word every 256 frames.  Behavioural reference: src/eurocrypt.c
(EC-M/S/S2/3DES cipher :286-648, ECM packets :879-1031, EMM packets
:1033-1506, scheduling :1541-1758).

Everything here is tiny sequential byte-domain work; it runs on the
host ahead of the waveform synthesis on the device and feeds the
`MacMux` packet queue (video/mac.py).  `now=` pins the wall clock that
`TODAY` providers and every provider's current day read.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

from ..ops import mac_bits as mb

ECM_PAYLOAD_BYTES = 45
MAC_PAYLOAD_BYTES = 91

# Packet-type / algorithm identifiers (src/eurocrypt.c:29-32)
EC_M = 0x20
EC_S = 0x01
EC_S2 = 0x30
EC_3DES = 0x31

# EMM packet types (src/eurocrypt.h:23-26)
EMMU = 0x00
EMMS = 0xF8
EMMC = 0xC7
EMMG = 0x3F

_ECM = 0      # desmode: ECM/EMM decryption schedule
_HASH = 1     # desmode: hash schedule

THEME_ENTERTAINMENT = 0x04
THEME_FILM = 0x05


@dataclass(frozen=True)
class EcMode:
    """ECM provider entry (src/eurocrypt.c:57-80)."""
    id: str
    des_algo: int
    packet_type: int
    key: bytes          # 8 bytes (16 for 3DES)
    ppid: bytes         # 3 bytes
    date: str           # "dd/mm/yyyy" or "TODAY"
    theme: bytes        # theme, level
    channame: str


@dataclass(frozen=True)
class EmMode:
    """EMM provider entry (src/eurocrypt.c:83-102)."""
    id: str
    des_algo: int
    packet_type: int
    key: bytes
    ppid: bytes
    sa: bytes           # 3-byte shared address
    ua: bytes           # 5-byte unique address
    emmtype: int


def _h(*xs) -> bytes:
    return bytes(xs)


EC_MODES = {m.id: m for m in [
    EcMode("bbcprime", EC_M, EC_M,
           _h(0x99, 0x01, 0x00, 0x5C, 0x63, 0xF8, 0x50, 0x00),
           _h(0x00, 0x28, 0x18), "TODAY",
           _h(THEME_ENTERTAINMENT, 0x04), "BBC Prime (M)"),
    EcMode("cplusfr", EC_M, EC_M,
           _h(0xEC, 0xA6, 0xE8, 0x4E, 0x10, 0x41, 0x6F, 0x00),
           _h(0x10, 0x00, 0x18), "TODAY",
           _h(THEME_FILM, 0x00), "Canal+ 4/3 (M)"),
    EcMode("cplusfr169", EC_M, EC_M,
           _h(0x34, 0x94, 0x2B, 0x9B, 0xE5, 0xC1, 0xA2, 0x00),
           _h(0x10, 0x00, 0x28), "TODAY",
           _h(THEME_FILM, 0x00), "Canal+ 16/9 (M)"),
    EcMode("ctv", EC_M, EC_M,
           _h(0x84, 0x66, 0x30, 0xE4, 0xDA, 0xFA, 0x23, 0x00),
           _h(0x00, 0x04, 0x38), "02/04/1996",
           _h(THEME_ENTERTAINMENT, 0x00), "CTV (M)"),
    EcMode("filmnet", EC_M, EC_M,
           _h(0x21, 0x12, 0x31, 0x35, 0x8A, 0xC3, 0x4F, 0x00),
           _h(0x00, 0x28, 0x08), "TODAY",
           _h(THEME_FILM, 0x00), "FilmNet (M)"),
    EcMode("multivisio", EC_M, EC_M,
           _h(0xA3, 0x42, 0xC3, 0x9F, 0xED, 0xA4, 0x53, 0x00),
           _h(0x00, 0x44, 0x08), "TODAY",
           _h(THEME_ENTERTAINMENT, 0x00), "Multivisio (M)"),
    EcMode("tv3", EC_M, EC_M,
           _h(0xE9, 0xF3, 0x34, 0x36, 0xB0, 0xBB, 0xF8, 0x00),
           _h(0x00, 0x04, 0x0C), "TODAY",
           _h(THEME_ENTERTAINMENT, 0x00), "TV3 (M)"),
    EcMode("tv1000", EC_M, EC_M,
           _h(0x48, 0x63, 0xC5, 0xB3, 0xDA, 0xE3, 0x29, 0x00),
           _h(0x00, 0x04, 0x18), "TODAY",
           _h(THEME_FILM, 0x00), "TV 1000 (M)"),
    EcMode("tvcable", EC_M, EC_M,
           _h(0xDA, 0xCF, 0xEB, 0x94, 0x44, 0x55, 0x56, 0x00),
           _h(0x00, 0x0C, 0x09), "TODAY",
           _h(THEME_ENTERTAINMENT, 0x00), "TV Cable (M)"),
    EcMode("tvplus", EC_M, EC_M,
           _h(0x12, 0x06, 0x28, 0x3A, 0x4B, 0x1D, 0xE2, 0x00),
           _h(0x00, 0x2C, 0x08), "TODAY",
           _h(THEME_ENTERTAINMENT, 0x00), "TVPlus (M)"),
    EcMode("visiopass", EC_M, EC_M,
           _h(0x68, 0x67, 0x24, 0x50, 0xF1, 0x98, 0x72, 0x00),
           _h(0x00, 0x24, 0x08), "TODAY",
           _h(THEME_ENTERTAINMENT, 0x00), "Visiopass (M)"),
    EcMode("teletv", EC_S, EC_S,
           _h(0x72, 0xEE, 0xD1, 0xFA, 0xE5, 0x0E, 0x84, 0xEE),
           _h(0x00, 0x60, 0x47), "TODAY",
           _h(THEME_ENTERTAINMENT, 0x00), "Tele-TV (S)"),
    EcMode("nrk", EC_S2, EC_M,
           _h(0xE7, 0x19, 0x5B, 0x7C, 0x47, 0xF4, 0x66, 0x00),
           _h(0x47, 0x52, 0x00), "06/02/1999",
           _h(THEME_ENTERTAINMENT, 0x00), "NRK (S2)"),
    EcMode("tv2", EC_S2, EC_M,
           _h(0x70, 0xBF, 0x6E, 0x51, 0x9F, 0xB8, 0xA6, 0x00),
           _h(0x47, 0x51, 0x00), "06/02/1999",
           _h(THEME_ENTERTAINMENT, 0x00), "TV2 Norway (S2)"),
    EcMode("ctvs", EC_S2, EC_S2,
           _h(0x17, 0x38, 0xFA, 0x8A, 0x84, 0x5A, 0x5E, 0x00),
           _h(0x00, 0x2B, 0x20), "TODAY",
           _h(THEME_ENTERTAINMENT, 0x00), "CTV (S2)"),
    EcMode("eros", EC_S2, EC_S2,
           _h(0x3E, 0xC5, 0x54, 0x92, 0x61, 0x7D, 0x24, 0x00),
           _h(0x00, 0x2E, 0x10), "01/01/2019",
           _h(THEME_FILM, 0x00), "Eros (S2)"),
    EcMode("rdv", EC_S2, EC_S2,
           _h(0x22, 0xC5, 0xC9, 0x22, 0x8D, 0x45, 0x35, 0x00),
           _h(0x00, 0x2D, 0x10), "TODAY",
           _h(THEME_ENTERTAINMENT, 0x00), "RDV (S2)"),
    EcMode("tvs", EC_S2, EC_S2,
           _h(0x5C, 0x8B, 0x11, 0x2F, 0x99, 0xA8, 0x2C, 0x00),
           _h(0x00, 0x2B, 0x50), "06/02/1999",
           _h(THEME_ENTERTAINMENT, 0x00), "TV-S (S2)"),
    EcMode("cplus", EC_3DES, EC_3DES,
           _h(0x62, 0xA7, 0x01, 0xA0, 0x5E, 0x8B, 0xB9, 0x00,
              0xCB, 0x86, 0x67, 0x27, 0x5C, 0x53, 0x17, 0x00),
           _h(0x00, 0x2B, 0x1E), "19/11/1998",
           _h(THEME_FILM, 0x00), "Canal+ DK (3DES)"),
]}

EM_MODES = {m.id: m for m in [
    EmMode("bbcprime", EC_M, EC_M,
           _h(0x89, 0x6D, 0xAA, 0x83, 0x03, 0x57, 0x16, 0x00),
           _h(0x00, 0x28, 0x12), bytes(3), bytes(5), EMMG),
    EmMode("cplusfr", EC_M, EC_M,
           _h(0xB2, 0x26, 0xF7, 0x98, 0x36, 0xEB, 0xC8, 0x00),
           _h(0x10, 0x00, 0x13), bytes(3), bytes(5), EMMG),
    EmMode("cplusfr169", EC_M, EC_M,
           _h(0x6B, 0xB7, 0x78, 0x65, 0xA8, 0xC7, 0xF2, 0x00),
           _h(0x10, 0x00, 0x23), bytes(3), bytes(5), EMMG),
    EmMode("ctv", EC_M, EC_M,
           _h(0x5E, 0xC9, 0xD7, 0x19, 0x89, 0x64, 0xE6, 0x00),
           _h(0x00, 0x04, 0x34), bytes(3), bytes(5), EMMG),
    EmMode("filmnet", EC_M, EC_M,
           _h(0x13, 0x39, 0x6F, 0xDB, 0x3A, 0x88, 0x60, 0x00),
           _h(0x00, 0x28, 0x06), bytes(3), bytes(5), EMMG),
    EmMode("tv3", EC_M, EC_M,
           _h(0x31, 0xD4, 0x65, 0x64, 0x15, 0xC8, 0x7B, 0x00),
           _h(0x00, 0x04, 0x03), bytes(3), bytes(5), EMMG),
    EmMode("tv1000", EC_M, EC_M,
           _h(0xFA, 0x9B, 0xBF, 0x2C, 0x22, 0x5C, 0x22, 0x00),
           _h(0x00, 0x04, 0x13), bytes(3), bytes(5), EMMG),
    EmMode("tvcable", EC_M, EC_M,
           _h(0x16, 0x81, 0x15, 0x93, 0xD8, 0xDD, 0x68, 0x00),
           _h(0x00, 0x0C, 0x02), bytes(3), bytes(5), EMMG),
    EmMode("tvplus", EC_M, EC_M,
           _h(0x21, 0xF5, 0x50, 0xAC, 0x0E, 0xF4, 0xA7, 0x00),
           _h(0x00, 0x2C, 0x03), bytes(3), bytes(5), EMMG),
    EmMode("visiopass", EC_M, EC_M,
           _h(0x3B, 0xDD, 0x2C, 0xF3, 0xC1, 0xA0, 0x03, 0x00),
           _h(0x00, 0x24, 0x03), bytes(3), bytes(5), EMMG),
    EmMode("teletv", EC_S, EC_S,
           _h(0x7A, 0x88, 0x42, 0xD3, 0xFC, 0x66, 0xF8, 0x2A),
           _h(0x00, 0x60, 0x47), bytes(3),
           _h(0xCD, 0x1A, 0xFB, 0x0B, 0x00), EMMU),
    EmMode("tv2", EC_S2, EC_M,
           _h(0x5B, 0xF7, 0xBF, 0xCF, 0xF7, 0x59, 0xB7, 0x00),
           _h(0x47, 0x52, 0x00), bytes(3),
           _h(0x3E, 0xE3, 0x8E, 0x06, 0x00), EMMU),
    EmMode("ctvs", EC_S2, EC_S2,
           _h(0xC2, 0xAC, 0x87, 0xC1, 0xFD, 0x6D, 0x4B, 0x00),
           _h(0x00, 0x2B, 0x20), _h(0xD9, 0x6F, 0x28),
           _h(0xBC, 0x61, 0x97, 0x1F, 0x00), EMMU),
    EmMode("rdv", EC_S2, EC_S2,
           _h(0xD3, 0x4E, 0xD3, 0x85, 0xC2, 0x0E, 0x13, 0x00),
           _h(0x00, 0x2D, 0x80), _h(0xA6, 0x68, 0x35),
           _h(0x05, 0xC2, 0xB9, 0x29, 0x00), EMMU),
    EmMode("cplus", EC_3DES, EC_3DES,
           _h(0x00, 0x20, 0x20, 0x02, 0x00, 0x02, 0x00, 0x00,
              0x8B, 0xBE, 0xD4, 0x7C, 0xF8, 0x8A, 0x7A, 0x00),
           _h(0x00, 0x2B, 0x10), _h(0x9B, 0x54, 0x3F),
           _h(0x4D, 0x19, 0x7A, 0x31, 0x00), EMMU),
]}


# ----------------------------------------------------------------------
# The Eurocrypt DES variant (src/eurocrypt.c:105-648)
#
# Standard DES tables (initial/final permutation, expansion E, S-boxes,
# permutation P, PC-2, shift schedule) with Eurocrypt's non-standard key
# handling: EC-M runs the *decryption* schedule against pre-rotated key
# registers, EC hashing rotates forward and swaps two output bytes.

_IP = (58, 50, 42, 34, 26, 18, 10, 2, 60, 52, 44, 36, 28, 20, 12, 4,
       62, 54, 46, 38, 30, 22, 14, 6, 64, 56, 48, 40, 32, 24, 16, 8,
       57, 49, 41, 33, 25, 17, 9, 1, 59, 51, 43, 35, 27, 19, 11, 3,
       61, 53, 45, 37, 29, 21, 13, 5, 63, 55, 47, 39, 31, 23, 15, 7)

_IPP = (40, 8, 48, 16, 56, 24, 64, 32, 39, 7, 47, 15, 55, 23, 63, 31,
        38, 6, 46, 14, 54, 22, 62, 30, 37, 5, 45, 13, 53, 21, 61, 29,
        36, 4, 44, 12, 52, 20, 60, 28, 35, 3, 43, 11, 51, 19, 59, 27,
        34, 2, 42, 10, 50, 18, 58, 26, 33, 1, 41, 9, 49, 17, 57, 25)

_EXP = (32, 1, 2, 3, 4, 5, 4, 5, 6, 7, 8, 9, 8, 9, 10, 11, 12, 13,
        12, 13, 14, 15, 16, 17, 16, 17, 18, 19, 20, 21, 20, 21, 22, 23,
        24, 25, 24, 25, 26, 27, 28, 29, 28, 29, 30, 31, 32, 1)

# DES S-boxes in flat input-index order (row bits are input bits 0&5)
_SB = (
    (0xE, 0x0, 0x4, 0xF, 0xD, 0x7, 0x1, 0x4, 0x2, 0xE, 0xF, 0x2,
     0xB, 0xD, 0x8, 0x1, 0x3, 0xA, 0xA, 0x6, 0x6, 0xC, 0xC, 0xB,
     0x5, 0x9, 0x9, 0x5, 0x0, 0x3, 0x7, 0x8, 0x4, 0xF, 0x1, 0xC,
     0xE, 0x8, 0x8, 0x2, 0xD, 0x4, 0x6, 0x9, 0x2, 0x1, 0xB, 0x7,
     0xF, 0x5, 0xC, 0xB, 0x9, 0x3, 0x7, 0xE, 0x3, 0xA, 0xA, 0x0,
     0x5, 0x6, 0x0, 0xD),
    (0xF, 0x3, 0x1, 0xD, 0x8, 0x4, 0xE, 0x7, 0x6, 0xF, 0xB, 0x2,
     0x3, 0x8, 0x4, 0xE, 0x9, 0xC, 0x7, 0x0, 0x2, 0x1, 0xD, 0xA,
     0xC, 0x6, 0x0, 0x9, 0x5, 0xB, 0xA, 0x5, 0x0, 0xD, 0xE, 0x8,
     0x7, 0xA, 0xB, 0x1, 0xA, 0x3, 0x4, 0xF, 0xD, 0x4, 0x1, 0x2,
     0x5, 0xB, 0x8, 0x6, 0xC, 0x7, 0x6, 0xC, 0x9, 0x0, 0x3, 0x5,
     0x2, 0xE, 0xF, 0x9),
    (0xA, 0xD, 0x0, 0x7, 0x9, 0x0, 0xE, 0x9, 0x6, 0x3, 0x3, 0x4,
     0xF, 0x6, 0x5, 0xA, 0x1, 0x2, 0xD, 0x8, 0xC, 0x5, 0x7, 0xE,
     0xB, 0xC, 0x4, 0xB, 0x2, 0xF, 0x8, 0x1, 0xD, 0x1, 0x6, 0xA,
     0x4, 0xD, 0x9, 0x0, 0x8, 0x6, 0xF, 0x9, 0x3, 0x8, 0x0, 0x7,
     0xB, 0x4, 0x1, 0xF, 0x2, 0xE, 0xC, 0x3, 0x5, 0xB, 0xA, 0x5,
     0xE, 0x2, 0x7, 0xC),
    (0x7, 0xD, 0xD, 0x8, 0xE, 0xB, 0x3, 0x5, 0x0, 0x6, 0x6, 0xF,
     0x9, 0x0, 0xA, 0x3, 0x1, 0x4, 0x2, 0x7, 0x8, 0x2, 0x5, 0xC,
     0xB, 0x1, 0xC, 0xA, 0x4, 0xE, 0xF, 0x9, 0xA, 0x3, 0x6, 0xF,
     0x9, 0x0, 0x0, 0x6, 0xC, 0xA, 0xB, 0x1, 0x7, 0xD, 0xD, 0x8,
     0xF, 0x9, 0x1, 0x4, 0x3, 0x5, 0xE, 0xB, 0x5, 0xC, 0x2, 0x7,
     0x8, 0x2, 0x4, 0xE),
    (0x2, 0xE, 0xC, 0xB, 0x4, 0x2, 0x1, 0xC, 0x7, 0x4, 0xA, 0x7,
     0xB, 0xD, 0x6, 0x1, 0x8, 0x5, 0x5, 0x0, 0x3, 0xF, 0xF, 0xA,
     0xD, 0x3, 0x0, 0x9, 0xE, 0x8, 0x9, 0x6, 0x4, 0xB, 0x2, 0x8,
     0x1, 0xC, 0xB, 0x7, 0xA, 0x1, 0xD, 0xE, 0x7, 0x2, 0x8, 0xD,
     0xF, 0x6, 0x9, 0xF, 0xC, 0x0, 0x5, 0x9, 0x6, 0xA, 0x3, 0x4,
     0x0, 0x5, 0xE, 0x3),
    (0xC, 0xA, 0x1, 0xF, 0xA, 0x4, 0xF, 0x2, 0x9, 0x7, 0x2, 0xC,
     0x6, 0x9, 0x8, 0x5, 0x0, 0x6, 0xD, 0x1, 0x3, 0xD, 0x4, 0xE,
     0xE, 0x0, 0x7, 0xB, 0x5, 0x3, 0xB, 0x8, 0x9, 0x4, 0xE, 0x3,
     0xF, 0x2, 0x5, 0xC, 0x2, 0x9, 0x8, 0x5, 0xC, 0xF, 0x3, 0xA,
     0x7, 0xB, 0x0, 0xE, 0x4, 0x1, 0xA, 0x7, 0x1, 0x6, 0xD, 0x0,
     0xB, 0x8, 0x6, 0xD),
    (0x4, 0xD, 0xB, 0x0, 0x2, 0xB, 0xE, 0x7, 0xF, 0x4, 0x0, 0x9,
     0x8, 0x1, 0xD, 0xA, 0x3, 0xE, 0xC, 0x3, 0x9, 0x5, 0x7, 0xC,
     0x5, 0x2, 0xA, 0xF, 0x6, 0x8, 0x1, 0x6, 0x1, 0x6, 0x4, 0xB,
     0xB, 0xD, 0xD, 0x8, 0xC, 0x1, 0x3, 0x4, 0x7, 0xA, 0xE, 0x7,
     0xA, 0x9, 0xF, 0x5, 0x6, 0x0, 0x8, 0xF, 0x0, 0xE, 0x5, 0x2,
     0x9, 0x3, 0x2, 0xC),
    (0xD, 0x1, 0x2, 0xF, 0x8, 0xD, 0x4, 0x8, 0x6, 0xA, 0xF, 0x3,
     0xB, 0x7, 0x1, 0x4, 0xA, 0xC, 0x9, 0x5, 0x3, 0x6, 0xE, 0xB,
     0x5, 0x0, 0x0, 0xE, 0xC, 0x9, 0x7, 0x2, 0x7, 0x2, 0xB, 0x1,
     0x4, 0xE, 0x1, 0x7, 0x9, 0x4, 0xC, 0xA, 0xE, 0x8, 0x2, 0xD,
     0x0, 0xF, 0x6, 0xC, 0xA, 0x9, 0xD, 0x0, 0xF, 0x3, 0x3, 0x5,
     0x5, 0x6, 0x8, 0xB),
)

# System-S substitution table (src/eurocrypt.c:215-232)
_SS_SB = bytes((
    0xEC, 0x16, 0x6E, 0x46, 0x3B, 0x96, 0x70, 0x32, 0x54, 0x20, 0x4F,
    0x78, 0x5A, 0x4D, 0x01, 0xC1, 0x9E, 0xD9, 0x35, 0xEF, 0xBA, 0x5F,
    0xA5, 0x7F, 0x19, 0x72, 0xE2, 0x31, 0xA0, 0x3E, 0xEC, 0x3A, 0xE1,
    0x73, 0x8D, 0x13, 0x52, 0x1F, 0xF3, 0xE0, 0x90, 0x28, 0xD0, 0xD3,
    0x30, 0x09, 0x6B, 0x8F, 0x33, 0x9D, 0xA7, 0xEB, 0x90, 0x7D, 0x3D,
    0xBF, 0x26, 0x20, 0xBB, 0x2B, 0xAE, 0x84, 0xB0, 0x77, 0xDB, 0x1C,
    0xB0, 0xEF, 0x6A, 0x91, 0xD8, 0x36, 0x3F, 0x65, 0x81, 0x0C, 0x82,
    0xC5, 0xD4, 0x1B, 0x04, 0x15, 0xB2, 0x0D, 0x0E, 0x1A, 0x2B, 0xC0,
    0xCA, 0x67, 0x1B, 0xF7, 0x8F, 0x31, 0x0D, 0x05, 0x2C, 0x92, 0xDF,
    0xD3, 0xFA, 0xB9, 0xB7, 0xE3, 0x55, 0x03, 0x12, 0x29, 0x93, 0xD7,
    0x43, 0x87, 0xFF, 0xA1, 0x4C, 0x9B, 0xB0, 0xC4, 0x11, 0x59, 0xE8,
    0xC6, 0xF2, 0x57, 0x14, 0x63, 0x42, 0xE0, 0xAB, 0xB4, 0xC2, 0xF0,
    0x34, 0x02, 0x11, 0x59, 0x8E, 0x86, 0x6B, 0xCE, 0xAF, 0xF1, 0xA2,
    0x95, 0x79, 0x5A, 0x66, 0x8F, 0x88, 0x4B, 0x4E, 0x0B, 0xC9, 0xCC,
    0x7A, 0x89, 0xAA, 0x41, 0x64, 0xAB, 0xB6, 0xB8, 0x51, 0x10, 0x1D,
    0x68, 0x2A, 0x65, 0xF5, 0xF4, 0x43, 0xA9, 0x2F, 0x5D, 0x65, 0x4A,
    0x7B, 0xE9, 0x40, 0x6D, 0x45, 0x97, 0xF3, 0xC3, 0x69, 0xD1, 0xFE,
    0xE6, 0xD0, 0x64, 0x08, 0x83, 0x5B, 0xF6, 0xED, 0x2E, 0x99, 0xE7,
    0x0F, 0x74, 0x37, 0x24, 0xD8, 0x07, 0x23, 0x71, 0xA4, 0x5C, 0x9A,
    0xA3, 0x05, 0x53, 0xFB, 0xBE, 0x5E, 0x1E, 0x17, 0xB3, 0x88, 0x0F,
    0xD2, 0x7C, 0xCB, 0x59, 0x0A, 0x22, 0xCD, 0x61, 0x6C, 0xEE, 0xAC,
    0x7E, 0x75, 0x8A, 0x76, 0x94, 0x27, 0xFC, 0x47, 0xBD, 0x60, 0x3B,
    0xDD, 0x56, 0x4D, 0x58, 0x44, 0xEA, 0x67, 0x3C, 0x46, 0xAD, 0x62,
    0xD5, 0x46, 0x21))

_SS_DATA = bytes((0x89, 0xAB, 0xCD, 0xEF, 0xFE, 0xDC, 0xBA, 0x98))

_PERM = (16, 7, 20, 21, 29, 12, 28, 17, 1, 15, 23, 26, 5, 18, 31, 10,
         2, 8, 24, 14, 32, 27, 3, 9, 19, 13, 30, 6, 22, 11, 4, 25)

_IPC1 = (8, 16, 24, 56, 52, 44, 36, 57, 7, 15, 23, 55, 51, 43, 35, 58,
         6, 14, 22, 54, 50, 42, 34, 59, 5, 13, 21, 53, 49, 41, 33, 60,
         4, 12, 20, 28, 48, 40, 32, 61, 3, 11, 19, 27, 47, 39, 31, 62,
         2, 10, 18, 26, 46, 38, 30, 63, 1, 9, 17, 25, 45, 37, 29, 64)

_PC2 = (14, 17, 11, 24, 1, 5, 3, 28, 15, 6, 21, 10, 23, 19, 12, 4,
        26, 8, 16, 7, 27, 20, 13, 2, 41, 52, 31, 37, 47, 55, 30, 40,
        51, 45, 33, 48, 44, 49, 39, 56, 34, 53, 46, 42, 50, 36, 29, 32)

_TDESMAP = ((0x00, 0x01), (0x01, 0x02), (0x02, 0x03), (0x03, 0x00))

_LSHIFT = (1, 1, 2, 2, 2, 2, 2, 2, 1, 2, 2, 2, 2, 2, 2, 1)


def _permute(data: bytearray, table) -> None:
    """In-place 64-bit permutation; table entries are 1-based MSB-first
    bit indices (src/eurocrypt.c:286-305)."""
    src = bytes(data)
    for i in range(8):
        p = 0
        for j in range(8):
            t = table[i * 8 + j] - 1
            p = (p << 1) | ((src[t >> 3] >> (7 - (t & 7))) & 1)
        data[i] = p


def _des_f(r: int, k2) -> int:
    """DES round function with Eurocrypt tables (src/eurocrypt.c:355-385)."""
    s = 0
    for i in range(8):
        v = 0
        for j in range(6):
            v |= ((r >> (32 - _EXP[i * 6 + j])) & 1) << (5 - j)
        s |= _SB[i][v ^ k2[i]] << (28 - 4 * i)
    out = 0
    for i in range(32):
        out |= ((s >> (32 - _PERM[i])) & 1) << (31 - i)
    return out


def _rotl28(x: int, n: int) -> int:
    return ((x << n) | (x >> (28 - n))) & 0xFFFFFFF


def _key_schedule(k2_out, c: int, d: int):
    """PC-2 compression of the C/D registers into 8 six-bit subkey
    words (src/eurocrypt.c:411-434)."""
    for j in range(8):
        v = 0
        for t in range(6):
            p = _PC2[j * 6 + t]
            if p < 29:
                v |= ((c >> (28 - p)) & 1) << (5 - t)
            else:
                v |= ((d >> (56 - p)) & 1) << (5 - t)
        k2_out[j] = v


def ec_des(data: bytearray, key: bytes, desmode: int, des_algo: int,
           rnd: int) -> None:
    """One 16-round Eurocrypt DES pass over an 8-byte block, in place
    (src/eurocrypt.c:524-648).

    desmode: _ECM (decryption schedule) or _HASH (encryption schedule
    with the EC-M output-byte swap); rnd is the 3DES round (1..3).
    """
    c = (key[0] << 20) | (key[1] << 12) | (key[2] << 4) | (key[3] >> 4)
    d = ((key[3] & 0x0F) << 24) | (key[4] << 16) | (key[5] << 8) | key[6]

    if des_algo != EC_M:
        _permute(data, _IP)

    l = int.from_bytes(data[0:4], "big")
    r = int.from_bytes(data[4:8], "big")
    k2 = [0] * 8

    for i in range(16):
        if des_algo in (EC_M, EC_S):
            if desmode == _HASH:
                c = _rotl28(c, _LSHIFT[i])
                d = _rotl28(d, _LSHIFT[i])
            _key_schedule(k2, c, d)
            s = _des_f(r, k2)
            if desmode != _HASH:
                n = _LSHIFT[15 - i]
                c = _rotl28(c, 28 - n)
                d = _rotl28(d, 28 - n)
            else:
                # EC hashing swaps the two middle output bytes
                s = (((s >> 8) & 0xFF0000) | ((s << 8) & 0xFF000000) |
                     (s & 0x0000FFFF))
        elif des_algo == EC_S2:
            c = _rotl28(c, _LSHIFT[i])
            d = _rotl28(d, _LSHIFT[i])
            _key_schedule(k2, c, d)
            s = _des_f(r, k2)
        elif des_algo == EC_3DES:
            if rnd != 2:
                c = _rotl28(c, _LSHIFT[i])
                d = _rotl28(d, _LSHIFT[i])
            _key_schedule(k2, c, d)
            s = _des_f(r, k2)
            if rnd == 2:
                n = _LSHIFT[15 - i]
                c = _rotl28(c, 28 - n)
                d = _rotl28(d, 28 - n)
        else:
            raise ValueError(f"invalid des_algo {des_algo:#x}")
        l, r = r, l ^ s

    data[0:4] = r.to_bytes(4, "big")
    data[4:8] = l.to_bytes(4, "big")

    if des_algo != EC_M:
        _permute(data, _IPP)


def system_s_encrypt(buf: bytearray, key: bytes) -> None:
    """The Eurocrypt System-S byte cipher over a 39-byte payload, in
    place (src/eurocrypt.c:436-522): 8 boustrophedon rounds of a
    substitution/transpose keystream, then a final reversal."""
    data = bytearray(buf[:39])
    d = 0
    for rnd in range(8):
        k = bytearray(key[:8])
        tmp = bytearray(_SS_DATA)
        sl = sr = 0
        for _ in range(0x27):
            sb = bytearray(16)
            for i in range(8):
                sb[i] = _SS_SB[(k[i] + tmp[i]) & 0xFF]
            # 8x8 bit transpose of sb[0..7] into sb[8..15]
            for i in range(8, 0, -1):
                for y in range(7, -1, -1):
                    c = (sb[y] >> 7) & 1
                    sb[y] = (sb[y] << 1) & 0xFF
                    sb[7 + i] = ((sb[7 + i] << 1) | c) & 0xFF
            x = 0
            for i in range(8):
                sb[i] = _SS_SB[sb[8 + i]]
                x |= sb[i] & (1 << i)
            x = _SS_SB[(sl + sr + x) & 0xFF]
            sl = _SS_SB[(sb[2] & 0x03) | (sb[1] & 0xFC)]
            sr = _SS_SB[(sb[6] & 0x3F) | (sb[5] & 0xC0)]
            tmp[1:8] = tmp[0:7]
            if (sb[6] >> 7) & 1:
                k = k[1:] + k[:1]
            data[d] ^= x
            tmp[0] = data[d]
            d += -1 if rnd & 1 else 1
        d += 1 if rnd & 1 else -1
    data[:0x27] = data[:0x27][::-1]
    buf[:39] = data


def _calc_hash(msg: bytes, mode: int, key: bytes) -> bytes:
    """CBC-MAC style hash (src/eurocrypt.c:650-675)."""
    h = bytearray(8)
    for i, b in enumerate(msg):
        h[i % 8] ^= b
        if i % 8 == 7:
            for r in range(3 if mode == EC_3DES else 1):
                ec_des(h, key[8:] if r == 1 else key[:8], _HASH, mode,
                       r + 1)
    if mode == EC_M:
        ec_des(h, key, _HASH, mode, 1)
    return bytes(h)


# ----------------------------------------------------------------------
# Dates (src/eurocrypt.c:307-353, 778-818)

_MONTH_DAYS = (31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31)


def pack_date(day: int, mon: int, year: int, mode: int) -> int:
    """Eurocrypt packed date; layout differs per system
    (src/eurocrypt.c:307-353)."""
    if mode == EC_M:
        return ((year - 1980) << 9) | (mon << 5) | day
    if mode == EC_S:
        return ((year % 10) << 12) | (mon << 8) | day
    if mode == EC_S2:
        if year > 2029:
            y = (3 << 5) | (year - 1990 - 30)
        else:
            yd = (year - 1990) // 10
            y = (yd << 5) | (year - 1990 - 10 * yd)
        return ((y & 0x0F) << 12) | (mon << 8) | (y & 0xE0) | day
    # EC_3DES has no branch in the reference's _get_ec_date
    # (src/eurocrypt.c:307-353) — dates pack to 0
    return 0


class _Dates:
    """Start/end/current broadcast dates for a provider; `TODAY`
    providers use the wall clock like the reference
    (src/eurocrypt.c:778-818)."""

    def __init__(self, date: str, now: float | None = None):
        tm = time.localtime(time.time() if now is None else now)
        self.today_day = tm.tm_mday
        if date != "TODAY":
            d, m, y = (int(x) for x in date.split("/"))
            self.day, self.mon, self.year = d, m, y
        else:
            self.day = tm.tm_mday
            self.mon = tm.tm_mon + 0
            self.year = tm.tm_year

    def sub_date(self, b: int) -> tuple[int, int, int]:
        if b == 0:
            d = self.today_day
        elif b == 31:
            d = _MONTH_DAYS[self.mon - 1]
        else:
            d = b if 0 < b <= 31 else 1
        return d, self.mon, self.year


# ----------------------------------------------------------------------
# glibc rand() replica (TYPE_3 additive-feedback generator), for parity
# with the seed-pinned reference golden captures.

class GlibcRand:
    """random(3) TYPE_3 (degree 31, separation 3) additive generator."""

    def __init__(self, seed: int = 1):
        seed = (seed & 0xFFFFFFFF) or 1
        s = [seed]
        for _ in range(30):
            hi, lo = divmod(s[-1], 127773)
            word = 16807 * lo - 2836 * hi
            if word < 0:
                word += 2147483647
            s.append(word)
        self.s = s
        self.f = 3
        self.b = 0
        for _ in range(310):
            self._next()

    def _next(self) -> int:
        self.s[self.f] = (self.s[self.f] + self.s[self.b]) & 0xFFFFFFFF
        out = (self.s[self.f] >> 1) & 0x7FFFFFFF
        self.f = (self.f + 1) % 31
        self.b = (self.b + 1) % 31
        return out

    def __call__(self) -> int:
        return self._next()


# ----------------------------------------------------------------------
# The CA state machine

class Eurocrypt:
    """Eurocrypt ECM/EMM generator + CW rotation.

    Plugs into `MacMux` (video/mac.py): `next_frame` is
    called at line 1 of every frame and pushes ECM/EMM packets into the
    mux queue and rotates `mux.cw`; `si_info` feeds the SI DG3 ACCM
    parameter.  Scheduling mirrors src/eurocrypt.c:1541-1758.
    """

    ECM_ADDR = 346
    EMM_ADDR = 347

    def __init__(self, mode: str, rand=None, mat_rating: int = 0,
                 ppv: str | None = None, nodate: bool = False,
                 now: float | None = None, showecm: bool = False):
        if mode not in EC_MODES:
            raise ValueError(f"unknown Eurocrypt mode '{mode}'; "
                             f"available: {sorted(EC_MODES)}")
        self.mode = EC_MODES[mode]
        self.emmode = EM_MODES.get(mode)
        self.rand = rand if rand is not None else GlibcRand(1)
        self.mat_rating = mat_rating
        self.ppv = ppv
        self.nodate = nodate
        self.dates = _Dates(self.mode.date, now)

        self.cw = [bytearray(8), bytearray(8)]    # decrypted CWs
        self.ecw = [bytearray(8), bytearray(8)]   # encrypted CWs
        self.enc_data = bytearray(8)
        self.ecm_hash = bytes(8)
        self.emm_hash = bytes(8)
        self._flag = 0   # EMM date/key alternation counter

        self._update_cw(0)
        self._update_cw(1)
        self.showecm = showecm
        self.ecm_pkt, self.ecm_cont = self._build_ecm(0)
        if showecm:
            self._print_ecm()

    # -- key material ---------------------------------------------------
    def _update_cw(self, t: int) -> int:
        """Fetch the active CW for toggle `t` and generate the next CW
        for toggle `t^1` (src/eurocrypt.c:1508-1539)."""
        cw = int.from_bytes(self.cw[t], "big")
        t ^= 1
        fresh = bytes(self.rand() & 0xFF for _ in range(8))
        self.cw[t] = bytearray(fresh)
        self.ecw[t] = bytearray(fresh)
        if self.mode.des_algo != EC_S:
            for r in range(3 if self.mode.des_algo == EC_3DES else 1):
                key = self.mode.key[8:16] if r == 1 else self.mode.key[:8]
                ec_des(self.ecw[t], key, _ECM, self.mode.des_algo, r + 1)
        return cw

    def _encrypt_opkey(self, t: int) -> bytes:
        """Operational key encrypted under the management key
        (src/eurocrypt.c:820-850)."""
        em = self.emmode
        if self.mode.des_algo == EC_3DES:
            buf = bytearray(self.mode.key[8 * t:8 * t + 8] if t
                            else self.mode.key[:8])
        else:
            buf = bytearray(self.mode.key[:8])
        if em.des_algo != EC_M:
            _permute(buf, _IPC1)
        for r in range(3 if em.des_algo == EC_3DES else 1):
            key = em.key[8:16] if r == 1 else em.key[:8]
            ec_des(buf, key, _ECM, em.des_algo, r + 1)
        return bytes(buf)

    def _encrypt_date(self, data: bytearray) -> bytes:
        """Date block is encrypted only in 3DES mode
        (src/eurocrypt.c:852-867)."""
        em = self.emmode
        if em.des_algo == EC_3DES:
            for r in range(3):
                key = em.key[8:16] if r == 1 else em.key[:8]
                ec_des(data, key, _ECM, em.des_algo, r + 1)
        return bytes(data[:8])

    def _date_theme_block(self) -> bytes:
        d1 = pack_date(*self.dates.sub_date(1), self.emmode.des_algo)
        d2 = pack_date(*self.dates.sub_date(31), self.emmode.des_algo)
        return (d1.to_bytes(2, "big") + d2.to_bytes(2, "big") +
                self.mode.theme + b"\x00\x00")

    # -- ECM ------------------------------------------------------------
    def _build_ecm(self, t: int) -> tuple[bytearray, int]:
        if self.mode.packet_type == EC_S:
            return self._build_ecm_system_s()
        m = self.mode
        pkt = bytearray(MAC_PAYLOAD_BYTES * 2)
        x = 0
        pkt[x] = 0x00; x += 1                       # PT: ECM
        pkt[x] = ((m.packet_type & 0x30) << 2 | 2 | t) & 0xFF; x += 1
        x += 1                                      # CLI, fixed up below
        pkt[x:x + 2] = b"\x90\x03"; x += 2
        pkt[x:x + 3] = m.ppid; x += 3
        pkt[x:x + 2] = b"\xDF\x00"; x += 2
        if m.des_algo == EC_M:
            pkt[x:x + 2] = b"\xE0\x01"; x += 2
            # NB: reference overwrites the maturity-enable bit with the
            # date-verification bit (src/eurocrypt.c:974-976)
            b = ((1 if self.nodate else 0) << 5) | (self.mat_rating or 0)
            pkt[x] = b; x += 1
        if self.ppv is not None:
            vals = [int(float(p)) for p in self.ppv.split(",")][:2]
            vals += [0] * (2 - len(vals))
            pkt[x:x + 2] = b"\xE4\x05"; x += 2
            pkt[x:x + 3] = (vals[0] & 0xFFFFFF).to_bytes(3, "big"); x += 3
            pkt[x] = vals[1] & 0xFF; x += 1
            pkt[x] = 0x00; x += 1
        else:
            pkt[x:x + 2] = b"\xE1\x04"; x += 2
            d = pack_date(self.dates.day, self.dates.mon, self.dates.year,
                          m.des_algo) if m.date != "TODAY" else \
                pack_date(*self.dates.sub_date(0), m.des_algo)
            pkt[x:x + 2] = d.to_bytes(2, "big"); x += 2
            pkt[x:x + 2] = m.theme; x += 2
        pkt[x:x + 2] = b"\xEA\x10"; x += 2
        pkt[x:x + 8] = self.ecw[0]; x += 8
        pkt[x:x + 8] = self.ecw[1]; x += 8
        pkt[x:x + 2] = b"\xF0\x08"; x += 2
        h = self._ecm_hash_input(pkt, x)
        self.ecm_hash = _calc_hash(h, m.des_algo, m.key)
        pkt[x:x + 8] = self.ecm_hash; x += 8
        pkt[2] = x - 3
        return pkt, x // ECM_PAYLOAD_BYTES

    def _ecm_hash_input(self, pkt: bytearray, x: int) -> bytes:
        """(src/eurocrypt.c:677-715)"""
        if self.mode.des_algo != EC_M:
            msg = bytearray(pkt[5:8])
            msg[2] &= 0xF0
            msg += pkt[x - 24:x - 19]
            msg += self.ecw[0] + self.ecw[1]
            return bytes(msg)
        return bytes(pkt[8:8 + x - 10])

    def _build_ecm_system_s(self) -> tuple[bytearray, int]:
        """(src/eurocrypt.c:879-936)"""
        m = self.mode
        pkt = bytearray(MAC_PAYLOAD_BYTES * 2)
        x = 0
        pkt[x:x + 2] = b"\x00\x00"; x += 2
        pkt[x:x + 2] = b"\x60\x47"; x += 2
        pkt[x] = 0x00; x += 1
        d = pack_date(*self.dates.sub_date(0), m.des_algo) \
            if m.date == "TODAY" else \
            pack_date(self.dates.day, self.dates.mon, self.dates.year,
                      m.des_algo)
        pkt[x:x + 2] = d.to_bytes(2, "big"); x += 2
        pkt[x:x + 6] = bytes(6); x += 6
        pkt[x:x + 5] = b"\xFF" * 5; x += 5
        pkt[x:x + 4] = bytes(4); x += 4
        # CW bytes transmitted reversed; the reversal also becomes the
        # decoder-facing CW (src/eurocrypt.c:916-921)
        self.cw[0] = bytearray(self.ecw[0][::-1])
        self.cw[1] = bytearray(self.ecw[1][::-1])
        pkt[x:x + 8] = self.ecw[1]; x += 8
        pkt[x:x + 8] = self.ecw[0]; x += 8
        pkt[x] = 0xAE; x += 1
        pkt[x:x + 7] = pkt[1:8]; x += 7
        enc = bytearray(pkt[x - 39:x])
        system_s_encrypt(enc, m.key)
        pkt[x - 39:x] = enc
        return pkt, x // ECM_PAYLOAD_BYTES

    # -- EMMs -------------------------------------------------------------
    def _label(self, width: int) -> bytes:
        name = self.mode.channame
        i = name.find("(")
        s = name[:i - 1] if i > 1 else ""
        out = bytearray(b" " * width)
        out[:len(s[:width])] = s[:width].encode()
        return bytes(out)

    def _build_emmg(self, t: int) -> tuple[bytearray, int]:
        """EMM-Global, EC-M only (src/eurocrypt.c:1362-1441)."""
        em = self.emmode
        pkt = bytearray(MAC_PAYLOAD_BYTES * 2)
        x = 0
        pkt[x] = EMMG; x += 1
        pkt[x] = ((em.packet_type & 0x30) << 2 | 2 | t) & 0xFF; x += 1
        x += 1
        pkt[x:x + 2] = b"\x90\x03"; x += 2
        pkt[x:x + 3] = em.ppid; x += 3
        pkt[x:x + 3] = b"\xA0\x01\x00"; x += 3
        if self.ppv and t:
            d = pack_date(*self.dates.sub_date(0), self.mode.des_algo)
            pkt[x:x + 2] = b"\xAB\x04"; x += 2
            pkt[x:x + 2] = d.to_bytes(2, "big"); x += 2
            pkt[x:x + 2] = b"\x0F\xFF"; x += 2
        else:
            pkt[x:x + 2] = b"\xA8\x06"; x += 2
            pkt[x:x + 6] = self._date_theme_block()[:6]
            x += 6
            pkt[x:x + 2] = b"\xA1\x03"; x += 2
            pkt[x:x + 3] = self.mode.ppid; x += 3
            pkt[x:x + 2] = b"\xEF\x08"; x += 2
            self.enc_data = bytearray(self._encrypt_opkey(t))
            pkt[x:x + 8] = self.enc_data; x += 8
        pkt[x:x + 2] = b"\xF0\x08"; x += 2
        self.emm_hash = _calc_hash(bytes(pkt[8:8 + x - 10]),
                                   self.mode.des_algo, em.key)
        pkt[x:x + 8] = self.emm_hash; x += 8
        pkt[2] = x - 3
        return pkt, x // ECM_PAYLOAD_BYTES

    def _build_emmu(self, t: int) -> tuple[bytearray, int]:
        """EMM-Unique for S2/3DES (src/eurocrypt.c:1117-1246)."""
        em = self.emmode
        pkt = bytearray(MAC_PAYLOAD_BYTES * 2)
        x = 0
        pkt[x] = EMMU; x += 1
        pkt[x:x + 5] = em.ua; x += 5
        pkt[x] = ((em.packet_type & 0x30) << 2 | 2 | 1) & 0xFF; x += 1
        x += 1   # CLI at pkt[7]
        pkt[x:x + 2] = b"\x90\x03"; x += 2
        pkt[x:x + 3] = em.ppid; x += 3
        pkt[x:x + 2] = b"\xA7\x0B"; x += 2
        pkt[x:x + 0x0B] = self._label(0x0B); x += 0x0B
        self._flag += 1
        if self._flag % 3 == 0:
            pkt[x:x + 2] = b"\xA8\x06"; x += 2
            self.enc_data = bytearray(
                self._encrypt_date(bytearray(self._date_theme_block())))
        else:
            pkt[x:x + 2] = b"\xEF\x06"; x += 2
            self.enc_data = bytearray(self._encrypt_opkey(t))
        pkt[x:x + 6] = self.enc_data[:6]; x += 6
        pkt[x:x + 2] = b"\xDF\x00"; x += 2
        pkt[x:x + 2] = b"\xF0\x08"; x += 2
        pkt[x:x + 2] = self.enc_data[6:8]; x += 2
        if self._flag % 3 == 0:
            b = 0x02
        else:
            b = 0x20
            if em.des_algo == EC_3DES and em.packet_type == EC_3DES:
                b |= _TDESMAP[(self.mode.ppid[2] & 0x0F) - 0x0C][t]
            else:
                b |= self.mode.ppid[2] & 0x0F
        pkt[x] = b; x += 1
        self.emm_hash = self._emmu_hash(pkt)
        # the reference writes the full hash at x then overwrites the
        # first 5 bytes with hash[3:] — bytes x+5..x+7 keep hash[5:8]
        # and are transmitted in the continuation chunk
        # (src/eurocrypt.c:1238-1240)
        pkt[x:x + 8] = self.emm_hash
        pkt[x:x + 5] = self.emm_hash[3:8]; x += 5
        pkt[7] = x - 8
        return pkt, x // ECM_PAYLOAD_BYTES

    def _emmu_hash(self, pkt: bytearray) -> bytes:
        """(src/eurocrypt.c:1033-1059)"""
        em = self.emmode
        msg = bytearray(em.ppid)
        msg += pkt[15:15 + 0x0C]
        msg += pkt[40:41]
        msg += pkt[28:34]
        msg += pkt[38:40]
        return _calc_hash(bytes(msg), em.des_algo, em.key)

    def _build_emmu_system_s(self, t: int) -> tuple[bytearray, int]:
        """(src/eurocrypt.c:1061-1115)"""
        em = self.emmode
        pkt = bytearray(MAC_PAYLOAD_BYTES * 2)
        x = 0
        pkt[x] = EMMU; x += 1
        pkt[x:x + 5] = em.ua; x += 5
        pkt[x:x + 2] = b"\x00\xA0"; x += 2
        pkt[x] = em.ppid[1]; x += 1
        pkt[x] = em.ppid[2]; x += 1
        pkt[x:x + 0x0D] = self._label(0x0D); x += 0x0D
        d = pack_date(*self.dates.sub_date(1), em.des_algo)
        pkt[x:x + 2] = d.to_bytes(2, "big"); x += 2
        d = pack_date(*self.dates.sub_date(31), em.des_algo)
        pkt[x:x + 2] = d.to_bytes(2, "big"); x += 2
        pkt[x:x + 4] = b"\x0A\x01\x10\x01"; x += 4
        pkt[x:x + 8] = self.mode.key[:8]; x += 8
        pkt[x:x + 7] = pkt[1:8]; x += 7
        enc = bytearray(pkt[x - 39:x])
        system_s_encrypt(enc, em.key)
        pkt[x - 39:x] = enc
        return pkt, x // ECM_PAYLOAD_BYTES

    def _build_emmgs(self, t: int) -> tuple[bytearray, int]:
        """EMM-Global preceding an EMM-Shared (src/eurocrypt.c:1443-1506)."""
        em = self.emmode
        pkt = bytearray(MAC_PAYLOAD_BYTES * 2)
        x = 0
        pkt[x] = EMMG; x += 1
        pkt[x] = ((em.packet_type & 0x30) << 2 | 2 | t) & 0xFF; x += 1
        x += 1
        pkt[x:x + 2] = b"\x90\x03"; x += 2
        pkt[x:x + 3] = em.ppid; x += 3
        if em.des_algo == EC_M:
            pkt[x:x + 2] = b"\xA1\x03"; x += 2
            pkt[x:x + 3] = self.mode.ppid; x += 3
            pkt[x:x + 2] = b"\xEF\x08"; x += 2
            self.enc_data = bytearray(self._encrypt_opkey(t))
            pkt[x:x + 8] = self.enc_data; x += 8
        else:
            pkt[x:x + 2] = b"\xA7\x0B"; x += 2
            pkt[x:x + 0x0B] = self._label(0x0B); x += 0x0B
            pkt[x:x + 2] = b"\xDF\x00"; x += 2
        pkt[2] = x - 3
        self._emmg_pkt = pkt
        return pkt, x // ECM_PAYLOAD_BYTES

    def _build_emms(self, t: int) -> bytearray:
        """EMM-Shared, fixed length (src/eurocrypt.c:1248-1359)."""
        em = self.emmode
        pkt = bytearray(MAC_PAYLOAD_BYTES)
        x = 0
        pkt[x] = EMMS; x += 1
        pkt[x:x + 3] = em.sa; x += 3
        pkt[x] = ((em.packet_type & 0x30) << 2) & 0xFF; x += 1
        pkt[x] = 0x28; x += 1
        pkt[x:x + 32] = b"\xFF" * 32; x += 32
        if em.des_algo == EC_M:
            self._emms_pkt = pkt
            self.emm_hash = self._emms_hash()
            pkt[x:x + 8] = self.emm_hash; x += 8
        else:
            x -= 7
            self._flag += 1
            if self._flag % 3 == 0:
                b = 0x02
            else:
                b = 0x20
                if em.des_algo == EC_3DES and em.packet_type == EC_3DES:
                    b |= _TDESMAP[(self.mode.ppid[2] & 0x0F) - 0x0C][t]
                else:
                    b |= self.mode.ppid[2] & 0x0F
            pkt[x] = b; x += 1
            b = (em.ppid[2] & 0x0F) << 4
            if em.packet_type == EC_M:
                b |= self.mode.ppid[1] & 0x0F
            else:
                b |= (self.mode.ppid[2] & 0xF0) >> 4
            pkt[x] = b; x += 1
            if self._flag % 3 == 0:
                self.enc_data = bytearray(
                    self._encrypt_date(bytearray(self._date_theme_block())))
            else:
                self.enc_data = bytearray(self._encrypt_opkey(t))
            pkt[x:x + 8] = self.enc_data; x += 8
            self._emms_pkt = pkt
            self.emm_hash = self._emms_hash()
            pkt[x:x + 5] = self.emm_hash[3:8]
        body = bytearray(pkt[1:])
        enc = mb.golay_encode(bytes(body[:45]), 30)
        pkt[1:1 + len(enc)] = enc
        return pkt

    def _emms_hash(self) -> bytes:
        """(src/eurocrypt.c:733-776)"""
        em = self.emmode
        if em.des_algo == EC_M:
            h = bytearray(8)
            h[5] = em.sa[2]
            h[6] = em.sa[1]
            h[7] = em.sa[0]
            ec_des(h, em.key, _HASH, self.mode.des_algo, 1)
            msg = bytearray(b"\x9e\x20")
            msg += self._emms_pkt[6:6 + 32]
            # continue the chained hash over the ADF
            for i, byte in enumerate(msg):
                h[i % 8] ^= byte
                if i % 8 == 7:
                    ec_des(h, em.key, _HASH, self.mode.des_algo, 1)
            ec_des(h, em.key, _HASH, self.mode.des_algo, 1)
            msg = bytes(self._emmg_pkt[8:8 + 15])
            h2 = bytearray(h)
            for i, byte in enumerate(msg):
                h2[i % 8] ^= byte
                if i % 8 == 7:
                    ec_des(h2, em.key, _HASH, em.des_algo, 1)
            ec_des(h2, em.key, _HASH, em.des_algo, 1)
            return bytes(h2)
        msg = bytes(self._emms_pkt[6:6 + 35]) + b"\xFF" * 5
        return _calc_hash(msg, em.des_algo, em.key)

    # -- frame hook -------------------------------------------------------
    def _send_split(self, mux, addr: int, ptype: int, pkt: bytearray,
                    cont: int):
        """Split a long command into 45-byte Golay-protected packets
        (src/eurocrypt.c:1596-1613)."""
        for i in range(cont + 1):
            chunk = bytearray(MAC_PAYLOAD_BYTES)
            seg = pkt[i * ECM_PAYLOAD_BYTES:
                      i * ECM_PAYLOAD_BYTES + ECM_PAYLOAD_BYTES + 1]
            chunk[:len(seg)] = seg
            chunk[0] = ptype
            body = mb.golay_encode(bytes(chunk[1:46]), 30)
            payload = bytes([chunk[0]]) + body
            mux._write_packet(0, addr, i, payload, False)

    def _print_ecm(self) -> None:
        """--showecm: print the current ECM packet + CWs to stderr
        (the reference's eurocrypt.c ECM debug print)."""
        import sys
        print("ECM: " + bytes(self.ecm_pkt).hex(), file=sys.stderr)

    def next_frame(self, mux, frame: int):
        if (frame & 0xFF) == 1:
            t = (frame >> 8) & 1
            mux.cw = self._update_cw(t)
            self.ecm_pkt, self.ecm_cont = self._build_ecm(t)
            if self.showecm:
                self._print_ecm()

        if frame % 64 == 1:
            self._send_split(mux, self.ECM_ADDR, 0x00, self.ecm_pkt,
                             self.ecm_cont)

        # The reference's EMM schedule tests vid->frame, the frame number
        # of the last *output* line, which trails the mux's l->frame by
        # exactly one frame at line 1 (pipeline window lag,
        # src/eurocrypt.c:1618,1630 vs src/video.c:4948) — so EMMs land
        # one frame after the & 0xFF == 0x7F mark.
        lagged = frame - 1
        if self.emmode is not None and (lagged & 0xFF) == 0x7F:
            t = (lagged >> 8) & 1
            if self.emmode.packet_type == EC_S:
                if self.emmode.emmtype == EMMU:
                    pkt, cont = self._build_emmu_system_s(t)
                    self._send_split(mux, self.EMM_ADDR, EMMU, pkt, cont)
            elif self.emmode.emmtype == EMMG:
                pkt, cont = self._build_emmg(t)
                self._send_split(mux, self.EMM_ADDR, EMMG, pkt, cont)
            elif self.emmode.emmtype == EMMU:
                pkt, cont = self._build_emmu(t)
                self._send_split(mux, self.EMM_ADDR, EMMU, pkt, cont)
            elif self.emmode.emmtype == EMMS:
                pkt, cont = self._build_emmgs(t)
                self._send_split(mux, self.EMM_ADDR, EMMG, pkt, cont)
                emms = self._build_emms(t)
                mux._write_packet(0, self.EMM_ADDR, 0, bytes(emms), False)

    def si_info(self) -> dict:
        return {"ecm_addr": self.ECM_ADDR,
                "packet_type": self.mode.packet_type}
