"""Nagravision Syster conditional-access cipher (src/syster-ca.c); a copy
of hacktv_tpu/services/syster_ca.py (pure Python).

A DES variant with a modified key schedule and custom permutations, used
to encrypt the 16-byte plain ECM into the over-air form and derive the
64-bit control word that seeds the line-shuffle PRBS.  Pure bit-domain
host code — runs once per ECM table build.
"""

from __future__ import annotations

NG_ENCRYPT = 1
NG_DECRYPT = 0

# Key left-shift schedule (src/syster-ca.c:28)
_LS = (1, 2, 2, 2, 2, 2, 2, 1, 2, 2, 2, 2, 2, 2, 1, 0)

# S-boxes (src/syster-ca.c:31-48)
_S = (
    0x1F, 0xB0, 0x28, 0xEB, 0xD1, 0x0D, 0x42, 0x7E, 0xC5, 0x59, 0x93, 0x34,
    0xA6, 0x6A, 0xFC, 0x87, 0xB0, 0xE3, 0x17, 0x7D, 0x2B, 0x96, 0xDE, 0x48,
    0x0A, 0x34, 0x6C, 0x81, 0xC5, 0x5F, 0xA9, 0xF2, 0x2E, 0xD0, 0x72, 0xB7,
    0x95, 0x0C, 0x48, 0xEB, 0x53, 0x6A, 0xC9, 0x14, 0xAF, 0xF1, 0x36, 0x8D,
    0x8D, 0x4E, 0xB1, 0xE8, 0x6B, 0x35, 0x17, 0xD2, 0xF0, 0x93, 0x56, 0x2F,
    0x0C, 0xCA, 0xA9, 0x74, 0xB2, 0x4F, 0xD4, 0x18, 0x0B, 0xF6, 0x7E, 0x25,
    0xC1, 0x3C, 0x6A, 0x83, 0xAD, 0x50, 0x97, 0xE9, 0xE9, 0xB4, 0x42, 0x27,
    0x3E, 0xCB, 0x85, 0x18, 0x56, 0x0A, 0x9F, 0x70, 0xF1, 0xAD, 0x6C, 0xD3,
    0x35, 0xE0, 0x5B, 0x0D, 0x68, 0xD3, 0x96, 0x7A, 0xF9, 0x2E, 0xC2, 0xB1,
    0x1F, 0x84, 0xAC, 0x47, 0x6B, 0x1C, 0x0D, 0xA3, 0xD6, 0x7A, 0x30, 0xC5,
    0x84, 0xF1, 0xBE, 0x58, 0xE9, 0x2F, 0x47, 0x92, 0xD1, 0x34, 0xBD, 0xE3,
    0x8B, 0x58, 0x42, 0x9E, 0x7A, 0xAF, 0xC0, 0x05, 0x2C, 0xF6, 0x17, 0x69,
    0xB4, 0xD7, 0xE3, 0x48, 0x5E, 0x21, 0x8D, 0x72, 0x09, 0x60, 0x3F, 0xA6,
    0x95, 0xCB, 0xFA, 0x1C, 0x82, 0x27, 0x14, 0xCA, 0xF9, 0x90, 0x6F, 0x5C,
    0xEB, 0xD8, 0x7D, 0xA3, 0x4E, 0x35, 0xB1, 0x06, 0x5C, 0x90, 0x6F, 0xF9,
    0x35, 0x4E, 0x82, 0x27, 0x06, 0xEB, 0xCA, 0x14, 0xA3, 0xD8, 0x7D, 0xB1,
    0x52, 0xF8, 0x6F, 0x16, 0x9C, 0xCB, 0x09, 0xA5, 0xED, 0x27, 0x3A, 0x81,
    0x43, 0xB4, 0xD0, 0x7E, 0x2E, 0x95, 0xB2, 0x6F, 0x79, 0x06, 0xC7, 0xF8,
    0x4B, 0xE0, 0xD1, 0x3C, 0xA4, 0x5A, 0x1D, 0x83, 0x0C, 0xE2, 0x7B, 0x18,
    0x90, 0x4D, 0xC7, 0xB1, 0x63, 0x8F, 0xDE, 0x25, 0x39, 0xF6, 0xA4, 0x5A,
    0xF2, 0x17, 0x85, 0x4E, 0x5C, 0xB0, 0x2B, 0xED, 0xA4, 0x79, 0x38, 0x93,
    0x6F, 0xCA, 0xD1, 0x06,
)

# Key expansion table (src/syster-ca.c:51-58)
_C = (
    28, 31, 24, 10, 18, 14, 7, 26, 4, 21, 11, 16, 12, 27, 15, 9,
    20, 30, 5, 13, 23, 29, 8, 19, 62, 51, 44, 37, 57, 48, 56, 38,
    60, 52, 45, 41, 54, 43, 58, 49, 36, 61, 59, 63, 40, 53, 47, 50,
)

# CW expansion table (src/syster-ca.c:61-68)
_E = (
    31, 0, 1, 2, 3, 4, 3, 4, 5, 6, 7, 8, 7, 8, 9, 10,
    11, 12, 11, 12, 13, 14, 15, 16, 15, 16, 17, 18, 19, 20, 19, 20,
    21, 22, 23, 24, 23, 24, 25, 26, 27, 28, 27, 28, 29, 30, 31, 0,
)

# Output permutation: (byte | bit<<4) targets (src/syster-ca.c:71-76)
_P = (
    0x31, 0x12, 0x50, 0x33, 0x13, 0x21, 0x42, 0x00,
    0x51, 0x52, 0x30, 0x43, 0x53, 0x70, 0x22, 0x03,
    0x73, 0x62, 0x41, 0x60, 0x23, 0x20, 0x02, 0x01,
    0x61, 0x63, 0x40, 0x32, 0x10, 0x11, 0x71, 0x72,
)

_KP = (0, 3, 2, 1, 4, 5, 6, 7)   # initial key permutation
_IP = (4, 0, 5, 1, 6, 2, 7, 3)   # initial CW permutation
_FP = (7, 3, 6, 2, 5, 1, 4, 0)   # final CW permutation


def _permute(src, p):
    """Bit permutation (src/syster-ca.c:88-113); p[0]&3 selects the final
    (bits shifted out of T[p[i]] into out[j]) vs initial direction."""
    T = list(src)
    out = [0] * 8
    final = bool(p[0] & 3)
    for j in range(7, -1, -1):
        for i in range(8):
            if final:
                out[j] = ((out[j] << 1) | (T[p[i]] & 1)) & 0xFF
                T[p[i]] >>= 1
            else:
                out[p[i]] = (out[p[i]] >> 1) | (0x80 if T[j] & 1 else 0)
                T[j] >>= 1
    return out


def _expand(e, data):
    """48-bit expansion of key (table C) or CW (table E)
    (src/syster-ca.c:116-130)."""
    mask = 0x1F if e[0] == 0x1F else 0xFF
    result = [0] * 8
    for j in range(8):
        for i in range(6, 0, -1):
            result[j] = (result[j] << 1) & 0xFF
            d = e[(7 - j) * 6 + (i - 1)] & mask
            if data[d >> 3] & (1 << (d & 7)):
                result[j] |= 1
    return result


def _key_rotate(rounds, k):
    """Rotate each 28-bit key half right LS[rounds] times in place
    (src/syster-ca.c:133-148)."""
    for _ in range(_LS[rounds]):
        for j in range(3):
            k[j] = (k[j] >> 1) | ((k[j + 1] & 1) << 7)
            k[j + 4] = (k[j + 4] >> 1) | ((k[j + 5] & 1) << 7)
        k[3] = (k[3] >> 1) | (((k[0] >> 3) & 1) << 7)
        k[7] = (k[7] >> 1) | (((k[4] >> 3) & 1) << 7)


def _des_f(k, cw, m):
    """16-round Feistel core, in-place on cw (src/syster-ca.c:151-219)."""
    kr = []
    k = list(k)
    for i in range(16):
        kr.append(list(k))
        _key_rotate(i, k)

    for i in range(16):
        ek = _expand(_C, kr[15 - i if m else i])
        ecw = _expand(_E, cw)
        r = [0] * 4
        j = 31
        for c in range(8):
            x = (ek[c] ^ ecw[c]) & 0x3F
            sb = _S[(x >> 1) | ((0x20 * (8 - c)) & 0xFF)]
            if x & 1:
                sb = (sb << 4) & 0xF0
            for _ in range(4):
                b = _P[j] & 0x03
                mbit = 1 << ((_P[j] >> 4) & 0x07)
                r[b] = (r[b] & (mbit ^ 0xFF)) if sb & 0x80 else (r[b] | mbit)
                sb = (sb << 1) & 0xFF
                j -= 1
        for l in range(4):
            r[l] ^= cw[l + 4]
            cw[l + 4] = cw[l]
            cw[l] = r[l]


def encrypt_syster_cw(ecm, key, m=NG_ENCRYPT):
    """Encrypt (in place) a 16-byte plain ECM; returns the 64-bit control
    word (src/syster-ca.c:221-275).  `ecm` must be a mutable list."""
    buffer1 = [0] * 8
    for rnd in range(2):
        k64ip = _permute(key, _KP)
        k64ip[0] = (k64ip[4] << 4) & 0xFF
        pcw = _permute(ecm[rnd * 8:rnd * 8 + 8], _IP)
        _des_f(k64ip, pcw, m)
        buffer2 = _permute(pcw, _FP)
        if m == NG_ENCRYPT:
            buffer1[rnd * 4:rnd * 4 + 4] = ecm[rnd * 12:rnd * 12 + 4]
            ecm[rnd * 8:rnd * 8 + 8] = buffer2
        else:
            buffer1[rnd * 4:rnd * 4 + 4] = buffer2[rnd * 4:rnd * 4 + 4]

    cw = [0] * 8
    for i in range(4):
        cw[i] = buffer1[i + 4] & (0x7F if i == 3 else 0xFF)
        cw[i + 4] = (((buffer1[i] << 1) & (0x1F if i == 3 else 0xFF))
                     | ((buffer1[7 if i == 0 else i - 1] >> 7) & 1))
    word = 0
    for i in range(8):
        word |= cw[i] << (i * 8)
    return word
