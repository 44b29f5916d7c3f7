"""Per-line content descriptors for each raster type.

Each scan line is described by a 4-character code "abcd" (the scheme of
src/video.c:2447-2810 `_line_sequence`):

  a: first sync       h=horizontal, v=short vertical, V=long vertical, _=none
  b: colour burst     0=always, _=never, 1=burst on even frame counts,
                      2=burst on odd frame counts
  c: left content     _=blanking, a=active video
  d: right content    _=blanking, a=active video, v=short sync, V=long sync

`line_sequence(type, line)` returns the code for 1-based `line`;
`active_video_line(type, line)` the source row mapping
(src/video.c:2812-2862).
"""

from __future__ import annotations

from ..config.standards import RasterType

# Sparse tables: {line: seq}, plus the default for unlisted lines.
_SEQ_625 = {
    1: "V__V", 2: "V__V", 3: "V__v", 4: "v__v", 5: "v__v", 6: "h1__",
    **{n: "h0__" for n in range(7, 23)},
    23: "h0_a",
    310: "h1aa", 311: "v__v", 312: "v__v", 313: "v__V", 314: "V__V",
    315: "V__V", 316: "v__v", 317: "v__v", 318: "v___", 319: "h2__",
    **{n: "h0__" for n in range(320, 336)},
    622: "h1aa", 623: "h_av", 624: "v__v", 625: "v__v",
}

_SEQ_525 = {
    1: "v__v", 2: "v__v", 3: "v__v", 4: "V__V", 5: "V__V", 6: "V__V",
    7: "v__v", 8: "v__v", 9: "v__v",
    **{n: "h0__" for n in range(10, 21)},
    263: "h0av", 264: "v__v", 265: "v__v", 266: "v__V", 267: "V__V",
    268: "V__V", 269: "V__v", 270: "v__v", 271: "v__v", 272: "v___",
    **{n: "h0__" for n in range(273, 283)},
    283: "h0_a",
}

_SEQ_819 = {
    817: "h___", 818: "h___", 819: "h___",
    1: "V___",
    **{n: "h___" for n in range(2, 39)},
    406: "h_a_", 407: "h___", 408: "h___", 409: "h__V",
    **{n: "h___" for n in range(410, 447)},
    447: "h__a",
}

_SEQ_405 = {
    1: "V__V", 2: "V__V", 3: "V__V", 4: "V__V",
    **{n: "h0__" for n in range(5, 16)},
    203: "h0aV", 204: "V__V", 205: "V__V", 206: "V__V", 207: "V___",
    **{n: "h0__" for n in range(208, 218)},
    218: "h0_a",
}

_SEQ_CBS405 = {
    1: "v__v", 2: "v__v", 3: "v__v", 4: "V__V", 5: "V__V", 6: "V__V",
    7: "v__v", 8: "v__v", 9: "v__v",
    **{n: "h___" for n in range(10, 15)},
    203: "h_av", 204: "v__v", 205: "v__v", 206: "v__V", 207: "V__V",
    208: "V__V", 209: "V__v", 210: "v__v", 211: "v__v", 212: "v___",
    213: "h___", 214: "h___", 215: "h___", 216: "h___", 217: "h__a",
}

_SEQ_BAIRD_240 = {
    **{n: "V__V" for n in range(1, 13)},
    **{n: "h___" for n in range(13, 21)},
}

_TABLES = {
    RasterType.RASTER_625: (_SEQ_625, "h0aa"),
    RasterType.RASTER_525: (_SEQ_525, "h0aa"),
    RasterType.RASTER_819: (_SEQ_819, "h_aa"),
    RasterType.RASTER_405: (_SEQ_405, "h0aa"),
    RasterType.CBS_405: (_SEQ_CBS405, "h_aa"),
    RasterType.BAIRD_240: (_SEQ_BAIRD_240, "h_aa"),
}


def line_sequence(rtype: RasterType, line: int) -> str:
    if rtype == RasterType.APOLLO_320:
        return "V__v" if line <= 8 else "h_aa"
    if rtype == RasterType.BAIRD_30:
        return "__aa"
    if rtype == RasterType.NBTV_32:
        return "__aa" if line == 1 else "h_aa"
    table, default = _TABLES[rtype]
    # Line 0 only occurs once, at stream start, before the first real line;
    # the reference's switch falls through to the default for it.
    return table.get(line, default)


def active_video_line(rtype: RasterType, line: int) -> int:
    """Map a 1-based scan line to the source frame row (-1 = none).

    src/video.c:2812-2862.
    """
    if rtype == RasterType.RASTER_625:
        return (line - 23) * 2 if line < 313 else (line - 336) * 2 + 1
    if rtype == RasterType.RASTER_525:
        return (line - 23) * 2 if line < 265 else (line - 286) * 2 + 1
    if rtype == RasterType.RASTER_819:
        return (line - 48) * 2 if line < 406 else (line - 457) * 2 + 1
    if rtype == RasterType.RASTER_405:
        return (line - 16) * 2 if line < 210 else (line - 218) * 2 + 1
    if rtype == RasterType.CBS_405:
        return (line - 16) * 2 if line < 210 else (line - 219) * 2 + 1
    if rtype == RasterType.APOLLO_320:
        return line - 9
    if rtype == RasterType.BAIRD_240:
        return line - 20
    if rtype in (RasterType.BAIRD_30, RasterType.NBTV_32):
        return line - 1
    return -1
