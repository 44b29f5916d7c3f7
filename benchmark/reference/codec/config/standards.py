"""TV standards registry.

Every timing, level and carrier constant needed to reproduce the 50 modes
of the reference's standards table (src/video.c:50-2008 `vid_configs[]`).
The values are the physical constants of the analogue TV systems and must
match the reference exactly for output parity; the representation (frozen
dataclasses, exact `Rational` carriers) is our own.

Enumerations mirror src/video.h:49-87.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field, replace
from typing import Optional

from ..rational import Rational

MAC_CLOCK_RATE = 20250000  # src/mac.h:23


class OutputType(enum.Enum):
    REAL = "real"
    COMPLEX = "complex"


class Modulation(enum.Enum):
    NONE = 0
    AM = 1
    VSB = 2
    FM = 3


class RasterType(enum.Enum):
    RASTER_625 = 0
    RASTER_525 = 1
    RASTER_405 = 2
    RASTER_819 = 3
    BAIRD_240 = 4
    BAIRD_30 = 5
    NBTV_32 = 6
    APOLLO_320 = 7
    MAC = 8
    CBS_405 = 9


class ColourMode(enum.Enum):
    MONOCHROME = 0
    PAL = 1
    NTSC = 2
    SECAM = 3
    APOLLO_FSC = 4
    CBS_FSC = 5


class Preemph(enum.Enum):
    NONE = 0
    US50 = 1
    US75 = 2
    J17 = 3


class MacMode(enum.Enum):
    D2 = 0
    D = 1


# SECAM chroma FM constants (src/video.c:45-48)
SECAM_FM_DEV = 1000e3
SECAM_FM_FREQ = 4328125.0   # 277 fH
SECAM_CB_FREQ = 4250000.0   # 272 fH
SECAM_CR_FREQ = 4406250.0   # 282 fH


@dataclass(frozen=True)
class VidConfig:
    """Mirror of the reference's `vid_config_t` (src/video.h:125-292)."""

    output_type: OutputType = OutputType.COMPLEX
    modulation: Modulation = Modulation.NONE

    video_bw: float = 0.0
    vsb_upper_bw: float = 0.0
    vsb_lower_bw: float = 0.0

    fm_level: float = 0.0
    fm_deviation: float = 0.0
    fm_energy_dispersal: float = 0.0

    level: float = 1.0
    swap_iq: bool = False
    offset: int = 0

    video_level: float = 0.0
    fm_mono_level: float = 0.0
    fm_left_level: float = 0.0
    fm_right_level: float = 0.0
    am_audio_level: float = 0.0
    nicam_level: float = 0.0
    dance_level: float = 0.0

    type: RasterType = RasterType.RASTER_625
    frame_rate: Rational = Rational(25, 1)
    frame_aspects: tuple = (Rational(4, 3),)
    frame_orientation: int = 0

    lines: int = 625
    hline: int = 0
    interlaced: int = 0        # 0 = progressive, 1 = TFF, 2 = BFF
    active_lines: int = 0
    interlace: int = 0         # update image per field rather than frame

    hsync_width: float = 0.0
    vsync_short_width: float = 0.0
    vsync_long_width: float = 0.0
    sync_rise: float = 0.0

    invert_video: bool = False
    white_level: float = 0.0
    black_level: float = 0.0
    blanking_level: float = 0.0
    sync_level: float = 0.0

    active_width: float = 0.0
    active_left: float = 0.0

    gamma: float = 0.0

    # RGB weights (defaults applied at derive time, src/video.c:3834-3836)
    rw_co: float = 0.0
    gw_co: float = 0.0
    bw_co: float = 0.0

    colour_mode: ColourMode = ColourMode.MONOCHROME
    colour_carrier: Optional[Rational] = None
    colour_bw: float = 0.0
    s_video: bool = False

    burst_width: float = 0.0
    burst_left: float = 0.0
    burst_level: float = 0.0
    burst_rise: float = 0.0

    fsc_flag_width: float = 0.0
    fsc_flag_left: float = 0.0
    fsc_flag_level: float = 0.0

    ev_co: float = 0.0
    eu_co: float = 0.0

    secam_field_id: bool = False
    secam_field_id_lines: int = 0

    volume: float = 1.0

    fm_mono_carrier: float = 0.0
    fm_mono_deviation: float = 0.0
    fm_mono_preemph: Preemph = Preemph.NONE

    fm_left_carrier: float = 0.0
    fm_left_deviation: float = 0.0
    fm_left_preemph: Preemph = Preemph.NONE

    fm_right_carrier: float = 0.0
    fm_right_deviation: float = 0.0
    fm_right_preemph: Preemph = Preemph.NONE

    a2stereo: bool = False

    nicam_carrier: float = 0.0
    nicam_beta: float = 0.0

    dance_carrier: float = 0.0
    dance_beta: float = 0.0

    am_mono_carrier: float = 0.0
    am_mono_bandwidth: float = 0.0

    mac_mode: Optional[MacMode] = None
    chid: int = 0
    mac_audio_stereo: bool = True
    mac_audio_quality: bool = True
    mac_audio_protection: bool = False   # False = first level (src/hacktv.c:592)
    mac_audio_companded: bool = True
    scramble_video: int = 0
    scramble_audio: int = 0

    vfilter: bool = False


# ---------------------------------------------------------------------------
# 625-line PAL timing shared by most PAL 625 modes (src/video.c:50-315)
_RASTER_625 = dict(
    type=RasterType.RASTER_625,
    frame_rate=Rational(25, 1),
    frame_aspects=(Rational(4, 3),),
    lines=625,
    interlaced=1,
    active_lines=576,
    active_width=0.00005195,
    active_left=0.00001040,
    hsync_width=0.00000470,
    vsync_short_width=0.00000235,
    vsync_long_width=0.00002730,
)

_PAL_COLOUR = dict(
    colour_mode=ColourMode.PAL,
    burst_width=0.00000225,
    burst_rise=0.00000030,
    burst_left=0.00000560,
    burst_level=3.0 / 7.0,
    colour_carrier=Rational(17734475, 4),  # 4433618.75 Hz
    colour_bw=1.4e6,
    ev_co=0.877,
    eu_co=0.493,
)

PAL_I = VidConfig(
    output_type=OutputType.COMPLEX,
    modulation=Modulation.VSB,
    vsb_upper_bw=5500000.0,
    vsb_lower_bw=1250000.0,
    level=1.0,
    video_level=0.71,
    fm_mono_level=0.22,
    nicam_level=0.07 / 2,
    sync_rise=0.00000025,
    white_level=0.20, black_level=0.76, blanking_level=0.76, sync_level=1.00,
    fm_mono_carrier=6000000 - 400,
    fm_mono_deviation=50000,
    fm_mono_preemph=Preemph.US50,
    nicam_carrier=6552000.0,
    nicam_beta=1.0,
    **_RASTER_625, **_PAL_COLOUR,
)

PAL_BG = replace(
    PAL_I,
    vsb_upper_bw=5000000.0, vsb_lower_bw=750000.0,
    fm_mono_level=0.15,
    sync_rise=0.00000020,
    fm_mono_carrier=5500000.0,
    nicam_carrier=5850000.0, nicam_beta=0.4,
)

PAL_DK = replace(
    PAL_I,
    vsb_upper_bw=5500000.0, vsb_lower_bw=750000.0,
    video_level=0.70, fm_mono_level=0.20,
    sync_rise=0.00000020,
    fm_mono_carrier=6500000.0,
    nicam_carrier=5850000.0, nicam_beta=0.4,
)

PAL_FM = VidConfig(
    output_type=OutputType.COMPLEX,
    modulation=Modulation.FM,
    fm_level=1.0,
    fm_deviation=16e6,
    level=1.0,
    video_level=1.00,
    fm_mono_level=0.06,
    sync_rise=0.00000020,
    white_level=0.50, black_level=-0.20, blanking_level=-0.20, sync_level=-0.50,
    fm_mono_carrier=6500000.0,
    fm_mono_deviation=85000.0,
    fm_mono_preemph=Preemph.US50,
    **_RASTER_625, **_PAL_COLOUR,
)

PAL = VidConfig(
    output_type=OutputType.REAL,
    level=1.0, video_level=1.0,
    video_bw=6.0e6,
    sync_rise=0.00000020,
    white_level=0.70, black_level=0.00, blanking_level=0.00, sync_level=-0.30,
    **_RASTER_625, **_PAL_COLOUR,
)

# 525-line raster timing (src/video.c:316-455)
_RASTER_525 = dict(
    type=RasterType.RASTER_525,
    frame_rate=Rational(30000, 1001),
    frame_aspects=(Rational(4, 3),),
    lines=525,
    interlaced=1,
    active_lines=480,
    hsync_width=0.00000470,
    vsync_short_width=0.00000230,
    vsync_long_width=0.00002710,
)

_PAL_M_COLOUR = dict(
    colour_mode=ColourMode.PAL,
    burst_width=0.00000252,
    burst_rise=0.00000030,
    burst_left=0.00000530,
    burst_level=33.0 / 73.0,
    colour_bw=1.4e6,
    ev_co=0.877,
    eu_co=0.493,
)

PAL_M = VidConfig(
    output_type=OutputType.COMPLEX,
    modulation=Modulation.VSB,
    vsb_upper_bw=4200000.0, vsb_lower_bw=750000.0,
    level=1.0, video_level=0.77, fm_mono_level=0.15,
    active_width=0.00005280, active_left=0.00000920,
    sync_rise=0.00000020,
    white_level=0.2000, black_level=0.7280, blanking_level=0.7712, sync_level=1.0000,
    colour_carrier=Rational(511312500, 143),  # 3575611.888... Hz
    fm_mono_carrier=4500000.0, fm_mono_deviation=25000.0,
    fm_mono_preemph=Preemph.US75,
    **_RASTER_525, **_PAL_M_COLOUR,
)

PAL_N = VidConfig(
    output_type=OutputType.COMPLEX,
    modulation=Modulation.VSB,
    vsb_upper_bw=4200000.0, vsb_lower_bw=750000.0,
    level=1.0, video_level=0.77, fm_mono_level=0.15,
    sync_rise=0.00000020,
    white_level=0.2000, black_level=0.7280, blanking_level=0.7712, sync_level=1.0000,
    colour_mode=ColourMode.PAL,
    burst_width=0.00000252, burst_rise=0.00000030, burst_left=0.00000530,
    burst_level=33.0 / 73.0,
    colour_carrier=Rational(14328225, 4),  # 3582056.25 Hz
    colour_bw=1.4e6,
    ev_co=0.877, eu_co=0.493,
    fm_mono_carrier=4500000.0, fm_mono_deviation=25000.0,
    fm_mono_preemph=Preemph.US75,
    **_RASTER_625,
)

PAL_525 = VidConfig(
    output_type=OutputType.REAL,
    level=1.0, video_level=1.0,
    video_bw=6.0e6,
    active_width=0.00005280, active_left=0.00000920,
    sync_rise=0.00000020,
    white_level=0.70, black_level=0.00, blanking_level=0.00, sync_level=-0.30,
    colour_carrier=Rational(511312500, 143),
    **_RASTER_525, **_PAL_M_COLOUR,
)

# --- SECAM (src/video.c:457-753) -------------------------------------------
_SECAM_COLOUR = dict(
    colour_mode=ColourMode.SECAM,
    burst_width=0.00005690,
    burst_rise=0.00000100,
    burst_left=0.00000560,
    ev_co=-1.902 * 280e3,   # D'R
    eu_co=1.505 * 230e3,    # D'B
)

SECAM_L = VidConfig(
    output_type=OutputType.COMPLEX,
    modulation=Modulation.VSB,
    vsb_upper_bw=6000000.0, vsb_lower_bw=1250000.0,
    level=1.0,
    video_level=0.80 * (100.0 / 124.0),
    am_audio_level=0.10,
    nicam_level=0.04,
    sync_rise=0.00000020,
    white_level=1.00, black_level=0.30, blanking_level=0.30, sync_level=0.05,
    am_mono_carrier=6500000.0,
    nicam_carrier=5850000.0, nicam_beta=0.4,
    **_RASTER_625, **_SECAM_COLOUR,
)

SECAM_DK = VidConfig(
    output_type=OutputType.COMPLEX,
    modulation=Modulation.VSB,
    vsb_upper_bw=5500000.0, vsb_lower_bw=750000.0,
    level=1.0, video_level=0.70, fm_mono_level=0.20, nicam_level=0.07 / 2,
    sync_rise=0.00000020,
    white_level=0.20, black_level=0.76, blanking_level=0.76, sync_level=1.00,
    fm_mono_carrier=6500000.0, fm_mono_deviation=50000.0,
    fm_mono_preemph=Preemph.US50,
    nicam_carrier=5850000.0, nicam_beta=0.4,
    **_RASTER_625, **_SECAM_COLOUR,
)

SECAM_I = VidConfig(
    output_type=OutputType.COMPLEX,
    modulation=Modulation.VSB,
    vsb_upper_bw=5500000.0, vsb_lower_bw=1250000.0,
    level=1.0, video_level=0.71, fm_mono_level=0.15, nicam_level=0.07 / 2,
    sync_rise=0.00000025,
    white_level=0.20, black_level=0.76, blanking_level=0.76, sync_level=1.00,
    fm_mono_carrier=6000000 - 400, fm_mono_deviation=50000.0,
    fm_mono_preemph=Preemph.US50,
    nicam_carrier=6552000.0, nicam_beta=1.0,
    **_RASTER_625, **_SECAM_COLOUR,
)

SECAM_BG = VidConfig(
    output_type=OutputType.COMPLEX,
    modulation=Modulation.VSB,
    vsb_upper_bw=5000000.0, vsb_lower_bw=750000.0,
    level=1.0,
    video_level=0.80 * (100.0 / 124.0),
    fm_mono_level=0.15, nicam_level=0.07 / 2,
    sync_rise=0.00000020,
    white_level=0.20, black_level=0.76, blanking_level=0.76, sync_level=1.00,
    fm_mono_carrier=5500000.0, fm_mono_deviation=50000.0,
    fm_mono_preemph=Preemph.US50,
    nicam_carrier=5850000.0, nicam_beta=0.4,
    **_RASTER_625, **_SECAM_COLOUR,
)

SECAM_FM = VidConfig(
    output_type=OutputType.COMPLEX,
    modulation=Modulation.FM,
    fm_level=1.0, fm_deviation=16e6,
    level=1.0, video_level=1.00, fm_mono_level=0.05,
    sync_rise=0.00000020,
    white_level=0.50, black_level=-0.20, blanking_level=-0.20, sync_level=-0.50,
    fm_mono_carrier=6500000.0, fm_mono_deviation=85000.0,
    fm_mono_preemph=Preemph.US50,
    **_RASTER_625, **_SECAM_COLOUR,
)

SECAM = VidConfig(
    output_type=OutputType.REAL,
    level=1.0, video_level=1.0,
    video_bw=6.0e6,
    sync_rise=0.00000020,
    white_level=0.70, black_level=0.00, blanking_level=0.00, sync_level=-0.30,
    **_RASTER_625, **_SECAM_COLOUR,
)

# --- NTSC (src/video.c:755-1008) -------------------------------------------
_NTSC_COLOUR = dict(
    colour_mode=ColourMode.NTSC,
    burst_width=0.00000250,
    burst_rise=0.00000030,
    burst_left=0.00000530,
    burst_level=4.0 / 10.0,
    colour_carrier=Rational(39375000, 11),  # 3579545.4545... Hz
    colour_bw=1.4e6,
    ev_co=0.877,
    eu_co=0.493,
)

_NTSC_RASTER = dict(
    active_width=0.00005290,
    active_left=0.00000920,
    sync_rise=0.00000025,
)

NTSC_M = VidConfig(
    output_type=OutputType.COMPLEX,
    modulation=Modulation.VSB,
    vsb_upper_bw=4200000.0, vsb_lower_bw=750000.0,
    level=1.0, video_level=0.77, fm_mono_level=0.15,
    white_level=0.125000, black_level=0.703125,
    blanking_level=0.750000, sync_level=1.000000,
    fm_mono_carrier=4500000.0, fm_mono_deviation=25000.0,
    fm_mono_preemph=Preemph.US75,
    **_RASTER_525, **_NTSC_RASTER, **_NTSC_COLOUR,
)

NTSC_I = VidConfig(
    output_type=OutputType.COMPLEX,
    modulation=Modulation.VSB,
    vsb_upper_bw=5500000.0, vsb_lower_bw=1250000.0,
    level=1.0, video_level=0.71, fm_mono_level=0.22, nicam_level=0.07 / 2,
    white_level=0.200000, black_level=0.728571,
    blanking_level=0.771428, sync_level=1.000000,
    fm_mono_carrier=6000000 - 400, fm_mono_deviation=50000.0,
    fm_mono_preemph=Preemph.US50,
    nicam_carrier=6552000.0, nicam_beta=1.0,
    **_RASTER_525, **_NTSC_RASTER, **_NTSC_COLOUR,
)

NTSC_FM = VidConfig(
    output_type=OutputType.COMPLEX,
    modulation=Modulation.FM,
    fm_level=1.0, fm_deviation=16e6,
    level=1.0, video_level=1.00, fm_mono_level=0.05,
    white_level=0.5000, black_level=-0.1607,
    blanking_level=-0.2143, sync_level=-0.5000,
    fm_mono_carrier=6500000.0, fm_mono_deviation=85000.0,
    fm_mono_preemph=Preemph.US50,
    **_RASTER_525, **_NTSC_RASTER, **_NTSC_COLOUR,
)

NTSC_BS_FM = VidConfig(
    output_type=OutputType.COMPLEX,
    modulation=Modulation.FM,
    fm_level=1.0, fm_deviation=17.0e6,
    level=1.0, video_level=1.00, dance_level=0.19,
    white_level=0.5000, black_level=-0.2143,
    blanking_level=-0.2143, sync_level=-0.5000,
    dance_carrier=5000000.0 * 63 / 88 * 8 / 5,
    dance_beta=1.0,
    **_RASTER_525, **_NTSC_RASTER, **_NTSC_COLOUR,
)

NTSC = VidConfig(
    output_type=OutputType.REAL,
    level=1.0, video_level=1.0,
    video_bw=6.0e6,
    white_level=100.0 / 140, black_level=7.5 / 140,
    blanking_level=0.0 / 140, sync_level=-40.0 / 140,
    **_RASTER_525, **_NTSC_RASTER, **_NTSC_COLOUR,
)

PAL60_I = VidConfig(
    output_type=OutputType.COMPLEX,
    modulation=Modulation.VSB,
    vsb_upper_bw=5500000.0, vsb_lower_bw=1250000.0,
    level=1.0, video_level=0.71, fm_mono_level=0.22, nicam_level=0.07 / 2,
    active_width=0.00005290, active_left=0.00000920,
    sync_rise=0.00000025,
    white_level=0.20, black_level=0.76, blanking_level=0.76, sync_level=1.00,
    colour_mode=ColourMode.PAL,
    burst_width=0.00000225, burst_rise=0.00000030, burst_left=0.00000560,
    burst_level=3.0 / 7.0,
    colour_carrier=Rational(17734475, 4),
    colour_bw=1.4e6,
    ev_co=0.877, eu_co=0.493,
    fm_mono_carrier=6000000 - 400, fm_mono_deviation=50000.0,
    fm_mono_preemph=Preemph.US50,
    nicam_carrier=6552000.0, nicam_beta=1.0,
    **_RASTER_525,
)

PAL60 = VidConfig(
    output_type=OutputType.REAL,
    level=1.0, video_level=1.0,
    video_bw=6.0e6,
    active_width=0.00005290, active_left=0.00000920,
    white_level=0.70, black_level=0.00, blanking_level=0.00, sync_level=-0.30,
    colour_mode=ColourMode.PAL,
    burst_width=0.00000225, burst_rise=0.00000030, burst_left=0.00000560,
    burst_level=3.0 / 7.0,
    colour_carrier=Rational(17734475, 4),
    colour_bw=1.4e6,
    ev_co=0.877, eu_co=0.493,
    **_RASTER_525,
)

# --- D/D2-MAC (src/video.c:1105-1299) --------------------------------------
_MAC_COMMON = dict(
    type=RasterType.MAC,
    chid=0xE8B5,
    frame_rate=Rational(25, 1),
    frame_aspects=(Rational(4, 3), Rational(16, 9)),
    lines=625,
    interlaced=1,
    active_lines=576,
    active_left=585.0 / MAC_CLOCK_RATE,
    active_width=702.0 / MAC_CLOCK_RATE,
    ev_co=0.927,
    eu_co=0.733,
)

D2MAC_AM = VidConfig(
    output_type=OutputType.COMPLEX,
    modulation=Modulation.AM,
    level=1.00, video_level=0.85,
    white_level=0.10, black_level=1.00, blanking_level=0.55, sync_level=0.55,
    mac_mode=MacMode.D2,
    **_MAC_COMMON,
)

D2MAC_FM = VidConfig(
    output_type=OutputType.COMPLEX,
    modulation=Modulation.FM,
    fm_level=1.0, fm_deviation=13.5e6,
    level=1.0, video_level=1.0,
    white_level=0.50, black_level=-0.50, blanking_level=0.00, sync_level=0.00,
    mac_mode=MacMode.D2,
    **_MAC_COMMON,
)

D2MAC = VidConfig(
    output_type=OutputType.REAL,
    video_bw=6.0e6,
    level=1.0, video_level=1.0,
    white_level=0.50, black_level=-0.50, blanking_level=0.00, sync_level=0.00,
    mac_mode=MacMode.D2,
    **_MAC_COMMON,
)

DMAC_AM = replace(D2MAC_AM, mac_mode=MacMode.D)
DMAC_FM = replace(D2MAC_FM, mac_mode=MacMode.D)
DMAC = replace(D2MAC, mac_mode=MacMode.D, video_bw=8.4e6)

# --- 819-line French system (src/video.c:1301-1364) ------------------------
_RASTER_819 = dict(
    type=RasterType.RASTER_819,
    frame_rate=Rational(25, 1),
    frame_aspects=(Rational(4, 3),),
    lines=819,
    interlaced=1,
    active_lines=720,
    active_width=0.00003944,
    active_left=0.00000890,
    hsync_width=0.00000250,
    vsync_long_width=0.00002000,
)

SYS_819_E = VidConfig(
    output_type=OutputType.COMPLEX,
    modulation=Modulation.VSB,
    vsb_upper_bw=2000000.0, vsb_lower_bw=10400000.0,
    level=1.0, video_level=0.8, am_audio_level=0.2,
    white_level=1.00, black_level=0.35, blanking_level=0.30, sync_level=0.00,
    am_mono_carrier=11.15e6, am_mono_bandwidth=10000.0,
    **_RASTER_819,
)

SYS_819 = VidConfig(
    output_type=OutputType.REAL,
    video_bw=10.4e6,
    level=1.0, video_level=1.0,
    white_level=0.70, black_level=0.05, blanking_level=0.00, sync_level=-0.30,
    **_RASTER_819,
)

# --- 405-line (src/video.c:1366-1559) ---------------------------------------
_RASTER_405 = dict(
    type=RasterType.RASTER_405,
    frame_rate=Rational(25, 1),
    frame_aspects=(Rational(4, 3),),
    lines=405,
    interlaced=2,
    active_lines=378,
    active_width=0.00008030,
    active_left=0.00001680,
    hsync_width=0.00000900,
    vsync_long_width=0.00004000,
    sync_rise=0.00000025,
)

SYS_405_A = VidConfig(
    output_type=OutputType.COMPLEX,
    modulation=Modulation.VSB,
    vsb_upper_bw=750000.0, vsb_lower_bw=3000000.0,
    level=1.0, video_level=0.8, am_audio_level=0.2,
    white_level=1.00, black_level=0.30, blanking_level=0.30, sync_level=0.00,
    am_mono_carrier=-3500000.0, am_mono_bandwidth=10000.0,
    **_RASTER_405,
)

SYS_405_A_NTSC = VidConfig(
    output_type=OutputType.COMPLEX,
    modulation=Modulation.VSB,
    vsb_upper_bw=750000.0, vsb_lower_bw=3000000.0,
    level=1.0, video_level=0.80 / 1.22, am_audio_level=0.20,
    white_level=1.00, black_level=0.35, blanking_level=0.30, sync_level=0.00,
    colour_mode=ColourMode.NTSC,
    burst_width=0.00000339, burst_rise=0.00000030, burst_left=0.00001050,
    burst_level=3.0 / 7.0,
    colour_carrier=Rational(5315625, 2),  # 2657812.5 Hz
    ev_co=0.877, eu_co=0.493,
    am_mono_carrier=-3500000.0, am_mono_bandwidth=10000.0,
    **_RASTER_405,
)

SYS_405_I = VidConfig(
    output_type=OutputType.COMPLEX,
    modulation=Modulation.VSB,
    vsb_upper_bw=5500000.0, vsb_lower_bw=1250000.0,
    level=1.0, video_level=0.80, fm_mono_level=0.19,
    white_level=0.20, black_level=0.76, blanking_level=0.76, sync_level=1.00,
    fm_mono_carrier=6000000 - 400, fm_mono_deviation=50000.0,
    fm_mono_preemph=Preemph.US50,
    **_RASTER_405,
)

SYS_405 = VidConfig(
    output_type=OutputType.REAL,
    level=1.0, video_level=1.0,
    video_bw=3.0e6,
    white_level=0.70, black_level=0.00, blanking_level=0.00, sync_level=-0.30,
    **_RASTER_405,
)

SYS_405_NTSC = VidConfig(
    output_type=OutputType.REAL,
    level=1.0, video_level=1.0,
    video_bw=3.0e6,
    white_level=0.70, black_level=0.05, blanking_level=0.00, sync_level=-0.30,
    colour_mode=ColourMode.NTSC,
    burst_width=0.00000339, burst_rise=0.00000030, burst_left=0.00001050,
    burst_level=3.0 / 7.0,
    colour_carrier=Rational(5315625, 2),
    colour_bw=1.1e6,
    ev_co=0.877, eu_co=0.493,
    **_RASTER_405,
)

# --- Baird 240/30, NBTV 32 (src/video.c:1561-1717) --------------------------
_BAIRD_240 = dict(
    type=RasterType.BAIRD_240,
    frame_rate=Rational(25, 1),
    frame_aspects=(Rational(4, 3),),
    lines=240,
    active_lines=220,
    active_width=0.00015,
    active_left=0.000016667,
    hsync_width=0.000013333,
    vsync_long_width=0.000166667,
)

BAIRD_240_AM = VidConfig(
    output_type=OutputType.COMPLEX,
    modulation=Modulation.AM,
    level=1.0, video_level=1.0,
    white_level=1.00, black_level=0.40, blanking_level=0.40, sync_level=0.00,
    **_BAIRD_240,
)

BAIRD_240 = VidConfig(
    output_type=OutputType.REAL,
    level=1.0, video_level=1.0,
    white_level=1.00, black_level=0.40, blanking_level=0.40, sync_level=0.00,
    **_BAIRD_240,
)

# VID_ROTATE_270 | VID_HFLIP = 3 | (1 << 2)
_ROT270_HFLIP = 3 | (1 << 2)

_BAIRD_30 = dict(
    type=RasterType.BAIRD_30,
    frame_rate=Rational(25, 2),
    frame_aspects=(Rational(3, 7),),
    frame_orientation=_ROT270_HFLIP,
    lines=30,
    active_lines=30,
    active_width=0.002666667,
    active_left=0.0,
)

BAIRD_30_AM = VidConfig(
    output_type=OutputType.COMPLEX,
    modulation=Modulation.AM,
    level=1.0, video_level=1.0,
    white_level=1.00, black_level=0.00, blanking_level=0.00, sync_level=0.00,
    **_BAIRD_30,
)

BAIRD_30 = VidConfig(
    output_type=OutputType.REAL,
    level=1.0, video_level=1.0,
    white_level=1.00, black_level=-1.00, blanking_level=-1.00, sync_level=-1.00,
    **_BAIRD_30,
)

_NBTV_32 = dict(
    type=RasterType.NBTV_32,
    frame_rate=Rational(25, 2),
    frame_aspects=(Rational(2, 3),),
    frame_orientation=_ROT270_HFLIP,
    lines=32,
    active_lines=32,
    active_width=2.5e-3 - 0.1e-3,
    active_left=0.1e-3,
    hsync_width=0.1e-3,
)

NBTV_32_AM = VidConfig(
    output_type=OutputType.COMPLEX,
    modulation=Modulation.AM,
    level=1.0, video_level=1.0,
    white_level=0.10, black_level=0.73, blanking_level=0.73, sync_level=1.00,
    **_NBTV_32,
)

NBTV_32 = VidConfig(
    output_type=OutputType.REAL,
    level=1.0, video_level=1.0,
    white_level=1.00, black_level=0.30, blanking_level=0.30, sync_level=0.00,
    **_NBTV_32,
)

# --- Apollo (src/video.c:1719-1878) -----------------------------------------
APOLLO_COLOUR_FM = VidConfig(
    output_type=OutputType.COMPLEX,
    level=1.000, video_level=1.000, fm_mono_level=0.150,
    modulation=Modulation.FM,
    fm_level=1.0, fm_deviation=2e6,
    white_level=0.5000, black_level=-0.1475,
    blanking_level=-0.2000, sync_level=-0.5000,
    colour_mode=ColourMode.APOLLO_FSC,
    fsc_flag_width=0.00002000,
    fsc_flag_left=0.00001470,
    fsc_flag_level=0.5000,
    fm_mono_carrier=1250000.0, fm_mono_deviation=25000.0,
    fm_mono_preemph=Preemph.NONE,
    **_RASTER_525, **_NTSC_RASTER,
)

APOLLO_COLOUR = VidConfig(
    output_type=OutputType.REAL,
    level=1.0, video_level=1.0,
    white_level=0.70, black_level=0.0525,
    blanking_level=0.00, sync_level=-0.30,
    colour_mode=ColourMode.APOLLO_FSC,
    fsc_flag_width=0.00002000,
    fsc_flag_left=0.00001470,
    fsc_flag_level=0.70,
    **_RASTER_525, **_NTSC_RASTER,
)

_APOLLO_320 = dict(
    type=RasterType.APOLLO_320,
    frame_rate=Rational(10, 1),
    frame_aspects=(Rational(4, 3),),
    lines=320,
    active_lines=312,
    active_width=0.00028250,
    active_left=0.00002500,
    hsync_width=0.00002000,
    vsync_long_width=0.00026750,
    # The camera's long pulse is wider than half a line; the reference
    # splits it across the long + short templates (src/video.c:1825-1827).
    vsync_short_width=1.0 / 10.0 / 320.0 / 2.0 - 45e-6,
)

APOLLO_MONO_FM = VidConfig(
    output_type=OutputType.COMPLEX,
    level=1.000, video_level=1.000, fm_mono_level=0.150,
    modulation=Modulation.FM,
    fm_level=1.0, fm_deviation=2e6,
    white_level=0.50, black_level=-0.20, blanking_level=-0.20, sync_level=-0.50,
    fm_mono_carrier=1250000.0, fm_mono_deviation=25000.0,
    fm_mono_preemph=Preemph.NONE,
    **_APOLLO_320,
)

APOLLO_MONO = VidConfig(
    output_type=OutputType.REAL,
    level=1.0, video_level=1.0,
    white_level=0.70, black_level=0.00, blanking_level=0.00, sync_level=-0.30,
    **_APOLLO_320,
)

# --- CBS 405-line field sequential colour (src/video.c:1880-1954) -----------
_CBS_405 = dict(
    type=RasterType.CBS_405,
    frame_rate=Rational(72, 1),
    frame_aspects=(Rational(4, 3),),
    lines=405,
    interlaced=1,
    active_lines=376,
    active_width=0.00002812,
    active_left=0.00000480,
    hsync_width=0.000002743,
    vsync_short_width=0.000001372,
    vsync_long_width=0.000014746,
)

CBS405_M = VidConfig(
    output_type=OutputType.COMPLEX,
    modulation=Modulation.VSB,
    vsb_upper_bw=4200000.0, vsb_lower_bw=750000.0,
    level=1.0, video_level=0.77, fm_mono_level=0.15,
    white_level=0.159, black_level=0.595, blanking_level=0.595, sync_level=1.000,
    colour_mode=ColourMode.CBS_FSC,
    fsc_flag_width=0.000001372,
    fsc_flag_left=0.000008573,
    fsc_flag_level=1.000,
    fm_mono_carrier=4500000.0, fm_mono_deviation=25000.0,
    fm_mono_preemph=Preemph.US75,
    **_CBS_405,
)

CBS405 = VidConfig(
    output_type=OutputType.REAL,
    level=1.0, video_level=1.0,
    white_level=0.70, black_level=0.00, blanking_level=0.00, sync_level=-0.30,
    colour_mode=ColourMode.CBS_FSC,
    fsc_flag_width=0.000001372,
    fsc_flag_left=0.000008573,
    fsc_flag_level=-0.30,
    **_CBS_405,
)


# ---------------------------------------------------------------------------
# Registry of mode id -> (config, description); ids match the reference CLI
# (src/video.c:1956-2008).
REGISTRY: dict[str, tuple[VidConfig, str]] = {
    "i":        (PAL_I, "PAL colour, 25 fps, 625 lines, AM (complex), 6.0 MHz FM audio"),
    "b":        (PAL_BG, "PAL colour, 25 fps, 625 lines, AM (complex), 5.5 MHz FM audio"),
    "g":        (PAL_BG, "PAL colour, 25 fps, 625 lines, AM (complex), 5.5 MHz FM audio"),
    "pal-d":    (PAL_DK, "PAL colour, 25 fps, 625 lines, AM (complex), 6.5 MHz FM audio"),
    "pal-k":    (PAL_DK, "PAL colour, 25 fps, 625 lines, AM (complex), 6.5 MHz FM audio"),
    "pal-fm":   (PAL_FM, "PAL colour, 25 fps, 625 lines, FM (complex), 6.5 MHz FM audio"),
    "pal":      (PAL, "PAL colour, 25 fps, 625 lines, unmodulated (real)"),
    "pal-m":    (PAL_M, "PAL colour, 30/1.001 fps, 525 lines, AM (complex), 4.5 MHz FM audio"),
    "pal-n":    (PAL_N, "PAL colour, 25 fps, 625 lines, AM (complex), 4.5 MHz FM audio"),
    "525pal":   (PAL_525, "PAL colour, 30/1.001 fps, 525 lines, unmodulated (real)"),
    "l":        (SECAM_L, "SECAM colour, 25 fps, 625 lines, AM (complex), 6.5 MHz AM audio"),
    "d":        (SECAM_DK, "SECAM colour, 25 fps, 625 lines, AM (complex), 6.5 MHz FM audio"),
    "k":        (SECAM_DK, "SECAM colour, 25 fps, 625 lines, AM (complex), 6.5 MHz FM audio"),
    "secam-i":  (SECAM_I, "SECAM colour, 25 fps, 625 lines, AM (complex), 6.0 MHz FM audio"),
    "secam-b":  (SECAM_BG, "SECAM colour, 25 fps, 625 lines, AM (complex), 5.5 MHz FM audio"),
    "secam-g":  (SECAM_BG, "SECAM colour, 25 fps, 625 lines, AM (complex), 5.5 MHz FM audio"),
    "secam-fm": (SECAM_FM, "SECAM colour, 25 fps, 625 lines, FM (complex), 6.5 MHz FM audio"),
    "secam":    (SECAM, "SECAM colour, 25 fps, 625 lines, unmodulated (real)"),
    "m":        (NTSC_M, "NTSC colour, 30/1.001 fps, 525 lines, AM (complex), 4.5 MHz FM audio"),
    "ntsc-i":   (NTSC_I, "NTSC colour, 30/1.001 fps, 525 lines, AM (complex), 6.0 MHz FM audio"),
    "ntsc-fm":  (NTSC_FM, "NTSC colour, 30/1.001 fps, 525 lines, FM (complex), 6.5 MHz FM audio"),
    "ntsc-bs":  (NTSC_BS_FM, "NTSC colour, 30/1.001 fps, 525 lines, FM (complex), BS digital audio"),
    "ntsc":     (NTSC, "NTSC colour, 30/1.001 fps, 525 lines, unmodulated (real)"),
    "pal60-i":  (PAL60_I, "PAL colour, 30/1.001 fps, 525 lines, AM (complex), 6.0 MHz FM audio"),
    "pal60":    (PAL60, "PAL colour, 30/1.001 fps, 525 lines, unmodulated (real)"),
    "d2mac-am": (D2MAC_AM, "D2-MAC, 25 fps, 625 lines, AM (complex)"),
    "d2mac-fm": (D2MAC_FM, "D2-MAC, 25 fps, 625 lines, FM (complex)"),
    "d2mac":    (D2MAC, "D2-MAC, 25 fps, 625 lines, unmodulated (real)"),
    "dmac-am":  (DMAC_AM, "D-MAC, 25 fps, 625 lines, AM (complex)"),
    "dmac-fm":  (DMAC_FM, "D-MAC, 25 fps, 625 lines, FM (complex)"),
    "dmac":     (DMAC, "D-MAC, 25 fps, 625 lines, unmodulated (real)"),
    "e":        (SYS_819_E, "No colour, 25 fps, 819 lines, AM (complex), 11.15 MHz AM audio"),
    "819":      (SYS_819, "No colour, 25 fps, 819 lines, unmodulated (real)"),
    "a":        (SYS_405_A, "No colour, 25 fps, 405 lines, AM (complex), -3.5 MHz AM audio"),
    "ntsc-a":   (SYS_405_A_NTSC, "NTSC colour, 25 fps, 405 lines, AM (complex), -3.5 MHz AM audio"),
    "405-i":    (SYS_405_I, "No colour, 25 fps, 405 lines, AM (complex), 6.0 MHz FM audio"),
    "405":      (SYS_405, "No colour, 25 fps, 405 lines, unmodulated (real)"),
    "ntsc-405": (SYS_405_NTSC, "NTSC colour, 25 fps, 405 lines, unmodulated (real)"),
    "240-am":   (BAIRD_240_AM, "No colour, 25 fps, 240 lines, AM (complex)"),
    "240":      (BAIRD_240, "No colour, 25 fps, 240 lines, unmodulated (real)"),
    "30-am":    (BAIRD_30_AM, "No colour, 12.5 fps, 30 lines, AM (complex)"),
    "30":       (BAIRD_30, "No colour, 12.5 fps, 30 lines, unmodulated (real)"),
    "nbtv-am":  (NBTV_32_AM, "No colour, 12.5 fps, 32 lines, AM (complex)"),
    "nbtv":     (NBTV_32, "No colour, 12.5 fps, 32 lines, unmodulated (real)"),
    "apollo-fsc-fm": (APOLLO_COLOUR_FM, "Field sequential colour, 30/1.001 fps, 525 lines, FM (complex), 1.25 MHz FM audio"),
    "apollo-fsc":    (APOLLO_COLOUR, "Field sequential colour, 30/1.001 fps, 525 lines, unmodulated (real)"),
    "apollo-fm":     (APOLLO_MONO_FM, "No colour, 10 fps, 320 lines, FM (complex), 1.25 MHz FM audio"),
    "apollo":        (APOLLO_MONO, "No colour, 10 fps, 320 lines, unmodulated (real)"),
    "m-cbs405":      (CBS405_M, "Field sequential colour, 72 fps, 405 lines, VSB (complex), 4.5MHz FM audio"),
    "cbs405":        (CBS405, "Field sequential colour, 72 fps, 405 lines, unmodulated (real)"),
}


def get_mode(mode_id: str) -> VidConfig:
    try:
        return REGISTRY[mode_id][0]
    except KeyError:
        raise KeyError(f"unknown TV mode {mode_id!r}; "
                       f"known: {', '.join(sorted(REGISTRY))}") from None


def list_modes() -> list[tuple[str, str]]:
    return [(k, v[1]) for k, v in REGISTRY.items()]
