"""Carry an encoder's statics across, as numpy arrays under the JAX
package's field names.

The statics play the role that weights play in a model: the raster
constants (`RasterStatics`: sync templates, chroma taps, burst, colour
carrier rows or tables), the video filter taps (`VideoParams.vfilter_ctaps`
or `vfilter_taps`), the FM carrier's column tables (`FMStatics.cos_x`,
`sin_x`), the FM hold lengths (`FMWin.lens_tiled`), the NICAM pulse
matrices and carrier LUTs (`NicamStatics.pulse`, `lut_i`, `lut_q`) and the
NICAM frame encoder's tables (`NicamDevStatics.perm`, `prn`, `taps`) go
under their field names.  The statics added with SECAM, AM and A2 go
under "<Encoder attribute>.<field>", the attribute that holds them on the
JAX Encoder, since several share a field name: `secam_statics.` +
`luma_taps`, `chroma_taps`, `bell_i`, `bell_q`, `w0_tab`, `_win_q` and the
device program's constants `r_pow`, `w0_col`, `win_col`, `fid` (the JAX
package's `_device_consts`); `am_statics.cos_x`, `sin_x`;
`fm_right_statics.cos_x`, `sin_x`, `fm_right_win.lens_tiled`; and
`a2_statics.cos1_x`, `sin1_x`, `cos2_x`, `sin2_x`.  The RF tail's statics
follow the same rule: `offset_statics.` + `cos_x`, `sin_x`, `intro_bi`,
`intro_bq`; the energy-dispersal frame `_fm_ed_frame`; the phasor LUTs of
the host-exact FM carriers `fm_exact._lut` (sound) and
`fm_video_exact._lut` (video); and the host-exact SECAM carrier's LUT
`_secam_lut`.  The video resampler's polyphase bank and class windows go
under `resampler.` + `rs.T`, `Td`, `offq`, `offr`; the field-sequential
flag templates under `fsc_tpl`.  `carrier_rows`, a (cos, sin) pair of
[P, W] tables, travels stacked as one [2, P, W] array.  Each VBI
service's arrays go under "services.<class>.<attribute>", the names of
the JAX package's service objects: `WSS.basis`, `bits` (its waveform row,
`bits @ basis`, is rebuilt from them each block, as there); `VITS.r_tpl`,
`c_tpl`, `cs`; `VITC.basis`; `CC608.basis`, `cri`; `ACP.psync_mask`,
`pagc_mask`; `Teletext.basis`; `SiS.basis`, `blank_win`,
`warmup_spill`; the scramblers' `Videocrypt.basis`; `VideocryptS.basis`,
`seq` (the shuffle table); `Syster.basis`, with cut-and-rotate also
`cols` and `seq`; `SysterCNR.basis`, `cols`, `seq`; `D11.basis`,
`table`.  DANCE's pulse matrices and carrier LUTs go under
`dance_statics.` + `pulse`, `lut_i`, `lut_q` (its two-part split of the
pulse is made again from `pulse` when installed).  A D/D2-MAC encoder
(video/mac.py's MacEncoder) carries the duobinary bases under `mac.` +
`Bm`, `B0`, `Bp` (f32 [nbits, W], integer-valued; f64 on the device)
and, where it assembles the line bits on the device, the base bit rows
`mac.base_bits` (int8 [2 * 625, nbits]): the JAX MacEncoder's `Bm`,
`B0`, `Bp` and `_base_bits`.

    arrays = statics_to_numpy(enc)          # {name: np.ndarray}
    statics_from_numpy(other_enc, arrays)   # installs them on its device
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

RASTER_FIELDS = ("sync_main", "sync_tail", "sync_head", "chroma_taps",
                 "burst_u", "burst_v", "carrier_rows", "carrier_cos",
                 "carrier_sin", "fsc_tpl")
NICAM_FIELDS = ("pulse", "lut_i", "lut_q")
NICAM_DEV_FIELDS = ("perm", "prn", "taps")
SECAM_FIELDS = ("luma_taps", "chroma_taps", "bell_i", "bell_q", "w0_tab",
                "_win_q")
SECAM_CONST_FIELDS = ("r_pow", "w0_col", "win_col", "fid")
A2_FIELDS = ("cos1_x", "sin1_x", "cos2_x", "sin2_x")
OFFSET_FIELDS = ("cos_x", "sin_x", "intro_bi", "intro_bq")
FM_EXACT_ATTRS = ("fm_exact", "fm_video_exact")
RESAMPLER_FIELDS = ("Td", "offq", "offr")
MAC_BASES = ("Bm", "B0", "Bp")


def _is_mac(enc) -> bool:
    """A MacEncoder (its statics are the bases, not the raster's)."""
    from .video.mac import MacEncoder
    return isinstance(enc, MacEncoder)


def statics_to_numpy(enc) -> dict:
    """The encoder's device statics as host arrays."""
    if _is_mac(enc):
        out = {"mac." + f: getattr(enc, f) for f in MAC_BASES}
        if enc._base_bits is not None:
            out["mac.base_bits"] = enc._base_bits
        return out
    host = lambda t: t.detach().cpu().numpy()
    out = {}
    for f in RASTER_FIELDS:
        v = getattr(enc.dstatics, f)
        if v is not None:
            out[f] = (np.stack([host(a) for a in v]) if isinstance(v, tuple)
                      else host(v))
    if enc.vf_taps is not None:
        taps_r, taps_i = enc.vf_taps
        if taps_i is not None:
            out["vfilter_ctaps"] = (host(taps_r)
                                    + 1j * host(taps_i)).astype(np.complex64)
        else:
            out["vfilter_taps"] = host(taps_r)
    if enc.fm_statics is not None:
        out["cos_x"] = host(enc.fm_statics.cos_x)
        out["sin_x"] = host(enc.fm_statics.sin_x)
        if enc.fm_win is not None:
            out["lens_tiled"] = host(enc.fm_win.lens_tiled)
    if enc.nicam_statics is not None:
        for f in NICAM_FIELDS:
            out[f] = host(getattr(enc.nicam_statics, f))
        for f in NICAM_DEV_FIELDS:
            out[f] = host(getattr(enc.nicam_dev_statics, f))
    if enc.secam is not None:
        for f in SECAM_FIELDS:
            out["secam_statics." + f] = np.asarray(getattr(enc.secam.st, f))
        for f in SECAM_CONST_FIELDS:
            out["secam_statics." + f] = host(getattr(enc.secam, f))
    if enc.am_statics is not None:
        out["am_statics.cos_x"] = host(enc.am_statics.cos_x)
        out["am_statics.sin_x"] = host(enc.am_statics.sin_x)
    if enc.fm_right_statics is not None:
        out["fm_right_statics.cos_x"] = host(enc.fm_right_statics.cos_x)
        out["fm_right_statics.sin_x"] = host(enc.fm_right_statics.sin_x)
        if enc.fm_right_win is not None:
            out["fm_right_win.lens_tiled"] = host(
                enc.fm_right_win.lens_tiled)
        for f in A2_FIELDS:
            out["a2_statics." + f] = host(getattr(enc.a2_statics, f))
    if enc.offset_statics is not None:
        for f in OFFSET_FIELDS:
            out["offset_statics." + f] = host(getattr(enc.offset_statics, f))
    if enc._fm_ed_frame is not None:
        out["_fm_ed_frame"] = enc._fm_ed_frame
    for name in FM_EXACT_ATTRS:
        if getattr(enc, name) is not None:
            out[name + "._lut"] = getattr(enc, name)._lut
    if enc.secam is not None and not enc.secam_device:
        out["_secam_lut"] = enc._secam_lut
    if enc.resampler is not None:
        out["resampler.rs.T"] = enc.resampler.rs.T
        for f in RESAMPLER_FIELDS:
            out["resampler." + f] = getattr(enc.resampler, f)
    for svc in enc.services:
        for f in svc.STATICS:
            out[service_key(svc, f)] = np.asarray(getattr(svc, f))
    if enc.dance_statics is not None:
        for f in NICAM_FIELDS:
            out["dance_statics." + f] = host(getattr(enc.dance_statics, f))
    return out


def service_key(svc, field: str) -> str:
    """The name a service's array travels under."""
    return f"services.{type(svc).__name__}.{field}"


def statics_from_numpy(enc, arrays: dict) -> None:
    """Install `arrays` (as statics_to_numpy gives them) as tensors on the
    encoder's device.  Every static the encoder holds must be present."""
    have = set(statics_to_numpy(enc))
    if set(arrays) != have:
        raise ValueError(f"statics mismatch: expected {sorted(have)}, "
                         f"got {sorted(arrays)}")
    if _is_mac(enc):
        for f in MAC_BASES:
            setattr(enc, f, np.asarray(arrays["mac." + f], np.float32))
        if "mac.base_bits" in arrays:
            enc._base_bits = np.asarray(arrays["mac.base_bits"], np.int8)
        enc.upload()
        return
    dev = enc.device
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)
    upd = {}
    for f in RASTER_FIELDS:
        if f in arrays:
            a = arrays[f]
            upd[f] = (t(a[0]), t(a[1])) if f == "carrier_rows" else t(a)
    enc.dstatics = dataclasses.replace(enc.dstatics, **upd)
    # the stream FIR's taps stay on the host (see Encoder.__init__)
    h = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32))
    if "vfilter_ctaps" in arrays:
        c = np.asarray(arrays["vfilter_ctaps"], np.complex64)
        enc.vf_taps = (h(c.real), h(c.imag))
    elif "vfilter_taps" in arrays:
        enc.vf_taps = (h(arrays["vfilter_taps"]), None)
    if "cos_x" in arrays:
        enc.fm_statics.cos_x = t(arrays["cos_x"])
        enc.fm_statics.sin_x = t(arrays["sin_x"])
    if "lens_tiled" in arrays:
        enc.fm_win.lens_tiled = t(arrays["lens_tiled"])
    if enc.secam is not None:
        from .video import secam as secam_mod
        st = dataclasses.replace(enc.secam.st, **{
            f: np.asarray(arrays["secam_statics." + f])
            for f in SECAM_FIELDS})
        enc.secam = secam_mod.to_device(st, dev, consts={
            f: arrays["secam_statics." + f] for f in SECAM_CONST_FIELDS},
            large=enc.secam.large)
    for name in ("am_statics", "fm_right_statics"):
        if name + ".cos_x" in arrays:
            fs = getattr(enc, name)
            fs.cos_x = t(arrays[name + ".cos_x"])
            fs.sin_x = t(arrays[name + ".sin_x"])
    if "fm_right_win.lens_tiled" in arrays:
        enc.fm_right_win.lens_tiled = t(arrays["fm_right_win.lens_tiled"])
    if enc.fm_right_statics is not None:
        enc.a2_statics = dataclasses.replace(
            enc.a2_statics,
            **{f: t(arrays["a2_statics." + f]) for f in A2_FIELDS})
    if enc.offset_statics is not None:
        enc.offset_statics = dataclasses.replace(
            enc.offset_statics,
            **{f: t(arrays["offset_statics." + f]) for f in OFFSET_FIELDS})
    if "_fm_ed_frame" in arrays:
        enc._fm_ed_frame = np.asarray(arrays["_fm_ed_frame"], np.int16)
        if enc.fm_video_statics is not None:
            enc._fm_ed_dev = t(enc._fm_ed_frame.astype(np.int32))
    for name in FM_EXACT_ATTRS:
        if name + "._lut" in arrays:
            getattr(enc, name)._lut = np.ascontiguousarray(
                arrays[name + "._lut"], np.int32)
    if "_secam_lut" in arrays:
        enc._secam_lut = np.ascontiguousarray(arrays["_secam_lut"], np.int32)
    if enc.resampler is not None:
        # a new statics object: its tensors are made again on first use
        st = enc.resampler
        enc.resampler = dataclasses.replace(
            st, rs=dataclasses.replace(
                st.rs, T=np.asarray(arrays["resampler.rs.T"], np.int64)),
            Td=np.asarray(arrays["resampler.Td"], np.int32),
            offq=np.asarray(arrays["resampler.offq"], np.int64),
            offr=np.asarray(arrays["resampler.offr"], np.int64))
    for svc in enc.services:
        for f in svc.STATICS:
            a = np.asarray(arrays[service_key(svc, f)])
            if isinstance(getattr(svc, f), tuple):
                setattr(svc, f, tuple(int(x) for x in a))
            else:
                setattr(svc, f, np.array(a, dtype=getattr(svc, f).dtype))
        svc.upload()
    if enc.dance_statics is not None:
        from .audio.synth import EXACT_TAP, split_pulse
        pulse = np.asarray(arrays["dance_statics.pulse"], np.float32)
        split = (split_pulse(pulse) if np.abs(pulse).max() >= EXACT_TAP
                 else (None, None))
        enc.dance_statics = dataclasses.replace(
            enc.dance_statics,
            **{f: t(arrays["dance_statics." + f]) for f in NICAM_FIELDS},
            pulse_hi=None if split[0] is None else t(split[0]),
            pulse_lo=None if split[1] is None else t(split[1]))
    if "pulse" in arrays:
        enc.nicam_statics = dataclasses.replace(
            enc.nicam_statics, **{f: t(arrays[f]) for f in NICAM_FIELDS})
        enc.nicam_dev_statics = dataclasses.replace(
            enc.nicam_dev_statics,
            **{f: t(arrays[f]) for f in NICAM_DEV_FIELDS})
