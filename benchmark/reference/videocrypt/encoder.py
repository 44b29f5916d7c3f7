"""The plain reference encoder of PAL-I with free-access Videocrypt I:
hacktv's `-m i --filter --videocrypt free`, written in plain PyTorch on
any device.

    raster (reference/codec/video/raster.py) -> Videocrypt I
    (videocrypt.py) -> stream FIR (reference/codec/ops/stream_fir.py) ->
    FM mono sound -> NICAM (reference/codec/audio) -> int16 wrap

That is upstream's line-process order: the scrambler runs between the
raster and the video filter, and holds two lines of the output ring (the
line and the next, which it reads).  Each block is computed on its own:
the raster runs one line past the FIR's halo, so that the halo line is
scrambled from its own next line, and the scrambler's state follows from
the block's frame numbers (videocrypt.py).  The sound is reference/
codec's, unchanged.
"""

from __future__ import annotations

import torch

from reference.codec.audio import synth as audio_synth
from reference.codec.config.standards import ColourMode, Modulation
from reference.codec.encoder import Encoder as CodecEncoder
from reference.codec.ops.stream_fir import stream_fir
from reference.codec.video import raster

from .videocrypt import FreeAccessVideocrypt


class Encoder(CodecEncoder):
    def __init__(self, mode: str, sample_rate: int, source,
                 frames_per_block: int = 1, vfilter: bool = True,
                 device="cuda", fir_dtype=None):
        """`fir_dtype` computes the stream FIR in a lower precision than
        float32 (the benchmark's control).  TF32 is turned off: the
        configuration computes in float32."""
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        super().__init__(mode, sample_rate, source=source,
                         frames_per_block=frames_per_block, vfilter=vfilter,
                         device=device, fir_dtype=fir_dtype)
        conf = self.conf
        if (conf.colour_mode != ColourMode.PAL or conf.lines != 625
                or conf.modulation == Modulation.FM
                or self.fm_statics is None or not self.complex_out
                or (self.vf_taps is not None and self.vf_taps[1] is None)):
            raise NotImplementedError(f"the Videocrypt reference does not "
                                      f"run {mode}")
        self.videocrypt = FreeAccessVideocrypt(self.params)
        # the upstream output ring (src/video.c:3578, 4641-4688): raster,
        # Videocrypt (two lines, in the caller's thread), [video filter],
        # audio, output
        procs = [(3, False), (2, False)]
        if self.vf_taps is not None:
            procs.append((2, True))
        procs += [(1, True), (1, False)]
        olines, prev_thread = 0, True
        for i, (nl, th) in enumerate(procs):
            olines += nl - (0 if (i == 0 or th or prev_thread) else 1)
            prev_thread = th
        self._spill_warmup = olines - 1

    def _raster(self, block_no: int, k_first: int, nrows: int):
        """The raster's rows for stream lines k_first .. k_first + nrows
        - 1, float32 [nrows, W]."""
        p = self.params
        rgb = self.source.read_video(block_no * self.frames_per_block)
        yuv = tuple(torch.as_tensor(x, device=self.device)
                    for x in raster.rgb_to_yuv_host(p, rgb))
        # _block_meta(k0, n) reads n + 2 lines from k0 - 1
        m = self._block_meta(k_first + 1, nrows - 2)
        return raster.synth_block(
            self.dstatics, yuv, m["base"], m["nxt"], m["burst"],
            m["vswitch"], m["vy"], m["al"], m["ar"], m["cos0"], m["sin0"],
            m["lut_row"], m["prv"] if self._use_prv else None, m["fsc"],
            m["fscf"], split_chroma=False, stacked_h=0)

    @torch.no_grad()
    def encode_block(self, block_no: int, states: dict | None = None):
        """Block `block_no`'s int16 samples [n, 2] (I, Q), and no state
        (nothing is carried)."""
        p = self.params
        W = p.width
        nlines = self.frames_per_block * p.lines
        n = nlines * W
        k0 = block_no * nlines
        a_k0 = k0 + (1 if self.conf.vfilter else 0)

        # the halo line before the block, its lines, the FIR's halo line
        # after it, and that line's next line, which the scrambler reads
        rows = self._raster(block_no, k0 - 1, nlines + 3)
        block = self.videocrypt.process(rows, k0 - 1)
        if block_no == 0:
            block[0] *= 0.0          # zero filter history at the start
        x = block.reshape(-1)
        if self.vf_taps is not None:
            taps_r, taps_i = self.vf_taps
            half = taps_r.shape[0] // 2
            xs = x[W - half: W - half + n + taps_r.shape[0] - 1]
            y, yq = stream_fir(xs, taps_r, taps_i, n, dtype=self.fir_dtype)
            y, yq = y.view(nlines, W), yq.view(nlines, W)
        else:
            y = x[W: W + n].view(nlines, W)
            yq = torch.zeros_like(y)
        out_i, out_q = self._sound(y, yq, a_k0, nlines)
        # int16 wrap, as every upstream mix into the line buffer
        wrap = lambda v: ((v + 0x8000) & 0xFFFF) - 0x8000
        ii = wrap(torch.round(out_i).to(torch.int32))
        qq = wrap(torch.round(out_q).to(torch.int32))
        out = torch.stack([ii, qq], dim=-1).to(torch.int16).cpu().numpy()
        return out.reshape(-1, 2), dict(states or {})

    def _sound(self, out_i, out_q, a_k0: int, nlines: int):
        """FM mono, then NICAM where the mode has it."""
        out_i, out_q = audio_synth.fm_add(
            self.fm_statics, out_i, out_q, *self._fm_mono(a_k0, nlines),
            a2=False)
        if self.nicam_statics is not None:
            si, sq, nc = self._nicam(a_k0, nlines)
            out_i, out_q = audio_synth.nicam_add(
                self.nicam_statics, out_i, out_q, si, sq, nc["offq"],
                nc["offr"], torch.as_tensor(nc["cc_off"], device=self.device),
                a_k0 % self.nicam_statics.period, line0=0,
                block_lines=nlines)
        return out_i, out_q
