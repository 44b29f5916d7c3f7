"""The free-access Videocrypt I reference (encoder.py) for a configuration
of the benchmark, under the contract of every reference module under
reference/ (reference/codec/make.py states it):

    make(config, mix, seed, device, fir_dtype=None)

It runs the configuration's `mode` (a 625-line PAL mode with FM mono
sound: `i`), `sample_rate` and `vfilter`, and the switches
`--videocrypt free` and nothing else: any other list is refused by name.

Cost: the PRBS is clocked one bit at a time in plain Python, 574 lines of
16 clocks a frame, for the block's frames, the frame before them and the
frame of the halo line after them: 0.017 s a frame on the H100 machine's
host, so about 0.3 s of a 16-frame block's reference, all on the host.
"""

from __future__ import annotations

from harness.sources import make_source

from reference.codec.av.testcard import test_card_rgb
from reference.codec.config.standards import get_mode
from reference.codec.video.params import VideoParams

from .encoder import Encoder

SWITCHES = ["--videocrypt", "free"]


def make(config: dict, mix: dict, seed: int, device, fir_dtype=None):
    if config.get("switches") != SWITCHES:
        raise NotImplementedError(
            "the Videocrypt reference runs `--videocrypt free` and no "
            "other switch: " + " ".join(config.get("switches") or []))
    p = VideoParams.create(get_mode(config["mode"]), config["sample_rate"],
                           0)
    src = make_source(mix, seed, p.active_width, p.conf.active_lines,
                      test_card_rgb)
    return Encoder(config["mode"], config["sample_rate"], src,
                   frames_per_block=mix["frames_per_block"],
                   vfilter=config["vfilter"], device=device,
                   fir_dtype=fir_dtype)
