"""The SECAM-L reference (encoder.py) for a configuration of the
benchmark, under the contract of every reference module under
reference/ (reference/codec/make.py states it):

    make(config, mix, seed, device, fir_dtype=None)

It runs the configuration's `mode` (SECAM colour with AM sound: `l`),
`sample_rate` and `vfilter`, and no CLI switch: a configuration with
`switches` (`--secam-field-id` among them) is refused by name.
"""

from __future__ import annotations

from harness.sources import make_source

from reference.codec.av.testcard import test_card_rgb
from reference.codec.config.standards import get_mode
from reference.codec.video.params import VideoParams

from .encoder import Encoder


def make(config: dict, mix: dict, seed: int, device, fir_dtype=None):
    if config.get("switches"):
        raise NotImplementedError("the SECAM-L reference runs no switches: "
                                  + " ".join(config["switches"]))
    p = VideoParams.create(get_mode(config["mode"]), config["sample_rate"],
                           0)
    src = make_source(mix, seed, p.active_width, p.conf.active_lines,
                      test_card_rgb)
    return Encoder(config["mode"], config["sample_rate"], src,
                   frames_per_block=mix["frames_per_block"],
                   vfilter=config["vfilter"], device=device,
                   fir_dtype=fir_dtype)
