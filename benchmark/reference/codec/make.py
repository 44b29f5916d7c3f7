"""The codec reference (encoder.py) for a configuration of the benchmark,
under the contract of every reference module under reference/:

    make(config, mix, seed, device, fir_dtype=None)

returns an encoder with `encode_block(b, start) -> (samples, end
states)` and `initial_states()` (what harness/check.py's `compare`
reads), made from the configuration's file as it stands and the traffic
mix's source for `seed`; `fir_dtype` computes the stream FIR in a lower
precision (the control).  `start` holds, by name, every serial host
state that the check follows for the configuration (run.py's `follows`:
those its file names under `check.follows`, or else the encoder's FM
carriers), each as (state, n) read from the program at block b's start;
the end states and `initial_states()` give the same names.  This one runs the configuration's `mode`,
`sample_rate` and `vfilter`, and no CLI switch: a configuration with
`switches` needs a reference of its own.
"""

from __future__ import annotations

from harness.sources import make_source

from .av.testcard import test_card_rgb
from .config.standards import get_mode
from .encoder import Encoder
from .video.params import VideoParams


def make(config: dict, mix: dict, seed: int, device, fir_dtype=None):
    if config.get("switches"):
        raise NotImplementedError("the codec reference runs no switches: "
                                  + " ".join(config["switches"]))
    p = VideoParams.create(get_mode(config["mode"]), config["sample_rate"],
                           0)
    src = make_source(mix, seed, p.active_width, p.conf.active_lines,
                      test_card_rgb)
    return Encoder(config["mode"], config["sample_rate"], source=src,
                   frames_per_block=mix["frames_per_block"],
                   vfilter=config["vfilter"], device=device,
                   fir_dtype=fir_dtype)
