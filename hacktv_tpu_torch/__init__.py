"""hacktv_tpu_torch — the PyTorch/CUDA port of hacktv_tpu.

The same analogue television signal synthesis as the JAX package, written
as torch tensor code with hand-written CUDA kernels for NVIDIA Hopper
(`csrc/`).  Entry points run on the card (`device="cuda"`) unless the
caller asks for the CPU (`device="cpu"`), where each kernel's plain
PyTorch version runs instead.  The package imports neither jax nor
hacktv_tpu.
"""

from .config import REGISTRY, VidConfig, get_mode, list_modes  # noqa: F401
from .encoder import Encoder  # noqa: F401
from .rational import Rational  # noqa: F401


def create_encoder(mode, sample_rate, **kwargs):
    """Factory returning the right encoder class for a mode: `MacEncoder`
    for D/D2-MAC (packet-multiplex raster), `Encoder` otherwise.  Both
    take `device` (the CUDA card by default, or "cpu"), and `devices`, a
    list of devices to shard each block's lines over (shard.py)."""
    conf = get_mode(mode) if isinstance(mode, str) else mode
    if conf.mac_mode is not None:
        from .video.mac import MacEncoder
        mac_kw = {k: v for k, v in kwargs.items()
                  if k in ("pixel_rate", "source", "frames_per_block",
                           "scramble_video", "scramble_audio", "eurocrypt",
                           "timestamp", "device")}
        return MacEncoder(conf, sample_rate, **mac_kw)
    return Encoder(conf, sample_rate, **kwargs)


__version__ = "0.1.0"
