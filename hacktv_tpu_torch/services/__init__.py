"""VBI data services (port of hacktv_tpu/services): WSS, VITS, VITC,
CEA-608 captions, ACP, teletext and sound-in-syncs.  Each service builds
its per-block arrays on the host (`block_arrays`, numpy) and adds its
lines to the block on the device (`apply`, torch)."""

from __future__ import annotations

import numpy as np
import torch


def arrays_to_device(arrays: dict, device) -> dict:
    """A service's host block arrays for its `apply`: numpy arrays as
    tensors on `device`, numpy scalars as Python numbers."""
    out = {}
    for k, v in arrays.items():
        if isinstance(v, np.ndarray):
            out[k] = torch.as_tensor(np.ascontiguousarray(v), device=device)
        elif isinstance(v, np.generic):
            out[k] = v.item()
        else:
            out[k] = v
    return out
