"""VBI data services (port of hacktv_tpu/services): WSS, VITS, VITC,
CEA-608 captions, ACP, teletext and sound-in-syncs.  Each service builds
its per-block arrays on the host (`block_arrays`, numpy) and adds its
lines to the block on the device (`apply`, torch)."""

from __future__ import annotations

import torch


def window_arrays(svc, arrays: dict, r0: int, r1: int) -> dict:
    """A service's block arrays (on the device) for the block rows
    [r0, r1), one shard's window: every per-row array sliced, the
    per-block values (the service's `block_keys`) kept; a service whose
    rows are not independent windows them itself (`window_arrays`)."""
    own = getattr(svc, "window_arrays", None)
    if own is not None:
        return own(arrays, r0, r1)
    keep = getattr(svc, "block_keys", ())
    return {k: v if k in keep or not isinstance(v, torch.Tensor)
            else v[r0:r1] for k, v in arrays.items()}
