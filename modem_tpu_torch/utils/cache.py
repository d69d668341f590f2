"""Host-built tables as device tensors, built once per owner and device."""

from __future__ import annotations

import numpy as np
import torch


def on_device(owner, key, make, dtype: torch.dtype, device) -> torch.Tensor:
    """``make()`` (a numpy array) as a ``dtype`` tensor on ``device``, built
    at the first call for this ``owner``, ``key`` and device and kept in
    ``owner.__dict__``."""
    store = owner.__dict__.setdefault("_on_device", {})
    k = (key, dtype, torch.device(device))
    t = store.get(k)
    if t is None:
        t = store[k] = torch.as_tensor(np.asarray(make()), dtype=dtype,
                                       device=device)
    return t
