"""Modular prefix sums (counterpart of :mod:`modem_tpu.utils.scan`).

Every stateful per-symbol ``update()`` of the reference is a phase
accumulation (`dmpsk.rs:29-33`, `mfsk.rs:68-75`, `bfsk.rs:43-55`):
``phase[k] = (phase0 + sum_{j<=k} delta[j]) mod M``, here a prefix sum along
the last axis.

* Integer input: one int64 ``cumsum`` then ``%`` is exact for any block
  this package handles (the JAX version reduces chunk-wise only to keep
  int32 partial sums from overflowing on the TPU). The result keeps the
  input's dtype.
* Float input (DMPSK turns): reduced in 256-sample chunks, as the JAX
  version does, so running sums stay small and the phases agree with it to
  f32 tolerance.
"""

from __future__ import annotations

import torch

_CHUNK = 256


def cummod(x: torch.Tensor, m) -> torch.Tensor:
    """Inclusive prefix sum of ``x`` modulo ``m`` along the last axis, in
    ``[0, m)``; inputs are reduced mod ``m`` first, so deltas of any
    magnitude are fine."""
    x = x % m
    if not x.is_floating_point():
        return (torch.cumsum(x, dim=-1, dtype=torch.int64) % m).to(x.dtype)
    n = x.shape[-1]
    if n <= _CHUNK:
        return torch.cumsum(x, dim=-1) % m
    pad = (-n) % _CHUNK
    xp = torch.nn.functional.pad(x, (0, pad)) if pad else x
    chunks = xp.reshape(x.shape[:-1] + ((n + pad) // _CHUNK, _CHUNK))
    inner = torch.cumsum(chunks, dim=-1) % m  # [..., n_chunks, CHUNK]
    # exclusive prefix over the chunk totals, itself reduced recursively
    carry = cummod(inner[..., -1], m)
    carry = torch.cat([torch.zeros_like(carry[..., :1]), carry[..., :-1]],
                      dim=-1)
    out = (inner + carry[..., None]) % m
    return out.reshape(x.shape[:-1] + (n + pad,))[..., :n]
