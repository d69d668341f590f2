"""Block (row/column) interleaving (counterpart of
:mod:`modem_tpu.fec.interleave`): a burst of adjacent corrupted code bits
becomes many short error events the convolutional decoder absorbs. Pure
reshapes and transposes."""

from __future__ import annotations

import torch


def block_interleave(bits: torch.Tensor, rows: int) -> torch.Tensor:
    """``[..., L]`` -> ``[..., L]``, written row-wise / read column-wise.
    ``L`` must divide by ``rows``."""
    l = bits.shape[-1]
    if l % rows:
        raise ValueError(f"block length {l} must divide by rows={rows}")
    x = bits.reshape(bits.shape[:-1] + (rows, l // rows))
    return x.transpose(-1, -2).reshape(bits.shape)


def block_deinterleave(bits: torch.Tensor, rows: int) -> torch.Tensor:
    """Inverse of :func:`block_interleave` (same ``rows``)."""
    l = bits.shape[-1]
    if l % rows:
        raise ValueError(f"block length {l} must divide by rows={rows}")
    x = bits.reshape(bits.shape[:-1] + (l // rows, rows))
    return x.transpose(-1, -2).reshape(bits.shape)
