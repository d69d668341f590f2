"""Constellation map and minimum-distance slicer (counterpart of the LUT pair
in :mod:`modem_tpu.ops.slicer`).

The JAX package maps with a one-hot matmul because gathers serialize on its
TPU; here the map is a plain index into the table. The slicer keeps the
first of equal minima, as the fused kernels do.
"""

from __future__ import annotations

import torch


def as_lut(lut, device) -> torch.Tensor:
    """``[M, 2]`` float32 constellation table on ``device``."""
    lut = torch.as_tensor(lut, dtype=torch.float32, device=device)
    if lut.ndim != 2 or lut.shape[1] != 2:
        raise ValueError("lut must be [M, 2]")
    return lut


def lut_map(symbols: torch.Tensor, lut) -> tuple[torch.Tensor, torch.Tensor]:
    """``[..., K]`` int symbols -> per-symbol ``(i, q)`` float32."""
    iq = as_lut(lut, symbols.device)[symbols.long()]
    return iq[..., 0], iq[..., 1]


def lut_slice(i: torch.Tensor, q: torch.Tensor, lut) -> torch.Tensor:
    """Nearest constellation point: ``[..., K]`` I/Q -> ``[..., K]`` int32
    symbols; of equal distances the lowest index wins."""
    lut = as_lut(lut, i.device)
    dist = (i[..., None] - lut[:, 0]) ** 2 + (q[..., None] - lut[:, 1]) ** 2
    return torch.argmin(dist, dim=-1).to(torch.int32)
