"""Per-bit max-log LLRs over a constellation (counterpart of
:func:`modem_tpu.ops.llr.lut_llr` and :func:`~modem_tpu.ops.llr.llr_hard_bits`).

    LLR_j = (min_{c: bit_j(c)=1} |y-c|^2 - min_{c: bit_j(c)=0} |y-c|^2) / (2*sigma^2)

Positive LLR = bit 0 more likely.
"""

from __future__ import annotations

import torch

from .slicer import as_lut


def lut_llr(i: torch.Tensor, q: torch.Tensor, lut, bits_per_symbol: int,
            noise_var: float = 1.0) -> torch.Tensor:
    """Max-log LLRs: decision-point I/Q ``[..., K]`` -> ``[..., K*bps]``.

    ``lut``: ``[M, 2]`` constellation (symbol index = MSB-first bit pattern);
    ``noise_var`` is the per-rail noise variance sigma^2 at the decision
    point (``N0/2``).
    """
    lut = as_lut(lut, i.device)
    m = lut.shape[0]
    if m != 1 << bits_per_symbol:
        raise ValueError(f"lut has {m} points, expected 2^{bits_per_symbol}")
    # |y - c|^2 = |y|^2 - 2<y, c> + |c|^2; |y|^2 cancels in the difference
    cross = i[..., None] * lut[:, 0] + q[..., None] * lut[:, 1]  # [..., K, M]
    d2 = torch.sum(lut * lut, dim=-1) - 2.0 * cross
    sym = torch.arange(m, device=i.device)
    llrs = []
    for j in range(bits_per_symbol):
        bit = (sym >> (bits_per_symbol - 1 - j)) & 1  # MSB first
        d0 = d2[..., bit == 0].amin(dim=-1)
        d1 = d2[..., bit == 1].amin(dim=-1)
        llrs.append(d1 - d0)
    out = torch.stack(llrs, dim=-1) / (2.0 * noise_var)
    return out.reshape(out.shape[:-2] + (out.shape[-2] * bits_per_symbol,))


def llr_hard_bits(llrs: torch.Tensor) -> torch.Tensor:
    """Hard decisions from LLRs: bit = 1 where LLR < 0."""
    return (llrs < 0).to(torch.int32)
