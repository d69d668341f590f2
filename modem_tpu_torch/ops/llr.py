"""Per-bit max-log LLRs (counterpart of :mod:`modem_tpu.ops.llr`): over a
constellation (:func:`lut_llr`), in the FSK discriminator domain
(:func:`fsk_llr`) and in the differential-phase domain (:func:`dmpsk_llr`).

    LLR_j = (min_{c: bit_j(c)=1} d(c) - min_{c: bit_j(c)=0} d(c)) / (2*sigma^2)

with ``d`` the squared distance to candidate ``c``. Positive LLR = bit 0
more likely; symbol indices are MSB-first bit patterns.
"""

from __future__ import annotations

import math

import torch

from .slicer import as_lut, fsk_targets


def _bitwise_min_llrs(d2: torch.Tensor, bits_per_symbol: int,
                      noise_var: float) -> torch.Tensor:
    """Per-candidate squared distances ``[..., K, M]`` -> per-bit LLRs
    ``[..., K*bps]`` via masked mins (MSB-first bits)."""
    sym = torch.arange(d2.shape[-1], device=d2.device)
    llrs = []
    for j in range(bits_per_symbol):
        bit = (sym >> (bits_per_symbol - 1 - j)) & 1
        llrs.append(d2[..., bit == 1].amin(dim=-1)
                    - d2[..., bit == 0].amin(dim=-1))
    out = torch.stack(llrs, dim=-1) / (2.0 * noise_var)
    return out.reshape(out.shape[:-2] + (out.shape[-2] * bits_per_symbol,))


def lut_llr(i: torch.Tensor, q: torch.Tensor, lut, bits_per_symbol: int,
            noise_var: float = 1.0) -> torch.Tensor:
    """Max-log LLRs: decision-point I/Q ``[..., K]`` -> ``[..., K*bps]``.

    ``lut``: ``[M, 2]`` constellation; ``noise_var`` is the per-rail noise
    variance sigma^2 at the decision point (``N0/2``).
    """
    lut = as_lut(lut, i.device)
    m = lut.shape[0]
    if m != 1 << bits_per_symbol:
        raise ValueError(f"lut has {m} points, expected 2^{bits_per_symbol}")
    # |y - c|^2 = |y|^2 - 2<y, c> + |c|^2; |y|^2 cancels in the difference
    cross = i[..., None] * lut[:, 0] + q[..., None] * lut[:, 1]  # [..., K, M]
    d2 = torch.sum(lut * lut, dim=-1) - 2.0 * cross
    return _bitwise_min_llrs(d2, bits_per_symbol, noise_var)


def llr_hard_bits(llrs: torch.Tensor) -> torch.Tensor:
    """Hard decisions from LLRs: bit = 1 where LLR < 0."""
    return (llrs < 0).to(torch.int32)


def fsk_llr(mean_f: torch.Tensor, coefs, dev_rad_per_sample: float,
            bits_per_symbol: int, noise_var: float = 1.0) -> torch.Tensor:
    """Discriminator-domain LLRs of the FSK family from the per-symbol mean
    instantaneous frequency ``[..., K]``, taken as Gaussian around each tone
    ``coef * dev`` with variance ``noise_var``. The sign of each LLR gives
    :func:`~modem_tpu_torch.ops.slicer.fsk_slice`'s bits."""
    targets = fsk_targets(coefs, dev_rad_per_sample, mean_f.device)
    if 1 << bits_per_symbol != targets.shape[0]:
        raise ValueError(
            f"{targets.shape[0]} coefs for 2^{bits_per_symbol} symbols")
    d2 = (mean_f[..., None] - targets) ** 2  # [..., K, M]
    return _bitwise_min_llrs(d2, bits_per_symbol, noise_var)


def dmpsk_llr(dphi: torch.Tensor, shift: float, bits_per_symbol: int,
              noise_var: float = 1.0) -> torch.Tensor:
    """Differential-phase LLRs of DMPSK from the per-symbol phase change
    ``[..., K]``: candidates at ``m * shift`` on the circle, compared by
    wrapped angular distance; ``noise_var`` is the differential-phase
    variance."""
    m = 1 << bits_per_symbol
    cand = shift * torch.arange(m, dtype=torch.float32, device=dphi.device)
    err = dphi[..., None] - cand
    wrapped = torch.remainder(err + math.pi, 2.0 * math.pi) - math.pi
    return _bitwise_min_llrs(wrapped * wrapped, bits_per_symbol, noise_var)
