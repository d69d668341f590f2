"""Data-aided linear MMSE equalization at symbol rate (counterpart of
:mod:`modem_tpu.ops.equalizer`).

A preamble-trained complex FIR corrects inter-symbol interference from
multipath that the matched filter alone cannot: taps are the regularized
least-squares solution of ``min ||conv(d, w) - a||^2`` over the known
preamble, a ``[2T, 2T]`` solve per channel (``torch.linalg.solve_ex``, as
the JAX package solves outside any kernel). Complex math in the real 2x
block form: with windows ``X = Xr + j*Xi`` and taps ``w = wr + j*wi``,

    [yr]   [Xr  -Xi] [wr]
    [yi] = [Xi   Xr] [wi]

The products ``G^T G``, ``G^T b`` and the equalizer's sums are elementwise
products summed in float32, so no matmul setting (TF32) can round them.
"""

from __future__ import annotations

import torch


def symbol_windows(d: torch.Tensor, n_taps: int) -> torch.Tensor:
    """``[..., K] -> [..., K, n_taps]``: row ``k`` holds
    ``d[k-c .. k+n_taps-1-c]`` with ``c = n_taps//2`` (cursor-centered,
    zero-padded at the edges)."""
    c = n_taps // 2
    dp = torch.cat([d.new_zeros(d.shape[:-1] + (c,)), d,
                    d.new_zeros(d.shape[:-1] + (n_taps - 1 - c,))], dim=-1)
    return dp.unfold(-1, n_taps, 1)


def _gram(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a^T b`` over the second-to-last axis, ``[..., R, M] x [..., R, N]
    -> [..., M, N]``, as float32 products summed."""
    return torch.sum(a[..., :, :, None] * b[..., :, None, :], dim=-3)


def train_lmmse(di: torch.Tensor, dq: torch.Tensor, targets, n_taps: int,
                ridge: float = 1e-3) -> tuple[torch.Tensor, torch.Tensor]:
    """LMMSE taps from received preamble decision points.

    ``di, dq [..., P]``: received symbol-rate samples over the known
    preamble; ``targets [P, 2]`` (or ``[..., P, 2]``): the transmitted
    symbols' I/Q. Returns ``(wr, wi) [..., n_taps]`` minimizing
    ``||X w - a||^2 + ridge*trace(X^H X)/(2T) * ||w||^2``.
    """
    t = torch.as_tensor(targets, dtype=torch.float32, device=di.device)
    ar, ai = t[..., 0], t[..., 1]
    xr = symbol_windows(di, n_taps)  # [..., P, T]
    xi = symbol_windows(dq, n_taps)
    # G = [[Xr, -Xi], [Xi, Xr]]  (2P x 2T), b = [ar; ai]  (2P)
    top = torch.cat([xr, -xi], dim=-1)
    bot = torch.cat([xi, xr], dim=-1)
    g = torch.cat([top, bot], dim=-2)  # [..., 2P, 2T]
    b = torch.cat([ar, ai], dim=-1)[..., None]  # [..., 2P, 1]
    gtg = _gram(g, g)  # [..., 2T, 2T]
    gtb = _gram(g, b)  # [..., 2T, 1]
    tt = 2 * n_taps
    scale = torch.diagonal(gtg, dim1=-2, dim2=-1).sum(-1)[..., None, None] / tt
    eye = torch.eye(tt, dtype=gtg.dtype, device=gtg.device)
    w = torch.linalg.solve_ex(gtg + ridge * scale * eye, gtb)[0][..., 0]
    return w[..., :n_taps], w[..., n_taps:]


def apply_equalizer(di: torch.Tensor, dq: torch.Tensor, wr: torch.Tensor,
                    wi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Complex FIR at symbol rate with (possibly per-channel) trained taps:
    ``y = conv(d, w)``, cursor-centered like :func:`symbol_windows`."""
    n_taps = wr.shape[-1]
    xr = symbol_windows(di, n_taps)
    xi = symbol_windows(dq, n_taps)
    wr, wi = wr[..., None, :], wi[..., None, :]
    yr = torch.sum(xr * wr, dim=-1) - torch.sum(xi * wi, dim=-1)
    yi = torch.sum(xi * wr, dim=-1) + torch.sum(xr * wi, dim=-1)
    return yr, yi
