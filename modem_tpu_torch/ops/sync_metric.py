"""Blind-synchronization primitives for CP-based frame PHYs (counterpart of
:mod:`modem_tpu.ops.sync_metric`).

* :func:`periodic_similarity`: the Schmidl & Cox shaped metric with the
  symmetric (Minn-style) denominator, bounded to [0, 1], each of its
  windowed sums taken directly (the JAX package takes prefix-sum
  differences);
* :func:`template_correlate_fir`: the complex correlation against a known
  template as four causal FIR passes with the reversed template as taps:
  kernel K4 (:func:`modem_tpu_torch.ops.fir.fir_filter`) on a CUDA tensor,
  its plain version on a CPU one;
* :func:`aligned_frame_matmul`: the located frame's samples, a per-row
  gather.
"""

from __future__ import annotations

import numpy as np
import torch

from .fir import as_taps, fir_filter


def periodic_similarity(i: torch.Tensor, q: torch.Tensor, lag: int,
                        width: int, max_lag: int):
    """Period-``lag`` self-similarity over ``width``-sample windows at lags
    ``[0, max_lag)``: returns ``(M, P_i, P_q)`` with ``P(d) = sum_m
    conj(r[d+m]) r[d+m+lag]`` and ``M = |P|^2 / ((E1+E2)/2)^2`` in [0, 1]."""
    need = max_lag + width + lag
    if i.shape[-1] < need:
        raise ValueError(f"need >= {need} samples for max_lag={max_lag}")
    n = max_lag + width - 1  # the samples the windows cover
    a_i, a_q = i[..., :n], q[..., :n]
    b_i, b_q = i[..., lag:lag + n], q[..., lag:lag + n]
    pi = a_i * b_i + a_q * b_q
    pq = a_i * b_q - a_q * b_i
    en1 = a_i ** 2 + a_q ** 2
    en2 = b_i ** 2 + b_q ** 2

    def wsum(x):
        # each window summed on its own: a run of zeros sums to exactly
        # zero, where a difference of prefix sums keeps the rounding of
        # the samples before it (a parallel scan's, on the card), which
        # the ratio M can turn into a false plateau
        return x.unfold(-1, width, 1).sum(dim=-1)

    ps_i, ps_q = wsum(pi), wsum(pq)
    es = torch.clamp(0.5 * (wsum(en1) + wsum(en2)), min=1e-12)
    m = (ps_i * ps_i + ps_q * ps_q) / (es * es)
    return m, ps_i, ps_q


def correlate_reversed(ci: torch.Tensor, cq: torch.Tensor,
                       rev_i: torch.Tensor, rev_q: torch.Tensor,
                       max_lag: int):
    """:func:`template_correlate_fir` with the template already reversed
    (``rev_i``, ``rev_q``: float32 taps on the capture's device, kept by the
    caller so K4's host copy of them is made once)."""
    p = rev_i.shape[0]
    # only the first max_lag + p - 1 samples reach lags [0, max_lag)
    head = max_lag + p - 1
    if ci.shape[-1] > head:
        ci, cq = ci[..., :head], cq[..., :head]
    aii, _ = fir_filter(ci, rev_i)
    aqq, _ = fir_filter(cq, rev_q)
    aqi, _ = fir_filter(cq, rev_i)
    aiq, _ = fir_filter(ci, rev_q)
    cr = (aii + aqq)[..., p - 1: p - 1 + max_lag]
    cj = (aqi - aiq)[..., p - 1: p - 1 + max_lag]
    return cr, cj


def template_correlate_fir(ci: torch.Tensor, cq: torch.Tensor, tpl_i, tpl_q,
                           max_lag: int):
    """Complex correlation against a known template at lags ``[0,
    max_lag)``: ``C(d) = sum_k conj(tpl[k]) r[d+k]`` as four causal FIR
    passes with the reversed template as taps, read at offset ``P - 1``.
    Returns ``(cr, cj) [..., max_lag]``."""
    rev = [as_taps(np.asarray(t, np.float32)[::-1].copy(), ci.device)
           for t in (tpl_i, tpl_q)]
    return correlate_reversed(ci, cq, rev[0], rev[1], max_lag)


def aligned_frame_matmul(ci: torch.Tensor, cq: torch.Tensor,
                         start: torch.Tensor, out_len: int, max_lag: int):
    """``(ci[..., s : s + out_len], cq[..., s : s + out_len])`` for a
    per-row integer start ``s`` in ``[0, max_lag)``, zero past the end of
    the capture (silence after the frame). The JAX package computes it as a
    one-hot matmul, a TPU stand-in for this gather; it selects one value an
    output, so the two agree bit for bit."""
    need = out_len + int(max_lag)
    if ci.shape[-1] < need:
        pad = ci.new_zeros(ci.shape[:-1] + (need - ci.shape[-1],))
        ci, cq = torch.cat([ci, pad], dim=-1), torch.cat([cq, pad], dim=-1)
    idx = start.to(torch.int64)[..., None] + torch.arange(
        out_len, device=ci.device)
    idx = idx.expand(ci.shape[:-1] + (out_len,))
    return torch.gather(ci, -1, idx), torch.gather(cq, -1, idx)
