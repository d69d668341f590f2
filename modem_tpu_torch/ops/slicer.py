"""Hard-decision slicers (counterpart of :mod:`modem_tpu.ops.slicer`).

* constellation schemes: map and minimum-distance slice against the table;
* differential PSK: the phase change between consecutive decision points;
* FSK family: the FM discriminator, per-symbol interior means and the
  nearest-frequency decision.

The JAX package maps with a one-hot matmul because gathers serialize on its
TPU; here the map is a plain index into the table. Slicers keep the first of
equal minima, as the fused kernels do. The staged discriminator uses the
exact ``torch.atan2``, as the JAX one uses ``jnp.arctan2``; only the fused
kernels use the polynomial (:func:`modem_tpu_torch.ops.fsk_kernel.atan2_poly`).
"""

from __future__ import annotations

import numpy as np
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


def _with_previous(x: torch.Tensor, first: torch.Tensor) -> torch.Tensor:
    """``x`` delayed by one step along the last axis, ``first [..., 1]`` in
    front."""
    return torch.cat([first, x[..., :-1]], dim=-1)


def _angle_increment(i, q, ip, qp) -> torch.Tensor:
    """``angle(y * conj(y_prev))`` on real I/Q planes."""
    return torch.atan2(q * ip - i * qp, i * ip + q * qp)


def diff_phase(i: torch.Tensor, q: torch.Tensor,
               prev: torch.Tensor | None = None) -> torch.Tensor:
    """Phase change between consecutive decision points,
    ``angle(y_k * conj(y_{k-1}))``: the differential-PSK statistic of the
    hard slicer and the DMPSK LLRs. ``prev``: the previous block's last
    ``(i, q)`` pair ``[..., 2]`` ((1, 0) if None)."""
    if prev is None:
        pi_, pq_ = torch.ones_like(i[..., :1]), torch.zeros_like(q[..., :1])
    else:
        pi_, pq_ = prev[..., 0:1], prev[..., 1:2]
    return _angle_increment(i, q, _with_previous(i, pi_),
                            _with_previous(q, pq_))


def diff_phase_slice(i: torch.Tensor, q: torch.Tensor, shift: float,
                     bits_per_symbol: int,
                     prev: torch.Tensor | None = None) -> torch.Tensor:
    """Differential PSK decisions: the phase change rounded (half to even,
    as ``jnp.round``) to the nearest multiple of ``shift``, mod M."""
    m = 1 << bits_per_symbol
    dphi = diff_phase(i, q, prev)
    return torch.round(dphi / shift).to(torch.int32) % m


def fm_discriminate(i: torch.Tensor, q: torch.Tensor,
                    prev: torch.Tensor | None = None) -> torch.Tensor:
    """Instantaneous frequency (rad/sample) of a complex baseband signal,
    ``angle(y[n] * conj(y[n-1]))``; ``prev`` is the previous block's last
    sample ``[..., 2]`` (the first sample itself if None: increment 0)."""
    if prev is None:
        pi_, pq_ = i[..., :1], q[..., :1]
    else:
        pi_, pq_ = prev[..., 0:1], prev[..., 1:2]
    return _angle_increment(i, q, _with_previous(i, pi_),
                            _with_previous(q, pq_))


def fsk_symbol_means(inst_freq: torch.Tensor, sps: int,
                     guard: int = 1) -> torch.Tensor:
    """Per-symbol mean instantaneous frequency over the interior samples
    (``guard`` boundary samples skipped): the FSK decision statistic."""
    k = inst_freq.shape[-1] // sps
    per_sym = inst_freq[..., : k * sps].reshape(inst_freq.shape[:-1] + (k, sps))
    return torch.mean(per_sym[..., guard:], dim=-1)


def fsk_targets(coefs, dev_rad_per_sample: float, device) -> torch.Tensor:
    """``f32(coef) * f32(dev)`` per candidate symbol, rad/sample."""
    t = np.asarray(coefs, np.float32) * np.float32(dev_rad_per_sample)
    return torch.as_tensor(t, device=device)


def fsk_slice(inst_freq: torch.Tensor, coefs, dev_rad_per_sample: float,
              sps: int, guard: int = 1) -> torch.Tensor:
    """Per-symbol frequency decisions ``[..., K]`` int32 from the
    instantaneous frequency ``[..., K*sps]``: the interior mean of each
    symbol, then the nearest ``coef * dev``. Every ``|coef * dev|`` must stay
    below pi rad/sample, or the increment wraps and symbols alias."""
    return fsk_slice_means(fsk_symbol_means(inst_freq, sps, guard), coefs,
                           dev_rad_per_sample)


def fsk_slice_means(mean_f: torch.Tensor, coefs,
                    dev_rad_per_sample: float) -> torch.Tensor:
    """Nearest-frequency decisions from the per-symbol means; of equal
    distances the first candidate wins."""
    targets = fsk_targets(coefs, dev_rad_per_sample, mean_f.device)
    return torch.argmin(torch.abs(mean_f[..., None] - targets),
                        dim=-1).to(torch.int32)
