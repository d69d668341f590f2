"""Channel impairment models and their correction primitives (counterpart of
:mod:`modem_tpu.ops.impairments`).

Block transforms that *impose* carrier frequency offset, static phase and
gain, multipath, fractional delay and Doppler fading (test apparatus and
channel emulation), and the Farrow fractional delay that the synchronizers
of :mod:`modem_tpu_torch.sync` use to *correct* timing. Real I/Q planes,
channel-major ``[..., N]`` tensors; every function runs on its inputs'
device. The FIR channels (:func:`multipath_fir`, :func:`apply_static_delay`)
go through :func:`modem_tpu_torch.ops.fir.fir_filter`: kernel K4 on a CUDA
tensor, its plain version on a CPU one. The float32 arithmetic keeps the
JAX package's order (a phase is ``((2*pi/sr) * cfo) * n`` over a float32
``n``), so streaming with ``n0`` continues a block exactly.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import TWO_PI
from .fir import fir_filter


def _f32(v, like: torch.Tensor) -> torch.Tensor:
    """A scalar, array or tensor as float32 on ``like``'s device (a scalar
    by a fill, with no copy from the host)."""
    if isinstance(v, torch.Tensor) or np.ndim(v):
        return torch.as_tensor(v, dtype=torch.float32, device=like.device)
    return torch.full((), float(v), dtype=torch.float32, device=like.device)


def _ramp(n: int, n0, like: torch.Tensor) -> torch.Tensor:
    """``arange(n) + n0`` in float32 on ``like``'s device."""
    return torch.arange(n, dtype=torch.float32, device=like.device) + _f32(
        n0, like)


# ---------------------------------------------------------------------------
# Rotation impairments: CFO, static phase, gain
# ---------------------------------------------------------------------------

def apply_cfo(i: torch.Tensor, q: torch.Tensor, cfo_hz, sample_rate: int,
              phase0=0.0, n0=0) -> tuple[torch.Tensor, torch.Tensor]:
    """Rotate baseband I/Q by ``exp(j*(2*pi*cfo*(n0+n)/sr + phase0))``.

    ``cfo_hz``/``phase0`` may be scalars or ``[..., 1]`` tensors (per-channel
    offsets); pass a negative ``cfo_hz`` to correct an estimated offset.
    ``n0`` is the block's starting sample index for streaming continuity.
    """
    n = _ramp(i.shape[-1], n0, i)
    theta = (TWO_PI / sample_rate) * _f32(cfo_hz, i) * n
    theta = theta + _f32(phase0, i)
    c, s = torch.cos(theta), torch.sin(theta)
    return i * c - q * s, i * s + q * c


def apply_gain_phase(i: torch.Tensor, q: torch.Tensor, gain=1.0, phase=0.0
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Multiply by ``gain * exp(j*phase)`` (scalars or tensors)."""
    g = _f32(gain, i)
    c = g * torch.cos(_f32(phase, i))
    s = g * torch.sin(_f32(phase, i))
    return i * c - q * s, i * s + q * c


# ---------------------------------------------------------------------------
# Multipath: static complex FIR channel
# ---------------------------------------------------------------------------

def multipath_fir(i: torch.Tensor, q: torch.Tensor, taps_i, taps_q
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Convolve I/Q with a static complex channel ``h = taps_i + j*taps_q``:
    four real causal FIR passes from zero history (K4 on CUDA)."""
    ii, _ = fir_filter(i, taps_i)
    qq, _ = fir_filter(q, taps_q)
    iq, _ = fir_filter(i, taps_q)
    qi, _ = fir_filter(q, taps_i)
    return ii - qq, iq + qi


# ---------------------------------------------------------------------------
# Fractional delay: static windowed-sinc (imposing) and Farrow (correcting)
# ---------------------------------------------------------------------------

def sinc_delay_taps(mu: float, num_taps: int = 63,
                    beta: float = 8.0) -> np.ndarray:
    """Kaiser-windowed sinc fractional-delay filter (host numpy, static
    ``mu``): total delay ``num_taps//2 + mu`` samples (``num_taps`` odd)."""
    if num_taps % 2 == 0:
        raise ValueError("sinc_delay_taps wants an odd num_taps")
    c = num_taps // 2
    n = np.arange(num_taps, dtype=np.float64)
    h = np.sinc(n - c - mu) * np.kaiser(num_taps, beta)
    return (h / h.sum()).astype(np.float32)


def apply_static_delay(i: torch.Tensor, q: torch.Tensor, mu: float,
                       num_taps: int = 63
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Delay I/Q by ``num_taps//2 + mu`` samples (static ``mu``; K4 at
    ``num_taps`` taps on CUDA)."""
    h = sinc_delay_taps(mu, num_taps)
    di, _ = fir_filter(i, h)
    dq, _ = fir_filter(q, h)
    return di, dq


def _lagrange_weights(f: torch.Tensor):
    """The cubic-Lagrange basis on nodes ``{-1, 0, 1, 2}`` at ``f``: the
    weights of ``x[n-3], x[n-2], x[n-1], x[n]`` for a delay of ``2 - f``
    samples."""
    return (-f * (f - 1.0) * (f - 2.0) / 6.0,
            (f * f - 1.0) * (f - 2.0) / 2.0,
            -f * (f + 1.0) * (f - 2.0) / 2.0,
            f * (f * f - 1.0) / 6.0)


def farrow_delay(x: torch.Tensor, mu) -> torch.Tensor:
    """Cubic-Lagrange (Farrow) fractional delay by ``1 + mu`` samples.

    ``mu`` in [0, 1) may be a scalar or a ``[..., 1]`` per-channel tensor
    (the weights are evaluated on the device). Output ``y[n] ~= x(n - 1 -
    mu)`` with zero history (the first 3 outputs are edge-affected)."""
    w = _lagrange_weights(1.0 - _f32(mu, x))
    xp = torch.cat([x.new_zeros(x.shape[:-1] + (3,)), x], dim=-1)
    n = x.shape[-1]
    return (w[0] * xp[..., 0:n] + w[1] * xp[..., 1:n + 1]
            + w[2] * xp[..., 2:n + 2] + w[3] * xp[..., 3:n + 3])


# ---------------------------------------------------------------------------
# Doppler fading: each path rotates at its own Doppler shift
# ---------------------------------------------------------------------------

def doppler_multipath(i: torch.Tensor, q: torch.Tensor, taps_i, taps_q,
                      doppler_hz, sample_rate: int, n0: int = 0
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Time-varying multipath: ``y[n] = sum_l h_l e^{j 2 pi f_l n / sr}
    x[n - l]``, each delay tap with its own Doppler shift ``f_l``; ``n0``
    is the block's first absolute sample index for streaming continuity.
    Degenerates to :func:`multipath_fir` at ``doppler_hz = 0``."""
    hi = np.asarray(taps_i, np.float32)
    hq = np.asarray(taps_q, np.float32)
    fd = np.asarray(doppler_hz, np.float64)
    if not (hi.shape == hq.shape == fd.shape) or hi.ndim != 1:
        raise ValueError("taps_i, taps_q, doppler_hz must be 1-D and "
                         "equal length")
    n = i.shape[-1]
    t = _ramp(n, n0, i)
    yi = torch.zeros_like(i)
    yq = torch.zeros_like(q)
    for l in range(hi.shape[0]):
        if hi[l] == 0.0 and hq[l] == 0.0:
            continue
        if l:
            z = i.new_zeros(i.shape[:-1] + (min(l, n),))
            xi = torch.cat([z, i[..., :max(n - l, 0)]], dim=-1)
            xq = torch.cat([z, q[..., :max(n - l, 0)]], dim=-1)
        else:
            xi, xq = i, q
        th = t * np.float32(TWO_PI * fd[l] / sample_rate)
        c, s = torch.cos(th), torch.sin(th)
        gi = float(hi[l]) * c - float(hq[l]) * s   # h_l * e^{j th}
        gq = float(hi[l]) * s + float(hq[l]) * c
        yi = yi + xi * gi - xq * gq
        yq = yq + xi * gq + xq * gi
    return yi, yq
