"""Rational sample-rate conversion: the polyphase up/down resampler
(counterpart of :mod:`modem_tpu.ops.resample`).

``y = downsample_M(lowpass(upsample_L(x)))`` without the upsampled stream,
by the polyphase identity

    y[m] = sum_k h[k*L + p_m] * x[b_m - k],   p_m = (m*M) mod L,
                                              b_m = (m*M) div L.

Outputs of one phase ``r = m mod L`` form a decimated FIR on ``x`` (stride
M, offset ``b_r``): one :func:`~modem_tpu_torch.ops.polyphase
.polyphase_decim` call per branch. The resampler carries the previous
block's last ``taps_per_phase - 1`` input samples as explicit state, so a
chunked stream equals one shot; block lengths must satisfy
``N * up % down == 0``. ``up == down == 1`` is the plain FIR
(:func:`~modem_tpu_torch.ops.fir.fir_filter`, kernel K4 on a CUDA device).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .fir import as_taps, fir_filter
from .polyphase import polyphase_decim


def design_lowpass(num_taps: int, cutoff: float, beta: float = 8.0) -> np.ndarray:
    """Kaiser-windowed sinc lowpass; ``cutoff`` in (0, 1] of Nyquist."""
    if not 0.0 < cutoff <= 1.0:
        raise ValueError("cutoff must be in (0, 1]")
    n = np.arange(num_taps) - (num_taps - 1) / 2.0
    h = np.sinc(cutoff * n) * cutoff
    h *= np.kaiser(num_taps, beta)
    return (h / h.sum()).astype(np.float32)


def resample_taps(up: int, down: int, taps_per_phase: int = 16,
                  beta: float = 8.0) -> np.ndarray:
    """Anti-aliasing/interpolation prototype for an up/down converter: cutoff
    at the tighter of the two Nyquists, gain ``up`` (to preserve amplitude
    through zero-stuffing)."""
    num = up * taps_per_phase
    h = design_lowpass(num, 1.0 / max(up, down), beta)
    return (h * up).astype(np.float32)


def resample_state_len(taps, up: int, down: int) -> int:
    """Length of the carried input history: ``taps_per_phase - 1`` samples
    (the longest lookback of any polyphase branch)."""
    up //= math.gcd(up, down)
    n = len(taps)
    return (n + (-n) % up) // up - 1


def rational_resample(x: torch.Tensor, up: int, down: int, taps=None,
                      taps_per_phase: int = 16,
                      state: torch.Tensor | None = None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Resample ``x [..., N]`` by ``up/down``. Returns ``(y [..., N*up//down],
    new_state)`` (requires ``N*up % down == 0``); causal, no group-delay
    compensation. ``state`` is the previous block's last
    ``taps_per_phase - 1`` input samples (zero history if None)."""
    g = math.gcd(up, down)
    up, down = up // g, down // g
    if taps is None:
        taps = resample_taps(up, down, taps_per_phase)
    taps = as_taps(taps, x.device)
    n = x.shape[-1]
    if (n * up) % down:
        raise ValueError(f"N*up ({n}*{up}) must divide by down ({down})")
    n_out = n * up // down
    h = torch.nn.functional.pad(taps, (0, (-taps.shape[0]) % up))
    kp = h.shape[0] // up  # taps per polyphase branch
    if state is None:
        state = torch.zeros(x.shape[:-1] + (kp - 1,), dtype=x.dtype,
                            device=x.device)
    if state.shape[-1] != kp - 1:
        raise ValueError(
            f"resampler state must hold {kp - 1} samples, got {state.shape[-1]}")
    xh = torch.cat([state, x], dim=-1) if kp > 1 else x
    new_state = xh[..., xh.shape[-1] - (kp - 1):] if kp > 1 else state
    if up == 1 and down == 1:
        y, _ = fir_filter(x, taps, state=state)
        return y, new_state

    # branch r decides the outputs m = r + t*up:
    #   y_r[t] = sum_k h[k*up + p_r] * x[b_r + t*down - k]
    t_max = -(-n_out // up)
    branches = []
    for r in range(up):
        t_r = max(-(-(n_out - r) // up), 0)
        if t_r == 0:
            y_r = torch.zeros(x.shape[:-1] + (0,), dtype=x.dtype,
                              device=x.device)
        else:
            y_r = polyphase_decim(x, h[(r * down) % up::up], down,
                                  (r * down) // up, t_r, state=state)
        branches.append(torch.nn.functional.pad(y_r, (0, t_max - t_r)))
    y = torch.stack(branches, dim=-1).reshape(x.shape[:-1] + (t_max * up,))
    return y[..., :n_out], new_state
