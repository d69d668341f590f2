"""Causal FIR filter, direct form (counterpart of :mod:`modem_tpu.ops.fir`
with its ``direct`` backend).

``y[n] = sum_j taps[j] * x[n-j]`` with zero initial history (the reference's
`fir.rs:10-34`), as a block transform over ``[..., n]`` tensors with an
explicit ``taps-1``-sample tail carried between blocks. The JAX package's
``conv``, ``matmul`` and ``fft`` backends are not ported yet.
"""

from __future__ import annotations

import torch


def as_taps(taps, device) -> torch.Tensor:
    """1-D float32 filter taps on ``device``."""
    t = torch.as_tensor(taps, dtype=torch.float32, device=device)
    if t.ndim != 1:
        raise ValueError("taps must be 1-D")
    return t


def fir_init_state(taps, batch_shape: tuple[int, ...] = (),
                   device=None) -> torch.Tensor:
    """Zero history of ``taps-1`` samples (matches `fir.rs:12-15`)."""
    return torch.zeros(batch_shape + (len(taps) - 1,), dtype=torch.float32,
                       device=device)


def fir_filter(x: torch.Tensor, taps, state: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Causal FIR: returns ``(y, new_state)`` with ``y.shape == x.shape``.

    ``state`` is the previous block's last ``K-1`` samples (zeros if None,
    matching the reference's fresh-filter behavior).
    """
    taps = as_taps(taps, x.device)
    k = taps.shape[0]
    if state is None:
        state = torch.zeros(x.shape[:-1] + (k - 1,), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([state, x], dim=-1) if k > 1 else x
    new_state = xp[..., xp.shape[-1] - (k - 1):] if k > 1 else state
    return _fir_direct(xp, taps), new_state


def _fir_direct(xp: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """y[n] = sum_j taps[j] * xp[n + K-1 - j]: K shifted multiply-adds."""
    k = taps.shape[0]
    n = xp.shape[-1] - (k - 1)
    y = torch.zeros(xp.shape[:-1] + (n,), dtype=xp.dtype, device=xp.device)
    for j in range(k):
        y = y + taps[j] * xp[..., k - 1 - j: k - 1 - j + n]
    return y
