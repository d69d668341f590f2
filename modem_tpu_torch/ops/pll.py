"""First-order PLL carrier-phase acquisition (counterpart of
:mod:`modem_tpu.ops.pll`).

The reference runs a first-order loop over a fixed 64-sample preamble and
then freezes the acquired offset (`pll.rs:10-22`, `demodulator.rs:5,32-36`):
per sample,

    err  = arg(x * conj(e^{j(theta + phi)}))
    phi += 0.447214 * err

A 64-step recurrence is negligible work: a loop of tensor ops on the
tensor's device, batch dimensions riding along. The JAX package has no
kernel here, so neither has the port.
"""

from __future__ import annotations

import torch

#: Loop gain, `pll.rs:3`.
PLL_GAIN = 0.447214
#: Acquisition length, `demodulator.rs:5`.
LOCK_SAMPLES = 64


def pll_lock(xi: torch.Tensor, xq: torch.Tensor, theta: torch.Tensor,
             gain: float = PLL_GAIN) -> torch.Tensor:
    """Run the PLL over analytic samples ``xi + j*xq`` ``[..., n]`` against
    carrier phases ``theta`` ``[n]``; returns the final phase offset
    ``[...]``. ``err`` is the atan2 of the rotated planes."""
    if theta.ndim != 1 or theta.shape[0] != xi.shape[-1]:
        raise ValueError("theta must be [n] matching x's last axis")
    theta = theta.to(torch.float32)
    phi = torch.zeros(xi.shape[:-1], dtype=torch.float32, device=xi.device)
    for n in range(theta.shape[0]):
        si, sq = xi[..., n], xq[..., n]
        inner = theta[n] + phi
        c, s = torch.cos(inner), torch.sin(inner)
        err = torch.atan2(sq * c - si * s, si * c + sq * s)
        phi = phi + gain * err.to(torch.float32)
    return phi
