"""Automatic gain control: log-domain feedback AGC at sub-block rate
(counterpart of :mod:`modem_tpu.ops.agc`).

The loop runs at sub-block rate: each step applies the carried gain to
``sub_block`` samples at once, measures the output RMS and nudges the
log-gain toward the target. The JAX package's ``lax.scan`` over sub-blocks
is a loop here that carries the log-gain, one channel-parallel step a
sub-block. State is one float32 log-gain per channel; pushes of whole
sub-blocks equal one shot bit for bit.
"""

from __future__ import annotations

import torch

from ..cuda import resolve_device


def normalize_rms(i: torch.Tensor, q: torch.Tensor, target_rms: float = 1.0,
                  eps: float = 1e-12):
    """Feedforward whole-block normalization to ``target_rms`` (complex
    magnitude RMS over the last axis). The one-shot form for burst work."""
    p = torch.mean(i * i + q * q, dim=-1, keepdim=True)
    g = torch.full((), target_rms, dtype=torch.float32, device=i.device) \
        / torch.sqrt(torch.clamp(p, min=eps))
    return i * g, q * g


class Agc:
    """Feedback AGC with log-domain loop gain.

    ``loop_gain`` is the fraction of the measured log-level error folded in
    per sub-block (0 < g <= 1): convergence to 1% of a level step takes
    about ``ln(0.01)/ln(1-g)`` sub-blocks.
    """

    def __init__(self, target_rms: float = 1.0, loop_gain: float = 0.25,
                 sub_block: int = 64, eps: float = 1e-12):
        if not 0.0 < loop_gain <= 1.0:
            raise ValueError("loop_gain must be in (0, 1]")
        self.target = float(target_rms)
        self.loop_gain = float(loop_gain)
        self.sub_block = int(sub_block)
        self.eps = float(eps)

    def init_state(self, batch_shape: tuple[int, ...] = (),
                   device: torch.device | str | None = None) -> torch.Tensor:
        """Initial log-gain (0 = unity) on ``device``, the card unless the
        caller asks for the CPU."""
        return torch.zeros(batch_shape, dtype=torch.float32,
                           device=resolve_device(device))

    def process(self, i: torch.Tensor, q: torch.Tensor, state: torch.Tensor):
        """``[..., n]`` I/Q (n a multiple of ``sub_block``) -> gained I/Q
        and the advanced log-gain state."""
        n = i.shape[-1]
        l = self.sub_block
        if n % l:
            raise ValueError(f"block length {n} must divide by {l}")
        # the log in float32, as the JAX package's jnp.log(target)
        log_target = torch.log(torch.full((), self.target,
                                          dtype=torch.float32,
                                          device=i.device))
        bi = i.reshape(i.shape[:-1] + (n // l, l))
        bq = q.reshape(q.shape[:-1] + (n // l, l))
        lg, out_i, out_q = state, [], []
        for b in range(n // l):
            g = torch.exp(lg)[..., None]
            yi, yq = bi[..., b, :] * g, bq[..., b, :] * g
            p = torch.mean(yi * yi + yq * yq, dim=-1)
            err = log_target - 0.5 * torch.log(torch.clamp(p, min=self.eps))
            lg = lg + self.loop_gain * err
            out_i.append(yi)
            out_q.append(yq)
        yi = torch.stack(out_i, dim=-2).reshape(i.shape)
        yq = torch.stack(out_q, dim=-2).reshape(q.shape)
        return (yi, yq), lg
