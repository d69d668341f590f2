"""Numerically-controlled oscillator and I/Q mixing (counterpart of
:mod:`modem_tpu.ops.nco`).

The carrier phase of a whole block is exact integer arithmetic: for an
integer carrier ``hz`` and sample rate ``sr``,

    theta(s) = 2*pi * ((hz * (s mod sr)) mod sr) / sr

bit-stable for unbounded streams (the reference's f32 ``omega * s``,
`carrier.rs:17-19`, drifts for long ones). ``hz * (s mod sr)`` fits int32
for ``hz * sr < 2^31``. Mixing mirrors `modulator.rs:37-48` (up) and
`demodulator.rs:50-55` (down).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import TWO_PI


def carrier_phase(hz: int, sr: int, n: int, s0_mod: torch.Tensor | int = 0,
                  device=None) -> torch.Tensor:
    """Phase ``theta(s0 + k) for k in [0, n)`` as float32 radians in
    ``[0, 2*pi)``. ``s0_mod`` is the block's first sample index modulo
    ``sr``, an int or an int32 tensor (carried on the device, so a stream
    never waits for the host); the result lies on its device, or on
    ``device`` for an int."""
    if torch.is_tensor(s0_mod):
        device = s0_mod.device
    s = (torch.arange(n, dtype=torch.int32, device=device) + s0_mod) % sr
    u = (s * hz) % sr
    return u.to(torch.float32) * float(np.float32(TWO_PI / sr))


def mix_up(i: torch.Tensor, q: torch.Tensor, theta: torch.Tensor):
    """Baseband I/Q -> passband ``(re, im)``: ``re = i*cos - q*sin``,
    ``im = i*sin + q*cos`` (`modulator.rs:37-48`)."""
    c = torch.cos(theta)
    s = torch.sin(theta)
    return i * c - q * s, i * s + q * c


def mix_down(x: torch.Tensor, theta: torch.Tensor):
    """Product-detector mixer terms ``(x*cos(theta), -x*sin(theta))``
    (`demodulator.rs:50-55`)."""
    return x * torch.cos(theta), -x * torch.sin(theta)
