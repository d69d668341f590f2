"""BPSK and QPSK constellations (counterpart of :mod:`modem_tpu.models.psk`).

Only the tables are built here; mapping is a plain index into them
(:func:`modem_tpu_torch.ops.slicer.lut_map`).
"""

from __future__ import annotations

import math

import numpy as np

from .base import Scheme

_SQRT_HALF = math.sqrt(0.5)


class BPSK(Scheme):
    """i = sign(b)*A*cos(phase), q = sign(b)*A*sin(phase) (`bpsk.rs:17-31`)."""

    bits_per_symbol = 1

    def __init__(self, phase: float, amplitude: float):
        s = np.array([-1.0, 1.0])
        self.lut = np.stack(
            [s * amplitude * math.cos(phase), s * amplitude * math.sin(phase)], axis=-1
        )


class QPSK(Scheme):
    """Rotated +-1/+-1 constellation scaled by A/sqrt(2) (`qpsk.rs:11-35`).

    i = A'*(s0*cos - s1*sin), q = A'*(s1*cos + s0*sin) with s_k = 2*b_k - 1.
    """

    bits_per_symbol = 2

    def __init__(self, phase: float, amplitude: float):
        a = amplitude * _SQRT_HALF
        c, s = math.cos(phase), math.sin(phase)
        sym = np.arange(4)
        s0 = 2.0 * (sym >> 1) - 1.0
        s1 = 2.0 * (sym & 1) - 1.0
        self.lut = np.stack([a * (s0 * c - s1 * s), a * (s1 * c + s0 * s)], axis=-1)
