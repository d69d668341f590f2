"""Amplitude-shift keying (counterpart of :mod:`modem_tpu.models.ask`)."""

from __future__ import annotations

import numpy as np
import torch

from .base import IQProgram, Scheme, f32


class BASK(Scheme):
    """Binary ASK: i = b*A, q = 0 (`bask.rs:18-24`)."""

    bits_per_symbol = 1

    def __init__(self, amplitude: float):
        self.amplitude = amplitude
        #: the 2-point table, for the LUT-driven surfaces
        self.lut = np.array([[0.0, 0.0], [amplitude, 0.0]], np.float32)

    def program(self, symbols, state, rates, t0_mod):
        i = symbols.to(torch.float32) * f32(self.amplitude)
        return IQProgram(i=i, q=torch.zeros_like(i)), state
