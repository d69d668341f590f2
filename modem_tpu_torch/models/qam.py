"""Square-grid QAM (counterpart of :mod:`modem_tpu.models.qam`)."""

from __future__ import annotations

import math

import numpy as np

from ..utils.bits import max_symbol
from .base import Scheme
from .psk import lut_program


class QAM(Scheme):
    """Square-grid QAM (`qam.rs:14-60`): the symbol splits into MSB/LSB
    halves, each half maps to the level ``2*s - max`` scaled by
    ``A/max/2``, and the pair is rotated by ``phase``. Compiled to the full
    ``2^bps``-point table. ``gray=True`` Gray-codes each rail; the default
    is the reference's natural-binary map (`qam.rs:32-38`)."""

    def __init__(self, bits_per_symbol: int, phase: float,
                 amplitude: float, gray: bool = False):
        if bits_per_symbol <= 1:
            raise ValueError("QAM needs at least one bit per carrier")
        self.bits_per_symbol = bits_per_symbol
        self.phase = phase
        self.amplitude = amplitude
        self.gray = bool(gray)
        cs = bits_per_symbol // 2
        ms = float(max_symbol(cs))
        a = amplitude / ms / 2.0
        sym = np.arange(1 << bits_per_symbol)
        msb = sym >> (bits_per_symbol - cs)
        lsb = sym & max_symbol(bits_per_symbol - cs)
        if gray:
            # inverse Gray per rail: pattern g -> level s with s ^ (s >> 1) == g
            def inv_gray(g):
                s = g.copy()
                shift = 1
                while (1 << shift) <= int(g.max(initial=1)):
                    s = s ^ (s >> shift)
                    shift *= 2
                return s
            msb = inv_gray(msb)
            lsb = inv_gray(lsb)
        pos_m = 2.0 * msb - ms
        pos_l = 2.0 * lsb - ms
        c, s = math.cos(phase), math.sin(phase)
        self.lut = np.stack(
            [a * (pos_m * c - pos_l * s), a * (pos_l * c + pos_m * s)], axis=-1
        ).astype(np.float32)

    def program(self, symbols, state, rates, t0_mod):
        return lut_program(self.lut, symbols), state
