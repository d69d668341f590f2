"""Amplitude-and-phase-shift keying over concentric rings (counterpart of
:mod:`modem_tpu.models.apsk`)."""

from __future__ import annotations

import dataclasses

import numpy as np

from ..config import TWO_PI
from ..utils.bits import max_symbol
from .base import Scheme
from .psk import lut_program


@dataclasses.dataclass(frozen=True)
class Ring:
    """Symbols [start, end) on a ring of given radius and phase offset
    (`apsk.rs:60-82`)."""

    start: int
    end: int
    radius: float
    phase: float

    def __post_init__(self):
        if not 0.0 <= self.radius <= 1.0:
            raise ValueError("radius must be in [0, 1]")


class APSK(Scheme):
    """APSK (`apsk.rs:12-57`): symbol -> (ring radius, angle within ring),
    angle = 2*pi*(sym - start)/(end - start) + ring.phase, precomputed into
    a table. The rings must cover every symbol contiguously from 0, as
    `apsk.rs:85-97` checks."""

    def __init__(self, amplitude: float, bits_per_symbol: int,
                 rings: list[Ring]):
        self.bits_per_symbol = bits_per_symbol
        prev = 0
        for ring in rings:
            if ring.start != prev:
                raise ValueError("rings must be contiguous from symbol 0")
            prev = ring.end
        if prev != max_symbol(bits_per_symbol) + 1:
            raise ValueError("rings must cover all symbols")

        lut = np.zeros((1 << bits_per_symbol, 2), np.float32)
        for ring in rings:
            sym = np.arange(ring.start, ring.end)
            ph = TWO_PI * (sym - ring.start) / (ring.end - ring.start) + ring.phase
            lut[sym, 0] = amplitude * ring.radius * np.cos(ph)
            lut[sym, 1] = amplitude * ring.radius * np.sin(ph)
        self.lut = lut

    def program(self, symbols, state, rates, t0_mod):
        return lut_program(self.lut, symbols), state
