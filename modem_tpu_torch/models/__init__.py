"""Modulation schemes and the scheme registry (counterpart of
:mod:`modem_tpu.models`).

:func:`make_scheme` mirrors the reference CLI's scheme table with its exact
per-scheme constants (`modulate.rs:74-95`).
"""

from __future__ import annotations

import math

from ..config import Rates
from .apsk import APSK, Ring
from .ask import BASK
from .base import IQProgram, PhaseProgram, Scheme, synthesize
from .fsk import BFSK, CPFSK, MFSK, MSK
from .psk import BPSK, DCQPSK, DMPSK, MPSK, OQPSK, QPSK
from .qam import QAM

__all__ = [
    "APSK", "BASK", "BFSK", "BPSK", "CPFSK", "DCQPSK", "DMPSK", "IQProgram",
    "MFSK", "MPSK", "MSK", "OQPSK", "PhaseProgram", "QAM", "QPSK", "Ring",
    "Scheme", "SCHEME_NAMES", "make_scheme", "synthesize",
]

#: The waveform amplitude used by the reference CLI (`modulate.rs:14`).
AMPLITUDE = 1.0

SCHEME_NAMES = (
    "bask", "bpsk", "bfsk", "qpsk", "qam16", "qam256", "msk", "mfsk", "16psk",
    "oqpsk", "dcqpsk", "16cpfsk", "16apsk", "dqpsk", "dbpsk",
)


def make_scheme(name: str, rates: Rates, amplitude: float = AMPLITUDE) -> Scheme:
    """Build a scheme with the reference CLI's parameters (`modulate.rs:74-95`)."""
    sr = rates.sample_rate
    pi = math.pi
    if name == "bask":
        return BASK(amplitude)
    if name == "bpsk":
        return BPSK(pi / 4.0, amplitude)
    if name == "bfsk":
        return BFSK(200, sr, amplitude)
    if name == "qpsk":
        return QPSK(0.0, amplitude)
    if name == "qam16":
        return QAM(4, 0.0, amplitude)
    if name == "qam256":
        return QAM(8, 0.0, amplitude)
    if name == "msk":
        return MSK(amplitude, rates.samples_per_symbol)
    if name == "mfsk":
        return MFSK(4, 50, sr, amplitude, symbol_map="increase")
    if name == "16psk":
        return MPSK(4, 0.0, amplitude)
    if name == "oqpsk":
        return OQPSK(amplitude)
    if name == "dcqpsk":
        return DCQPSK(amplitude)
    if name == "16cpfsk":
        return CPFSK(4, rates, amplitude, 1)
    if name == "16apsk":
        return APSK(amplitude, 4, [
            Ring(0, 4, 0.5, pi / 4.0),
            Ring(4, 16, 1.0, pi / 12.0),
        ])
    if name == "dqpsk":
        return DMPSK(2, amplitude, pi / 4.0, pi / 2.0)
    if name == "dbpsk":
        return DMPSK(1, amplitude, pi / 4.0, pi)
    raise ValueError(f"invalid digital modulation {name!r}")
