"""Scheme base class of the port (counterpart of :mod:`modem_tpu.models.base`).

The slice ported so far runs constellation schemes only: a scheme is its
``bits_per_symbol`` and its ``lut``, the ``[M, 2]`` float32 table of (i, q)
points indexed by the MSB-first bit pattern. The JAX package's IQ and phase
programs, which the other families need, are not ported yet.
"""

from __future__ import annotations

import numpy as np


class Scheme:
    """Base for all modulation schemes: subclasses set ``bits_per_symbol``,
    and constellation schemes also set ``lut``."""

    bits_per_symbol: int


class LutScheme(Scheme):
    """A constellation scheme given by its table alone, for chains built from
    another package's parameters (:meth:`modem_tpu_torch.chain
    .PulseShapedChain.from_numpy`)."""

    def __init__(self, lut, bits_per_symbol: int):
        lut = np.asarray(lut, np.float32)
        if lut.ndim != 2 or lut.shape[1] != 2:
            raise ValueError("lut must be [M, 2]")
        if lut.shape[0] != 1 << bits_per_symbol:
            raise ValueError(
                f"lut has {lut.shape[0]} points, expected 2^{bits_per_symbol}")
        self.bits_per_symbol = int(bits_per_symbol)
        self.lut = lut
