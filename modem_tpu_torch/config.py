"""Static configuration types of the port (counterpart of
:mod:`modem_tpu.config`, re-expressed so that this package never imports the
JAX one)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Rates:
    """Symbol/sample rate pair.

    Mirrors the reference's `rates.rs:12-18`: ``samples_per_symbol`` uses
    integer division, so ``sample_rate`` should normally be a multiple of
    ``baud_rate``.
    """

    baud_rate: int
    sample_rate: int

    def __post_init__(self):
        if self.baud_rate <= 0 or self.sample_rate <= 0:
            raise ValueError("rates must be positive")
        if self.sample_rate < self.baud_rate:
            raise ValueError("sample_rate must be >= baud_rate")

    @property
    def samples_per_symbol(self) -> int:
        return self.sample_rate // self.baud_rate
