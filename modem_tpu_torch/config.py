"""Static configuration types of the port (counterpart of
:mod:`modem_tpu.config`, re-expressed so that this package never imports the
JAX one)."""

from __future__ import annotations

import dataclasses
import math

TWO_PI = 2.0 * math.pi


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


@dataclasses.dataclass(frozen=True)
class Freq:
    """A frequency in Hz tied to a sample rate (`freq.rs:11-26`)."""

    hz: int
    sr: int

    @property
    def ang_freq(self) -> float:
        """Radians per second (`freq.rs:19-21`)."""
        return TWO_PI * self.hz

    @property
    def sample_freq(self) -> float:
        """Radians per sample (`freq.rs:24-26`)."""
        return self.ang_freq / self.sr


def mod_trig(x: float) -> float:
    """x mod 2pi via floor, matching `util.rs:3-6` (host-side helper)."""
    return x - TWO_PI * math.floor(x / TWO_PI)
