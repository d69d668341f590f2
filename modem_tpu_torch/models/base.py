"""Scheme base class and the baseband programs (counterpart of
:mod:`modem_tpu.models.base`).

Every scheme compiles a block of symbols into one of two small per-slot
programs, and :func:`synthesize` expands either to per-sample I/Q:

* :class:`IQProgram`: constant I/Q per slot (ASK/PSK/QAM/APSK, and the
  differential PSKs after a prefix sum);
* :class:`PhaseProgram`: per-slot integer frequency and phase numerators of
  a static denominator ``den`` (the FSK family and MSK),

      theta(s) = 2*pi * ((fnum * (t(s) mod den) + pnum) mod den) / den
      i(s) = gi * cos(theta)        q(s) = gq * cos(theta + qshift)

A slot is a symbol, or half a symbol for the staggered MSK/OQPSK sources.
``time_offset=1`` reproduces the reference modulator's indexing (the phasor is
evaluated at ``s+1``, `carrier.rs:21-26`, `modulator.rs:85-100`). Integer
programs and states keep the JAX package's int32 dtype.

Constellation schemes also carry ``lut``, the ``[M, 2]`` float32 table that
the pulse-shaped chain and its kernels read.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..config import TWO_PI, Rates


@dataclasses.dataclass
class IQProgram:
    """Per-slot constant baseband I/Q, ``[..., n_slots]`` each."""

    i: torch.Tensor
    q: torch.Tensor
    slots_per_symbol: int = 1


@dataclasses.dataclass
class PhaseProgram:
    """Per-slot integer phase trajectory (see the module docstring)."""

    gi: torch.Tensor  # [..., n_slots] f32 gain on the cos (I) arm
    gq: torch.Tensor  # [..., n_slots] f32 gain on the Q arm
    fnum: torch.Tensor  # [..., n_slots] int32 frequency numerator
    pnum: torch.Tensor  # [..., n_slots] int32 phase numerator, in [0, den)
    den: int  # static denominator (phase units per turn)
    qshift: float = -0.25 * TWO_PI  # cos(theta - pi/2) = sin(theta)
    slots_per_symbol: int = 1


class Scheme:
    """Base for all modulation schemes: subclasses set ``bits_per_symbol``
    and implement :meth:`program`; constellation schemes also set ``lut``.
    The object is static configuration; runtime state is what
    :meth:`init_state` returns."""

    bits_per_symbol: int
    #: static phase denominator of PhaseProgram schemes (0 = IQ scheme)
    den: int = 0

    def init_state(self, batch_shape: tuple[int, ...] = (), device=None
                   ) -> Any:
        """Streaming state carried across blocks (``()`` if stateless)."""
        return ()

    def program(self, symbols: torch.Tensor, state: Any, rates: Rates,
                t0_mod: torch.Tensor | int
                ) -> tuple[IQProgram | PhaseProgram, Any]:
        """Compile a ``[..., K]`` int32 symbol block into a baseband
        program; ``t0_mod`` is the block's first sample index modulo
        ``self.den`` (ignored by IQ schemes)."""
        raise NotImplementedError


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


def f32(x: float) -> float:
    """``x`` rounded to float32, as the JAX package's ``jnp.float32``
    constants are."""
    return float(np.float32(x))


def _expand(a: torch.Tensor, slot_len: int) -> torch.Tensor:
    """Repeat each slot value ``slot_len`` times along the last axis (a
    symbol's value held for its samples, `rates.rs:16`, `data.rs:14-33`)."""
    if slot_len == 1:
        return a
    return torch.repeat_interleave(a, slot_len, dim=-1)


def synthesize(prog: IQProgram | PhaseProgram, sps: int,
               t0_mod: torch.Tensor | int = 0, time_offset: int = 1
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Expand a baseband program to per-sample I/Q
    ``[..., n_slots*slot_len]``; an IQ program evaluates no trig at all."""
    slot_len = sps // prog.slots_per_symbol
    if slot_len * prog.slots_per_symbol != sps:
        raise ValueError(
            f"sps={sps} not divisible by {prog.slots_per_symbol} slots")
    if isinstance(prog, IQProgram):
        return _expand(prog.i, slot_len), _expand(prog.q, slot_len)

    den = prog.den
    n = prog.fnum.shape[-1] * slot_len
    # t(s) = s + time_offset mod den; fnum*t + pnum stays in int32 while
    # max|fnum| * den < 2^31 (checked by the scheme constructors)
    t = (torch.arange(n, dtype=torch.int32, device=prog.fnum.device)
         + t0_mod + time_offset) % den
    u = (_expand(prog.fnum, slot_len) * t + _expand(prog.pnum, slot_len)) % den
    theta = u.to(torch.float32) * f32(TWO_PI / den)
    i = _expand(prog.gi, slot_len) * torch.cos(theta)
    q = _expand(prog.gq, slot_len) * torch.cos(theta + f32(prog.qshift))
    return i, q


def stagger_bit_planes(b0: torch.Tensor, b1: torch.Tensor,
                       prev_b1: torch.Tensor):
    """Half-symbol staggering for MSK/OQPSK (`EvenOddOffset`,
    `data.rs:81-123`) as a shift of the Q plane on the half-symbol grid:
    slot 2m -> (b0[m], b1[m-1]), slot 2m+1 -> (b0[m], b1[m]), with
    ``b1[-1] = prev_b1`` (0 on the first block). Returns the per-slot planes
    ``[..., 2K]`` and the carry for the next block."""
    k = b0.shape[-1]
    b0_slots = _expand(b0, 2)
    first = prev_b1[..., None].expand(b1.shape[:-1] + (1,)).to(b1.dtype)
    b1_shift = torch.cat([first, b1[..., :-1]], dim=-1)
    b1_slots = torch.stack([b1_shift, b1], dim=-1).reshape(
        b1.shape[:-1] + (2 * k,))
    return b0_slots, b1_slots, b1[..., -1]
