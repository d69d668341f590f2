"""Phase-shift keying family: BPSK, QPSK, OQPSK, pi/4-QPSK, MPSK, DMPSK
(counterpart of :mod:`modem_tpu.models.psk`).

The memoryless variants map through their constellation table
(:func:`modem_tpu_torch.ops.slicer.lut_map`); the two stateful ones become
prefix sums: DCQPSK's parity toggle (`dcqpsk.rs:42-44`) is the parity of the
global symbol index, and DMPSK's phase accumulator (`dmpsk.rs:29-33`) a
modular prefix sum in turns.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..config import TWO_PI
from ..ops.slicer import lut_map
from ..utils.bits import unpack_symbols
from ..utils.scan import cummod
from .base import IQProgram, Scheme, f32, stagger_bit_planes

_SQRT_HALF = math.sqrt(0.5)


def lut_program(lut, symbols: torch.Tensor) -> IQProgram:
    """The constellation point of each symbol as an IQ program."""
    i, q = lut_map(symbols, lut)
    return IQProgram(i=i, q=q)


class BPSK(Scheme):
    """i = sign(b)*A*cos(phase), q = sign(b)*A*sin(phase) (`bpsk.rs:17-31`)."""

    bits_per_symbol = 1

    def __init__(self, phase: float, amplitude: float):
        s = np.array([-1.0, 1.0])
        self.lut = np.stack(
            [s * amplitude * math.cos(phase), s * amplitude * math.sin(phase)], axis=-1
        )

    def program(self, symbols, state, rates, t0_mod):
        return lut_program(self.lut, symbols), state


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

    def program(self, symbols, state, rates, t0_mod):
        return lut_program(self.lut, symbols), state


class MPSK(Scheme):
    """M-ary PSK: phase = 2*pi*sym/M + offset (`mpsk.rs:23-41`).
    ``gray=True`` Gray-codes the phase index; the default is the
    reference's natural order."""

    def __init__(self, bits_per_symbol: int, phase_offset: float,
                 amplitude: float, gray: bool = False):
        self.bits_per_symbol = bits_per_symbol
        self.gray = bool(gray)
        m = 1 << bits_per_symbol
        idx = np.arange(m)
        if gray:
            s = idx.copy()
            shift = 1
            while (1 << shift) < m:
                s = s ^ (s >> shift)
                shift *= 2
            idx = s
        ph = TWO_PI * idx / m + phase_offset
        self.lut = np.stack(
            [amplitude * np.cos(ph), amplitude * np.sin(ph)], axis=-1
        ).astype(np.float32)

    def program(self, symbols, state, rates, t0_mod):
        return lut_program(self.lut, symbols), state


class DCQPSK(Scheme):
    """pi/4-QPSK: the QPSK phase map with a +pi/4 rotation on alternate
    symbols (`dcqpsk.rs:24-44`). The reference toggles ``even`` before each
    symbol, so symbol k (0-based, stream-global) is rotated iff k is even;
    the state is the count of symbols sent, mod 2."""

    bits_per_symbol = 2
    _MAP = np.array([0.0, math.pi / 2.0, 3.0 * math.pi / 2.0, math.pi])

    def __init__(self, amplitude: float):
        # lut[parity, sym]: parity 0 = rotated (+pi/4), matching k % 2 == 0
        ph = np.stack([self._MAP + math.pi / 4.0, self._MAP], axis=0)
        self.lut = np.stack(
            [amplitude * np.cos(ph), amplitude * np.sin(ph)], axis=-1
        ).astype(np.float32)

    def init_state(self, batch_shape=(), device=None):
        return torch.zeros(batch_shape, dtype=torch.int32, device=device)

    def program(self, symbols, state, rates, t0_mod):
        k = symbols.shape[-1]
        idx = torch.arange(k, dtype=torch.int32, device=symbols.device)
        parity = (state[..., None] + idx) % 2
        table = torch.as_tensor(self.lut, device=symbols.device)
        iq = table[parity.long(), symbols.long()]
        return IQProgram(i=iq[..., 0], q=iq[..., 1]), (state + k) % 2


class DMPSK(Scheme):
    """Differential M-ary PSK: each symbol advances the phase by sym*shift
    (`dmpsk.rs:29-41`), as a modular prefix sum in turns; the state is the
    phase in turns after the last symbol."""

    def __init__(self, bits_per_symbol: int, amplitude: float, phase: float,
                 shift: float):
        self.bits_per_symbol = bits_per_symbol
        self.amplitude = amplitude
        self.phase0_turns = (phase / TWO_PI) % 1.0
        self.shift_turns = shift / TWO_PI

    def init_state(self, batch_shape=(), device=None):
        return torch.full(batch_shape, self.phase0_turns, dtype=torch.float32,
                          device=device)

    def program(self, symbols, state, rates, t0_mod):
        # update() runs before the evaluation, so symbol k uses the phase
        # after its own increment (`modulator.rs:88-97`)
        delta = symbols.to(torch.float32) * f32(self.shift_turns)
        turns = (state[..., None] + cummod(delta, 1.0)) % 1.0
        theta = turns * f32(TWO_PI)
        amp = f32(self.amplitude)
        prog = IQProgram(i=amp * torch.cos(theta), q=amp * torch.sin(theta))
        return prog, turns[..., -1]


class OQPSK(Scheme):
    """Offset QPSK: i = sign(b0)*A/sqrt(2), q = sign(b1)*A/sqrt(2)
    (`oqpsk.rs:19-25`), the Q bit staggered half a symbol
    (`data.rs:81-123`); the state is the previous block's last Q bit."""

    bits_per_symbol = 2

    def __init__(self, amplitude: float):
        self.amp = amplitude * _SQRT_HALF

    def init_state(self, batch_shape=(), device=None):
        return torch.zeros(batch_shape, dtype=torch.int32, device=device)

    def program(self, symbols, state, rates, t0_mod):
        bits = unpack_symbols(symbols, 2)
        b0s, b1s, carry = stagger_bit_planes(bits[..., 0::2], bits[..., 1::2],
                                             state)
        amp = f32(self.amp)
        prog = IQProgram(
            i=(2 * b0s - 1).to(torch.float32) * amp,
            q=(2 * b1s - 1).to(torch.float32) * amp,
            slots_per_symbol=2,
        )
        return prog, carry
