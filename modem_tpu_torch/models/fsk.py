"""Frequency-shift keying family: BFSK, MFSK, CPFSK, MSK (counterpart of
:mod:`modem_tpu.models.fsk`).

Each compiles to a :class:`~modem_tpu_torch.models.base.PhaseProgram` whose
phase is exact integer arithmetic in units of ``1/sr`` turns: every
continuity correction of the reference's accumulators (`bfsk.rs:43-55`,
`mfsk.rs:68-75`) is an integer multiple of ``dev_hz * t / sr`` turns, so
they become modular prefix sums (:func:`~modem_tpu_torch.utils.scan.cummod`)
with no drift. The reference modulator calls ``update`` after the carrier's
post-increment (`modulator.rs:85-97`), so the k-th symbol boundary observes
``t_k = k*sps + 1``.
"""

from __future__ import annotations

import torch

from ..config import Rates
from ..utils.bits import max_symbol, unpack_symbols
from ..utils.scan import cummod
from .base import PhaseProgram, Scheme, f32, stagger_bit_planes

_INT32_MAX = 2**31 - 1


def _check_range(max_fnum: int, den: int):
    if max_fnum * den > _INT32_MAX:
        raise ValueError(
            f"fnum*den = {max_fnum}*{den} would overflow int32 phase arithmetic"
        )


def _boundary_times(k: int, sps: int, sr: int, t0_mod, device
                    ) -> torch.Tensor:
    """t_k = (t0 + k*sps + 1) mod sr for k in [0, K), int32."""
    idx = (torch.arange(k, dtype=torch.int32, device=device) * (sps % sr)) % sr
    return (idx + t0_mod + 1) % sr


def _previous(first: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``x`` shifted one step later along the last axis, ``first`` in front."""
    return torch.cat([first[..., None].expand(x.shape[:-1] + (1,)),
                      x[..., :-1]], dim=-1)


class BFSK(Scheme):
    """Binary FSK: theta = b*w_dev*t + phi (`bfsk.rs:23-29`), phi adjusted
    on each bit flip (`bfsk.rs:43-55`): a flip to 1 subtracts ``w_dev*t_k``,
    a flip to 0 adds ``w_dev*(t_k - 1)``."""

    bits_per_symbol = 1

    def __init__(self, deviation_hz: int, sample_rate: int, amplitude: float):
        self.dev = int(deviation_hz)
        self.den = int(sample_rate)
        self.amplitude = amplitude
        _check_range(self.dev, self.den)

    def init_state(self, batch_shape=(), device=None):
        zeros = torch.zeros(batch_shape, dtype=torch.int32, device=device)
        # `bfsk.rs:19` prev = 0; the phase in units of 1/sr turn
        return {"prev": zeros, "pnum": zeros.clone()}

    def program(self, symbols, state, rates, t0_mod):
        sr, dev = self.den, self.dev
        t_k = _boundary_times(symbols.shape[-1], rates.samples_per_symbol, sr,
                              t0_mod, symbols.device)
        b = symbols.to(torch.int32)
        prev = _previous(state["prev"], b)
        flip_to_1 = (b == 1) & (prev == 0)
        flip_to_0 = (b == 0) & (prev == 1)
        zero = torch.zeros((), dtype=torch.int32, device=b.device)
        delta = torch.where(flip_to_1, (-dev * t_k) % sr,
                            torch.where(flip_to_0, (dev * (t_k - 1)) % sr,
                                        zero))
        pnum = (state["pnum"][..., None] + cummod(delta, sr)) % sr
        amp = torch.full(b.shape, self.amplitude, dtype=torch.float32,
                         device=b.device)
        prog = PhaseProgram(gi=amp, gq=amp, fnum=b * dev, pnum=pnum, den=sr)
        return prog, {"prev": b[..., -1], "pnum": pnum[..., -1]}


class MFSK(Scheme):
    """M-ary FSK: theta = coef(sym)*w_dev*t + phi (`mfsk.rs:60-82`), with
    phi += (coef_prev - coef_new)*w_dev*t_k at each boundary
    (`mfsk.rs:68-75`). ``symbol_map``: 'default' = 2s - max
    (`mfsk.rs:13-27`), 'increase' = 2s (`mfsk.rs:29-35`)."""

    def __init__(self, bits_per_symbol: int, deviation_hz: int,
                 sample_rate: int, amplitude: float,
                 symbol_map: str = "default"):
        self.bits_per_symbol = bits_per_symbol
        self.dev = int(deviation_hz)
        self.den = int(sample_rate)
        self.amplitude = amplitude
        if symbol_map not in ("default", "increase"):
            raise ValueError(f"unknown symbol map {symbol_map!r}")
        self.symbol_map = symbol_map
        self.max_sym = max_symbol(bits_per_symbol)
        _check_range(2 * self.max_sym * self.dev, self.den)

    def coef(self, symbols: torch.Tensor) -> torch.Tensor:
        s = symbols.to(torch.int32)
        if self.symbol_map == "increase":
            return 2 * s
        return 2 * s - self.max_sym

    def init_state(self, batch_shape=(), device=None):
        zeros = torch.zeros(batch_shape, dtype=torch.int32, device=device)
        # `mfsk.rs:57`: the coefficient starts at 0
        return {"cur_coef": zeros, "pnum": zeros.clone()}

    def program(self, symbols, state, rates, t0_mod):
        sr, dev = self.den, self.dev
        t_k = _boundary_times(symbols.shape[-1], rates.samples_per_symbol, sr,
                              t0_mod, symbols.device)
        coef = self.coef(symbols)
        cprev = _previous(state["cur_coef"], coef)
        # |cprev - coef| * dev * t_k <= 2*max_sym*dev*(sr-1) < 2^31 (checked
        # in __init__): exact in int32
        delta = (cprev - coef) * dev * t_k
        pnum = (state["pnum"][..., None] + cummod(delta, sr)) % sr
        amp = torch.full(coef.shape, self.amplitude, dtype=torch.float32,
                         device=coef.device)
        prog = PhaseProgram(gi=amp, gq=amp, fnum=coef * dev, pnum=pnum, den=sr)
        return prog, {"cur_coef": coef[..., -1], "pnum": pnum[..., -1]}


class CPFSK(Scheme):
    """Continuous-phase FSK: theta = 2*sym*w*t with w from
    ``Freq(deviation*baud/2, sr)`` (`cpfsk.rs:17-31`). Stateless: each
    symbol advances the phase by whole turns."""

    def __init__(self, bits_per_symbol: int, rates: Rates, amplitude: float,
                 deviation: int):
        self.bits_per_symbol = bits_per_symbol
        self.dev_hz = deviation * rates.baud_rate // 2  # `cpfsk.rs:20-21`
        self.den = rates.sample_rate
        self.amplitude = amplitude
        _check_range(2 * max_symbol(bits_per_symbol) * self.dev_hz, self.den)

    def program(self, symbols, state, rates, t0_mod):
        fnum = 2 * symbols.to(torch.int32) * self.dev_hz
        amp = torch.full(symbols.shape, self.amplitude, dtype=torch.float32,
                         device=symbols.device)
        prog = PhaseProgram(gi=amp, gq=amp, fnum=fnum,
                            pnum=torch.zeros_like(fnum), den=self.den)
        return prog, state


class MSK(Scheme):
    """Minimum-shift keying (`msk.rs:12-35`): i = A*sign(b0)*cos(pi*t/(2*spb)),
    q = -A*sign(b1)*sin(pi*t/(2*spb)) with spb = sps/2 and the b1 plane
    staggered half a symbol (`modulate.rs:101-107`). The envelope's period
    is 4*spb samples: den = 2*sps, fnum = 1."""

    bits_per_symbol = 2

    def __init__(self, amplitude: float, samples_per_symbol: int):
        if samples_per_symbol % 2 != 0:
            raise ValueError("MSK requires even samples_per_symbol")  # `msk.rs:13`
        self.amplitude = amplitude
        self.den = 2 * samples_per_symbol

    def init_state(self, batch_shape=(), device=None):
        # the previous block's last b1
        return torch.zeros(batch_shape, dtype=torch.int32, device=device)

    def program(self, symbols, state, rates, t0_mod):
        bits = unpack_symbols(symbols, 2)
        b0s, b1s, carry = stagger_bit_planes(bits[..., 0::2], bits[..., 1::2],
                                             state)
        amp = f32(self.amplitude)
        gi = (2 * b0s - 1).to(torch.float32) * amp
        gq = -(2 * b1s - 1).to(torch.float32) * amp
        ones = torch.ones(b0s.shape, dtype=torch.int32, device=b0s.device)
        prog = PhaseProgram(gi=gi, gq=gq, fnum=ones,
                            pnum=torch.zeros_like(ones), den=self.den,
                            slots_per_symbol=2)
        return prog, carry
