"""Block modulator: the transmitter (counterpart of :mod:`modem_tpu.tx`).

The reference's per-sample iterator chain (`DigitalModulator`,
`modulator.rs:64-101`) as a block transform over ``[channels, n]`` tensors:

    bits -> pack to symbols -> scheme.program -> synthesize -> NCO mix

The streaming state (sample counters reduced mod their periods, and the
scheme's own accumulators) is an explicit :class:`TxState` of tensors on the
modulator's device, so a long stream runs block by block with bit-stable
continuity. The JAX package computes the TX with XLA and no Pallas kernel;
so does this one, with plain tensor ops.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from .config import Rates
from .cuda import resolve_device
from .models.base import Scheme, synthesize
from .ops.nco import carrier_phase, mix_up
from .utils.bits import pack_bits

#: Reference modulator indexing quirk: phasor timestamps lead the carrier phase
#: by one sample (`carrier.rs:21-26` post-increment vs `modulator.rs:85-100`).
REF_TIME_OFFSET = 1


def tree_to_torch(tree: Any, device) -> Any:
    """A state pytree (dicts, tuples, lists, arrays) with every leaf as a
    tensor on ``device``, dtypes kept."""
    if isinstance(tree, dict):
        return {k: tree_to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_to_torch(v, device) for v in tree)
    if torch.is_tensor(tree):
        return tree.to(device)
    return torch.as_tensor(np.asarray(tree), device=device)


@dataclasses.dataclass
class TxState:
    """Streaming carry: the sample index mod the carrier period and mod the
    scheme's phase denominator (0-d int32 tensors), plus the scheme's own
    accumulator pytree."""

    s_mod_sr: torch.Tensor
    s_mod_den: torch.Tensor
    scheme: Any

    @classmethod
    def from_numpy(cls, state, device=None) -> "TxState":
        """From the numpy form of a :class:`modem_tpu.tx.TxState` (every leaf
        through ``np.asarray``), so a stream started there goes on here."""
        device = resolve_device(device)
        return cls(tree_to_torch(state.s_mod_sr, device),
                   tree_to_torch(state.s_mod_den, device),
                   tree_to_torch(state.scheme, device))


class Modulator:
    """Digital block modulator for one scheme + rate + carrier configuration.

    ``carrier_hz`` may be None for pure-baseband (``--iq``) use; the passband
    methods then raise. The object is static configuration on ``device``
    (the card unless the caller asks for the CPU); :meth:`init_state` gives
    the runtime carry.
    """

    def __init__(self, scheme: Scheme, rates: Rates,
                 carrier_hz: int | None = None,
                 device: torch.device | str | None = None):
        self.scheme = scheme
        self.rates = rates
        self.carrier_hz = carrier_hz
        if carrier_hz is not None and not carrier_hz < rates.sample_rate / 2:
            raise ValueError("carrier must satisfy Nyquist")  # `modulate.rs:68`
        self.den = scheme.den if scheme.den else rates.sample_rate
        self.device = resolve_device(device)

    def init_state(self, batch_shape: tuple[int, ...] = ()) -> TxState:
        zero = torch.zeros((), dtype=torch.int32, device=self.device)
        return TxState(s_mod_sr=zero, s_mod_den=zero.clone(),
                       scheme=self.scheme.init_state(batch_shape, self.device))

    def _advance(self, state: TxState, n: int) -> TxState:
        sr = self.rates.sample_rate
        return TxState(
            s_mod_sr=(state.s_mod_sr + n % sr) % sr,
            s_mod_den=(state.s_mod_den + n % self.den) % self.den,
            scheme=state.scheme,
        )

    def baseband(self, bits: torch.Tensor, state: TxState
                 ) -> tuple[tuple[torch.Tensor, torch.Tensor], TxState]:
        """bits ``[..., K*bps]`` -> baseband I/Q ``[..., K*sps]`` (``--iq``
        mode, `modulate.rs:109-116`)."""
        symbols = pack_bits(bits, self.scheme.bits_per_symbol)
        prog, scheme_state = self.scheme.program(
            symbols, state.scheme, self.rates, state.s_mod_den)
        sps = self.rates.samples_per_symbol
        i, q = synthesize(prog, sps, state.s_mod_den, REF_TIME_OFFSET)
        new_state = self._advance(
            TxState(state.s_mod_sr, state.s_mod_den, scheme_state),
            symbols.shape[-1] * sps)
        return (i, q), new_state

    def passband(self, bits: torch.Tensor, state: TxState
                 ) -> tuple[torch.Tensor, TxState]:
        """bits -> real passband waveform (`modulate.rs:128-133`):
        ``re = i*cos(theta_c) - q*sin(theta_c)``."""
        if self.carrier_hz is None:
            raise ValueError("passband output requires a carrier")
        (i, q), new_state = self.baseband(bits, state)
        theta = carrier_phase(self.carrier_hz, self.rates.sample_rate,
                              i.shape[-1], state.s_mod_sr)
        re, _ = mix_up(i, q, theta)
        return re, new_state

    def preamble(self, cycles: int, state: TxState
                 ) -> tuple[torch.Tensor, TxState]:
        """Carrier sync tone: ``sr/cf * cycles - 1`` samples of
        ``cos(theta(s))`` (`modulate.rs:118-126`). Advances the sample
        counter so the digital stream continues the preamble's phase
        (`modulate.rs:71,120,128`)."""
        if self.carrier_hz is None:
            raise ValueError("preamble requires a carrier")
        sr = self.rates.sample_rate
        if sr % self.carrier_hz != 0:
            raise ValueError("preamble requires sr % carrier == 0")  # `modulate.rs:62`
        n = sr // self.carrier_hz * cycles - 1
        theta = carrier_phase(self.carrier_hz, sr, n, state.s_mod_sr)
        return torch.cos(theta), self._advance(state, n)
