"""GMSK: Gaussian minimum-shift keying, bits -> constant-envelope waveform
(counterpart of :mod:`modem_tpu.gmsk`).

The phase integral ``theta[n] = (pi/2/sps) * sum_k a_k * G[n - k*sps]``,
``G = cumsum(g)`` with ``g`` the Gaussian frequency pulse, splits into

* the delayed MSK ramp: an integer-exact backbone, a cumulative sum of the
  +-1 symbol signs in units of ``pi/2/sps`` carried mod ``4*sps`` across
  blocks (int32, so it never drifts);
* ``G_tr = G - G_sat``: a compact transient that returns to zero after
  every symbol, so its contribution is a causal FIR over the zero-stuffed
  symbol impulses (:func:`~modem_tpu_torch.ops.fir.fir_filter`, kernel K4 on
  a CUDA device) with the FIR tail as streaming state.

RX is the FSK-family discriminator: instantaneous frequency, per-symbol
window means at the pulse's group delay, sign decisions.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .config import Rates
from .cuda import resolve_device
from .models.base import f32
from .ops.fir import fir_filter
from .ops.slicer import fm_discriminate
from .tx import tree_to_torch


@lru_cache(maxsize=16)
def gmsk_pulse(bt: float, sps: int, span: int):
    """``(g, G_tr, D)``: the Gaussian frequency pulse ``g`` (``span*sps``
    taps, ``sum g = sps``), the compact cumsum transient ``G_tr`` and the
    backbone delay ``D`` in samples, as numpy float32 arrays and an int.

    ``g = rect(sps) * gauss(BT)``, the Gaussian's sigma
    ``sps * sqrt(ln 2) / (2*pi*BT)``, truncated to ``span`` symbols and
    renormalized."""
    if span < 2:
        raise ValueError("GMSK needs span >= 2 symbols of pulse support")
    sigma = sps * np.sqrt(np.log(2.0)) / (2.0 * np.pi * bt)
    m = (span - 1) * sps
    t = np.arange(m + 1, dtype=np.float64) - m / 2.0
    h = np.exp(-0.5 * (t / sigma) ** 2)
    h /= h.sum()
    g = np.convolve(np.ones(sps), h)          # length span*sps
    g *= sps / g.sum()
    gc = np.cumsum(g)
    n = g.size
    d = (n - sps) // 2
    ramp = np.clip(np.arange(1, n + 1, dtype=np.float64) - d, 0, sps)
    g_tr = (gc - ramp).astype(np.float32)
    return g.astype(np.float32), g_tr, d


class GmskChain:
    """GMSK bits -> bits chain with streaming state (1 bit per symbol).

    ``bt``: the Gaussian filter's 3-dB bandwidth x symbol time (0.3 = GSM);
    ``span``: pulse support in symbols. :meth:`tx` appends ``span`` flush
    symbols so the last bit's pulse lands in the waveform. Builds on
    ``device``, the card unless the caller asks for the CPU.
    """

    bits_per_symbol = 1

    def __init__(self, rates: Rates, bt: float = 0.3, span: int = 4,
                 amplitude: float = 1.0, guard: int = 1,
                 device: torch.device | str | None = None):
        sps = rates.samples_per_symbol
        if guard < 1 or guard >= sps:
            raise ValueError("need 1 <= guard < samples_per_symbol")
        self.rates = rates
        self.bt = float(bt)
        self.span = int(span)
        self.amplitude = float(amplitude)
        self.guard = int(guard)
        self.sps = sps
        self.device = resolve_device(device)
        _, g_tr, self._delay = gmsk_pulse(self.bt, sps, self.span)
        self._g_tr = torch.as_tensor(g_tr, device=self.device)

    def init_state(self, batch_shape: tuple = ()) -> dict:
        """Streaming state: the integer backbone phase (units of pi/2/sps,
        mod 4*sps), the delayed-backbone buffer and the transient FIR tail,
        with the JAX package's dtypes."""
        d, n_taps = self._delay, self._g_tr.shape[0]
        dev = self.device
        return {
            "u": torch.zeros(batch_shape, dtype=torch.int32, device=dev),
            "ubuf": torch.zeros(batch_shape + (d,), dtype=torch.int32,
                                device=dev),
            "fir": torch.zeros(batch_shape + (n_taps - 1,),
                               dtype=torch.float32, device=dev),
        }

    @staticmethod
    def state_from_numpy(state: dict, device=None) -> dict:
        """A :class:`modem_tpu.gmsk.GmskChain` state (every leaf through
        ``np.asarray``) as this chain's, so a stream started there goes on
        here."""
        return tree_to_torch(state, resolve_device(device))

    def _core(self, a: torch.Tensor, state: dict):
        """Signs ``a [..., K]`` (int32, 0 for flush) -> I/Q ``[..., K*sps]``
        and the new state."""
        sps = self.sps
        n = a.shape[-1] * sps
        r = torch.repeat_interleave(a, sps, dim=-1)
        u = (state["u"][..., None]
             + torch.cumsum(r, dim=-1, dtype=torch.int32)) % (4 * sps)
        ud = torch.cat([state["ubuf"], u], dim=-1)
        stuffed = torch.zeros(a.shape + (sps,), dtype=torch.float32,
                              device=a.device)
        stuffed[..., 0] = a
        delta, fir = fir_filter(stuffed.reshape(a.shape[:-1] + (n,)),
                                self._g_tr, state["fir"])
        theta = (ud[..., :n].to(torch.float32) + delta) * f32(np.pi / 2.0 / sps)
        new_state = {"u": u[..., -1], "ubuf": ud[..., n:], "fir": fir}
        return (self.amplitude * torch.cos(theta),
                self.amplitude * torch.sin(theta), new_state)

    def tx_stream(self, bits: torch.Tensor, state: dict):
        """``[..., K]`` bits -> ``(i, q, new_state)``, ``K*sps`` samples;
        chunked equals one shot bit for bit."""
        return self._core(2 * bits.to(torch.int32) - 1, state)

    def tx(self, bits: torch.Tensor):
        """One-shot TX with ``span`` zero flush symbols appended:
        ``[..., (K+span)*sps]`` samples."""
        i0, q0, st = self.tx_stream(bits, self.init_state(bits.shape[:-1]))
        flush = torch.zeros(bits.shape[:-1] + (self.span,), dtype=torch.int32,
                            device=bits.device)
        i1, q1, _ = self._core(flush, st)
        return torch.cat([i0, i1], dim=-1), torch.cat([q0, q1], dim=-1)

    def _symbol_means(self, i: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
        sps, d = self.sps, self._delay
        k = i.shape[-1] // sps - self.span
        if k < 1:
            raise ValueError("waveform shorter than the flush tail")
        inst = fm_discriminate(i, q)
        x = inst[..., d:d + k * sps].reshape(inst.shape[:-1] + (k, sps))
        return torch.mean(x[..., self.guard:], dim=-1)

    def rx(self, i: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
        """Waveform (as from :meth:`tx`) -> decided bits: discriminator,
        per-symbol window means at the pulse delay, sign."""
        return (self._symbol_means(i, q) > 0).to(torch.int32)

    def rx_soft(self, i: torch.Tensor, q: torch.Tensor,
                noise_var: float = 1.0) -> torch.Tensor:
        """Waveform -> per-bit LLRs ``-2*mu*m/noise_var``, ``mu = pi/2/sps``
        (positive = bit 0); the sign gives :meth:`rx`'s bits."""
        mu = np.pi / 2.0 / self.sps
        return -2.0 * mu * self._symbol_means(i, q) / noise_var

    def roundtrip(self, bits: torch.Tensor) -> torch.Tensor:
        return self.rx(*self.tx(bits))
