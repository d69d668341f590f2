"""Direct-sequence spread spectrum around any constellation chain
(counterpart of :mod:`modem_tpu.dsss`).

Each symbol is multiplied by a ±1 PN sequence of ``spread_factor`` chips,
spreading its energy over ``L`` x the bandwidth; the receiver's correlator
concentrates it back (processing gain ``L``) while narrowband interference
stays spread and is rejected by the same factor.

* TX: map symbols through the constellation table
  (:func:`~modem_tpu_torch.ops.slicer.lut_map`), tile each point over its
  ``L`` chips times the PN plane, then the chip stream rides the RRC pulse
  shaping of the chains (:func:`~modem_tpu_torch.chain.shape_iq`) at chip
  rate: kernel K4 on a CUDA device, one launch a rail;
* RX: the matched filter at the chip instants
  (:func:`~modem_tpu_torch.chain.matched_decision_points`, K4 again, one
  launch a rail), then the PN correlator, a ``[K, L] x [L]`` contraction as
  float32 products summed (no TF32 setting rounds it).

``Rates`` here is the CHIP rate config (``samples_per_symbol`` samples per
chip); the symbol rate is ``baud / spread_factor``. The PN is the JAX
package's seeded Bernoulli sequence, made on the host by the same
``numpy`` calls, so both packages spread with the same chips; pass ``pn``
for a standard's code (Gold, Barker).
"""

from __future__ import annotations

import numpy as np
import torch

from .chain import matched_decision_points, shape_iq
from .config import Rates
from .cuda import resolve_device
from .ops.filters import rrc_taps
from .ops.llr import lut_llr
from .ops.slicer import lut_map, lut_slice
from .utils.bits import pack_bits, unpack_symbols


class DsssChain(torch.nn.Module):
    """Spread-spectrum bits->bits chain over any LUT scheme.

    ``spread_factor``: chips per symbol (the processing gain). ``pn``:
    optional explicit ±1 chip sequence ``[spread_factor]``; defaults to a
    seeded random sequence. The table, the RRC taps and the PN sequence are
    buffers on ``device``, the card unless the caller asks for the CPU;
    every tensor passed in must be there too.
    """

    def __init__(self, scheme, rates: Rates, spread_factor: int,
                 span_symbols: int = 8, beta: float = 0.35,
                 pn: np.ndarray | None = None, seed: int = 7,
                 device: torch.device | str | None = None):
        super().__init__()
        if not hasattr(scheme, "lut"):
            raise TypeError("DsssChain needs a constellation-LUT scheme")
        if spread_factor < 2:
            raise ValueError("spread_factor must be >= 2")
        self.scheme = scheme
        self.rates = rates
        self.l = int(spread_factor)
        self.span = span_symbols
        self.sps = rates.samples_per_symbol  # samples per CHIP
        if pn is None:
            rng = np.random.default_rng(seed)
            pn = 2.0 * rng.integers(0, 2, self.l) - 1.0
        pn = np.asarray(pn, np.float32)
        if pn.shape != (self.l,) or not np.all(np.abs(pn) == 1.0):
            raise ValueError(f"pn must be ±1 of length {self.l}")
        device = resolve_device(device)
        self.register_buffer("rrc", torch.as_tensor(
            np.asarray(rrc_taps(self.sps, span_symbols, beta), np.float32),
            device=device))
        self.register_buffer("lut", torch.as_tensor(
            np.asarray(scheme.lut, np.float32), device=device))
        self.register_buffer("pn", torch.as_tensor(pn, device=device))
        #: the correlator's weights, ``pn / L`` rounded as the JAX package's
        self.register_buffer("_pn_l", torch.as_tensor(pn / self.l,
                                                      device=device))

    # ------------------------------------------------------------------

    def _spread(self, bits: torch.Tensor):
        syms = pack_bits(bits, self.scheme.bits_per_symbol)
        mi, mq = lut_map(syms, self.lut)           # [..., K]
        ci = (mi[..., None] * self.pn).reshape(mi.shape[:-1] + (-1,))
        cq = (mq[..., None] * self.pn).reshape(mq.shape[:-1] + (-1,))
        return ci, cq                                # [..., K*L] chips

    def tx(self, bits: torch.Tensor):
        """bits -> chip-rate RRC baseband, ``(K*L + span) * sps`` samples."""
        ci, cq = self._spread(bits)
        return shape_iq(torch.stack([ci, cq], dim=-1), self.rrc, self.sps,
                        self.span, polyphase=False)

    def _despread(self, i: torch.Tensor, q: torch.Tensor, n_symbols: int):
        """Waveform -> symbol decision points: matched filter at chip
        instants, then the PN correlator."""
        di, dq = matched_decision_points(
            i, q, self.rrc, self.sps, self.span, n_symbols * self.l,
            polyphase=False)
        shp = di.shape[:-1] + (n_symbols, self.l)
        return ((di.reshape(shp) * self._pn_l).sum(-1),
                (dq.reshape(shp) * self._pn_l).sum(-1))

    def rx(self, rx_wave, n_symbols: int) -> torch.Tensor:
        i, q = rx_wave
        di, dq = self._despread(i, q, n_symbols)
        syms = lut_slice(di, dq, self.lut)
        return unpack_symbols(syms, self.scheme.bits_per_symbol)

    def rx_soft(self, rx_wave, n_symbols: int,
                noise_var: float = 1.0) -> torch.Tensor:
        """``noise_var`` is the per-rail chip-level variance; the
        correlator averages it down by the processing gain L."""
        i, q = rx_wave
        di, dq = self._despread(i, q, n_symbols)
        return lut_llr(di, dq, self.lut, self.scheme.bits_per_symbol,
                       noise_var / self.l)

    def roundtrip(self, bits: torch.Tensor) -> torch.Tensor:
        return self.rx(self.tx(bits), bits.shape[-1]
                       // self.scheme.bits_per_symbol)
