"""The pulse-shaped bits -> waveform -> bits chain (counterpart of
:class:`modem_tpu.chain.PulseShapedChain` and
:func:`modem_tpu.chain.qpsk_reference_chain`).

bits -> constellation map -> RRC pulse shaping -> matched filter ->
symbol-instant decimation -> min-distance slice -> bits, at complex
baseband. Two forms, as in the JAX package:

* staged (``tx``, ``rx``, ``rx_soft``, ``decision_points``, ``roundtrip``):
  the readable cross-check, tensor ops around the FIR
  (:func:`~modem_tpu_torch.ops.fir.fir_filter`, kernel K4 on a CUDA device);
* fused (``tx_fused``, ``rx_fused``, ``rx_soft_fused``, ``roundtrip_fused``):
  the production path, one hand-written CUDA kernel per call on a CUDA
  device (:mod:`modem_tpu_torch.ops.txrx`,
  :mod:`modem_tpu_torch.ops.chain_kernel`).

The passband NCO leg and the other scheme families are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import Rates
from .cuda import resolve_device
from .models.base import LutScheme, Scheme
from .models.psk import QPSK
from .ops.chain_kernel import fused_pulse_chain
from .ops.filters import rrc_taps
from .ops.fir import fir_filter
from .ops.llr import lut_llr
from .ops.polyphase import polyphase_decim, polyphase_interp
from .ops.slicer import lut_map, lut_slice
from .ops.txrx import fused_rx, fused_tx
from .utils.bits import pack_bits, unpack_symbols


def upsample_zero_stuff(x: torch.Tensor, factor: int) -> torch.Tensor:
    """[..., K] -> [..., K*factor] with x[k] at position k*factor, zeros between."""
    u = torch.zeros(x.shape + (factor,), dtype=x.dtype, device=x.device)
    u[..., 0] = x
    return u.reshape(x.shape[:-1] + (x.shape[-1] * factor,))


def shape_iq(iq: torch.Tensor, rrc, sps: int, span: int, polyphase: bool):
    """Per-symbol I/Q ``[..., K, 2]`` -> RRC-shaped baseband ``(i, q)``
    ``[..., (K+span)*sps]``, ``span`` flush symbols appended."""
    flush = torch.zeros(iq.shape[:-2] + (span, 2), dtype=iq.dtype,
                        device=iq.device)
    iq = torch.cat([iq, flush], dim=-2)
    if polyphase:
        si, _ = polyphase_interp(iq[..., 0], rrc, sps)
        sq, _ = polyphase_interp(iq[..., 1], rrc, sps)
        return si, sq
    si, _ = fir_filter(upsample_zero_stuff(iq[..., 0], sps), rrc)
    sq, _ = fir_filter(upsample_zero_stuff(iq[..., 1], sps), rrc)
    return si, sq


def matched_decision_points(yi, yq, rrc, sps: int, span: int, n_symbols: int,
                            polyphase: bool):
    """Matched filter + symbol-instant sampling -> ``(di, dq) [..., K]``,
    decision instants ``span*sps + m*sps``."""
    d = span * sps
    if polyphase:
        return (polyphase_decim(yi, rrc, sps, d, n_symbols),
                polyphase_decim(yq, rrc, sps, d, n_symbols))
    yi, _ = fir_filter(yi, rrc)
    yq, _ = fir_filter(yq, rrc)
    idx = d + torch.arange(n_symbols, device=yi.device) * sps
    return yi[..., idx], yq[..., idx]


class PulseShapedChain(torch.nn.Module):
    """Matched-filter chain for constellation (LUT) schemes at baseband.

    ``scheme`` exposes ``lut`` ([M, 2]) and ``bits_per_symbol``; slicing is
    minimum-distance against the table. The TX appends ``span`` flush
    symbols so the matched filter's full response is observed; the total
    group delay is ``span*sps``. The table and the RRC taps are buffers on
    ``device``, the card unless the caller asks for the CPU; every tensor
    passed in must be there too.
    ``rrc`` replaces the designed taps (``span_symbols*sps + 1`` of them).
    """

    def __init__(self, scheme: Scheme, rates: Rates, span_symbols: int = 8,
                 beta: float = 0.35, polyphase: bool = False,
                 device: torch.device | str | None = None, rrc=None):
        super().__init__()
        if not hasattr(scheme, "lut"):
            raise TypeError("PulseShapedChain needs a constellation-LUT scheme")
        self.scheme = scheme
        self.rates = rates
        self.span = span_symbols
        self.sps = rates.samples_per_symbol
        #: polyphase=True computes the staged pulse shaping at symbol rate
        #: and the matched filter only at the decision instants
        self.polyphase = polyphase
        taps = rrc_taps(self.sps, span_symbols, beta) if rrc is None else rrc
        taps = np.asarray(taps, np.float32)
        if taps.shape != (span_symbols * self.sps + 1,):
            raise ValueError("rrc taps length must equal span*sps + 1")
        device = resolve_device(device)
        self.register_buffer("lut", torch.as_tensor(
            np.asarray(scheme.lut, np.float32), device=device))
        self.register_buffer("rrc", torch.as_tensor(taps, device=device))

    @classmethod
    def from_numpy(cls, params: dict, rates: Rates,
                   device: torch.device | str | None = None,
                   polyphase: bool = False) -> "PulseShapedChain":
        """Build from another chain's arrays: ``{"lut", "rrc",
        "bits_per_symbol", "span", "sps"}``, e.g. ``np.asarray`` of a
        :class:`modem_tpu.chain.PulseShapedChain`'s ``lut`` and ``rrc``, so
        that both filter and slice with the same numbers."""
        if params["sps"] != rates.samples_per_symbol:
            raise ValueError("params sps disagrees with rates")
        scheme = LutScheme(params["lut"], params["bits_per_symbol"])
        return cls(scheme, rates, span_symbols=int(params["span"]),
                   polyphase=polyphase, device=device, rrc=params["rrc"])

    @property
    def bits_per_symbol(self) -> int:
        return self.scheme.bits_per_symbol

    # ---- TX ----

    def map_symbols(self, bits: torch.Tensor) -> torch.Tensor:
        return pack_bits(bits, self.bits_per_symbol)

    def shape_pulses(self, symbols: torch.Tensor):
        """symbols [..., K] -> RRC-shaped baseband I/Q [..., (K+span)*sps]."""
        mi, mq = lut_map(symbols, self.lut)
        return shape_iq(torch.stack([mi, mq], dim=-1), self.rrc, self.sps,
                        self.span, self.polyphase)

    def tx(self, bits: torch.Tensor):
        """bits -> baseband ``(i, q)``."""
        return self.shape_pulses(self.map_symbols(bits))

    # ---- RX ----

    def decision_points(self, rx_wave, n_symbols: int):
        """waveform -> matched-filter outputs at the symbol instants
        ``(di, dq) [..., K]``."""
        yi, yq = rx_wave
        return matched_decision_points(yi, yq, self.rrc, self.sps, self.span,
                                       n_symbols, self.polyphase)

    def rx(self, rx_wave, n_symbols: int) -> torch.Tensor:
        """waveform -> decided bits [..., K*bps]."""
        di, dq = self.decision_points(rx_wave, n_symbols)
        return unpack_symbols(lut_slice(di, dq, self.lut), self.bits_per_symbol)

    def rx_soft(self, rx_wave, n_symbols: int,
                noise_var: float = 1.0) -> torch.Tensor:
        """waveform -> per-bit max-log LLRs ``[..., K*bps]`` (``noise_var`` =
        per-rail sigma^2 at the decision point, N0/2)."""
        di, dq = self.decision_points(rx_wave, n_symbols)
        return lut_llr(di, dq, self.lut, self.bits_per_symbol, noise_var)

    def roundtrip(self, bits: torch.Tensor) -> torch.Tensor:
        """Noiseless bits -> bits through the staged form."""
        return self.rx(self.tx(bits), bits.shape[-1] // self.bits_per_symbol)

    # ---- fused: the production path ----

    def tx_fused(self, bits: torch.Tensor):
        """bits -> baseband ``(i, q)`` through the fused TX (kernel K2 on
        CUDA): :meth:`tx` up to f32 reassociation."""
        return fused_tx(self.map_symbols(bits), self.lut, self.rrc, self.sps,
                        self.span)

    def rx_fused(self, rx_wave, n_symbols: int) -> torch.Tensor:
        """waveform -> decided bits through the fused RX (kernel K3 on
        CUDA); decisions equal :meth:`rx`."""
        syms = fused_rx(rx_wave, n_symbols, self.lut, self.rrc, self.sps,
                        self.span)
        return unpack_symbols(syms, self.bits_per_symbol)

    def rx_soft_fused(self, rx_wave, n_symbols: int,
                      noise_var: float = 1.0) -> torch.Tensor:
        """waveform -> per-bit LLRs: fused matched filter + decimation to the
        decision-point I/Q (kernel K3 on CUDA), then :func:`lut_llr`."""
        di, dq = fused_rx(rx_wave, n_symbols, self.lut, self.rrc, self.sps,
                          self.span, soft=True)
        return lut_llr(di, dq, self.lut, self.bits_per_symbol, noise_var)

    def roundtrip_fused(self, bits: torch.Tensor) -> torch.Tensor:
        """Noiseless bits -> bits through the fused loopback (kernel K1 on
        CUDA): the waveform never leaves the chip. Decisions match
        :meth:`roundtrip`."""
        dec = fused_pulse_chain(self.map_symbols(bits), self.lut, self.rrc,
                                self.sps, self.span)
        return unpack_symbols(dec, self.bits_per_symbol)


def qpsk_reference_chain(rates: Rates, span_symbols: int = 8,
                         beta: float = 0.35,
                         device: torch.device | str | None = None
                         ) -> PulseShapedChain:
    """The flagship: QPSK + RRC + matched filter at complex baseband
    (`BASELINE.json` config #2)."""
    return PulseShapedChain(QPSK(0.0, 1.0), rates, span_symbols, beta,
                            device=device)
