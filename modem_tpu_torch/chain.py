"""End-to-end bits -> waveform -> bits chains (counterpart of
:mod:`modem_tpu.chain`).

* :class:`PulseShapedChain` (and :func:`qpsk_reference_chain`): bits ->
  constellation map -> RRC pulse shaping -> [NCO passband] -> matched
  filter -> symbol-instant decimation -> slice -> bits (configs #1/#2);
* :class:`DifferentialChain`: the same for DBPSK/DQPSK, deciding on the
  phase change between decision points;
* :class:`FskChain` and :class:`MskChain`: the Modulator's exact phase
  programs and an FM-discriminator receiver (config #3);
* :class:`OqpskChain` and :class:`DcqpskChain`: mid-slot coherent slicing.

Two forms, as in the JAX package:

* staged (``tx``, ``rx``, ``rx_soft``, ``roundtrip``): the readable
  cross-check, tensor ops around the FIR
  (:func:`~modem_tpu_torch.ops.fir.fir_filter` with the chain's
  ``fir_backend``: ``"direct"``, kernel K4 on a CUDA device, or ``"conv"``,
  ``"matmul"``, ``"fft"``);
* fused (``tx_fused``, ``rx_fused``, ``rx_soft_fused``, ``roundtrip_fused``):
  the production path, one hand-written CUDA kernel per call on a CUDA
  device: K1-K3 (:mod:`~modem_tpu_torch.ops.txrx`,
  :mod:`~modem_tpu_torch.ops.chain_kernel`) for the pulse-shaped and
  differential chains, in every mode of the JAX kernels (passband, in-kernel
  noise, algebraic square QAM, bf16 and int16 waveforms), K6-K10
  (:mod:`~modem_tpu_torch.ops.fsk_kernel`) for the FSK family and MSK.

Every chain builds on ``device``, the card unless the caller asks for the
CPU; every tensor passed in must be there too.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .config import TWO_PI, Rates
from .cuda import resolve_device
from .models.base import LutScheme, PhaseProgram, Scheme, stagger_bit_planes
from .models.fsk import MSK
from .models.psk import DCQPSK, DMPSK, OQPSK, QPSK
from .models.qam import QAM
from .ops.chain_kernel import fused_pulse_chain, fused_pulse_chain_qam
from .ops.filters import rrc_taps
from .ops.fir import check_backend, fir_filter
from .ops.fsk_kernel import (fused_discriminator_means, fused_fsk_chain,
                             fused_fsk_tx, fused_msk_slots, fused_msk_tx)
from .ops.llr import dmpsk_llr, fsk_llr, lut_llr
from .ops.nco import carrier_phase, mix_up
from .ops.polyphase import polyphase_decim, polyphase_interp
from .ops.slicer import (diff_phase, fm_discriminate, fsk_slice,
                         fsk_slice_means, fsk_symbol_means, lut_map, lut_slice)
from .ops.txrx import fused_rx, fused_tx, qam_mparams
from .tx import Modulator
from .utils.bits import pack_bits, unpack_symbols
from .utils.scan import cummod


def _rrc_buffer(rrc, sps: int, span: int, beta: float, device) -> torch.Tensor:
    """The designed RRC taps, or ``rrc`` (``span*sps + 1`` of them), as a
    float32 tensor on ``device``."""
    taps = np.asarray(rrc_taps(sps, span, beta) if rrc is None else rrc,
                      np.float32)
    if taps.shape != (span * sps + 1,):
        raise ValueError("rrc taps length must equal span*sps + 1")
    return torch.as_tensor(taps, device=device)


def upsample_zero_stuff(x: torch.Tensor, factor: int) -> torch.Tensor:
    """[..., K] -> [..., K*factor] with x[k] at position k*factor, zeros between."""
    u = torch.zeros(x.shape + (factor,), dtype=x.dtype, device=x.device)
    u[..., 0] = x
    return u.reshape(x.shape[:-1] + (x.shape[-1] * factor,))


def shape_iq(iq: torch.Tensor, rrc, sps: int, span: int, polyphase: bool,
             fir_backend: str = "direct"):
    """Per-symbol I/Q ``[..., K, 2]`` -> RRC-shaped baseband ``(i, q)``
    ``[..., (K+span)*sps]``, ``span`` flush symbols appended, filtered by
    ``fir_backend`` (the polyphase form has its own arithmetic)."""
    check_backend(fir_backend)
    flush = torch.zeros(iq.shape[:-2] + (span, 2), dtype=iq.dtype,
                        device=iq.device)
    iq = torch.cat([iq, flush], dim=-2)
    if polyphase:
        si, _ = polyphase_interp(iq[..., 0], rrc, sps)
        sq, _ = polyphase_interp(iq[..., 1], rrc, sps)
        return si, sq
    si, _ = fir_filter(upsample_zero_stuff(iq[..., 0], sps), rrc,
                       backend=fir_backend)
    sq, _ = fir_filter(upsample_zero_stuff(iq[..., 1], sps), rrc,
                       backend=fir_backend)
    return si, sq


def matched_filter_rails(yi, yq, rrc, fir_backend: str = "direct"):
    """The matched filter over every sample of both rails (``fir_filter``
    with ``fir_backend``; ``"direct"`` is kernel K4 on CUDA), from a zero
    state."""
    return (fir_filter(yi, rrc, backend=fir_backend)[0],
            fir_filter(yq, rrc, backend=fir_backend)[0])


def symbol_instants(yi, yq, sps: int, span: int, n_symbols: int,
                    delay: int | None = None):
    """Samples ``d + m*sps`` of both rails -> ``(di, dq) [..., K]``, with
    ``d = span*sps`` unless ``delay`` is given."""
    d = span * sps if delay is None else delay
    idx = d + torch.arange(n_symbols, device=yi.device) * sps
    return yi[..., idx], yq[..., idx]


def matched_decision_points(yi, yq, rrc, sps: int, span: int, n_symbols: int,
                            polyphase: bool, fir_backend: str = "direct",
                            delay: int | None = None):
    """Matched filter + symbol-instant sampling -> ``(di, dq) [..., K]``,
    decision instants ``d + m*sps``: ``d = span*sps`` unless ``delay``
    overrides it (a cascade that adds its own group delay); the matched
    filter by ``fir_backend``."""
    check_backend(fir_backend)
    d = span * sps if delay is None else delay
    if polyphase:
        return (polyphase_decim(yi, rrc, sps, d, n_symbols),
                polyphase_decim(yq, rrc, sps, d, n_symbols))
    return symbol_instants(*matched_filter_rails(yi, yq, rrc, fir_backend),
                           sps, span, n_symbols, d)


class PulseShapedChain(torch.nn.Module):
    """Matched-filter chain for constellation (LUT) schemes.

    ``scheme`` exposes ``lut`` ([M, 2]) and ``bits_per_symbol``; slicing is
    minimum-distance against the table. The TX appends ``span`` flush
    symbols so the matched filter's full response is observed; the total
    group delay is ``span*sps``. ``carrier_hz`` (an integer, with the
    rates' sample rate) makes the waveform a real passband one: the exact
    integer NCO up-mixes (`modulator.rs:37-48`) and the RX product-detects
    with 2x gain (`demodulator.rs:52-55`). The table and the RRC taps are
    buffers on ``device``, the card unless the caller asks for the CPU;
    every tensor passed in must be there too. ``fir_backend`` (one of
    :data:`~modem_tpu_torch.ops.fir.BACKENDS`) filters the staged forms;
    the fused forms run their own kernels whatever it is, as in JAX.
    ``rrc`` replaces the designed taps (``span_symbols*sps + 1`` of them).
    """

    def __init__(self, scheme: Scheme, rates: Rates, span_symbols: int = 8,
                 beta: float = 0.35, carrier_hz: int | None = None,
                 fir_backend: str = "direct", polyphase: bool = False,
                 device: torch.device | str | None = None, rrc=None):
        super().__init__()
        if not hasattr(scheme, "lut"):
            raise TypeError("PulseShapedChain needs a constellation-LUT scheme")
        check_backend(fir_backend)
        self.scheme = scheme
        self.rates = rates
        self.span = span_symbols
        self.sps = rates.samples_per_symbol
        self.carrier_hz = None if carrier_hz is None else int(carrier_hz)
        self.fir_backend = fir_backend
        #: polyphase=True computes the staged pulse shaping at symbol rate
        #: and the matched filter only at the decision instants
        self.polyphase = polyphase
        device = resolve_device(device)
        self.register_buffer("lut", torch.as_tensor(
            np.asarray(scheme.lut, np.float32), device=device))
        self.register_buffer("rrc", _rrc_buffer(rrc, self.sps, span_symbols,
                                                beta, device))

    @classmethod
    def from_numpy(cls, params: dict, rates: Rates,
                   device: torch.device | str | None = None,
                   polyphase: bool = False,
                   carrier_hz: int | None = None) -> "PulseShapedChain":
        """Build from another chain's arrays: ``{"lut", "rrc",
        "bits_per_symbol", "span", "sps"}``, e.g. ``np.asarray`` of a
        :class:`modem_tpu.chain.PulseShapedChain`'s ``lut`` and ``rrc``, so
        that both filter and slice with the same numbers."""
        if params["sps"] != rates.samples_per_symbol:
            raise ValueError("params sps disagrees with rates")
        scheme = LutScheme(params["lut"], params["bits_per_symbol"])
        return cls(scheme, rates, span_symbols=int(params["span"]),
                   carrier_hz=carrier_hz, polyphase=polyphase, device=device,
                   rrc=params["rrc"])

    @property
    def bits_per_symbol(self) -> int:
        return self.scheme.bits_per_symbol

    def _carrier(self) -> dict:
        """The fused calls' carrier keywords."""
        if self.carrier_hz is None:
            return {}
        return {"carrier_hz": self.carrier_hz,
                "sample_rate": self.rates.sample_rate}

    def _theta(self, n: int, device) -> torch.Tensor:
        return carrier_phase(self.carrier_hz, self.rates.sample_rate, n, 0,
                             device=device)

    # ---- TX ----

    def map_symbols(self, bits: torch.Tensor) -> torch.Tensor:
        return pack_bits(bits, self.bits_per_symbol)

    def shape_pulses(self, symbols: torch.Tensor):
        """symbols [..., K] -> RRC-shaped baseband I/Q [..., (K+span)*sps]."""
        mi, mq = lut_map(symbols, self.lut)
        return shape_iq(torch.stack([mi, mq], dim=-1), self.rrc, self.sps,
                        self.span, self.polyphase, self.fir_backend)

    def tx(self, bits: torch.Tensor):
        """bits -> baseband ``(i, q)``, or the real passband waveform with
        ``carrier_hz``."""
        si, sq = self.shape_pulses(self.map_symbols(bits))
        if self.carrier_hz is None:
            return si, sq
        re, _ = mix_up(si, sq, self._theta(si.shape[-1], si.device))
        return re

    # ---- RX ----

    def matched_filter(self, i: torch.Tensor, q: torch.Tensor):
        """The RRC matched filter over every sample of ``(i, q)``
        (``fir_filter`` with the chain's ``fir_backend``), from a zero
        state."""
        return matched_filter_rails(i, q, self.rrc, self.fir_backend)

    def decimate(self, yi: torch.Tensor, yq: torch.Tensor, n_symbols: int):
        """Sample at the symbol centers: delay ``span*sps``, stride
        ``sps``."""
        return symbol_instants(yi, yq, self.sps, self.span, n_symbols)

    def downconvert(self, x: torch.Tensor):
        """Real passband -> baseband ``(i, q)`` by coherent product
        detection, 2x gain (`demodulator.rs:52-55`); the matched filter is
        the lowpass."""
        theta = self._theta(x.shape[-1], x.device)
        return 2.0 * x * torch.cos(theta), -2.0 * x * torch.sin(theta)

    def decision_points(self, rx_wave, n_symbols: int):
        """waveform -> matched-filter outputs at the symbol instants
        ``(di, dq) [..., K]``."""
        if self.carrier_hz is None:
            yi, yq = rx_wave
        else:
            yi, yq = self.downconvert(rx_wave)
        return matched_decision_points(yi, yq, self.rrc, self.sps, self.span,
                                       n_symbols, self.polyphase,
                                       self.fir_backend)

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

    def _algebraic_qam(self) -> bool:
        """Natural-binary square QAM takes the algebraic map of K1-K3; the
        algebraic map is natural binary, so Gray QAM takes the table."""
        return (isinstance(self.scheme, QAM) and self.bits_per_symbol % 2 == 0
                and not self.scheme.gray)

    def _txrx_params(self) -> dict:
        """The fused calls' map keywords: ``qam_params`` for non-Gray square
        QAM, the table otherwise."""
        if self._algebraic_qam():
            return {"lut": None, "qam_params": qam_mparams(
                self.bits_per_symbol, self.scheme.phase,
                self.scheme.amplitude)}
        return {"lut": self.lut}

    def _fused_rx(self, rx_wave, n_symbols: int, sym_offset: int,
                  soft: bool):
        return fused_rx(rx_wave, n_symbols, rrc_taps=self.rrc, sps=self.sps,
                        span=self.span, sym_offset=sym_offset, soft=soft,
                        **self._txrx_params(), **self._carrier())

    def tx_fused(self, bits: torch.Tensor, sym_offset: int = 0,
                 out_scale: float | None = None,
                 wave_dtype: torch.dtype = torch.float32):
        """bits -> waveform through the fused TX (kernel K2 on CUDA):
        :meth:`tx` up to f32 reassociation. ``out_scale`` stores int16
        ``round(x*out_scale)`` (the CLI's wire format), ``wave_dtype``
        bfloat16 halves the write; ``sym_offset`` is the stream-global
        index of the first symbol (the carrier's phase)."""
        return fused_tx(self.map_symbols(bits), rrc_taps=self.rrc,
                        sps=self.sps, span=self.span, sym_offset=sym_offset,
                        out_scale=out_scale, wave_dtype=wave_dtype,
                        **self._txrx_params(), **self._carrier())

    def rx_fused(self, rx_wave, n_symbols: int,
                 sym_offset: int = 0) -> torch.Tensor:
        """waveform -> decided bits through the fused RX (kernel K3 on
        CUDA); decisions equal :meth:`rx`."""
        syms = self._fused_rx(rx_wave, n_symbols, sym_offset, False)
        return unpack_symbols(syms, self.bits_per_symbol)

    def rx_soft_fused(self, rx_wave, n_symbols: int, noise_var: float = 1.0,
                      sym_offset: int = 0) -> torch.Tensor:
        """waveform -> per-bit LLRs: fused matched filter + decimation to the
        decision-point I/Q (kernel K3 on CUDA), then :func:`lut_llr`."""
        di, dq = self._fused_rx(rx_wave, n_symbols, sym_offset, True)
        return lut_llr(di, dq, self.lut, self.bits_per_symbol, noise_var)

    def roundtrip_fused(self, bits: torch.Tensor) -> torch.Tensor:
        """Noiseless bits -> bits through the fused loopback (kernel K1 on
        CUDA): the waveform never leaves the chip, the passband leg
        included. Decisions match :meth:`roundtrip`."""
        syms = self.map_symbols(bits)
        common = dict(rrc_taps=self.rrc, sps=self.sps, span=self.span,
                      **self._carrier())
        if self._algebraic_qam():
            dec = fused_pulse_chain_qam(syms, self.bits_per_symbol,
                                        self.scheme.phase,
                                        self.scheme.amplitude, **common)
        else:
            dec = fused_pulse_chain(syms, self.lut, **common)
        return unpack_symbols(dec, self.bits_per_symbol)


def _previous_or(x: torch.Tensor, first: int) -> torch.Tensor:
    """``x`` delayed one step along the last axis, ``first`` in front."""
    return torch.cat([torch.full_like(x[..., :1], first), x[..., :-1]], dim=-1)


class DifferentialChain(torch.nn.Module):
    """Pulse-shaped chain for differential PSK (DBPSK/DQPSK, `dmpsk.rs`).

    The TX maps symbols through the scheme's phase-accumulating program to
    per-symbol I/Q; the RX decides on the phase change between consecutive
    matched-filter outputs, the first against the known TX initial phase
    (`modulate.rs:86-90`). The fused forms run K1-K3 on the accumulated
    constellation (:meth:`_acc_constellation`). ``rrc`` replaces the
    designed taps (``span_symbols*sps + 1`` of them).
    """

    def __init__(self, scheme, rates: Rates, span_symbols: int = 8,
                 beta: float = 0.35, polyphase: bool = False,
                 device: torch.device | str | None = None, rrc=None):
        super().__init__()
        if not isinstance(scheme, DMPSK):
            raise TypeError("DifferentialChain requires a DMPSK scheme")
        self.scheme = scheme
        self.rates = rates
        self.span = span_symbols
        self.sps = rates.samples_per_symbol
        self.polyphase = polyphase
        self.register_buffer("rrc", _rrc_buffer(
            rrc, self.sps, span_symbols, beta, resolve_device(device)))
        self._acc = None

    def tx(self, bits: torch.Tensor):
        """bits -> RRC-shaped baseband ``(i, q)`` ``[..., (K+span)*sps]``."""
        symbols = pack_bits(bits, self.scheme.bits_per_symbol)
        prog, _ = self.scheme.program(
            symbols, self.scheme.init_state(symbols.shape[:-1], bits.device),
            self.rates, 0)
        return shape_iq(torch.stack([prog.i, prog.q], dim=-1), self.rrc,
                        self.sps, self.span, self.polyphase)

    def _phase0(self, like: torch.Tensor) -> torch.Tensor:
        """``(cos, sin)`` of the TX initial phase, ``[..., 2]`` float32."""
        p0 = self.scheme.phase0_turns * TWO_PI
        return torch.tensor([math.cos(p0), math.sin(p0)], dtype=torch.float32,
                            device=like.device).expand(like.shape[:-1] + (2,))

    def _dphi(self, rx_wave, n_symbols: int) -> torch.Tensor:
        """Per-symbol differential phase at the decision points."""
        di, dq = matched_decision_points(*rx_wave, self.rrc, self.sps,
                                         self.span, n_symbols, self.polyphase)
        return diff_phase(di, dq, self._phase0(di))

    @property
    def _shift(self) -> float:
        return self.scheme.shift_turns * TWO_PI

    def rx(self, rx_wave, n_symbols: int) -> torch.Tensor:
        """waveform -> decided bits: the phase change rounded to the nearest
        multiple of the shift (half to even)."""
        m = 1 << self.scheme.bits_per_symbol
        dphi = self._dphi(rx_wave, n_symbols)
        syms = torch.round(dphi / self._shift).to(torch.int32) % m
        return unpack_symbols(syms, self.scheme.bits_per_symbol)

    def rx_soft(self, rx_wave, n_symbols: int,
                noise_var: float = 1.0) -> torch.Tensor:
        """waveform -> per-bit LLRs from the differential phase
        (``noise_var`` = differential-phase variance)."""
        return dmpsk_llr(self._dphi(rx_wave, n_symbols), self._shift,
                         self.scheme.bits_per_symbol, noise_var)

    def roundtrip(self, bits: torch.Tensor) -> torch.Tensor:
        return self.rx(self.tx(bits),
                       bits.shape[-1] // self.scheme.bits_per_symbol)

    # ---- fused: K1-K3 on the accumulated constellation ----

    def _acc_constellation(self):
        """DMPSK's accumulated phase ``phi0 + shift * sum sym_j``
        (`dmpsk.rs:29-41`) is a rotated M'-PSK constellation indexed by the
        modular prefix sum of the symbols. Returns ``(M', lut)``, the table
        float32 on the chain's device."""
        if self._acc is None:
            sch = self.scheme
            inv = 1.0 / sch.shift_turns
            m_ph = round(inv)
            if abs(inv - m_ph) > 1e-9 or m_ph != 1 << sch.bits_per_symbol:
                raise NotImplementedError(
                    "fused DMPSK needs shift = 2*pi / 2^bits_per_symbol")
            ang = TWO_PI * (sch.phase0_turns + np.arange(m_ph) / m_ph)
            lut = np.stack([sch.amplitude * np.cos(ang),
                            sch.amplitude * np.sin(ang)], axis=-1)
            self._acc = (m_ph, torch.as_tensor(lut.astype(np.float32),
                                               device=self.rrc.device))
        return self._acc

    def _acc_symbols(self, bits: torch.Tensor, m_ph: int) -> torch.Tensor:
        syms = pack_bits(bits, self.scheme.bits_per_symbol)
        return cummod(syms, m_ph)

    def _decode(self, dec_abs: torch.Tensor, m_ph: int) -> torch.Tensor:
        """Absolute decisions -> bits: ``sym = (a_k - a_{k-1}) mod M'``."""
        dec = (dec_abs - _previous_or(dec_abs, 0)) % m_ph
        return unpack_symbols(dec, self.scheme.bits_per_symbol)

    def tx_fused(self, bits: torch.Tensor):
        """bits -> baseband ``(i, q)`` through K2: :meth:`tx` to f32
        rounding."""
        m_ph, lut = self._acc_constellation()
        return fused_tx(self._acc_symbols(bits, m_ph), lut, self.rrc, self.sps,
                        self.span)

    def rx_fused(self, rx_wave, n_symbols: int) -> torch.Tensor:
        """waveform -> decided bits through K3's min-distance slice against
        the accumulated constellation, then the differential decode."""
        m_ph, lut = self._acc_constellation()
        dec_abs = fused_rx(rx_wave, n_symbols, lut, self.rrc, self.sps,
                           self.span)
        return self._decode(dec_abs, m_ph)

    def rx_soft_fused(self, rx_wave, n_symbols: int,
                      noise_var: float = 1.0) -> torch.Tensor:
        """waveform -> per-bit LLRs: K3's decision-point I/Q, then the
        differential-phase LLRs (as :meth:`rx_soft`)."""
        _, lut = self._acc_constellation()
        di, dq = fused_rx(rx_wave, n_symbols, lut, self.rrc, self.sps,
                          self.span, soft=True)
        return dmpsk_llr(diff_phase(di, dq, self._phase0(di)), self._shift,
                         self.scheme.bits_per_symbol, noise_var)

    def roundtrip_fused(self, bits: torch.Tensor, snr_db: float | None = None,
                        seed=None) -> torch.Tensor:
        """bits -> bits through K1 on the accumulated constellation, the
        differential decode at symbol rate. ``snr_db`` (Es/N0 at the
        decision point) adds in-kernel noise from the stream keyed by
        ``seed``."""
        m_ph, lut = self._acc_constellation()
        dec_abs = fused_pulse_chain(self._acc_symbols(bits, m_ph), lut,
                                    self.rrc, self.sps, self.span,
                                    snr_db=snr_db, seed=seed)
        return self._decode(dec_abs, m_ph)


class FskChain:
    """FSK chain (config #3): exact-phase TX (the Modulator's PhaseProgram)
    and an FM-discriminator RX. ``coefs`` is the symbol -> frequency
    coefficient table, ``dev_rad_per_sample`` the deviation; decisions pick
    the nearest ``coef * dev``. ``guard >= 1`` samples of each symbol are
    skipped (the first increment spans the symbol boundary)."""

    def __init__(self, scheme: Scheme, rates: Rates, coefs,
                 dev_rad_per_sample: float, guard: int = 1,
                 device: torch.device | str | None = None):
        if guard < 1:
            raise ValueError("FskChain needs guard >= 1")
        if guard >= rates.samples_per_symbol:
            raise ValueError("guard leaves no interior samples per symbol")
        self.scheme = scheme
        self.rates = rates
        self.mod = Modulator(scheme, rates, device=device)
        self.device = self.mod.device
        self.coefs = np.asarray(coefs, np.float32)
        self.dev = float(dev_rad_per_sample)
        self.guard = guard

    @property
    def sps(self) -> int:
        return self.rates.samples_per_symbol

    def tx(self, bits: torch.Tensor, state=None):
        """bits -> baseband ``(i, q)`` ``[..., K*sps]``."""
        st = state if state is not None else self.mod.init_state(bits.shape[:-1])
        (i, q), _ = self.mod.baseband(bits, st)
        return i, q

    def rx(self, i: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
        """waveform -> decided bits (exact ``atan2`` discriminator)."""
        syms = fsk_slice(fm_discriminate(i, q), self.coefs, self.dev, self.sps,
                         self.guard)
        return unpack_symbols(syms, self.scheme.bits_per_symbol)

    def rx_soft(self, i: torch.Tensor, q: torch.Tensor,
                noise_var: float = 1.0) -> torch.Tensor:
        """waveform -> per-bit LLRs in the discriminator domain
        (``noise_var`` = variance of the per-symbol mean frequency)."""
        mean_f = fsk_symbol_means(fm_discriminate(i, q), self.sps, self.guard)
        return fsk_llr(mean_f, self.coefs, self.dev,
                       self.scheme.bits_per_symbol, noise_var)

    def roundtrip(self, bits: torch.Tensor) -> torch.Tensor:
        return self.rx(*self.tx(bits))

    # ---- fused: K8, K9, K6 ----

    def _phase_program(self, bits: torch.Tensor) -> PhaseProgram:
        syms = pack_bits(bits, self.scheme.bits_per_symbol)
        prog, _ = self.scheme.program(
            syms, self.scheme.init_state(syms.shape[:-1], bits.device),
            self.rates, 0)
        if not isinstance(prog, PhaseProgram) or prog.slots_per_symbol != 1:
            raise TypeError("fused FSK supports slots_per_symbol == 1 schemes")
        return prog

    def tx_fused(self, bits: torch.Tensor):
        """bits -> baseband ``(i, q)`` through K8: :meth:`tx` to f32 trig
        rounding."""
        prog = self._phase_program(bits)
        return fused_fsk_tx(prog.fnum, prog.pnum, prog.den, self.sps,
                            float(self.scheme.amplitude), prog.qshift)

    def rx_fused(self, i: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
        """waveform -> decided bits: K9's per-symbol means (polynomial
        discriminator), the nearest frequency at symbol rate. Equal to
        :meth:`rx` away from the midpoints between tones."""
        mean_f = fused_discriminator_means(i, q, self.sps, self.guard)
        syms = fsk_slice_means(mean_f, self.coefs, self.dev)
        return unpack_symbols(syms, self.scheme.bits_per_symbol)

    def rx_soft_fused(self, i: torch.Tensor, q: torch.Tensor,
                      noise_var: float = 1.0) -> torch.Tensor:
        """waveform -> per-bit LLRs from K9's means (as :meth:`rx_soft`)."""
        mean_f = fused_discriminator_means(i, q, self.sps, self.guard)
        return fsk_llr(mean_f, self.coefs, self.dev,
                       self.scheme.bits_per_symbol, noise_var)

    def roundtrip_fused(self, bits: torch.Tensor, snr_db: float | None = None,
                        seed=None) -> torch.Tensor:
        """bits -> bits through K6, the waveform kept on chip; ``snr_db``
        (per complex sample) adds in-kernel noise from the stream keyed by
        ``seed``."""
        bps = self.scheme.bits_per_symbol
        dec = fused_fsk_chain(pack_bits(bits, bps), self.scheme, self.rates,
                              self.guard, snr_db=snr_db, seed=seed)
        return unpack_symbols(dec, bps)


class MskChain:
    """MSK bits -> bits: exact half-sine TX and discriminator detection with
    differential decoding.

    Within one half-symbol slot the baseband
    ``y = A*(s0*cos(th) - j*s1*sin(th))`` (`msk.rs:12-35`) is a tone of
    frequency ``-s0*s1 * pi/(2*spb)``, so the discriminator gives one sign
    per slot, ``c = -s0*s1``; consecutive slot products telescope back to
    the bits, ``c[2m]*c[2m+1] = s1[m-1]*s1[m]`` and ``s0[m] = -c[2m]*s1[m-1]``,
    seeded by the zero-initialized stagger (``s1[-1] = -1``, `data.rs:97-99`).
    """

    def __init__(self, rates: Rates, amplitude: float = 1.0, guard: int = 1,
                 device: torch.device | str | None = None):
        if rates.samples_per_symbol % 2:
            raise ValueError("MSK needs even samples_per_symbol")
        self.rates = rates
        self.scheme = MSK(amplitude, rates.samples_per_symbol)
        self.mod = Modulator(self.scheme, rates, device=device)
        self.device = self.mod.device
        self.spb = rates.samples_per_symbol // 2
        self.guard = guard
        if guard < 1:
            raise ValueError("MskChain needs guard >= 1")
        if self.spb - guard < 1:
            raise ValueError("guard leaves no interior samples per slot")

    def tx(self, bits: torch.Tensor):
        (i, q), _ = self.mod.baseband(bits, self.mod.init_state(bits.shape[:-1]))
        return i, q

    def _decode_cneg(self, c_neg: torch.Tensor) -> torch.Tensor:
        """Per-slot discriminator sign bits (1 where c = -1) -> bits, by the
        telescoping slot-product prefix decode."""
        ce, co = c_neg[..., 0::2], c_neg[..., 1::2]  # slots 2m, 2m+1
        flips = (ce + co) % 2  # where s1 changes sign; s1[-1] = -1
        s1_neg = (1 + torch.cumsum(flips, dim=-1, dtype=torch.int32)) % 2
        s0_neg = (1 + ce + _previous_or(s1_neg, 1)) % 2
        bits = torch.stack([1 - s0_neg, 1 - s1_neg], dim=-1)
        return bits.reshape(bits.shape[:-2] + (2 * ce.shape[-1],))

    def rx(self, i: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
        """waveform -> bits through the exact discriminator."""
        inst = fm_discriminate(i, q)
        mean_f = fsk_symbol_means(inst, self.spb, self.guard)
        return self._decode_cneg((mean_f < 0).to(torch.int32))

    def roundtrip(self, bits: torch.Tensor) -> torch.Tensor:
        return self.rx(*self.tx(bits))

    def _slot_signs(self, bits: torch.Tensor):
        """bits ``[..., 2K]`` -> staggered slot signs ``(s0, s1)`` (+-1)."""
        b = bits.reshape(bits.shape[:-1] + (bits.shape[-1] // 2, 2))
        prev = torch.zeros(bits.shape[:-1], dtype=torch.int32,
                           device=bits.device)
        b0s, b1s, _ = stagger_bit_planes(b[..., 0], b[..., 1], prev)
        return (2 * b0s.to(torch.int32) - 1, 2 * b1s.to(torch.int32) - 1)

    def tx_fused(self, bits: torch.Tensor):
        """bits -> baseband ``(i, q)`` through K10: :meth:`tx` to f32 trig
        rounding."""
        s0, s1 = self._slot_signs(bits)
        return fused_msk_tx(s0, s1, self.spb, float(self.scheme.amplitude))

    def rx_fused(self, i: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
        """waveform -> bits: K9's per-slot means, then the prefix decode."""
        mean_f = fused_discriminator_means(i, q, self.spb, self.guard)
        return self._decode_cneg((mean_f < 0).to(torch.int32))

    def roundtrip_fused(self, bits: torch.Tensor, snr_db: float | None = None,
                        seed=None) -> torch.Tensor:
        """bits -> bits through the MSK loopback (kernel K7 on CUDA):
        synthesis, discriminator and per-slot sign on chip, the prefix
        decode at slot rate; ``snr_db`` (per complex sample) adds in-kernel
        noise from the stream keyed by ``seed``."""
        s0, s1 = self._slot_signs(bits)
        return self._decode_cneg(fused_msk_slots(
            s0, s1, self.spb, float(self.scheme.amplitude), self.guard,
            snr_db=snr_db, seed=seed))


class OqpskChain:
    """OQPSK bits -> bits: rectangular-pulse offset QPSK with mid-slot
    coherent sampling. The I rail holds ``b0`` over slots [2m, 2m+2), the Q
    rail ``b1`` over [2m+1, 2m+3) (`oqpsk.rs:19-25`, `data.rs:102-123`);
    each rail is sampled in the middle of its hold and sign-sliced."""

    def __init__(self, rates: Rates, amplitude: float = 1.0,
                 device: torch.device | str | None = None):
        if rates.samples_per_symbol % 2:
            raise ValueError("OQPSK needs even samples_per_symbol")
        self.rates = rates
        self.scheme = OQPSK(amplitude)
        self.mod = Modulator(self.scheme, rates, device=device)
        self.device = self.mod.device
        self.sps = rates.samples_per_symbol

    def tx(self, bits: torch.Tensor):
        (i, q), _ = self.mod.baseband(bits, self.mod.init_state(bits.shape[:-1]))
        return i, q

    def rx(self, i: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
        sps = self.sps
        k = i.shape[-1] // sps
        starts = torch.arange(k, device=i.device) * sps
        # Q's hold for b1[m] is centred on the next symbol boundary; the
        # last one runs past the stream, so its last sample is read
        idx1 = torch.clamp(starts + sps, max=i.shape[-1] - 1)
        b0 = (i[..., starts + sps // 2] > 0).to(torch.int32)
        b1 = (q[..., idx1] > 0).to(torch.int32)
        return torch.stack([b0, b1], dim=-1).reshape(i.shape[:-1] + (2 * k,))

    def roundtrip(self, bits: torch.Tensor) -> torch.Tensor:
        return self.rx(*self.tx(bits))


class DcqpskChain:
    """pi/4-QPSK bits -> bits: coherent slicing against the parity-dependent
    constellation (`dcqpsk.rs:24-44`), symbol k against the +pi/4-rotated
    table iff k is even."""

    def __init__(self, rates: Rates, amplitude: float = 1.0,
                 device: torch.device | str | None = None):
        self.rates = rates
        self.scheme = DCQPSK(amplitude)
        self.mod = Modulator(self.scheme, rates, device=device)
        self.device = self.mod.device
        self.sps = rates.samples_per_symbol

    def tx(self, bits: torch.Tensor):
        (i, q), _ = self.mod.baseband(bits, self.mod.init_state(bits.shape[:-1]))
        return i, q

    def rx(self, i: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
        sps = self.sps
        k = i.shape[-1] // sps
        idx = torch.arange(k, device=i.device) * sps + sps // 2
        di, dq = i[..., idx], q[..., idx]
        lut = self.scheme.lut  # [2, 4, 2]: even symbols, odd symbols
        even = torch.arange(k, device=i.device) % 2 == 0
        syms = torch.where(even, lut_slice(di, dq, lut[0]),
                           lut_slice(di, dq, lut[1]))
        return unpack_symbols(syms, 2)

    def roundtrip(self, bits: torch.Tensor) -> torch.Tensor:
        return self.rx(*self.tx(bits))


def qpsk_reference_chain(rates: Rates, span_symbols: int = 8,
                         beta: float = 0.35, fir_backend: str = "direct",
                         device: torch.device | str | None = None
                         ) -> PulseShapedChain:
    """The flagship: QPSK + RRC + matched filter at complex baseband
    (`BASELINE.json` config #2)."""
    return PulseShapedChain(QPSK(0.0, 1.0), rates, span_symbols, beta,
                            fir_backend=fir_backend, device=device)
