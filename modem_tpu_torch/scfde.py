"""SC-FDE: single-carrier block transmission with a cyclic prefix and MMSE
frequency-domain equalization (counterpart of :mod:`modem_tpu.scfde`).

The payload symbols stay in the time domain (a single-carrier envelope);
the receiver strips each block's CP, takes the unitary DFT, applies one
MMSE tap a bin against the channel estimated from the frame's Zadoff–Chu
training blocks, and returns to the time domain before slicing. A spectral
null costs a little SNR on every symbol instead of erasing the symbols of
the nulled bins, as it does in OFDM.

* the DFT and IDFT are unitary ``[N, N]`` float32 matmuls (``torch.matmul``;
  PyTorch's default keeps TF32 off for these); the MMSE weights, the bias
  removal and the post-FDE error variance are elementwise;
* blind acquisition (:meth:`ScFdeModem.locate_frame`) is the periodic
  similarity of the repeated training blocks (period one block), the
  fractional CFO from its angle, and fine timing against the whole CP'd
  preamble as four causal FIR passes: kernel K4 with the ``n_ltf * (n +
  cp)``-tap reversed preamble as taps on a CUDA tensor (160 taps at the
  default geometry, K4's generic route).

Every table comes from the JAX package's numpy code, so both packages build
the same frames. A modem's tables live on its ``device``, the card unless
the caller asks for the CPU.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .cuda import resolve_device
from .ofdm import _angle, _dft_rows
from .ops.llr import lut_llr
from .ops.slicer import lut_map, lut_slice
from .ops.sync_metric import (aligned_frame_matmul, correlate_reversed,
                              periodic_similarity)
from .utils.bits import pack_bits, unpack_symbols
from .utils.cache import on_device


@lru_cache(maxsize=8)
def _zadoff_chu(n: int) -> tuple[np.ndarray, np.ndarray]:
    """Even-length Zadoff–Chu root-1 sequence ``x[k] = exp(-j pi k^2/n)``:
    constant amplitude in time and in frequency (CAZAC)."""
    k = np.arange(n, dtype=np.float64)
    ang = -np.pi * k * k / n
    return (np.cos(ang).astype(np.float32),
            np.sin(ang).astype(np.float32))


class ScFdeModem:
    """Single-carrier frequency-domain-equalized block modem.

    Frame layout (every block CP-prefixed, ``sym_len = n + cp`` samples)::

        [ZC training] * n_ltf  +  [payload block] * n_blocks

    ``tx_frame(bits)`` -> ``(i, q)``; ``rx_frame(i, q, n_blocks,
    noise_var)`` -> bits, the channel estimated from the frame's own
    training blocks. ``noise_var`` is the per-complex-sample noise variance
    the MMSE weights assume; 0.0 is zero-forcing. ``device``: where the
    tables live (the card unless the caller asks for the CPU).
    """

    def __init__(self, scheme, n: int = 64, cp: int = 16, n_ltf: int = 2,
                 device: torch.device | str | None = None):
        if not hasattr(scheme, "lut"):
            raise ValueError("SC-FDE needs a constellation (LUT) scheme")
        if n_ltf < 1:
            raise ValueError("need n_ltf >= 1 training blocks")
        if cp >= n:
            raise ValueError("cp must be shorter than the block")
        self.device = resolve_device(device)
        self.scheme = scheme
        self.lut = np.asarray(scheme.lut, np.float32)
        self.bits_per_symbol = scheme.bits_per_symbol
        self.n = int(n)
        self.cp = int(cp)
        self.sym_len = self.n + self.cp
        self.n_ltf = int(n_ltf)

        # the unitary full-band DFT as real matmuls: bins 0..n-1
        c, s = _dft_rows(self.n, tuple(range(self.n)))
        self._c = (c / np.sqrt(self.n)).astype(np.float32)  # [N, N]
        self._s = (s / np.sqrt(self.n)).astype(np.float32)

        zi, zq = _zadoff_chu(self.n)
        self._zc_i, self._zc_q = zi, zq
        self._es = float(np.mean(np.sum(self.lut ** 2, axis=-1)))
        # the training block's frequency response (unitary DFT of the ZC)
        self._zf_i = (zi @ self._c.T + zq @ self._s.T)
        self._zf_q = (zq @ self._c.T - zi @ self._s.T)
        # |X(k)|^2 is 1 for a unitary-DFT CAZAC; the computed value per bin
        self._zf_m2 = self._zf_i ** 2 + self._zf_q ** 2

        # the whole preamble (CP'd ZC blocks): the fine-timing template
        self._preamble_i = np.tile(
            np.concatenate([zi[-self.cp:], zi]), self.n_ltf)
        self._preamble_q = np.tile(
            np.concatenate([zq[-self.cp:], zq]), self.n_ltf)

    def _t(self, name: str) -> torch.Tensor:
        """The table ``self.<name>`` as a tensor on the modem's device."""
        return on_device(self, name, lambda: getattr(self, name),
                         torch.float32, self.device)

    # ---- frame geometry ----

    @property
    def preamble_len(self) -> int:
        return self.n_ltf * self.sym_len

    def frame_len(self, n_blocks: int) -> int:
        return (self.n_ltf + n_blocks) * self.sym_len

    def bits_per_frame(self, n_blocks: int) -> int:
        return n_blocks * self.n * self.bits_per_symbol

    def _add_cp(self, x: torch.Tensor) -> torch.Tensor:
        """``[..., B, N]`` -> ``[..., B*(cp+N)]``."""
        ext = torch.cat([x[..., -self.cp:], x], dim=-1)
        return ext.reshape(ext.shape[:-2] + (-1,))

    def _strip_cp(self, x: torch.Tensor, n_blocks: int) -> torch.Tensor:
        """``[..., B*(cp+N)]`` -> ``[..., B, N]``."""
        need = n_blocks * self.sym_len
        if x.shape[-1] < need:
            raise ValueError(f"need {need} samples, got {x.shape[-1]}")
        b = x[..., :need].reshape(x.shape[:-1] + (n_blocks, self.sym_len))
        return b[..., self.cp:]

    def _dft(self, xi: torch.Tensor, xq: torch.Tensor):
        ct, st = self._t("_c").T, self._t("_s").T
        return xi @ ct + xq @ st, xq @ ct - xi @ st

    def _idft(self, yi: torch.Tensor, yq: torch.Tensor):
        # the unitary inverse is the conjugate transpose: C is symmetric and
        # S antisymmetric in (k, n), so the same tables with a sign flipped
        c, s = self._t("_c"), self._t("_s")
        return yi @ c - yq @ s, yq @ c + yi @ s

    # ---- TX ----

    def tx_frame(self, bits: torch.Tensor):
        """``[..., n_blocks*N*bps]`` bits -> ``(i, q)`` frame waveform."""
        syms = pack_bits(bits, self.bits_per_symbol)
        if syms.shape[-1] % self.n:
            raise ValueError(
                f"bits must fill whole {self.n}-symbol blocks")
        di, dq = lut_map(syms, self._t("lut"))
        shape = syms.shape[:-1] + (-1, self.n)
        pi = self._add_cp(di.reshape(shape))
        pq = self._add_cp(dq.reshape(shape))
        hi = self._t("_preamble_i").expand(pi.shape[:-1] + (-1,))
        hq = self._t("_preamble_q").expand(pq.shape[:-1] + (-1,))
        return torch.cat([hi, pi], dim=-1), torch.cat([hq, pq], dim=-1)

    # ---- RX (frame-aligned) ----

    def estimate_channel(self, i: torch.Tensor, q: torch.Tensor):
        """Aligned training section ``[..., n_ltf*sym_len]`` -> per-bin
        ``(hi, hq) [..., N]`` (LS, averaged over the repetitions)."""
        yi, yq = self._dft(self._strip_cp(i, self.n_ltf),
                           self._strip_cp(q, self.n_ltf))
        zi, zq, m2 = (self._t(n) for n in ("_zf_i", "_zf_q", "_zf_m2"))
        hi = torch.mean((yi * zi + yq * zq) / m2, dim=-2)
        hq = torch.mean((yq * zi - yi * zq) / m2, dim=-2)
        return hi, hq

    def _equalize(self, i: torch.Tensor, q: torch.Tensor, n_blocks: int,
                  h, noise_var: float):
        """Aligned payload ``[..., n_blocks*sym_len]`` -> time-domain
        decision points ``(di, dq, mse)``; ``mse`` is the per-symbol
        post-FDE error variance (the soft-decision noise scale)."""
        yi, yq = self._dft(self._strip_cp(i, n_blocks),
                           self._strip_cp(q, n_blocks))
        hi, hq = h
        hi = hi[..., None, :]
        hq = hq[..., None, :]
        m2 = hi * hi + hq * hq
        # MMSE in symbol-energy units: g = noise_var / Es, in float32
        g = float(np.float32(noise_var / self._es))
        den = m2 + g
        wi = hi / den          # W = conj(H) / (|H|^2 + g)
        wq = -hq / den
        ei = yi * wi - yq * wq
        eq = yq * wi + yi * wq
        # bias removal: the MMSE output is alpha * s + noise with alpha =
        # mean_k |H_k|^2 / (|H_k|^2 + g) < 1, divided out for the slicer
        alpha = torch.clamp(torch.mean(m2 / den, dim=-1), min=1e-12)
        di, dq = self._idft(ei, eq)
        di = di / alpha[..., None]
        dq = dq / alpha[..., None]
        # the unbiased post-MMSE error variance Es * (1/alpha - 1): the
        # soft demapper's noise scale
        mse = self._es * (1.0 / alpha[..., 0] - 1.0)
        return di, dq, mse

    def rx_frame(self, i: torch.Tensor, q: torch.Tensor, n_blocks: int,
                 noise_var: float = 0.0) -> torch.Tensor:
        """Frame-aligned waveform -> hard bits (the channel estimated from
        the frame's own training blocks)."""
        p = self.preamble_len
        h = self.estimate_channel(i[..., :p], q[..., :p])
        di, dq, _ = self._equalize(i[..., p:], q[..., p:], n_blocks, h,
                                   noise_var)
        syms = lut_slice(di, dq, self._t("lut"))
        bits = unpack_symbols(syms, self.bits_per_symbol)
        return bits.reshape(bits.shape[:-2] + (-1,))

    def rx_soft_frame(self, i: torch.Tensor, q: torch.Tensor,
                      n_blocks: int, noise_var: float) -> torch.Tensor:
        """Frame-aligned waveform -> max-log LLRs scaled by the post-FDE
        SNR (what soft FEC expects)."""
        p = self.preamble_len
        h = self.estimate_channel(i[..., :p], q[..., :p])
        di, dq, mse = self._equalize(i[..., p:], q[..., p:], n_blocks, h,
                                     noise_var)
        llr = lut_llr(di, dq, self._t("lut"), self.bits_per_symbol, 1.0)
        w = 2.0 / torch.clamp(mse, min=1e-12)  # per-rail variance mse/2
        llr = llr * w[..., None, None]
        return llr.reshape(llr.shape[:-2] + (-1,))

    # ---- blind acquisition (periodic similarity + preamble fine timing) ----

    def sc_metric(self, i: torch.Tensor, q: torch.Tensor, max_lag: int):
        """Periodic-similarity timing metric over lags ``[0, max_lag)`` from
        the training blocks' ``sym_len`` repetition (needs ``n_ltf >= 2``).
        Returns ``(M, P_i, P_q)``, ``M`` in [0, 1]."""
        if self.n_ltf < 2:
            raise ValueError("blind sync needs n_ltf >= 2 training blocks")
        return periodic_similarity(i, q, lag=self.sym_len,
                                   width=self.sym_len, max_lag=max_lag)

    def locate_frame(self, i: torch.Tensor, q: torch.Tensor,
                     n_blocks: int, max_lag: int,
                     aligner: str = "matmul"):
        """The blind front end of :meth:`acquire`: coarse timing and the
        fractional CFO (range ``±0.5/sym_len`` cycles/sample), derotation,
        fine timing against the whole preamble (K4 on a CUDA capture), and
        the located frame's samples. ``aligner``: ``"matmul"``
        (:func:`~modem_tpu_torch.ops.sync_metric.aligned_frame_matmul`) or
        ``"gather"``; both are one gather here. Returns ``(fi, fq,
        report)``; captures shorter than the last candidate frame's end are
        zero-padded."""
        if aligner not in ("matmul", "gather"):
            raise ValueError(f"unknown aligner {aligner!r}")
        need = max_lag + self.frame_len(n_blocks)
        if i.shape[-1] < need:
            pad = i.new_zeros(i.shape[:-1] + (need - i.shape[-1],))
            i, q = torch.cat([i, pad], dim=-1), torch.cat([q, pad], dim=-1)
        m, ps_i, ps_q = self.sc_metric(i, q, max_lag + self.cp)
        coarse = torch.argmax(m, dim=-1, keepdim=True)
        pk_i = torch.gather(ps_i, -1, coarse)
        pk_q = torch.gather(ps_q, -1, coarse)
        cfo = _angle(pk_i, pk_q) / self.sym_len  # rad/sample
        n = torch.arange(i.shape[-1], dtype=torch.float32, device=i.device)
        th = -cfo * n
        c, s = torch.cos(th), torch.sin(th)
        ci = i * c - q * s
        cq = i * s + q * c
        rev = [on_device(self, ("rev", n),
                         lambda n=n: getattr(self, n)[::-1].copy(),
                         torch.float32, ci.device)
               for n in ("_preamble_i", "_preamble_q")]
        cr, cj = correlate_reversed(ci, cq, rev[0], rev[1], max_lag)
        start = torch.argmax(cr * cr + cj * cj, dim=-1).to(torch.int32)
        fi, fq = aligned_frame_matmul(ci, cq, start, self.frame_len(n_blocks),
                                      max_lag)
        report = {"start": start, "cfo_rad_per_sample": cfo[..., 0],
                  "sc_peak": torch.gather(m, -1, coarse)[..., 0]}
        return fi, fq, report

    def acquire(self, i: torch.Tensor, q: torch.Tensor, n_blocks: int,
                max_lag: int, noise_var: float = 0.0):
        """Blind RX: frame start unknown in ``[0, max_lag)``, a small CFO,
        flat gain and phase, CP-short multipath. Returns ``(bits,
        report)``."""
        fi, fq, report = self.locate_frame(i, q, n_blocks, max_lag)
        return self.rx_frame(fi, fq, n_blocks, noise_var), report


class ScFdeChain:
    """Chain adapter that lets :class:`~modem_tpu_torch.link.FramedLink` run
    over the SC-FDE PHY: one SC-FDE block is "a symbol" of ``N * bps`` bits.
    Frame-aligned waveforms; no fused forms, so the link's fused route
    takes the staged one."""

    class _Shim:
        def __init__(self, bits_per_symbol: int):
            self.bits_per_symbol = bits_per_symbol

    def __init__(self, modem: ScFdeModem):
        self.modem = modem
        self.scheme = self._Shim(modem.n * modem.bits_per_symbol)

    def tx(self, bits: torch.Tensor):
        return self.modem.tx_frame(bits)

    def rx_soft(self, iq, n_symbols: int,
                noise_var: float = 1.0) -> torch.Tensor:
        i, q = iq
        return self.modem.rx_soft_frame(i, q, n_symbols, noise_var)

    def rx(self, iq, n_symbols: int) -> torch.Tensor:
        i, q = iq
        return self.modem.rx_frame(i, q, n_symbols)
