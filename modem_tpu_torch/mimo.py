"""Spatially-multiplexed MIMO over the OFDM PHY, per-subcarrier MMSE
(counterpart of :mod:`modem_tpu.mimo`): :class:`MimoOfdm` (2x2, closed
form) and :class:`MimoOfdmN` (``nt`` streams, ``nr >= nt`` receive
antennas, the inverse by recursive Schur complement).

Per data subcarrier ``y = H s + noise``. The frame is ``[STF][LTF slot per
transmit antenna][payload]``, so each receive antenna gets an LS estimate of
every channel entry from a clean slot (:func:`~modem_tpu_torch.stbc
._slot_estimates`). Detection solves ``A = H^H H + g I`` (``g = noise_var /
Es``; ZF at 0) per bin; stream k's estimate is divided by ``1 - d_k``, ``d_k
= g [A^-1]_kk`` (bias removal), and its LLRs are weighted by the
post-detection SINR ``(1 - d_k) / (d_k Es)``.

Matrices are ``(re, im)`` pairs of tensors with two trailing axes; their
products are elementwise products summed over the small axis (:func:`_cmm`),
so no TF32 setting rounds them (the JAX package asks XLA for its highest
precision there). :class:`MimoOfdmN` runs its small-matrix algebra (the Gram
matrix, its inverse, the products, the bias removal) in float64 from the
float32 channel estimates and spectra, and returns float32: the normal
equations square the channel's condition number, and in float32 two orders
of summation (XLA's and PyTorch's) then differ by up to 1.5e-4 at a 4x4
zero-forcing solve, where in float64 the port is within 5e-6 of the exact
solution and so within the JAX detector's own float32 error of it.
"""

from __future__ import annotations

import numpy as np
import torch

from .ofdm import OfdmModem, _default_grid
from .ops.llr import lut_llr
from .ops.slicer import lut_slice
from .stbc import _framed, _heads, _slot_estimates
from .utils.bits import unpack_symbols
from .utils.cache import on_device


def _es(m: OfdmModem) -> float:
    return float(np.mean(np.sum(np.asarray(m.lut, np.float32) ** 2,
                                axis=-1)))


def _bits_of(m: OfdmModem, di: torch.Tensor, dq: torch.Tensor):
    """Decision points ``[..., S, D]`` -> hard bits ``[..., S*D*bps]``."""
    bits = unpack_symbols(lut_slice(di, dq, m._t("lut")), m.bits_per_symbol)
    return bits.reshape(bits.shape[:-2] + (-1,))


def _weighted_llrs(m: OfdmModem, di: torch.Tensor, dq: torch.Tensor,
                   w: torch.Tensor) -> torch.Tensor:
    """Decision points ``[..., nt*S, D]`` in virtual-symbol order and the
    per-stream weights ``[..., nt, D]`` -> weighted max-log LLRs ``[...,
    nt*S*D*bps]``."""
    llr = lut_llr(di, dq, m._t("lut"), m.bits_per_symbol, 1.0)
    wb = torch.repeat_interleave(w, m.bits_per_symbol, dim=-1)
    s = di.shape[-2] // w.shape[-2]
    llr = llr * wb.repeat((1,) * (wb.ndim - 2) + (s, 1))
    return llr.reshape(llr.shape[:-2] + (-1,))


class MimoOfdm:
    """2x2 spatially-multiplexed OFDM.

    ``scheme``: any constellation scheme. Each payload slot carries two
    independent streams (``2 * bits_per_sym`` bits). :meth:`tx` returns two
    antenna waveforms; :meth:`rx_frame` takes two receive-antenna captures.
    ``device``: where the tables live (the card unless the caller asks for
    the CPU); other keywords go to the inner modem.
    """

    def __init__(self, scheme, n_fft: int = 64, cp: int = 16,
                 seed: int = 2016, device: torch.device | str | None = None,
                 **modem_kwargs):
        data, pilots = _default_grid(n_fft)
        # pilotless inner modem, one LTF a transmit antenna's slot
        self.m = OfdmModem(scheme, n_fft=n_fft, cp=cp,
                           data_bins=data + pilots, pilot_bins=(),
                           n_ltf=1, seed=seed, device=device, **modem_kwargs)
        self.device = self.m.device
        self.bits_per_slot = 2 * self.m.bits_per_sym
        self._es = _es(self.m)
        self.__dict__.update(_heads(self.m, a=("stf", "ltf", None),
                                    b=(None, None, "ltf")))

    def _t(self, name: str) -> torch.Tensor:
        return on_device(self, name, lambda: getattr(self, name),
                         torch.float32, self.device)

    @property
    def preamble_len(self) -> int:
        """STF + one LTF slot per transmit antenna."""
        return 3 * self.m.sym_len

    def frame_len(self, n_symbols: int) -> int:
        return self.preamble_len + n_symbols * self.m.sym_len

    def bits_per_frame(self, n_symbols: int) -> int:
        return n_symbols * self.bits_per_slot

    # ---- TX ----

    def tx(self, bits: torch.Tensor):
        """``[..., n_symbols*bits_per_slot]`` bits -> two antenna waveforms
        ``((ia, qa), (ib, qb))``, each ``[..., frame_len]``. Slot s carries
        virtual symbols 2s (stream A) and 2s+1 (stream B) of the inner
        modem's bit mapping."""
        m = self.m
        di, dq = m.map_bits(bits)                # [..., 2S, D]
        if di.shape[-2] % 2:
            raise ValueError("need an even number of virtual symbols")
        wa = _framed(m, self._t("_head_ai"), self._t("_head_aq"),
                     di[..., 0::2, :], dq[..., 0::2, :])
        wb = _framed(m, self._t("_head_bi"), self._t("_head_bq"),
                     di[..., 1::2, :], dq[..., 1::2, :])
        return wa, wb

    # ---- RX ----

    def detect(self, i1, q1, i2, q2, n_symbols: int,
               noise_var: float = 0.0):
        """Two aligned receive captures -> per-stream decision points
        ``(di, dq, w)``: unbiased MMSE estimates in virtual-symbol order
        ``[..., 2S, D]`` and the per-stream LLR weights ``w [..., 2, D]``
        (post-detection SINR / Es; ``noise_var=0`` is zero-forcing, whose
        weights mean something only for hard slicing)."""
        ((h11i, h11q), (h12i, h12q)), (y1i, y1q) = _slot_estimates(
            self.m, i1, q1, 2, n_symbols)
        ((h21i, h21q), (h22i, h22q)), (y2i, y2q) = _slot_estimates(
            self.m, i2, q2, 2, n_symbols)
        g = float(np.float32(noise_var / self._es))
        # A = H^H H + g I (2x2 Hermitian PD) per data bin [..., D]
        a11 = h11i * h11i + h11q * h11q + h21i * h21i + h21q * h21q + g
        a22 = h12i * h12i + h12q * h12q + h22i * h22i + h22q * h22q + g
        a12i = h11i * h12i + h11q * h12q + h21i * h22i + h21q * h22q
        a12q = h11i * h12q - h11q * h12i + h21i * h22q - h21q * h22i
        det = torch.clamp(a11 * a22 - (a12i * a12i + a12q * a12q), min=1e-24)

        def bc(x):  # a bin's value against every symbol [..., 1, D]
            return x[..., None, :]

        # z = H^H y
        z1i = (bc(h11i) * y1i + bc(h11q) * y1q
               + bc(h21i) * y2i + bc(h21q) * y2q)
        z1q = (bc(h11i) * y1q - bc(h11q) * y1i
               + bc(h21i) * y2q - bc(h21q) * y2i)
        z2i = (bc(h12i) * y1i + bc(h12q) * y1q
               + bc(h22i) * y2i + bc(h22q) * y2q)
        z2q = (bc(h12i) * y1q - bc(h12q) * y1i
               + bc(h22i) * y2q - bc(h22q) * y2i)
        # s = A^-1 z by the 2x2 adjugate
        ddet = bc(det)
        s1i = (bc(a22) * z1i - (bc(a12i) * z2i - bc(a12q) * z2q)) / ddet
        s1q = (bc(a22) * z1q - (bc(a12i) * z2q + bc(a12q) * z2i)) / ddet
        s2i = (bc(a11) * z2i - (bc(a12i) * z1i + bc(a12q) * z1q)) / ddet
        s2q = (bc(a11) * z2q - (bc(a12i) * z1q - bc(a12q) * z1i)) / ddet
        # bias removal and SINR weights: d_k = g [A^-1]_kk
        d1 = torch.clamp(g * a22 / det, 0.0, 1.0 - 1e-6)
        d2 = torch.clamp(g * a11 / det, 0.0, 1.0 - 1e-6)
        s1i = s1i / bc(1.0 - d1)
        s1q = s1q / bc(1.0 - d1)
        s2i = s2i / bc(1.0 - d2)
        s2q = s2q / bc(1.0 - d2)
        w1 = (1.0 - d1) / (torch.clamp(d1, min=1e-12) * self._es)
        w2 = (1.0 - d2) / (torch.clamp(d2, min=1e-12) * self._es)
        # the streams back to virtual-symbol order [..., 2S, D]
        gi = torch.stack([s1i, s2i], dim=-2)      # [..., S, 2, D]
        gq = torch.stack([s1q, s2q], dim=-2)
        shp = gi.shape[:-3] + (2 * gi.shape[-3],) + gi.shape[-1:]
        return gi.reshape(shp), gq.reshape(shp), torch.stack([w1, w2], -2)

    def rx_frame(self, i1, q1, i2, q2, n_symbols: int,
                 noise_var: float = 0.0) -> torch.Tensor:
        """Two frame-aligned receive captures -> hard bits ``[...,
        n_symbols*bits_per_slot]``."""
        di, dq, _ = self.detect(i1, q1, i2, q2, n_symbols, noise_var)
        return _bits_of(self.m, di, dq)

    def rx_soft_frame(self, i1, q1, i2, q2, n_symbols: int,
                      noise_var: float) -> torch.Tensor:
        """Two frame-aligned receive captures -> SINR-weighted max-log
        LLRs (per-stream weights)."""
        di, dq, w = self.detect(i1, q1, i2, q2, n_symbols, noise_var)
        return _weighted_llrs(self.m, di, dq, w)

    def as_link_chain(self):
        """Chain adapter so :class:`~modem_tpu_torch.link.FramedLink` runs
        over the MIMO PHY (one "symbol" = one payload slot =
        ``bits_per_slot`` bits). The waveform is the pair of antenna
        streams; ``rx``/``rx_soft`` take the aligned receive captures
        ``(i1, q1, i2, q2)``."""
        return _MimoChain(self)


class _MimoScheme:
    def __init__(self, bits_per_symbol: int):
        self.bits_per_symbol = bits_per_symbol


class _MimoChain:
    """FramedLink adapter for :class:`MimoOfdm`."""

    def __init__(self, mimo: MimoOfdm):
        self.mimo = mimo
        self.scheme = _MimoScheme(mimo.bits_per_slot)

    def tx(self, bits: torch.Tensor):
        return self.mimo.tx(bits)

    def rx_soft(self, y, n_symbols: int,
                noise_var: float = 1.0) -> torch.Tensor:
        i1, q1, i2, q2 = y
        return self.mimo.rx_soft_frame(i1, q1, i2, q2, n_symbols,
                                       noise_var=noise_var)

    def rx(self, y, n_symbols: int) -> torch.Tensor:
        i1, q1, i2, q2 = y
        return self.mimo.rx_frame(i1, q1, i2, q2, n_symbols)


# ---- N x N: split-plane small-matrix MMSE ----

def _cmm(a, b):
    """``(re, im)`` matrix product over the two trailing axes, each entry a
    sum of elementwise products."""
    ar, ai = a
    br, bi = b

    def mm(x, y):
        return torch.sum(x[..., :, :, None] * y[..., None, :, :], dim=-2)

    return mm(ar, br) - mm(ai, bi), mm(ar, bi) + mm(ai, br)


def _chermt(a):
    ar, ai = a
    return ar.transpose(-1, -2), -ai.transpose(-1, -2)


def _csub(a, b):
    return a[0] - b[0], a[1] - b[1]


def _cinv_h(a, n: int):
    """Inverse of a Hermitian positive-definite ``(re, im)`` matrix pair of
    size ``n``: the 1x1 and 2x2 by adjugate (determinants real, clamped away
    from 0); larger sizes split ``[[P, Q], [Q^H, S]]`` and recurse on P and
    the Schur complement (every leading block of a Hermitian PD matrix is PD,
    so no pivoting)."""
    ar, ai = a
    if n == 1:
        d = torch.clamp(ar[..., 0, 0], min=1e-24)
        return (1.0 / d)[..., None, None], torch.zeros_like(ai)
    if n == 2:
        p = ar[..., 0, 0]
        s = ar[..., 1, 1]
        br, bi = ar[..., 0, 1], ai[..., 0, 1]
        det = torch.clamp(p * s - (br * br + bi * bi), min=1e-24)
        zero = torch.zeros_like(bi)
        rr = torch.stack([torch.stack([s, -br], dim=-1),
                          torch.stack([-br, p], dim=-1)], dim=-2)
        ri = torch.stack([torch.stack([zero, -bi], dim=-1),
                          torch.stack([bi, zero], dim=-1)], dim=-2)
        return rr / det[..., None, None], ri / det[..., None, None]
    m = n // 2

    def blk(r0, r1, c0, c1):
        return ar[..., r0:r1, c0:c1], ai[..., r0:r1, c0:c1]

    p, q, s = blk(0, m, 0, m), blk(0, m, m, n), blk(m, n, m, n)
    pi = _cinv_h(p, m)
    b = _cmm(pi, q)                       # P^-1 Q, [..., m, n-m]
    t = _cinv_h(_csub(s, _cmm(_chermt(q), b)), n - m)
    bt = _cmm(b, t)
    btb = _cmm(bt, _chermt(b))
    tl = (pi[0] + btb[0], pi[1] + btb[1])
    tr = (-bt[0], -bt[1])
    bl = _chermt(tr)
    return tuple(torch.cat([torch.cat([tl[r], tr[r]], dim=-1),
                            torch.cat([bl[r], t[r]], dim=-1)], dim=-2)
                 for r in range(2))


class MimoOfdmN:
    """``nt x nr`` spatially-multiplexed OFDM (``nt`` streams, ``nr >= nt``
    receive antennas), per-subcarrier MMSE: the N-antenna generalization of
    :class:`MimoOfdm`.

    Frame: ``[STF][LTF slot per TX antenna][payload]``; payload slot s
    carries ``nt`` streams (``nt * bits_per_sym`` bits). Detection inverts
    ``A = H^H H + g I`` per data bin by :func:`_cinv_h`; bias removal and
    the LLR weights follow :class:`MimoOfdm`'s convention. Antenna axes are
    stacked: ``[..., nt|nr, samples]``. ``device``: where the tables live
    (the card unless the caller asks for the CPU).
    """

    def __init__(self, scheme, nt: int = 4, n_fft: int = 64, cp: int = 16,
                 seed: int = 2016, device: torch.device | str | None = None,
                 **modem_kwargs):
        if nt < 1:
            raise ValueError("nt must be >= 1")
        data, pilots = _default_grid(n_fft)
        self.nt = int(nt)
        self.m = OfdmModem(scheme, n_fft=n_fft, cp=cp,
                           data_bins=data + pilots, pilot_bins=(),
                           n_ltf=1, seed=seed, device=device, **modem_kwargs)
        self.device = self.m.device
        self.bits_per_slot = self.nt * self.m.bits_per_sym
        self._es = _es(self.m)
        # the STF from antenna 0 only, then one LTF slot an antenna
        self.__dict__.update(_heads(self.m, **{
            str(a): ("stf" if a == 0 else None,) + tuple(
                "ltf" if j == a else None for j in range(self.nt))
            for a in range(self.nt)}))

    def _t(self, name: str) -> torch.Tensor:
        return on_device(self, name, lambda: getattr(self, name),
                         torch.float32, self.device)

    @property
    def preamble_len(self) -> int:
        return (1 + self.nt) * self.m.sym_len

    def frame_len(self, n_symbols: int) -> int:
        return self.preamble_len + n_symbols * self.m.sym_len

    def bits_per_frame(self, n_symbols: int) -> int:
        return n_symbols * self.bits_per_slot

    # ---- TX ----

    def tx(self, bits: torch.Tensor):
        """``[..., n_symbols*bits_per_slot]`` bits -> antenna waveforms
        ``(i, q)``, each ``[..., nt, frame_len]``."""
        m, nt = self.m, self.nt
        di, dq = m.map_bits(bits)                 # [..., nt*S, D]
        if di.shape[-2] % nt:
            raise ValueError(f"virtual symbol count must divide by {nt}")
        outs = [_framed(m, self._t(f"_head_{a}i"), self._t(f"_head_{a}q"),
                        di[..., a::nt, :], dq[..., a::nt, :])
                for a in range(nt)]
        return (torch.stack([o[0] for o in outs], dim=-2),
                torch.stack([o[1] for o in outs], dim=-2))

    # ---- RX ----

    def detect(self, yi: torch.Tensor, yq: torch.Tensor, n_symbols: int,
               noise_var: float = 0.0):
        """``[..., nr, frame_len]`` aligned captures -> per-stream decision
        points ``(di, dq, w)``: unbiased MMSE estimates in virtual-symbol
        order ``[..., nt*S, D]`` and LLR weights ``w [..., nt, D]``."""
        m, nt = self.m, self.nt
        nr = yi.shape[-2]
        if nr < nt:
            raise ValueError(f"need nr >= nt receive antennas ({nr} < {nt})")
        hs_i, hs_q, sp_i, sp_q = [], [], [], []
        for j in range(nr):
            hs, (si, sq) = _slot_estimates(m, yi[..., j, :], yq[..., j, :],
                                           nt, n_symbols)
            # [..., D, nt] each
            hs_i.append(torch.stack([h[0] for h in hs], dim=-1))
            hs_q.append(torch.stack([h[1] for h in hs], dim=-1))
            sp_i.append(si)                       # [..., S, D]
            sp_q.append(sq)
        # h: [..., D, nr, nt]; y: [..., S, D, nr, 1]; the algebra from
        # here in float64 (see the module notes)
        h = (torch.stack(hs_i, dim=-2).double(),
             torch.stack(hs_q, dim=-2).double())
        y = (torch.stack(sp_i, dim=-1)[..., None].double(),
             torch.stack(sp_q, dim=-1)[..., None].double())
        g = float(np.float32(noise_var / self._es))
        hh = _chermt(h)
        ar, ai = _cmm(hh, h)                      # [..., D, nt, nt]
        ar = ar + g * torch.eye(nt, dtype=ar.dtype, device=ar.device)
        ainv = _cinv_h((ar, ai), nt)
        z = _cmm((hh[0][..., None, :, :, :], hh[1][..., None, :, :, :]), y)
        s_hat = _cmm((ainv[0][..., None, :, :, :],
                      ainv[1][..., None, :, :, :]), z)  # [..., S, D, nt, 1]
        # bias removal and SINR weights: d_k = g [A^-1]_kk (real)
        diag = torch.diagonal(ainv[0], dim1=-2, dim2=-1)  # [..., D, nt]
        d = torch.clamp(g * diag, 0.0, 1.0 - 1e-6)
        si = s_hat[0][..., 0] / (1.0 - d)[..., None, :, :]
        sq = s_hat[1][..., 0] / (1.0 - d)[..., None, :, :]
        w = (1.0 - d) / (torch.clamp(d, min=1e-12) * self._es)
        # [..., S, D, nt] -> virtual-symbol order [..., nt*S, D]
        gi = si.transpose(-1, -2)                 # [..., S, nt, D]
        gq = sq.transpose(-1, -2)
        shp = gi.shape[:-3] + (gi.shape[-3] * nt,) + gi.shape[-1:]
        return (gi.reshape(shp).float(), gq.reshape(shp).float(),
                w.transpose(-1, -2).float())

    def rx_frame(self, yi, yq, n_symbols: int,
                 noise_var: float = 0.0) -> torch.Tensor:
        """Aligned captures -> hard bits ``[..., n_symbols*bits_per_slot]``."""
        di, dq, _ = self.detect(yi, yq, n_symbols, noise_var)
        return _bits_of(self.m, di, dq)

    def rx_soft_frame(self, yi, yq, n_symbols: int,
                      noise_var: float) -> torch.Tensor:
        """Aligned captures -> SINR-weighted max-log LLRs."""
        di, dq, w = self.detect(yi, yq, n_symbols, noise_var)
        return _weighted_llrs(self.m, di, dq, w)

    def as_link_chain(self):
        """FramedLink adapter (one "symbol" = one slot of nt streams); the
        waveform is the stacked antenna pair ``(i, q)``."""
        return _MimoChainN(self)


class _MimoChainN:
    def __init__(self, mimo: MimoOfdmN):
        self.mimo = mimo
        self.scheme = _MimoScheme(mimo.bits_per_slot)

    def tx(self, bits: torch.Tensor):
        return self.mimo.tx(bits)

    def rx_soft(self, y, n_symbols: int,
                noise_var: float = 1.0) -> torch.Tensor:
        yi, yq = y
        return self.mimo.rx_soft_frame(yi, yq, n_symbols,
                                       noise_var=noise_var)

    def rx(self, y, n_symbols: int) -> torch.Tensor:
        yi, yq = y
        return self.mimo.rx_frame(yi, yq, n_symbols)
