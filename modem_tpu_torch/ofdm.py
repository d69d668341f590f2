"""OFDM modem: multicarrier TX/RX over real I/Q planes (counterpart of
:mod:`modem_tpu.ofdm`).

The constellation layer of the package (scheme tables,
:func:`~modem_tpu_torch.ops.slicer.lut_slice`,
:func:`~modem_tpu_torch.ops.llr.lut_llr`) inside an OFDM PHY:

* the IDFT and DFT are reduced real matmuls: only the used bins' rows of the
  DFT matrix are kept, so TX is ``[S, D] @ [D, N]`` and RX ``[S, N] @ [N,
  U]`` (``torch.matmul`` in float32; PyTorch's default keeps TF32 off for
  these); the pilots are a precomputed time-domain row added per symbol;
* the cyclic prefix is slicing and a reshape;
* blind acquisition (:meth:`OfdmModem.locate_frame`) is the Schmidl & Cox
  metric by prefix sums (:func:`~modem_tpu_torch.ops.sync_metric
  .periodic_similarity`), the fractional CFO from its angle, and fine timing
  against the whole preamble as four causal FIR passes
  (:func:`~modem_tpu_torch.ops.sync_metric.correlate_reversed`): kernel K4
  with the 240-tap reversed preamble as taps on a CUDA tensor;
* equalization is elementwise: the LS channel estimate from the LTFs
  (optionally projected onto the CP's delay subspace), one complex tap a
  bin, and per-symbol pilot tracking of the common phase and gain
  (``"cpe"``) or of phase and slope across the pilots (``"sfo"``).

Frame layout (every symbol ``n_fft + cp`` samples)::

    [ STF ] [ LTF x n_ltf ] [ payload symbol ] ... [ payload symbol ]

Every table comes from the JAX package's seeded numpy code, so both packages
build the same frames. A modem's tables live on its ``device``, the card
unless the caller asks for the CPU.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .cuda import resolve_device
from .ops.llr import lut_llr
from .ops.slicer import lut_map, lut_slice
from .ops.sync_metric import (aligned_frame_matmul, correlate_reversed,
                              periodic_similarity)
from .utils.bits import pack_bits, unpack_symbols
from .utils.cache import on_device


def _angle(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    return torch.atan2(im, re)


@lru_cache(maxsize=16)
def _dft_rows(n_fft: int, bins: tuple) -> tuple[np.ndarray, np.ndarray]:
    """cos/sin rows of the N-point DFT for the given bins: ``[B, N]`` each,
    ``C[b, n] = cos(2*pi*bins[b]*n/N)`` (bins may be negative)."""
    k = np.asarray(bins, np.int64)[:, None]
    n = np.arange(n_fft, dtype=np.int64)[None, :]
    ang = 2.0 * np.pi * ((k * n) % n_fft) / n_fft
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def _default_grid(n_fft: int) -> tuple[tuple, tuple]:
    """(data_bins, pilot_bins) for an 802.11a-style loading: 52 used bins
    ±(1..26) with pilots at ±7, ±21, scaled to other FFT sizes."""
    half = (n_fft * 26) // 64
    pil = ((n_fft * 7) // 64, (n_fft * 21) // 64)
    used = [b for b in range(-half, half + 1) if b != 0]
    pilots = tuple(sorted((-pil[1], -pil[0], pil[0], pil[1])))
    data = tuple(b for b in used if b not in pilots)
    return data, pilots


class OfdmModem:
    """OFDM PHY around any constellation (LUT) scheme of the package.

    ``n_fft``, ``cp``: FFT size and cyclic prefix (``cp`` must exceed the
    channel's delay spread); ``data_bins``, ``pilot_bins``: signed bins
    (default the 52-bin grid, 48 data and 4 pilots at N=64, scaled
    otherwise); ``n_ltf``: LTF repetitions averaged into the LS channel
    estimate; ``channel_denoise``: project that estimate onto the <= cp-tap
    delay subspace; ``pilot_tracking``: ``"cpe"`` (common phase and gain
    per symbol) or ``"sfo"`` (a weighted LS fit of phase = cpe + slope *
    bin across the pilots); ``device``: where the tables live (the card
    unless the caller asks for the CPU).
    """

    def __init__(self, scheme, n_fft: int = 64, cp: int = 16,
                 data_bins: tuple | None = None,
                 pilot_bins: tuple | None = None,
                 n_ltf: int = 2, seed: int = 2016,
                 pilot_tracking: str = "cpe",
                 channel_denoise: bool = False,
                 device: torch.device | str | None = None):
        if not hasattr(scheme, "lut"):
            raise ValueError("OFDM needs a constellation (LUT) scheme")
        if n_fft % 4:
            raise ValueError("n_fft must divide by 4 (STF periodicity)")
        if data_bins is None and pilot_bins is None:
            data_bins, pilot_bins = _default_grid(n_fft)
        if data_bins is None:
            raise ValueError(
                "data_bins is required when pilot_bins is given (pass "
                "both, or neither for the default grid)")
        if n_ltf < 1:
            raise ValueError("need n_ltf >= 1 (the LS channel estimate "
                             "averages over the LTF repetitions)")
        if pilot_tracking not in ("cpe", "sfo"):
            raise ValueError("pilot_tracking must be 'cpe' or 'sfo'")
        self.channel_denoise = bool(channel_denoise)
        if pilot_tracking == "sfo" and len(pilot_bins or ()) < 2:
            raise ValueError("sfo tracking needs >= 2 pilot bins to fit "
                             "a phase slope")
        self.pilot_tracking = pilot_tracking
        data_bins = tuple(int(b) for b in data_bins)
        pilot_bins = tuple(int(b) for b in (pilot_bins or ()))
        if set(data_bins) & set(pilot_bins):
            raise ValueError("data and pilot bins overlap")
        for b in data_bins + pilot_bins:
            if not -n_fft // 2 < b < n_fft // 2 or b == 0:
                raise ValueError(f"bin {b} outside (-{n_fft//2}, {n_fft//2})"
                                 " or DC")
        self.device = resolve_device(device)
        self.scheme = scheme
        self.lut = np.asarray(scheme.lut, np.float32)
        self.bits_per_symbol = scheme.bits_per_symbol
        self.n_fft = int(n_fft)
        self.cp = int(cp)
        self.sym_len = self.n_fft + self.cp
        self.data_bins = data_bins
        self.pilot_bins = pilot_bins
        self.used_bins = tuple(sorted(data_bins + pilot_bins))
        self.n_data = len(data_bins)
        self.n_ltf = int(n_ltf)
        self.bits_per_sym = self.n_data * self.bits_per_symbol

        rng = np.random.default_rng(seed)
        # pilots: fixed BPSK per pilot bin, polarity flipped per symbol by a
        # fixed PN sequence
        self._pilot_vals = (2.0 * rng.integers(0, 2, len(pilot_bins))
                            - 1.0).astype(np.float32)
        self._polarity_pn = (2.0 * rng.integers(0, 2, 4096)
                             - 1.0).astype(np.float32)
        # LTF: BPSK on every used bin
        self._ltf_vals = (2.0 * rng.integers(0, 2, len(self.used_bins))
                          - 1.0).astype(np.float32)
        # STF: QPSK on every 4th bin (time period n_fft/4), boosted to the
        # payload's power
        stf_bins = tuple(b for b in self.used_bins if b % 4 == 0)
        if not stf_bins:
            raise ValueError("no bins divisible by 4 for the STF")
        ph = rng.uniform(0.0, 2.0 * np.pi, len(stf_bins))
        boost = np.sqrt(len(self.used_bins) / len(stf_bins))
        self._stf_bins = stf_bins
        self._stf_i = (boost * np.cos(ph)).astype(np.float32)
        self._stf_q = (boost * np.sin(ph)).astype(np.float32)

        n = self.n_fft
        scale = np.float32(1.0 / np.sqrt(n))
        cd, sd = _dft_rows(n, data_bins)
        cp_, sp_ = _dft_rows(n, pilot_bins) if pilot_bins else (
            np.zeros((0, n), np.float32), np.zeros((0, n), np.float32))
        cu, su = _dft_rows(n, self.used_bins)
        self._tx_c = (cd * scale).astype(np.float32)   # [D, N]
        self._tx_s = (sd * scale).astype(np.float32)
        self._rx_c = (cu.T * scale).astype(np.float32)  # [N, U]
        self._rx_s = (su.T * scale).astype(np.float32)
        self._rx_cd = self._tx_c.T.copy()               # [N, D]
        self._rx_sd = self._tx_s.T.copy()
        self._rx_cp = (cp_.T * scale).astype(np.float32)  # [N, P]
        self._rx_sp = (sp_.T * scale).astype(np.float32)
        self._pilot_ti = scale * (self._pilot_vals @ cp_)
        self._pilot_tq = scale * (self._pilot_vals @ sp_)
        self._ltf_ti = scale * (self._ltf_vals @ cu)
        self._ltf_tq = scale * (self._ltf_vals @ su)
        cs_, ss_ = _dft_rows(n, stf_bins)
        self._stf_ti = scale * (self._stf_i @ cs_ - self._stf_q @ ss_)
        self._stf_tq = scale * (self._stf_i @ ss_ + self._stf_q @ cs_)
        self._data_in_used = np.asarray(
            [self.used_bins.index(b) for b in data_bins], np.int64)
        self._pilot_in_used = np.asarray(
            [self.used_bins.index(b) for b in pilot_bins], np.int64)
        # delay-subspace projector P = F (F^H F)^-1 F^H, F[u, l] =
        # e^{-j 2 pi k_u l / N} over the cp delays
        ku = np.asarray(self.used_bins, np.float64)[:, None]
        ll = np.arange(self.cp, dtype=np.float64)[None, :]
        f = np.exp(-2j * np.pi * ku * ll / n)
        proj = f @ np.linalg.pinv(f)
        self._denoise_re = np.ascontiguousarray(
            proj.T.real.astype(np.float32))
        self._denoise_im = np.ascontiguousarray(
            proj.T.imag.astype(np.float32))

        # the CP-extended preamble (STF + n_ltf x LTF), one copy shared by
        # tx_frame and the fine-timing template
        def head(parts):
            return np.concatenate(
                [np.concatenate([t[-self.cp:], t]) for t in parts]
            ).astype(np.float32)
        self._preamble_i = head([self._stf_ti] + [self._ltf_ti] * n_ltf)
        self._preamble_q = head([self._stf_tq] + [self._ltf_tq] * n_ltf)

    def _t(self, name: str, dtype: torch.dtype = torch.float32
           ) -> torch.Tensor:
        """The table ``self.<name>`` as a tensor on the modem's device."""
        return on_device(self, name, lambda: getattr(self, name), dtype,
                         self.device)

    # ---- frame geometry ----

    @property
    def preamble_len(self) -> int:
        """Samples before the first payload symbol in a full frame."""
        return (1 + self.n_ltf) * self.sym_len

    def frame_len(self, n_symbols: int) -> int:
        return self.preamble_len + n_symbols * self.sym_len

    def bits_per_frame(self, n_symbols: int) -> int:
        return n_symbols * self.bits_per_sym

    def _polarity(self, n_symbols: int) -> np.ndarray:
        pn = self._polarity_pn
        if n_symbols > pn.size:
            pn = np.tile(pn, -(-n_symbols // pn.size))
        return pn[:n_symbols]

    def _pol(self, n_symbols: int) -> torch.Tensor:
        """The pilot polarity of ``n_symbols`` symbols, ``[S, 1]``."""
        return on_device(self, ("pol", n_symbols),
                         lambda: self._polarity(n_symbols)[:, None],
                         torch.float32, self.device)

    # ---- TX ----

    def map_bits(self, bits: torch.Tensor):
        """``[..., S*bits_per_sym]`` bits -> data-bin I/Q ``[..., S, D]``."""
        if bits.shape[-1] % self.bits_per_sym:
            raise ValueError(
                f"bit count {bits.shape[-1]} must divide by "
                f"{self.bits_per_sym} (= {self.n_data} data bins x "
                f"{self.bits_per_symbol} bits)")
        syms = pack_bits(bits, self.bits_per_symbol)
        s = syms.shape[-1] // self.n_data
        syms = syms.reshape(syms.shape[:-1] + (s, self.n_data))
        return lut_map(syms, self._t("lut"))

    def _payload_td(self, di: torch.Tensor, dq: torch.Tensor):
        """Data-bin I/Q ``[..., S, D]`` -> time-domain symbols ``[..., S,
        N]`` (pilot overlay added, no CP yet)."""
        tc, ts = self._t("_tx_c"), self._t("_tx_s")
        xi = di @ tc - dq @ ts
        xq = di @ ts + dq @ tc
        if self.pilot_bins:
            pol = self._pol(di.shape[-2])
            xi = xi + pol * self._t("_pilot_ti")
            xq = xq + pol * self._t("_pilot_tq")
        return xi, xq

    @staticmethod
    def _add_cp(xi: torch.Tensor, xq: torch.Tensor, cp: int):
        """``[..., S, N]`` -> serialized ``[..., S*(N+cp)]``."""
        def one(x):
            xcp = torch.cat([x[..., -cp:], x], dim=-1)
            return xcp.reshape(xcp.shape[:-2] + (-1,))
        return one(xi), one(xq)

    def tx_payload(self, bits: torch.Tensor):
        """Bits -> payload sample stream (no preamble), ``[...,
        S*sym_len]``."""
        di, dq = self.map_bits(bits)
        xi, xq = self._payload_td(di, dq)
        return self._add_cp(xi, xq, self.cp)

    def tx_frame(self, bits: torch.Tensor):
        """Bits -> full frame: STF + n_ltf x LTF + payload."""
        pi, pq = self.tx_payload(bits)
        hi = self._t("_preamble_i").expand(pi.shape[:-1] + (-1,))
        hq = self._t("_preamble_q").expand(pq.shape[:-1] + (-1,))
        return torch.cat([hi, pi], dim=-1), torch.cat([hq, pq], dim=-1)

    # ---- RX (frame-aligned) ----

    def _strip_cp(self, i: torch.Tensor, q: torch.Tensor, n_symbols: int):
        """Aligned sample stream -> ``[..., S, N]`` FFT windows."""
        need = n_symbols * self.sym_len
        if i.shape[-1] < need:
            raise ValueError(f"need {need} samples, got {i.shape[-1]}")

        def one(x):
            x = x[..., :need].reshape(x.shape[:-1] + (n_symbols,
                                                      self.sym_len))
            return x[..., self.cp:]
        return one(i), one(q)

    def _dft(self, xi: torch.Tensor, xq: torch.Tensor, c: str, s: str):
        """``[..., N]`` time windows -> the spectra of the bins whose DFT
        columns are the tables ``c``, ``s``."""
        rc, rs = self._t(c), self._t(s)
        return xi @ rc + xq @ rs, xq @ rc - xi @ rs

    def estimate_channel(self, i: torch.Tensor, q: torch.Tensor,
                         denoise: bool | None = None):
        """LS channel estimate from the aligned LTF section ``i, q [...,
        n_ltf*sym_len]`` (starting at LTF 0's CP): per-used-bin ``(hi, hq)
        [..., U]`` averaged over the repetitions. ``denoise`` (the modem's
        ``channel_denoise`` if None) projects it onto the <= cp-tap delay
        subspace."""
        if denoise is None:
            denoise = self.channel_denoise
        xi, xq = self._strip_cp(i, q, self.n_ltf)
        yi, yq = self._dft(xi, xq, "_rx_c", "_rx_s")
        li = self._t("_ltf_vals")
        hi = torch.mean(yi * li, dim=-2)
        hq = torch.mean(yq * li, dim=-2)
        if denoise:
            pr, pi_ = self._t("_denoise_re"), self._t("_denoise_im")
            hi, hq = hi @ pr - hq @ pi_, hi @ pi_ + hq @ pr
        return hi, hq

    def _equalize(self, i: torch.Tensor, q: torch.Tensor, n_symbols: int,
                  h=None):
        """Aligned payload stream -> equalized data-bin points ``(di, dq,
        m2)``, ``m2 [..., D]`` = |H|^2 at the data bins. ``h``: ``(hi, hq)``
        from :meth:`estimate_channel`; None = ideal channel."""
        xi, xq = self._strip_cp(i, q, n_symbols)
        yi, yq = self._dft(xi, xq, "_rx_cd", "_rx_sd")   # [..., S, D]
        if h is None:
            hdi = yi.new_ones(yi.shape[:-2] + (1, self.n_data))
            hdq = torch.zeros_like(hdi)
            hpi = yi.new_ones(yi.shape[:-2] + (1, len(self.pilot_bins)))
            hpq = torch.zeros_like(hpi)
        else:
            hi, hq = h
            d, p = (self._t(n, torch.int64) for n in ("_data_in_used",
                                                      "_pilot_in_used"))
            hdi, hdq = hi[..., d][..., None, :], hq[..., d][..., None, :]
            hpi, hpq = hi[..., p][..., None, :], hq[..., p][..., None, :]
        if self.pilot_bins:
            # ri + j rq: the expected pilot after the channel; ei + j eq =
            # Y conj(R), each pilot's residual rotation, |R|^2-weighted
            ypi, ypq = self._dft(xi, xq, "_rx_cp", "_rx_sp")  # [..., S, P]
            pv = self._t("_pilot_vals")
            pol = self._pol(n_symbols)
            ri = hpi * pv * pol
            rq = hpq * pv * pol
            ei = ypi * ri + ypq * rq
            eq = ypq * ri - ypi * rq
            wgt = ri * ri + rq * rq
            e = torch.sum(wgt, dim=-1, keepdim=True)
            if self.pilot_tracking == "sfo":
                # weighted LS of phase = cpe + slope * bin across pilots
                phi = torch.atan2(eq, ei)
                kp = self._t("pilot_bins")
                s1 = torch.sum(wgt * kp, dim=-1, keepdim=True)
                s2 = torch.sum(wgt * kp * kp, dim=-1, keepdim=True)
                b0 = torch.sum(wgt * phi, dim=-1, keepdim=True)
                b1 = torch.sum(wgt * kp * phi, dim=-1, keepdim=True)
                det = torch.clamp(e * s2 - s1 * s1, min=1e-24)
                cpe = (s2 * b0 - s1 * b1) / det
                slope = (e * b1 - s1 * b0) / det
                amp = torch.clamp(
                    torch.sum(torch.sqrt(ei * ei + eq * eq), dim=-1,
                              keepdim=True) / torch.clamp(e, min=1e-24),
                    min=1e-12)
                th = cpe + slope * self._t("data_bins")  # [..., S, D]
                c_, s_ = torch.cos(th), torch.sin(th)
                yi, yq = ((yi * c_ + yq * s_) / amp,
                          (yq * c_ - yi * s_) / amp)
            else:
                # common phase and gain per symbol: divide by c/e, c the
                # pilots' complex sum
                ci = torch.sum(ei, dim=-1, keepdim=True)
                cq = torch.sum(eq, dim=-1, keepdim=True)
                m2c = torch.clamp(ci * ci + cq * cq, min=1e-24)
                yi, yq = ((yi * ci + yq * cq) * e / m2c,
                          (yq * ci - yi * cq) * e / m2c)
        m2 = torch.clamp(hdi * hdi + hdq * hdq, min=1e-24)
        return ((yi * hdi + yq * hdq) / m2,
                (yq * hdi - yi * hdq) / m2, m2[..., 0, :])

    def rx_payload(self, i: torch.Tensor, q: torch.Tensor, n_symbols: int,
                   h=None) -> torch.Tensor:
        """Aligned payload stream -> hard bits ``[..., S*bits_per_sym]``."""
        di, dq, _ = self._equalize(i, q, n_symbols, h)
        syms = lut_slice(di, dq, self._t("lut"))
        bits = unpack_symbols(syms, self.bits_per_symbol)
        return bits.reshape(bits.shape[:-2] + (-1,))

    def rx_soft_payload(self, i: torch.Tensor, q: torch.Tensor,
                        n_symbols: int, h=None,
                        noise_var: float = 1.0) -> torch.Tensor:
        """Aligned payload stream -> max-log LLRs, each bin's scaled by its
        ``|H_k|^2`` (the per-bin noise after the one-tap equalizer is
        ``noise_var / |H_k|^2``)."""
        di, dq, m2 = self._equalize(i, q, n_symbols, h)
        llr = lut_llr(di, dq, self._t("lut"), self.bits_per_symbol, 1.0)
        llr = llr.reshape(llr.shape[:-1] + (self.n_data,
                                            self.bits_per_symbol))
        w = (m2 / float(np.float32(noise_var)))[..., None, :, None]
        return (llr * w).reshape(llr.shape[:-3] + (-1,))

    def rx_frame(self, i: torch.Tensor, q: torch.Tensor,
                 n_symbols: int) -> torch.Tensor:
        """Frame-aligned stream (at the STF's first sample) -> bits."""
        off = self.sym_len
        nl = self.n_ltf * self.sym_len
        h = self.estimate_channel(i[..., off:off + nl], q[..., off:off + nl])
        off += nl
        return self.rx_payload(i[..., off:], q[..., off:], n_symbols, h)

    # ---- blind acquisition (Schmidl & Cox + preamble fine timing) ----

    def sc_metric(self, i: torch.Tensor, q: torch.Tensor, max_lag: int):
        """Schmidl & Cox metric over lags ``[0, max_lag)``: the STF's
        period-``n_fft/4`` self-similarity over the whole STF symbol (CP
        included), ``(M, P_i, P_q)``."""
        lag = self.n_fft // 4
        return periodic_similarity(i, q, lag=lag, width=self.sym_len - lag,
                                   max_lag=max_lag)

    def _preamble_correlate(self, ci: torch.Tensor, cq: torch.Tensor,
                            max_lag: int, correlator: str):
        """Complex correlation against the preamble at lags ``[0,
        max_lag)``, ``(cr, cj) [..., max_lag]``: ``"fir"`` four causal FIR
        passes (K4 on a CUDA tensor) or ``"gather"`` the ``[max_lag, P]``
        windows reduced."""
        if correlator == "fir":
            rev = [on_device(self, ("rev", n),
                             lambda n=n: getattr(self, n)[::-1].copy(),
                             torch.float32, ci.device)
                   for n in ("_preamble_i", "_preamble_q")]
            return correlate_reversed(ci, cq, rev[0], rev[1], max_lag)
        if correlator != "gather":
            raise ValueError(f"unknown correlator {correlator!r}")
        idx = (torch.arange(max_lag, device=ci.device)[:, None]
               + torch.arange(self.preamble_len, device=ci.device)[None, :])
        wi, wq = ci[..., idx], cq[..., idx]
        ti, tq = self._t("_preamble_i"), self._t("_preamble_q")
        cr = torch.sum(wi * ti + wq * tq, dim=-1)
        cj = torch.sum(wq * ti - wi * tq, dim=-1)
        return cr, cj

    def locate_frame(self, i: torch.Tensor, q: torch.Tensor,
                     n_symbols: int, max_lag: int,
                     correlator: str = "fir", aligner: str = "matmul"):
        """The blind front end of :meth:`acquire` and :meth:`acquire_soft`:
        S&C coarse timing and the closed-form fractional CFO, derotation,
        fine timing against the whole preamble, and the located frame's
        samples. Returns ``(fi, fq, report)``. ``aligner``: ``"matmul"``
        (:func:`~modem_tpu_torch.ops.sync_metric.aligned_frame_matmul`) or
        ``"gather"``; both are one gather here."""
        if aligner not in ("matmul", "gather"):
            raise ValueError(f"unknown aligner {aligner!r}")
        need = max_lag + self.frame_len(n_symbols)
        if i.shape[-1] < need:
            pad = i.new_zeros(i.shape[:-1] + (need - i.shape[-1],))
            i, q = torch.cat([i, pad], dim=-1), torch.cat([q, pad], dim=-1)
        # 1) coarse timing and fractional CFO from the STF periodicity
        lag = self.n_fft // 4
        m, ps_i, ps_q = self.sc_metric(i, q, max_lag + self.cp)
        coarse = torch.argmax(m, dim=-1, keepdim=True)
        pk_i = torch.gather(ps_i, -1, coarse)
        pk_q = torch.gather(ps_q, -1, coarse)
        cfo = _angle(pk_i, pk_q) / lag  # rad/sample, within ±2 bins
        # 2) derotate the capture
        n = torch.arange(i.shape[-1], dtype=torch.float32, device=i.device)
        th = -cfo * n
        c, s = torch.cos(th), torch.sin(th)
        ci = i * c - q * s
        cq = i * s + q * c
        # 3) fine timing against the whole preamble (STF and every LTF,
        #    CPs included): only the true start scores every part
        cr, cj = self._preamble_correlate(ci, cq, max_lag, correlator)
        start = torch.argmax(cr * cr + cj * cj, dim=-1).to(torch.int32)
        # 4) the frame at the located start
        fi, fq = aligned_frame_matmul(ci, cq, start, self.frame_len(n_symbols),
                                      max_lag)
        report = {"start": start, "cfo_rad_per_sample": cfo[..., 0],
                  "sc_peak": torch.gather(m, -1, coarse)[..., 0]}
        return fi, fq, report

    def acquire(self, i: torch.Tensor, q: torch.Tensor, n_symbols: int,
                max_lag: int, correlator: str = "fir"):
        """Blind RX: frame start unknown in ``[0, max_lag)``, CFO up to ±2
        subcarriers, flat gain and phase, CP-short multipath. Returns
        ``(bits, report)`` (the located start, the fractional CFO in
        rad/sample, the S&C peak); captures shorter than the last candidate
        frame's end are zero-padded."""
        fi, fq, report = self.locate_frame(i, q, n_symbols, max_lag,
                                           correlator)
        return self.rx_frame(fi, fq, n_symbols), report

    def acquire_soft(self, i: torch.Tensor, q: torch.Tensor,
                     n_symbols: int, max_lag: int,
                     noise_var: float = 1.0, correlator: str = "fir"):
        """Blind RX to channel-weighted LLRs: ``(llrs, report)``."""
        fi, fq, report = self.locate_frame(i, q, n_symbols, max_lag,
                                           correlator)
        off = self.sym_len
        h = self.estimate_channel(fi[..., off:self.preamble_len],
                                  fq[..., off:self.preamble_len])
        llrs = self.rx_soft_payload(fi[..., self.preamble_len:],
                                    fq[..., self.preamble_len:],
                                    n_symbols, h, noise_var=noise_var)
        return llrs, report


class _OfdmSchemeShim:
    def __init__(self, bits_per_symbol: int):
        self.bits_per_symbol = bits_per_symbol


class OfdmChain:
    """Chain adapter that lets :class:`~modem_tpu_torch.link.FramedLink` run
    over an OFDM PHY: one OFDM symbol is "a symbol" of
    ``modem.bits_per_sym`` bits; ``tx`` emits a full frame, ``rx_soft``
    estimates the channel from the frame's own LTFs. Frame-aligned
    waveforms (acquire first for captures); no fused forms, so the link's
    fused route takes the staged one."""

    def __init__(self, modem: OfdmModem):
        self.modem = modem
        self.scheme = _OfdmSchemeShim(modem.bits_per_sym)

    def tx(self, bits: torch.Tensor):
        return self.modem.tx_frame(bits)

    def rx_soft(self, iq, n_symbols: int,
                noise_var: float = 1.0) -> torch.Tensor:
        i, q = iq
        m = self.modem
        off = m.sym_len
        h = m.estimate_channel(i[..., off:m.preamble_len],
                               q[..., off:m.preamble_len])
        return m.rx_soft_payload(i[..., m.preamble_len:],
                                 q[..., m.preamble_len:], n_symbols, h,
                                 noise_var=noise_var)

    def rx(self, iq, n_symbols: int) -> torch.Tensor:
        i, q = iq
        return self.modem.rx_frame(i, q, n_symbols)


class OfdmStreamReceiver:
    """Continuous blind burst receiver over an unbounded OFDM sample stream
    on the modem's device.

    ``push(i, q)`` takes chunks of any size and returns the frames completed
    so far, each ``(bits, report)`` with the frame start as a global stream
    index. Detection thresholds the S&C metric over the leading ``max_lag``
    lags of a window of ``max_lag + frame_len`` samples (one host read of
    its peak a step); each detected burst runs
    :meth:`OfdmModem.locate_frame` and :meth:`OfdmModem.rx_frame`. Frames
    equal :meth:`OfdmModem.acquire` on an aligned capture, however the
    stream is chunked.
    """

    def __init__(self, modem: OfdmModem, n_symbols: int,
                 max_lag: int | None = None, threshold: float = 0.6):
        self.modem = modem
        self.n_symbols = int(n_symbols)
        self.frame_len = modem.frame_len(n_symbols)
        # >= one symbol, so a frame starting just past the range fully
        # enters the next window
        self.max_lag = int(max_lag) if max_lag else 2 * modem.sym_len
        if self.max_lag > self.frame_len:
            # at most one frame start fits a range of <= frame_len, so the
            # fine-timing argmax cannot skip an earlier burst
            raise ValueError(
                f"max_lag ({self.max_lag}) must be <= frame_len "
                f"({self.frame_len}): a larger detection range could hold "
                "two bursts and the argmax would drop one")
        self.win = self.max_lag + self.frame_len
        self.threshold = float(threshold)
        self._reset()

    def _reset(self) -> None:
        self._buf_i = torch.zeros((0,), device=self.modem.device)
        self._buf_q = torch.zeros((0,), device=self.modem.device)
        self._pos = 0  # global stream index of _buf[0]

    def _detect(self, i: torch.Tensor, q: torch.Tensor):
        met, _, _ = self.modem.sc_metric(i, q, self.max_lag)
        c = torch.argmax(met, dim=-1)
        return met[c], c

    def _decode(self, i: torch.Tensor, q: torch.Tensor):
        m = self.modem
        fi, fq, rep = m.locate_frame(i, q, self.n_symbols, self.max_lag)
        return m.rx_frame(fi, fq, self.n_symbols), rep

    def push(self, i, q) -> list:
        """Append a chunk; returns ``[(bits, report), ...]`` for every frame
        now fully buffered, ``report`` :meth:`OfdmModem.locate_frame`'s with
        ``start`` the global stream index (host int) and an ``sc_detect``
        score."""
        dev = self.modem.device
        self._buf_i = torch.cat(
            [self._buf_i, torch.as_tensor(i, dtype=torch.float32,
                                          device=dev)], -1)
        self._buf_q = torch.cat(
            [self._buf_q, torch.as_tensor(q, dtype=torch.float32,
                                          device=dev)], -1)
        return self._drain(final=False)

    def flush(self) -> list:
        """End of stream: zero-pad the residue to one last full window and
        drain a final frame whose preamble is buffered; the receiver then
        starts a fresh stream (global indices from 0)."""
        if self._buf_i.shape[-1] > self.modem.preamble_len:
            pad = self._buf_i.new_zeros((self.win,))
            self._buf_i = torch.cat([self._buf_i, pad], -1)
            self._buf_q = torch.cat([self._buf_q, pad], -1)
        out = self._drain(final=True)
        self._reset()
        return out

    def _advance(self, n: int) -> None:
        self._buf_i = self._buf_i[..., n:]
        self._buf_q = self._buf_q[..., n:]
        self._pos += n

    def _drain(self, final: bool) -> list:
        frames = []
        sym_len = self.modem.sym_len
        while self._buf_i.shape[-1] >= self.win:
            wi = self._buf_i[..., :self.win]
            wq = self._buf_q[..., :self.win]
            peak, coarse = self._detect(wi, wq)
            if float(peak) < self.threshold:
                # no STF plateau in the leading lags: skip ahead, keeping
                # one symbol of lookback for a plateau cut at the seam
                self._advance(self.max_lag - sym_len
                              if self.max_lag > sym_len else self.max_lag)
                continue
            c = int(coarse)
            if c > self.max_lag - sym_len and not final:
                # plateau near the end of the range: realign so the burst
                # sits early in the next window
                self._advance(max(1, c - self.modem.cp))
                continue
            bits, rep = self._decode(wi, wq)
            start = int(rep["start"])
            rep = dict(rep)
            rep["start"] = self._pos + start
            rep["sc_detect"] = float(peak)
            frames.append((bits, rep))
            self._advance(start + self.frame_len)
        return frames
