"""Adaptive bit loading: per-subcarrier constellations from measured SNR
(counterpart of :mod:`modem_tpu.bitloading`).

:func:`bit_loading` is the host-side rule (the gap approximation, ``b_k =
log2(1 + SNR_k / gap)`` floored to the supported sizes); :class:`AdaptiveOfdm`
carries a mixed-constellation payload. The loading is configuration, as in
the JAX package: the active bins split into static groups, one a
constellation size, each mapped, sliced and soft-demapped through its own
unit-power table, and the groups' results go back in order by static
permutations. The per-group indices and tables are copied to the modem's
device once. Framing (preamble, pilots, CP, channel estimation, pilot
tracking) is the inner :class:`~modem_tpu_torch.ofdm.OfdmModem` over the
active bins.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.qam import QAM
from .ofdm import OfdmModem, _default_grid
from .ops.llr import lut_llr
from .ops.slicer import lut_map, lut_slice
from .utils.bits import pack_bits, unpack_symbols
from .utils.cache import on_device

#: constellation sizes the loader may assign (bits a bin)
LEVELS = (0, 1, 2, 4, 6, 8)


def bit_loading(snr_db, gap_db: float = 6.0, levels=LEVELS,
                max_bits: int | None = None):
    """Per-bin SNR (dB) -> per-bin constellation sizes (on the host).

    The gap approximation: a bin supports ``log2(1 + SNR/gap)`` bits at the
    target symbol error rate (``gap`` about 6 dB at SER 1e-5 for uncoded
    QAM), rounded down to the largest supported level.
    """
    snr = np.asarray(snr_db, np.float64)
    gap = 10.0 ** (gap_db / 10.0)
    b_cont = np.log2(1.0 + (10.0 ** (snr / 10.0)) / gap)
    lv = sorted(levels)
    if max_bits is not None:
        lv = [b for b in lv if b <= max_bits]
    out = np.zeros(snr.shape, np.int64)
    for b in lv:
        out = np.where(b_cont >= b, b, out)
    return tuple(int(x) for x in out)


def _unit_lut(bits: int) -> np.ndarray:
    """Unit-average-energy table of a ``bits``-per-symbol constellation
    (BPSK for 1; Gray square QAM otherwise, QPSK being QAM(2))."""
    if bits == 1:
        lut = np.asarray([[1.0, 0.0], [-1.0, 0.0]], np.float32)
    else:
        lut = QAM(bits, 0.0, 1.0, gray=True).lut
    es = float(np.mean(np.sum(lut.astype(np.float64) ** 2, axis=-1)))
    return (lut / np.sqrt(es)).astype(np.float32)


class AdaptiveOfdm:
    """OFDM modem with per-bin constellations from a loading map.

    ``loading``: bits per data bin, aligned with ``data_bins`` (default: the
    standard grid of :class:`~modem_tpu_torch.ofdm.OfdmModem`); 0 turns a
    bin off. Bit layout of a payload symbol: the active bins in
    ``data_bins`` order, each with its ``loading[k]`` bits in a row.
    ``device``: where the tables live (the card unless the caller asks for
    the CPU); other keywords go to the inner modem.
    """

    def __init__(self, loading, n_fft: int = 64, cp: int = 16,
                 seed: int = 2016, data_bins=None, pilot_bins=None,
                 device: torch.device | str | None = None, **modem_kwargs):
        if data_bins is None or pilot_bins is None:
            dflt_data, dflt_pilot = _default_grid(n_fft)
            data_bins = dflt_data if data_bins is None else tuple(data_bins)
            pilot_bins = (dflt_pilot if pilot_bins is None
                          else tuple(pilot_bins))
        loading = tuple(int(b) for b in loading)
        if len(loading) != len(data_bins):
            raise ValueError(f"loading has {len(loading)} entries for "
                             f"{len(data_bins)} data bins")
        bad = sorted({b for b in loading if b not in LEVELS})
        if bad:
            raise ValueError(f"unsupported constellation sizes {bad}; "
                             f"supported: {LEVELS}")
        active = tuple(b for b, l in zip(data_bins, loading) if l)
        if not active:
            raise ValueError("loading turns every data bin off")
        self.loads = tuple(l for l in loading if l)   # per active bin
        self.loading = loading
        # the inner modem frames, estimates and equalizes the active bins;
        # its own table is never used on this path
        self.m = OfdmModem(QAM(2, 0.0, 1.0), n_fft=n_fft, cp=cp,
                           data_bins=active, pilot_bins=pilot_bins,
                           seed=seed, device=device, **modem_kwargs)
        self.device = self.m.device
        self.bits_per_sym = int(sum(self.loads))      # a payload symbol's

        # static per-constellation groups over the active-bin positions
        loads = np.asarray(self.loads, np.int64)
        offs = np.concatenate([[0], np.cumsum(loads)])
        self._groups = []
        col_order, bit_order = [], []
        for b in sorted(set(self.loads)):
            cols = np.where(loads == b)[0]
            bit_idx = np.concatenate(
                [np.arange(offs[k], offs[k] + b) for k in cols])
            self._groups.append((b, _unit_lut(b), cols, bit_idx))
            col_order.append(cols)
            bit_order.append(bit_idx)
        self._col_inv = np.argsort(np.concatenate(col_order))
        self._bit_inv = np.argsort(np.concatenate(bit_order))

    def _t(self, key, make, dtype=torch.int64) -> torch.Tensor:
        return on_device(self, key, make, dtype, self.device)

    def _group(self, g: int):
        """Group ``g`` on the device: ``(bits, lut, cols, bit_idx)``."""
        b, lut, cols, bit_idx = self._groups[g]
        return (b, self._t(("lut", g), lambda: lut, torch.float32),
                self._t(("cols", g), lambda: cols),
                self._t(("bits", g), lambda: bit_idx))

    # ---- geometry ----

    @property
    def preamble_len(self) -> int:
        return self.m.preamble_len

    def frame_len(self, n_symbols: int) -> int:
        return self.m.frame_len(n_symbols)

    def bits_per_frame(self, n_symbols: int) -> int:
        return n_symbols * self.bits_per_sym

    # ---- TX ----

    def map_bits(self, bits: torch.Tensor):
        """``[..., S*bits_per_sym]`` bits -> active-bin I/Q ``[..., S, D]``."""
        if bits.shape[-1] % self.bits_per_sym:
            raise ValueError(f"bit count {bits.shape[-1]} must divide by "
                             f"{self.bits_per_sym}")
        s = bits.shape[-1] // self.bits_per_sym
        bt = bits.reshape(bits.shape[:-1] + (s, self.bits_per_sym))
        gi, gq = [], []
        for g in range(len(self._groups)):
            b, lut, _, bit_idx = self._group(g)
            i, q = lut_map(pack_bits(bt[..., bit_idx], b), lut)
            gi.append(i)
            gq.append(q)
        inv = self._t("col_inv", lambda: self._col_inv)
        return (torch.cat(gi, dim=-1)[..., inv],
                torch.cat(gq, dim=-1)[..., inv])

    def tx_frame(self, bits: torch.Tensor):
        """Bits -> full frame (STF + LTF + mixed-constellation payload)."""
        m = self.m
        xi, xq = m._payload_td(*self.map_bits(bits))
        pi, pq = m._add_cp(xi, xq, m.cp)
        hi = m._t("_preamble_i").expand(pi.shape[:-1] + (-1,))
        hq = m._t("_preamble_q").expand(pq.shape[:-1] + (-1,))
        return torch.cat([hi, pi], dim=-1), torch.cat([hq, pq], dim=-1)

    # ---- RX ----

    def _demap(self, di, dq, m2, noise_var, soft: bool):
        outs = []
        nv = float(np.float32(noise_var))
        for g in range(len(self._groups)):
            b, lut, cols, _ = self._group(g)
            ci, cq = di[..., cols], dq[..., cols]
            if soft:
                llr = lut_llr(ci, cq, lut, b, 1.0)       # [..., S, |g|*b]
                w = torch.repeat_interleave(m2[..., cols] / nv, b, dim=-1)
                outs.append(llr * w[..., None, :])
            else:
                outs.append(unpack_symbols(lut_slice(ci, cq, lut), b))
        out = torch.cat(outs, dim=-1)[..., self._t("bit_inv",
                                                   lambda: self._bit_inv)]
        return out.reshape(out.shape[:-2] + (-1,))

    def _points(self, i: torch.Tensor, q: torch.Tensor, n_symbols: int):
        """Frame-aligned stream -> equalized active-bin points and
        ``|H|^2``."""
        m = self.m
        off = m.sym_len
        nl = m.n_ltf * m.sym_len
        h = m.estimate_channel(i[..., off:off + nl], q[..., off:off + nl])
        off += nl
        return m._equalize(i[..., off:], q[..., off:], n_symbols, h)

    def rx_frame(self, i: torch.Tensor, q: torch.Tensor,
                 n_symbols: int) -> torch.Tensor:
        """Frame-aligned stream -> hard bits ``[..., S*bits_per_sym]``."""
        return self._demap(*self._points(i, q, n_symbols), 1.0, soft=False)

    def rx_soft_frame(self, i: torch.Tensor, q: torch.Tensor,
                      n_symbols: int, noise_var: float = 1.0):
        """Frame-aligned stream -> ``|H|^2 / noise``-weighted max-log LLRs."""
        return self._demap(*self._points(i, q, n_symbols), noise_var,
                           soft=True)

    def as_link_chain(self):
        """Chain adapter: :class:`~modem_tpu_torch.link.FramedLink` over the
        loaded PHY, one "symbol" one mixed-constellation OFDM symbol of
        ``bits_per_sym`` bits."""
        return _AdaptiveChain(self)


class _LoadedSchemeShim:
    def __init__(self, bits_per_symbol: int):
        self.bits_per_symbol = bits_per_symbol


class _AdaptiveChain:
    def __init__(self, modem: AdaptiveOfdm):
        self.modem = modem
        self.scheme = _LoadedSchemeShim(modem.bits_per_sym)

    def tx(self, bits: torch.Tensor):
        return self.modem.tx_frame(bits)

    def rx_soft(self, iq, n_symbols: int,
                noise_var: float = 1.0) -> torch.Tensor:
        i, q = iq
        return self.modem.rx_soft_frame(i, q, n_symbols,
                                        noise_var=noise_var)

    def rx(self, iq, n_symbols: int) -> torch.Tensor:
        i, q = iq
        return self.modem.rx_frame(i, q, n_symbols)
