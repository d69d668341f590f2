"""Alamouti 2x1 space-time block coding over the OFDM PHY (counterpart of
:mod:`modem_tpu.stbc`).

Two transmit antennas send, per subcarrier and per symbol pair (s1, s2)::

    antenna A: [ s1, -conj(s2) ]      (symbols 2m, 2m+1)
    antenna B: [ s2,  conj(s1) ]

and the single-antenna receiver combines

    s1_hat = (conj(H_A) Y1 + H_B conj(Y2)) / (|H_A|^2 + |H_B|^2)
    s2_hat = (conj(H_B) Y1 - H_A conj(Y2)) / (|H_A|^2 + |H_B|^2)

so both channels must fade at the same bin for data to be lost. The frame is
``[STF][LTF from A][LTF from B][payload pairs]``: each antenna's channel is
an LS estimate on its own slot. The inner :class:`~modem_tpu_torch.ofdm
.OfdmModem` is pilotless, with one LTF a slot; the combining is elementwise
around its reduced-DFT matmuls. The frame heads are built once per modem and
kept on its device.
"""

from __future__ import annotations

import numpy as np
import torch

from .ofdm import OfdmModem, _default_grid
from .ops.llr import lut_llr
from .ops.slicer import lut_slice
from .utils.bits import unpack_symbols
from .utils.cache import on_device


def _heads(m: OfdmModem, **antennas):
    """The CP'd preamble heads of the antennas, ``{"_head_<antenna><rail>":
    [L]}``: each antenna's slots ``"stf"``, ``"ltf"`` or ``None`` (silence)
    of ``sym_len`` samples."""
    def with_cp(t):
        return np.concatenate([t[-m.cp:], t])

    parts = {"stf": (with_cp(m._stf_ti), with_cp(m._stf_tq)),
             "ltf": (with_cp(m._ltf_ti), with_cp(m._ltf_tq)),
             None: (np.zeros(m.sym_len, np.float32),) * 2}
    out = {}
    for ant, slots in antennas.items():
        for r, rail in enumerate("iq"):
            out[f"_head_{ant}{rail}"] = np.concatenate(
                [parts[s][r] for s in slots]).astype(np.float32)
    return out


def _slot_estimates(m: OfdmModem, i: torch.Tensor, q: torch.Tensor,
                    n_tx: int, n_symbols: int):
    """One receive antenna's aligned capture ``[STF][LTF slot per transmit
    antenna][payload]`` -> the LS channel estimate from each transmit
    antenna on the data bins, ``[(hi, hq) [..., D]] * n_tx``, and the
    payload's data-bin spectra ``(yi, yq) [..., S, D]``."""
    sl = m.sym_len
    d = m._t("_data_in_used", torch.int64)
    hs = []
    for a in range(1, n_tx + 1):
        hi, hq = m.estimate_channel(i[..., a * sl:(a + 1) * sl],
                                    q[..., a * sl:(a + 1) * sl])
        hs.append((hi[..., d], hq[..., d]))
    off = (1 + n_tx) * sl
    xi, xq = m._strip_cp(i[..., off:], q[..., off:], n_symbols)
    return hs, m._dft(xi, xq, "_rx_cd", "_rx_sd")


def _framed(m: OfdmModem, head_i: torch.Tensor, head_q: torch.Tensor,
            xi: torch.Tensor, xq: torch.Tensor):
    """Payload points ``[..., S, D]`` of one antenna -> its frame ``(i,
    q)``: the head, then the CP'd OFDM symbols."""
    ti, tq = m._payload_td(xi, xq)
    pi, pq = m._add_cp(ti, tq, m.cp)
    return (torch.cat([head_i.expand(pi.shape[:-1] + (-1,)), pi], dim=-1),
            torch.cat([head_q.expand(pq.shape[:-1] + (-1,)), pq], dim=-1))


class AlamoutiOfdm:
    """2x1 Alamouti STBC over an OFDM grid.

    ``scheme``: any constellation scheme. Frames carry an even number of
    payload symbols (``n_pairs`` pairs). :meth:`tx` returns two antenna
    waveforms; the receiver sees their channel-weighted sum. ``device``:
    where the tables live (the card unless the caller asks for the CPU);
    other keywords (``channel_denoise=True``) go to the inner modem.
    """

    def __init__(self, scheme, n_fft: int = 64, cp: int = 16,
                 seed: int = 2016, device: torch.device | str | None = None,
                 **modem_kwargs):
        data, pilots = _default_grid(n_fft)
        self.m = OfdmModem(scheme, n_fft=n_fft, cp=cp,
                           data_bins=data + pilots, pilot_bins=(),
                           n_ltf=1, seed=seed, device=device, **modem_kwargs)
        self.device = self.m.device
        self.bits_per_pair = 2 * self.m.bits_per_sym
        self.__dict__.update(_heads(self.m, a=("stf", "ltf", None),
                                    b=(None, None, "ltf")))

    def _t(self, name: str) -> torch.Tensor:
        return on_device(self, name, lambda: getattr(self, name),
                         torch.float32, self.device)

    @property
    def preamble_len(self) -> int:
        """STF + one LTF slot per antenna."""
        return 3 * self.m.sym_len

    def frame_len(self, n_pairs: int) -> int:
        return self.preamble_len + 2 * n_pairs * self.m.sym_len

    def bits_per_frame(self, n_pairs: int) -> int:
        return n_pairs * self.bits_per_pair

    # ---- TX ----

    def tx(self, bits: torch.Tensor):
        """``[..., n_pairs*bits_per_pair]`` bits -> two antenna waveforms
        ``((ia, qa), (ib, qb))``, each ``[..., frame_len]``."""
        m = self.m
        di, dq = m.map_bits(bits)            # [..., 2P, D]
        if di.shape[-2] % 2:
            raise ValueError("STBC needs an even number of OFDM symbols")
        i1, q1 = di[..., 0::2, :], dq[..., 0::2, :]
        i2, q2 = di[..., 1::2, :], dq[..., 1::2, :]

        def interleave(e_i, e_q, o_i, o_q):
            return (torch.stack([e_i, o_i], dim=-2).reshape(di.shape),
                    torch.stack([e_q, o_q], dim=-2).reshape(dq.shape))

        ai, aq = interleave(i1, q1, -i2, q2)      # A: [s1, -conj(s2)]
        bi, bq = interleave(i2, q2, i1, -q1)      # B: [s2,  conj(s1)]
        wa = _framed(m, self._t("_head_ai"), self._t("_head_aq"), ai, aq)
        wb = _framed(m, self._t("_head_bi"), self._t("_head_bq"), bi, bq)
        return wa, wb

    # ---- RX ----

    def decision_points(self, i: torch.Tensor, q: torch.Tensor,
                        n_pairs: int):
        """Frame-aligned waveform -> combined decision points ``(di, dq,
        g)`` with ``g = |H_A|^2 + |H_B|^2`` per data bin (the diversity
        gain, also the LLR weight)."""
        ((hai, haq), (hbi, hbq)), (yi, yq) = _slot_estimates(
            self.m, i, q, 2, 2 * n_pairs)
        p2 = yi.shape[-2]
        shp = yi.shape[:-2] + (p2 // 2, 2) + yi.shape[-1:]
        yi = yi.reshape(shp)
        yq = yq.reshape(shp)
        y1i, y1q = yi[..., 0, :], yq[..., 0, :]
        y2i, y2q = yi[..., 1, :], yq[..., 1, :]
        hai, haq = hai[..., None, :], haq[..., None, :]
        hbi, hbq = hbi[..., None, :], hbq[..., None, :]
        g = torch.clamp(hai * hai + haq * haq + hbi * hbi + hbq * hbq,
                        min=1e-24)
        # s1 = (conj(Ha) y1 + Hb conj(y2)) / g
        s1i = (hai * y1i + haq * y1q) + (hbi * y2i + hbq * y2q)
        s1q = (hai * y1q - haq * y1i) + (hbq * y2i - hbi * y2q)
        # s2 = (conj(Hb) y1 - Ha conj(y2)) / g
        s2i = (hbi * y1i + hbq * y1q) - (hai * y2i + haq * y2q)
        s2q = (hbi * y1q - hbq * y1i) - (haq * y2i - hai * y2q)
        # the pairs back to the symbol stream [..., 2P, D]
        gi = torch.stack([s1i / g, s2i / g], dim=-2)
        gq = torch.stack([s1q / g, s2q / g], dim=-2)
        out_shape = gi.shape[:-3] + (p2,) + gi.shape[-1:]
        return gi.reshape(out_shape), gq.reshape(out_shape), g[..., 0, :]

    def rx(self, i: torch.Tensor, q: torch.Tensor,
           n_pairs: int) -> torch.Tensor:
        """Frame-aligned combined waveform -> hard bits."""
        di, dq, _ = self.decision_points(i, q, n_pairs)
        syms = lut_slice(di, dq, self.m._t("lut"))
        bits = unpack_symbols(syms, self.m.bits_per_symbol)
        return bits.reshape(bits.shape[:-2] + (-1,))

    def as_link_chain(self):
        """Chain adapter so :class:`~modem_tpu_torch.link.FramedLink` runs
        over the STBC PHY (one "symbol" = one Alamouti pair =
        ``bits_per_pair`` bits). The link's waveform is the pair of antenna
        streams until the user's channel combines them; ``rx`` takes the
        combined single-antenna capture."""
        return _StbcChain(self)

    def rx_soft(self, i: torch.Tensor, q: torch.Tensor, n_pairs: int,
                noise_var: float = 1.0) -> torch.Tensor:
        """Diversity-weighted max-log LLRs: after combining, the per-bin
        noise variance is ``noise_var / g``."""
        m = self.m
        di, dq, g = self.decision_points(i, q, n_pairs)
        llr = lut_llr(di, dq, m._t("lut"), m.bits_per_symbol, 1.0)
        w = torch.repeat_interleave(g / float(np.float32(noise_var)),
                                    m.bits_per_symbol, dim=-1)
        llr = llr * w[..., None, :]
        return llr.reshape(llr.shape[:-2] + (-1,))


class _StbcScheme:
    def __init__(self, bits_per_symbol: int):
        self.bits_per_symbol = bits_per_symbol


class _StbcChain:
    """FramedLink adapter for :class:`AlamoutiOfdm` (see
    :meth:`AlamoutiOfdm.as_link_chain`)."""

    def __init__(self, stbc: AlamoutiOfdm):
        self.stbc = stbc
        self.scheme = _StbcScheme(stbc.bits_per_pair)

    def tx(self, bits: torch.Tensor):
        return self.stbc.tx(bits)

    def rx_soft(self, iq, n_pairs: int,
                noise_var: float = 1.0) -> torch.Tensor:
        i, q = iq
        return self.stbc.rx_soft(i, q, n_pairs, noise_var=noise_var)

    def rx(self, iq, n_pairs: int) -> torch.Tensor:
        i, q = iq
        return self.stbc.rx(i, q, n_pairs)
