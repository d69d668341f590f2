"""Frequency-hopping spread spectrum behind the polyphase channelizer
(counterpart of :mod:`modem_tpu.fhss`).

The dual of :mod:`~modem_tpu_torch.dsss`: instead of spreading every symbol
over PN chips in time, the carrier *hops* across the channelizer's M
channels on a known schedule, so a partial-band jammer only touches the
dwells that land on its channel.

* TX: each dwell's chain waveform (any bits->bits chain of this package at
  channel rate) is written onto its hop channel of a zero channel grid by
  one indexed assignment, then the synthesis bank
  (:class:`~modem_tpu_torch.ops.channelizer.Channelizer`) makes one
  wideband stream;
* RX: the analysis bank, then one gather takes each dwell back from its hop
  channel, then the chain's RX. The JAX package writes both selections as
  einsums with the one-hot hop matrix; each output picks exactly one value,
  so the scatter and the gather give the same values;
* the banks' group delay and passband gain are calibrated once per modem
  by probing the synthesis->analysis cascade with an impulse (delay) and a
  DC tone (complex gain), on a CPU twin of the bank, so the constants are
  the same on every device and cost the card no host read.

Dwells are separated by a guard of bank-transient length so hops cannot
smear into each other. The bank lives on the chain's device (that of its
constellation table ``chain.lut``).
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.channelizer import Channelizer


class FhssModem:
    """Frequency hopper: ``chain`` (any bits->bits chain with ``tx``/
    ``rx(n_symbols)`` at channel rate), ``m`` channels, and a static
    ``hop_seq [n_dwells]`` of channel indices. Each dwell carries
    ``dwell_symbols`` symbols.
    """

    def __init__(self, chain, m: int, hop_seq, dwell_symbols: int,
                 taps_per_phase: int = 12):
        hop = np.asarray(hop_seq, np.int64)
        if hop.ndim != 1 or hop.size < 1:
            raise ValueError("hop_seq must be a 1-D channel-index list")
        if hop.min() < 0 or hop.max() >= m:
            raise ValueError(f"hop indices must lie in [0, {m})")
        self.chain = chain
        self.m = int(m)
        self.hop = hop
        self.n_dwells = hop.size
        self.dwell_symbols = int(dwell_symbols)
        device = chain.lut.device
        self.bank = Channelizer(m, taps_per_phase, device=device)
        # the hop schedule as the (channel, dwell) index pair of each dwell
        self._hop_t = torch.as_tensor(hop, device=device)
        self._dwell_t = torch.arange(hop.size, device=device)
        # chain waveform length per dwell + a guard of bank-transient
        # length so consecutive hops cannot smear into each other. Probed
        # by one run of the chain's TX on zero bits (its shape only, no
        # host read of values), so any chain-protocol object works: a DSSS
        # chain emits (symbols*L + span)*sps samples per dwell, not
        # (symbols + span)*sps
        probe = torch.zeros((1, self.bits_per_dwell), dtype=torch.int32,
                            device=device)
        out = chain.tx(probe)
        wave = out[0] if isinstance(out, (tuple, list)) else out
        self._wave_len = int(wave.shape[-1])
        self._guard = 2 * taps_per_phase
        self._dwell_len = self._wave_len + self._guard
        self._cal = None  # (delay, gi, gq), probed lazily

    @property
    def bits_per_dwell(self) -> int:
        return self.dwell_symbols * self.chain.scheme.bits_per_symbol

    def bits_per_frame(self) -> int:
        return self.n_dwells * self.bits_per_dwell

    def _calibrate(self):
        """Group delay (impulse argmax) and passband complex gain (DC
        steady state) of synthesis->analysis on one channel, on a CPU twin
        of the bank."""
        if self._cal is not None:
            return self._cal
        bank = Channelizer(self.m, self.bank.taps_per_phase, self.bank.beta,
                           device="cpu")
        n = 16 * bank.taps_per_phase
        t0 = n // 2
        zi = torch.zeros((self.m, n))
        imp = zi.clone()
        imp[0, t0] = 1.0
        yi, yq = bank.analyze(*bank.synthesize(imp, zi))
        mag = yi[0].numpy() ** 2 + yq[0].numpy() ** 2
        delay = int(np.argmax(mag)) - t0
        if delay < 0:
            raise RuntimeError("bank calibration found a negative group "
                               "delay — probe window too short?")
        dc = zi.clone()
        dc[0, :] = 1.0
        yi, yq = bank.analyze(*bank.synthesize(dc, zi))
        mid = n // 2 + delay
        self._cal = (delay, float(yi[0, mid]), float(yq[0, mid]))
        return self._cal

    def _scatter(self, w: torch.Tensor) -> torch.Tensor:
        """Dwell waveforms ``[..., D, wave_len]`` -> the zero-guarded
        channel grid ``[..., M, D, dwell_len]``: channel m carries dwell
        d's stream iff hop[d] == m (the JAX package's one-hot einsum
        ``...dt,dm->...mdt``)."""
        g = w.new_zeros(w.shape[:-2] + (self.m, self.n_dwells,
                                        self._dwell_len))
        g[..., self._hop_t, self._dwell_t, :w.shape[-1]] = w
        return g

    def _gather(self, y: torch.Tensor) -> torch.Tensor:
        """Channel grid ``[..., M, D, L]`` -> each dwell from its hop
        channel, ``[..., D, L]`` (the einsum ``...mdt,dm->...dt``)."""
        return y[..., self._hop_t, self._dwell_t, :]

    # ------------------------------------------------------------------

    def tx(self, bits: torch.Tensor):
        """``[..., n_dwells*bits_per_dwell]`` -> one wideband I/Q stream
        at ``M x`` the channel rate."""
        if bits.shape[-1] != self.bits_per_frame():
            raise ValueError(
                f"expected {self.bits_per_frame()} bits "
                f"({self.n_dwells} dwells x {self.bits_per_dwell})")
        d = self.n_dwells
        b = bits.reshape(bits.shape[:-1] + (d, self.bits_per_dwell))
        wi, wq = self.chain.tx(b)          # [..., D, wave_len]
        gi, gq = self._scatter(wi), self._scatter(wq)
        lead = gi.shape[:-3]
        gi = gi.reshape(lead + (self.m, d * self._dwell_len))
        gq = gq.reshape(lead + (self.m, d * self._dwell_len))
        return self.bank.synthesize(gi, gq)

    def rx(self, wi: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
        """Wideband stream -> bits, following the hop schedule."""
        delay, gi_, gq_ = self._calibrate()
        yi, yq = self.bank.analyze(wi, wq)  # [..., M, K]
        pad = yi.new_zeros(yi.shape[:-1] + (max(0, delay),))
        yi = torch.cat([yi[..., delay:], pad], dim=-1)
        yq = torch.cat([yq[..., delay:], pad], dim=-1)
        d = self.n_dwells
        need = d * self._dwell_len
        shp = yi.shape[:-1] + (d, self._dwell_len)
        yi = yi[..., :need].reshape(shp)
        yq = yq[..., :need].reshape(shp)
        si, sq = self._gather(yi), self._gather(yq)   # [..., D, dwell_len]
        # undo the banks' passband complex gain
        g2 = max(gi_ * gi_ + gq_ * gq_, 1e-24)
        ri = (si * gi_ + sq * gq_) / g2
        rq = (sq * gi_ - si * gq_) / g2
        out = self.chain.rx((ri[..., :self._wave_len],
                             rq[..., :self._wave_len]),
                            self.dwell_symbols)   # [..., D, bpd]
        return out.reshape(out.shape[:-2] + (-1,))
