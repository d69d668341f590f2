"""WidebandModem: M burst modems behind one wideband front end
(counterpart of :mod:`modem_tpu.wideband`, its single-device path).

One object for the composition: an
:class:`~modem_tpu_torch.sync.AcquiringReceiver` per channel (all channels
share one chain and preamble) and a
:class:`~modem_tpu_torch.ops.channelizer.Channelizer` synthesis/analysis
pair. It owns the bookkeeping: the listen window is extended past the burst
so both banks' group delay (about ``2*J`` channel-rate samples) and the
receiver's decision lookahead stay inside the analyzed window. The blind
acquisition absorbs the banks' group delay and gain, so no delay or scale
calibration is needed. On a CUDA device the chain's pulse shaping
(``tx_burst``) and the receiver's matched filter (``rx``) run kernel K4 at
65 taps, two launches each.

The JAX package's meshed front end (``mesh=``: time-sharded banks and
channel-sharded acquisition over ``parallel/``) is not ported yet.
"""

from __future__ import annotations

import torch

from .ops.channelizer import Channelizer
from .sync import AcquiringReceiver


class WidebandModem:
    """``tx``: per-channel payload bits ``[M, n_payload*bps]`` -> one
    wideband I/Q stream at ``M x`` the channel rate. ``rx``: the inverse,
    via blind per-channel burst acquisition. The bank lives on the
    receiver's device (that of its chain's table). ``mesh`` must be None:
    the meshed path raises ``NotImplementedError``.
    """

    def __init__(self, rxr: AcquiringReceiver, m: int, n_payload: int,
                 taps_per_phase: int = 12, beta: float = 9.0,
                 mesh=None, time_axis: str = "time"):
        if mesh is not None:
            raise NotImplementedError(
                "WidebandModem(mesh=) is not ported yet (ROADMAP.md queue 1, "
                "item 6: parallel/ on torch.distributed)")
        self.rxr = rxr
        self.m = int(m)
        self.n_payload = int(n_payload)
        self.bank = Channelizer(m, taps_per_phase, beta,
                                device=rxr.chain.lut.device)
        self.mesh = mesh
        self.time_axis = time_axis
        # Listen window (channel-rate samples): the burst itself, plus the
        # two banks' group delay (~2·J rows), plus the receiver's decision
        # lookahead margin (the JAX package rounds it up to divide by the
        # mesh's time axis, of size 1 without a mesh)
        p = len(rxr.pre_syms)
        # chain TX emits (n_syms + span) * sps samples (span flush symbols)
        burst = (p + n_payload + rxr.chain.span) * rxr.chain.sps
        margin = 2 * taps_per_phase + rxr.max_lag // rxr.chain.sps + 8
        self.window = burst + margin
        self._burst_len = burst

    # ---- TX ------------------------------------------------------------

    def tx(self, payload_bits: torch.Tensor):
        """``[M, n_payload*bps]`` bits -> wideband ``(wi, wq)``, each
        ``[M * window]`` samples at the wideband rate."""
        if payload_bits.shape[-2] != self.m:
            raise ValueError(f"expected {self.m} channels")
        ci, cq = self.rxr.tx_burst(payload_bits)
        pad = self.window - ci.shape[-1]
        if pad < 0:
            raise ValueError("burst longer than the listen window")
        z = ci.new_zeros(ci.shape[:-1] + (pad,))
        ci = torch.cat([ci, z], dim=-1)
        cq = torch.cat([cq, z], dim=-1)
        return self.bank.synthesize(ci, cq)

    # ---- RX ------------------------------------------------------------

    def rx(self, wi: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
        """Wideband ``[M * window]`` I/Q -> payload bits
        ``[M, n_payload*bps]`` via blind per-channel acquisition."""
        yi, yq = self.bank.analyze(wi, wq)
        return self.rxr.rx(yi, yq, self.n_payload)
