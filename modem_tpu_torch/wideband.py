"""WidebandModem: M burst modems behind one wideband front end
(counterpart of :mod:`modem_tpu.wideband`).

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

Given a mesh, ``tx`` and ``rx`` run the distributed front end
(:mod:`~modem_tpu_torch.parallel.channelizer`: time-sharded banks and the
all-to-all re-deal) and the acquisition of each rank's channels, on this
rank's blocks.
"""

from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh

from .ops.channelizer import Channelizer
from .parallel.acquire import sharded_acquire_fn
from .parallel.channelizer import wideband_rx_fn, wideband_tx_fn
from .sync import AcquiringReceiver


class WidebandModem:
    """``tx``: per-channel payload bits ``[M, n_payload*bps]`` -> one
    wideband I/Q stream at ``M x`` the channel rate. ``rx``: the inverse,
    via blind per-channel burst acquisition. The bank lives on the
    receiver's device (that of its chain's table).

    With ``mesh`` (a ``DeviceMesh`` whose ``time_axis`` size ``D`` divides
    ``M``; the listen window is rounded up to divide by ``D``) both run the
    distributed front end on this rank's blocks: ``tx`` takes the bits of
    this rank's channels ``[M/D, n_payload*bps]`` (coordinate ``d`` holds
    channels ``d*M/D ..``) and returns its block ``[M*window/D]`` of the
    wideband stream; ``rx`` the inverse. Without, the single-device banks.
    """

    def __init__(self, rxr: AcquiringReceiver, m: int, n_payload: int,
                 taps_per_phase: int = 12, beta: float = 9.0,
                 mesh: DeviceMesh | None = None, time_axis: str = "time"):
        if mesh is not None and not isinstance(mesh, DeviceMesh):
            raise TypeError(f"mesh must be a DeviceMesh, got "
                            f"{type(mesh).__name__}")
        d = (mesh.size(mesh.mesh_dim_names.index(time_axis))
             if mesh is not None else 1)
        if int(m) % d:
            raise ValueError(f"M={m} must divide by the {time_axis!r} size "
                             f"{d}")
        self.rxr = rxr
        self.m = int(m)
        self.n_payload = int(n_payload)
        self.bank = Channelizer(m, taps_per_phase, beta,
                                device=rxr.chain.lut.device)
        self.mesh = mesh
        self.time_axis = time_axis
        # Listen window (channel-rate samples): the burst itself, plus the
        # two banks' group delay (~2·J rows), plus the receiver's decision
        # lookahead margin; rounded up to divide by the mesh
        p = len(rxr.pre_syms)
        # chain TX emits (n_syms + span) * sps samples (span flush symbols)
        burst = (p + n_payload + rxr.chain.span) * rxr.chain.sps
        margin = 2 * taps_per_phase + rxr.max_lag // rxr.chain.sps + 8
        self.window = -(-(burst + margin) // d) * d
        self._burst_len = burst
        self._d = d

    # ---- TX ------------------------------------------------------------

    def tx(self, payload_bits: torch.Tensor):
        """``[M, n_payload*bps]`` bits -> wideband ``(wi, wq)``, each
        ``[M * window]`` samples at the wideband rate (with a mesh: this
        rank's blocks, see the class)."""
        if payload_bits.shape[-2] != self.m // self._d:
            raise ValueError(f"expected {self.m // self._d} channels")
        ci, cq = self.rxr.tx_burst(payload_bits)
        pad = self.window - ci.shape[-1]
        if pad < 0:
            raise ValueError("burst longer than the listen window")
        z = ci.new_zeros(ci.shape[:-1] + (pad,))
        ci = torch.cat([ci, z], dim=-1)
        cq = torch.cat([cq, z], dim=-1)
        if self.mesh is None:
            return self.bank.synthesize(ci, cq)
        return wideband_tx_fn(self.bank, self.mesh, self.time_axis)(ci, cq)

    # ---- RX ------------------------------------------------------------

    def rx(self, wi: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
        """Wideband ``[M * window]`` I/Q -> payload bits
        ``[M, n_payload*bps]`` via blind per-channel acquisition (with a
        mesh: this rank's blocks)."""
        if self.mesh is None:
            yi, yq = self.bank.analyze(wi, wq)
            return self.rxr.rx(yi, yq, self.n_payload)
        yi, yq = wideband_rx_fn(self.bank, self.mesh, self.time_axis)(wi, wq)
        # the re-deal leaves the channels dealt over the time dimension
        return sharded_acquire_fn(self.rxr, self.mesh, self.n_payload,
                                  ch_axis=self.time_axis)(yi, yq)
