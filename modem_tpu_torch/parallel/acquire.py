"""Channel-sharded burst acquisition (counterpart of
:mod:`modem_tpu.parallel.acquire`).

Burst acquisition (:class:`~modem_tpu_torch.sync.AcquiringReceiver`) is
parallel over channels: every estimator (Oerder & Meyr timing, frame sync,
the preamble's carrier fit, the LMMSE solve, the block trackers) is a
reduction within a channel, so each rank acquires its own channels with no
collective (its matched filter on kernel K4 on the card).
"""

from __future__ import annotations

from torch.distributed.device_mesh import DeviceMesh

from .generic import channel_sharded


def sharded_acquire_fn(rxr, mesh: DeviceMesh, n_payload: int,
                       ch_axis: str = "ch"):
    """``f(i_l, q_l) -> bits_l``: this rank's channels ``[C_l, N]`` of the
    bank over ``ch_axis`` -> their payload bits ``[C_l, n_payload*bps]``,
    the single-device :meth:`AcquiringReceiver.rx` bit for bit. The other
    mesh dimensions hold copies: one burst's acquisition is a problem of
    one block in time."""
    return channel_sharded(lambda i, q: rxr.rx(i, q, n_payload), mesh,
                           ch_axis)
