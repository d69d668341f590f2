"""Channel-sharded OFDM (counterpart of :mod:`modem_tpu.parallel.ofdm`).

An OFDM link (:class:`~modem_tpu_torch.ofdm.OfdmModem`) is parallel over
independent streams (the DFT matmuls, the LS channel estimate, the pilot
CPE correction and the blind acquisition are reductions within a stream),
so each rank runs the modem on its own streams with no collective; the
blind acquisition's preamble correlation runs kernel K4 at 240 taps on the
card.
"""

from __future__ import annotations

from torch.distributed.device_mesh import DeviceMesh

from .generic import channel_sharded


def sharded_ofdm_tx_fn(modem, mesh: DeviceMesh, ch_axis: str = "ch"):
    """``f(bits_l) -> (i, q)``: this rank's streams ``[C_l,
    S*bits_per_sym]`` -> their frames ``[C_l, frame_len]``, the
    single-device :meth:`OfdmModem.tx_frame` bit for bit."""
    return channel_sharded(modem.tx_frame, mesh, ch_axis)


def sharded_ofdm_rx_fn(modem, mesh: DeviceMesh, n_symbols: int,
                       max_lag: int | None = None, ch_axis: str = "ch"):
    """``f(i_l, q_l) -> bits_l`` for this rank's streams ``[C_l, T]``: with
    ``max_lag`` the blind acquisition (:meth:`OfdmModem.acquire`), else the
    frame-aligned :meth:`OfdmModem.rx_frame`; the single-device decisions
    bit for bit."""
    def local(i, q):
        if max_lag is None:
            return modem.rx_frame(i, q, n_symbols)
        bits, _ = modem.acquire(i, q, n_symbols, max_lag)
        return bits

    return channel_sharded(local, mesh, ch_axis)
