"""Fused loopback of the pulse-shaped chain (counterpart of
:mod:`modem_tpu.ops.pallas_chain`): kernel K1, in
``modem_tpu_torch/csrc/chain.cu``.

:func:`fused_pulse_chain` takes ``[..., K]`` int32 symbols to the decided
``[..., K]`` int32 symbols through map, RRC pulse shaping, matched filter
and slicer, with the waveform kept on chip. A CPU tensor runs the plain
version (:func:`chain_plain`: :func:`~modem_tpu_torch.ops.txrx.tx_plain`
then :func:`~modem_tpu_torch.ops.txrx.rx_plain`), a CUDA tensor the kernel.
Scope: baseband, noiseless, LUT constellations of up to 64 points; in-kernel
AWGN, the passband NCO and the algebraic QAM form raise
``NotImplementedError``.
"""

from __future__ import annotations

import torch

from ..cuda import Kernel, check_cuda
from .txrx import check_lut_taps, not_ported, rx_plain, tx_plain

CHAIN_KERNEL = Kernel("modem_chain_lut")


def fused_pulse_chain(symbols: torch.Tensor, lut, rrc_taps, sps: int,
                      span: int, snr_db: float | None = None,
                      carrier_hz: int | None = None) -> torch.Tensor:
    """Loopback of the pulse-shaped chain: ``symbols [..., K]`` -> decided
    ``[..., K]`` int32, equal to the staged chain's tx -> rx. Negative
    symbols are the streaming sentinel: zero I/Q, like positions outside
    ``[0, K)``."""
    if snr_db is not None:
        raise not_ported("in-kernel AWGN (snr_db)")
    if carrier_hz is not None:
        raise not_ported("the passband NCO (carrier_hz)")
    lut, taps = check_lut_taps(lut, rrc_taps, sps, span, symbols.device)
    run = chain_kernel if symbols.is_cuda else chain_plain
    return run(symbols.to(torch.int32), lut, taps, sps, span)


def chain_plain(symbols, lut, taps, sps: int, span: int) -> torch.Tensor:
    """Plain version of K1: the TX then the RX plain versions."""
    wi, wq = tx_plain(symbols, lut, taps, sps, span)
    return rx_plain(wi, wq, symbols.shape[-1], lut, taps, sps, span,
                    soft=False)


def chain_kernel(symbols, lut, taps, sps: int, span: int) -> torch.Tensor:
    """Launch K1 (``modem_chain_lut``) on CUDA tensors."""
    dev = symbols.device
    k = symbols.shape[-1]
    flat = symbols.reshape(-1, k).contiguous()
    for name, t, dt in (("symbols", flat, torch.int32),
                        ("lut", lut, torch.float32),
                        ("taps", taps, torch.float32)):
        check_cuda(name, t, dt, dev)
    out = torch.empty_like(flat)
    if out.numel():
        CHAIN_KERNEL.launch(
            dev, flat.data_ptr(), flat.shape[0], k, lut.data_ptr(),
            lut.shape[0], taps.data_ptr(), taps.shape[0], sps, span,
            out.data_ptr())
    return out.reshape(symbols.shape)
