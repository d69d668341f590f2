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

The noise stream of the fused kernels' in-kernel AWGN is here too
(:func:`hash_u32`, :func:`gauss_pair`): the counter-based stream the JAX
kernels draw in interpret mode, bit for bit, which ``csrc/common.cuh``
repeats on the card. The FSK loopback (K6) uses it now; K1's AWGN mode
will.
"""

from __future__ import annotations

import math

import torch

from ..cuda import Kernel, check_cuda
from .txrx import check_lut_taps, not_ported, rx_plain, tx_plain

CHAIN_KERNEL = Kernel("modem_chain_lut")

_U32 = 0xFFFFFFFF


def _mul_u32(x: torch.Tensor, m: int) -> torch.Tensor:
    """``x * m mod 2^32`` for int64 ``x`` in ``[0, 2^32)``: the multiplier
    is split in 16-bit halves so that no product leaves int64."""
    lo, hi = m & 0xFFFF, m >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _U32


def hash_u32(x: torch.Tensor) -> torch.Tensor:
    """lowbias32 avalanche hash on uint32 values held in int64 (torch has
    no wrapping uint32 multiply on the CPU)."""
    x = x ^ (x >> 16)
    x = _mul_u32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul_u32(x, 0x846CA68B)
    return x ^ (x >> 16)


def gauss_pair(ctr: torch.Tensor, key, salt: int = 0):
    """Standard-normal pair by Box-Muller from the counter-based stream of
    the JAX kernels' interpret mode (``modem_tpu.ops.pallas_chain``
    ``_gauss_pair``): ``ctr`` the per-draw uint32 counter and ``key`` the
    int32 tile key (int or tensor, broadcast against it), both as int64.
    Returns float32 ``(r*cos, r*sin)``."""
    k = (torch.as_tensor(key, dtype=torch.int64, device=ctr.device)
         + ((salt * 0x9E3779B9) & _U32)) & _U32
    b1 = hash_u32((_mul_u32(ctr, 2654435761) + k) & _U32)
    b2 = hash_u32((_mul_u32(ctr, 2246822519) + (k ^ 0x85EBCA6B)) & _U32)
    # 24 bits -> uniform in (0, 1), never 0; exact in float32
    u1 = ((b1 >> 8).to(torch.float32) + 0.5) * 2.0 ** -24
    u2 = ((b2 >> 8).to(torch.float32) + 0.5) * 2.0 ** -24
    r = torch.sqrt(-2.0 * torch.log(u1))
    ang = (2.0 * math.pi) * u2
    return r * torch.cos(ang), r * torch.sin(ang)


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
