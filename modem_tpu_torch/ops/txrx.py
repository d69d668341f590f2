"""Fused one-way TX and RX of the pulse-shaped chain (counterpart of
:mod:`modem_tpu.ops.pallas_txrx`): kernels K2 and K3, in
``modem_tpu_torch/csrc/txrx.cu``.

* :func:`fused_tx`: ``symbols [..., K]`` int32 -> baseband ``(i, q)``
  float32 ``[..., (K+span)*sps]``;
* :func:`fused_rx`: baseband ``(i, q)`` ``[..., N]``, ``N >= (K+span)*sps``
  -> int32 decisions ``[..., K]``, or with ``soft=True`` the float32
  decision-point ``(i, q)``.

Each has a plain PyTorch version (:func:`tx_plain`, :func:`rx_plain`), which
a CPU tensor runs, and a kernel wrapper (:func:`tx_kernel`,
:func:`rx_kernel`), which a CUDA tensor runs; a CUDA tensor never takes the
plain version. Scope: LUT constellations of up to 64 points, f32
waveforms. The JAX package's other modes raise ``NotImplementedError``.
"""

from __future__ import annotations

import torch

from ..cuda import Kernel, check_cuda
from .fir import as_taps
from .polyphase import polyphase_decim, polyphase_interp
from .slicer import as_lut, lut_slice

MAX_LUT_POINTS = 64

TX_KERNEL = Kernel("modem_tx_lut")
RX_HARD_KERNEL = Kernel("modem_rx_lut_hard")
RX_SOFT_KERNEL = Kernel("modem_rx_lut_soft")


def not_ported(mode: str):
    """The error for a mode of the JAX kernels that waits for a later port."""
    return NotImplementedError(
        f"{mode} is not ported yet (ROADMAP.md queue 2, 'K1-K3 modes still "
        "to port')")


def check_lut_taps(lut, rrc_taps, sps: int, span: int, device,
                   qam_params=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Validated ``(lut, taps)`` float32 tensors on ``device``."""
    if qam_params is not None:
        raise not_ported("the algebraic square-QAM mode (qam_params)")
    lut = as_lut(lut, device)
    if lut.shape[0] > MAX_LUT_POINTS:
        raise ValueError(f"lut path supports up to {MAX_LUT_POINTS} points")
    taps = as_taps(rrc_taps, device)
    if taps.shape[0] != span * sps + 1:
        raise ValueError("rrc taps length must equal span*sps + 1")
    return lut, taps


def _map_valid(symbols: torch.Tensor, lut: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Constellation I/Q per symbol, zero for symbols outside the table
    (negative values are the streaming sentinel)."""
    valid = (symbols >= 0) & (symbols < lut.shape[0])
    iq = lut[torch.where(valid, symbols, 0).long()]
    zero = torch.zeros((), dtype=lut.dtype, device=lut.device)
    return (torch.where(valid, iq[..., 0], zero),
            torch.where(valid, iq[..., 1], zero))


# --------------------------------------------------------------------------
# TX: symbols -> waveform
# --------------------------------------------------------------------------

def fused_tx(symbols: torch.Tensor, lut, rrc_taps, sps: int, span: int,
             carrier_hz: int | None = None, qam_params=None,
             out_scale: float | None = None,
             wave_dtype: torch.dtype = torch.float32):
    """Fused transmitter: ``symbols [..., K]`` -> RRC-shaped baseband
    ``(i, q)``, each ``[..., (K+span)*sps]`` float32: the staged
    :meth:`modem_tpu_torch.chain.PulseShapedChain.tx` up to f32
    reassociation."""
    if carrier_hz is not None:
        raise not_ported("the passband NCO (carrier_hz)")
    if out_scale is not None or wave_dtype != torch.float32:
        raise not_ported("the int16/bf16 waveform formats")
    lut, taps = check_lut_taps(lut, rrc_taps, sps, span, symbols.device,
                               qam_params)
    run = tx_kernel if symbols.is_cuda else tx_plain
    return run(symbols.to(torch.int32), lut, taps, sps, span)


def tx_plain(symbols, lut, taps, sps: int, span: int):
    """Plain version of K2: map, append ``span`` zero flush symbols,
    polyphase interpolation from a zero start state."""
    zi, zq = _map_valid(symbols, lut)
    flush = torch.zeros(symbols.shape[:-1] + (span,), dtype=zi.dtype,
                        device=zi.device)
    wi, _ = polyphase_interp(torch.cat([zi, flush], dim=-1), taps, sps)
    wq, _ = polyphase_interp(torch.cat([zq, flush], dim=-1), taps, sps)
    return wi, wq


def tx_kernel(symbols, lut, taps, sps: int, span: int):
    """Launch K2 (``modem_tx_lut``) on CUDA tensors."""
    dev = symbols.device
    k = symbols.shape[-1]
    flat = symbols.reshape(-1, k).contiguous()
    for name, t, dt in (("symbols", flat, torch.int32),
                        ("lut", lut, torch.float32),
                        ("taps", taps, torch.float32)):
        check_cuda(name, t, dt, dev)
    n = (k + span) * sps
    wi = torch.empty((flat.shape[0], n), dtype=torch.float32, device=dev)
    wq = torch.empty_like(wi)
    if wi.numel():
        TX_KERNEL.launch(
            dev, flat.data_ptr(), flat.shape[0], k, lut.data_ptr(),
            lut.shape[0], taps.data_ptr(), taps.shape[0], sps, span,
            wi.data_ptr(), wq.data_ptr())
    shape = symbols.shape[:-1] + (n,)
    return wi.reshape(shape), wq.reshape(shape)


# --------------------------------------------------------------------------
# RX: waveform -> decisions (or soft decision-point I/Q)
# --------------------------------------------------------------------------

def fused_rx(wave, n_symbols: int, lut, rrc_taps, sps: int, span: int,
             carrier_hz: int | None = None, qam_params=None,
             soft: bool = False):
    """Fused receiver: baseband ``(i, q)`` ``[..., N]`` with
    ``N >= (n_symbols + span) * sps`` -> int32 decisions
    ``[..., n_symbols]`` equal to the staged
    :meth:`modem_tpu_torch.chain.PulseShapedChain.rx`; with ``soft=True``
    the matched-filter decision-point ``(i, q)`` float32."""
    if carrier_hz is not None:
        raise not_ported("the passband NCO (carrier_hz)")
    wi, wq = wave
    if wi.dtype == torch.bfloat16 or wq.dtype == torch.bfloat16:
        raise not_ported("the bf16 waveform format")
    if wi.shape != wq.shape:
        raise ValueError("i and q rails differ in shape")
    if wi.shape[-1] < (n_symbols + span) * sps:
        raise ValueError("waveform shorter than (n_symbols + span) * sps")
    lut, taps = check_lut_taps(lut, rrc_taps, sps, span, wi.device,
                               qam_params)
    run = rx_kernel if wi.is_cuda else rx_plain
    return run(wi.to(torch.float32), wq.to(torch.float32), n_symbols, lut,
               taps, sps, span, soft)


def rx_plain(wi, wq, n_symbols: int, lut, taps, sps: int, span: int,
             soft: bool):
    """Plain version of K3: polyphase matched filter at the decision
    instants ``span*sps + m*sps``, then slice."""
    di = polyphase_decim(wi, taps, sps, span * sps, n_symbols)
    dq = polyphase_decim(wq, taps, sps, span * sps, n_symbols)
    return (di, dq) if soft else lut_slice(di, dq, lut)


def rx_kernel(wi, wq, n_symbols: int, lut, taps, sps: int, span: int,
              soft: bool):
    """Launch K3 (``modem_rx_lut_soft`` or ``modem_rx_lut_hard``) on CUDA
    tensors."""
    dev = wi.device
    n = wi.shape[-1]
    fi = wi.reshape(-1, n).contiguous()
    fq = wq.reshape(-1, n).contiguous()
    for name, t in (("i", fi), ("q", fq), ("lut", lut), ("taps", taps)):
        check_cuda(name, t, torch.float32, dev)
    c = fi.shape[0]
    shape = wi.shape[:-1] + (n_symbols,)
    args = (fi.data_ptr(), fq.data_ptr(), c, n, n_symbols, taps.data_ptr(),
            taps.shape[0], sps, span)
    if soft:
        di = torch.empty((c, n_symbols), dtype=torch.float32, device=dev)
        dq = torch.empty_like(di)
        if di.numel():
            RX_SOFT_KERNEL.launch(dev, *args, di.data_ptr(), dq.data_ptr())
        return di.reshape(shape), dq.reshape(shape)
    dec = torch.empty((c, n_symbols), dtype=torch.int32, device=dev)
    if dec.numel():
        RX_HARD_KERNEL.launch(dev, *args, lut.data_ptr(), lut.shape[0],
                              dec.data_ptr())
    return dec.reshape(shape)
