"""Fused one-way TX and RX of the pulse-shaped chain (counterpart of
:mod:`modem_tpu.ops.pallas_txrx`): kernels K2 and K3, in
``modem_tpu_torch/csrc/txrx.cu``.

* :func:`fused_tx`: ``symbols [..., K]`` int32 -> the RRC-shaped waveform
  ``[..., (K+span)*sps]``: baseband ``(i, q)``, or with ``carrier_hz`` the
  real passband waveform of the exact integer NCO; float32, bfloat16
  (``wave_dtype``) or int16 (``out_scale``);
* :func:`fused_rx`: that waveform (``N >= (K+span)*sps`` samples; float32 or
  bfloat16 read as they are, other dtypes cast to float32) -> int32
  decisions ``[..., K]``, or with ``soft=True`` the float32 decision-point
  ``(i, q)``.

The map is a table of up to 64 points (``lut``) or, with ``qam_params``
from :func:`qam_mparams`, natural-binary square QAM of any even bits per
symbol computed from the bit halves. ``sym_offset`` is the stream-global
index of symbol 0, which keeps the carrier phase of a stream's blocks
aligned (negative on a stream's first block).

Each has a plain PyTorch version (:func:`tx_plain`, :func:`rx_plain`), which
a CPU tensor runs, and a kernel wrapper (:func:`tx_kernel`,
:func:`rx_kernel`), which a CUDA tensor runs; a CUDA tensor never takes the
plain version.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..config import TWO_PI
from ..cuda import TAPS_PARAM, Kernel, check_cuda, host_taps
from .fir import as_taps
from .nco import carrier_phase
from .polyphase import polyphase_decim, polyphase_interp
from .slicer import as_lut, lut_slice

MAX_LUT_POINTS = 64
#: the most taps K1's and K3's short route takes: there the taps travel by
#: value in a kernel parameter of this many floats (``csrc/common.cuh``,
#: ``Taps``); a longer chain takes the long route
MAX_KERNEL_TAPS = TAPS_PARAM
#: the most samples a symbol K1's and K3's short route takes
MAX_KERNEL_SPS = 64

TX_KERNEL = Kernel("modem_tx")
RX_HARD_KERNEL = Kernel("modem_rx_hard")
RX_SOFT_KERNEL = Kernel("modem_rx_soft")

#: the C entries' storage kinds (``csrc/common.cuh``, ``WaveKind``)
_WAVE_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.int16: 2}


def qam_mparams(bits_per_symbol: int, phase: float, amplitude: float):
    """Algebraic square-QAM map/slice parameters ``(cshift, ms, a, cos,
    sin)`` (any even bits per symbol)."""
    if bits_per_symbol % 2:
        raise ValueError("square QAM needs even bits_per_symbol")
    cshift = bits_per_symbol // 2
    ms = float((1 << cshift) - 1)
    a = amplitude / ms / 2.0
    return (cshift, ms, float(a), math.cos(phase), math.sin(phase))


def carrier_of(carrier_hz, sample_rate) -> tuple[int, int] | None:
    """``(hz, sr)`` of a passband call, None at baseband; raises where the
    NCO's int32 arithmetic would overflow (``hz*sr >= 2^31``)."""
    if carrier_hz is None:
        return None
    if sample_rate is None:
        raise ValueError("carrier_hz needs sample_rate")
    hz, sr = int(carrier_hz), int(sample_rate)
    if hz < 0 or sr <= 0:
        raise ValueError("carrier_hz must be >= 0 and sample_rate > 0")
    if hz * sr >= 1 << 31:
        raise ValueError("carrier needs hz*sr < 2^31 for exact int32 NCO")
    return hz, sr


def check_map(lut, qam_params, device) -> torch.Tensor | None:
    """The table as a float32 tensor on ``device``, or None for QAM;
    exactly one of ``lut`` and ``qam_params`` is given."""
    if (lut is None) == (qam_params is None):
        raise ValueError("pass exactly one of lut / qam_params")
    if lut is None:
        if len(qam_params) != 5 or int(qam_params[0]) < 1:
            raise ValueError("qam_params is (cshift, ms, a, cos, sin)")
        return None
    lut = as_lut(lut, device)
    if lut.shape[0] > MAX_LUT_POINTS:
        raise ValueError(f"lut path supports up to {MAX_LUT_POINTS} points; "
                         "use qam_params")
    return lut


def check_taps(rrc_taps, sps: int, span: int, device) -> torch.Tensor:
    taps = as_taps(rrc_taps, device)
    if taps.shape[0] != span * sps + 1:
        raise ValueError("rrc taps length must equal span*sps + 1")
    return taps


def check_lut_taps(lut, rrc_taps, sps: int, span: int, device,
                   qam_params=None) -> tuple[torch.Tensor | None,
                                             torch.Tensor]:
    """Validated ``(lut or None, taps)`` float32 tensors on ``device``."""
    return (check_map(lut, qam_params, device),
            check_taps(rrc_taps, sps, span, device))


# --------------------------------------------------------------------------
# the map, the slice and the carrier, as the plain versions compute them
# --------------------------------------------------------------------------

def _f32(x: float) -> float:
    return float(np.float32(x))


def map_plain(symbols: torch.Tensor, lut, qam=None):
    """Constellation I/Q per symbol, zero for negative symbols (the
    streaming sentinel) and, with a table, for symbols past its end."""
    zero = torch.zeros((), dtype=torch.float32, device=symbols.device)
    if qam is None:
        valid = (symbols >= 0) & (symbols < lut.shape[0])
        iq = lut[torch.where(valid, symbols, 0).long()]
        return (torch.where(valid, iq[..., 0], zero),
                torch.where(valid, iq[..., 1], zero))
    cshift, ms, a, c, s = (int(qam[0]),) + tuple(_f32(v) for v in qam[1:])
    valid = symbols >= 0
    sym = torch.where(valid, symbols, 0)
    pm = 2.0 * (sym >> cshift).to(torch.float32) - ms
    pl = 2.0 * (sym & ((1 << cshift) - 1)).to(torch.float32) - ms
    zi = a * (pm * c - pl * s)
    zq = a * (pl * c + pm * s)
    return torch.where(valid, zi, zero), torch.where(valid, zq, zero)


def slice_plain(di: torch.Tensor, dq: torch.Tensor, lut, qam=None
                ) -> torch.Tensor:
    """Decisions: the nearest table point (the first of equal distances),
    or QAM's algebraic slice (un-rotate, divide by ``a``, round half to
    even, clip each half to ``[0, ms]``)."""
    if qam is None:
        return lut_slice(di, dq, lut)
    cshift, ms, a, c, s = (int(qam[0]),) + tuple(_f32(v) for v in qam[1:])
    pm = (di * c + dq * s) / a
    pl = (dq * c - di * s) / a
    hm = torch.clamp(torch.round((pm + ms) * 0.5), 0.0, ms).to(torch.int32)
    hl = torch.clamp(torch.round((pl + ms) * 0.5), 0.0, ms).to(torch.int32)
    return (hm << cshift) | hl


def nco_theta(n: int, sps: int, carrier, sym_offset: int, device
              ) -> torch.Tensor:
    """Carrier phase of samples ``0..n-1`` of a call whose symbol 0 is
    stream symbol ``sym_offset``: the exact integer NCO at the global
    sample ``sym_offset*sps + s``."""
    hz, sr = carrier
    return carrier_phase(hz, sr, n, (int(sym_offset) * sps) % sr,
                         device=device)


def _kernel_map(lut, qam) -> tuple:
    """The C entries' map arguments."""
    if lut is not None:
        return (lut.data_ptr(), lut.shape[0], 0, 0.0, 1.0, 1.0, 0.0)
    cshift, ms, a, c, s = qam
    return (None, 0, int(cshift), ms, a, c, s)


def kernel_taps(taps: torch.Tensor, sps: int) -> tuple:
    """K1's and K3's taps arguments, which pick the route: ``(host, device)``
    with ``host`` the address of the host copy of ``taps`` as the short route
    takes them (by value, in a kernel parameter:
    :func:`~modem_tpu_torch.cuda.host_taps`); or ``(None, device)`` for a
    chain of more than ``MAX_KERNEL_TAPS`` taps or ``MAX_KERNEL_SPS``
    samples a symbol, which takes the long route (the taps read from
    ``device``, the address of ``taps`` on the card)."""
    if taps.shape[0] > MAX_KERNEL_TAPS or sps > MAX_KERNEL_SPS:
        return None, taps.data_ptr()
    return host_taps(taps), taps.data_ptr()


def _kernel_carrier(carrier, sym_offset) -> tuple:
    """The C entries' carrier arguments: ``sr == 0`` is baseband."""
    if carrier is None:
        return (0, 0, 0, 0.0)
    hz, sr = carrier
    return (hz, sr, int(sym_offset), _f32(TWO_PI / sr))


# --------------------------------------------------------------------------
# TX: symbols -> waveform
# --------------------------------------------------------------------------

def fused_tx(symbols: torch.Tensor, lut, rrc_taps, sps: int, span: int,
             carrier_hz: int | None = None, sample_rate: int | None = None,
             sym_offset: int = 0, qam_params=None,
             out_scale: float | None = None,
             wave_dtype: torch.dtype = torch.float32):
    """Fused transmitter: ``symbols [..., K]`` -> RRC-shaped waveform
    ``[..., (K+span)*sps]``: baseband ``(i, q)``, the staged
    :meth:`modem_tpu_torch.chain.PulseShapedChain.tx` up to f32
    reassociation, or with ``carrier_hz`` (and ``sample_rate``) the real
    passband waveform. Stored as ``wave_dtype`` (float32 or bfloat16, one
    rounding to nearest even), or with ``out_scale`` as int16
    ``clip(rint(x*out_scale), -32768, 32767)``, the CLI's wire format."""
    lut, taps = check_lut_taps(lut, rrc_taps, sps, span, symbols.device,
                               qam_params)
    carrier = carrier_of(carrier_hz, sample_rate)
    out_dtype = torch.int16 if out_scale is not None else wave_dtype
    if out_dtype not in _WAVE_KINDS or (out_scale is None
                                        and out_dtype == torch.int16):
        raise ValueError("wave_dtype is float32 or bfloat16 (int16 through "
                         "out_scale)")
    run = tx_kernel if symbols.is_cuda else tx_plain
    return run(symbols.to(torch.int32), lut, taps, sps, span, qam_params,
               carrier, int(sym_offset), out_scale, out_dtype)


def store_plain(w: torch.Tensor, out_scale, out_dtype) -> torch.Tensor:
    """A float32 waveform in its storage form."""
    if out_scale is not None:
        v = torch.round(w * _f32(out_scale))
        return torch.clamp(v, -32768.0, 32767.0).to(torch.int16)
    return w.to(out_dtype)


def tx_plain(symbols, lut, taps, sps: int, span: int, qam=None,
             carrier=None, sym_offset: int = 0, out_scale=None,
             out_dtype=torch.float32):
    """Plain version of K2: map, append ``span`` zero flush symbols,
    polyphase interpolation from a zero start state, [up-mix], store."""
    zi, zq = map_plain(symbols, lut, qam)
    flush = torch.zeros(symbols.shape[:-1] + (span,), dtype=zi.dtype,
                        device=zi.device)
    wi, _ = polyphase_interp(torch.cat([zi, flush], dim=-1), taps, sps)
    wq, _ = polyphase_interp(torch.cat([zq, flush], dim=-1), taps, sps)
    if carrier is not None:
        th = nco_theta(wi.shape[-1], sps, carrier, sym_offset, wi.device)
        x = wi * torch.cos(th) - wq * torch.sin(th)
        return store_plain(x, out_scale, out_dtype)
    return (store_plain(wi, out_scale, out_dtype),
            store_plain(wq, out_scale, out_dtype))


def tx_kernel(symbols, lut, taps, sps: int, span: int, qam=None,
              carrier=None, sym_offset: int = 0, out_scale=None,
              out_dtype=torch.float32):
    """Launch K2 (``modem_tx``) on CUDA tensors."""
    dev = symbols.device
    k = symbols.shape[-1]
    flat = symbols.reshape(-1, k).contiguous()
    check_cuda("symbols", flat, torch.int32, dev)
    check_cuda("taps", taps, torch.float32, dev)
    if lut is not None:
        check_cuda("lut", lut, torch.float32, dev)
    n = (k + span) * sps
    n_out = 1 if carrier is not None else 2
    outs = [torch.empty((flat.shape[0], n), dtype=out_dtype, device=dev)
            for _ in range(n_out)]
    if outs[0].numel():
        TX_KERNEL.launch(
            dev, flat.data_ptr(), flat.shape[0], k, *_kernel_map(lut, qam),
            taps.data_ptr(), taps.shape[0], sps, span,
            *_kernel_carrier(carrier, sym_offset), _WAVE_KINDS[out_dtype],
            _f32(1.0 if out_scale is None else out_scale), outs[0].data_ptr(),
            outs[-1].data_ptr() if n_out == 2 else None)
    shape = symbols.shape[:-1] + (n,)
    outs = [o.reshape(shape) for o in outs]
    return outs[0] if carrier is not None else tuple(outs)


# --------------------------------------------------------------------------
# RX: waveform -> decisions (or soft decision-point I/Q)
# --------------------------------------------------------------------------

def fused_rx(wave, n_symbols: int, lut, rrc_taps, sps: int, span: int,
             carrier_hz: int | None = None, sample_rate: int | None = None,
             sym_offset: int = 0, qam_params=None, soft: bool = False):
    """Fused receiver: baseband ``(i, q)`` or, with ``carrier_hz``, the real
    passband waveform ``[..., N]``, ``N >= (n_symbols + span) * sps`` ->
    int32 decisions ``[..., n_symbols]`` equal to the staged
    :meth:`modem_tpu_torch.chain.PulseShapedChain.rx`; with ``soft=True``
    the matched-filter decision-point ``(i, q)`` float32."""
    carrier = carrier_of(carrier_hz, sample_rate)
    if torch.is_tensor(wave) != (carrier is not None):
        raise ValueError("baseband takes (i, q); passband one real waveform")
    waves = (wave,) if carrier is not None else tuple(wave)
    if any(w.shape != waves[0].shape for w in waves):
        raise ValueError("i and q rails differ in shape")
    if waves[0].shape[-1] < (n_symbols + span) * sps:
        raise ValueError("waveform shorter than (n_symbols + span) * sps")
    dev = waves[0].device
    lut, taps = check_lut_taps(lut, rrc_taps, sps, span, dev, qam_params)
    # bf16 stays bf16 (the kernel reads it as it is); anything else f32
    keep = all(w.dtype == torch.bfloat16 for w in waves)
    waves = tuple(w if keep else w.to(torch.float32) for w in waves)
    run = rx_kernel if dev.type == "cuda" else rx_plain
    return run(waves[0], waves[1] if len(waves) == 2 else None, n_symbols,
               lut, taps, sps, span, soft, qam_params, carrier,
               int(sym_offset))


def rx_plain(wi, wq, n_symbols: int, lut, taps, sps: int, span: int,
             soft: bool, qam=None, carrier=None, sym_offset: int = 0):
    """Plain version of K3: [product detection], polyphase matched filter
    at the decision instants ``span*sps + m*sps``, then slice. At passband
    ``wi`` is the real waveform and ``wq`` None."""
    wi = wi.to(torch.float32)
    if carrier is not None:
        th = nco_theta(wi.shape[-1], sps, carrier, sym_offset, wi.device)
        wi, wq = 2.0 * wi * torch.cos(th), -2.0 * wi * torch.sin(th)
    else:
        wq = wq.to(torch.float32)
    di = polyphase_decim(wi, taps, sps, span * sps, n_symbols)
    dq = polyphase_decim(wq, taps, sps, span * sps, n_symbols)
    return (di, dq) if soft else slice_plain(di, dq, lut, qam)


def rx_kernel(wi, wq, n_symbols: int, lut, taps, sps: int, span: int,
              soft: bool, qam=None, carrier=None, sym_offset: int = 0):
    """Launch K3 (``modem_rx_soft`` or ``modem_rx_hard``) on CUDA
    tensors."""
    dev = wi.device
    n = wi.shape[-1]
    rails = [w.reshape(-1, n).contiguous() for w in (wi, wq) if w is not None]
    for name, t in zip("iq", rails):
        check_cuda(name, t, t.dtype if t.dtype == torch.bfloat16
                   else torch.float32, dev)
    check_cuda("taps", taps, torch.float32, dev)
    c = rails[0].shape[0]
    shape = wi.shape[:-1] + (n_symbols,)
    bf16 = int(rails[0].dtype == torch.bfloat16)
    head = (rails[0].data_ptr(), rails[-1].data_ptr() if wq is not None
            else None, bf16, c, n, n_symbols, *kernel_taps(taps, sps),
            taps.shape[0], sps, span)
    nco = _kernel_carrier(carrier, sym_offset)
    if soft:
        di = torch.empty((c, n_symbols), dtype=torch.float32, device=dev)
        dq = torch.empty_like(di)
        if di.numel():
            RX_SOFT_KERNEL.launch(dev, *head, *nco, di.data_ptr(),
                                  dq.data_ptr())
        return di.reshape(shape), dq.reshape(shape)
    if lut is not None:
        check_cuda("lut", lut, torch.float32, dev)
    dec = torch.empty((c, n_symbols), dtype=torch.int32, device=dev)
    if dec.numel():
        RX_HARD_KERNEL.launch(dev, *head, *_kernel_map(lut, qam), *nco,
                              dec.data_ptr())
    return dec.reshape(shape)
