"""Fused loopback of the pulse-shaped chain (counterpart of
:mod:`modem_tpu.ops.pallas_chain`): kernel K1, in
``modem_tpu_torch/csrc/chain.cu``.

:func:`fused_pulse_chain` (a table of up to 64 points) and
:func:`fused_pulse_chain_qam` (natural-binary square QAM of any even bits
per symbol, map and slice from the bit halves) take ``[..., K]`` int32
symbols to the decided ``[..., K]`` int32 symbols through map, RRC pulse
shaping, [the passband NCO's up-mix], [AWGN], [product detection], matched
filter and slicer, with the waveform kept on chip. A CPU tensor runs the
plain version (:func:`chain_plain`), a CUDA tensor the kernel.

The noise stream is here too (:func:`hash_u32`, :func:`gauss_pair`): the
counter-based stream the JAX kernels draw in interpret mode, bit for bit,
which ``csrc/common.cuh`` repeats on the card. K1 draws it per JAX tile of
128 channels by ``chunk_sym`` symbols (:func:`chain_noise`), so the chunk
selects the stream, as there; the FSK loopbacks (K6, K7) draw it too.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..cuda import Kernel, check_cuda
from .polyphase import polyphase_decim
from .txrx import (_f32, _kernel_carrier, _kernel_map, carrier_of,
                   check_lut_taps, kernel_taps, long_first, nco_theta,
                   qam_mparams, rx_plain, slice_plain, tx_plain)

CHAIN_KERNEL = Kernel("modem_chain")
#: K1's long route on its first version, by the host's rule
#: (:func:`~modem_tpu_torch.ops.txrx.pulse_long_route`) or forced
#: (``chain_kernel(..., first=True)``)
CHAIN_FIRST_KERNEL = Kernel("modem_chain_first")

DEFAULT_CHUNK_SYM = 256
#: channels per JAX tile, which the noise stream's keys and counters count
LANE = 128

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


def snr_sigma(es: float, snr_db: float, carrier) -> float:
    """Waveform-noise sigma for a decision-point Es/N0 of ``snr_db``:
    per-rail N0/2 at baseband; at passband the 2x product detector doubles
    the noise power at the rail, so the sigma is halved."""
    denom = 4.0 if carrier is not None else 2.0
    return math.sqrt(es / (10.0 ** (snr_db / 10.0)) / denom)


def fused_pulse_chain(symbols: torch.Tensor, lut, rrc_taps, sps: int,
                      span: int, snr_db: float | None = None, seed=None,
                      carrier_hz: int | None = None,
                      sample_rate: int | None = None, sym_offset: int = 0,
                      chunk_sym: int = DEFAULT_CHUNK_SYM) -> torch.Tensor:
    """Loopback of the pulse-shaped chain: ``symbols [..., K]`` -> decided
    ``[..., K]`` int32; noiseless, equal to the staged chain's tx -> rx.
    Negative symbols are the streaming sentinel: zero I/Q, like positions
    outside ``[0, K)``. ``snr_db`` (Es/N0 at the decision point, Es the
    table's mean energy) adds in-kernel AWGN from the stream keyed by
    ``seed`` (an int32; 0 if None); ``carrier_hz`` (with ``sample_rate``)
    runs the passband leg, ``sym_offset`` being the stream-global index of
    ``symbols[..., 0]``."""
    if snr_db is None:
        sigma = None
    else:
        lut_np = np.asarray(lut.detach().cpu() if torch.is_tensor(lut)
                            else lut, np.float32)
        es = float(np.mean(np.sum(lut_np * lut_np, axis=-1)))
        sigma = snr_sigma(es, snr_db, carrier_of(carrier_hz, sample_rate))
    return _run(symbols, lut, None, rrc_taps, sps, span, sigma, seed,
                carrier_hz, sample_rate, sym_offset, chunk_sym)


def fused_pulse_chain_qam(symbols: torch.Tensor, bits_per_symbol: int,
                          phase: float, amplitude: float, rrc_taps, sps: int,
                          span: int, snr_db: float | None = None, seed=None,
                          carrier_hz: int | None = None,
                          sample_rate: int | None = None,
                          sym_offset: int = 0,
                          chunk_sym: int = DEFAULT_CHUNK_SYM) -> torch.Tensor:
    """:func:`fused_pulse_chain` for natural-binary square QAM of any even
    ``bits_per_symbol`` (256-QAM and up): map and slice from the bit halves,
    O(1) in the constellation's size."""
    qam = qam_mparams(bits_per_symbol, phase, amplitude)
    sigma = None
    if snr_db is not None:
        _, ms, a, _, _ = qam
        levels = 2.0 * np.arange(int(ms) + 1) - ms
        es = float(a * a * 2.0 * np.mean(levels ** 2))
        sigma = snr_sigma(es, snr_db, carrier_of(carrier_hz, sample_rate))
    return _run(symbols, None, qam, rrc_taps, sps, span, sigma, seed,
                carrier_hz, sample_rate, sym_offset, chunk_sym)


def _run(symbols, lut, qam, rrc_taps, sps, span, sigma, seed, carrier_hz,
         sample_rate, sym_offset, chunk_sym):
    lut, taps = check_lut_taps(lut, rrc_taps, sps, span, symbols.device, qam)
    carrier = carrier_of(carrier_hz, sample_rate)
    if int(chunk_sym) < 1:
        raise ValueError("chunk_sym must be positive")
    seed = 0 if seed is None else int(seed)
    run = chain_kernel if symbols.is_cuda else chain_plain
    return run(symbols.to(torch.int32), lut, taps, sps, span, qam, carrier,
               int(sym_offset), None if sigma is None else _f32(sigma),
               seed, int(chunk_sym))


def chain_noise(n_ch: int, n_tiles: int, rows: int, sps: int, seed: int,
                device):
    """The Gaussians K1 adds, ``(g1, g2)`` ``[C, T, rows, sps]``: channel
    c, tile t, waveform row r of the tile, phase p draw from key ``seed +
    (c//128)*1000003 + t*7919`` (int32 wrap-around) with salt p and counter
    ``r*128 + c%128``, as the JAX interpret tiles do."""
    c = torch.arange(n_ch, dtype=torch.int64, device=device)[:, None, None,
                                                                None]
    t = torch.arange(n_tiles, dtype=torch.int64, device=device)[:, None, None]
    r = torch.arange(rows, dtype=torch.int64, device=device)[:, None]
    p = torch.arange(sps, dtype=torch.int64, device=device)
    key = (seed + (c // LANE) * 1000003 + t * 7919
           + ((p * 0x9E3779B9) & _U32)) & _U32
    ctr = (r * LANE + c % LANE) & _U32
    return gauss_pair(ctr, key)


def _tiles(w: torch.Tensor, n_tiles: int, cs: int, rows: int, sps: int):
    """``w [C, N]`` as the tiles' overlapping waveform rows ``[C, T, rows,
    sps]`` (tile t holds rows ``t*cs .. t*cs + rows - 1``, zero past the
    end)."""
    n_rows = (n_tiles - 1) * cs + rows
    w = torch.nn.functional.pad(w, (0, n_rows * sps - w.shape[-1]))
    w = w.reshape(w.shape[0], n_rows, sps)
    idx = (torch.arange(n_tiles, device=w.device)[:, None] * cs
           + torch.arange(rows, device=w.device)[None, :])
    return w[:, idx, :]


def chain_plain(symbols, lut, taps, sps: int, span: int, qam=None,
                carrier=None, sym_offset: int = 0, sigma=None, seed: int = 0,
                cs: int = DEFAULT_CHUNK_SYM) -> torch.Tensor:
    """Plain version of K1: the TX then the RX plain versions; with noise,
    tile by tile as the kernel draws it (each tile's span-symbol lookahead
    noised with the tile's own draw), then the matched filter of each
    tile's decisions."""
    k = symbols.shape[-1]
    flat = symbols.reshape(-1, k)
    w = tx_plain(flat, lut, taps, sps, span, qam, carrier, sym_offset)
    if sigma is None:
        rails = (w, None) if carrier is not None else w
        dec = rx_plain(*rails, k, lut, taps, sps, span, False, qam, carrier,
                       sym_offset)
        return dec.reshape(symbols.shape)
    n_ch = flat.shape[0]
    n_tiles = -(-k // cs)
    rows = cs + span  # the rows a tile's matched filter reads
    g1, g2 = chain_noise(n_ch, n_tiles, rows, sps, seed, flat.device)
    if carrier is not None:
        n_wave = ((n_tiles - 1) * cs + rows) * sps
        th = _tiles(nco_theta(n_wave, sps, carrier, sym_offset,
                              flat.device)[None], n_tiles, cs, rows, sps)
        x = _tiles(w, n_tiles, cs, rows, sps) + sigma * g1
        yi, yq = 2.0 * x * torch.cos(th), -2.0 * x * torch.sin(th)
    else:
        yi = _tiles(w[0], n_tiles, cs, rows, sps) + sigma * g1
        yq = _tiles(w[1], n_tiles, cs, rows, sps) + sigma * g2
    seg = (n_ch * n_tiles, rows * sps)
    di = polyphase_decim(yi.reshape(seg), taps, sps, span * sps, cs)
    dq = polyphase_decim(yq.reshape(seg), taps, sps, span * sps, cs)
    dec = slice_plain(di, dq, lut, qam).reshape(n_ch, n_tiles * cs)[:, :k]
    return dec.reshape(symbols.shape)


def chain_kernel(symbols, lut, taps, sps: int, span: int, qam=None,
                 carrier=None, sym_offset: int = 0, sigma=None, seed: int = 0,
                 cs: int = DEFAULT_CHUNK_SYM,
                 first: bool = False) -> torch.Tensor:
    """Launch K1 on CUDA tensors: ``modem_chain`` (the short route, or the
    long route's core), or ``modem_chain_first`` where
    :func:`~modem_tpu_torch.ops.txrx.long_first` says (``first`` forces
    the long route's first version at any shape, for comparisons)."""
    dev = symbols.device
    k = symbols.shape[-1]
    flat = symbols.reshape(-1, k).contiguous()
    check_cuda("symbols", flat, torch.int32, dev)
    check_cuda("taps", taps, torch.float32, dev)
    if lut is not None:
        check_cuda("lut", lut, torch.float32, dev)
    out = torch.empty_like(flat)
    fv = long_first(taps, sps, span, first)
    route_taps = (taps.data_ptr(),) if fv else kernel_taps(taps, sps)
    if out.numel():
        (CHAIN_FIRST_KERNEL if fv else CHAIN_KERNEL).launch(
            dev, flat.data_ptr(), flat.shape[0], k, cs, *_kernel_map(lut, qam),
            *route_taps, taps.shape[0], sps, span,
            *_kernel_carrier(carrier, sym_offset), int(sigma is not None),
            0.0 if sigma is None else sigma, seed & _U32, out.data_ptr())
    return out.reshape(symbols.shape)
