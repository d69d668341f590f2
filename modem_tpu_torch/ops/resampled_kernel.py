"""The fused pair of config #4, the QAM chain with a rational resampler in it
(counterpart of :mod:`modem_tpu.ops.pallas_resampled`): kernels K11 and
K12, in ``modem_tpu_torch/csrc/resampled.cu``.

* :func:`fused_resampled_tx` (K11): ``symbols [..., K]`` int32 ->
  constellation map -> polyphase RRC interpolation to the modem rate ->
  rational ``up/down`` stage -> channel-rate ``(i, q)`` float32
  ``[..., n_modem*up//down]``;
* :func:`fused_resampled_rx` (K12): channel-rate ``(i, q)`` -> one
  periodically time-varying stage to the symbol rate, which is the
  ``down/up`` resampler, the matched filter and the decimation collapsed
  into one table (:func:`_composite_rx_weights`) -> int32 decisions
  ``[..., K]``, or with ``soft=True`` the decision-point ``(i, q)``.

Both rate stages are one form, :func:`ptv_stage`: ``out[m] = sum_o
table[m % P, o] * x[(m // P)*S + first + o]``, ``x`` zero outside its
length. The tables come from the JAX package's helpers
(:func:`_stage_weights`, :func:`_composite_rx_weights`, copied here), laid
out dense, so both packages weight the same samples by the same numbers.
The TPU tiling (halo rows, chunk and window searches, lane padding) is not
carried over: ``[C, N]`` in and out. Each wrapper takes a CPU tensor to its
plain version and a CUDA tensor to its kernel, never to the plain version.
Constellations of up to 64 points.

On the card both kernels run on one polyphase core (``resampled.cu``) with
their tables passed by value in a ``Taps`` kernel parameter
(:func:`host_tables`: K11 its RRC taps and then its stage table, K12 its
composite table). The C entry points choose the route: config #4's tables
at 3/2 and 2/3 take a compiled instantiation of the core, every other shape
the long route, the first version, which reads the tables from the device.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..cuda import TAPS_PARAM, Kernel, check_cuda, host_taps
from .polyphase import polyphase_interp
from .slicer import as_lut, lut_slice
from .txrx import MAX_LUT_POINTS, map_plain

RESAMPLED_TX_KERNEL = Kernel("modem_resampled_tx")
#: hard and soft modes, one C entry point
RESAMPLED_RX_KERNEL = Kernel("modem_resampled_rx")

def host_tables(*tables: torch.Tensor) -> int | None:
    """The host copy of ``tables`` (:func:`~modem_tpu_torch.cuda.host_taps`)
    that the core takes by value where they fit its ``Taps`` parameter, else
    ``None``: the C entry point then takes the long route."""
    if sum(t.numel() for t in tables) > TAPS_PARAM:
        return None
    return host_taps(*tables)


def _stage_weights(h, L: int, M: int, base_off: int):
    """Per-output-phase slice weights for a rational L/M polyphase stage.

    Output ``m = g*L + r`` is ``sum_k h[k*L + (r*M)%L] * x[(r*M)//L + g*M -
    k]``. With ``x`` viewed as ``[g', M, C]`` and the output's group origin
    shifted ``base_off`` input rows into the view, sample ``(r*M)//L - k +
    base_off = q*M + i`` contributes tap ``k`` at slice offset ``q``,
    middle-lane ``i``. Returns ``{r: {q: np[M]}}``.
    """
    h = np.asarray(h, np.float32)
    kp = -(-len(h) // L)
    out = {}
    for r in range(L):
        p_r = (r * M) % L
        b_r = (r * M) // L
        rows: dict[int, np.ndarray] = {}
        for k in range(kp):
            idx = k * L + p_r
            tap = float(h[idx]) if idx < len(h) else 0.0
            if tap == 0.0:
                continue
            a = b_r - k + base_off
            if a < 0:
                raise ValueError("stage lookback exceeds its halo")
            q, i = divmod(a, M)
            rows.setdefault(q, np.zeros(M, np.float32))[i] = tap
        out[r] = rows
    return out


def _composite_rx_weights(taps, h2, sps: int, up: int, down: int, d: int,
                          pb: int):
    """Collapse stage-2 resampling + matched filter + decimation into one
    periodically-time-varying channel-rate -> symbol-rate stage.

    Substituting ``y2[n] = sum_k h2[k*down + (n*up)%down] *
    yc[(n*up)//down - k]`` into ``z[m] = sum_j taps[j] * y2[m*sps + d - j]``
    gives ``z[m] = sum_o G_rho[o] * yc[(m//P)*S_g + o - pb]`` with period
    ``P = down / gcd(sps*up, down)`` (``rho = m % P``) and input group
    ``S_g = sps*up / gcd(sps*up, down)``, with fewer taps than running the
    two stages separately. Returns ``(P, S_g, {rho: {q: np[S_g]}})``.
    """
    g = math.gcd(sps * up, down)
    P = down // g
    S_g = sps * up // g
    h2 = np.asarray(h2, np.float32)
    kp2 = -(-len(h2) // down)
    out = {}
    for rho in range(P):
        rows: dict[int, np.ndarray] = {}
        for j in range(len(taps)):
            tj = float(taps[j])
            if tj == 0.0:
                continue
            e = d - j  # y2 offset; e >= 0 since d >= len(taps) - 1
            num = (rho * sps + e) * up
            p = num % down
            base = num // down
            for k in range(kp2):
                idx = k * down + p
                h = float(h2[idx]) if idx < len(h2) else 0.0
                if h == 0.0:
                    continue
                o = base - k + pb
                if o < 0:
                    raise ValueError("composite lookback exceeds the halo")
                q, i = divmod(o, S_g)
                row = rows.setdefault(q, np.zeros(S_g, np.float32))
                row[i] += tj * h
        out[rho] = rows
    return P, S_g, out


def _dense_table(weights: dict, width: int) -> tuple[np.ndarray, int]:
    """``{phase: {q: np[width]}}`` -> ``(table [n_phases, n_o] float32,
    lo)``: phase ``r``'s weight at window offset ``q*width + i`` is
    ``table[r, q*width + i - lo]``; ``lo`` and ``n_o`` span the nonzero
    weights of all phases."""
    offs = {r: {q * width + i: row[i] for q, row in rows.items()
                for i in np.flatnonzero(row)}
            for r, rows in weights.items()}
    every = [o for w in offs.values() for o in w]
    lo = int(min(every))
    table = np.zeros((len(weights), max(every) - lo + 1), np.float32)
    for r, w in offs.items():
        for o, v in w.items():
            table[r, o - lo] = v
    return table, lo


def _host_taps(taps) -> np.ndarray:
    """1-D float32 taps on the host (a tensor on the card is copied back)."""
    t = taps.detach().cpu().numpy() if torch.is_tensor(taps) else taps
    t = np.asarray(t, np.float32)
    if t.ndim != 1:
        raise ValueError("taps must be 1-D")
    return t


def _check_lut(lut, device) -> torch.Tensor:
    lut = as_lut(lut, device)
    if lut.shape[0] > MAX_LUT_POINTS:
        raise ValueError(f"lut path supports up to {MAX_LUT_POINTS} points")
    return lut


@functools.lru_cache(maxsize=32)
def _tx_params(rrc: bytes, h1: bytes, up: int, down: int, device):
    """K11's RRC taps and stage table on ``device`` with the table's
    ``first`` offset, made once per filter pair."""
    h = np.frombuffer(h1, np.float32)
    base = -(-len(h) // up) - 1
    table, lo = _dense_table(_stage_weights(h, up, down, base), down)
    return (torch.as_tensor(np.frombuffer(rrc, np.float32).copy(),
                            device=device),
            torch.as_tensor(table, device=device), lo - base)


@functools.lru_cache(maxsize=32)
def _rx_params(rrc: bytes, h2: bytes, sps: int, up: int, down: int,
               delay: int, device):
    """K12's composite table on ``device``, its period ``P``, its input
    group ``S_g`` and its ``first`` offset, made once per configuration."""
    h = np.frombuffer(h2, np.float32)
    base = -(-len(h) // down) - 1
    taps = tuple(float(v) for v in np.frombuffer(rrc, np.float32))
    period, width, wts = _composite_rx_weights(taps, tuple(float(v) for v in h),
                                               sps, up, down, delay, base)
    table, lo = _dense_table(wts, width)
    return torch.as_tensor(table, device=device), period, width, lo - base


def ptv_stage(x: torch.Tensor, table: torch.Tensor, period: int, width: int,
              first: int, n_out: int) -> torch.Tensor:
    """Periodically time-varying FIR, the plain form of both kernels' rate
    stages: ``out[..., m] = sum_o table[m % period, o] * x[..., (m //
    period)*width + first + o]`` for ``m < n_out``, ``x`` zero outside
    ``[0, N)``; taps summed in order of ``o``, as the kernels sum them."""
    n_o = table.shape[1]
    n_groups = -(-n_out // period)
    if n_groups == 0:
        return torch.zeros(x.shape[:-1] + (0,), dtype=x.dtype, device=x.device)
    left = max(0, -first)
    reach = (n_groups - 1) * width + first + n_o
    xp = torch.nn.functional.pad(x, (left, max(0, reach - x.shape[-1])))
    start = first + left
    win = xp[..., start:start + reach - first].unfold(-1, n_o, width)
    phases = []
    for r in range(period):
        acc = torch.zeros(x.shape[:-1] + (n_groups,), dtype=x.dtype,
                          device=x.device)
        for o in range(n_o):
            acc = acc + table[r, o] * win[..., o]
        phases.append(acc)
    y = torch.stack(phases, dim=-1).reshape(x.shape[:-1] + (n_groups * period,))
    return y[..., :n_out]


# --------------------------------------------------------------------------
# K11: symbols -> channel-rate waveform
# --------------------------------------------------------------------------

def fused_resampled_tx(symbols: torch.Tensor, lut, rrc, sps: int, span: int,
                       up: int, down: int, taps1, n_modem: int):
    """``symbols [..., K]`` -> channel-rate ``(i, q)`` ``[...,
    n_modem*up//down]`` float32. ``n_modem`` is the modem-rate length the
    staged chain pads to (:meth:`ResampledChain._padded_len`); the modem-rate
    waveform stays on chip. Matches :meth:`ResampledChain.tx` to f32
    reassociation."""
    lut = _check_lut(lut, symbols.device)
    rrc = _host_taps(rrc)
    if len(rrc) != span * sps + 1:
        raise ValueError("rrc taps length must equal span*sps + 1")
    if n_modem % down:
        raise ValueError("n_modem must divide by down")
    taps, table, first = _tx_params(rrc.tobytes(), _host_taps(taps1).tobytes(),
                                    up, down, symbols.device)
    run = resampled_tx_kernel if symbols.is_cuda else resampled_tx_plain
    return run(symbols.to(torch.int32), lut, taps, table, first, sps, up, down,
               n_modem)


def resampled_tx_plain(symbols, lut, taps, table, first: int, sps: int,
                       up: int, down: int, n_modem: int):
    """Plain version of K11: map (zero for negative symbols), polyphase
    interpolation of ``ceil(n_modem/sps)`` symbols from a zero start state
    cut to ``n_modem`` samples, then :func:`ptv_stage`."""
    n_sym = -(-n_modem // sps)
    n_out = n_modem * up // down
    out = []
    for z in map_plain(symbols, lut):
        z = torch.nn.functional.pad(z, (0, n_sym - z.shape[-1]))
        w, _ = polyphase_interp(z, taps, sps)
        out.append(ptv_stage(w[..., :n_modem], table, up, down, first, n_out))
    return out[0], out[1]


def resampled_tx_kernel(symbols, lut, taps, table, first: int, sps: int,
                        up: int, down: int, n_modem: int):
    """Launch K11 (``modem_resampled_tx``) on CUDA tensors."""
    dev = symbols.device
    k = symbols.shape[-1]
    flat = symbols.reshape(-1, k).contiguous()
    for name, t, dt in (("symbols", flat, torch.int32),
                        ("lut", lut, torch.float32),
                        ("taps", taps, torch.float32),
                        ("table", table, torch.float32)):
        check_cuda(name, t, dt, dev)
    n_out = n_modem * up // down
    wi = torch.empty((flat.shape[0], n_out), dtype=torch.float32, device=dev)
    wq = torch.empty_like(wi)
    if wi.numel():
        RESAMPLED_TX_KERNEL.launch(
            dev, flat.data_ptr(), flat.shape[0], k, lut.data_ptr(),
            lut.shape[0], host_tables(taps, table), taps.data_ptr(),
            taps.shape[0], sps, table.data_ptr(), up, down, table.shape[1],
            first, n_out, wi.data_ptr(), wq.data_ptr())
    shape = symbols.shape[:-1] + (n_out,)
    return wi.reshape(shape), wq.reshape(shape)


# --------------------------------------------------------------------------
# K12: channel-rate waveform -> decisions (or soft decision-point I/Q)
# --------------------------------------------------------------------------

def fused_resampled_rx(wave, n_symbols: int, lut, rrc, sps: int, span: int,
                       up: int, down: int, taps2, delay: int,
                       soft: bool = False):
    """Channel-rate ``(i, q)`` ``[..., N]`` -> int32 decisions ``[...,
    n_symbols]``, equal to :meth:`ResampledChain.rx` in practice; with
    ``soft=True`` the matched-filter decision-point ``(i, q)`` float32.
    ``delay`` is the chain's decision delay in modem-rate samples
    (:attr:`ResampledChain.delay`); samples before the stream are zero."""
    wi, wq = wave
    if wi.shape != wq.shape:
        raise ValueError("i and q rails differ in shape")
    lut = _check_lut(lut, wi.device)
    rrc = _host_taps(rrc)
    if delay < len(rrc) - 1:
        raise ValueError("delay must cover the matched filter span")
    need_rows = ((delay + (n_symbols - 1) * sps) * up) // down + 1
    if wi.shape[-1] < need_rows:
        raise ValueError("waveform shorter than the last decision's reach")
    table, period, width, first = _rx_params(
        rrc.tobytes(), _host_taps(taps2).tobytes(), sps, up, down, delay,
        wi.device)
    run = resampled_rx_kernel if wi.is_cuda else resampled_rx_plain
    return run(wi.to(torch.float32), wq.to(torch.float32), n_symbols, lut,
               table, period, width, first, soft)


def resampled_rx_plain(wi, wq, n_symbols: int, lut, table, period: int,
                       width: int, first: int, soft: bool):
    """Plain version of K12: :func:`ptv_stage` on each rail, then the
    min-distance slice."""
    di = ptv_stage(wi, table, period, width, first, n_symbols)
    dq = ptv_stage(wq, table, period, width, first, n_symbols)
    return (di, dq) if soft else lut_slice(di, dq, lut)


def resampled_rx_kernel(wi, wq, n_symbols: int, lut, table, period: int,
                        width: int, first: int, soft: bool):
    """Launch K12 (``modem_resampled_rx``) on CUDA tensors."""
    dev = wi.device
    n = wi.shape[-1]
    fi = wi.reshape(-1, n).contiguous()
    fq = wq.reshape(-1, n).contiguous()
    for name, t in (("i", fi), ("q", fq), ("lut", lut), ("table", table)):
        check_cuda(name, t, torch.float32, dev)
    c = fi.shape[0]
    shape = wi.shape[:-1] + (n_symbols,)
    if soft:
        di = torch.empty((c, n_symbols), dtype=torch.float32, device=dev)
        dq = torch.empty_like(di)
        out = (0, di.data_ptr(), dq.data_ptr())
    else:
        dec = torch.empty((c, n_symbols), dtype=torch.int32, device=dev)
        out = (dec.data_ptr(), 0, 0)
    if c * n_symbols:
        RESAMPLED_RX_KERNEL.launch(
            dev, fi.data_ptr(), fq.data_ptr(), c, n, n_symbols,
            host_tables(table), table.data_ptr(), period, width,
            table.shape[1], first, lut.data_ptr(), lut.shape[0], int(soft),
            *out)
    if soft:
        return di.reshape(shape), dq.reshape(shape)
    return dec.reshape(shape)
