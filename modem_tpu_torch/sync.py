"""Feedforward synchronization: timing, carrier and frame acquisition
(counterpart of :mod:`modem_tpu.sync`).

Block estimators instead of feedback loops: every estimator is a reduction
over a block, parallel over channels.

* :func:`oerder_meyr_timing` — square-law symbol-timing estimate from the
  cyclostationarity of ``|x|^2`` (Oerder & Meyr 1988);
* :func:`correct_timing` — Farrow resampler by the estimate
  (:func:`modem_tpu_torch.ops.impairments.farrow_delay`);
* :func:`mth_power_cfo` / :func:`viterbi_viterbi_phase` — blind carrier
  recovery for M-PSK by modulation stripping (z = d^M);
* :func:`sfo_track` / :func:`phase_track` — per-block trackers for long
  streams (sampling-clock drift, residual-CFO phase spin): block estimates,
  unwrap, fit, one parallel correction;
* :func:`frame_sync` — CFO-robust differential preamble correlation over a
  window of lags;
* :func:`preamble_cfo_phase_gain` — data-aided joint CFO/phase/gain
  estimate from the located preamble;
* :func:`dd_phase_track` / :func:`dd_carrier_track` — decision-directed
  carrier loops at block rate (a loop over blocks, each step a few tensor
  ops over every channel);
* :class:`AcquiringReceiver` — the composed burst receiver over a
  :class:`modem_tpu_torch.chain.PulseShapedChain`: impaired waveform ->
  timing -> matched filter (kernel K4 on the card) -> frame -> carrier ->
  corrected decision points -> bits.

The JAX package selects values with one-hot sums and matmuls, its stand-in
for gathers on the TPU (the decision instants, :func:`varying_delay`'s
integer shift, the piecewise fits' block bounds). Each selects one value an
output, so the gathers here give the same values. Every function runs on
its inputs' device; the receiver on its chain's.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import TWO_PI
from .ops.impairments import _lagrange_weights, farrow_delay
from .ops.slicer import lut_slice
from .utils.bits import unpack_symbols
from .utils.cache import on_device

#: host constants (a preamble's products, a constellation table) on a
#: device, by value: copied from the host at the first call, not at every
_CONSTS: dict = {}


def _const(a, device) -> torch.Tensor:
    """A host float32 array (or a tensor, moved) on ``device``."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.float32)
    a = np.ascontiguousarray(a, np.float32)
    key = (a.shape, a.tobytes(), torch.device(device))
    t = _CONSTS.get(key)
    if t is None:
        if len(_CONSTS) >= 256:
            _CONSTS.clear()
        t = _CONSTS[key] = torch.as_tensor(a, device=device)
    return t


def _angle(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    return torch.atan2(im, re)


# ---------------------------------------------------------------------------
# Symbol timing: Oerder & Meyr square-law estimator
# ---------------------------------------------------------------------------

def oerder_meyr_timing(i: torch.Tensor, q: torch.Tensor,
                       sps: int) -> torch.Tensor:
    """Blind symbol-timing offset from ``|x|^2`` cyclostationarity.

    Returns ``t0 [...]`` in samples, in ``[0, sps)``: pulse peaks sit at
    ``n ~= t0 (mod sps)``. The squared envelope is projected onto the
    symbol-rate tone and the timing phase read off its angle; the estimate
    never looks at the signal's own phase, so CFO and carrier phase do not
    move it. Needs ``sps >= 4`` and an RRC-shaped input with beta > 0.
    """
    env = i * i + q * q
    n = torch.arange(env.shape[-1], dtype=torch.float32, device=i.device)
    wn = (TWO_PI / sps) * n
    sr = torch.sum(env * torch.cos(wn), dim=-1)
    si = torch.sum(env * -torch.sin(wn), dim=-1)
    return torch.remainder(-_angle(sr, si) * (sps / TWO_PI), sps)


def correct_timing(i: torch.Tensor, q: torch.Tensor, t0
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Remove the fractional part of a timing estimate ``t0``: a Farrow
    delay of ``1 + ((-t0) mod 1)`` samples, so pulse peaks land on integer
    sample indices (the integer offset is left to :func:`frame_sync`).
    Broadcasts a scalar or per-channel ``t0 [...]`` against ``[..., N]``."""
    mu = torch.remainder(-torch.as_tensor(t0, dtype=torch.float32,
                                          device=i.device), 1.0)
    mu = mu[..., None] if mu.ndim else mu
    return farrow_delay(i, mu), farrow_delay(q, mu)


# ---------------------------------------------------------------------------
# Time-varying delay and the trackers for long streams
# ---------------------------------------------------------------------------

def varying_delay(i: torch.Tensor, q: torch.Tensor, delay: torch.Tensor,
                  max_int: int):
    """Apply a per-sample time-varying delay: ``y(n) = x(n - delay[n])``
    with ``delay`` in ``[0, max_int + 1)`` samples.

    The fractional part drives per-sample cubic-Lagrange (Farrow) weights;
    the integer part picks, by a gather, the four samples they weigh. The
    first few outputs read the zero history (edge transient), like
    :func:`~modem_tpu_torch.ops.impairments.farrow_delay`.
    """
    shape = torch.broadcast_shapes(i.shape, delay.shape)
    delay = delay.expand(shape)
    k = torch.clamp(torch.floor(delay).to(torch.int32), 0, max_int)
    f = torch.clamp(delay - k, 0.0, 1.0)
    # the Lagrange basis of farrow_delay at fv = 1 - f: taps over
    # x[n - k - 2 .. n - k + 1]
    w = _lagrange_weights(1.0 - f)
    n = i.shape[-1]
    pl = max_int + 2

    def pad(x):
        x = x.expand(shape[:-1] + (n,))
        return torch.cat([x.new_zeros(x.shape[:-1] + (pl,)), x,
                          x.new_zeros(x.shape[:-1] + (1,))], dim=-1)

    ip, qp = pad(i), pad(q)
    # tap t reads x[n - k - 2 + t] = xp[n + pl - k - 2 + t]
    base = (torch.arange(n, device=i.device) + (pl - 2)) - k.to(torch.int64)
    taps = [base + t for t in range(4)]

    def weigh(xp):
        return (w[0] * torch.gather(xp, -1, taps[0])
                + w[1] * torch.gather(xp, -1, taps[1])
                + w[2] * torch.gather(xp, -1, taps[2])
                + w[3] * torch.gather(xp, -1, taps[3]))

    return weigh(ip), weigh(qp)


def _unwrap_blocks(est: torch.Tensor, period: float) -> torch.Tensor:
    """Per-block estimates ``[..., nb]`` unwrapped modulo ``period``."""
    d = est[..., 1:] - est[..., :-1]
    d = torch.remainder(d + period / 2.0, period) - period / 2.0
    return torch.cat([est[..., :1], est[..., :1] + torch.cumsum(d, dim=-1)],
                     dim=-1)


def _fit_blocks(un: torch.Tensor, n: int, block_len: int, fit: str):
    """The per-block values ``un [..., nb]`` (at the block centers) fitted
    over ``n`` samples: ``(curve [..., n], slope [..., 1])``. ``"linear"``
    is the least-squares line, ``"piecewise"`` interpolates between block
    centers (extrapolating at the ends)."""
    nb = un.shape[-1]
    dev = un.device
    centers = (np.arange(nb, dtype=np.float32) + 0.5) * block_len
    ns = torch.arange(n, dtype=torch.float32, device=dev)
    if fit == "linear":
        cm = float(centers.mean())
        cc = _const(centers - cm, dev)
        denom = float(np.sum((centers - cm) ** 2))
        slope = torch.sum(un * cc, dim=-1, keepdim=True) / denom
        mean = torch.mean(un, dim=-1, keepdim=True)
        return mean + slope * (ns - cm), slope
    if fit == "piecewise":
        x = (ns - float(centers[0])) / block_len    # center units
        j = torch.clamp(torch.floor(x).to(torch.int32), 0, nb - 2)
        frac = x - j.to(torch.float32)
        idx = j.to(torch.int64).expand(un.shape[:-1] + (n,))
        lo = torch.gather(un[..., :-1], -1, idx)
        hi = torch.gather(un[..., 1:], -1, idx)
        slope = (un[..., -1:] - un[..., :1]) / ((nb - 1) * block_len)
        return lo + frac * (hi - lo), slope
    raise ValueError(f"unknown fit {fit!r}")


def sfo_track(i: torch.Tensor, q: torch.Tensor, sps: int, block_len: int,
              max_delay: int | None = None, fit: str = "linear"):
    """Timing-drift tracking for long single-carrier streams.

    Under a sampling-clock offset (SFO) a one-shot timing estimate goes
    stale. The stream splits into ``block_len``-sample blocks (a multiple
    of ``sps``), O&M runs on every block, the block timings unwrap modulo
    ``sps`` and are fitted (``"linear"``: the slope is the SFO estimate;
    ``"piecewise"``: interpolated per block), and :func:`varying_delay`
    resamples the whole stream so pulse peaks sit at ``n = 0 (mod sps)``.

    Returns ``(ci, cq, report)`` with ``report = {"t0_blocks", "delay0",
    "sfo_ppm", "clipped"}``. ``max_delay`` bounds the applied integer delay
    (default ``2 * sps``); ``report["clipped"]`` is True per channel where
    the fitted drift range exceeded it and the correction froze.
    """
    if block_len % sps:
        raise ValueError("block_len must be a multiple of sps")
    n = i.shape[-1]
    nb = n // block_len
    if nb < 2:
        raise ValueError("need >= 2 blocks to track drift")
    head = nb * block_len
    bi = i[..., :head].reshape(i.shape[:-1] + (nb, block_len))
    bq = q[..., :head].reshape(q.shape[:-1] + (nb, block_len))
    t0 = oerder_meyr_timing(bi, bq, sps)          # [..., nb] in [0, sps)
    un = _unwrap_blocks(t0, float(sps))
    delay, slope = _fit_blocks(un, n, block_len, fit)
    # a pulse measured at phase fit(n) is pushed back onto the grid: the
    # delay C - fit(n), C a per-channel multiple of sps covering max(fit)
    c = sps * torch.ceil(torch.amax(delay, dim=-1, keepdim=True) / sps)
    mi = int(2 * sps) if max_delay is None else int(max_delay)
    applied = c - delay
    clipped = torch.amax(applied, dim=-1) > np.float32(mi + 0.999)
    delay = torch.clamp(applied, 0.0, mi + 0.999)
    ci, cq = varying_delay(i, q, delay, mi)
    report = {"t0_blocks": un, "delay0": delay[..., 0],
              "sfo_ppm": slope[..., 0] * 1e6, "clipped": clipped}
    return ci, cq, report


def phase_track(di: torch.Tensor, dq: torch.Tensor, m: int, block_len: int,
                fit: str = "linear"):
    """Blind carrier phase/CFO tracking for long M-PSK decision-point
    streams, the carrier twin of :func:`sfo_track`: Viterbi & Viterbi on
    every ``block_len`` block, the block phases unwrapped modulo ``2*pi/M``
    (drift per block below ``pi/M``), fitted (``"linear"``: the slope is
    the residual CFO in rad/symbol; ``"piecewise"``), and the stream
    derotated by the fitted phase.

    Returns ``(ci, cq, report)`` with ``report = {"phase_blocks",
    "cfo_rad_per_sym"}``; the M-fold ambiguity stays a constant offset.
    """
    n = di.shape[-1]
    nb = n // block_len
    if nb < 2:
        raise ValueError("need >= 2 blocks to track drift")
    head = nb * block_len
    bi = di[..., :head].reshape(di.shape[:-1] + (nb, block_len))
    bq = dq[..., :head].reshape(dq.shape[:-1] + (nb, block_len))
    zi, zq = _mth_power(bi, bq, m)
    pb = _angle(torch.sum(zi, dim=-1), torch.sum(zq, dim=-1)) / m
    un = _unwrap_blocks(pb, 2.0 * np.pi / m)
    ph, slope = _fit_blocks(un, n, block_len, fit)
    c, s = torch.cos(ph), torch.sin(ph)
    ci = di * c + dq * s          # multiply by e^{-j*ph}
    cq = dq * c - di * s
    report = {"phase_blocks": un, "cfo_rad_per_sym": slope[..., 0]}
    return ci, cq, report


# ---------------------------------------------------------------------------
# Blind carrier recovery for M-PSK (modulation stripping)
# ---------------------------------------------------------------------------

def _mth_power(di: torch.Tensor, dq: torch.Tensor, m: int):
    """z = (di + j*dq)^m in polar form on real planes."""
    r = (di * di + dq * dq) ** (m / 2.0)
    th = m * _angle(di, dq)
    return r * torch.cos(th), r * torch.sin(th)


def mth_power_cfo(di: torch.Tensor, dq: torch.Tensor, m: int) -> torch.Tensor:
    """Blind CFO estimate from symbol-rate decision points of an M-PSK
    constellation, in radians/symbol in ``(-pi/m, pi/m]``: the M-th power
    strips the data phases, the residual rotation is read from the one-lag
    autocorrelation."""
    zi, zq = _mth_power(di, dq, m)
    ar = torch.sum(zi[..., 1:] * zi[..., :-1] + zq[..., 1:] * zq[..., :-1],
                   dim=-1)
    ai = torch.sum(zq[..., 1:] * zi[..., :-1] - zi[..., 1:] * zq[..., :-1],
                   dim=-1)
    return _angle(ar, ai) / m


def viterbi_viterbi_phase(di: torch.Tensor, dq: torch.Tensor,
                          m: int) -> torch.Tensor:
    """Blind carrier-phase estimate for M-PSK (Viterbi & Viterbi), in
    radians in ``(-pi/m, pi/m]``."""
    zi, zq = _mth_power(di, dq, m)
    return _angle(torch.sum(zi, dim=-1), torch.sum(zq, dim=-1)) / m


# ---------------------------------------------------------------------------
# Frame synchronization: CFO-robust differential preamble correlation
# ---------------------------------------------------------------------------

def frame_sync(yi: torch.Tensor, yq: torch.Tensor, preamble, sps: int,
               max_lag: int) -> torch.Tensor:
    """Locate a known preamble in a matched-filtered waveform.

    ``preamble [P, 2]`` (host numpy) are the known symbols' I/Q; candidate
    symbol grids start at sample lags ``[0, max_lag)``. Differential
    products ``y[t+(k+1)sps] * conj(y[t+k*sps])`` correlated against the
    preamble's own make the metric blind to constant phase and CFO. Returns
    the argmax lag ``[...]`` (int32, the first of equal maxima): the
    absolute sample index of preamble symbol 0's decision instant in ``y``.
    """
    p = np.asarray(preamble, np.float32)
    need = max_lag + (p.shape[0] - 1) * sps + 1
    if yi.shape[-1] < need:
        raise ValueError(
            f"frame_sync needs >= {need} samples for max_lag={max_lag}, "
            f"got {yi.shape[-1]}")
    dev = yi.device
    dpi = _const(p[1:, 0] * p[:-1, 0] + p[1:, 1] * p[:-1, 1], dev)
    dpq = _const(p[1:, 1] * p[:-1, 0] - p[1:, 0] * p[:-1, 1], dev)
    idx = (torch.arange(max_lag, device=dev)[:, None]
           + torch.arange(p.shape[0], device=dev)[None, :] * sps)
    wi = yi[..., idx]  # [..., max_lag, P]
    wq = yq[..., idx]
    ui = wi[..., 1:] * wi[..., :-1] + wq[..., 1:] * wq[..., :-1]
    uq = wq[..., 1:] * wi[..., :-1] - wi[..., 1:] * wq[..., :-1]
    cr = torch.sum(ui * dpi + uq * dpq, dim=-1)
    ci = torch.sum(uq * dpi - ui * dpq, dim=-1)
    return torch.argmax(cr * cr + ci * ci, dim=-1).to(torch.int32)


# ---------------------------------------------------------------------------
# Data-aided carrier estimation from the located preamble
# ---------------------------------------------------------------------------

def preamble_cfo_phase_gain(di: torch.Tensor, dq: torch.Tensor, preamble):
    """Joint CFO/phase/gain from received preamble decision points.

    ``di, dq [..., P]`` are the symbol-rate samples at the located frame
    start; ``preamble [P, 2]`` (host numpy) the known symbols. With
    ``p_k = d_k * conj(a_k)``, the CFO is the phase slope of ``p`` and,
    after derotating it, gain and phase fall out of the matched sum.
    Returns ``(cfo_rad_per_symbol, phase_rad, gain)``, each ``[...]``.
    """
    a = np.asarray(preamble, np.float32)
    ai, aq = _const(a[:, 0], di.device), _const(a[:, 1], di.device)
    pi = di * ai + dq * aq
    pq = dq * ai - di * aq
    ar = torch.sum(pi[..., 1:] * pi[..., :-1] + pq[..., 1:] * pq[..., :-1],
                   dim=-1)
    aj = torch.sum(pq[..., 1:] * pi[..., :-1] - pi[..., 1:] * pq[..., :-1],
                   dim=-1)
    cfo = _angle(ar, aj)  # rad/symbol
    k = torch.arange(a.shape[0], dtype=torch.float32, device=di.device)
    th = cfo[..., None] * k
    c, s = torch.cos(th), torch.sin(th)
    ri = torch.sum(pi * c + pq * s, dim=-1)  # p~ = p * exp(-j*cfo*k)
    rq = torch.sum(pq * c - pi * s, dim=-1)
    e = float(np.sum(a[:, 0] ** 2 + a[:, 1] ** 2))
    phase = _angle(ri, rq)
    gain = torch.sqrt(ri * ri + rq * rq) / e
    return cfo, phase, gain


# ---------------------------------------------------------------------------
# Decision-directed carrier phase tracking (block rate)
# ---------------------------------------------------------------------------

def _blocks(di: torch.Tensor, dq: torch.Tensor, block: int):
    """Zero-pad ``[..., K]`` to whole blocks: ``(bi, bq) [..., nb, block]``."""
    k = di.shape[-1]
    nb = -(-k // block)
    pad = nb * block - k
    if pad:
        z = di.new_zeros(di.shape[:-1] + (pad,))
        di, dq = torch.cat([di, z], dim=-1), torch.cat([dq, z], dim=-1)
    return (di.reshape(di.shape[:-1] + (nb, block)),
            dq.reshape(dq.shape[:-1] + (nb, block)))


def _decision_error(ri: torch.Tensor, rq: torch.Tensor, lut: torch.Tensor):
    """The mean rotation of a block's points off their nearest points of
    ``lut``: ``angle(sum r * conj(a))`` ``[...]``."""
    a = lut[lut_slice(ri, rq, lut).to(torch.int64)]  # [..., block, 2]
    er = torch.sum(ri * a[..., 0] + rq * a[..., 1], dim=-1)
    ei = torch.sum(rq * a[..., 0] - ri * a[..., 1], dim=-1)
    return _angle(er, ei)


def dd_phase_track(di: torch.Tensor, dq: torch.Tensor, lut, block: int = 16):
    """Track residual carrier phase across a symbol stream,
    decision-directed, at block rate: per block, derotate by the carried
    phase, slice against ``lut``, measure the mean rotation of the points
    off their decisions and fold it into the carry.

    Returns ``(ci, cq, phases)`` with ``phases [..., n_blocks]`` the
    absolute correction applied per block. Tolerates residual CFO up to
    about ``pi / (2*M*block)`` rad/symbol.
    """
    k = di.shape[-1]
    bi, bq = _blocks(di, dq, block)
    lut = _const(lut, di.device)
    phi = di.new_zeros(di.shape[:-1])
    out_i, out_q, phases = [], [], []
    for b in range(bi.shape[-2]):
        xi, xq = bi[..., b, :], bq[..., b, :]
        c, s = torch.cos(phi)[..., None], torch.sin(phi)[..., None]
        ri = xi * c + xq * s          # rotate by -phi
        rq = xq * c - xi * s
        err = _decision_error(ri, rq, lut)
        phi = phi + err
        c2, s2 = torch.cos(err)[..., None], torch.sin(err)[..., None]
        out_i.append(ri * c2 + rq * s2)
        out_q.append(rq * c2 - ri * s2)
        phases.append(phi)
    shape = bi.shape[:-2] + (-1,)
    yi = torch.stack(out_i, dim=-2).reshape(shape)[..., :k]
    yq = torch.stack(out_q, dim=-2).reshape(shape)[..., :k]
    return yi, yq, torch.stack(phases, dim=-1)


def dd_carrier_track(di: torch.Tensor, dq: torch.Tensor, lut,
                     block: int = 16, phase_gain: float = 0.7,
                     freq_gain: float = 0.25):
    """Second-order decision-directed carrier loop (phase and frequency):
    the carry is ``(phi, freq)`` per channel, the within-block derotation
    includes the per-symbol slope ``freq*j``, so a constant residual CFO is
    tracked with no steady-state lag (a type-II loop at block rate).

    Returns ``(ci, cq, report)`` with ``report = {"phase", "freq"}`` the
    per-block carry trajectories (``freq`` in rad/symbol).
    """
    k = di.shape[-1]
    bi, bq = _blocks(di, dq, block)
    lut = _const(lut, di.device)
    j = torch.arange(block, dtype=torch.float32, device=di.device)
    phi = di.new_zeros(di.shape[:-1])
    f = di.new_zeros(di.shape[:-1])
    out_i, out_q, phases, freqs = [], [], [], []
    for b in range(bi.shape[-2]):
        xi, xq = bi[..., b, :], bq[..., b, :]
        th = phi[..., None] + f[..., None] * j  # predicted phase per symbol
        c, s = torch.cos(th), torch.sin(th)
        ri = xi * c + xq * s                    # rotate by -theta
        rq = xq * c - xi * s
        err = _decision_error(ri, rq, lut)      # mean residual rotation
        c2, s2 = torch.cos(err)[..., None], torch.sin(err)[..., None]
        out_i.append(ri * c2 + rq * s2)
        out_q.append(rq * c2 - ri * s2)
        phi = phi + f * block + phase_gain * err
        f = f + freq_gain * err / block
        phases.append(phi)
        freqs.append(f)
    shape = bi.shape[:-2] + (-1,)
    yi = torch.stack(out_i, dim=-2).reshape(shape)[..., :k]
    yq = torch.stack(out_q, dim=-2).reshape(shape)[..., :k]
    return yi, yq, {"phase": torch.stack(phases, dim=-1),
                    "freq": torch.stack(freqs, dim=-1)}


# ---------------------------------------------------------------------------
# Composed burst receiver
# ---------------------------------------------------------------------------

def _decision_points(yi: torch.Tensor, yq: torch.Tensor, lag: torch.Tensor,
                    sps: int, n: int, max_lag: int):
    """``y[..., lag + k*sps]`` for ``k`` in ``[0, n)`` with a per-row
    ``lag`` in ``[0, max_lag)``, zero past the end of ``y``: one gather
    (the JAX package picks the polyphase lane with a one-hot sum, then the
    symbol offset with a banded one-hot matmul; both select one value an
    output)."""
    need = max_lag + (n - 1) * sps
    if yi.shape[-1] < need:
        z = yi.new_zeros(yi.shape[:-1] + (need - yi.shape[-1],))
        yi, yq = torch.cat([yi, z], dim=-1), torch.cat([yq, z], dim=-1)
    idx = lag.to(torch.int64)[..., None] + sps * torch.arange(
        n, device=yi.device)
    idx = idx.expand(yi.shape[:-1] + (n,))
    return torch.gather(yi, -1, idx), torch.gather(yq, -1, idx)


class AcquiringReceiver:
    """Burst receiver with full feedforward acquisition over a
    :class:`modem_tpu_torch.chain.PulseShapedChain`, on the chain's device.

    The burst is ``preamble_symbols`` then the payload, RRC-shaped by the
    chain's TX. The received waveform may carry an unknown integer and
    fractional delay (the integer part within ``max_lag`` samples, the
    chain's group delay included), CFO, phase and gain. ``rx`` runs:

    1. :func:`oerder_meyr_timing` + :func:`correct_timing`;
    2. the chain's matched filter (kernel K4 on the card);
    3. :func:`frame_sync`;
    4. :func:`preamble_cfo_phase_gain` on the located preamble;
    5. derotate/rescale, the optional equalizer and tracker, slice to bits.
    """

    def __init__(self, chain, preamble_symbols, max_lag: int,
                 eq_taps: int | None = None, eq_ridge: float = 1e-3,
                 track_block: int | None = None, track_order: int = 1):
        if chain.carrier_hz is not None:
            raise NotImplementedError(
                "AcquiringReceiver operates at complex baseband; downconvert "
                "passband first (chain.downconvert)")
        self.chain = chain
        self.pre_syms = np.asarray(preamble_symbols, np.int64)
        #: the preamble's points on the host, from the chain's table read
        #: once (the frame sync's and estimators' constants)
        self.pre_iq = chain.lut.detach().cpu().numpy()[self.pre_syms]
        self.max_lag = int(max_lag)
        #: optional preamble-trained symbol-spaced LMMSE equalizer
        #: (:mod:`modem_tpu_torch.ops.equalizer`), ``eq_taps`` complex taps
        self.eq_taps = eq_taps
        self.eq_ridge = eq_ridge
        if eq_taps is not None and eq_taps > len(self.pre_syms) // 2:
            raise ValueError("eq_taps should be << preamble length")
        #: optional decision-directed block tracking of the payload:
        #: :func:`dd_phase_track` (``track_order=1``) or the second-order
        #: :func:`dd_carrier_track` (``track_order=2``)
        self.track_block = track_block
        if track_order not in (1, 2):
            raise ValueError("track_order must be 1 or 2")
        self.track_order = track_order

    def tx_burst(self, payload_bits: torch.Tensor):
        """Preamble + payload bits -> baseband I/Q via the chain's TX."""
        bps = self.chain.scheme.bits_per_symbol
        pre_bits = on_device(
            self, "pre_bits",
            lambda: unpack_symbols(torch.as_tensor(self.pre_syms), bps),
            torch.int32, payload_bits.device)
        pre_bits = pre_bits.expand(payload_bits.shape[:-1]
                                   + pre_bits.shape[-1:])
        bits = torch.cat([pre_bits, payload_bits.to(torch.int32)], dim=-1)
        return self.chain.tx(bits)

    def acquire(self, i: torch.Tensor, q: torch.Tensor, n_payload: int):
        """Impaired waveform -> (payload decision points, sync report).

        ``max_lag`` must cover the full lag of preamble symbol 0's decision
        instant: the chain's ``span*sps`` group delay plus any channel
        delay. Waveforms shorter than the last candidate decision instant
        are zero-padded (silence after the burst).
        """
        sps = self.chain.sps
        p = self.pre_iq.shape[0]
        # with an equalizer, extra trailing decision points let the last
        # payload symbols' windows see the channel's echo tail
        extra = 0 if self.eq_taps is None else self.eq_taps
        n_tot = p + n_payload + extra
        need = self.max_lag + (n_tot - 1) * sps + 1
        if i.shape[-1] < need:
            pad = i.new_zeros(i.shape[:-1] + (need - i.shape[-1],))
            i, q = torch.cat([i, pad], dim=-1), torch.cat([q, pad], dim=-1)
        t0 = oerder_meyr_timing(i, q, sps)
        ci, cq = correct_timing(i, q, t0)
        yi, yq = self.chain.matched_filter(ci, cq)
        lag = frame_sync(yi, yq, self.pre_iq, sps, self.max_lag)
        di, dq = _decision_points(yi, yq, lag, sps, n_tot, self.max_lag)
        cfo, phase, gain = preamble_cfo_phase_gain(di[..., :p], dq[..., :p],
                                                   self.pre_iq)
        # derotate/rescale the whole burst, so the corrected preamble can
        # train the optional equalizer
        k = torch.arange(n_tot, dtype=torch.float32, device=i.device)
        th = cfo[..., None] * k + phase[..., None]
        c, s = torch.cos(th), torch.sin(th)
        g = torch.clamp(gain[..., None], min=1e-12)
        ci = (di * c + dq * s) / g
        cq = (dq * c - di * s) / g
        report = {"timing": t0, "lag": lag, "cfo_rad_per_symbol": cfo,
                  "phase": phase, "gain": gain}
        if self.eq_taps is not None:
            from .ops.equalizer import apply_equalizer, train_lmmse

            wr, wi = train_lmmse(ci[..., :p], cq[..., :p],
                                 _const(self.pre_iq, i.device), self.eq_taps,
                                 self.eq_ridge)
            ci, cq = apply_equalizer(ci, cq, wr, wi)
            report["eq_taps"] = (wr, wi)
        ci = ci[..., p:p + n_payload]
        cq = cq[..., p:p + n_payload]
        if self.track_block is not None:
            if self.track_order == 2:
                ci, cq, trk = dd_carrier_track(ci, cq, self.chain.lut,
                                               self.track_block)
                report["tracked_phase"] = trk["phase"]
                report["tracked_freq"] = trk["freq"]
            else:
                ci, cq, phases = dd_phase_track(ci, cq, self.chain.lut,
                                                self.track_block)
                report["tracked_phase"] = phases
        return (ci, cq), report

    def rx(self, i: torch.Tensor, q: torch.Tensor,
           n_payload: int) -> torch.Tensor:
        """Impaired waveform -> payload bits ``[..., n_payload*bps]``."""
        (ri, rq), _ = self.acquire(i, q, n_payload)
        syms = lut_slice(ri, rq, self.chain.lut)
        return unpack_symbols(syms, self.chain.scheme.bits_per_symbol)
