"""The fused FSK/MSK kernels (counterpart of :mod:`modem_tpu.ops.pallas_fsk`):
kernels K6, K7, K8, K9 and K10, in ``modem_tpu_torch/csrc/fsk.cu``.

* :func:`fused_fsk_tx` (K8): integer phase program ``fnum``/``pnum``
  ``[..., K]`` -> baseband ``(i, q)`` ``[..., K*sps]`` for BFSK/MFSK/CPFSK;
* :func:`fused_msk_tx` (K10): MSK slot signs ``[..., 2K]`` -> the
  half-sine baseband ``[..., 2K*spb]``;
* :func:`fused_discriminator_means` (K9): baseband ``[..., N]`` -> the mean
  instantaneous frequency of each group of samples (a symbol, or an MSK
  slot), guard samples skipped;
* :func:`fsk_decide_from_program` / :func:`fused_fsk_chain` (K6): the
  loopback, program -> synthesis -> optional AWGN -> discriminator -> mean
  -> nearest frequency, the waveform kept on chip;
* :func:`fused_msk_slots` (K7): the MSK loopback, slot signs -> half-sine
  synthesis -> optional AWGN -> discriminator -> sign bit per slot.

Each takes a CPU tensor to its plain version (``*_plain``) and a CUDA tensor
to its kernel (``*_kernel``), never to the plain version. The fused
discriminator uses the JAX kernels' degree-9 polynomial :func:`atan2_poly`
(error ~1e-5 rad) in both versions, so its means carry the same error as
the JAX function's; the staged receivers use the exact ``torch.atan2``.

K6's and K7's noise is the JAX kernels' interpret-mode stream
(:func:`~modem_tpu_torch.ops.chain_kernel.gauss_pair`) with the same tile
keys and counters: the JAX tile is 128 channels by ``chunk_sym`` symbols
(``chunk_slots`` MSK slots) plus a one-row halo, so the chunk (default 256,
as there) selects the stream.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..config import TWO_PI
from ..cuda import Kernel, check_cuda
from ..models.base import PhaseProgram, f32
from ..models.fsk import BFSK, CPFSK, MFSK
from ..tx import REF_TIME_OFFSET
from .chain_kernel import gauss_pair

DEFAULT_CHUNK_SYM = 256
#: channels per JAX tile, which the noise stream's keys and counters count
LANE = 128
#: candidate frequencies the K6 kernel takes (shared memory)
MAX_CANDIDATES = 256

FSK_CHAIN_KERNEL = Kernel("modem_fsk_chain")
FSK_TX_KERNEL = Kernel("modem_fsk_tx")
DISC_MEANS_KERNEL = Kernel("modem_disc_means")
MSK_TX_KERNEL = Kernel("modem_msk_tx")
MSK_CHAIN_KERNEL = Kernel("modem_msk_chain")

_PI = f32(math.pi)


def atan2_poly(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Four-quadrant arctangent from the JAX kernels' degree-9 minimax
    polynomial (``pallas_fsk._atan2``), in float32; max error ~1e-5 rad."""
    ax, ay = torch.abs(x), torch.abs(y)
    hi = torch.maximum(ax, ay)
    lo = torch.minimum(ax, ay)
    t = lo / torch.clamp(hi, min=1e-30)
    s = t * t
    r = t * (0.99997726
             + s * (-0.33262347
                    + s * (0.19354346
                           + s * (-0.11643287
                                  + s * (0.05265332 + s * -0.01172120)))))
    r = torch.where(ay > ax, _PI * 0.5 - r, r)
    r = torch.where(x < 0, _PI - r, r)
    return torch.where(y < 0, -r, r)


def fsk_noise_sigma(amp: float, snr_db: float) -> float:
    """Per-rail noise sigma for a per-complex-sample SNR of ``snr_db``
    (``A^2 / (2*sigma^2)`` per rail)."""
    return amp / math.sqrt(2.0) * 10.0 ** (-snr_db / 20.0)


def fsk_coef_table(scheme) -> tuple:
    """Per-candidate-symbol ``fnum`` table of a BFSK/MFSK/CPFSK scheme;
    raises ``ValueError`` where the discriminator's Nyquist bound fails
    (``2*|fnum| >= den``: the phase increment would alias)."""
    s = np.arange(1 << scheme.bits_per_symbol)
    if isinstance(scheme, BFSK):
        table = s * scheme.dev
    elif isinstance(scheme, MFSK):
        coef = 2 * s if scheme.symbol_map == "increase" else 2 * s - scheme.max_sym
        table = coef * scheme.dev
    elif isinstance(scheme, CPFSK):
        table = 2 * s * scheme.dev_hz
    else:
        raise TypeError(f"fused FSK does not support {type(scheme).__name__}")
    coefs = tuple(int(v) for v in table)
    if max(abs(v) for v in coefs) * 2 >= scheme.den:
        raise ValueError(
            "discriminator Nyquist violated: |fnum| must stay below den/2 "
            f"(max {max(abs(v) for v in coefs)} vs den {scheme.den}) — the "
            "phase increment would alias (see ops/slicer.py fsk_slice)")
    return coefs


def _check_guard(guard: int, group: int, what: str) -> None:
    if guard < 1:
        raise ValueError(f"{what} needs guard >= 1")
    if guard >= group:
        raise ValueError("guard leaves no interior samples per group")


def _flat_int32(*ts: torch.Tensor) -> list[torch.Tensor]:
    """Each ``[..., K]`` tensor as a contiguous int32 ``[C, K]``."""
    return [t.to(torch.int32).reshape(-1, t.shape[-1]).contiguous() for t in ts]


# --------------------------------------------------------------------------
# K8: the FSK waveform
# --------------------------------------------------------------------------

def fused_fsk_tx(fnum: torch.Tensor, pnum: torch.Tensor, den: int, sps: int,
                 amp: float, qshift: float):
    """Integer phase program ``[..., K]`` -> baseband ``(i, q)``
    ``[..., K*sps]`` float32, ``i = amp*cos(theta)``,
    ``q = amp*cos(theta + qshift)``: the staged
    :meth:`modem_tpu_torch.tx.Modulator.baseband` of a BFSK, MFSK or CPFSK
    block to f32 trig rounding."""
    if fnum.shape != pnum.shape:
        raise ValueError("fnum and pnum differ in shape")
    run = fsk_tx_kernel if fnum.is_cuda else fsk_tx_plain
    return run(fnum, pnum, int(den), int(sps), f32(amp), f32(qshift))


def _program_theta(fnum, pnum, den: int, slot_len: int) -> torch.Tensor:
    """theta of every sample of a ``[..., K]`` program, ``[..., K*slot_len]``:
    exact floor-mod integer phase, one f32 rounding of ``u * 2pi/den``."""
    n = fnum.shape[-1] * slot_len
    t = (torch.arange(n, dtype=torch.int64, device=fnum.device)
         + REF_TIME_OFFSET) % den
    f = torch.repeat_interleave(fnum.to(torch.int64), slot_len, dim=-1)
    p = torch.repeat_interleave(pnum.to(torch.int64), slot_len, dim=-1)
    u = (f * t + p) % den
    return u.to(torch.float32) * f32(TWO_PI / den)


def fsk_tx_plain(fnum, pnum, den: int, sps: int, amp: float, qshift: float):
    """Plain version of K8."""
    theta = _program_theta(fnum, pnum, den, sps)
    return amp * torch.cos(theta), amp * torch.cos(theta + qshift)


def fsk_tx_kernel(fnum, pnum, den: int, sps: int, amp: float, qshift: float):
    """Launch K8 (``modem_fsk_tx``) on CUDA tensors."""
    dev = fnum.device
    ff, fp = _flat_int32(fnum, pnum)
    for name, t in (("fnum", ff), ("pnum", fp)):
        check_cuda(name, t, torch.int32, dev)
    c, k = ff.shape
    wi = torch.empty((c, k * sps), dtype=torch.float32, device=dev)
    wq = torch.empty_like(wi)
    if wi.numel():
        FSK_TX_KERNEL.launch(dev, ff.data_ptr(), fp.data_ptr(), c, k, sps, den,
                             amp, qshift, f32(TWO_PI / den), wi.data_ptr(),
                             wq.data_ptr())
    shape = fnum.shape[:-1] + (k * sps,)
    return wi.reshape(shape), wq.reshape(shape)


# --------------------------------------------------------------------------
# K10: the MSK waveform
# --------------------------------------------------------------------------

def fused_msk_tx(s0: torch.Tensor, s1: torch.Tensor, spb: int, amp: float):
    """Staggered slot signs ``[..., 2K]`` (+-1) -> baseband ``(i, q)``
    ``[..., 2K*spb]``, ``i = amp*s0*cos(theta)``, ``q = -amp*s1*sin(theta)``,
    ``theta = 2pi*((t+1) mod 4spb)/(4spb)`` (`msk.rs:12-35`)."""
    if s0.shape != s1.shape:
        raise ValueError("s0 and s1 differ in shape")
    run = msk_tx_kernel if s0.is_cuda else msk_tx_plain
    return run(s0, s1, int(spb), f32(amp))


def msk_tx_plain(s0, s1, spb: int, amp: float):
    """Plain version of K10."""
    ones = torch.ones_like(s0, dtype=torch.int64)
    theta = _program_theta(ones, torch.zeros_like(ones), 4 * spb, spb)
    gi = torch.repeat_interleave(amp * s0.to(torch.float32), spb, dim=-1)
    gq = torch.repeat_interleave(-amp * s1.to(torch.float32), spb, dim=-1)
    return gi * torch.cos(theta), gq * torch.sin(theta)


def msk_tx_kernel(s0, s1, spb: int, amp: float):
    """Launch K10 (``modem_msk_tx``) on CUDA tensors."""
    dev = s0.device
    f0, f1 = _flat_int32(s0, s1)
    for name, t in (("s0", f0), ("s1", f1)):
        check_cuda(name, t, torch.int32, dev)
    c, k = f0.shape
    wi = torch.empty((c, k * spb), dtype=torch.float32, device=dev)
    wq = torch.empty_like(wi)
    if wi.numel():
        MSK_TX_KERNEL.launch(dev, f0.data_ptr(), f1.data_ptr(), c, k, spb, amp,
                             f32(TWO_PI / (4 * spb)), wi.data_ptr(),
                             wq.data_ptr())
    shape = s0.shape[:-1] + (k * spb,)
    return wi.reshape(shape), wq.reshape(shape)


# --------------------------------------------------------------------------
# K9: discriminator means
# --------------------------------------------------------------------------

def fused_discriminator_means(i: torch.Tensor, q: torch.Tensor, group: int,
                              guard: int = 1) -> torch.Tensor:
    """Baseband ``(i, q) [..., N]`` -> per-group mean instantaneous
    frequency ``[..., N//group]`` (rad/sample): the sum of the polynomial
    discriminator's increments into samples ``guard..group-1`` of each
    group, times ``f32(1/(group-guard))``. ``group`` is ``sps`` for the FSK
    family, the half-symbol slot for MSK."""
    _check_guard(guard, group, "the discriminator")
    if i.shape != q.shape:
        raise ValueError("i and q rails differ in shape")
    if i.shape[-1] % group:
        raise ValueError("waveform length must be a whole number of groups")
    run = disc_means_kernel if i.is_cuda else disc_means_plain
    return run(i.to(torch.float32), q.to(torch.float32), int(group),
               int(guard))


def _increment_sums(i, q, group: int, guard: int) -> torch.Tensor:
    """Per group of ``group`` samples, the polynomial discriminator's
    increments into samples ``guard..group-1`` summed in order of the
    sample, as the kernels sum them."""
    k = i.shape[-1] // group
    wi = i.reshape(i.shape[:-1] + (k, group))
    wq = q.reshape(q.shape[:-1] + (k, group))
    ci, cq = wi[..., guard:], wq[..., guard:]
    ip, qp = wi[..., guard - 1:-1], wq[..., guard - 1:-1]
    d = atan2_poly(cq * ip - ci * qp, ci * ip + cq * qp)
    acc = torch.zeros(d.shape[:-1], dtype=torch.float32, device=d.device)
    for j in range(d.shape[-1]):
        acc = acc + d[..., j]
    return acc


def disc_means_plain(i, q, group: int, guard: int) -> torch.Tensor:
    """Plain version of K9."""
    return _increment_sums(i, q, group, guard) * f32(1.0 / (group - guard))


def disc_means_kernel(i, q, group: int, guard: int) -> torch.Tensor:
    """Launch K9 (``modem_disc_means``) on CUDA tensors."""
    dev = i.device
    fi, fq = i.contiguous(), q.contiguous()
    for name, t in (("i", fi), ("q", fq)):
        check_cuda(name, t, torch.float32, dev)
    out = torch.empty(i.shape[:-1] + (i.shape[-1] // group,),
                      dtype=torch.float32, device=dev)
    if out.numel():
        DISC_MEANS_KERNEL.launch(dev, fi.data_ptr(), fq.data_ptr(),
                                 out.numel(), group, guard,
                                 f32(1.0 / (group - guard)), out.data_ptr())
    return out


# --------------------------------------------------------------------------
# K6: the loopback
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=64)
def _candidate_increments(coefs: tuple, den: int,
                          device: torch.device) -> torch.Tensor:
    """``f32(2pi*fnum_m/den)`` per candidate on ``device``, made once per
    table (not copied to the card on every call)."""
    return torch.tensor([f32(TWO_PI * fn / den) for fn in coefs],
                        dtype=torch.float32, device=device)


def fsk_decide_from_program(fnum: torch.Tensor, pnum: torch.Tensor,
                            coefs: tuple, den: int, sps: int, amp: float,
                            qshift: float, guard: int = 1,
                            chunk_sym: int = DEFAULT_CHUNK_SYM,
                            sigma: float | None = None,
                            seed=None) -> torch.Tensor:
    """Integer phase program ``[..., K]`` -> decided symbols ``[..., K]``
    int32: the index of the candidate whose increment
    ``f32(2pi*fnum_m/den)`` is nearest the symbol's mean discriminator
    output, the first of equal distances. ``sigma`` adds that much Gaussian
    noise per rail from the stream keyed by ``seed`` (an int32; 0 if None)
    in tiles of ``chunk_sym`` symbols."""
    _check_guard(guard, sps, "fused FSK")
    if fnum.shape != pnum.shape:
        raise ValueError("fnum and pnum differ in shape")
    if not 1 <= len(coefs) <= MAX_CANDIDATES:
        raise ValueError(f"fused FSK takes 1 to {MAX_CANDIDATES} candidates")
    if chunk_sym < 1:
        raise ValueError("chunk_sym must be positive")
    targets = _candidate_increments(tuple(coefs), int(den), fnum.device)
    seed = 0 if seed is None else int(seed)
    sig = None if sigma is None else f32(sigma)
    run = fsk_chain_kernel if fnum.is_cuda else fsk_chain_plain
    return run(fnum, pnum, targets, int(den), int(sps), f32(amp), f32(qshift),
               int(guard), int(chunk_sym), sig, seed)


def fsk_noise(shape, sps: int, cs: int, seed: int, device):
    """The Gaussians K6 adds to ``[C, K]`` symbols of ``sps`` samples:
    ``(gi, gq)`` ``[C, K, sps]`` from the JAX interpret tiles' keys
    (``seed + (c//128)*1000003 + (k//cs)*7919``, int32 wrap-around) and
    counters (``((k%cs + 1)*sps + j)*128 + c%128``, uint32)."""
    n_ch, k_sym = shape
    c = torch.arange(n_ch, dtype=torch.int64, device=device)[:, None, None]
    k = torch.arange(k_sym, dtype=torch.int64, device=device)[None, :, None]
    j = torch.arange(sps, dtype=torch.int64, device=device)[None, None, :]
    key = (seed + (c // LANE) * 1000003 + (k // cs) * 7919) & 0xFFFFFFFF
    ctr = (((k % cs + 1) * sps + j) * LANE + c % LANE) & 0xFFFFFFFF
    return gauss_pair(ctr, key)


def fsk_chain_plain(fnum, pnum, targets, den: int, sps: int, amp: float,
                    qshift: float, guard: int, cs: int, sigma, seed: int):
    """Plain version of K6: K8's waveform, the noise, K9's means, the
    nearest target."""
    ff, fp = _flat_int32(fnum, pnum)
    wi, wq = fsk_tx_plain(ff, fp, den, sps, amp, qshift)
    if sigma is not None:
        gi, gq = fsk_noise(ff.shape, sps, cs, seed, ff.device)
        wi = wi + sigma * gi.reshape(wi.shape)
        wq = wq + sigma * gq.reshape(wq.shape)
    mean = disc_means_plain(wi, wq, sps, guard)
    dec = torch.argmin(torch.abs(mean[..., None] - targets), dim=-1)
    return dec.to(torch.int32).reshape(fnum.shape)


def fsk_chain_kernel(fnum, pnum, targets, den: int, sps: int, amp: float,
                     qshift: float, guard: int, cs: int, sigma, seed: int):
    """Launch K6 (``modem_fsk_chain``) on CUDA tensors."""
    dev = fnum.device
    ff, fp = _flat_int32(fnum, pnum)
    for name, t, dt in (("fnum", ff, torch.int32), ("pnum", fp, torch.int32),
                        ("targets", targets, torch.float32)):
        check_cuda(name, t, dt, dev)
    c, k = ff.shape
    out = torch.empty_like(ff)
    if out.numel():
        FSK_CHAIN_KERNEL.launch(
            dev, ff.data_ptr(), fp.data_ptr(), c, k, targets.data_ptr(),
            targets.shape[0], den, sps, amp, qshift, f32(TWO_PI / den), guard,
            f32(1.0 / (sps - guard)), cs, int(sigma is not None),
            0.0 if sigma is None else sigma, seed & 0xFFFFFFFF,
            out.data_ptr())
    return out.reshape(fnum.shape)


def fused_fsk_chain(symbols: torch.Tensor, scheme, rates, guard: int = 1,
                    chunk_sym: int = DEFAULT_CHUNK_SYM,
                    snr_db: float | None = None, seed=None) -> torch.Tensor:
    """FSK loopback: ``[..., K]`` int32 symbols -> decided symbols, through
    the scheme's own phase program and K6. ``scheme``: BFSK, MFSK or CPFSK.
    ``snr_db`` is the per-complex-sample SNR of the in-kernel noise."""
    coefs = fsk_coef_table(scheme)
    prog, _ = scheme.program(
        symbols, scheme.init_state(symbols.shape[:-1], symbols.device),
        rates, 0)
    if not isinstance(prog, PhaseProgram) or prog.slots_per_symbol != 1:
        raise TypeError("fused FSK supports slots_per_symbol == 1 schemes")
    amp = float(scheme.amplitude)
    sigma = None if snr_db is None else fsk_noise_sigma(amp, snr_db)
    return fsk_decide_from_program(
        prog.fnum, prog.pnum, coefs, prog.den, rates.samples_per_symbol, amp,
        prog.qshift, guard, chunk_sym, sigma, seed)


# --------------------------------------------------------------------------
# K7: the MSK loopback
# --------------------------------------------------------------------------

def fused_msk_slots(s0: torch.Tensor, s1: torch.Tensor, spb: int,
                    amp: float, guard: int = 1,
                    chunk_slots: int = DEFAULT_CHUNK_SYM,
                    snr_db: float | None = None, seed=None) -> torch.Tensor:
    """MSK loopback: staggered slot signs ``[..., 2K]`` (+-1) -> per-slot
    discriminator sign bits ``[..., 2K]`` int32, 1 where the slot's tone is
    negative (``c = -1``). K10's half-sine synthesis, ``snr_db`` (per
    complex sample) of noise from the stream keyed by ``seed`` in tiles of
    ``chunk_slots`` slots, then the sign of the sum of the polynomial
    discriminator's increments into samples ``guard..spb-1``."""
    _check_guard(guard, spb, "fused MSK")
    if s0.shape != s1.shape:
        raise ValueError("s0 and s1 differ in shape")
    if chunk_slots < 1:
        raise ValueError("chunk_slots must be positive")
    sigma = None if snr_db is None else f32(fsk_noise_sigma(amp, snr_db))
    seed = 0 if seed is None else int(seed)
    run = msk_chain_kernel if s0.is_cuda else msk_chain_plain
    return run(s0, s1, int(spb), f32(amp), int(guard), int(chunk_slots), sigma,
               seed)


def msk_chain_plain(s0, s1, spb: int, amp: float, guard: int, cs: int, sigma,
                    seed: int) -> torch.Tensor:
    """Plain version of K7: K10's waveform, K6's noise geometry over slots of
    ``spb`` samples, the sign of K9's sum."""
    f0, f1 = _flat_int32(s0, s1)
    wi, wq = msk_tx_plain(f0, f1, spb, amp)
    if sigma is not None:
        gi, gq = fsk_noise(f0.shape, spb, cs, seed, f0.device)
        wi = wi + sigma * gi.reshape(wi.shape)
        wq = wq + sigma * gq.reshape(wq.shape)
    acc = _increment_sums(wi, wq, spb, guard)
    return (acc < 0).to(torch.int32).reshape(s0.shape)


def msk_chain_kernel(s0, s1, spb: int, amp: float, guard: int, cs: int, sigma,
                     seed: int) -> torch.Tensor:
    """Launch K7 (``modem_msk_chain``) on CUDA tensors."""
    dev = s0.device
    f0, f1 = _flat_int32(s0, s1)
    for name, t in (("s0", f0), ("s1", f1)):
        check_cuda(name, t, torch.int32, dev)
    c, k = f0.shape
    out = torch.empty_like(f0)
    if out.numel():
        MSK_CHAIN_KERNEL.launch(
            dev, f0.data_ptr(), f1.data_ptr(), c, k, spb, amp,
            f32(TWO_PI / (4 * spb)), guard, cs, int(sigma is not None),
            0.0 if sigma is None else sigma, seed & 0xFFFFFFFF, out.data_ptr())
    return out.reshape(s0.shape)
