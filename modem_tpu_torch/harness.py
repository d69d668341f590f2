"""Link-level simulation harnesses: BER waterfalls on the card (counterpart
of :mod:`modem_tpu.harness`).

The fused loopback K1 (:mod:`modem_tpu_torch.ops.chain_kernel`) draws its
AWGN on the chip, so a whole Monte-Carlo BER point (waveform synthesis,
channel, matched filter, decisions) is one kernel per block; the errors
are counted on the device. Calibration is held to the closed forms below.

* closed forms: :func:`q_function`, :func:`qpsk_ber_theory`,
  :func:`mqam_ber_theory`, :func:`mpsk_ber_theory`,
  :func:`rayleigh_ber_theory`, :func:`natural_binary_flip_factor`;
* :func:`fused_ber_point` and :func:`ber_waterfall` through K1's noise
  mode, the symbols drawn by ``np.random.default_rng(seed)`` as the JAX
  package draws them;
* :func:`chain_awgn_ber_point`, :func:`ofdm_ber_point` and
  :func:`ofdm_rayleigh_ber_point`: the staged chain and the OFDM payload
  path with noise from a seeded ``torch.Generator``;
* :func:`release_gates`: the five Monte-Carlo correctness gates of the JAX
  package.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .chain import PulseShapedChain, qpsk_reference_chain
from .config import Rates
from .cuda import resolve_device
from .fec import QcLdpc, rs_dvb
from .link import FramedLink
from .models import make_scheme
from .models.psk import MPSK
from .ofdm import OfdmModem, _default_grid
from .ops.chain_kernel import fused_pulse_chain, fused_pulse_chain_qam
from .ops.channel import awgn
from .presets import qam16_gray_chain
from .utils.bits import unpack_symbols


def q_function(x: float) -> float:
    return 0.5 * math.erfc(x / math.sqrt(2.0))


def qpsk_ber_theory(es_n0_db: float) -> float:
    """QPSK (Gray, per rail) BER = Q(sqrt(Es/N0)) = Q(sqrt(2*Eb/N0))."""
    return q_function(math.sqrt(10.0 ** (es_n0_db / 10.0)))


def natural_binary_flip_factor(levels: int) -> float:
    """Average bit flips per adjacent-level error of a natural-binary rail
    of ``levels`` levels (`qam.rs:32-38` maps each rail in natural binary):
    ``sum(trailing_ones(i) + 1) / (L - 1)``, 4/3 for 16-QAM."""
    total = 0
    for i in range(levels - 1):
        t, v = 1, i
        while v & 1:
            t += 1
            v >>= 1
        total += t
    return total / (levels - 1)


def mqam_ber_theory(es_n0_db: float, m: int, gray: bool = False) -> float:
    """Square M-QAM nearest-neighbour BER approximation,
    ``4/log2(M) * (1 - 1/sqrt(M)) * Q(sqrt(3/(M-1) * Es/N0))``, times the
    natural-binary flip factor unless ``gray``."""
    k = math.log2(m)
    es_n0 = 10.0 ** (es_n0_db / 10.0)
    ber = (4.0 / k) * (1.0 - 1.0 / math.sqrt(m)) * q_function(
        math.sqrt(3.0 / (m - 1.0) * es_n0))
    if not gray:
        ber *= natural_binary_flip_factor(int(math.isqrt(m)))
    return ber


def mpsk_ber_theory(es_n0_db: float, m: int, gray: bool = False) -> float:
    """M-PSK nearest-neighbour BER approximation: SER ~=
    ``2*Q(sqrt(2*Es/N0)*sin(pi/M))``, times the average bit flips per
    adjacent slip (1 for Gray, the cyclic natural-binary average
    otherwise), over log2(M)."""
    es_n0 = 10.0 ** (es_n0_db / 10.0)
    ser = 2.0 * q_function(math.sqrt(2.0 * es_n0) * math.sin(math.pi / m))
    k = math.log2(m)
    if gray:
        flips = 1.0
    else:
        flips = sum(bin(i ^ ((i + 1) % m)).count("1") for i in range(m)) / m
    return ser * flips / k


def rayleigh_ber_theory(eb_n0_db: float) -> float:
    """Coherent BPSK-per-rail BER over flat Rayleigh fading with perfect
    CSI: ``0.5*(1 - sqrt(g/(1+g)))``, g the average Eb/N0."""
    g = 10.0 ** (eb_n0_db / 10.0)
    return 0.5 * (1.0 - math.sqrt(g / (1.0 + g)))


@dataclasses.dataclass(frozen=True)
class BerPoint:
    snr_db: float
    bit_errors: int
    bits: int

    @property
    def ber(self) -> float:
        return self.bit_errors / self.bits


def fused_ber_point(chain: PulseShapedChain, snr_db: float,
                    n_symbols: int = 4096, channels: int = 64,
                    seed: int = 0) -> BerPoint:
    """One Monte-Carlo BER point through the fused loopback (K1 with its
    noise, at baseband): ``snr_db`` is Es/N0 at the matched-filter decision
    point, the noise stream keyed by ``seed + 1``."""
    bps = chain.bits_per_symbol
    rng = np.random.default_rng(seed)
    syms = torch.as_tensor(rng.integers(0, 1 << bps, (channels, n_symbols))
                           .astype(np.int32), device=chain.lut.device)
    kwargs = dict(rrc_taps=chain.rrc, sps=chain.sps, span=chain.span,
                  snr_db=snr_db, seed=seed + 1)
    if chain._algebraic_qam():
        dec = fused_pulse_chain_qam(syms, bps, chain.scheme.phase,
                                    chain.scheme.amplitude, **kwargs)
    else:
        dec = fused_pulse_chain(syms, chain.lut, **kwargs)
    tx_bits = unpack_symbols(syms, bps)
    errors = int(torch.sum(tx_bits != unpack_symbols(dec, bps)))
    return BerPoint(snr_db, errors, tx_bits.numel())


def ber_waterfall(chain: PulseShapedChain, snrs_db, n_symbols: int = 4096,
                  channels: int = 64, seed: int = 0) -> list[BerPoint]:
    """BER across an Es/N0 sweep, one fused run per point (seed ``seed +
    17*i`` for point i)."""
    return [fused_ber_point(chain, s, n_symbols, channels, seed + 17 * i)
            for i, s in enumerate(snrs_db)]


def chain_awgn_ber_point(chain: PulseShapedChain, es_n0_db: float,
                         n_symbols: int = 4096, channels: int = 32,
                         seed: int = 0) -> BerPoint:
    """One Monte-Carlo BER point through the staged baseband chain, the
    bits drawn by ``np.random.default_rng(seed)`` and the noise by a
    ``torch.Generator`` seeded ``seed + 1`` on the chain's device. With the
    unit-energy RRC the per-rail noise survives the matched filter
    unchanged, so noise at Es/N0 against the table's mean energy Es gives
    the requested decision-point ratio."""
    bps = chain.bits_per_symbol
    dev = chain.lut.device
    rng = np.random.default_rng(seed)
    bits = torch.as_tensor(rng.integers(0, 2, (channels, n_symbols * bps))
                           .astype(np.int32), device=dev)
    i, q = chain.tx(bits)
    lut = chain.lut.detach().cpu().numpy()
    es = float(np.mean(np.sum(lut * lut, axis=-1)))
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    out = chain.rx(awgn(g, i, q, es_n0_db, signal_power=es), n_symbols)
    return BerPoint(es_n0_db, int(torch.sum(out != bits)), bits.numel())


def _pilotless_modem(scheme, device) -> OfdmModem:
    """The default 64-FFT grid with every used bin carrying data."""
    data, pilots = _default_grid(64)
    return OfdmModem(scheme, data_bins=data + pilots, pilot_bins=(),
                     device=device)


def ofdm_ber_point(scheme, es_n0_db: float, n_symbols: int = 40,
                   channels: int = 32, seed: int = 0,
                   device: torch.device | str | None = None) -> BerPoint:
    """One Monte-Carlo BER point through the OFDM payload path over AWGN:
    the pilotless default grid with an ideal channel, so the point
    measures the detector. With the unitary reduced DFT the per-bin Es/N0
    is the per-sample ratio, so the single-carrier closed forms hold. Bits
    from ``np.random.default_rng(seed)``, noise from a ``torch.Generator``
    seeded ``seed + 1``."""
    dev = resolve_device(device)
    modem = _pilotless_modem(scheme, dev)
    rng = np.random.default_rng(seed)
    bits = torch.as_tensor(
        rng.integers(0, 2, (channels, modem.bits_per_frame(n_symbols)))
        .astype(np.int32), device=dev)
    i, q = modem.tx_payload(bits)
    es = float(np.mean(np.sum(modem.lut ** 2, axis=-1)))
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    ni, nq = awgn(g, i, q, es_n0_db, signal_power=es)
    out = modem.rx_payload(ni, nq, n_symbols)
    return BerPoint(es_n0_db, int(torch.sum(out != bits)), bits.numel())


def ofdm_rayleigh_ber_point(scheme, eb_n0_db: float, n_symbols: int = 8,
                            channels: int = 256, n_taps: int = 8,
                            seed: int = 0,
                            device: torch.device | str | None = None
                            ) -> BerPoint:
    """OFDM over a random CP-contained multipath channel with ideal per-bin
    CSI: each batch element draws ``n_taps`` iid CN(0, 1/L) taps (numpy,
    ``default_rng(seed)`` after the bits), so every data bin sees a
    marginally Rayleigh gain and the batch average must reproduce
    :func:`rayleigh_ber_theory`. Noise from a ``torch.Generator`` seeded
    ``seed + 1``."""
    dev = resolve_device(device)
    modem = _pilotless_modem(scheme, dev)
    bps = modem.bits_per_symbol
    rng = np.random.default_rng(seed)
    bits = torch.as_tensor(
        rng.integers(0, 2, (channels, modem.bits_per_frame(n_symbols)))
        .astype(np.int32), device=dev)
    xi, xq = modem.tx_payload(bits)

    # per-batch complex taps, E[|H|^2] = 1
    taps = rng.normal(size=(channels, n_taps, 2)) / math.sqrt(2 * n_taps)
    hi_t = torch.as_tensor(taps[..., 0], dtype=torch.float32, device=dev)
    hq_t = torch.as_tensor(taps[..., 1], dtype=torch.float32, device=dev)
    yi, yq = torch.zeros_like(xi), torch.zeros_like(xq)
    for l in range(n_taps):
        sx = xi if l == 0 else torch.cat(
            [xi.new_zeros(xi.shape[:-1] + (l,)), xi[..., :-l]], -1)
        sy = xq if l == 0 else torch.cat(
            [xq.new_zeros(xq.shape[:-1] + (l,)), xq[..., :-l]], -1)
        a, b = hi_t[:, l][:, None], hq_t[:, l][:, None]
        yi = yi + sx * a - sy * b
        yq = yq + sx * b + sy * a

    # the exact per-used-bin H of the taps (ideal CSI)
    k_bins = np.asarray(modem.used_bins, np.float64)[:, None]
    ll = np.arange(n_taps, dtype=np.float64)[None, :]
    ang = -2.0 * np.pi * k_bins * ll / modem.n_fft  # [U, L]
    cr = torch.as_tensor(np.cos(ang).astype(np.float32).T, device=dev)
    ci = torch.as_tensor(np.sin(ang).astype(np.float32).T, device=dev)
    h_i = hi_t @ cr - hq_t @ ci  # [B, U]
    h_q = hi_t @ ci + hq_t @ cr

    es = float(np.mean(np.sum(modem.lut ** 2, axis=-1)))
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    # Es/N0 = Eb/N0 * bits a symbol
    yi, yq = awgn(g, yi, yq, eb_n0_db + 10.0 * math.log10(bps),
                  signal_power=es)
    out = modem.rx_payload(yi, yq, n_symbols, h=(h_i, h_q))
    return BerPoint(eb_n0_db, int(torch.sum(out != bits)), bits.numel())


def release_gates(seed: int = 0, scale: int = 1,
                  device: torch.device | str | None = None) -> list[dict]:
    """The Monte-Carlo correctness gates on ``device`` (the card unless the
    caller asks for the CPU), one dict per gate in the JAX package's order:
    ``{gate, measured, expected, lo, hi, passed}``, a ratio gate passing
    iff ``lo <= measured/expected <= hi`` with at least 200 errors, the
    link gate iff every payload bit and CRC comes back, the LDPC gate iff
    the decode is error-free while the raw channel makes more than 100 ·
    ``scale`` errors. ``scale`` multiplies the sample counts."""
    dev = resolve_device(device)
    rates = Rates(baud_rate=1250, sample_rate=10000)
    gates: list[dict] = []

    def ratio_gate(name, pt, expected, lo=0.85, hi=1.18):
        r = pt.ber / expected
        gates.append({
            "gate": name, "measured": pt.ber, "expected": expected,
            "errors": pt.bit_errors, "bits": pt.bits, "lo": lo, "hi": hi,
            "passed": bool(lo <= r <= hi and pt.bit_errors >= 200)})

    # 1) 8-PSK natural binary over AWGN vs the closed form
    chain = PulseShapedChain(MPSK(3, 0.0, 1.0), rates, device=dev)
    pt = chain_awgn_ber_point(chain, 14.0, n_symbols=4096,
                              channels=32 * scale, seed=seed)
    ratio_gate("8psk_awgn_vs_theory", pt, mpsk_ber_theory(14.0, 8))

    # 2) 16-QAM Gray over AWGN vs the closed form
    chain = qam16_gray_chain(rates, device=dev)
    pt = chain_awgn_ber_point(chain, 14.0, n_symbols=4096,
                              channels=32 * scale, seed=seed + 1)
    ratio_gate("qam16_gray_awgn_vs_theory", pt,
               mqam_ber_theory(14.0, 16, gray=True))

    # 3) OFDM QPSK over Rayleigh multipath, ideal CSI, vs the closed form
    pt = ofdm_rayleigh_ber_point(make_scheme("qpsk", rates), 12.0,
                                 channels=256 * scale, seed=seed + 2,
                                 device=dev)
    ratio_gate("ofdm_qpsk_rayleigh_vs_theory", pt,
               rayleigh_ber_theory(12.0), lo=0.85, hi=1.2)

    # 4) RS(204,188) over conv K=7, framed: error-free at 1 dB while the
    #    raw channel is plainly noisy
    link = FramedLink(qpsk_reference_chain(rates, device=dev), rs=rs_dvb(),
                      interleave_rows=12)
    rng = np.random.default_rng(seed + 3)
    payload = torch.as_tensor(rng.integers(0, 2, (4 * scale,
                                                  link.payload_bits))
                              .astype(np.int32), device=dev)
    i, q = link.tx(payload)
    p = float(torch.mean(i * i + q * q))
    nv = p / (2.0 * 10.0 ** (1.0 / 10.0))
    g = torch.Generator(device=dev).manual_seed(seed + 4)
    out, ok = link.rx(awgn(g, i, q, 1.0, signal_power=p), nv)
    errs = int(torch.sum(out != payload))
    gates.append({
        "gate": "rs_conv_link_zero_errors_at_1db", "measured": errs,
        "expected": 0, "crc_all_ok": bool(ok.all()),
        "payload_bits": payload.numel(),
        "passed": bool(errs == 0 and ok.all())})

    # 5) LDPC(648,324) layered: error-free at 4.5 dB Eb/N0 while the raw
    #    channel makes hundreds of errors; the data continue gate 4's numpy
    #    stream and the noise is numpy's, so the inputs are the JAX gate's
    code = QcLdpc()
    data = torch.as_tensor(rng.integers(0, 2, (64 * scale, code.k))
                           .astype(np.int32), device=dev)
    cw = code.encode(data)
    x = 1.0 - 2.0 * cw.to(torch.float32)
    sigma2 = 1.0 / (2.0 * 0.5 * 10.0 ** (4.5 / 10.0))
    noise = torch.as_tensor(np.random.default_rng(seed + 5).normal(
        0.0, math.sqrt(sigma2), tuple(x.shape)).astype(np.float32),
        device=dev)
    y = x + noise
    raw = int(torch.sum((y < 0).to(torch.int32) != cw))
    dec = code.decode(2.0 * y / sigma2, iters=20, schedule="layered")
    errs = int(torch.sum(dec != data))
    gates.append({
        "gate": "ldpc_648_324_zero_errors_at_4p5db", "measured": errs,
        "expected": 0, "raw_channel_errors": raw,
        "data_bits": data.numel(),
        "passed": bool(errs == 0 and raw > 100 * scale)})
    return gates
