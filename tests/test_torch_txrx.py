"""Fused one-way TX/RX of the PyTorch port (``modem_tpu_torch.ops.txrx``, the
plain versions the CPU runs) vs ``modem_tpu.ops.pallas_txrx.fused_tx`` /
``fused_rx`` in interpret mode, on shared numpy inputs.

Tolerances: decisions exactly; waveforms and soft points ``atol=1e-5``
(f32 reassociation).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from modem_tpu.models.psk import MPSK as JMPSK, QPSK as JQPSK
from modem_tpu.models.qam import QAM as JQAM
from modem_tpu.ops import pallas_txrx as jtxrx
from modem_tpu.ops.filters import rrc_taps

from modem_tpu_torch.ops import txrx

torch.set_num_threads(1)

SPS, SPAN = 8, 8
RRC = rrc_taps(SPS, SPAN, 0.35)
QPSK_LUT = np.asarray(JQPSK(0.0, 1.0).lut, np.float32)
ATOL = 1e-5


def _syms(rng, shape, m=4):
    return rng.integers(0, m, shape).astype(np.int32)


def _j_tx(syms, lut=QPSK_LUT):
    wi, wq = jtxrx.fused_tx(jnp.asarray(syms), lut, RRC, SPS, SPAN)
    return np.array(wi), np.array(wq)  # writable copies


def _t_tx(syms, lut=QPSK_LUT):
    wi, wq = txrx.fused_tx(torch.as_tensor(syms), lut, RRC, SPS, SPAN)
    assert wi.dtype == torch.float32
    return wi.numpy(), wq.numpy()


@pytest.fixture(scope="module")
def qpsk_case():
    """3 channels x 500 symbols: symbols, the JAX waveform, and the JAX
    hard and soft RX of that waveform with light noise."""
    rng = np.random.default_rng(0)
    syms = _syms(rng, (3, 500))
    wave = _j_tx(syms)
    noisy = tuple((w + rng.normal(0, 0.15, w.shape)).astype(np.float32)
                  for w in wave)
    jw = tuple(jnp.asarray(w) for w in noisy)
    hard = np.asarray(jtxrx.fused_rx(jw, 500, QPSK_LUT, RRC, SPS, SPAN))
    soft = tuple(np.asarray(v) for v in jtxrx.fused_rx(
        jw, 500, QPSK_LUT, RRC, SPS, SPAN, soft=True))
    return syms, wave, noisy, hard, soft


def test_tx_matches_jax(qpsk_case):
    syms, wave, *_ = qpsk_case
    got = _t_tx(syms)
    assert got[0].shape == (3, (500 + SPAN) * SPS)
    for g, w in zip(got, wave):
        np.testing.assert_allclose(g, w, atol=ATOL)


def test_rx_hard_matches_jax(qpsk_case):
    syms, wave, noisy, hard, _ = qpsk_case
    got = txrx.fused_rx(tuple(torch.as_tensor(w) for w in noisy), 500,
                        QPSK_LUT, RRC, SPS, SPAN)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), hard)
    clean = txrx.fused_rx(tuple(torch.as_tensor(w) for w in wave), 500,
                          QPSK_LUT, RRC, SPS, SPAN)
    np.testing.assert_array_equal(clean.numpy(), syms)


def test_rx_soft_matches_jax(qpsk_case):
    _, _, noisy, _, soft = qpsk_case
    got = txrx.fused_rx(tuple(torch.as_tensor(w) for w in noisy), 500,
                        QPSK_LUT, RRC, SPS, SPAN, soft=True)
    for g, w in zip(got, soft):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, atol=ATOL)


def test_rx_longer_waveform(qpsk_case):
    """N above (K+span)*sps: only the first K decisions' samples count."""
    syms, wave, *_ = qpsk_case
    pad = [np.concatenate([w, np.ones((3, 37), np.float32)], -1) for w in wave]
    got = txrx.fused_rx(tuple(torch.as_tensor(w) for w in pad), 500,
                        QPSK_LUT, RRC, SPS, SPAN)
    np.testing.assert_array_equal(got.numpy(), syms)


def test_sentinel_symbols():
    """-1 is the streaming "no symbol here": zero I/Q, as in the JAX kernel."""
    rng = np.random.default_rng(1)
    syms = _syms(rng, (3, 120))
    syms[0, :16] = -1
    syms[1, 50:53] = -1
    syms[2, -4:] = -1
    for g, w in zip(_t_tx(syms), _j_tx(syms)):
        np.testing.assert_allclose(g, w, atol=ATOL)


def test_batch_shape():
    rng = np.random.default_rng(2)
    syms = _syms(rng, (2, 3, 90))
    got, want = _t_tx(syms), _j_tx(syms)
    assert got[0].shape == (2, 3, (90 + SPAN) * SPS)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=ATOL)
    jw = tuple(jnp.asarray(w) for w in want)
    tw = tuple(torch.as_tensor(w) for w in want)
    dec = txrx.fused_rx(tw, 90, QPSK_LUT, RRC, SPS, SPAN)
    assert dec.shape == (2, 3, 90)
    np.testing.assert_array_equal(
        dec.numpy(), np.asarray(jtxrx.fused_rx(jw, 90, QPSK_LUT, RRC, SPS, SPAN)))
    np.testing.assert_array_equal(dec.numpy(), syms)


@pytest.mark.parametrize("k", [1, 5, 31])
def test_short_blocks(k):
    """Blocks shorter than one kernel tile."""
    syms = _syms(np.random.default_rng(k), (2, k))
    want = _j_tx(syms)
    for g, w in zip(_t_tx(syms), want):
        np.testing.assert_allclose(g, w, atol=ATOL)
    dec = txrx.fused_rx(tuple(torch.as_tensor(w) for w in want), k, QPSK_LUT,
                        RRC, SPS, SPAN)
    np.testing.assert_array_equal(dec.numpy(), syms)


@pytest.mark.parametrize("name,lut", [
    ("8psk_gray", JMPSK(3, 0.1, 1.0, gray=True).lut),
    ("64qam_gray", JQAM(6, 0.0, 1.0, gray=True).lut),
])
def test_other_lut_schemes(name, lut):
    m = len(lut)
    syms = _syms(np.random.default_rng(3), (2, 100), m)
    want = _j_tx(syms, lut)
    for g, w in zip(_t_tx(syms, lut), want):
        np.testing.assert_allclose(g, w, atol=ATOL)
    dec = txrx.fused_rx(tuple(torch.as_tensor(w) for w in want), 100, lut,
                        RRC, SPS, SPAN)
    np.testing.assert_array_equal(dec.numpy(), syms)


def test_rejects_short_waveform():
    w = np.zeros((2, (40 + SPAN) * SPS - 1), np.float32)
    with pytest.raises(ValueError, match="shorter"):
        jtxrx.fused_rx((jnp.asarray(w), jnp.asarray(w)), 40, QPSK_LUT, RRC,
                       SPS, SPAN)
    with pytest.raises(ValueError, match="shorter"):
        txrx.fused_rx((torch.as_tensor(w), torch.as_tensor(w)), 40, QPSK_LUT,
                      RRC, SPS, SPAN)


def test_rejects_bad_tables():
    syms = torch.zeros((1, 10), dtype=torch.int32)
    with pytest.raises(ValueError, match="64"):
        txrx.fused_tx(syms, np.zeros((65, 2), np.float32), RRC, SPS, SPAN)
    with pytest.raises(ValueError, match="span"):
        txrx.fused_tx(syms, QPSK_LUT, RRC[:-1], SPS, SPAN)


@pytest.mark.parametrize("kwargs", [
    {"carrier_hz": 2000}, {"qam_params": (2, 3.0, 0.1, 1.0, 0.0)},
    {"out_scale": 1000.0}, {"wave_dtype": torch.bfloat16},
])
def test_tx_unported_modes_raise(kwargs):
    """The modes once refused now run; what they cannot take raises
    ``ValueError``: a carrier without its sample rate or past the int32
    NCO, a table and QAM parameters together, an int16 store without its
    scale."""
    syms = torch.zeros((1, 10), dtype=torch.int32)
    key = next(iter(kwargs))
    bad = {"carrier_hz": {"carrier_hz": 50000, "sample_rate": 50000},
           "qam_params": {"qam_params": kwargs["qam_params"]} if key ==
           "qam_params" else {},
           "out_scale": {"wave_dtype": torch.int16},
           "wave_dtype": {"wave_dtype": torch.float64}}[key]
    with pytest.raises(ValueError):
        txrx.fused_tx(syms, QPSK_LUT, RRC, SPS, SPAN, **bad)
    good = ({**kwargs, "sample_rate": 10000} if key == "carrier_hz"
            else kwargs)
    lut = None if key == "qam_params" else QPSK_LUT
    out = txrx.fused_tx(syms, lut, RRC, SPS, SPAN, **good)
    first = out if key == "carrier_hz" else out[0]
    assert first.shape == (1, (10 + SPAN) * SPS)
    assert first.dtype == {"out_scale": torch.int16,
                           "wave_dtype": torch.bfloat16}.get(key,
                                                             torch.float32)


def test_rx_unported_modes_raise():
    """Passband and bf16 input, once refused, now decide; a passband call
    given an (i, q) pair raises."""
    w = torch.zeros((1, 200 * SPS))
    with pytest.raises(ValueError, match="passband"):
        txrx.fused_rx((w, w), 10, QPSK_LUT, RRC, SPS, SPAN, carrier_hz=2000,
                      sample_rate=10000)
    pb = txrx.fused_rx(w, 10, QPSK_LUT, RRC, SPS, SPAN, carrier_hz=2000,
                       sample_rate=10000)
    bf = txrx.fused_rx((w.bfloat16(), w.bfloat16()), 10, QPSK_LUT, RRC, SPS,
                       SPAN)
    assert pb.shape == bf.shape == (1, 10) and bf.dtype == torch.int32


def test_cpu_tensors_take_the_plain_version():
    """A CPU tensor runs the plain version; the kernel wrappers refuse it."""
    counts = (txrx.TX_KERNEL.launches, txrx.RX_HARD_KERNEL.launches,
              txrx.RX_SOFT_KERNEL.launches)
    syms = torch.zeros((1, 20), dtype=torch.int32)
    wi, wq = txrx.fused_tx(syms, QPSK_LUT, RRC, SPS, SPAN)
    txrx.fused_rx((wi, wq), 20, QPSK_LUT, RRC, SPS, SPAN)
    txrx.fused_rx((wi, wq), 20, QPSK_LUT, RRC, SPS, SPAN, soft=True)
    assert counts == (txrx.TX_KERNEL.launches, txrx.RX_HARD_KERNEL.launches,
                      txrx.RX_SOFT_KERNEL.launches)
    lut, taps = txrx.check_lut_taps(QPSK_LUT, RRC, SPS, SPAN, syms.device)
    with pytest.raises(ValueError, match="kernel takes"):
        txrx.tx_kernel(syms, lut, taps, SPS, SPAN)
    with pytest.raises(ValueError, match="kernel takes"):
        txrx.rx_kernel(wi, wq, 20, lut, taps, SPS, SPAN, False)


@pytest.mark.parametrize("sps,span", [(8, 32), (20, 16)])
@pytest.mark.parametrize("carrier", [None, 5], ids=["baseband", "passband"])
def test_long_chains_match_jax(sps, span, carrier):
    """Chains past K3's short route on the card (more than 256 taps, or
    sps 20): on the JAX TX's waveform with light noise, the plain version
    the CPU runs decides as the JAX kernel does, and its soft points agree
    (a carrier at a fifth of the sample rate)."""
    rrc = rrc_taps(sps, span, 0.35)
    assert len(rrc) > txrx.MAX_KERNEL_TAPS
    rng = np.random.default_rng(sps)
    syms = _syms(rng, (2, 96))
    kw = {}
    if carrier:
        sr = sps * 1250
        kw = {"carrier_hz": sr // carrier, "sample_rate": sr,
              "sym_offset": -16}
    wave = jtxrx.fused_tx(jnp.asarray(syms), QPSK_LUT, rrc, sps, span, **kw)
    wave = (wave,) if carrier else wave
    noisy = tuple((np.asarray(w) + rng.normal(0, 0.15, w.shape))
                  .astype(np.float32) for w in wave)
    jw = jnp.asarray(noisy[0]) if carrier else tuple(map(jnp.asarray, noisy))
    tw = torch.as_tensor(noisy[0]) if carrier else tuple(
        map(torch.as_tensor, noisy))
    for soft in (False, True):
        want = jtxrx.fused_rx(jw, 96, QPSK_LUT, rrc, sps, span, soft=soft,
                              **kw)
        got = txrx.fused_rx(tw, 96, QPSK_LUT, rrc, sps, span, soft=soft, **kw)
        if soft:
            for g, w in zip(got, want):
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           atol=ATOL)
        else:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            np.testing.assert_array_equal(got.numpy(), syms)
