"""Fused loopback of the PyTorch port (``modem_tpu_torch.ops.chain_kernel``,
the plain version the CPU runs) vs ``modem_tpu.ops.pallas_chain
.fused_pulse_chain`` in interpret mode: noiseless, LUT, baseband.
Decisions must be exactly equal."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from modem_tpu.models.psk import BPSK as JBPSK, MPSK as JMPSK, QPSK as JQPSK
from modem_tpu.models.qam import QAM as JQAM
from modem_tpu.ops import pallas_chain as jchain
from modem_tpu.ops.filters import rrc_taps

from modem_tpu_torch.ops import chain_kernel, txrx

torch.set_num_threads(1)

SPS, SPAN = 8, 8
RRC = rrc_taps(SPS, SPAN, 0.35)
QPSK_LUT = np.asarray(JQPSK(0.0, 1.0).lut, np.float32)


def _both(syms, lut=QPSK_LUT, rrc=RRC, sps=SPS, span=SPAN):
    want = np.asarray(jchain.fused_pulse_chain(jnp.asarray(syms), lut, rrc,
                                               sps, span))
    got = chain_kernel.fused_pulse_chain(torch.as_tensor(syms), lut, rrc, sps,
                                         span)
    assert got.dtype == torch.int32 and got.shape == want.shape
    return got.numpy(), want


def test_qpsk_matches_jax():
    syms = np.random.default_rng(0).integers(0, 4, (3, 500)).astype(np.int32)
    got, want = _both(syms)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, syms)


@pytest.mark.parametrize("name,lut", [
    ("bpsk", JBPSK(0.0, 1.0).lut),
    ("8psk_gray", JMPSK(3, 0.0, 1.0, gray=True).lut),
    ("64qam_gray", JQAM(6, 0.3, 1.0, gray=True).lut),
])
def test_lut_schemes_match_jax(name, lut):
    lut = np.asarray(lut, np.float32)
    syms = np.random.default_rng(1).integers(
        0, len(lut), (2, 150)).astype(np.int32)
    got, want = _both(syms, lut)
    np.testing.assert_array_equal(got, want)


def test_streaming_sentinels_match_jax():
    """Inputs as the streaming loopback builds them: 2*span ``-1`` symbols
    ahead of the first block, and a carry-only flush block."""
    rng = np.random.default_rng(2)
    syms = rng.integers(0, 4, (3, 2 * SPAN + 200)).astype(np.int32)
    syms[:, :2 * SPAN] = -1
    got, want = _both(syms)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:, 2 * SPAN:], syms[:, 2 * SPAN:])
    tail = syms[:, -2 * SPAN:]
    np.testing.assert_array_equal(*_both(tail))


@pytest.mark.parametrize("shape", [(2, 3, 64), (1, 7), (4, 1)])
def test_shapes_match_jax(shape):
    syms = np.random.default_rng(3).integers(0, 4, shape).astype(np.int32)
    got, want = _both(syms)
    np.testing.assert_array_equal(got, want)


def test_other_geometry_matches_jax():
    sps, span = 4, 6
    rrc = rrc_taps(sps, span, 0.25)
    syms = np.random.default_rng(4).integers(0, 4, (2, 120)).astype(np.int32)
    got, want = _both(syms, rrc=rrc, sps=sps, span=span)
    np.testing.assert_array_equal(got, want)


def test_equals_tx_then_rx_plain():
    syms = torch.as_tensor(
        np.random.default_rng(5).integers(0, 4, (2, 80)).astype(np.int32))
    lut = torch.as_tensor(QPSK_LUT)
    taps = torch.as_tensor(RRC)
    wi, wq = txrx.tx_plain(syms, lut, taps, SPS, SPAN)
    assert torch.equal(chain_kernel.chain_plain(syms, lut, taps, SPS, SPAN),
                       txrx.rx_plain(wi, wq, 80, lut, taps, SPS, SPAN, False))


@pytest.mark.parametrize("kwargs", [{"snr_db": 6.0}, {"carrier_hz": 2000}])
def test_unported_modes_raise(kwargs):
    """The noise and passband modes, once refused, now run; each raises
    only for arguments it cannot take (a carrier without its sample rate,
    a noise tile of no symbols)."""
    syms = torch.zeros((1, 10), dtype=torch.int32)
    bad = ({"carrier_hz": 2000} if "carrier_hz" in kwargs
           else {**kwargs, "chunk_sym": 0})
    with pytest.raises(ValueError, match="sample_rate|chunk_sym"):
        chain_kernel.fused_pulse_chain(syms, QPSK_LUT, RRC, SPS, SPAN, **bad)
    good = {**kwargs, "sample_rate": 10000} if "carrier_hz" in kwargs else kwargs
    dec = chain_kernel.fused_pulse_chain(syms, QPSK_LUT, RRC, SPS, SPAN,
                                         **good)
    assert dec.dtype == torch.int32 and dec.shape == (1, 10)


def test_cpu_tensors_take_the_plain_version():
    before = chain_kernel.CHAIN_KERNEL.launches
    syms = torch.zeros((1, 20), dtype=torch.int32)
    chain_kernel.fused_pulse_chain(syms, QPSK_LUT, RRC, SPS, SPAN)
    assert chain_kernel.CHAIN_KERNEL.launches == before
    with pytest.raises(ValueError, match="kernel takes"):
        chain_kernel.chain_kernel(syms, torch.as_tensor(QPSK_LUT),
                                  torch.as_tensor(RRC), SPS, SPAN)


@pytest.mark.parametrize("sps,span", [(8, 32), (20, 16)])
@pytest.mark.parametrize("carrier", [None, 5], ids=["baseband", "passband"])
def test_long_chains_match_jax(sps, span, carrier):
    """Chains past K1's short route on the card (more than 256 taps, or
    sps 20): the plain version the CPU runs decides as the JAX kernel does
    (a carrier at a fifth of the sample rate). The JAX K1 takes spans below
    its 32-row halo only (``pallas_chain.HALO_ROWS``), so at span 32 the
    port's loopback is held to the JAX one-way pair, ``fused_tx`` then
    ``fused_rx``, in interpret mode."""
    from modem_tpu.ops import pallas_txrx as jtxrx

    rrc = rrc_taps(sps, span, 0.35)
    assert len(rrc) > txrx.MAX_KERNEL_TAPS
    syms = np.random.default_rng(sps).integers(0, 4, (2, 96)).astype(np.int32)
    kw = {}
    if carrier:
        sr = sps * 1250
        kw = {"carrier_hz": sr // carrier, "sample_rate": sr,
              "sym_offset": -16}
    if span < jchain.HALO_ROWS:
        want = jchain.fused_pulse_chain(jnp.asarray(syms), QPSK_LUT, rrc,
                                        sps, span, **kw)
    else:
        wave = jtxrx.fused_tx(jnp.asarray(syms), QPSK_LUT, rrc, sps, span,
                              **kw)
        want = jtxrx.fused_rx(wave, syms.shape[-1], QPSK_LUT, rrc, sps, span,
                              **kw)
    got = chain_kernel.fused_pulse_chain(torch.as_tensor(syms), QPSK_LUT, rrc,
                                         sps, span, **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), syms)
