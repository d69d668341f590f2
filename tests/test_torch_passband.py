"""The modes of K1-K3 in the PyTorch port (the plain versions the CPU runs)
and the passband chain around them, vs the JAX package on shared numpy
inputs: ``modem_tpu.ops.pallas_txrx`` / ``pallas_chain`` in interpret mode,
the staged and fused ``PulseShapedChain`` with ``carrier_hz``, natural
256-QAM, and the streaming classes at passband.

Modes: the passband NCO (2000 Hz at 10000, a table of 5 phases; 1700 Hz,
100 phases, per sample) with a negative and a positive ``sym_offset``;
algebraic square QAM (256-QAM); bf16 and int16 waveforms; K1's in-kernel
noise at baseband and passband over 130 channels x 300 symbols in tiles of
32, which crosses the noise stream's lane and tile keys.

Tolerances: decisions exactly (noisy K1 on >= 99.99%); waveforms and soft
points ``atol=1e-5`` (f32 reassociation); bf16 within one bf16 ulp; int16
within one step.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from modem_tpu import Rates as JRates
from modem_tpu import streaming as jstreaming
from modem_tpu.chain import PulseShapedChain as JChain
from modem_tpu.models.psk import QPSK as JQPSK
from modem_tpu.models.qam import QAM as JQAM
from modem_tpu.ops import pallas_chain as jchain_k, pallas_txrx as jtxrx
from modem_tpu.ops.filters import rrc_taps

from modem_tpu_torch import (Rates, StreamingFusedChain, StreamingFusedRx,
                             StreamingFusedTx)
from modem_tpu_torch.chain import PulseShapedChain
from modem_tpu_torch.models.psk import QPSK
from modem_tpu_torch.models.qam import QAM
from modem_tpu_torch.ops import chain_kernel, txrx

torch.set_num_threads(1)

SR = 10000
SPS, SPAN = 8, 8
RRC = rrc_taps(SPS, SPAN, 0.35)
LUT = np.asarray(JQPSK(0.0, 1.0).lut, np.float32)
QAM256 = jtxrx.qam_mparams(8, 0.1, 1.0)
ATOL = 1e-5
C, K = 3, 300

#: (id, keyword arguments shared by the JAX and the port call, bits/symbol)
MODES = [
    ("pb2000", {"carrier_hz": 2000, "sample_rate": SR, "sym_offset": -16}, 2),
    ("pb1700", {"carrier_hz": 1700, "sample_rate": SR, "sym_offset": 37}, 2),
    ("qam256", {"qam_params": QAM256}, 8),
    ("qam256_pb1700", {"qam_params": QAM256, "carrier_hz": 1700,
                       "sample_rate": SR, "sym_offset": -5}, 8),
]
IDS = [m[0] for m in MODES]


def _syms(bps, seed, shape=(C, K)):
    return np.random.default_rng(seed).integers(0, 1 << bps, shape).astype(
        np.int32)


def _lut(kw):
    return None if "qam_params" in kw else LUT


def _np(x):
    if isinstance(x, tuple):
        return tuple(_np(v) for v in x)
    if torch.is_tensor(x):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype == jnp.bfloat16 else x


def _rails(x):
    return x if isinstance(x, tuple) else (x,)


@pytest.mark.parametrize("mode", MODES, ids=IDS)
def test_tx_mode_matches_jax(mode):
    _, kw, bps = mode
    syms = _syms(bps, 1)
    want = _rails(_np(jtxrx.fused_tx(jnp.asarray(syms), _lut(kw), RRC, SPS,
                                     SPAN, **kw)))
    got = _rails(_np(txrx.fused_tx(torch.as_tensor(syms), _lut(kw), RRC, SPS,
                                   SPAN, **kw)))
    assert len(got) == len(want) == (1 if "carrier_hz" in kw else 2)
    for g, w in zip(got, want):
        assert g.shape == (C, (K + SPAN) * SPS)
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0)


@pytest.mark.parametrize("mode", MODES, ids=IDS)
def test_rx_mode_matches_jax(mode):
    """Hard decisions equal, soft points within 1e-5, on the JAX waveform
    plus noise."""
    _, kw, bps = mode
    syms = _syms(bps, 2)
    rng = np.random.default_rng(3)
    sigma = 0.1 if bps == 2 else 0.002
    wave = tuple(np.asarray(w) + rng.normal(0, sigma, np.shape(w)).astype(
        np.float32) for w in _rails(jtxrx.fused_tx(
            jnp.asarray(syms), _lut(kw), RRC, SPS, SPAN, **kw)))
    jw = wave[0] if len(wave) == 1 else wave
    tw = tuple(torch.as_tensor(w) for w in wave)
    tw = tw[0] if len(tw) == 1 else tw
    jw = jnp.asarray(jw) if len(wave) == 1 else tuple(map(jnp.asarray, jw))
    hard = txrx.fused_rx(tw, K, _lut(kw), RRC, SPS, SPAN, **kw)
    np.testing.assert_array_equal(hard.numpy(), np.asarray(jtxrx.fused_rx(
        jw, K, _lut(kw), RRC, SPS, SPAN, **kw)))
    assert (hard.numpy() == syms).mean() > 0.99
    soft = txrx.fused_rx(tw, K, _lut(kw), RRC, SPS, SPAN, soft=True, **kw)
    for g, w in zip(soft, jtxrx.fused_rx(jw, K, _lut(kw), RRC, SPS, SPAN,
                                         soft=True, **kw)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                   rtol=0)


@pytest.mark.parametrize("mode", MODES, ids=IDS)
def test_chain_mode_matches_jax(mode):
    """K1 noiseless in each mode: decisions equal the JAX kernel's and the
    symbols sent (streaming sentinels at the front of channel 0)."""
    _, kw, bps = mode
    syms = _syms(bps, 4)
    syms[0, :16] = -1
    kk = {k: v for k, v in kw.items() if k != "qam_params"}
    if "qam_params" in kw:
        args = (8, 0.1, 1.0, RRC, SPS, SPAN)
        want = jchain_k.fused_pulse_chain_qam(jnp.asarray(syms), *args, **kk)
        got = chain_kernel.fused_pulse_chain_qam(torch.as_tensor(syms), *args,
                                                 **kk)
    else:
        want = jchain_k.fused_pulse_chain(jnp.asarray(syms), LUT, RRC, SPS,
                                          SPAN, **kk)
        got = chain_kernel.fused_pulse_chain(torch.as_tensor(syms), LUT, RRC,
                                             SPS, SPAN, **kk)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy()[syms >= 0], syms[syms >= 0])


@pytest.mark.parametrize("carrier", [None, 2000], ids=["baseband", "pb2000"])
def test_chain_noise_matches_jax(carrier):
    """K1's in-kernel noise: the JAX interpret stream per 128-channel by
    32-symbol tile, over 130 x 300 symbols (two lane tiles, ten time
    tiles); decisions equal on >= 99.99%, errors at the 6 dB rate."""
    syms = _syms(2, 5, (130, K))
    kw = dict(snr_db=6.0, seed=5, chunk_sym=32, carrier_hz=carrier,
              sample_rate=SR if carrier else None, sym_offset=-8)
    want = np.asarray(jchain_k.fused_pulse_chain(jnp.asarray(syms), LUT, RRC,
                                                 SPS, SPAN, **kw))
    got = chain_kernel.fused_pulse_chain(torch.as_tensor(syms), LUT, RRC, SPS,
                                         SPAN, **kw).numpy()
    assert (got == want).mean() >= 0.9999
    assert 0.03 < (got != syms).mean() < 0.07
    other = chain_kernel.fused_pulse_chain(torch.as_tensor(syms), LUT, RRC,
                                           SPS, SPAN, **{**kw, "seed": 6})
    assert (other.numpy() != got).any()


def test_bf16_and_int16_waveforms():
    """bf16: within one bf16 ulp of the JAX store, read back by K3 to the
    same decisions; int16: within one step of JAX's ``round(x*scale)``."""
    syms = _syms(2, 6)
    jb = jtxrx.fused_tx(jnp.asarray(syms), LUT, RRC, SPS, SPAN,
                        wave_dtype=jnp.bfloat16)
    tb = txrx.fused_tx(torch.as_tensor(syms), LUT, RRC, SPS, SPAN,
                       wave_dtype=torch.bfloat16)
    for g, w in zip(tb, jb):
        assert g.dtype == torch.bfloat16
        w = np.asarray(w.astype(jnp.float32))
        g = g.float().numpy()
        # one bf16 ulp of the larger, past f32 reassociation near zero
        ulp = np.maximum(np.abs(w), np.abs(g)) * 2.0 ** -7 + 1e-7
        assert (np.abs(g - w) <= ulp).all()
    dec = txrx.fused_rx(tb, K, LUT, RRC, SPS, SPAN)
    np.testing.assert_array_equal(dec.numpy(), np.asarray(jtxrx.fused_rx(
        jb, K, LUT, RRC, SPS, SPAN)))
    np.testing.assert_array_equal(dec.numpy(), syms)
    for kw in ({}, {"carrier_hz": 2000, "sample_rate": SR, "sym_offset": -3}):
        ji = _rails(jtxrx.fused_tx(jnp.asarray(syms), LUT, RRC, SPS, SPAN,
                                   out_scale=1000.0, **kw))
        ti = _rails(txrx.fused_tx(torch.as_tensor(syms), LUT, RRC, SPS, SPAN,
                                  out_scale=1000.0, **kw))
        for g, w in zip(ti, ji):
            assert g.dtype == torch.int16
            assert np.abs(g.numpy().astype(int) - np.asarray(w).astype(
                int)).max() <= 1
        wave = ti[0] if kw else ti
        np.testing.assert_array_equal(
            txrx.fused_rx(wave, K, LUT, RRC, SPS, SPAN, **kw).numpy(), syms)


# ---- the chain at passband, and 256-QAM ----

@pytest.fixture(scope="module")
def passband():
    jc = JChain(JQPSK(0.0, 1.0), JRates(1250, SR), carrier_hz=2000)
    tc = PulseShapedChain(QPSK(0.0, 1.0), Rates(1250, SR), carrier_hz=2000,
                          device="cpu")
    bits = np.random.default_rng(8).integers(0, 2, (C, 2 * K)).astype(
        np.int32)
    return jc, tc, bits


def test_passband_chain_staged(passband):
    jc, tc, bits = passband
    want = np.asarray(jc.tx(jnp.asarray(bits)))
    got = tc.tx(torch.as_tensor(bits))
    assert got.shape == (C, (K + SPAN) * SPS)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    noisy = (want + np.random.default_rng(9).normal(0, 0.3, want.shape)
             ).astype(np.float32)
    dec = tc.rx(torch.as_tensor(noisy), K)
    np.testing.assert_array_equal(dec.numpy(), np.asarray(
        jc.rx(jnp.asarray(noisy), K)))
    for g, w in zip(tc.downconvert(torch.as_tensor(noisy)),
                    jc.downconvert(jnp.asarray(noisy))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)
    assert torch.equal(tc.roundtrip(torch.as_tensor(bits)),
                       torch.as_tensor(bits))


def test_passband_chain_fused(passband):
    jc, tc, bits = passband
    tb = torch.as_tensor(bits)
    wave = tc.tx_fused(tb, sym_offset=0)
    np.testing.assert_allclose(wave.numpy(), tc.tx(tb).numpy(), atol=ATOL)
    np.testing.assert_allclose(wave.numpy(), np.asarray(
        jc.tx_fused(jnp.asarray(bits))), atol=ATOL)
    assert torch.equal(tc.rx_fused(wave, K), tb)
    assert torch.equal(tc.roundtrip_fused(tb), tb)
    llr = tc.rx_soft_fused(wave, K, noise_var=0.5)
    want = np.asarray(jc.rx_soft_fused(jnp.asarray(wave.numpy()), K,
                                       noise_var=0.5))
    np.testing.assert_allclose(llr.numpy(), want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())
    i16 = tc.tx_fused(tb, out_scale=8000.0)
    assert i16.dtype == torch.int16 and torch.equal(tc.rx_fused(i16, K), tb)


def test_chain_arguments_in_jax_order():
    """``carrier_hz`` and ``fir_backend`` stand where the JAX constructor has
    them; ``fir_backend`` takes only ``"direct"``."""
    tc = PulseShapedChain(QPSK(0.0, 1.0), Rates(1250, SR), 8, 0.35, 2000,
                          "direct", False, "cpu")
    assert (tc.carrier_hz, tc.fir_backend, tc.polyphase) == (2000, "direct",
                                                              False)
    with pytest.raises(NotImplementedError, match="fir_backend"):
        PulseShapedChain(QPSK(0.0, 1.0), Rates(1250, SR), fir_backend="fft",
                         device="cpu")


def test_qam256_chain_takes_the_algebraic_mode():
    """Natural 256-QAM (past the 64-point table) through every fused form,
    equal to the JAX chain; Gray QAM keeps the table."""
    jc = JChain(JQAM(8, 0.0, 1.0), JRates(1250, SR))
    tc = PulseShapedChain(QAM(8, 0.0, 1.0), Rates(1250, SR), device="cpu")
    assert tc._txrx_params()["lut"] is None
    assert "qam_params" not in PulseShapedChain(
        QAM(4, 0.0, 6.0, gray=True), Rates(1250, SR),
        device="cpu")._txrx_params()
    bits = np.random.default_rng(10).integers(0, 2, (2, 8 * 200)).astype(
        np.int32)
    tb = torch.as_tensor(bits)
    wave = tc.tx_fused(tb)
    for g, w in zip(wave, jc.tx_fused(jnp.asarray(bits))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)
    assert torch.equal(tc.rx_fused(wave, 200), tb)
    assert torch.equal(tc.roundtrip_fused(tb), tb)
    np.testing.assert_array_equal(tc.roundtrip_fused(tb).numpy(), np.asarray(
        jc.roundtrip_fused(jnp.asarray(bits))))


# ---- streaming at passband ----

def _pieces(x, splits, unit):
    out, start = [], 0
    for n in splits:
        out.append(x[..., start * unit:(start + n) * unit])
        start += n
    return out


SPLITS = [37, 101, 100, 62]


def test_streaming_passband_equals_one_shot(passband):
    """The three streaming classes at passband in four pushes equal one
    shot (which equals the JAX chain's, above): each block's
    ``sym_offset`` carries the carrier phase across the seams, the first
    one negative."""
    _, tc, bits = passband
    tb = torch.as_tensor(bits)
    st = StreamingFusedTx(tc, (C,))
    wave = torch.cat([st.push(b) for b in _pieces(tb, SPLITS, 2)]
                     + [st.flush()], dim=-1)
    assert torch.equal(wave, tc.tx_fused(tb))
    sr = StreamingFusedRx(tc, (C,))
    out = [sr.push(w) for w in _pieces(wave, SPLITS + [SPAN], SPS)]
    assert torch.equal(torch.cat(out, dim=-1), tb)
    sc = StreamingFusedChain(tc, (C,))
    got = torch.cat([sc.push(b) for b in _pieces(tb, SPLITS, 2)]
                    + [sc.flush()], dim=-1)
    assert torch.equal(got, tb)


def test_streaming_chain_matches_jax_stream(passband):
    """The passband ``StreamingFusedChain`` against the JAX one, pushed
    alike (two pushes and the flush)."""
    jc, tc, bits = passband
    pieces = _pieces(torch.as_tensor(bits), [150, 150], 2)
    sc, jsc = StreamingFusedChain(tc, (C,)), jstreaming.StreamingFusedChain(
        jc, (C,))
    got = [sc.push(b) for b in pieces] + [sc.flush()]
    want = [jsc.push(jnp.asarray(b.numpy())) for b in pieces] + [jsc.flush()]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_streaming_tx_int16(passband):
    """``StreamingFusedTx(out_scale=)``: int16 pushes equal the one-shot
    int16 ``tx_fused``."""
    _, tc, bits = passband
    tb = torch.as_tensor(bits)
    st = StreamingFusedTx(tc, (C,), out_scale=8000.0)
    wave = torch.cat([st.push(b) for b in _pieces(tb, SPLITS, 2)]
                     + [st.flush()], dim=-1)
    assert wave.dtype == torch.int16
    assert torch.equal(wave, tc.tx_fused(tb, out_scale=8000.0))
