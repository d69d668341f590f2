"""The ported slice as a whole: ``PulseShapedChain`` of ``modem_tpu_torch``
(built with ``from_numpy`` from the JAX chain's arrays) vs
``modem_tpu.chain.PulseShapedChain`` on the same numpy bits and waveforms,
staged and fused, clean and with numpy AWGN at Es/N0 = 6 dB.

Tolerances: bits and decisions exactly; waveforms ``atol=1e-5`` (f32
reassociation); LLRs ``rtol=1e-4`` (``atol=1e-5`` near zero).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from modem_tpu import Rates as JRates
from modem_tpu.chain import PulseShapedChain as JChain
from modem_tpu.chain import qpsk_reference_chain as j_qpsk_chain
from modem_tpu.models.psk import BPSK as JBPSK

from modem_tpu_torch import Rates, qpsk_reference_chain
from modem_tpu_torch.chain import PulseShapedChain, upsample_zero_stuff

torch.set_num_threads(1)

C, K = 3, 500
ES_N0_DB = 6.0
NOISE_VAR = 0.5
ATOL = 1e-5


def _params(jc):
    return {"lut": np.asarray(jc.lut), "rrc": np.asarray(jc.rrc),
            "bits_per_symbol": jc.scheme.bits_per_symbol, "span": jc.span,
            "sps": jc.sps}


@pytest.fixture(scope="module")
def chains():
    jc = j_qpsk_chain(JRates(1250, 10000))
    return jc, PulseShapedChain.from_numpy(_params(jc), Rates(1250, 10000),
                                          device="cpu")


@pytest.fixture(scope="module")
def case(chains):
    """Shared bits, the JAX staged waveform, and that waveform with numpy
    AWGN at Es/N0 = 6 dB (per-rail sigma^2 = Es / (2 Es/N0), Es = 1)."""
    jc, _ = chains
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, (C, 2 * K)).astype(np.int32)
    wave = tuple(np.array(w) for w in jc.tx(jnp.asarray(bits)))
    sigma = np.sqrt(1.0 / (2.0 * 10 ** (ES_N0_DB / 10)))
    noisy = tuple((w + rng.normal(0, sigma, w.shape)).astype(np.float32)
                  for w in wave)
    return bits, wave, noisy


def _j(w):
    return tuple(jnp.asarray(x) for x in w)


def _t(w):
    return tuple(torch.as_tensor(x) for x in w)


def test_from_numpy_carries_the_arrays(chains):
    jc, tc = chains
    np.testing.assert_array_equal(tc.lut.numpy(), np.asarray(jc.lut))
    np.testing.assert_array_equal(tc.rrc.numpy(), np.asarray(jc.rrc))
    assert (tc.sps, tc.span, tc.bits_per_symbol) == (8, 8, 2)
    assert {n for n, _ in tc.named_buffers()} == {"lut", "rrc"}


def test_qpsk_reference_chain_designs_the_same_taps(chains):
    jc, _ = chains
    tc = qpsk_reference_chain(Rates(1250, 10000), device="cpu")
    np.testing.assert_array_equal(tc.lut.numpy(), np.asarray(jc.lut))
    np.testing.assert_array_equal(tc.rrc.numpy(), np.asarray(jc.rrc))


def test_from_numpy_checks(chains):
    jc, _ = chains
    with pytest.raises(ValueError, match="sps"):
        PulseShapedChain.from_numpy(_params(jc), Rates(1000, 10000),
                                    device="cpu")
    bad = dict(_params(jc), rrc=np.asarray(jc.rrc)[:-1])
    with pytest.raises(ValueError, match="span"):
        PulseShapedChain.from_numpy(bad, Rates(1250, 10000), device="cpu")
    with pytest.raises(TypeError):
        PulseShapedChain(object(), Rates(1250, 10000), device="cpu")


def test_upsample_zero_stuff():
    x = torch.arange(1, 7, dtype=torch.float32).reshape(2, 3)
    u = upsample_zero_stuff(x, 3)
    assert u.shape == (2, 9)
    np.testing.assert_array_equal(u[:, ::3].numpy(), x.numpy())
    assert float(u.sum()) == float(x.sum())


@pytest.mark.parametrize("polyphase", [False, True])
def test_staged_tx(case, polyphase):
    bits, wave, _ = case
    tc = PulseShapedChain.from_numpy(
        _params(j_qpsk_chain(JRates(1250, 10000))), Rates(1250, 10000),
        polyphase=polyphase, device="cpu")
    got = tc.tx(torch.as_tensor(bits))
    for g, w in zip(got, wave):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, atol=ATOL)


@pytest.mark.parametrize("noisy", [False, True])
def test_staged_rx(chains, case, noisy):
    jc, tc = chains
    bits, clean, dirty = case
    w = dirty if noisy else clean
    want = np.asarray(jc.rx(_j(w), K))
    got = tc.rx(_t(w), K)
    np.testing.assert_array_equal(got.numpy(), want)
    if not noisy:
        np.testing.assert_array_equal(got.numpy(), bits)


@pytest.mark.parametrize("noisy", [False, True])
def test_staged_rx_soft(chains, case, noisy):
    jc, tc = chains
    _, clean, dirty = case
    w = dirty if noisy else clean
    want = np.asarray(jc.rx_soft(_j(w), K, noise_var=NOISE_VAR))
    got = tc.rx_soft(_t(w), K, noise_var=NOISE_VAR)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=ATOL)


def test_decision_points_polyphase_agree(chains, case):
    _, tc = chains
    _, _, dirty = case
    tp = PulseShapedChain.from_numpy(
        {"lut": tc.lut.numpy(), "rrc": tc.rrc.numpy(), "bits_per_symbol": 2,
         "span": 8, "sps": 8}, Rates(1250, 10000), polyphase=True,
        device="cpu")
    for a, b in zip(tc.decision_points(_t(dirty), K),
                    tp.decision_points(_t(dirty), K)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=ATOL)


def test_roundtrip(chains, case):
    jc, tc = chains
    bits, _, _ = case
    got = tc.roundtrip(torch.as_tensor(bits))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jc.roundtrip(jnp.asarray(bits))))
    np.testing.assert_array_equal(got.numpy(), bits)


def test_tx_fused(chains, case):
    jc, tc = chains
    bits, wave, _ = case
    want = jc.tx_fused(jnp.asarray(bits))
    got = tc.tx_fused(torch.as_tensor(bits))
    for g, w, s in zip(got, want, wave):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)
        np.testing.assert_allclose(g.numpy(), s, atol=ATOL)


@pytest.mark.parametrize("noisy", [False, True])
def test_rx_fused(chains, case, noisy):
    jc, tc = chains
    bits, clean, dirty = case
    w = dirty if noisy else clean
    want = np.asarray(jc.rx_fused(_j(w), K))
    got = tc.rx_fused(_t(w), K)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), tc.rx(_t(w), K).numpy())
    if not noisy:
        np.testing.assert_array_equal(got.numpy(), bits)


@pytest.mark.parametrize("noisy", [False, True])
def test_rx_soft_fused(chains, case, noisy):
    jc, tc = chains
    _, clean, dirty = case
    w = dirty if noisy else clean
    want = np.asarray(jc.rx_soft_fused(_j(w), K, noise_var=NOISE_VAR))
    got = tc.rx_soft_fused(_t(w), K, noise_var=NOISE_VAR)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=ATOL)
    np.testing.assert_array_equal((got < 0).int().numpy(),
                                  tc.rx(_t(w), K).numpy())


def test_roundtrip_fused(chains, case):
    jc, tc = chains
    bits, _, _ = case
    got = tc.roundtrip_fused(torch.as_tensor(bits))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jc.roundtrip_fused(jnp.asarray(bits))))
    np.testing.assert_array_equal(got.numpy(), bits)


def test_noisy_errors_agree(chains, case):
    """At Es/N0 = 6 dB the noisy case has bit errors, and both packages make
    the same ones."""
    jc, tc = chains
    bits, _, dirty = case
    got = tc.rx_fused(_t(dirty), K).numpy()
    n_err = int(np.sum(got != bits))
    assert 0 < n_err < 0.1 * bits.size
    assert n_err == int(np.sum(np.asarray(jc.rx_fused(_j(dirty), K)) != bits))


def test_bpsk_chain():
    jc = JChain(JBPSK(0.0, 1.0), JRates(1000, 4000), span_symbols=6)
    tc = PulseShapedChain.from_numpy(_params(jc), Rates(1000, 4000),
                                     device="cpu")
    bits = np.random.default_rng(1).integers(0, 2, (2, 64)).astype(np.int32)
    wave = jc.tx(jnp.asarray(bits))
    for g, w in zip(tc.tx_fused(torch.as_tensor(bits)), wave):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)
    np.testing.assert_array_equal(
        tc.roundtrip_fused(torch.as_tensor(bits)).numpy(),
        np.asarray(jc.roundtrip_fused(jnp.asarray(bits))))


@pytest.mark.parametrize("noisy", [False, True])
def test_matched_filter_and_decimate(chains, case, noisy):
    """The staged RX's two steps on their own, against the JAX chain's."""
    jc, tc = chains
    _, clean, dirty = case
    w = dirty if noisy else clean
    want = [np.asarray(y) for y in jc.matched_filter(*_j(w))]
    got = tc.matched_filter(*_t(w))
    for g, y in zip(got, want):
        assert g.shape == y.shape
        np.testing.assert_allclose(g.numpy(), y, atol=ATOL)
    # decimate on the same numpy inputs: a gather, so equal exactly
    want_d = jc.decimate(*(jnp.asarray(y) for y in want), K)
    got_d = tc.decimate(*(torch.as_tensor(y) for y in want), K)
    for g, y in zip(got_d, want_d):
        np.testing.assert_array_equal(g.numpy(), np.asarray(y))


@pytest.mark.parametrize("carrier_hz", [2000, 1700])
def test_matched_filter_passband(carrier_hz):
    """A passband chain: product detection, then the two steps, against
    the JAX chain's on the JAX waveform."""
    from modem_tpu.models.psk import QPSK as JQPSK
    from modem_tpu_torch.models.psk import QPSK

    jc = JChain(JQPSK(0.0, 1.0), JRates(1250, 10000), carrier_hz=carrier_hz)
    tc = PulseShapedChain(QPSK(0.0, 1.0), Rates(1250, 10000),
                          carrier_hz=carrier_hz, device="cpu")
    np.testing.assert_array_equal(tc.rrc.numpy(), np.asarray(jc.rrc))
    bits = np.random.default_rng(3).integers(0, 2, (C, 2 * K)).astype(np.int32)
    x = np.asarray(jc.tx(jnp.asarray(bits)))
    want = jc.matched_filter(*jc.downconvert(jnp.asarray(x)))
    got = tc.matched_filter(*tc.downconvert(torch.as_tensor(x)))
    for g, y in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(y), atol=ATOL)
    di, dq = tc.decimate(*got, K)
    jdi, jdq = jc.decimate(*want, K)
    np.testing.assert_allclose(di.numpy(), np.asarray(jdi), atol=ATOL)
    np.testing.assert_allclose(dq.numpy(), np.asarray(jdq), atol=ATOL)
    # the decisions the two steps lead to are the staged rx's
    np.testing.assert_array_equal(tc.rx(torch.as_tensor(x), K).numpy(), bits)
