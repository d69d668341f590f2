"""The port's other scheme-family chains vs the JAX package's on the same
numpy inputs: ``FskChain`` (every staged and fused method, BFSK, 4-FSK,
16-MFSK with both maps, CPFSK), ``MskChain``, ``GmskChain``,
``OqpskChain``, ``DcqpskChain`` and ``DifferentialChain`` (DBPSK, DQPSK).
The JAX Pallas kernels run in interpret mode; the port's kernels run their
plain versions (CPU tensors).

Tolerances: noiseless bits exactly, and decisions on the same noisy
waveform equal; waveforms ``atol=2e-6`` (FSK/MSK synthesis, f32 trig of two
libraries) or ``1e-5`` (after a FIR or a prefix sum: f32 reassociation);
LLRs ``rtol=1e-5`` (with ``atol`` 1e-5 of the largest); noisy K6 decisions
on >= 99.9% of symbols.
"""

import math

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from modem_tpu import Rates as JRates
from modem_tpu import chain as jchain
from modem_tpu import gmsk as jgmsk
from modem_tpu import make_scheme as jmake
from modem_tpu.models import fsk as jfsk

from modem_tpu_torch import (DcqpskChain, DifferentialChain, FskChain,
                             GmskChain, MskChain, OqpskChain, Rates,
                             make_scheme)
from modem_tpu_torch import gmsk as tgmsk
from modem_tpu_torch.models import fsk as tfsk

torch.set_num_threads(1)

JR, TR = JRates(1250, 10000), Rates(1250, 10000)
SR = 10000
CPU = "cpu"
TWO_PI = 2 * math.pi

# (id, JAX scheme, port scheme, coefs, dev rad/sample)
FSK = [
    ("bfsk", lambda: jfsk.BFSK(200, SR, 1.0), lambda: tfsk.BFSK(200, SR, 1.0),
     np.arange(2), TWO_PI * 200 / SR),
    ("4fsk", lambda: jfsk.MFSK(2, 100, SR, 1.0, "increase"),
     lambda: tfsk.MFSK(2, 100, SR, 1.0, "increase"), 2 * np.arange(4),
     TWO_PI * 100 / SR),
    ("16mfsk_increase", lambda: jfsk.MFSK(4, 50, SR, 1.0, "increase"),
     lambda: tfsk.MFSK(4, 50, SR, 1.0, "increase"), 2 * np.arange(16),
     TWO_PI * 50 / SR),
    ("16mfsk_default", lambda: jfsk.MFSK(4, 50, SR, 1.0, "default"),
     lambda: tfsk.MFSK(4, 50, SR, 1.0, "default"), 2 * np.arange(16) - 15,
     TWO_PI * 50 / SR),
    ("cpfsk2", lambda: jfsk.CPFSK(2, JR, 1.0, 1),
     lambda: tfsk.CPFSK(2, TR, 1.0, 1), 2 * np.arange(4), TWO_PI * 625 / SR),
]
FSK_IDS = [c[0] for c in FSK]


def _bits(shape, seed):
    return np.random.default_rng(seed).integers(0, 2, shape).astype(np.int32)


def _noise(shape, sigma, seed):
    return np.random.default_rng(seed).normal(0, sigma, shape).astype(np.float32)


def _close(got, want, atol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol, rtol=0)


def _equal(got, want):
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))


def _llr_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def _t(*arrays):
    return tuple(torch.as_tensor(np.asarray(a)) for a in arrays)


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


# ---- FskChain ----

def _fsk(case, guard=1):
    _, mj, mt, coefs, dev = case
    js, ts = mj(), mt()
    return (jchain.FskChain(js, JR, coefs, dev, guard),
            FskChain(ts, TR, coefs, dev, guard, device=CPU), js.bits_per_symbol)


def _fsk_wave(jc, bps, seed, n_sym=200, sigma=0.0):
    bits = _bits((3, n_sym * bps), seed)
    i, q = (np.asarray(v) for v in jc.tx(jnp.asarray(bits)))
    return bits, i + _noise(i.shape, sigma, seed + 1), q + _noise(q.shape, sigma, seed + 2)


@pytest.mark.parametrize("case", FSK, ids=FSK_IDS)
def test_fsk_tx_and_roundtrip(case):
    jc, tc, bps = _fsk(case)
    bits = _bits((3, 200 * bps), 1)
    got = tc.tx(torch.as_tensor(bits))
    for g, w in zip(got, jc.tx(jnp.asarray(bits))):
        assert g.shape == (3, 1600)
        _close(g, w, 2e-6)
    _equal(tc.roundtrip(torch.as_tensor(bits)), bits)


@pytest.mark.parametrize("case", FSK, ids=FSK_IDS)
def test_fsk_rx(case):
    jc, tc, bps = _fsk(case)
    bits, i, q = _fsk_wave(jc, bps, 2, sigma=0.05)
    want = jc.rx(*_j(i, q))
    _equal(tc.rx(*_t(i, q)), want)
    assert np.mean(np.asarray(want) == bits) > 0.99


@pytest.mark.parametrize("case", FSK, ids=FSK_IDS)
def test_fsk_rx_soft(case):
    jc, tc, bps = _fsk(case)
    _, i, q = _fsk_wave(jc, bps, 3, sigma=0.1)
    _llr_close(tc.rx_soft(*_t(i, q), noise_var=0.01),
               jc.rx_soft(*_j(i, q), noise_var=0.01))


@pytest.mark.parametrize("case", FSK, ids=FSK_IDS)
def test_fsk_tx_fused(case):
    jc, tc, bps = _fsk(case)
    bits = _bits((3, 200 * bps), 4)
    got = tc.tx_fused(torch.as_tensor(bits))
    staged = tc.tx(torch.as_tensor(bits))
    for g, w, s in zip(got, jc.tx_fused(jnp.asarray(bits)), staged):
        _close(g, w, 2e-6)
        _close(g, s.numpy(), 2e-6)


@pytest.mark.parametrize("case", FSK, ids=FSK_IDS)
def test_fsk_rx_fused(case):
    jc, tc, bps = _fsk(case)
    bits = _bits((3, 200 * bps), 5)
    _equal(tc.rx_fused(*tc.tx_fused(torch.as_tensor(bits))), bits)
    _, i, q = _fsk_wave(jc, bps, 6, sigma=0.05)
    _equal(tc.rx_fused(*_t(i, q)), jc.rx_fused(*_j(i, q)))


@pytest.mark.parametrize("case", FSK, ids=FSK_IDS)
def test_fsk_rx_soft_fused(case):
    from modem_tpu_torch.ops.llr import llr_hard_bits

    jc, tc, bps = _fsk(case, guard=2)
    bits, i, q = _fsk_wave(jc, bps, 7, sigma=0.1)
    got = tc.rx_soft_fused(*_t(i, q), noise_var=0.01)
    _llr_close(got, jc.rx_soft_fused(*_j(i, q), noise_var=0.01))
    clean = tc.tx_fused(torch.as_tensor(bits))
    _equal(llr_hard_bits(tc.rx_soft_fused(*clean)), bits)


@pytest.mark.parametrize("case", FSK, ids=FSK_IDS)
def test_fsk_roundtrip_fused(case):
    jc, tc, bps = _fsk(case)
    bits = _bits((3, 600 * bps), 8)
    got = tc.roundtrip_fused(torch.as_tensor(bits))
    _equal(got, bits)
    _equal(got, jc.roundtrip_fused(jnp.asarray(bits)))


@pytest.mark.parametrize("case", FSK, ids=FSK_IDS)
def test_fsk_roundtrip_fused_noisy(case):
    """The same seeded in-kernel noise stream: bits equal on >= 99.9%."""
    jc, tc, bps = _fsk(case)
    bits = _bits((3, 600 * bps), 9)
    snr = 18.0 if bps == 4 else 8.0
    want = np.asarray(jc.roundtrip_fused(jnp.asarray(bits), snr_db=snr, seed=5))
    got = tc.roundtrip_fused(torch.as_tensor(bits), snr_db=snr, seed=5).numpy()
    assert np.mean(got == want) >= 0.999
    assert np.mean(want != bits) > 0


@pytest.mark.parametrize("guard", [0, 8])
def test_fsk_chain_guard_errors(guard):
    _, _, mt, coefs, dev = FSK[0]
    with pytest.raises(ValueError):
        FskChain(mt(), TR, coefs, dev, guard, device=CPU)


# ---- MskChain ----

@pytest.mark.parametrize("sps", [4, 8, 16])
def test_msk_staged(sps):
    jr, tr = JRates(SR // sps, SR), Rates(SR // sps, SR)
    jc, tc = jchain.MskChain(jr), MskChain(tr, device=CPU)
    bits = _bits((3, 2 * 150), sps)
    wave = tc.tx(torch.as_tensor(bits))
    for g, w in zip(wave, jc.tx(jnp.asarray(bits))):
        _close(g, w, 2e-6)
    _equal(tc.roundtrip(torch.as_tensor(bits)), bits)
    i, q = (np.asarray(v) + _noise(v.shape, 0.1, sps) for v in jc.tx(jnp.asarray(bits)))
    _equal(tc.rx(*_t(i, q)), jc.rx(*_j(i, q)))


def test_msk_slot_signs_and_decode():
    jc, tc = jchain.MskChain(JR), MskChain(TR, device=CPU)
    bits = _bits((2, 3, 2 * 40), 10)
    for g, w in zip(tc._slot_signs(torch.as_tensor(bits)),
                    jc._slot_signs(jnp.asarray(bits))):
        _equal(g, w)
    c_neg = _bits((2, 3, 80), 11)
    _equal(tc._decode_cneg(torch.as_tensor(c_neg)),
           jc._decode_cneg(jnp.asarray(c_neg)))


@pytest.mark.parametrize("sps", [8, 16])
def test_msk_tx_fused(sps):
    jc = jchain.MskChain(JRates(SR // sps, SR))
    tc = MskChain(Rates(SR // sps, SR), amplitude=1.0, device=CPU)
    bits = _bits((3, 2 * 200), 12)
    got = tc.tx_fused(torch.as_tensor(bits))
    for g, w, s in zip(got, jc.tx_fused(jnp.asarray(bits)),
                       tc.tx(torch.as_tensor(bits))):
        _close(g, w, 2e-6)
        _close(g, s.numpy(), 2e-6)


def test_msk_rx_fused():
    jc, tc = jchain.MskChain(JR), MskChain(TR, device=CPU)
    bits = _bits((3, 2 * 200), 13)
    _equal(tc.rx_fused(*tc.tx_fused(torch.as_tensor(bits))), bits)
    i, q = (np.asarray(v) + _noise(v.shape, 0.1, 14) for v in jc.tx(jnp.asarray(bits)))
    _equal(tc.rx_fused(*_t(i, q)), jc.rx_fused(*_j(i, q)))


@pytest.mark.parametrize("snr,seed", [(None, None), (7.0, 5), (5.0, -8)])
def test_msk_roundtrip_fused(snr, seed):
    """K7's plain version through ``MskChain``: the JAX method's bits, and
    with noise the same seeded stream (a slot error flips the prefix decode
    from there on, so bit errors come in runs)."""
    jc, tc = jchain.MskChain(JR), MskChain(TR, device=CPU)
    bits = _bits((3, 2 * 300), 15)
    want = jc.roundtrip_fused(jnp.asarray(bits), snr_db=snr, seed=seed)
    got = tc.roundtrip_fused(torch.as_tensor(bits), snr_db=snr, seed=seed)
    _equal(got, want)
    if snr is None:
        _equal(got, bits)
    else:
        assert np.mean(np.asarray(want) != bits) > 0


def test_msk_errors():
    with pytest.raises(ValueError, match="even"):
        MskChain(Rates(2000, SR), device=CPU)  # sps 5
    with pytest.raises(ValueError):
        MskChain(Rates(5000, SR), device=CPU)  # spb 1: no interior
    with pytest.raises(ValueError):
        MskChain(TR, guard=0, device=CPU)


# ---- GmskChain ----

@pytest.mark.parametrize("bt,sps,span", [(0.3, 8, 4), (0.5, 8, 4),
                                         (0.3, 4, 3), (0.25, 16, 5)])
def test_gmsk_pulse_equal(bt, sps, span):
    for g, w in zip(tgmsk.gmsk_pulse(bt, sps, span),
                    jgmsk.gmsk_pulse(bt, sps, span)):
        if isinstance(w, np.ndarray):
            assert g.dtype == np.float32
            np.testing.assert_array_equal(g, w)
        else:
            assert g == w


@pytest.mark.parametrize("bt", [0.3, 0.5])
def test_gmsk_tx_rx(bt):
    jc = jgmsk.GmskChain(JR, bt=bt)
    tc = GmskChain(TR, bt=bt, device=CPU)
    bits = _bits((3, 300), 15)
    wave = tc.tx(torch.as_tensor(bits))
    jwave = jc.tx(jnp.asarray(bits))
    for g, w in zip(wave, jwave):
        assert g.shape == (3, (300 + 4) * 8)
        _close(g, w, 1e-5)
    _equal(tc.roundtrip(torch.as_tensor(bits)), bits)
    i, q = (np.asarray(v) + _noise(v.shape, 0.2, 16) for v in jwave)
    _equal(tc.rx(*_t(i, q)), jc.rx(*_j(i, q)))
    _llr_close(tc.rx_soft(*_t(i, q), noise_var=0.3),
               jc.rx_soft(*_j(i, q), noise_var=0.3))


def test_gmsk_chunked_equals_one_shot():
    tc = GmskChain(TR, bt=0.3, device=CPU)
    bits = torch.as_tensor(_bits((2, 500), 17))
    i1, q1, s1 = tc.tx_stream(bits, tc.init_state((2,)))
    st, parts = tc.init_state((2,)), []
    for a, b in ((0, 7), (7, 260), (260, 500)):
        i, q, st = tc.tx_stream(bits[:, a:b], st)
        parts.append((i, q))
    assert torch.equal(torch.cat([p[0] for p in parts], -1), i1)
    assert torch.equal(torch.cat([p[1] for p in parts], -1), q1)
    for k in s1:
        assert torch.equal(st[k], s1[k])
    assert st["u"].dtype == torch.int32 and st["ubuf"].dtype == torch.int32


def test_gmsk_state_from_numpy_continues_a_jax_stream():
    jc = jgmsk.GmskChain(JR, bt=0.3)
    tc = GmskChain(TR, bt=0.3, device=CPU)
    bits = _bits((2, 400), 18)
    _, _, jst = jc.tx_stream(jnp.asarray(bits[:, :150]), jc.init_state((2,)))
    wi, wq, jend = jc.tx_stream(jnp.asarray(bits[:, 150:]), jst)
    st = GmskChain.state_from_numpy({k: np.array(v) for k, v in jst.items()},
                                    CPU)
    assert st["u"].dtype == torch.int32 and st["fir"].dtype == torch.float32
    gi, gq, tend = tc.tx_stream(torch.as_tensor(bits[:, 150:]), st)
    _close(gi, wi, 1e-5)
    _close(gq, wq, 1e-5)
    _equal(tend["u"], jend["u"])
    _equal(tend["ubuf"], jend["ubuf"])
    _close(tend["fir"], jend["fir"], 1e-6)


def test_gmsk_errors():
    with pytest.raises(ValueError):
        GmskChain(TR, guard=8, device=CPU)
    with pytest.raises(ValueError, match="span"):
        GmskChain(TR, span=1, device=CPU)
    tc = GmskChain(TR, device=CPU)
    with pytest.raises(ValueError, match="flush"):
        tc.rx(torch.zeros(2, 32), torch.zeros(2, 32))


# ---- OqpskChain, DcqpskChain ----

@pytest.mark.parametrize("name", ["oqpsk", "dcqpsk"])
@pytest.mark.parametrize("shape", [(256,), (3, 256)], ids=str)
def test_offset_and_parity_chains(name, shape):
    jcls, tcls = {"oqpsk": (jchain.OqpskChain, OqpskChain),
                  "dcqpsk": (jchain.DcqpskChain, DcqpskChain)}[name]
    jc, tc = jcls(JR), tcls(TR, device=CPU)
    bits = _bits(shape, 19)
    jwave = jc.tx(jnp.asarray(bits))
    for g, w in zip(tc.tx(torch.as_tensor(bits)), jwave):
        _close(g, w, 1e-6)
    _equal(tc.roundtrip(torch.as_tensor(bits)), bits)
    i, q = (np.asarray(v) + _noise(v.shape, 0.3, 20) for v in jwave)
    _equal(tc.rx(*_t(i, q)), jc.rx(*_j(i, q)))


@pytest.mark.parametrize("cls", [MskChain, OqpskChain, DcqpskChain])
def test_all_ones_and_zeros(cls):
    tc = cls(TR, device=CPU)
    for val in (0, 1):
        bits = torch.full((2, 64), val, dtype=torch.int32)
        assert torch.equal(tc.roundtrip(bits), bits)


def test_oqpsk_rejects_odd_sps():
    with pytest.raises(ValueError, match="even"):
        OqpskChain(Rates(2000, SR), device=CPU)


# ---- DifferentialChain ----

DIFF = ["dbpsk", "dqpsk"]


def _diff(name, polyphase=False):
    return (jchain.DifferentialChain(jmake(name, JR), JR, polyphase=polyphase),
            DifferentialChain(make_scheme(name, TR), TR, polyphase=polyphase,
                              device=CPU))


@pytest.mark.parametrize("name", DIFF)
def test_differential_tables_equal(name):
    jc, tc = _diff(name)
    m_j, lut_j = jc._acc_constellation()
    m_t, lut_t = tc._acc_constellation()
    assert m_t == m_j
    np.testing.assert_array_equal(lut_t.numpy(), lut_j)
    np.testing.assert_array_equal(tc.rrc.numpy(), np.asarray(jc.rrc, np.float32))


@pytest.mark.parametrize("name", DIFF)
@pytest.mark.parametrize("polyphase", [False, True])
def test_differential_staged(name, polyphase):
    jc, tc = _diff(name, polyphase)
    bps = jc.scheme.bits_per_symbol
    bits = _bits((3, 300 * bps), 21)
    jwave = jc.tx(jnp.asarray(bits))
    for g, w in zip(tc.tx(torch.as_tensor(bits)), jwave):
        _close(g, w, 1e-5)
    _equal(tc.roundtrip(torch.as_tensor(bits)), bits)
    i, q = (np.asarray(v) + _noise(v.shape, 0.15, 22) for v in jwave)
    _equal(tc.rx(_t(i, q), 300), jc.rx(_j(i, q), 300))
    _llr_close(tc.rx_soft(_t(i, q), 300, noise_var=0.1),
               jc.rx_soft(_j(i, q), 300, noise_var=0.1))


@pytest.mark.parametrize("name", DIFF)
def test_differential_fused(name):
    jc, tc = _diff(name)
    bps = jc.scheme.bits_per_symbol
    bits = _bits((3, 300 * bps), 23)
    tb = torch.as_tensor(bits)
    wave = tc.tx_fused(tb)
    for g, w, s in zip(wave, jc.tx_fused(jnp.asarray(bits)), tc.tx(tb)):
        _close(g, w, 1e-5)
        _close(g, s.numpy(), 1e-5)
    _equal(tc.rx_fused(wave, 300), bits)
    _equal(tc.roundtrip_fused(tb), bits)
    _equal(tc.roundtrip_fused(tb), jc.roundtrip_fused(jnp.asarray(bits)))
    i, q = (np.asarray(v) + _noise(v.shape, 0.15, 24)
            for v in jc.tx(jnp.asarray(bits)))
    _equal(tc.rx_fused(_t(i, q), 300), jc.rx_fused(_j(i, q), 300))
    _llr_close(tc.rx_soft_fused(_t(i, q), 300, noise_var=0.1),
               jc.rx_soft_fused(_j(i, q), 300, noise_var=0.1))


def test_differential_noisy_loopback_not_ported():
    """K1's noise behind ``roundtrip_fused(snr_db, seed)``, once missing:
    the seed reaches the stream (two seeds differ, equal seeds agree) and
    the decisions equal the JAX chain's on the same seed."""
    jc, tc = _diff("dqpsk")
    bits = np.random.default_rng(7).integers(0, 2, (4, 600)).astype(np.int32)
    tb = torch.as_tensor(bits)
    a = tc.roundtrip_fused(tb, snr_db=6.0, seed=1)
    assert torch.equal(a, tc.roundtrip_fused(tb, snr_db=6.0, seed=1))
    assert not torch.equal(a, tc.roundtrip_fused(tb, snr_db=6.0, seed=2))
    assert 0 < int((a != tb).sum()) < bits.size // 10
    _equal(a, jc.roundtrip_fused(jnp.asarray(bits), snr_db=6.0, seed=1))


def test_differential_rrc_override_and_type():
    jc, _ = _diff("dqpsk")
    tc = DifferentialChain(make_scheme("dqpsk", TR), TR, device=CPU,
                           rrc=np.asarray(jc.rrc) * 2)
    np.testing.assert_array_equal(tc.rrc.numpy(), np.asarray(jc.rrc, np.float32) * 2)
    with pytest.raises(ValueError, match="span"):
        DifferentialChain(make_scheme("dqpsk", TR), TR, device=CPU,
                          rrc=np.ones(5))
    with pytest.raises(TypeError):
        DifferentialChain(make_scheme("qpsk", TR), TR, device=CPU)


# ---- the device default ----

@pytest.mark.parametrize("make", [
    lambda d: FskChain(make_scheme("mfsk", TR), TR, 2 * np.arange(16),
                       TWO_PI * 50 / SR, device=d),
    lambda d: MskChain(TR, device=d),
    lambda d: GmskChain(TR, device=d),
    lambda d: OqpskChain(TR, device=d),
    lambda d: DcqpskChain(TR, device=d),
    lambda d: DifferentialChain(make_scheme("dqpsk", TR), TR, device=d),
], ids=["fsk", "msk", "gmsk", "oqpsk", "dcqpsk", "differential"])
def test_device_none_is_the_card(make):
    if torch.cuda.is_available():
        chain = make(None)
        assert getattr(chain, "device", None) or chain.rrc.device
        assert (getattr(chain, "device", None) or chain.rrc.device).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            make(None)
    make(CPU)
