"""Config #4, the QAM chain with a rational resampler in it: the port's
``ops/resample.py``, ``resampled.py`` and the plain versions of kernels K11
and K12 (``ops/resampled_kernel.py``) vs the JAX package on the same numpy
inputs (``modem_tpu.ops.pallas_resampled`` in interpret mode, as
``tests/test_resampled_chain.py`` runs it).

Tolerances: filter taps, tables and delays exactly; ``rational_resample``
``atol=1e-6`` (sums in another order); staged ``tx`` ``atol=1e-6``;
decisions and bits exactly; staged ``rx_soft`` LLRs ``1e-4`` relative to
their largest; K11's plain version ``1e-6`` and K12's soft points ``1e-5``
(the JAX kernels sum their weights in another order).
"""

import math

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from modem_tpu.config import Rates as JRates
from modem_tpu.models.qam import QAM as JQAM
from modem_tpu.ops import pallas_resampled as jpr
from modem_tpu.ops import resample as jrs
from modem_tpu import resampled as jres

from modem_tpu_torch import Rates, ResampledChain, StreamingResampledChain
from modem_tpu_torch import resampled as tres
from modem_tpu_torch.models.qam import QAM
from modem_tpu_torch.ops import resample as trs
from modem_tpu_torch.ops import resampled_kernel as rk
from modem_tpu_torch.ops.llr import llr_hard_bits

torch.set_num_threads(1)

JR, TR = JRates(1250, 10000), Rates(1250, 10000)  # sps 8
CPU = "cpu"
N_SYM = 120
# (up, down, bits per symbol): P = 1 and P = 3 (2/3), 64-QAM once
CHAINS = [(3, 2, 4), (2, 3, 4), (5, 4, 4), (3, 2, 6)]
CHAIN_IDS = [f"{u}_{d}_qam{1 << b}" for u, d, b in CHAINS]


def _bits(shape, seed):
    return np.random.default_rng(seed).integers(0, 2, shape).astype(np.int32)


def _close(got, want, atol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol, rtol=0)


def _equal(got, want):
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.fixture(scope="module")
def chains():
    """Per case: the JAX chain, the port's chain, bits, the JAX staged
    waveform with a little noise, and the JAX fused outputs on them (the
    interpret-mode kernels run once per case)."""
    out = {}
    for (up, down, bps), cid in zip(CHAINS, CHAIN_IDS):
        jc = jres.ResampledChain(JQAM(bps, 0.0, 1.0), JR, up, down)
        tc = ResampledChain(QAM(bps, 0.0, 1.0), TR, up, down, device=CPU)
        bits = _bits((2, N_SYM * bps), up * 10 + down + bps)
        wi, wq = (np.asarray(v) for v in jc.tx(jnp.asarray(bits)))
        rng = np.random.default_rng(bps)
        wi = wi + rng.normal(0, 0.02, wi.shape).astype(np.float32)
        wq = wq + rng.normal(0, 0.02, wq.shape).astype(np.float32)
        jw = (jnp.asarray(wi), jnp.asarray(wq))
        syms = np.array(jc.map_symbols(jnp.asarray(bits)))
        syms[0, :5] = -1  # the streaming sentinel: zero I/Q
        args = (jc.lut, np.asarray(jc.rrc), jc.sps, jc.span, jc.up, jc.down)
        out[cid] = dict(
            jc=jc, tc=tc, bits=bits, wave=(wi, wq), syms=syms,
            tx=jpr.fused_resampled_tx(jnp.asarray(syms), *args, jc.taps1,
                                      jc._padded_len(N_SYM)),
            rx=jpr.fused_resampled_rx(jw, N_SYM, *args, jc.taps2, jc.delay),
            soft=jpr.fused_resampled_rx(jw, N_SYM, *args, jc.taps2, jc.delay,
                                        soft=True))
    return out


# ---- ops/resample.py ----

@pytest.mark.parametrize("up,down,tpp", [(3, 2, 16), (2, 3, 16), (5, 4, 8),
                                         (1, 1, 16), (7, 3, 10)])
def test_resample_taps_equal(up, down, tpp):
    assert np.array_equal(trs.resample_taps(up, down, tpp),
                          jrs.resample_taps(up, down, tpp))
    assert (trs.resample_state_len(jrs.resample_taps(up, down, tpp), up, down)
            == jrs.resample_state_len(jrs.resample_taps(up, down, tpp), up,
                                      down))


def test_design_lowpass_equal_and_cutoff_error():
    assert np.array_equal(trs.design_lowpass(33, 0.4, 6.0),
                          jrs.design_lowpass(33, 0.4, 6.0))
    with pytest.raises(ValueError, match="cutoff"):
        trs.design_lowpass(16, 1.5)


@pytest.mark.parametrize("up,down", [(3, 2), (2, 3), (5, 4), (2, 1), (1, 2),
                                     (1, 1)])
@pytest.mark.parametrize("with_state", [False, True])
def test_rational_resample(up, down, with_state):
    rng = np.random.default_rng(up * 7 + down)
    n = 48 * down
    x = rng.normal(size=(2, n)).astype(np.float32)
    taps = jrs.resample_taps(up, down, 8)
    kp = jrs.resample_state_len(taps, up, down)
    st = rng.normal(size=(2, kp)).astype(np.float32) if with_state else None
    want, wst = jrs.rational_resample(
        jnp.asarray(x), up, down, taps,
        state=None if st is None else jnp.asarray(st))
    got, gst = trs.rational_resample(
        torch.as_tensor(x), up, down, taps,
        state=None if st is None else torch.as_tensor(st))
    assert got.shape == (2, n * up // down)
    _close(got, want, 1e-6)
    _close(gst, wst, 0.0)


def test_rational_resample_stream_equals_one_shot():
    x = torch.as_tensor(np.random.default_rng(3).normal(size=(2, 96))
                        .astype(np.float32))
    one, _ = trs.rational_resample(x, 3, 2)
    parts, st = [], None
    for a, b in ((0, 10), (10, 12), (12, 60), (60, 96)):
        y, st = trs.rational_resample(x[:, a:b], 3, 2, state=st)
        parts.append(y)
    assert torch.equal(torch.cat(parts, -1), one)


def test_rational_resample_errors():
    x = torch.zeros(2, 7)
    with pytest.raises(ValueError, match="divide"):
        trs.rational_resample(x, 3, 2)
    with pytest.raises(ValueError, match="state"):
        trs.rational_resample(torch.zeros(2, 8), 3, 2, state=torch.zeros(2, 3))


# ---- the chain's construction ----

@pytest.mark.parametrize("up,down", [(3, 2), (2, 3), (5, 4), (4, 5), (7, 3),
                                     (2, 1), (1, 2)])
def test_stage2_taps_and_delays_equal(up, down):
    assert tres._solve_stage2_taps(up, down, 16) == jres._solve_stage2_taps(
        up, down, 16)
    jc = jres.ResampledChain(JQAM(4, 0.0, 1.0), JR, up, down)
    tc = ResampledChain(QAM(4, 0.0, 1.0), TR, up, down, device=CPU)
    for name in ("rrc", "lut", "taps1", "taps2"):
        assert np.array_equal(getattr(tc, name).numpy(),
                              np.asarray(getattr(jc, name))), name
    assert (tc.up, tc.down, tc.resample_delay, tc.delay) == (
        jc.up, jc.down, jc.resample_delay, jc.delay)
    for k in (1, 37, 4096):
        assert tc._padded_len(k) == jc._padded_len(k)


def test_stage2_solver_error_and_gcd():
    with pytest.raises(ValueError, match="integer-delay"):
        tres._solve_stage2_taps(3, 2, 15)
    tc = ResampledChain(QAM(4, 0.0, 1.0), TR, 6, 4, device=CPU)
    assert (tc.up, tc.down) == (3, 2)
    with pytest.raises(TypeError):
        ResampledChain(object(), TR, 3, 2, device=CPU)


def test_config4_geometry():
    """The benchmark row's chain: sps 8, 65 RRC taps, 48 + 32 resampler
    taps, delays 13 and 77, 32,838 modem samples for 4096 symbols."""
    tc = ResampledChain(QAM(4, 0.0, 1.0), TR, 3, 2, device=CPU)
    assert (tc.sps, len(tc.rrc), len(tc.taps1), len(tc.taps2)) == (8, 65, 48, 32)
    assert (tc.resample_delay, tc.delay) == (13, 77)
    assert tc._padded_len(4096) == 32838
    assert tc._padded_len(4096) * 3 // 2 == 49257


def test_device_none_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        ResampledChain(QAM(4, 0.0, 1.0), TR, 3, 2)


# ---- the staged chain ----

@pytest.mark.parametrize("cid", CHAIN_IDS)
def test_staged_tx(chains, cid):
    c = chains[cid]
    got = c["tc"].tx(torch.as_tensor(c["bits"]))
    for g, w in zip(got, c["jc"].tx(jnp.asarray(c["bits"]))):
        assert g.shape == w.shape and g.dtype == torch.float32
        _close(g, w, 1e-6)


@pytest.mark.parametrize("cid", CHAIN_IDS)
def test_staged_rx(chains, cid):
    c = chains[cid]
    wave = tuple(torch.as_tensor(v) for v in c["wave"])
    jw = tuple(jnp.asarray(v) for v in c["wave"])
    _equal(c["tc"].rx(wave, N_SYM), c["jc"].rx(jw, N_SYM))
    _equal(c["tc"].rx(wave, N_SYM), c["bits"])


@pytest.mark.parametrize("cid", CHAIN_IDS[1:3])
def test_staged_rx_soft(chains, cid):
    c = chains[cid]
    wave = tuple(torch.as_tensor(v) for v in c["wave"])
    jw = tuple(jnp.asarray(v) for v in c["wave"])
    want = np.asarray(c["jc"].rx_soft(jw, N_SYM, noise_var=0.05))
    got = c["tc"].rx_soft(wave, N_SYM, noise_var=0.05)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("cid", CHAIN_IDS[:2])
def test_staged_roundtrip_and_ber(chains, cid):
    c = chains[cid]
    bits = torch.as_tensor(c["bits"])
    _equal(c["tc"].roundtrip(bits), c["bits"])
    g = torch.Generator().manual_seed(0)
    assert float(c["tc"].ber(bits, 40.0, g)) == 0.0
    g = torch.Generator().manual_seed(0)
    assert 0.0 < float(c["tc"].ber(bits, 3.0, g)) < 0.5


# ---- K11 and K12: the plain versions vs the JAX kernels ----

@pytest.mark.parametrize("cid", CHAIN_IDS)
def test_fused_tx_plain_matches_jax(chains, cid):
    c = chains[cid]
    jc = c["jc"]
    got = rk.fused_resampled_tx(
        torch.as_tensor(c["syms"]), c["tc"].lut, np.asarray(jc.rrc), jc.sps,
        jc.span, jc.up, jc.down, jc.taps1, jc._padded_len(N_SYM))
    for g, w in zip(got, c["tx"]):
        assert g.shape == w.shape == (2, jc._padded_len(N_SYM) * jc.up // jc.down)
        _close(g, w, 1e-6)


@pytest.mark.parametrize("cid", CHAIN_IDS)
def test_fused_rx_plain_matches_jax(chains, cid):
    c = chains[cid]
    jc = c["jc"]
    wave = tuple(torch.as_tensor(v) for v in c["wave"])
    args = (N_SYM, c["tc"].lut, np.asarray(jc.rrc), jc.sps, jc.span, jc.up,
            jc.down, jc.taps2, jc.delay)
    _equal(rk.fused_resampled_rx(wave, *args), c["rx"])
    for g, w in zip(rk.fused_resampled_rx(wave, *args, soft=True), c["soft"]):
        _close(g, w, 1e-5)


@pytest.mark.parametrize("cid", CHAIN_IDS)
def test_fused_methods(chains, cid):
    """tx_fused equals the staged tx to f32 reassociation; rx_fused,
    rx_soft_fused and roundtrip_fused give the staged decisions."""
    c = chains[cid]
    tc, bits = c["tc"], torch.as_tensor(c["bits"])
    wave = tc.tx_fused(bits)
    for f, s in zip(wave, tc.tx(bits)):
        _close(f, s.numpy(), 1e-6)
    _equal(tc.rx_fused(wave, N_SYM), c["bits"])
    _equal(llr_hard_bits(tc.rx_soft_fused(wave, N_SYM)), c["bits"])
    _equal(tc.roundtrip_fused(bits), c["bits"])
    noisy = tuple(torch.as_tensor(v) for v in c["wave"])
    _equal(tc.rx_fused(noisy, N_SYM), tc.rx(noisy, N_SYM))


def test_tables_are_the_jax_weights():
    """The dense tables hold exactly the JAX helpers' weights."""
    h1 = jres.ResampledChain(JQAM(4, 0.0, 1.0), JR, 3, 2).taps1
    wts = jpr._stage_weights(h1, 3, 2, 15)
    table, lo = rk._dense_table(rk._stage_weights(h1, 3, 2, 15), 2)
    for r, rows in wts.items():
        for q, row in rows.items():
            for i in np.flatnonzero(row):
                assert table[r, q * 2 + i - lo] == row[i]
    assert np.count_nonzero(table) == sum(
        np.count_nonzero(row) for rows in wts.values() for row in rows.values())
    jc = jres.ResampledChain(JQAM(4, 0.0, 1.0), JR, 2, 3)
    taps = tuple(float(v) for v in np.asarray(jc.rrc))
    h2 = tuple(float(v) for v in jc.taps2)
    want = jpr._composite_rx_weights(taps, h2, 8, 2, 3, jc.delay, 10)
    got = rk._composite_rx_weights(taps, h2, 8, 2, 3, jc.delay, 10)
    assert want[:2] == got[:2] == (3, 16)
    for rho in range(3):
        assert want[2][rho].keys() == got[2][rho].keys()
        for q in want[2][rho]:
            assert np.array_equal(want[2][rho][q], got[2][rho][q])


def test_ptv_stage_is_the_direct_sum():
    """out[m] = sum_o table[m % P, o] * x[(m//P)*S + first + o], x zero
    outside, against a direct loop."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 50)).astype(np.float32)
    table = rng.normal(size=(3, 7)).astype(np.float32)
    got = rk.ptv_stage(torch.as_tensor(x), torch.as_tensor(table), 3, 5, -4, 31)
    want = np.zeros((2, 31))
    for m in range(31):
        for o in range(7):
            s = (m // 3) * 5 - 4 + o
            if 0 <= s < 50:
                want[:, m] += table[m % 3, o] * x[:, s]
    _close(got, want, 1e-5)
    assert rk.ptv_stage(torch.as_tensor(x), torch.as_tensor(table), 3, 5, 0,
                        0).shape == (2, 0)


def test_fused_wrapper_errors():
    tc = ResampledChain(QAM(4, 0.0, 1.0), TR, 3, 2, device=CPU)
    syms = torch.zeros(2, 10, dtype=torch.int32)
    rrc, t1, t2 = (tc._host[k] for k in ("rrc", "taps1", "taps2"))
    with pytest.raises(ValueError, match="span"):
        rk.fused_resampled_tx(syms, tc.lut, rrc[:-1], 8, 8, 3, 2, t1, 200)
    with pytest.raises(ValueError, match="divide"):
        rk.fused_resampled_tx(syms, tc.lut, rrc, 8, 8, 3, 2, t1, 201)
    with pytest.raises(ValueError, match="64"):
        rk.fused_resampled_tx(syms, torch.zeros(128, 2), rrc, 8, 8, 3, 2, t1,
                              200)
    wave = (torch.zeros(2, 300), torch.zeros(2, 300))
    with pytest.raises(ValueError, match="delay"):
        rk.fused_resampled_rx(wave, 10, tc.lut, rrc, 8, 8, 3, 2, t2, 63)
    with pytest.raises(ValueError, match="reach"):
        rk.fused_resampled_rx(wave, 30, tc.lut, rrc, 8, 8, 3, 2, t2, 77)
    with pytest.raises(ValueError, match="differ"):
        rk.fused_resampled_rx((wave[0], wave[1][:, :10]), 10, tc.lut, rrc, 8,
                              8, 3, 2, t2, 77)


# ---- streaming and from_numpy ----

@pytest.mark.parametrize("cid", CHAIN_IDS[:2])
def test_streaming_ragged_equals_jax_one_shot(chains, cid):
    c = chains[cid]
    bps = c["tc"].bits_per_symbol
    want = np.asarray(c["jc"].roundtrip(jnp.asarray(c["bits"])))
    st = StreamingResampledChain(c["tc"], batch_shape=(2,))
    outs, start = [], 0
    for blk in (7, 1, 30, 19, 25, 38):  # ragged split of 120 symbols
        outs.append(st.push(torch.as_tensor(
            c["bits"][:, start * bps:(start + blk) * bps])))
        start += blk
    assert start == N_SYM
    outs.append(st.flush())
    assert sum(o.shape[-1] for o in outs[:-1]) > 0  # emits before the flush
    _equal(torch.cat(outs, dim=-1), want)
    with pytest.raises(RuntimeError):
        st.push(torch.as_tensor(c["bits"][:, :bps]))
    with pytest.raises(ValueError, match="batch"):
        StreamingResampledChain(c["tc"], (2,)).push(torch.zeros(3, bps,
                                                                dtype=torch.int32))


def test_from_numpy_computes_what_the_jax_chain_computes(chains):
    c = chains[CHAIN_IDS[1]]
    jc = c["jc"]
    params = {"lut": np.asarray(jc.lut), "rrc": np.asarray(jc.rrc),
              "taps1": jc.taps1, "taps2": jc.taps2,
              "bits_per_symbol": jc.scheme.bits_per_symbol}
    tc = ResampledChain.from_numpy(params, TR, jc.up, jc.down, device=CPU)
    assert tc.delay == jc.delay
    bits = torch.as_tensor(c["bits"])
    for g, w in zip(tc.tx(bits), jc.tx(jnp.asarray(c["bits"]))):
        _close(g, w, 1e-6)
    wave = tuple(torch.as_tensor(v) for v in c["wave"])
    _equal(tc.rx_fused(wave, N_SYM), jc.rx(tuple(jnp.asarray(v)
                                                 for v in c["wave"]), N_SYM))
    with pytest.raises(ValueError, match="span"):
        ResampledChain.from_numpy(dict(params, rrc=params["rrc"][:-1]), TR,
                                  jc.up, jc.down, device=CPU)
    with pytest.raises(ValueError, match="integer"):
        ResampledChain.from_numpy(dict(params, taps2=params["taps2"][:-1]),
                                  TR, jc.up, jc.down, device=CPU)
