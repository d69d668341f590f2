"""Blind single-carrier burst acquisition in the port (``modem_tpu_torch``:
``ops/impairments.py``, ``ops/agc.py``, ``ops/equalizer.py``, ``sync.py``
with ``AcquiringReceiver``) against the JAX package on the same numpy
inputs, on the CPU (where the FIR channels and the matched filter take
K4's plain version). The cases mirror ``tests/test_sync.py``,
``tests/test_agc_track.py``, ``tests/test_sfo_track.py`` and
``tests/test_phase_track.py``, the sharded acquisition left out.

Tolerances: impairments, AGC, equalizer and trackers within 1e-5 of the
output's largest magnitude (the trackers' and long streams' corrected
points 1e-4: a decision feedback or a fit carries rounding across blocks);
the gathers that replace the JAX package's one-hot selections (the
decision instants' lane, ``varying_delay``'s integer shift, the piecewise
fits) bit for bit; estimators as ``chip_smoke.py`` phase 42 holds the
card: timing within 1e-3 samples (circular), CFO within 1e-5 rad/symbol,
phase within 1e-4 rad, gain within 1e-4 relative; frame lags and ``rx``
bits exactly. Each JAX receiver run is made once, in a module fixture.
"""

import math

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from modem_tpu import Rates as JRates
from modem_tpu import qpsk_reference_chain as jchain_of
from modem_tpu import sync as js
from modem_tpu.ops import agc as jagc
from modem_tpu.ops import equalizer as jeq
from modem_tpu.ops import impairments as jimp
from modem_tpu.ops.slicer import lut_slice as j_slice
from modem_tpu.ops.sync_metric import aligned_frame_matmul as j_aligned
from modem_tpu.utils.bits import unpack_symbols as j_unpack

from modem_tpu_torch import (AcquiringReceiver, PulseShapedChain, Rates,
                             make_scheme, qpsk_reference_chain)
from modem_tpu_torch import sync as ts
from modem_tpu_torch.ops import agc as tagc
from modem_tpu_torch.ops import equalizer as teq
from modem_tpu_torch.ops import impairments as timp

torch.set_num_threads(1)

CPU = "cpu"
SPS = 8
PRE = np.array([0, 1, 3, 2, 2, 0, 1, 1, 3, 0, 2, 3, 0, 0, 1, 2,
                3, 3, 1, 0, 2, 1, 0, 2, 1, 3, 2, 2, 0, 3, 1, 0])
TOL = 1e-5
TRACK_TOL = 1e-4
# test_sync.py's 3-ray channel (TestEqualizer) and the milder echo
# (test_tracking_fixes_residual_cfo_drift)
HI3 = np.array([1, 0, 0, 0, 0.3, 0, 0, 0, 0, 0, 0, 0, 0.45], np.float32)
HQ3 = np.array([0, 0, 0, 0, -0.2, 0, 0, 0, 0, 0, 0, 0, 0.25], np.float32)
HI13 = np.zeros(13, np.float32)
HQ13 = np.zeros(13, np.float32)
HI13[0], HI13[12], HQ13[12] = 1.0, 0.35, 0.175


def _t(a):
    return torch.tensor(np.asarray(a))


def _j(a):
    return jnp.asarray(np.asarray(a))


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.max(np.abs(want))), 1.0) if want.size else 1.0
    np.testing.assert_allclose(got, want, atol=tol * scale, rtol=0)


def _equal(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.array_equal(got, want)


def _circ(a, b, period):
    d = np.mod(np.asarray(a, np.float64) - np.asarray(b, np.float64), period)
    return np.minimum(d, period - d)


def _noisy(rng, i, q, sigma):
    return ((np.asarray(i) + sigma * rng.standard_normal(np.shape(i))
             ).astype(np.float32),
            (np.asarray(q) + sigma * rng.standard_normal(np.shape(q))
             ).astype(np.float32))


def _gauss(rng, shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


# ---------------------------------------------------------------------------
# Impairments
# ---------------------------------------------------------------------------

IMPAIRMENTS = {
    "cfo": lambda m, i, q: m.apply_cfo(i, q, 37.0, 10000, phase0=0.9),
    "cfo_n0": lambda m, i, q: m.apply_cfo(i, q, -11.5, 10000, phase0=0.3,
                                          n0=123457),
    "gain_phase": lambda m, i, q: m.apply_gain_phase(i, q, 0.8, 0.6),
    "multipath_4": lambda m, i, q: m.multipath_fir(
        i, q, np.array([1.0, 0, 0, 0.1], np.float32),
        np.array([0.0, 0, 0, 0.05], np.float32)),
    "multipath_13": lambda m, i, q: m.multipath_fir(i, q, HI13, HQ13),
    "static_delay_63": lambda m, i, q: m.apply_static_delay(i, q, 0.37),
    "static_delay_31": lambda m, i, q: m.apply_static_delay(i, q, 0.8, 31),
    "farrow": lambda m, i, q: (m.farrow_delay(i, 0.62),
                               m.farrow_delay(q, 0.13)),
    "doppler": lambda m, i, q: m.doppler_multipath(
        i, q, np.array([0.9, 0.0, 0.3], np.float32),
        np.array([0.0, 0.2, -0.1], np.float32),
        np.array([11.0, -7.0, 23.0]), 10000, n0=392),
}


@pytest.mark.parametrize("name", sorted(IMPAIRMENTS))
def test_impairment_equals_jax(name):
    rng = np.random.default_rng(sorted(IMPAIRMENTS).index(name))
    i, q = _gauss(rng, (3, 517)), _gauss(rng, (3, 517))
    fn = IMPAIRMENTS[name]
    got = fn(timp, _t(i), _t(q))
    want = fn(jimp, _j(i), _j(q))
    for g, w in zip(got, want):
        _close(g, w)


def test_per_channel_cfo_and_delay_equal_jax():
    rng = np.random.default_rng(7)
    i, q = _gauss(rng, (3, 300)), _gauss(rng, (3, 300))
    cfo = np.array([[5.0], [-20.0], [33.0]], np.float32)
    ph = np.array([[0.1], [1.2], [-2.0]], np.float32)
    mu = np.array([[0.1], [0.5], [0.93]], np.float32)
    for g, w in zip(timp.apply_cfo(_t(i), _t(q), _t(cfo), 10000, _t(ph)),
                    jimp.apply_cfo(_j(i), _j(q), _j(cfo), 10000, _j(ph))):
        _close(g, w)
    _close(timp.farrow_delay(_t(i), _t(mu)), jimp.farrow_delay(_j(i), _j(mu)))


@pytest.mark.parametrize("fn", ["cfo", "doppler"])
def test_n0_continuity(fn):
    """A block split in two with ``n0`` at the cut continues the one-shot
    output (the Doppler model's delay line fed a short overlap)."""
    rng = np.random.default_rng(2)
    i, q = _t(_gauss(rng, (800,))), _t(_gauss(rng, (800,)))
    hi = np.array([0.9, 0.0, 0.3], np.float32)
    hq = np.array([0.0, 0.2, -0.1], np.float32)
    fd = np.array([11.0, -7.0, 23.0])
    if fn == "cfo":
        one = timp.apply_cfo(i, q, 37.0, 10000)
        two = timp.apply_cfo(i[392:], q[392:], 37.0, 10000, n0=392)
    else:
        one = timp.doppler_multipath(i, q, hi, hq, fd, 10000)
        two = timp.doppler_multipath(i[392:], q[392:], hi, hq, fd, 10000,
                                     n0=392)
    for a, b in zip(one, two):
        _close(b[8:], a[400:])


def test_impairment_checks():
    assert np.array_equal(timp.sinc_delay_taps(0.37),
                          jimp.sinc_delay_taps(0.37))
    with pytest.raises(ValueError, match="odd"):
        timp.sinc_delay_taps(0.2, 64)
    x = torch.zeros(10)
    with pytest.raises(ValueError, match="equal length"):
        timp.doppler_multipath(x, x, np.ones(2), np.ones(2), np.ones(3),
                               10000)


# ---------------------------------------------------------------------------
# AGC
# ---------------------------------------------------------------------------

def test_normalize_rms_equals_jax():
    rng = np.random.default_rng(0)
    i, q = _gauss(rng, (2, 4096), 3.7), _gauss(rng, (2, 4096), 3.7)
    for g, w in zip(tagc.normalize_rms(_t(i), _t(q)),
                    jagc.normalize_rms(_j(i), _j(q))):
        _close(g, w)


@pytest.mark.parametrize("case", ["cold_start", "gain_step", "channels"])
def test_agc_equals_jax(case):
    rng = np.random.default_rng(3)
    if case == "cold_start":
        kw, x = {"loop_gain": 0.25}, [_gauss(rng, (2, 64 * 60), 0.1)]
    elif case == "gain_step":
        kw = {"loop_gain": 0.3}
        x = [_gauss(rng, (2, 64 * 40)), _gauss(rng, (2, 64 * 40), 8.0)]
    else:
        kw = {"loop_gain": 0.3}
        a = _gauss(rng, (2, 64 * 50))
        a[0] *= 0.2
        a[1] *= 5.0
        x = [a]
    t_agc, j_agc = tagc.Agc(**kw), jagc.Agc(**kw)
    ts_, js_ = t_agc.init_state((2,), device=CPU), j_agc.init_state((2,))
    for a in x:
        (ti, tq), ts_ = t_agc.process(_t(a), _t(a[::-1].copy()), ts_)
        (ji, jq), js_ = j_agc.process(_j(a), _j(a[::-1].copy()), js_)
        _close(ti, ji)
        _close(tq, jq)
        _close(ts_, js_)
    tail = (ti[:, -512:] ** 2 + tq[:, -512:] ** 2).mean(-1).sqrt()
    assert torch.all((tail - 1.0).abs() < 0.06)


def test_agc_pushes_equal_one_shot():
    agc = tagc.Agc(loop_gain=0.2, sub_block=32)
    rng = np.random.default_rng(4)
    i, q = _t(_gauss(rng, (3, 32 * 24), 0.5)), _t(_gauss(rng, (3, 32 * 24)))
    (one_i, one_q), one_st = agc.process(i, q, agc.init_state((3,), CPU))
    st, parts = agc.init_state((3,), CPU), []
    for a, b in ((0, 32), (32, 32 * 7), (32 * 7, 32 * 8), (32 * 8, 32 * 24)):
        (ci, cq), st = agc.process(i[:, a:b], q[:, a:b], st)
        parts.append((ci, cq))
    assert torch.equal(torch.cat([p[0] for p in parts], -1), one_i)
    assert torch.equal(torch.cat([p[1] for p in parts], -1), one_q)
    assert torch.equal(st, one_st)


def test_agc_checks_and_device():
    with pytest.raises(ValueError, match="loop_gain"):
        tagc.Agc(loop_gain=0.0)
    agc = tagc.Agc(sub_block=64)
    x = torch.zeros(100)
    with pytest.raises(ValueError, match="divide"):
        agc.process(x, x, agc.init_state(device=CPU))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            agc.init_state()


# ---------------------------------------------------------------------------
# Equalizer
# ---------------------------------------------------------------------------

def _isi_points(seed=11, n=256):
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 4, n)
    a = np.stack([np.cos(2 * np.pi * k / 4 + np.pi / 4),
                  np.sin(2 * np.pi * k / 4 + np.pi / 4)], -1)
    di = (a[:, 0] + 0.3 * np.roll(a[:, 0], 1)
          - 0.15 * np.roll(a[:, 1], 1)).astype(np.float32)
    dq = (a[:, 1] + 0.3 * np.roll(a[:, 1], 1)
          + 0.15 * np.roll(a[:, 0], 1)).astype(np.float32)
    return a.astype(np.float32), di, dq


def test_symbol_windows_equal_jax():
    d = np.arange(1, 41, dtype=np.float32).reshape(2, 20)
    for taps in (1, 4, 7):
        _equal(teq.symbol_windows(_t(d), taps),
               jeq.symbol_windows(_j(d), taps))


@pytest.mark.parametrize("batch", [False, True])
def test_equalizer_equals_jax(batch):
    a, di, dq = _isi_points()
    if batch:
        di = np.stack([di, 0.7 * di[::-1]])
        dq = np.stack([dq, 0.7 * dq[::-1]])
    tw = teq.train_lmmse(_t(di), _t(dq), a, 7, ridge=1e-4)
    jw = jeq.train_lmmse(_j(di), _j(dq), a, 7, ridge=1e-4)
    for g, w in zip(tw, jw):
        _close(g, w, 1e-4)
    ty = teq.apply_equalizer(_t(di), _t(dq), *tw)
    jy = jeq.apply_equalizer(_j(di), _j(dq), *jw)
    for g, w in zip(ty, jy):
        _close(g, w, 1e-4)
    if not batch:
        assert float((ty[0][4:250] - torch.as_tensor(a[4:250, 0])).abs()
                     .max()) < 0.05


# ---------------------------------------------------------------------------
# Estimators
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def burst():
    """A clean 2-channel burst of 256 payload symbols from the JAX chain
    and the same from the port's, with the bits."""
    jc, tc = jchain_of(JRates(1250, 10000)), _chain()
    jr = js.AcquiringReceiver(jc, PRE, max_lag=160)
    tr = AcquiringReceiver(tc, PRE, max_lag=160)
    bits = np.random.default_rng(0).integers(0, 2, (2, 512)).astype(np.int32)
    ji, jq = jr.tx_burst(_j(bits))
    ti, tq = tr.tx_burst(_t(bits))
    return {"bits": bits, "jax": (np.asarray(ji), np.asarray(jq)),
            "port": (ti, tq)}


def _chain():
    return qpsk_reference_chain(Rates(1250, 10000), device=CPU)


def test_tx_burst_equals_jax(burst):
    for g, w in zip(burst["port"], burst["jax"]):
        _close(g, w)


@pytest.mark.parametrize("mu", [0.0, 0.25, 0.3, 0.75])
def test_oerder_meyr_and_correct_timing_equal_jax(burst, mu):
    i, q = jimp.apply_static_delay(*(_j(v) for v in burst["jax"]), mu)
    i, q = np.asarray(i), np.asarray(q)
    t0 = ts.oerder_meyr_timing(_t(i), _t(q), SPS)
    j0 = js.oerder_meyr_timing(_j(i), _j(q), SPS)
    assert np.all(_circ(t0.numpy(), np.asarray(j0), SPS) < 1e-3)
    assert np.all(_circ(t0.numpy(), (31 + mu) % SPS, SPS) < 0.05)
    for g, w in zip(ts.correct_timing(_t(i), _t(q), _t(np.asarray(j0))),
                    js.correct_timing(_j(i), _j(q), j0)):
        _close(g, w)


def _qpsk_points(rng, n, slope, phase, gain=1.0, noise=0.0, shape=()):
    k = rng.integers(0, 4, shape + (n,))
    ang = 2 * np.pi * k / 4 + np.pi / 4 + slope * np.arange(n) + phase
    di = gain * np.cos(ang) + noise * rng.standard_normal(ang.shape)
    dq = gain * np.sin(ang) + noise * rng.standard_normal(ang.shape)
    return di.astype(np.float32), dq.astype(np.float32)


def test_blind_carrier_estimators_equal_jax():
    rng = np.random.default_rng(7)
    di, dq = _qpsk_points(rng, 512, 0.013, 0.4, noise=0.05, shape=(3,))
    cfo = ts.mth_power_cfo(_t(di), _t(dq), 4)
    _close(cfo, js.mth_power_cfo(_j(di), _j(dq), 4), 1e-5)
    assert torch.all((cfo - 0.013).abs() < 1e-3)
    di, dq = _qpsk_points(rng, 512, 0.0, 0.21 - np.pi / 4, noise=0.05,
                          shape=(3,))
    ph = ts.viterbi_viterbi_phase(_t(di), _t(dq), 4)
    _close(ph, js.viterbi_viterbi_phase(_j(di), _j(dq), 4), 1e-4)
    assert torch.all((ph - 0.21).abs() < 1e-2)


def test_preamble_cfo_phase_gain_equals_jax():
    pre_iq = np.stack([np.cos(2 * np.pi * PRE / 4 + np.pi / 4),
                       np.sin(2 * np.pi * PRE / 4 + np.pi / 4)],
                      axis=-1).astype(np.float32)
    k = np.arange(len(PRE))
    ang = (2 * np.pi * PRE / 4 + np.pi / 4 + np.array([[0.02], [-0.01]]) * k
           + np.array([[0.7], [-2.5]]))
    di = (0.85 * np.cos(ang)).astype(np.float32)
    dq = (0.85 * np.sin(ang)).astype(np.float32)
    got = ts.preamble_cfo_phase_gain(_t(di), _t(dq), pre_iq)
    want = js.preamble_cfo_phase_gain(_j(di), _j(dq), pre_iq)
    _close(got[0], want[0], 1e-5)
    _close(got[1], want[1], 1e-4)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               rtol=1e-4)
    assert torch.all((got[2] - 0.85).abs() < 1e-3)


def test_frame_sync_equals_jax(burst):
    rng = np.random.default_rng(9)
    i, q = burst["jax"]
    z = np.zeros((2, 13), np.float32)
    i, q = np.concatenate([z, i], -1), np.concatenate([z, q], -1)
    i, q = (np.asarray(v) for v in jimp.apply_cfo(_j(i), _j(q), 6.0, 10000,
                                                  phase0=0.5))
    i, q = _noisy(rng, i, q, 0.05)
    tc = _chain()
    yi, yq = tc.matched_filter(_t(i), _t(q))
    pre_iq = np.asarray(tc.lut)[PRE]
    lag = ts.frame_sync(yi, yq, pre_iq, SPS, 160)
    want = js.frame_sync(_j(yi.numpy()), _j(yq.numpy()), pre_iq, SPS, 160)
    _equal(lag, want)
    assert lag.dtype == torch.int32 and np.all(lag.numpy() == 64 + 13)
    with pytest.raises(ValueError, match="frame_sync needs"):
        ts.frame_sync(yi[:, :300], yq[:, :300], pre_iq, SPS, 160)


def test_decision_points_equal_jax_lane_selection(burst):
    """The gather of the decision instants equals the JAX package's one-hot
    lane selection and banded one-hot matmul bit for bit."""
    rng = np.random.default_rng(10)
    yi, yq = _gauss(rng, (3, 2400)), _gauss(rng, (3, 2400))
    lag = np.array([0, 77, 159], np.int32)
    n_tot, max_lag = 290, 160
    a_max = -(-max_lag // SPS)
    tneed = (n_tot + a_max) * SPS
    zp = np.zeros((3, tneed - yi.shape[-1]), np.float32)
    yri = _j(np.concatenate([yi, zp], -1)).reshape(3, n_tot + a_max, SPS)
    yrq = _j(np.concatenate([yq, zp], -1)).reshape(3, n_tot + a_max, SPS)
    ohb = (jnp.arange(SPS) == (_j(lag) % SPS)[:, None]).astype(jnp.float32)
    hp = jax.lax.Precision.HIGHEST
    pi_ = jnp.einsum("...kb,...b->...k", yri, ohb, precision=hp)
    pq_ = jnp.einsum("...kb,...b->...k", yrq, ohb, precision=hp)
    want = j_aligned(pi_, pq_, _j(lag) // SPS, n_tot, a_max)
    got = ts._decision_points(_t(yi), _t(yq), _t(lag), SPS, n_tot, max_lag)
    for g, w in zip(got, want):
        _equal(g, w)


def test_varying_delay_equals_jax():
    rng = np.random.default_rng(0)
    x, y = _gauss(rng, (2, 400)), _gauss(rng, (2, 400))
    d = np.clip(1.3 + 0.004 * np.arange(400) + 0.2 * rng.random((2, 400)),
                0, 4.999).astype(np.float32)
    for g, w in zip(ts.varying_delay(_t(x), _t(y), _t(d), 4),
                    js.varying_delay(_j(x), _j(y), _j(d), 4)):
        _close(g, w)
    # a constant 1 + mu is farrow_delay
    c = torch.full((2, 400), 1.37)
    _close(ts.varying_delay(_t(x), _t(y), c, 4)[0],
           timp.farrow_delay(_t(x), 0.37))


def test_varying_delay_integer_shift_bit_for_bit():
    """Integer delays select pure shifts: the gather equals the JAX
    package's one-hot sum over shifted copies bit for bit."""
    rng = np.random.default_rng(1)
    x = _gauss(rng, (3, 300))
    d = np.stack([np.full(300, j, np.float32) for j in (0, 3, 7)])
    d[2, 150:] = 2.0
    for g, w in zip(ts.varying_delay(_t(x), _t(x[::-1].copy()), _t(d), 8),
                    js.varying_delay(_j(x), _j(x[::-1].copy()), _j(d), 8)):
        _equal(g, w)
    got = ts.varying_delay(_t(x), _t(x), _t(d), 8)[0].numpy()
    assert np.array_equal(got[1, 7:], x[1, 4:300 - 3])


def _resample(x, ppm):
    """A slow RX clock: rx[n] = x(n / (1 + ppm*1e-6))."""
    n = x.shape[-1]
    t = np.arange(n) / (1.0 + ppm * 1e-6)
    return np.stack([np.interp(t, np.arange(n), row)
                     for row in x.reshape(-1, n)]).reshape(x.shape
                                                           ).astype(np.float32)


@pytest.mark.parametrize("fit", ["linear", "piecewise"])
def test_fits_equal_jax(fit):
    """The block fits of the trackers: the piecewise one's gathers equal the
    JAX package's one-hot einsums bit for bit; the linear one within
    1e-5."""
    rng = np.random.default_rng(12)
    nb, block, n = 6, 512, 6 * 512 + 100
    un = np.cumsum(rng.random((2, nb)), -1).astype(np.float32)
    got, slope = ts._fit_blocks(_t(un), n, block, fit)
    centers = (np.arange(nb, dtype=np.float32) + 0.5) * block
    ns = jnp.arange(n, dtype=jnp.float32)
    u = _j(un)
    if fit == "piecewise":
        x = (ns - centers[0]) / block
        j = jnp.clip(jnp.floor(x).astype(jnp.int32), 0, nb - 2)
        frac = x - j.astype(jnp.float32)
        ohj = (j[..., :, None]
               == jnp.arange(nb - 1, dtype=jnp.int32)).astype(jnp.float32)
        hp = jax.lax.Precision.HIGHEST
        lo = jnp.einsum("...b,nb->...n", u[..., :-1], ohj, precision=hp)
        hi = jnp.einsum("...b,nb->...n", u[..., 1:], ohj, precision=hp)
        _equal(got, lo + frac * (hi - lo))
        _equal(slope, (u[..., -1:] - u[..., :1]) / ((nb - 1) * block))
    else:
        cm = float(centers.mean())
        sl = jnp.sum(u * jnp.asarray(centers - cm), -1, keepdims=True) / float(
            np.sum((centers - cm) ** 2))
        _close(got, jnp.mean(u, -1, keepdims=True) + sl * (ns - cm))
        _close(slope, sl)


@pytest.fixture(scope="module")
def sfo_streams():
    """test_sfo_track.py's long bursts: 4096 payload symbols at 300 ppm
    with gain, phase and noise, and 2048 at 250 ppm, through the JAX
    ``sfo_track`` once."""
    jc = jchain_of(JRates(1250, 10000))
    jr = js.AcquiringReceiver(jc, PRE, max_lag=160, track_block=32,
                              track_order=2)
    out = {}
    for name, n_pay, ppm, seed, fit, md in (
            ("linear", 4096, 300.0, 2, "linear", 32),
            ("piecewise", 2048, 250.0, 4, "piecewise", 24)):
        rng = np.random.default_rng(seed)
        bits = rng.integers(0, 2, (2, n_pay * 2)).astype(np.int32)
        i, q = (np.asarray(v) for v in jr.tx_burst(_j(bits)))
        ri, rq = _resample(i, ppm), _resample(q, ppm)
        if name == "linear":
            ri, rq = (np.asarray(v) for v in jimp.apply_gain_phase(
                _j(ri), _j(rq), gain=0.8, phase=0.4))
            ri, rq = _noisy(rng, ri, rq, 0.8 * math.sqrt(0.5 * 10 ** -3))
        ci, cq, rep = js.sfo_track(_j(ri), _j(rq), sps=8, block_len=n_pay,
                                   max_delay=md, fit=fit)
        out[name] = dict(bits=bits, wave=(ri, rq), n=n_pay, md=md, fit=fit,
                         corrected=(np.asarray(ci), np.asarray(cq)),
                         rep={k: np.asarray(v) for k, v in rep.items()})
    return out


@pytest.mark.parametrize("name", ["linear", "piecewise"])
def test_sfo_track_equals_jax(sfo_streams, name):
    s = sfo_streams[name]
    ri, rq = s["wave"]
    ci, cq, rep = ts.sfo_track(_t(ri), _t(rq), sps=8, block_len=s["n"],
                               max_delay=s["md"], fit=s["fit"])
    np.testing.assert_allclose(rep["t0_blocks"].numpy(),
                               s["rep"]["t0_blocks"], atol=1e-3, rtol=0)
    np.testing.assert_allclose(rep["sfo_ppm"].numpy(), s["rep"]["sfo_ppm"],
                               rtol=1e-3)
    _equal(rep["clipped"], s["rep"]["clipped"])
    for g, w in zip((ci, cq), s["corrected"]):
        _close(g, w, TRACK_TOL)
    rxr = AcquiringReceiver(_chain(), PRE, max_lag=160, track_block=32,
                            track_order=2)
    _equal(rxr.rx(ci, cq, s["n"]), s["bits"])
    if name == "linear":
        assert np.all(np.abs(rep["sfo_ppm"].numpy() - 300.0) < 45.0)
        direct = rxr.rx(_t(ri), _t(rq), s["n"])
        assert int((direct != _t(s["bits"])).sum()) > 100


def test_sfo_track_checks():
    x = torch.zeros((2, 8192))
    with pytest.raises(ValueError, match="multiple of sps"):
        ts.sfo_track(x, x, sps=8, block_len=100)
    with pytest.raises(ValueError, match=">= 2 blocks"):
        ts.sfo_track(x, x, sps=8, block_len=8192)
    with pytest.raises(ValueError, match="unknown fit"):
        ts.sfo_track(x, x, sps=8, block_len=4096, fit="cubic")


@pytest.mark.parametrize("fit,m,n,block", [("linear", 4, 8192 + 100, 256),
                                           ("piecewise", 4, 8192, 256),
                                           ("linear", 2, 4096, 128)])
def test_phase_track_equals_jax(fit, m, n, block):
    rng = np.random.default_rng(n + m)
    if m == 4:
        di, dq = _qpsk_points(rng, n, 8e-4, 0.9, noise=0.02, shape=(2,))
        if fit == "piecewise":
            wob = 0.35 * np.sin(2 * np.pi * np.arange(n) / 6000)
            z = (di + 1j * dq) * np.exp(1j * wob)
            di, dq = z.real.astype(np.float32), z.imag.astype(np.float32)
    else:
        ang = rng.integers(0, 2, n) * np.pi + 0.2 + 1e-3 * np.arange(n)
        di, dq = (np.cos(ang).astype(np.float32),
                  np.sin(ang).astype(np.float32))
    ci, cq, rep = ts.phase_track(_t(di), _t(dq), m, block, fit=fit)
    jci, jcq, jrep = js.phase_track(_j(di), _j(dq), m, block, fit=fit)
    _close(ci, jci, TRACK_TOL)
    _close(cq, jcq, TRACK_TOL)
    _close(rep["phase_blocks"], jrep["phase_blocks"], 1e-4)
    _close(rep["cfo_rad_per_sym"], jrep["cfo_rad_per_sym"], 1e-5)
    with pytest.raises(ValueError, match=">= 2 blocks"):
        ts.phase_track(_t(di[..., :block]), _t(dq[..., :block]), m, block)


@pytest.mark.parametrize("order", [1, 2])
def test_dd_trackers_equal_jax(order):
    """test_agc_track.py's ramped QPSK points at 0.01 rad/symbol, through
    the first- and second-order decision-directed loops."""
    lut = np.asarray(_chain().lut)
    rng = np.random.default_rng(3)
    syms = rng.integers(0, 4, (2, 1000))
    th = 0.01 * np.arange(1000)
    pts = lut[syms]
    i = (pts[..., 0] * np.cos(th) - pts[..., 1] * np.sin(th)
         + 0.01 * rng.standard_normal((2, 1000))).astype(np.float32)
    q = (pts[..., 0] * np.sin(th) + pts[..., 1] * np.cos(th)
         + 0.01 * rng.standard_normal((2, 1000))).astype(np.float32)
    if order == 1:
        got = ts.dd_phase_track(_t(i), _t(q), lut, block=16)
        want = js.dd_phase_track(_j(i), _j(q), lut, block=16)
        _close(got[2], want[2], TRACK_TOL)
    else:
        got = ts.dd_carrier_track(_t(i), _t(q), lut, block=16)
        want = js.dd_carrier_track(_j(i), _j(q), lut, block=16)
        for key in ("phase", "freq"):
            _close(got[2][key], want[2][key], TRACK_TOL)
        assert torch.all((got[2]["freq"][:, -1] - 0.01).abs() < 1e-3)
    _close(got[0], want[0], TRACK_TOL)
    _close(got[1], want[1], TRACK_TOL)


# ---------------------------------------------------------------------------
# AcquiringReceiver
# ---------------------------------------------------------------------------

#: receiver keywords of each case
RX_KW = {"clean": {}, "full_stack": {}, "multipath": {},
         "equalized": {"eq_taps": 7, "track_block": 16},
         "tracked": {"track_block": 16},
         "second_order": {"track_block": 16, "track_order": 2}}


def _capture(case, jr, rng):
    """The JAX package's impairment stack of each ``test_sync.py`` /
    ``test_agc_track.py`` case on a JAX burst, noise drawn by numpy.
    Returns ``(bits, i, q, n_payload)``."""
    n_pay = 512 if case == "second_order" else 256
    bits = rng.integers(0, 2, (2, 2 * n_pay)).astype(np.int32)
    i, q = jr.tx_burst(_j(bits))
    sigma = None
    if case == "clean":
        z = jnp.zeros((2, 13), jnp.float32)
        i, q = jnp.concatenate([z, i], -1), jnp.concatenate([z, q], -1)
    elif case == "full_stack":
        i, q = jimp.apply_static_delay(i, q, 0.37)
        i, q = jimp.apply_cfo(i, q, 8.0, 10000, phase0=1.1)
        i, q = jimp.apply_gain_phase(i, q, gain=0.8)
        sigma = 30.0
    elif case == "multipath":
        i, q = jimp.multipath_fir(i, q, np.array([1.0, 0, 0, 0.1], np.float32),
                                  np.array([0.0, 0, 0, 0.05], np.float32))
    elif case == "equalized":
        i, q = jimp.multipath_fir(i, q, HI3, HQ3)
        sigma = 35.0
    elif case == "tracked":
        i, q = jimp.multipath_fir(i, q, HI13, HQ13)
        i, q = jimp.apply_static_delay(i, q, 0.2)
        i, q = jimp.apply_cfo(i, q, 5.0, 10000, phase0=0.5)
        sigma = 32.0
    else:
        i, q = jimp.apply_cfo(i, q, 6.0, 10000, phase0=0.7)
    i, q = np.asarray(i), np.asarray(q)
    if sigma is not None:
        p = float(np.mean(i * i + q * q))
        i, q = _noisy(rng, i, q, math.sqrt(p / 10 ** (sigma / 10) / 2))
    return bits, i, q, n_pay


@pytest.fixture(scope="module")
def acquisitions():
    """Each case's capture and the JAX receiver's points, report and bits,
    run once at first use."""
    jc = jchain_of(JRates(1250, 10000))
    memo = {}

    def run(case):
        if case not in memo:
            jr = js.AcquiringReceiver(jc, PRE, max_lag=160, **RX_KW[case])
            rng = np.random.default_rng(sorted(RX_KW).index(case))
            bits, i, q, n = _capture(case, jr, rng)
            (pi_, pq_), rep = jr.acquire(_j(i), _j(q), n)
            # rx's bits from acquire's points, as jr.rx slices them
            syms = j_slice(pi_, pq_, jc.lut)
            memo[case] = dict(bits=bits, wave=(i, q), n=n,
                              points=(np.asarray(pi_), np.asarray(pq_)),
                              rep={k: np.asarray(v) for k, v in rep.items()
                                   if k != "eq_taps"},
                              rx=np.asarray(j_unpack(syms, 2)))
        return memo[case]
    return run


def _check_report(rep, want):
    _equal(rep["lag"], want["lag"])
    assert np.all(_circ(rep["timing"].numpy(), want["timing"], SPS) < 1e-3)
    _close(rep["cfo_rad_per_symbol"], want["cfo_rad_per_symbol"], 1e-5)
    _close(rep["phase"], want["phase"], 1e-4)
    np.testing.assert_allclose(rep["gain"].numpy(), want["gain"], rtol=1e-4)


@pytest.mark.parametrize("case", sorted(RX_KW))
def test_acquiring_receiver_equals_jax(acquisitions, case):
    a = acquisitions(case)
    rxr = AcquiringReceiver(_chain(), PRE, max_lag=160, **RX_KW[case])
    i, q = _t(a["wave"][0]), _t(a["wave"][1])
    (pi_, pq_), rep = rxr.acquire(i, q, a["n"])
    _check_report(rep, a["rep"])
    tol = TRACK_TOL if RX_KW[case] else TOL
    _close(pi_, a["points"][0], tol)
    _close(pq_, a["points"][1], tol)
    for key in ("tracked_phase", "tracked_freq"):
        if key in a["rep"]:
            _close(rep[key], a["rep"][key], TRACK_TOL)
    out = rxr.rx(i, q, a["n"])
    assert out.dtype == torch.int32
    _equal(out, a["rx"])
    _equal(out, a["bits"])
    if case == "full_stack":
        want_cfo = 2 * np.pi * 8.0 * SPS / 10000
        assert torch.all((rep["cfo_rad_per_symbol"] - want_cfo).abs()
                         < 0.1 * want_cfo + 2e-3)
        assert torch.all((rep["gain"] - 0.8).abs() < 0.05)


def test_tracking_is_needed_where_the_jax_tests_say(acquisitions):
    """The plain receiver fails on the tracked case's capture, as the JAX
    one does (test_tracking_fixes_residual_cfo_drift)."""
    a = acquisitions("tracked")
    plain = AcquiringReceiver(_chain(), PRE, max_lag=160)
    assert int((plain.rx(_t(a["wave"][0]), _t(a["wave"][1]), a["n"])
                != _t(a["bits"])).sum()) > 0


def test_acquiring_receiver_checks():
    tc = _chain()
    with pytest.raises(ValueError, match="eq_taps"):
        AcquiringReceiver(tc, PRE, max_lag=160, eq_taps=17)
    with pytest.raises(ValueError, match="track_order"):
        AcquiringReceiver(tc, PRE, max_lag=160, track_order=3)
    passband = PulseShapedChain(make_scheme("qpsk", Rates(1250, 10000)),
                                Rates(1250, 10000), carrier_hz=2000,
                                device=CPU)
    with pytest.raises(NotImplementedError, match="baseband"):
        AcquiringReceiver(passband, PRE, max_lag=160)
    rxr = AcquiringReceiver(tc, PRE, max_lag=160)
    assert np.array_equal(rxr.pre_iq, np.asarray(tc.lut)[PRE])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            AcquiringReceiver(qpsk_reference_chain(Rates(1250, 10000)), PRE,
                              max_lag=160)
