"""The OFDM PHY of the port (``modem_tpu_torch.ofdm``: ``OfdmModem``,
``OfdmChain``, ``OfdmStreamReceiver``) and its acquisition primitives
(``modem_tpu_torch.ops.sync_metric``) against the JAX package on the same
numpy inputs, on the CPU (where the preamble correlation takes K4's plain
version).

Tolerances: ``tx_frame`` waveforms within 1e-5 absolute (unit power);
``rx_soft_payload`` LLRs within 1e-4 of their largest magnitude;
``periodic_similarity`` and ``template_correlate_fir`` within 1e-5 of the
output's largest magnitude; hard bits, located starts, the stream
receiver's frames and ``aligned_frame_matmul`` exactly. Each modem
configuration of the JAX package runs once, in a module fixture.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from modem_tpu import Rates as JRates
from modem_tpu import ofdm as jofdm
from modem_tpu.models import make_scheme as jscheme
from modem_tpu.ops import sync_metric as jsm

from modem_tpu_torch import (OfdmChain, OfdmModem, OfdmStreamReceiver,
                             Rates, make_scheme, presets)
from modem_tpu_torch.ops import fir, sync_metric as sm

torch.set_num_threads(1)

CPU = "cpu"
S = 4             # payload symbols a frame
MAX_LAG = 64
NV = 0.2
_DATA, _PILOTS = jofdm._default_grid(64)
#: configuration name -> OfdmModem keywords
CONFIGS = {"cpe": {}, "sfo": {"pilot_tracking": "sfo"},
           "denoise": {"channel_denoise": True},
           "pilotless": {"data_bins": _DATA + _PILOTS, "pilot_bins": ()}}


def _modems(name, scheme="qpsk"):
    kw = CONFIGS[name]
    return (jofdm.OfdmModem(jscheme(scheme, JRates(1250, 10000)), **kw),
            OfdmModem(make_scheme(scheme, Rates(1250, 10000)), device=CPU,
                      **kw))


def _capture(wi, wq, offsets, rng, cfo=0.01, sigma=0.03):
    """Each frame at its offset in a zero capture, rotated by a phase and
    a CFO (rad/sample), plus Gaussian noise."""
    b, t = wi.shape
    ci = np.zeros((b, MAX_LAG + t + 30), np.float32)
    cq = np.zeros_like(ci)
    n = np.arange(t)
    for r in range(b):
        z = (wi[r] + 1j * wq[r]) * np.exp(1j * (cfo * n + 0.7 * r + 0.2))
        ci[r, offsets[r]:offsets[r] + t] = z.real
        cq[r, offsets[r]:offsets[r] + t] = z.imag
    ci += rng.normal(0.0, sigma, ci.shape).astype(np.float32)
    cq += rng.normal(0.0, sigma, cq.shape).astype(np.float32)
    return ci, cq


def _burst_stream(jm, payloads, gaps, rng, noise=0.02):
    """``[gap][frame][gap][frame]...[gap]`` with noise in the gaps; the
    frames rotated and scaled. Returns ``(i, q, starts)``."""
    segs_i, segs_q, starts, pos = [], [], [], 0
    for g, bits in zip(gaps, list(payloads) + [None]):
        segs_i.append(noise * rng.standard_normal(g).astype(np.float32))
        segs_q.append(noise * rng.standard_normal(g).astype(np.float32))
        pos += g
        if bits is None:
            break
        i, q = (np.asarray(v) for v in jm.tx_frame(jnp.asarray(bits)))
        z = 1.2 * np.exp(0.7j) * (i + 1j * q)
        segs_i.append((z.real + noise * rng.standard_normal(z.size))
                      .astype(np.float32))
        segs_q.append((z.imag + noise * rng.standard_normal(z.size))
                      .astype(np.float32))
        starts.append(pos)
        pos += z.size
    return np.concatenate(segs_i), np.concatenate(segs_q), starts


@pytest.fixture(scope="module")
def runs():
    out = {}
    for k, name in enumerate(CONFIGS):
        jm, _ = _modems(name)
        rng = np.random.default_rng(k)
        bits = rng.integers(0, 2, (3, jm.bits_per_frame(S))).astype(np.int32)
        wi, wq = (np.asarray(v) for v in jm.tx_frame(jnp.asarray(bits)))
        ni = (wi + rng.normal(0, 0.1, wi.shape)).astype(np.float32)
        nq = (wq + rng.normal(0, 0.1, wq.shape)).astype(np.float32)
        jc = jofdm.OfdmChain(jm)
        offsets = (0, 17, MAX_LAG - 1)
        ci, cq = _capture(wi, wq, offsets, rng)
        jbits, jrep = jm.acquire(jnp.asarray(ci), jnp.asarray(cq), S,
                                 MAX_LAG)
        jllr, _ = jm.acquire_soft(jnp.asarray(ci), jnp.asarray(cq), S,
                                  MAX_LAG, noise_var=NV)
        out[name] = dict(
            bits=bits, wave=(wi, wq), noisy=(ni, nq), offsets=offsets,
            llr=np.asarray(jc.rx_soft((jnp.asarray(ni), jnp.asarray(nq)), S,
                                      noise_var=NV)),
            hard=np.asarray(jc.rx((jnp.asarray(ni), jnp.asarray(nq)), S)),
            capture=(ci, cq), acq_bits=np.asarray(jbits),
            acq_start=np.asarray(jrep["start"]),
            acq_llr=np.asarray(jllr))
    return out


@pytest.fixture(scope="module")
def streams():
    """Per configuration, three bursts in noise through the JAX stream
    receiver in chunks; each configuration run once, at first use."""
    memo = {}

    def run(name):
        if name in memo:
            return memo[name]
        jm, _ = _modems(name)
        rng = np.random.default_rng(7)
        payloads = [rng.integers(0, 2, jm.bits_per_frame(S)).astype(np.int32)
                    for _ in range(3)]
        si, sq, starts = _burst_stream(jm, payloads, [300, 40, 650, 200],
                                       rng)
        cuts = np.cumsum(rng.integers(1, 900, 40))
        cuts = [0] + [int(c) for c in cuts if c < si.size] + [si.size]
        rx = jofdm.OfdmStreamReceiver(jm, S)
        frames = []
        for a, b in zip(cuts, cuts[1:]):
            frames += rx.push(jnp.asarray(si[a:b]), jnp.asarray(sq[a:b]))
        frames += rx.flush()
        memo[name] = dict(payloads=payloads, stream=(si, sq), starts=starts,
                          cuts=cuts, frames=[(np.asarray(b), r["start"])
                                             for b, r in frames])
        return memo[name]
    return run


def _t(x):
    return torch.as_tensor(np.array(x))


@pytest.mark.parametrize("name", CONFIGS)
def test_tables_equal(name):
    jm, tm = _modems(name)
    for attr in ("_tx_c", "_tx_s", "_rx_c", "_rx_s", "_rx_cp", "_rx_sp",
                 "_pilot_vals", "_polarity_pn", "_ltf_vals", "_denoise_re",
                 "_denoise_im", "_preamble_i", "_preamble_q", "lut"):
        np.testing.assert_array_equal(getattr(tm, attr),
                                      np.asarray(getattr(jm, attr)))
    for attr in ("used_bins", "data_bins", "pilot_bins", "bits_per_sym",
                 "preamble_len", "sym_len"):
        assert getattr(tm, attr) == getattr(jm, attr), attr
    assert tm.frame_len(S) == jm.frame_len(S)


@pytest.mark.parametrize("name", CONFIGS)
def test_tx_frame_equal(runs, name):
    _, tm = _modems(name)
    run = runs[name]
    for got, want in zip(tm.tx_frame(_t(run["bits"])), run["wave"]):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("name", CONFIGS)
def test_rx_soft_and_hard_equal(runs, name):
    _, tm = _modems(name)
    run = runs[name]
    tc, wave = OfdmChain(tm), tuple(_t(w) for w in run["noisy"])
    llr = tc.rx_soft(wave, S, noise_var=NV).numpy()
    want = run["llr"]
    assert llr.shape == want.shape
    assert np.abs(llr - want).max() <= 1e-4 * np.abs(want).max()
    np.testing.assert_array_equal(tc.rx(wave, S).numpy(), run["hard"])
    np.testing.assert_array_equal(run["hard"], run["bits"])


@pytest.mark.parametrize("name", CONFIGS)
def test_acquire_equal(runs, name):
    _, tm = _modems(name)
    run = runs[name]
    ci, cq = (_t(c) for c in run["capture"])
    bits, rep = tm.acquire(ci, cq, S, MAX_LAG)
    np.testing.assert_array_equal(rep["start"].numpy(), run["acq_start"])
    np.testing.assert_array_equal(rep["start"].numpy(), run["offsets"])
    np.testing.assert_array_equal(bits.numpy(), run["acq_bits"])
    np.testing.assert_array_equal(bits.numpy(), run["bits"])
    assert abs(float(rep["cfo_rad_per_sample"].mean()) - 0.01) < 2e-3
    assert (rep["sc_peak"] > 0.6).all()
    llr, _ = tm.acquire_soft(ci, cq, S, MAX_LAG, noise_var=NV)
    want = run["acq_llr"]
    assert np.abs(llr.numpy() - want).max() <= 1e-4 * np.abs(want).max()


def test_acquire_correlators_and_aligners_agree(runs):
    """The ``"gather"`` correlator and aligner give the ``"fir"`` and
    ``"matmul"`` forms' starts and bits."""
    _, tm = _modems("cpe")
    ci, cq = (_t(c) for c in runs["cpe"]["capture"])
    bits, rep = tm.acquire(ci, cq, S, MAX_LAG, correlator="gather")
    np.testing.assert_array_equal(bits.numpy(), runs["cpe"]["acq_bits"])
    fi, fq, rep2 = tm.locate_frame(ci, cq, S, MAX_LAG, aligner="gather")
    gi, gq, _ = tm.locate_frame(ci, cq, S, MAX_LAG)
    assert torch.equal(fi, gi) and torch.equal(fq, gq)
    assert torch.equal(rep["start"], rep2["start"])
    for kw in (dict(correlator="bogus"), dict(aligner="bogus")):
        with pytest.raises(ValueError, match="unknown"):
            tm.locate_frame(ci, cq, S, MAX_LAG, **kw)


def test_acquire_runs_k4_plain_at_240_taps(runs, monkeypatch):
    """The fine timing is four FIR passes of the 240-tap reversed
    preamble: on the CPU, K4's plain version."""
    _, tm = _modems("cpe")
    seen = []
    plain = fir.fir_plain
    monkeypatch.setattr(fir, "fir_plain", lambda x, taps, state: (
        seen.append(taps.shape[0]) or plain(x, taps, state)))
    ci, cq = (_t(c) for c in runs["cpe"]["capture"])
    tm.acquire(ci, cq, S, MAX_LAG)
    assert seen == [tm.preamble_len] * 4 == [240] * 4


@pytest.mark.parametrize("name", CONFIGS)
def test_stream_receiver_equal(streams, name):
    _, tm = _modems(name)
    stream = streams(name)
    si, sq = stream["stream"]
    rx = OfdmStreamReceiver(tm, S)
    frames = []
    cuts = stream["cuts"]
    for a, b in zip(cuts, cuts[1:]):
        frames += rx.push(si[a:b], sq[a:b])
    frames += rx.flush()
    assert len(frames) == len(stream["frames"]) == 3
    for (bits, rep), (want, start), sent, t0 in zip(
            frames, stream["frames"], stream["payloads"], stream["starts"]):
        np.testing.assert_array_equal(bits.numpy(), want)
        np.testing.assert_array_equal(bits.numpy(), sent)
        assert rep["start"] == start and abs(start - t0) <= 4
        assert rep["sc_detect"] > 0.6
    # a fresh stream after the flush, in one push
    again = rx.push(si, sq) + rx.flush()
    assert [r["start"] for _, r in again] == [s for _, s in stream["frames"]]


def test_sync_metric_primitives_equal(runs):
    ci, cq = runs["cpe"]["capture"]
    jm, _ = _modems("cpe")
    for got, want in zip(
            sm.periodic_similarity(_t(ci), _t(cq), 16, 64, 100),
            jsm.periodic_similarity(jnp.asarray(ci), jnp.asarray(cq), 16, 64,
                                    100)):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    tpl = (jm._preamble_i, jm._preamble_q)
    for got, want in zip(
            sm.template_correlate_fir(_t(ci), _t(cq), *tpl, MAX_LAG),
            jsm.template_correlate_fir(jnp.asarray(ci), jnp.asarray(cq),
                                       *tpl, MAX_LAG)):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    with pytest.raises(ValueError, match="need >= 181 samples"):
        sm.periodic_similarity(_t(ci[:, :180]), _t(cq[:, :180]), 16, 64, 101)


@pytest.mark.parametrize("out_len", [300, 470, 1000])
def test_aligned_frame_matmul_bit_for_bit(runs, out_len):
    """Starts at both ends of the range; outputs that run past the capture
    read zeros."""
    ci, cq = runs["cpe"]["capture"]
    start = np.array([0, 13, MAX_LAG - 1], np.int32)
    got = sm.aligned_frame_matmul(_t(ci), _t(cq), _t(start), out_len,
                                  MAX_LAG)
    want = jsm.aligned_frame_matmul(jnp.asarray(ci), jnp.asarray(cq),
                                    jnp.asarray(start), out_len, MAX_LAG)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("kwargs,match", [
    (dict(n_fft=62), "n_fft must divide by 4"),
    (dict(pilot_bins=(7,)), "data_bins is required"),
    (dict(n_ltf=0), "need n_ltf >= 1"),
    (dict(pilot_tracking="x"), "pilot_tracking must be"),
    (dict(data_bins=(1, 2), pilot_bins=(3,), pilot_tracking="sfo"),
     "sfo tracking needs >= 2 pilot bins"),
    (dict(data_bins=(1, 2), pilot_bins=(2,)), "overlap"),
    (dict(data_bins=(0, 1)), "or DC"),
    (dict(data_bins=(1, 2, 3), pilot_bins=()), "no bins divisible by 4"),
])
def test_constructor_errors_equal(kwargs, match):
    with pytest.raises(ValueError, match=match):
        jofdm.OfdmModem(jscheme("qpsk", JRates(1250, 10000)), **kwargs)
    with pytest.raises(ValueError, match=match):
        OfdmModem(make_scheme("qpsk", Rates(1250, 10000)), device=CPU,
                  **kwargs)


def test_stream_receiver_errors_and_sizes():
    jm, tm = _modems("cpe")
    with pytest.raises(ValueError, match="must be <= frame_len"):
        OfdmStreamReceiver(tm, 1, max_lag=10000)
    rx, jrx = OfdmStreamReceiver(tm, S), jofdm.OfdmStreamReceiver(jm, S)
    assert (rx.max_lag, rx.win, rx.frame_len) == (jrx.max_lag, jrx.win,
                                                  jrx.frame_len)
    with pytest.raises(ValueError, match="must divide by 96"):
        tm.map_bits(torch.zeros((1, 95), dtype=torch.int32))
    with pytest.raises(ValueError, match="need 320 samples"):
        tm.rx_payload(torch.zeros(100), torch.zeros(100), 4)


@pytest.mark.parametrize("build", [
    lambda: OfdmModem(make_scheme("qpsk", Rates(1250, 10000))),
    lambda: OfdmStreamReceiver(
        OfdmModem(make_scheme("qpsk", Rates(1250, 10000))), S),
    lambda: presets.wifi_like_ofdm_link(),
    lambda: presets.burst_ofdm_receiver(),
], ids=["OfdmModem", "OfdmStreamReceiver", "wifi_like_ofdm_link",
        "burst_ofdm_receiver"])
def test_device_none_is_the_card(build, monkeypatch):
    """``device=None`` means CUDA; without a CUDA device the entry points
    raise and build nothing on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build()
