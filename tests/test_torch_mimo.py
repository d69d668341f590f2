"""The port's spatially-multiplexed MIMO over OFDM (``modem_tpu_torch.mimo``:
``MimoOfdm``, ``MimoOfdmN``, the split-plane helpers, and the
``mimo_ofdm_link`` preset) against the JAX package on the same numpy
inputs, on the CPU.

Tolerances: tables equal; antenna waveforms within 1e-5 absolute (unit
power); decision points within 1e-4; the LLR weights within 1e-4 relative;
LLRs within 1e-4 of their largest magnitude; ``_cinv_h`` against the JAX one
and ``np.linalg.inv`` at rtol 2e-3 / atol 2e-4 (the JAX test's); hard bits
and the links' payloads and verdicts exactly. The JAX receivers run once per
case, jitted together, in a module fixture.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from modem_tpu import Rates as JRates
from modem_tpu import mimo as jmimo
from modem_tpu import presets as jpresets
from modem_tpu.link import FramedLink as JFramedLink
from modem_tpu.models import make_scheme as jscheme

from modem_tpu_torch import (FramedLink, MimoOfdm, MimoOfdmN, Rates,
                             make_scheme, presets)
from modem_tpu_torch import mimo

torch.set_num_threads(1)

CPU = "cpu"
S = 4             # payload slots a frame
# a well-conditioned dispersive 2x2 channel: rx r hears stream a via CH[r, a]
CH = {
    (0, 0): (np.array([0.9, 0.0, 0.2, 0.0, -0.08], np.float32),
             np.array([0.1, -0.25, 0.0, 0.1, 0.0], np.float32)),
    (0, 1): (np.array([0.35, 0.2, 0.0, -0.1, 0.0], np.float32),
             np.array([0.0, 0.1, -0.15, 0.0, 0.05], np.float32)),
    (1, 0): (np.array([0.3, -0.15, 0.1, 0.0, 0.0], np.float32),
             np.array([0.12, 0.0, 0.08, -0.06, 0.0], np.float32)),
    (1, 1): (np.array([0.85, 0.1, -0.2, 0.0, 0.06], np.float32),
             np.array([0.05, 0.2, 0.0, -0.1, 0.0], np.float32)),
}


def _rand_channel(nr, nt, seed=0, taps=5):
    """Strong distinct diagonal paths plus weaker cross paths, CP-short."""
    rng = np.random.default_rng(seed)
    ch = {}
    for r in range(nr):
        for a in range(nt):
            hi = rng.normal(0, 0.08, taps).astype(np.float32)
            hq = rng.normal(0, 0.08, taps).astype(np.float32)
            hi[0] += 0.9 if r == a else 0.3
            ch[(r, a)] = (hi, hq)
    return ch


def _t(x):
    return torch.as_tensor(np.array(x))


def _fir(i, q, h):
    hc = h[0].astype(np.float64) + 1j * h[1]
    z = np.asarray(i, np.float64) + 1j * np.asarray(q)
    return np.apply_along_axis(lambda r: np.convolve(r, hc)[:r.size], -1, z)


def _mix(waves, ch, nr, rng, sigma):
    """Receive antenna r: the sum over transmit antennas a of
    ``waves[a]`` through ``ch[r, a]``, plus noise. Returns ``[(i, q)] *
    nr``."""
    out = []
    for r in range(nr):
        y = sum(_fir(*w, ch[(r, a)]) for a, w in enumerate(waves))
        y = y + sigma * (rng.standard_normal(y.shape)
                         + 1j * rng.standard_normal(y.shape))
        out.append((y.real.astype(np.float32), y.imag.astype(np.float32)))
    return out


def _pair(scheme="qpsk"):
    return (jmimo.MimoOfdm(jscheme(scheme, JRates(1250, 10000))),
            MimoOfdm(make_scheme(scheme, Rates(1250, 10000)), device=CPU))


def _pair_n(nt, scheme="qpsk"):
    return (jmimo.MimoOfdmN(jscheme(scheme, JRates(1250, 10000)), nt=nt),
            MimoOfdmN(make_scheme(scheme, Rates(1250, 10000)), nt=nt,
                      device=CPU))


#: N x N cases: (nt, nr, scheme, sigma, noise_var; seed)
N_CASES = {"4x4-zf": (4, 4, "qpsk", 0.0, 0.0, 0),
           "4x4-mmse": (4, 4, "qam16", 10 ** (-45 / 20) / np.sqrt(2),
                        10 ** (-45 / 10), 1),
           "2x3-mmse": (2, 3, "qpsk", 10 ** (-25 / 20) / np.sqrt(2),
                        10 ** (-25 / 10), 2)}


@pytest.fixture(scope="module")
def runs():
    out = {}
    for k, (name, snr, nv) in enumerate((("qpsk", None, 0.0),
                                         ("qam16", 34.0, 4e-4))):
        jm, _ = _pair(name)
        rng = np.random.default_rng(k)
        bits = rng.integers(0, 2, (2, jm.bits_per_frame(S))).astype(np.int32)
        wa, wb = jm.tx(jnp.asarray(bits))
        waves = [tuple(np.asarray(x) for x in w) for w in (wa, wb)]
        sigma = 0.0 if snr is None else 10 ** (-snr / 20) / np.sqrt(2)
        y = [x for pair in _mix(waves, CH, 2, rng, sigma) for x in pair]
        det, hard, llr = jax.jit(lambda *a: (
            jm.detect(*a, S, nv), jm.rx_frame(*a, S, noise_var=nv),
            jm.rx_soft_frame(*a, S, noise_var=max(nv, 1e-3))))(
                *(jnp.asarray(x) for x in y))
        out[name] = dict(bits=bits, wave=waves, rx=y, nv=nv,
                         det=tuple(np.asarray(x) for x in det),
                         hard=np.asarray(hard), llr=np.asarray(llr))
    for name, (nt, nr, scheme, sigma, nv, seed) in N_CASES.items():
        jm, _ = _pair_n(nt, scheme)
        rng = np.random.default_rng(seed)
        bits = rng.integers(0, 2, (2, jm.bits_per_frame(S))).astype(np.int32)
        ti, tq = (np.asarray(x) for x in jm.tx(jnp.asarray(bits)))
        waves = [(ti[..., a, :], tq[..., a, :]) for a in range(nt)]
        y = _mix(waves, _rand_channel(nr, nt, seed), nr, rng, sigma)
        yi = np.stack([p[0] for p in y], -2)
        yq = np.stack([p[1] for p in y], -2)
        jy = (jnp.asarray(yi), jnp.asarray(yq))
        # the detector as the JAX tests call it, op by op: jitted, XLA's
        # float32 error at the 4x4 zero-forcing solve reaches 1.04e-4
        det = jm.detect(*jy, S, nv)
        hard, llr = jax.jit(lambda *a: (
            jm.rx_frame(*a, S, noise_var=nv),
            jm.rx_soft_frame(*a, S, noise_var=max(nv, 1e-4))))(*jy)
        out[name] = dict(bits=bits, wave=(ti, tq), rx=(yi, yq), nv=nv,
                         det=tuple(np.asarray(x) for x in det),
                         hard=np.asarray(hard), llr=np.asarray(llr))
    return out


def _check_detect(got, want):
    """Decision points within 1e-4, weights within 1e-4 relative."""
    for g, w in zip(got[:2], want[:2]):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, atol=1e-4, rtol=0)
    assert got[2].shape == want[2].shape
    np.testing.assert_allclose(got[2].numpy(), want[2], rtol=1e-4)


def _check_llr(got, want):
    assert got.shape == want.shape
    assert np.abs(got.numpy() - want).max() <= 1e-4 * np.abs(want).max()


# ---- 2x2 ----

@pytest.mark.parametrize("name", ["qpsk", "qam16"])
def test_2x2_tables_and_tx_equal(runs, name):
    jm, tm = _pair(name)
    for attr in ("_rx_cd", "_rx_sd", "_ltf_vals", "_ltf_ti", "_stf_ti",
                 "lut"):
        np.testing.assert_array_equal(getattr(tm.m, attr),
                                      np.asarray(getattr(jm.m, attr)))
    assert tm._es == jm._es and tm.bits_per_slot == jm.bits_per_slot
    assert tm.frame_len(S) == jm.frame_len(S)
    run = runs[name]
    wa, wb = tm.tx(_t(run["bits"]))
    for got, want in zip(wa + wb, run["wave"][0] + run["wave"][1]):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("name", ["qpsk", "qam16"])
def test_2x2_detect_and_llrs_equal(runs, name):
    """Through the dispersive 2x2 channel: ZF noiseless (QPSK) and MMSE at
    34 dB (16-QAM): decision points, weights, hard bits and LLRs equal the
    JAX detector's; every bit right."""
    _, tm = _pair(name)
    run = runs[name]
    y = [_t(x) for x in run["rx"]]
    _check_detect(tm.detect(*y, S, run["nv"]), run["det"])
    np.testing.assert_array_equal(
        tm.rx_frame(*y, S, noise_var=run["nv"]).numpy(), run["hard"])
    np.testing.assert_array_equal(run["hard"], run["bits"])
    _check_llr(tm.rx_soft_frame(*y, S, noise_var=max(run["nv"], 1e-3)),
               run["llr"])


def test_conv_link_over_2x2_equal():
    """``FramedLink`` (CRC, scrambler, conv K=7 full-block, set on both
    sides, interleaver) over the MIMO adapter through the 2x2 channel at
    14 dB: 4 slots a frame, as in the JAX link; the waveforms from the same
    wire bits and the LLRs equal the JAX modem's; every payload back with
    its CRC true, and the decode of the JAX receiver's LLRs equal to the
    decode of the port's (the decoders are held to each other in
    ``test_torch_fec.py``)."""
    jm, tm = _pair()
    jl = JFramedLink(jm.as_link_chain(), payload_bits=394, conv_window=None)
    tl = FramedLink(tm.as_link_chain(), payload_bits=394, conv_window=None)
    assert tl.n_symbols == jl.n_symbols == 4
    rng = np.random.default_rng(7)
    pay = rng.integers(0, 2, (2, 394)).astype(np.int32)
    wa, wb = jm.tx(jnp.asarray(tl.frame(_t(pay)).numpy()))
    waves = [tuple(np.asarray(x) for x in w) for w in (wa, wb)]
    ta, tb = tl.tx(_t(pay))
    for got, want in zip(ta + tb, waves[0] + waves[1]):
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    sigma = 10 ** (-14 / 20) / np.sqrt(2)
    y = [x for p in _mix(waves, CH, 2, rng, sigma) for x in p]
    nv = 2 * sigma ** 2
    jllr = np.asarray(jm.rx_soft_frame(*(jnp.asarray(x) for x in y),
                                       tl.n_symbols, noise_var=nv))
    _check_llr(tl.chain.rx_soft(tuple(_t(x) for x in y), tl.n_symbols,
                                noise_var=nv), jllr)
    out, ok = tl.rx(tuple(_t(x) for x in y), nv)
    jout, jok = tl.decode(_t(jllr))
    assert torch.equal(out, jout) and torch.equal(ok, jok)
    assert ok.all() and np.array_equal(out.numpy(), pay)


def test_mimo_ofdm_link_equal():
    """``presets.mimo_ofdm_link()`` against the JAX preset: the same
    geometry (26 codewords in 81 slots), the same antenna waveforms from
    the same wire bits; through a flat cross-coupled 2x2 channel at 12 dB
    every payload back with its CRC true, and the decode of the JAX
    receiver's LLRs equal to the decode of the port's. (The LDPC decoder is
    held to the JAX one bit for bit in ``test_torch_ldpc.py``.)"""
    jl, tl = jpresets.mimo_ofdm_link(), presets.mimo_ofdm_link(device=CPU)
    assert tl.n_symbols == jl.n_symbols == 81
    assert (tl.payload_bits, tl.ldpc_iters, tl.rows, tl.wire_bits) == (
        jl.payload_bits, jl.ldpc_iters, jl.rows, jl.wire_bits)
    rng = np.random.default_rng(8)
    pay = rng.integers(0, 2, (1, tl.payload_bits)).astype(np.int32)
    wire = tl.frame(_t(pay))
    wa, wb = jl.chain.tx(jnp.asarray(wire.numpy()))
    za, zb = (np.asarray(w[0]) + 1j * np.asarray(w[1]) for w in (wa, wb))
    ta, tb = tl.tx(_t(pay))
    for got, want in zip(ta + tb, (za.real, za.imag, zb.real, zb.imag)):
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    y = []
    for ga, pa, gb, pb in [(1.0, 0.3, 0.6, -1.2), (0.5, 2.0, 0.9, 0.8)]:
        z = ga * np.exp(1j * pa) * za + gb * np.exp(1j * pb) * zb
        s = np.sqrt(np.mean(np.abs(z) ** 2) / 10 ** 1.2 / 2)
        z = z + s * (rng.standard_normal(z.shape)
                     + 1j * rng.standard_normal(z.shape))
        y += [z.real.astype(np.float32), z.imag.astype(np.float32)]
    nv = float(np.mean(y[0] ** 2 + y[1] ** 2)) / 10 ** 1.2
    jllr = np.asarray(jl.chain.rx_soft(tuple(jnp.asarray(x) for x in y),
                                       jl.n_symbols, noise_var=nv))
    tllr = tl.chain.rx_soft(tuple(_t(x) for x in y), tl.n_symbols,
                            noise_var=nv)
    _check_llr(tllr, jllr)
    out, ok = tl.rx(tuple(_t(x) for x in y), nv)
    jout, jok = tl.decode(_t(jllr))
    assert torch.equal(out, jout) and torch.equal(ok, jok)
    assert ok.all() and np.array_equal(out.numpy(), pay)


# ---- N x N ----

@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8])
def test_cinv_h_equals_jax_and_numpy(n):
    """The recursive Schur inverse of a Hermitian PD matrix against the JAX
    one and ``np.linalg.inv`` (float64), at the JAX test's tolerance."""
    rng = np.random.default_rng(n)
    b = rng.normal(0, 1, (64, n, n)) + 1j * rng.normal(0, 1, (64, n, n))
    a = np.einsum("bij,bkj->bik", b, b.conj()) + np.eye(n)
    ar, ai = a.real.astype(np.float32), a.imag.astype(np.float32)
    got = mimo._cinv_h((_t(ar), _t(ai)), n)
    jr, ji = jmimo._cinv_h((jnp.asarray(ar), jnp.asarray(ai)), n)
    want = np.linalg.inv(a)
    for g, j, w in zip(got, (jr, ji), (want.real, want.imag)):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, rtol=2e-3, atol=2e-4)
        np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=2e-3,
                                   atol=2e-4)


def test_small_complex_helpers_equal_jax():
    rng = np.random.default_rng(9)
    a = tuple(rng.normal(0, 1, (5, 3, 4)).astype(np.float32)
              for _ in range(2))
    b = tuple(rng.normal(0, 1, (5, 4, 2)).astype(np.float32)
              for _ in range(2))
    ta, tb = tuple(map(_t, a)), tuple(map(_t, b))
    ja, jb = tuple(map(jnp.asarray, a)), tuple(map(jnp.asarray, b))
    for got, want in ((mimo._cmm(ta, tb), jmimo._cmm(ja, jb)),
                      (mimo._chermt(ta), jmimo._chermt(ja)),
                      (mimo._csub(ta, ta), jmimo._csub(ja, ja))):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                       rtol=1e-5)


@pytest.mark.parametrize("name", N_CASES)
def test_nxn_tx_detect_and_llrs_equal(runs, name):
    """4x4 ZF noiseless (QPSK), 4x4 MMSE at 45 dB (16-QAM) and 2 streams
    into 3 antennas at 25 dB: the waveforms, decision points, weights, hard
    bits and LLRs equal the JAX detector's; every bit right."""
    nt, _, scheme, _, nv, _ = N_CASES[name]
    _, tm = _pair_n(nt, scheme)
    run = runs[name]
    for got, want in zip(tm.tx(_t(run["bits"])), run["wave"]):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    yi, yq = (_t(x) for x in run["rx"])
    _check_detect(tm.detect(yi, yq, S, nv), run["det"])
    np.testing.assert_array_equal(tm.rx_frame(yi, yq, S, noise_var=nv)
                                  .numpy(), run["hard"])
    np.testing.assert_array_equal(run["hard"], run["bits"])
    _check_llr(tm.rx_soft_frame(yi, yq, S, noise_var=max(nv, 1e-4)),
               run["llr"])


def test_nt2_matches_the_2x2_class(runs):
    """``MimoOfdmN(nt=2)`` and ``MimoOfdm``: the same waveforms, and the same
    decision points and weights to the JAX test's tolerance."""
    _, m2 = _pair()
    _, mn = _pair_n(2)
    run = runs["qpsk"]
    bits = _t(run["bits"])
    ti, tq = mn.tx(bits)
    wa, wb = m2.tx(bits)
    assert torch.equal(ti[..., 0, :], wa[0]) and torch.equal(tq[..., 1, :],
                                                            wb[1])
    y = [_t(x) for x in run["rx"]]
    got = mn.detect(torch.stack([y[0], y[2]], -2),
                    torch.stack([y[1], y[3]], -2), S, noise_var=1e-3)
    want = m2.detect(*y, S, noise_var=1e-3)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-3, atol=1e-3)


def test_refusals():
    """``nr < nt``, ``nt < 1`` and a slot count that does not fill the
    streams: refused as the JAX package refuses them."""
    jm, tm = _pair_n(4)
    y = torch.zeros((1, 3, tm.frame_len(S)))
    with pytest.raises(ValueError, match="nr >= nt"):
        tm.rx_frame(y, y, S)
    with pytest.raises(ValueError, match="nr >= nt"):
        jm.rx_frame(jnp.asarray(y.numpy()), jnp.asarray(y.numpy()), S)
    with pytest.raises(ValueError, match="nt must be >= 1"):
        MimoOfdmN(make_scheme("qpsk", Rates(1250, 10000)), nt=0, device=CPU)
    with pytest.raises(ValueError, match="divide by 4"):
        tm.tx(torch.zeros((1, 2 * tm.m.bits_per_sym), dtype=torch.int32))
    _, t2 = _pair()
    with pytest.raises(ValueError, match="even number"):
        t2.tx(torch.zeros((1, t2.m.bits_per_sym), dtype=torch.int32))


@pytest.mark.parametrize("build", [
    lambda: MimoOfdm(make_scheme("qpsk", Rates(1250, 10000))),
    lambda: MimoOfdmN(make_scheme("qpsk", Rates(1250, 10000))),
    lambda: presets.mimo_ofdm_link(),
], ids=["MimoOfdm", "MimoOfdmN", "mimo_ofdm_link"])
def test_device_none_is_the_card(build, monkeypatch):
    """``device=None`` means CUDA; without a CUDA device the entry points
    raise and build nothing on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build()
