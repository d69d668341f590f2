"""Direct-sequence spread spectrum in the port (``modem_tpu_torch.dsss``)
against the JAX package on the same numpy inputs, on the CPU (where the
chip shaping and the matched filter take K4's plain version). The cases
mirror ``tests/test_dsss.py``; the noise is made once by JAX and passed to
both packages as numpy.

Tolerances: the PN chips and decided bits equal; waveforms and decision
points within 2e-5 absolute plus 2e-5 relative (the correlator's order of
summation); LLRs within 1e-4 relative (of the largest magnitude). Each JAX
run is made once, in a module fixture.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from modem_tpu import Rates as JRates
from modem_tpu import make_scheme as jscheme
from modem_tpu.chain import PulseShapedChain as JPulseShapedChain
from modem_tpu.dsss import DsssChain as JDsssChain
from modem_tpu.ops.channel import awgn as jawgn

from modem_tpu_torch import DsssChain, PulseShapedChain, Rates, make_scheme
from modem_tpu_torch.ops.llr import llr_hard_bits

torch.set_num_threads(1)

CPU = "cpu"
TOL = 2e-5
LLR_TOL = 1e-4
RATES = Rates(baud_rate=1250, sample_rate=10000)  # chip rate; sps=8
JRATES = JRates(baud_rate=1250, sample_rate=10000)


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def _equal(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.array_equal(got, want)


def _bits(bps, n_symbols=64, channels=2, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2, (channels, n_symbols * bps)).astype(np.int32)


def _pair(name, l, **kw):
    return (JDsssChain(jscheme(name, JRATES), JRATES, l, **kw),
            DsssChain(make_scheme(name, RATES), RATES, l, device=CPU, **kw))


def _t(a):
    return torch.tensor(np.asarray(a))


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX package's waveforms, noisy captures, decision points, bits
    and LLRs for every case below."""
    out = {}
    for name, l in (("qpsk", 8), ("qam16", 16), ("bpsk", 31)):
        c, _ = _pair(name, l)
        bits = _bits(c.scheme.bits_per_symbol)
        i, q = c.tx(jnp.asarray(bits))
        out[name] = {"bits": bits, "pn": np.asarray(c.pn),
                     "i": np.asarray(i), "q": np.asarray(q),
                     "out": np.asarray(c.roundtrip(jnp.asarray(bits)))}
    # processing gain at -4 dB chip SNR, L = 16
    c, _ = _pair("qpsk", 16)
    bits = _bits(2, n_symbols=128, seed=1)
    i, q = c.tx(jnp.asarray(bits))
    ni, nq = jawgn(jax.random.PRNGKey(2), i, q, -4.0)
    di, dq = c._despread(ni, nq, 128)
    out["gain"] = {"bits": bits, "ni": np.asarray(ni), "nq": np.asarray(nq),
                   "di": np.asarray(di), "dq": np.asarray(dq),
                   "out": np.asarray(c.rx((ni, nq), 128))}
    # the 10x CW jammer at L = 32
    c, _ = _pair("qpsk", 32)
    bits = _bits(2, n_symbols=64, seed=4)
    i, q = c.tx(jnp.asarray(bits))
    p = float(jnp.mean(i * i + q * q))
    amp = np.sqrt(10.0 * p)
    n = jnp.arange(i.shape[-1], dtype=jnp.float32)
    th = 2.0 * np.pi * 0.013 * n + 0.7
    ji, jq = i + amp * jnp.cos(th), q + amp * jnp.sin(th)
    out["jam"] = {"bits": bits, "ji": np.asarray(ji), "jq": np.asarray(jq),
                  "out": np.asarray(c.rx((ji, jq), 64)), "amp": amp,
                  "th": np.asarray(th)}
    # soft output at -2 dB, L = 16
    c, _ = _pair("qpsk", 16)
    bits = _bits(2, seed=5)
    i, q = c.tx(jnp.asarray(bits))
    ni, nq = jawgn(jax.random.PRNGKey(6), i, q, -2.0)
    out["soft"] = {"bits": bits, "ni": np.asarray(ni), "nq": np.asarray(nq),
                   "hard": np.asarray(c.rx((ni, nq), 64)),
                   "llr": np.asarray(c.rx_soft((ni, nq), 64,
                                               noise_var=0.5))}
    return out


class TestDsss:
    @pytest.mark.parametrize("name,l", [("qpsk", 8), ("qam16", 16),
                                        ("bpsk", 31)])
    def test_noiseless_roundtrip_exact(self, jax_runs, name, l):
        want = jax_runs[name]
        _, c = _pair(name, l)
        _equal(c.pn, want["pn"])
        bits = _t(want["bits"])
        i, q = c.tx(bits)
        _close(i, want["i"])
        _close(q, want["q"])
        out = c.roundtrip(bits)
        _equal(out, want["bits"])
        _equal(out, want["out"])

    def test_awgn_processing_gain(self, jax_runs):
        """At a chip SNR where the unspread chain fails, L=16 spreading
        decodes exactly (the correlator averages chip noise by L)."""
        want = jax_runs["gain"]
        _, spread = _pair("qpsk", 16)
        ni, nq = _t(want["ni"]), _t(want["nq"])
        di, dq = spread._despread(ni, nq, 128)
        _close(di, want["di"])
        _close(dq, want["dq"])
        out = spread.rx((ni, nq), 128)
        _equal(out, want["out"])
        _equal(out, want["bits"])

        # unspread at the same chip SNR: ~4% BER (noise made here, seeded)
        plain = PulseShapedChain(make_scheme("qpsk", RATES), RATES,
                                 device=CPU)
        bits = _t(want["bits"])
        pi, pq = plain.tx(bits)
        p = float((pi * pi + pq * pq).mean())
        sigma = np.sqrt(p / 10.0 ** (-4.0 / 10.0) / 2.0)
        g = torch.Generator().manual_seed(3)
        npi = pi + sigma * torch.randn(pi.shape, generator=g)
        npq = pq + sigma * torch.randn(pq.shape, generator=g)
        pout = plain.rx((npi, npq), bits.shape[-1] // 2)
        assert int((pout != bits).sum()) > 15

    def test_narrowband_jammer_rejection(self, jax_runs):
        """A CW tone 10x the signal power: catastrophic for the plain
        chain, rejected by the correlator's processing gain."""
        want = jax_runs["jam"]
        _, c = _pair("qpsk", 32)
        out = c.rx((_t(want["ji"]), _t(want["jq"])), 64)
        _equal(out, want["out"])
        _equal(out, want["bits"])

        plain = PulseShapedChain(make_scheme("qpsk", RATES), RATES,
                                 device=CPU)
        bits = _t(want["bits"])
        pi, pq = plain.tx(bits)
        th = _t(want["th"][: pi.shape[-1]])
        pj = pi + want["amp"] * torch.cos(th)
        qj = pq + want["amp"] * torch.sin(th)
        pout = plain.rx((pj, qj), bits.shape[-1] // 2)
        assert int((pout != bits).sum()) > 100

    def test_soft_signs_and_validation(self, jax_runs):
        want = jax_runs["soft"]
        _, c = _pair("qpsk", 16)
        wave = (_t(want["ni"]), _t(want["nq"]))
        hard = c.rx(wave, 64)
        _equal(hard, want["hard"])
        llr = c.rx_soft(wave, 64, noise_var=0.5)
        scale = float(np.abs(want["llr"]).max())
        np.testing.assert_allclose(llr.numpy(), want["llr"],
                                   atol=LLR_TOL * scale, rtol=0)
        _equal(llr_hard_bits(llr), hard)
        with pytest.raises(ValueError):
            DsssChain(make_scheme("qpsk", RATES), RATES, 1, device=CPU)
        with pytest.raises(ValueError):
            DsssChain(make_scheme("qpsk", RATES), RATES, 8,
                      pn=np.zeros(8), device=CPU)
        with pytest.raises(TypeError):
            DsssChain(make_scheme("mfsk", RATES), RATES, 8, device=CPU)

    def test_explicit_pn_and_seed(self):
        barker = np.array([1, 1, 1, -1, -1, -1, 1, -1, -1, 1, -1])
        jc, c = _pair("qpsk", 11, pn=barker)
        _equal(c.pn, np.asarray(jc.pn))
        for seed in (0, 7, 123):
            jc, c = _pair("bpsk", 13, seed=seed)
            _equal(c.pn, np.asarray(jc.pn))
            _equal(c.rrc, np.asarray(jc.rrc, np.float32))

    def test_device_none_needs_the_card(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            DsssChain(make_scheme("qpsk", RATES), RATES, 8)
