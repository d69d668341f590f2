"""Frequency hopping in the port (``modem_tpu_torch.fhss``) against the JAX
package on the same numpy inputs, on the CPU. The cases mirror
``tests/test_fhss.py``; the noise and the jammer are made once by JAX and
passed to both packages as numpy.

Tolerances: decided bits, the hop selections (the port's scatter and gather
against the JAX one-hot einsums) and the calibrated group delay equal; the
wideband waveforms and the calibrated passband gain within 2e-5 absolute
plus 2e-5 relative. Each JAX run is made once, in a module fixture.
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
from modem_tpu.fhss import FhssModem as JFhssModem
from modem_tpu.ops.channel import awgn as jawgn

from modem_tpu_torch import (DsssChain, FhssModem, PulseShapedChain, Rates,
                             make_scheme)

torch.set_num_threads(1)

CPU = "cpu"
TOL = 2e-5
RATES = Rates(baud_rate=1250, sample_rate=10000)
JRATES = JRates(baud_rate=1250, sample_rate=10000)
HOP = [3, 6, 1, 4, 6, 2]
HOP2 = [3, 5, 1, 5, 6, 2]  # dwells 1 and 3 on the jammed channel


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def _equal(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.array_equal(got, want)


def _t(a):
    return torch.tensor(np.asarray(a))


def _modems(name="qpsk", hop=HOP, dwell=32):
    j = JFhssModem(JPulseShapedChain(jscheme(name, JRATES), JRATES), m=8,
                   hop_seq=hop, dwell_symbols=dwell)
    t = FhssModem(PulseShapedChain(make_scheme(name, RATES), RATES,
                                   device=CPU),
                  m=8, hop_seq=hop, dwell_symbols=dwell)
    return j, t


def _hybrid():
    j = JFhssModem(JDsssChain(jscheme("qpsk", JRATES), JRATES, 8), m=8,
                   hop_seq=[2, 7, 4], dwell_symbols=16)
    t = FhssModem(DsssChain(make_scheme("qpsk", RATES), RATES, 8,
                            device=CPU),
                  m=8, hop_seq=[2, 7, 4], dwell_symbols=16)
    return j, t


def _bits(fm, channels=2, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2, (channels, fm.bits_per_frame())).astype(
        np.int32)


def _jam(fm, wi, wq, channel, power=10.0):
    """CW tone at a channel's center frequency in the wideband domain."""
    p = float(jnp.mean(wi * wi + wq * wq)) * fm.m  # avg power per sample
    amp = np.sqrt(power * p)
    n = jnp.arange(wi.shape[-1], dtype=jnp.float32)
    th = 2.0 * np.pi * channel / fm.m * n + 1.1
    return wi + amp * jnp.cos(th), wq + amp * jnp.sin(th)


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX package's wideband streams, captures, calibration and bits
    for every case below."""
    out = {}

    def run(tag, fm, seed, capture=None):
        bits = _bits(fm, seed=seed)
        wi, wq = fm.tx(jnp.asarray(bits))
        ci, cq = (wi, wq) if capture is None else capture(fm, wi, wq)
        out[tag] = {"bits": bits, "wi": np.asarray(wi), "wq": np.asarray(wq),
                    "ci": np.asarray(ci), "cq": np.asarray(cq),
                    "out": np.asarray(fm.rx(ci, cq)), "cal": fm._calibrate(),
                    "dwell_len": fm._dwell_len}

    for name in ("qpsk", "qam16"):
        run(name, _modems(name)[0], 0)
    run("awgn", _modems()[0], 1,
        lambda fm, wi, wq: jawgn(jax.random.PRNGKey(2), wi, wq, 25.0))
    run("jam_avoided", _modems()[0], 3,
        lambda fm, wi, wq: _jam(fm, wi, wq, channel=5))
    run("jam_hit", _modems(hop=HOP2)[0], 4,
        lambda fm, wi, wq: _jam(fm, wi, wq, channel=5))
    run("hybrid", _hybrid()[0], 9)
    return out


class TestFhss:
    @pytest.mark.parametrize("name", ["qpsk", "qam16"])
    def test_noiseless_roundtrip_exact(self, jax_runs, name):
        want = jax_runs[name]
        _, fm = _modems(name)
        assert fm._dwell_len == want["dwell_len"]
        wi, wq = fm.tx(_t(want["bits"]))
        assert wi.shape[-1] == fm.m * fm.n_dwells * fm._dwell_len
        _close(wi, want["wi"])
        _close(wq, want["wq"])
        out = fm.rx(wi, wq)
        _equal(out, want["bits"])
        _equal(out, want["out"])

    def test_calibration_equals_the_jax_package(self, jax_runs):
        _, fm = _modems()
        delay, gi, gq = fm._calibrate()
        jdelay, jgi, jgq = jax_runs["qpsk"]["cal"]
        assert delay == jdelay
        _close([gi, gq], [jgi, jgq])
        assert fm._calibrate() is fm._cal

    def test_awgn_exact(self, jax_runs):
        want = jax_runs["awgn"]
        _, fm = _modems()
        out = fm.rx(_t(want["ci"]), _t(want["cq"]))
        _equal(out, want["out"])
        _equal(out, want["bits"])

    def test_partial_band_jammer_selectivity(self, jax_runs):
        """A 10x CW jammer parked on channel 5: the schedule that avoids
        it decodes exactly; a schedule that dwells there loses exactly
        those dwells."""
        want = jax_runs["jam_avoided"]
        _, fm = _modems()  # HOP avoids channel 5
        out = fm.rx(_t(want["ci"]), _t(want["cq"]))
        _equal(out, want["bits"])

        want = jax_runs["jam_hit"]
        _, fm2 = _modems(hop=HOP2)
        out2 = fm2.rx(_t(want["ci"]), _t(want["cq"])).numpy()
        _equal(out2, want["out"])
        errs = (out2 != want["bits"]).reshape(
            2, fm2.n_dwells, fm2.bits_per_dwell).sum(-1)
        assert np.all(errs[:, [1, 3]] > 5)       # jammed dwells die
        assert np.all(errs[:, [0, 2, 4, 5]] == 0)  # others untouched

    def test_hybrid_ds_fh_spread_spectrum(self, jax_runs):
        """FHSS over a DSSS chain: the hopper probes the wrapped chain's
        actual waveform length instead of assuming the pulse-shaped
        formula."""
        want = jax_runs["hybrid"]
        _, fm = _hybrid()
        assert fm._dwell_len == want["dwell_len"]
        wi, wq = fm.tx(_t(want["bits"]))
        _close(wi, want["wi"])
        _close(wq, want["wq"])
        out = fm.rx(wi, wq)
        _equal(out, want["bits"])
        _equal(out, want["out"])

    @pytest.mark.parametrize("batch", [(), (3,)])
    def test_hop_scatter_and_gather_equal_the_einsums(self, batch):
        """The modem's indexed scatter (TX) and gather (RX) pick the same
        values as the JAX package's one-hot einsums, bit for bit."""
        _, fm = _modems()
        m, d, t = fm.m, fm.n_dwells, fm._dwell_len
        onehot = np.zeros((d, m), np.float32)
        onehot[np.arange(d), HOP] = 1.0
        rng = np.random.default_rng(7)
        s = rng.normal(size=batch + (d, t)).astype(np.float32)
        s[..., fm._wave_len:] = 0.0  # the guard
        want = np.asarray(jnp.einsum("...dt,dm->...mdt", jnp.asarray(s),
                                     jnp.asarray(onehot)))
        got = fm._scatter(_t(s[..., :fm._wave_len]))
        # equal values (the einsum's products by 0 may be -0.0)
        np.testing.assert_array_equal(got.numpy(), want)
        y = rng.normal(size=batch + (m, d, t)).astype(np.float32)
        want = np.asarray(jnp.einsum("...mdt,dm->...dt", jnp.asarray(y),
                                     jnp.asarray(onehot)))
        _equal(fm._gather(_t(y)), want)

    def test_validation(self):
        chain = PulseShapedChain(make_scheme("qpsk", RATES), RATES,
                                 device=CPU)
        with pytest.raises(ValueError):
            FhssModem(chain, m=8, hop_seq=[9], dwell_symbols=8)
        with pytest.raises(ValueError):
            FhssModem(chain, m=8, hop_seq=[], dwell_symbols=8)
        _, fm = _modems()
        with pytest.raises(ValueError):
            fm.tx(torch.zeros((1, 7), dtype=torch.int32))
        assert fm.bank.device == chain.lut.device
