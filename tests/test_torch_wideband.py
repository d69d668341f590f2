"""The single-device WidebandModem in the port (``modem_tpu_torch.wideband``)
against the JAX package on the same numpy inputs, on the CPU (where the
chain's pulse shaping and the receiver's matched filter take K4's plain
version). The cases mirror ``tests/test_wideband.py``'s solo modem; the
meshed modem is in ``tests/test_torch_parallel_channelizer.py``. The
front end's impairments and noise are made once by JAX and passed to the
port as numpy.

Tolerances: payload bits equal; the wideband waveform within 2e-5 absolute
plus 2e-5 relative (the bar the JAX test holds its meshed modem to, for a
different order of summation). Each JAX run is made once, in a module
fixture.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from modem_tpu import Rates as JRates
from modem_tpu import qpsk_reference_chain as jchain_of
from modem_tpu.ops.channel import awgn as jawgn
from modem_tpu.ops.impairments import apply_cfo, apply_gain_phase
from modem_tpu.sync import AcquiringReceiver as JAcquiringReceiver
from modem_tpu.wideband import WidebandModem as JWidebandModem

from modem_tpu_torch import (AcquiringReceiver, Rates, WidebandModem,
                             qpsk_reference_chain)

torch.set_num_threads(1)

CPU = "cpu"
TOL = 2e-5
RATES = Rates(baud_rate=1250, sample_rate=10000)
JRATES = JRates(baud_rate=1250, sample_rate=10000)
PRE = np.array([0, 1, 3, 2, 2, 0, 1, 1, 3, 0, 2, 3, 0, 0, 1, 2,
                3, 3, 1, 0, 2, 1, 0, 2, 1, 3, 2, 2, 0, 3, 1, 0])


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def _equal(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.array_equal(got, want)


def _t(a):
    return torch.tensor(np.asarray(a))


def _jmodem(m, n_payload):
    rxr = JAcquiringReceiver(jchain_of(JRATES), PRE, max_lag=200)
    return JWidebandModem(rxr, m, n_payload)


def _modem(m, n_payload):
    rxr = AcquiringReceiver(qpsk_reference_chain(RATES, device=CPU), PRE,
                            max_lag=200)
    return WidebandModem(rxr, m, n_payload)


def _bits(m, n_payload, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2, (m, n_payload * 2)).astype(np.int32)


@pytest.fixture(scope="module")
def jax_runs():
    out = {}
    m, n_payload = 16, 128
    solo = _jmodem(m, n_payload)
    bits = _bits(m, n_payload, 0)
    wi, wq = solo.tx(jnp.asarray(bits))
    out["clean"] = {"bits": bits, "wi": np.asarray(wi), "wq": np.asarray(wq),
                    "out": np.asarray(solo.rx(wi, wq)),
                    "window": solo.window}
    # the whole bank tilts together (one analog front end): CFO + gain +
    # AWGN on the wideband stream
    m, n_payload = 8, 96
    solo = _jmodem(m, n_payload)
    bits = _bits(m, n_payload, 1)
    wi, wq = solo.tx(jnp.asarray(bits))
    wi, wq = apply_cfo(wi, wq, 3.0, JRATES.sample_rate * m, phase0=0.4)
    wi, wq = apply_gain_phase(wi, wq, gain=0.9)
    wi, wq = jawgn(jax.random.key(2), wi, wq, snr_db=28.0)
    out["front_end"] = {"bits": bits, "wi": np.asarray(wi),
                        "wq": np.asarray(wq),
                        "out": np.asarray(solo.rx(wi, wq))}
    return out


class TestWidebandModem:
    def test_roundtrip_exact(self, jax_runs):
        want = jax_runs["clean"]
        m, n_payload = 16, 128
        solo = _modem(m, n_payload)
        assert solo.window == want["window"]
        wi, wq = solo.tx(_t(want["bits"]))
        assert wi.shape[-1] == m * solo.window
        _close(wi, want["wi"])
        _close(wq, want["wq"])
        out = solo.rx(wi, wq)
        _equal(out, want["bits"])
        _equal(out, want["out"])

    def test_exact_through_front_end_impairments(self, jax_runs):
        want = jax_runs["front_end"]
        solo = _modem(8, 96)
        out = solo.rx(_t(want["wi"]), _t(want["wq"]))
        _equal(out, want["out"])
        _equal(out, want["bits"])

    @pytest.mark.parametrize("m,n_payload,taps", [(8, 64, 12), (16, 96, 6),
                                                  (4, 200, 12)])
    def test_listen_window_equals_the_jax_package(self, m, n_payload, taps):
        rxr = AcquiringReceiver(qpsk_reference_chain(RATES, device=CPU), PRE,
                                max_lag=200)
        jrxr = JAcquiringReceiver(jchain_of(JRATES), PRE, max_lag=200)
        solo = WidebandModem(rxr, m, n_payload, taps_per_phase=taps)
        want = JWidebandModem(jrxr, m, n_payload, taps_per_phase=taps)
        assert solo.window == want.window
        assert solo._burst_len == want._burst_len
        assert solo.bank.device == rxr.chain.lut.device

    def test_validation(self):
        solo = _modem(8, 64)
        rng = np.random.default_rng(2)
        bad = torch.as_tensor(rng.integers(0, 2, (4, 128)), dtype=torch.int32)
        with pytest.raises(ValueError):
            solo.tx(bad)
        with pytest.raises(TypeError, match="DeviceMesh"):
            WidebandModem(solo.rxr, 8, 64, mesh=object())
