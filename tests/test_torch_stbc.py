"""The port's Alamouti 2x1 STBC over OFDM (``modem_tpu_torch.stbc``:
``AlamoutiOfdm`` and its ``FramedLink`` adapter) against the JAX package on
the same numpy inputs, on the CPU.

Tolerances: tables equal; antenna waveforms within 1e-5 absolute (unit
power); combined decision points within 1e-4 and the diversity gain within
1e-4 relative; LLRs within 1e-4 of their largest magnitude; hard bits and
the LDPC link's payloads and verdicts exactly. The JAX receivers run once per
case, jitted together, in a module fixture.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from modem_tpu import Rates as JRates
from modem_tpu import stbc as jstbc
from modem_tpu.fec import QcLdpc as JQcLdpc
from modem_tpu.link import FramedLink as JFramedLink
from modem_tpu.models import make_scheme as jscheme

from modem_tpu_torch import AlamoutiOfdm, FramedLink, Rates, make_scheme
from modem_tpu_torch.fec import QcLdpc

torch.set_num_threads(1)

CPU = "cpu"
P = 3             # Alamouti pairs a frame
NV = 1e-2
SCHEMES = ("qpsk", "qam16")
# two channels with deep nulls at different bins
CH_A = (np.array([0.9, 0.0, 0.25, 0.0, -0.1], np.float32),
        np.array([0.1, -0.3, 0.0, 0.12, 0.05], np.float32))
CH_B = (np.array([0.8, 0.3, 0.0, -0.15, 0.0], np.float32),
        np.array([0.0, 0.1, -0.25, 0.0, 0.1], np.float32))


def _stbcs(scheme="qpsk", **kw):
    return (jstbc.AlamoutiOfdm(jscheme(scheme, JRates(1250, 10000)), **kw),
            AlamoutiOfdm(make_scheme(scheme, Rates(1250, 10000)),
                         device=CPU, **kw))


def _t(x):
    return torch.as_tensor(np.array(x))


def _fir(i, q, ch):
    h = ch[0].astype(np.float64) + 1j * ch[1]
    z = i.astype(np.float64) + 1j * q
    return np.stack([np.convolve(r, h)[:z.shape[-1]] for r in z])


def _through(wa, wb, rng, sigma):
    """Antenna A through CH_A plus antenna B through CH_B, and noise."""
    y = _fir(*wa, CH_A) + _fir(*wb, CH_B)
    y += sigma * (rng.standard_normal(y.shape)
                  + 1j * rng.standard_normal(y.shape))
    return y.real.astype(np.float32), y.imag.astype(np.float32)


@pytest.fixture(scope="module")
def runs():
    out = {}
    for k, name in enumerate(SCHEMES):
        js, _ = _stbcs(name)
        rng = np.random.default_rng(k)
        bits = rng.integers(0, 2, (2, js.bits_per_frame(P))).astype(np.int32)
        wa, wb = js.tx(jnp.asarray(bits))
        wa = tuple(np.asarray(x) for x in wa)
        wb = tuple(np.asarray(x) for x in wb)
        ci, cq = _through(wa, wb, rng, 0.02)
        pts, hard, llr = jax.jit(lambda *c: (
            js.decision_points(*c, P), js.rx(*c, P),
            js.rx_soft(*c, P, noise_var=NV)))(jnp.asarray(ci),
                                                jnp.asarray(cq))
        out[name] = dict(bits=bits, wave=wa + wb, rx=(ci, cq),
                         points=tuple(np.asarray(x) for x in pts),
                         hard=np.asarray(hard), llr=np.asarray(llr))
    return out


@pytest.mark.parametrize("name", SCHEMES)
def test_tables_equal(name):
    """The inner pilotless modem's tables and the frame geometry."""
    js, ts = _stbcs(name)
    for attr in ("_rx_c", "_rx_s", "_rx_cd", "_rx_sd", "_ltf_vals",
                 "_stf_ti", "_stf_tq", "_ltf_ti", "_ltf_tq", "_tx_c",
                 "_tx_s", "lut"):
        np.testing.assert_array_equal(getattr(ts.m, attr),
                                      np.asarray(getattr(js.m, attr)))
    assert ts.m.data_bins == js.m.data_bins and ts.m.pilot_bins == ()
    for attr in ("bits_per_pair", "preamble_len"):
        assert getattr(ts, attr) == getattr(js, attr)
    assert ts.frame_len(P) == js.frame_len(P)
    assert ts.bits_per_frame(P) == js.bits_per_frame(P)


@pytest.mark.parametrize("name", SCHEMES)
def test_tx_equal(runs, name):
    _, ts = _stbcs(name)
    run = runs[name]
    wa, wb = ts.tx(_t(run["bits"]))
    for got, want in zip(wa + wb, run["wave"]):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("name", SCHEMES)
def test_combining_and_llrs_equal(runs, name):
    """Through the two dispersive channels with noise: decision points,
    diversity gain, hard bits and LLRs equal the JAX combiner's; every bit
    right."""
    _, ts = _stbcs(name)
    run = runs[name]
    ci, cq = (_t(x) for x in run["rx"])
    di, dq, g = ts.decision_points(ci, cq, P)
    for got, want in zip((di, dq), run["points"][:2]):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
    np.testing.assert_allclose(g.numpy(), run["points"][2], rtol=1e-4)
    np.testing.assert_array_equal(ts.rx(ci, cq, P).numpy(), run["hard"])
    np.testing.assert_array_equal(run["hard"], run["bits"])
    llr = ts.rx_soft(ci, cq, P, noise_var=NV).numpy()
    want = run["llr"]
    assert llr.shape == want.shape == run["bits"].shape
    assert np.abs(llr - want).max() <= 1e-4 * np.abs(want).max()


def test_flat_channels_exact():
    """Each antenna through its own flat gain and phase: the bits back."""
    _, ts = _stbcs("qam16")
    rng = np.random.default_rng(5)
    bits = rng.integers(0, 2, (2, ts.bits_per_frame(P))).astype(np.int32)
    (ai, aq), (bi, bq) = ts.tx(_t(bits))
    za = 0.8 * np.exp(0.5j) * torch.complex(ai, aq).numpy()
    zb = 1.2 * np.exp(-1.0j) * torch.complex(bi, bq).numpy()
    z = za + zb
    out = ts.rx(_t(z.real.astype(np.float32)),
                _t(z.imag.astype(np.float32)), P)
    np.testing.assert_array_equal(out.numpy(), bits)


def test_odd_symbol_count_refused():
    """One OFDM symbol cannot pair: the JAX and the port's ``tx`` refuse
    it."""
    js, ts = _stbcs()
    with pytest.raises(ValueError, match="even number"):
        js.tx(jnp.zeros((1, js.m.bits_per_sym), jnp.int32))
    with pytest.raises(ValueError, match="even number"):
        ts.tx(torch.zeros((1, ts.m.bits_per_sym), dtype=torch.int32))


def test_ldpc_link_over_stbc_equal():
    """``FramedLink`` (CRC, scrambler, QC-LDPC with early exit set on both
    sides, interleaver) over the Alamouti adapter through the double-fade
    pair at 14 dB: 26 codewords fill 81 pairs, as in the JAX link; the
    antenna waveforms equal the JAX modem's on the same wire bits, the LLRs
    the JAX receiver's;
    every payload back with its CRC true, and the decode of the JAX
    receiver's LLRs equal to the decode of the port's. (The LDPC decoder is
    held to the JAX one bit for bit in ``test_torch_ldpc.py``.)"""
    js, ts = _stbcs()
    kw = dict(payload_bits=26 * 324 - 16, ldpc_iters=40, interleave_rows=16,
              ldpc_early_exit=True)
    jl = JFramedLink(js.as_link_chain(), ldpc=JQcLdpc(), **kw)
    tl = FramedLink(ts.as_link_chain(), ldpc=QcLdpc(), **kw)
    assert tl.n_symbols == jl.n_symbols == 81
    rng = np.random.default_rng(23)
    pay = rng.integers(0, 2, (1, tl.payload_bits)).astype(np.int32)
    wire = tl.frame(_t(pay))
    ja, jb = js.tx(jnp.asarray(wire.numpy()))
    ja = tuple(np.asarray(x) for x in ja)
    jb = tuple(np.asarray(x) for x in jb)
    (ta, tb) = tl.tx(_t(pay))
    for got, want in zip(ta + tb, ja + jb):
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    p = float(np.mean(ja[0] ** 2 + ja[1] ** 2))
    sigma = np.sqrt(2 * p / 10.0 ** 1.4 / 2)
    ci, cq = _through(ja, jb, rng, sigma)
    nv = float(sigma ** 2)
    jllr = np.asarray(js.rx_soft(jnp.asarray(ci), jnp.asarray(cq),
                                 tl.n_symbols, noise_var=nv))
    tllr = tl.chain.rx_soft((_t(ci), _t(cq)), tl.n_symbols, noise_var=nv)
    assert np.abs(tllr.numpy() - jllr).max() <= 1e-4 * np.abs(jllr).max()
    out, ok = tl.rx((_t(ci), _t(cq)), nv)
    jout, jok = tl.decode(_t(jllr))
    assert torch.equal(out, jout) and torch.equal(ok, jok)
    assert ok.all() and np.array_equal(out.numpy(), pay)
    np.testing.assert_array_equal(
        tl.chain.rx((_t(ci), _t(cq)), tl.n_symbols).numpy(),
        (tllr < 0).numpy().astype(np.int32))


def test_device_none_is_the_card(monkeypatch):
    """``device=None`` means CUDA; without a CUDA device the entry point
    raises and builds nothing on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AlamoutiOfdm(make_scheme("qpsk", Rates(1250, 10000)))
