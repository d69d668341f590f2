"""The port's SC-FDE PHY (``modem_tpu_torch.scfde``: ``ScFdeModem``,
``ScFdeChain``) against the JAX package on the same numpy inputs, on the CPU
(where the blind acquisition's preamble correlation takes K4's plain version
at 160 taps).

Tolerances: tables equal; ``tx_frame`` waveforms within 1e-5 absolute (unit
power); decision points within 1e-4; LLRs within 1e-4 of their largest
magnitude; hard bits, located starts, the stream receiver's frames and the
coded link's payloads and verdicts exactly. The JAX functions run once per
case, in a module fixture.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from modem_tpu import Rates as JRates
from modem_tpu import OfdmStreamReceiver as JStreamReceiver
from modem_tpu import scfde as jscfde
from modem_tpu.link import FramedLink as JFramedLink
from modem_tpu.models import make_scheme as jscheme

from modem_tpu_torch import (FramedLink, OfdmStreamReceiver, Rates,
                             ScFdeChain, ScFdeModem, make_scheme)
from modem_tpu_torch.ops import fir

torch.set_num_threads(1)

CPU = "cpu"
B = 3             # payload blocks a frame
MAX_LAG = 64
SCHEMES = ("qpsk", "qam16", "bpsk")
# a CP-short dispersive channel with a deep in-band null
CH_I = np.array([1.0, 0.0, 0.0, -0.85], np.float32)
CH_Q = np.array([0.0, 0.25, 0.0, 0.1], np.float32)


def _modems(scheme="qpsk", **kw):
    return (jscfde.ScFdeModem(jscheme(scheme, JRates(1250, 10000)), **kw),
            ScFdeModem(make_scheme(scheme, Rates(1250, 10000)), device=CPU,
                       **kw))


def _t(x):
    return torch.as_tensor(np.array(x))


def _channel(i, q, rng, sigma):
    """The nulled channel (a causal complex FIR) and Gaussian noise."""
    h = CH_I.astype(np.float64) + 1j * CH_Q
    z = i.astype(np.float64) + 1j * q
    y = np.stack([np.convolve(r, h)[:z.shape[-1]] for r in z])
    y += sigma * (rng.standard_normal(y.shape)
                  + 1j * rng.standard_normal(y.shape))
    return y.real.astype(np.float32), y.imag.astype(np.float32)


def _capture(i, q, offsets, rng, cfo=0.3 / 80, sigma=0.03):
    """Each frame at its offset in a zero capture, through the nulled
    channel, rotated by a gain, a phase and a CFO (cycles/sample)."""
    b, t = i.shape
    ci = np.zeros((b, MAX_LAG + t + 20), np.float32)
    cq = np.zeros_like(ci)
    for r in range(b):
        ci[r, offsets[r]:offsets[r] + t] = i[r]
        cq[r, offsets[r]:offsets[r] + t] = q[r]
    ci, cq = _channel(ci, cq, rng, 0.0)
    n = np.arange(ci.shape[-1])
    z = 1.3 * (ci + 1j * cq) * np.exp(1j * (2 * np.pi * cfo * n - 1.1))
    z += sigma * (rng.standard_normal(z.shape)
                  + 1j * rng.standard_normal(z.shape))
    return z.real.astype(np.float32), z.imag.astype(np.float32)


@pytest.fixture(scope="module")
def runs():
    out = {}
    for k, name in enumerate(SCHEMES):
        jm, _ = _modems(name)
        rng = np.random.default_rng(k)
        bits = rng.integers(0, 2, (2, jm.bits_per_frame(B))).astype(np.int32)
        wi, wq = (np.asarray(v) for v in jm.tx_frame(jnp.asarray(bits)))
        ni, nq = _channel(wi, wq, rng, 0.05)
        nv = 2 * 0.05 ** 2
        p = jm.preamble_len
        h = jm.estimate_channel(jnp.asarray(ni[:, :p]), jnp.asarray(nq[:, :p]))
        di, dq, mse = jm._equalize(jnp.asarray(ni[:, p:]),
                                   jnp.asarray(nq[:, p:]), B, h, nv)
        run = dict(
            bits=bits, wave=(wi, wq), noisy=(ni, nq), nv=nv,
            h=tuple(np.asarray(x) for x in h),
            points=tuple(np.asarray(x) for x in (di, dq, mse)),
            hard_zf=np.asarray(jm.rx_frame(jnp.asarray(ni), jnp.asarray(nq),
                                           B)),
            hard=np.asarray(jm.rx_frame(jnp.asarray(ni), jnp.asarray(nq), B,
                                        nv)),
            llr=np.asarray(jm.rx_soft_frame(jnp.asarray(ni), jnp.asarray(nq),
                                            B, nv)))
        if name == "qpsk":
            offsets = (0, 41)
            ci, cq = _capture(wi, wq, offsets, rng)
            jb, jrep = jm.acquire(jnp.asarray(ci), jnp.asarray(cq), B,
                                  MAX_LAG, noise_var=0.005)
            run.update(capture=(ci, cq), offsets=offsets,
                       acq_bits=np.asarray(jb),
                       acq_start=np.asarray(jrep["start"]),
                       acq_cfo=np.asarray(jrep["cfo_rad_per_sample"]))
        out[name] = run
    return out


@pytest.mark.parametrize("name", SCHEMES)
def test_tables_equal(name):
    """The tables carried across: the unitary DFT, the Zadoff–Chu block,
    its spectrum and the preamble template."""
    jm, tm = _modems(name)
    for attr in ("_c", "_s", "_zc_i", "_zc_q", "_zf_i", "_zf_q", "_zf_m2",
                 "_preamble_i", "_preamble_q", "lut"):
        np.testing.assert_array_equal(getattr(tm, attr),
                                      np.asarray(getattr(jm, attr)))
    assert tm._es == jm._es
    for attr in ("n", "cp", "sym_len", "n_ltf", "preamble_len",
                 "bits_per_symbol"):
        assert getattr(tm, attr) == getattr(jm, attr), attr
    assert tm.frame_len(B) == jm.frame_len(B)
    assert tm.bits_per_frame(B) == jm.bits_per_frame(B)


@pytest.mark.parametrize("name", SCHEMES)
def test_tx_frame_equal(runs, name):
    _, tm = _modems(name)
    run = runs[name]
    for got, want in zip(tm.tx_frame(_t(run["bits"])), run["wave"]):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("name", SCHEMES)
def test_equalizer_and_soft_output_equal(runs, name):
    """Through the nulled channel with noise: the channel estimate, the
    MMSE decision points and error variance, the LLRs, and the hard bits
    (MMSE and zero-forcing) equal the JAX modem's; QPSK and BPSK decode
    clean."""
    _, tm = _modems(name)
    run = runs[name]
    ni, nq = (_t(x) for x in run["noisy"])
    p = tm.preamble_len
    h = tm.estimate_channel(ni[:, :p], nq[:, :p])
    for got, want in zip(h, run["h"]):
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    pts = tm._equalize(ni[:, p:], nq[:, p:], B, h, run["nv"])
    for got, want in zip(pts[:2], run["points"][:2]):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
    np.testing.assert_allclose(pts[2].numpy(), run["points"][2], rtol=1e-4)
    llr = tm.rx_soft_frame(ni, nq, B, run["nv"]).numpy()
    want = run["llr"]
    assert llr.shape == want.shape
    assert np.abs(llr - want).max() <= 1e-4 * np.abs(want).max()
    np.testing.assert_array_equal(tm.rx_frame(ni, nq, B, run["nv"]).numpy(),
                                  run["hard"])
    np.testing.assert_array_equal(tm.rx_frame(ni, nq, B).numpy(),
                                  run["hard_zf"])
    if name != "qam16":  # 16-QAM keeps a few errors at this noise
        np.testing.assert_array_equal(run["hard"], run["bits"])


def test_acquire_equal(runs):
    """Blind acquisition through the nulled channel under an offset, a gain,
    a phase and a CFO: starts and bits equal the JAX modem's (and the sent
    ones), the CFO estimate within 1e-6 rad/sample of it."""
    _, tm = _modems()
    run = runs["qpsk"]
    ci, cq = (_t(c) for c in run["capture"])
    bits, rep = tm.acquire(ci, cq, B, MAX_LAG, noise_var=0.005)
    np.testing.assert_array_equal(rep["start"].numpy(), run["acq_start"])
    np.testing.assert_array_equal(rep["start"].numpy(), run["offsets"])
    np.testing.assert_array_equal(bits.numpy(), run["acq_bits"])
    np.testing.assert_array_equal(bits.numpy(), run["bits"])
    np.testing.assert_allclose(rep["cfo_rad_per_sample"].numpy(),
                               run["acq_cfo"], atol=1e-6, rtol=0)
    assert (rep["sc_peak"] > 0.6).all()


def test_acquire_runs_k4_plain_at_160_taps(runs, monkeypatch):
    """The fine timing is four FIR passes of the 160-tap reversed preamble
    (two CP'd training blocks): on the CPU, K4's plain version; its generic
    route on the card."""
    _, tm = _modems()
    seen = []
    plain = fir.fir_plain
    monkeypatch.setattr(fir, "fir_plain", lambda x, taps, state: (
        seen.append(taps.shape[0]) or plain(x, taps, state)))
    ci, cq = (_t(c) for c in runs["qpsk"]["capture"])
    tm.acquire(ci, cq, B, MAX_LAG)
    assert seen == [tm.preamble_len] * 4 == [160] * 4
    assert fir.fir_route(160) == "generic"


def test_aligners_agree_and_short_captures_pad(runs):
    """``aligner="gather"`` gives the default's frame; an unknown one is
    refused; a capture shorter than the last candidate frame is padded
    with zeros and still decodes."""
    _, tm = _modems()
    run = runs["qpsk"]
    ci, cq = (_t(c) for c in run["capture"])
    fi, fq, _ = tm.locate_frame(ci, cq, B, MAX_LAG)
    gi, gq, _ = tm.locate_frame(ci, cq, B, MAX_LAG, aligner="gather")
    assert torch.equal(fi, gi) and torch.equal(fq, gq)
    with pytest.raises(ValueError, match="unknown aligner"):
        tm.locate_frame(ci, cq, B, MAX_LAG, aligner="bogus")
    n = run["offsets"][1] + tm.frame_len(B)
    bits, rep = tm.acquire(ci[1:, :n], cq[1:, :n], B, MAX_LAG)
    assert int(rep["start"][0]) == run["offsets"][1]
    np.testing.assert_array_equal(bits.numpy(), run["bits"][1:])


def test_stream_receiver_over_scfde_frames():
    """The port's ``OfdmStreamReceiver`` over SC-FDE frames in a noisy
    stream (the receiver reads only the modem's geometry, metric, front end
    and ``device``): the frames and starts of the JAX receiver's run."""
    jm, tm = _modems()
    rng = np.random.default_rng(16)
    bits = [rng.integers(0, 2, jm.bits_per_frame(B)).astype(np.int32)
            for _ in range(2)]
    amp = 10.0 ** (-30.0 / 20.0)
    segs_i, segs_q, starts, pos = [], [], [], 0
    for g, b in [(97, bits[0]), (230, bits[1]), (60, None)]:
        segs_i.append(amp * rng.standard_normal(g).astype(np.float32))
        segs_q.append(amp * rng.standard_normal(g).astype(np.float32))
        pos += g
        if b is None:
            break
        i, q = (np.asarray(v) for v in jm.tx_frame(jnp.asarray(b)))
        segs_i.append(i)
        segs_q.append(q)
        starts.append(pos)
        pos += i.shape[-1]
    si, sq = np.concatenate(segs_i), np.concatenate(segs_q)
    jr = JStreamReceiver(jm, B)
    want = jr.push(jnp.asarray(si), jnp.asarray(sq)) + jr.flush()
    rx = OfdmStreamReceiver(tm, B)
    cut = 300
    got = (rx.push(_t(si[:cut]), _t(sq[:cut]))
           + rx.push(_t(si[cut:]), _t(sq[cut:])) + rx.flush())
    assert len(got) == len(want) == 2
    for (gb, grep), (wb, wrep), sent, t0 in zip(got, want, bits, starts):
        np.testing.assert_array_equal(gb.numpy(), np.asarray(wb))
        np.testing.assert_array_equal(gb.numpy(), sent)
        assert grep["start"] == wrep["start"] and abs(grep["start"] - t0) <= 4


def test_coded_link_over_scfde_equal():
    """``FramedLink`` (CRC, scrambler, conv K=7, interleaver; the full-block
    decode, set on both sides) over ``ScFdeChain`` through the nulled
    channel at 10 dB: 6 blocks a frame, as in the JAX link; the waveforms
    from the same wire bits and the LLRs equal the JAX modem's; every
    payload back with its CRC true, and the decode of the JAX receiver's
    LLRs equal to the decode of the port's (the decoders are held to each
    other in ``test_torch_fec.py``)."""
    jm, tm = _modems()
    bpb = tm.n * tm.bits_per_symbol
    kw = dict(payload_bits=3 * bpb - 16 - 6, interleave_rows=8,
              conv_window=None)
    jl = JFramedLink(jscfde.ScFdeChain(jm), **kw)
    tl = FramedLink(ScFdeChain(tm), **kw)
    assert tl.n_symbols == jl.n_symbols == 6
    rng = np.random.default_rng(10)
    pay = rng.integers(0, 2, (3, tl.payload_bits)).astype(np.int32)
    wi, wq = (np.asarray(v)
              for v in jm.tx_frame(jnp.asarray(tl.frame(_t(pay)).numpy())))
    for got, want in zip(tl.tx(_t(pay)), (wi, wq)):
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    sigma = np.sqrt(np.mean(wi ** 2 + wq ** 2) / 2 / 10.0)
    ci, cq = _channel(wi, wq, rng, sigma)
    nv = 2 * sigma ** 2
    jllr = np.asarray(jm.rx_soft_frame(jnp.asarray(ci), jnp.asarray(cq),
                                       tl.n_symbols, nv))
    tllr = tl.chain.rx_soft((_t(ci), _t(cq)), tl.n_symbols, noise_var=nv)
    assert np.abs(tllr.numpy() - jllr).max() <= 1e-4 * np.abs(jllr).max()
    out, ok = tl.rx((_t(ci), _t(cq)), nv)
    jout, jok = tl.decode(_t(jllr))
    assert torch.equal(out, jout) and torch.equal(ok, jok)
    assert ok.all() and np.array_equal(out.numpy(), pay)


@pytest.mark.parametrize("kw,match", [
    (dict(n_ltf=0), "n_ltf >= 1"), (dict(cp=64), "cp must be shorter")],
    ids=["n_ltf", "cp"])
def test_constructor_errors(kw, match):
    for make in (lambda: jscfde.ScFdeModem(jscheme("qpsk", JRates(1250,
                                                                  10000)),
                                           **kw),
                 lambda: ScFdeModem(make_scheme("qpsk", Rates(1250, 10000)),
                                    device=CPU, **kw)):
        with pytest.raises(ValueError, match=match):
            make()


def test_refusals():
    """A scheme without a table, bits short of a whole block, blind sync
    with one training block: refused as the JAX modem refuses them."""
    with pytest.raises(ValueError, match="LUT"):
        ScFdeModem(make_scheme("bfsk", Rates(1250, 10000)), device=CPU)
    _, tm = _modems()
    with pytest.raises(ValueError, match="whole 64-symbol blocks"):
        tm.tx_frame(torch.zeros((1, 2 * 63), dtype=torch.int32))
    one = ScFdeModem(make_scheme("qpsk", Rates(1250, 10000)), n_ltf=1,
                     device=CPU)
    with pytest.raises(ValueError, match="n_ltf >= 2"):
        one.sc_metric(torch.zeros(1000), torch.zeros(1000), 10)


@pytest.mark.parametrize("build", [
    lambda: ScFdeModem(make_scheme("qpsk", Rates(1250, 10000))),
    lambda: ScFdeChain(ScFdeModem(make_scheme("qpsk", Rates(1250, 10000)))),
], ids=["ScFdeModem", "ScFdeChain"])
def test_device_none_is_the_card(build, monkeypatch):
    """``device=None`` means CUDA; without a CUDA device the entry points
    raise and build nothing on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build()
