"""The coded link in the port (``modem_tpu_torch.link.FramedLink``, the
``reference``, ``dvb_like``, ``ccsds_deep_space``, ``lte_like_turbo``,
``nr_like_control`` and ``wifi_like_ofdm`` presets, the LDPC, turbo and
polar (SC and SCL-8) inner-code routes, the ``link`` CLI) against the JAX
package on the same numpy inputs.

Tolerances: wire bits, payloads, ``ok`` verdicts, the CLI's decoded bytes
and verdict lines exactly; waveforms ``atol=1e-5`` (the two packages sum
the RRC taps in another order). Noise is drawn in numpy from a seed and the
same noisy waveform, or the same LLRs, go to both packages. Each JAX link
runs once, jitted, in a module fixture.
"""

import io

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from modem_tpu import presets as jpresets
from modem_tpu.cli import link as jcli
from modem_tpu.fec import PolarCode as JPolar
from modem_tpu.fec import Puncturer as JPuncturer
from modem_tpu.fec import QcLdpc as JLdpc
from modem_tpu.fec import TurboCode as JTurbo
from modem_tpu.fec import rs_dvb as jrs_dvb
from modem_tpu.link import FramedLink as JFramedLink

from modem_tpu_torch import presets
from modem_tpu_torch.cli import link as cli
from modem_tpu_torch.fec import (PolarCode, Puncturer, QcLdpc, TurboCode,
                                 rate23_pattern, rate34_pattern, rs_dvb)
from modem_tpu_torch.link import FramedLink

torch.set_num_threads(1)

CPU = "cpu"
ATOL = 1e-5
#: preset -> operating SNR per complex sample (the JAX preset tests')
PRESETS = {"reference_link": -4.0, "dvb_like_link": 3.0,
           "ccsds_deep_space_link": 0.0}
#: the turbo and polar presets -> their operating SNR (the JAX tests')
FEC_PRESETS = {"lte_like_turbo_link": -6.0, "nr_like_control_link": 1.0}
FRAMES = 2


def _noisy(i, q, snr_db, seed):
    """The waveform plus numpy Gaussian noise at ``snr_db`` per complex
    sample; returns the noisy rails and the per-rail noise variance."""
    p = float(np.mean(i * i + q * q))
    nv = p / (2.0 * 10.0 ** (snr_db / 10.0))
    rng = np.random.default_rng(seed)
    ni = (i + rng.normal(0, np.sqrt(nv), i.shape)).astype(np.float32)
    nq = (q + rng.normal(0, np.sqrt(nv), q.shape)).astype(np.float32)
    return ni, nq, nv


def _jax_run(jl, payload, snr_db, seed):
    """The JAX link on one payload: wire bits, staged waveform, the noisy
    waveform, its LLRs and their decode."""
    frame = np.asarray(jax.jit(jl.frame)(jnp.asarray(payload)))
    i, q = (np.asarray(v) for v in jax.jit(jl.tx)(jnp.asarray(payload)))
    ni, nq, nv = _noisy(i, q, snr_db, seed)
    llr = jax.jit(lambda a, b: jl.chain.rx_soft((a, b), jl.n_symbols,
                                                noise_var=nv))(
        jnp.asarray(ni), jnp.asarray(nq))
    out, ok = jax.jit(jl.decode)(llr)
    return dict(payload=payload, frame=frame, wave=(i, q), noisy=(ni, nq),
                nv=nv, llr=np.asarray(llr), out=np.asarray(out),
                ok=np.asarray(ok))


@pytest.fixture(scope="module")
def runs():
    out = {}
    for k, (name, snr) in enumerate(sorted({**PRESETS,
                                            **FEC_PRESETS}.items())):
        jl = getattr(jpresets, name)()
        rng = np.random.default_rng(k)
        payload = rng.integers(0, 2, (FRAMES, jl.payload_bits)).astype(
            np.int32)
        out[name] = _jax_run(jl, payload, snr, 10 + k)
    jl = jpresets.reference_link()
    out["broken"] = _jax_run(jl, out["reference_link"]["payload"], -11.0, 20)
    return out


def _t(x, dtype=None):
    return torch.as_tensor(np.array(x), dtype=dtype)


def _eq(got, want):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == np.shape(want)
    assert np.array_equal(got, np.asarray(want))


def _link(name):
    return getattr(presets, name)(device=CPU)


# ---- FramedLink ----

@pytest.mark.parametrize("name", sorted(PRESETS))
def test_preset_geometry_equal(name):
    jl, tl = getattr(jpresets, name)(), _link(name)
    for attr in ("payload_bits", "wire_bits", "n_symbols", "conv_window",
                 "_steps", "rows"):
        assert getattr(tl, attr) == getattr(jl, attr), attr
    assert tl.conv_window == 512  # every preset's trellis is >= 1024 steps


@pytest.mark.parametrize("route", ["conv", "rs_conv", "rs_punctured_conv"])
def test_wire_bits_equal_per_route(route):
    """The reference preset (conv), RS(204,188) + conv with 4 rows, and the
    DVB preset (RS + conv punctured to 3/4)."""
    if route == "conv":
        jl, tl = jpresets.reference_link(), _link("reference_link")
    elif route == "rs_conv":
        jl = JFramedLink(jpresets.qpsk_reference_chain(
            jpresets.REFERENCE_RATES), rs=jrs_dvb(), interleave_rows=4)
        tl = FramedLink(presets.qpsk_reference_chain(
            presets.REFERENCE_RATES, device=CPU), rs=rs_dvb(),
            interleave_rows=4)
    else:
        jl, tl = jpresets.dvb_like_link(), _link("dvb_like_link")
    payload = np.random.default_rng(7).integers(
        0, 2, (3, jl.payload_bits)).astype(np.int32)
    got = tl.frame(_t(payload))
    assert got.dtype == torch.int32 and got.shape == (3, tl.wire_bits)
    _eq(got, jax.jit(jl.frame)(jnp.asarray(payload)))


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_frame_and_tx_waveform_equal(name, runs):
    run, tl = runs[name], _link(name)
    _eq(tl.frame(_t(run["payload"])), run["frame"])
    for got, want in zip(tl.tx(_t(run["payload"])), run["wave"]):
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_decode_of_shared_llrs_equal(name, runs):
    run = runs[name]
    out, ok = _link(name).decode(_t(run["llr"]))
    assert out.dtype == torch.int32 and ok.dtype == torch.bool
    _eq(out, run["out"])
    _eq(ok, run["ok"])


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_payload_and_ok_equal_at_operating_snr(name, runs):
    """The same noisy waveform through both packages' staged RX: payloads
    back exactly with every CRC true, on both sides."""
    run = runs[name]
    out, ok = _link(name).rx(tuple(_t(r) for r in run["noisy"]), run["nv"])
    _eq(out, run["out"])
    _eq(ok, run["ok"])
    assert ok.all() and np.array_equal(out.numpy(), run["payload"])


def test_every_crc_fails_at_minus_11_db(runs):
    run = runs["broken"]
    tl = _link("reference_link")
    out, ok = tl.rx(tuple(_t(r) for r in run["noisy"]), run["nv"])
    assert not run["ok"].any() and not ok.any()
    _eq(ok, run["ok"])
    _eq(out, run["out"])
    assert (out.numpy() != run["payload"]).any()
    out, ok = tl.decode(_t(run["llr"]))
    _eq(out, run["out"])
    _eq(ok, run["ok"])


def test_fused_route_on_cpu_is_staged(runs):
    run, tl = runs["reference_link"], _link("reference_link")
    p = _t(run["payload"])
    for f, s in zip(tl.tx_fused(p), tl.tx(p)):
        assert torch.equal(f, s)
    wave = tuple(_t(r) for r in run["noisy"])
    for f, s in zip(tl.rx_fused(wave, run["nv"]), tl.rx(wave, run["nv"])):
        assert torch.equal(f, s)


class StagedOnly:
    """A chain with only the staged forms (as the JAX package's OFDM and
    SC-FDE chains are): ``tx``, ``rx_soft`` and the scheme."""

    def __init__(self, chain):
        self.scheme = chain.scheme
        self.tx, self.rx_soft = chain.tx, chain.rx_soft


@pytest.mark.parametrize("carrier", [None, 2000], ids=["baseband", "pb2000"])
def test_fused_route_without_fused_forms(runs, carrier):
    """``FramedLink.tx_fused`` / ``rx_fused`` over a chain without fused
    forms take the staged route, at baseband and at passband (one real
    waveform), and give the payload back."""
    from modem_tpu_torch.chain import PulseShapedChain
    from modem_tpu_torch.models.psk import QPSK

    run = runs["reference_link"]
    chain = PulseShapedChain(QPSK(0.0, 1.0), presets.REFERENCE_RATES,
                             carrier_hz=carrier, device=CPU)
    tl = FramedLink(StagedOnly(chain), payload_bits=1002)
    p = _t(run["payload"])
    wave = tl.tx_fused(p)
    assert torch.is_tensor(wave) == (carrier is not None)
    out, ok = tl.rx_fused(wave, 0.05)
    assert torch.equal(out, p) and bool(ok.all())


def test_conv_window_resolution():
    chain = presets.qpsk_reference_chain(presets.REFERENCE_RATES, device=CPU)
    jchain = jpresets.qpsk_reference_chain(jpresets.REFERENCE_RATES)
    for kw in ({}, {"conv_window": None}, {"conv_window": 256},
               {"conv_window": "auto", "payload_bits": 490}):
        kw = {"payload_bits": 1002, **kw}
        assert (FramedLink(chain, **kw).conv_window
                == JFramedLink(jchain, **kw).conv_window)
    assert FramedLink(chain, payload_bits=490).conv_window is None  # 512 steps


def test_short_frame_full_block_decode_equal():
    """A 512-step trellis decodes in one block (``conv_window`` None), the
    same plain recursion on every device, equal to the JAX link."""
    chain = presets.qpsk_reference_chain(presets.REFERENCE_RATES, device=CPU)
    jl = JFramedLink(jpresets.qpsk_reference_chain(jpresets.REFERENCE_RATES),
                     payload_bits=490, interleave_rows=0)
    tl = FramedLink(chain, payload_bits=490, interleave_rows=0)
    rng = np.random.default_rng(8)
    payload = rng.integers(0, 2, (2, 490)).astype(np.int32)
    run = _jax_run(jl, payload, -3.0, 21)
    out, ok = tl.decode(_t(run["llr"]))
    _eq(out, run["out"])
    _eq(ok, run["ok"])


@pytest.mark.parametrize("kwargs,match", [
    ({}, "payload_bits is required"),
    ({"rs": "dvb", "interleave_rows": 8}, "interleave_rows"),
    ({"rs": "dvb", "payload_bits": 100}, "RS"),
    ({"payload_bits": 1002, "puncturer": "rate34"}, "puncture period"),
    ({"payload_bits": 1000, "puncturer": "rate23", "interleave_rows": 0},
     "bits/symbol"),
])
def test_size_validation(kwargs, match):
    chain = presets.qpsk_reference_chain(presets.REFERENCE_RATES, device=CPU)
    kwargs = dict(kwargs)
    if kwargs.get("rs") == "dvb":
        kwargs["rs"] = rs_dvb()
    pattern = {"rate23": rate23_pattern(), "rate34": rate34_pattern()}.get(
        kwargs.get("puncturer"))
    jkw = dict(kwargs)
    if pattern is not None:
        kwargs["puncturer"] = Puncturer(pattern)
        jkw["puncturer"] = JPuncturer(pattern)
    with pytest.raises(ValueError, match=match):
        FramedLink(chain, **kwargs)
    if "rs" in jkw:
        jkw["rs"] = jrs_dvb()
    with pytest.raises(ValueError):
        JFramedLink(jpresets.qpsk_reference_chain(jpresets.REFERENCE_RATES),
                    **jkw)


def test_payload_length_checked():
    tl = _link("reference_link")
    with pytest.raises(ValueError, match="expected 1002 payload bits"):
        tl.frame(torch.zeros((1, 1000), dtype=torch.int32))


@pytest.mark.parametrize("inner", ["ldpc", "polar_list"])
def test_other_inner_codes_not_ported(inner):
    """The LDPC inner code (ported) sizes the link as the JAX one does and
    refuses a framed block that is not whole codewords with its message;
    ``polar_list`` without a polar code is refused as the JAX constructor
    refuses it."""
    chain = presets.qpsk_reference_chain(presets.REFERENCE_RATES, device=CPU)
    jchain = jpresets.qpsk_reference_chain(jpresets.REFERENCE_RATES)
    if inner == "ldpc":
        tl = FramedLink(chain, payload_bits=2 * 324 - 16, ldpc=QcLdpc(),
                        ldpc_iters=7, ldpc_msg_dtype=torch.bfloat16)
        jl = JFramedLink(jchain, payload_bits=2 * 324 - 16, ldpc=JLdpc(),
                         ldpc_iters=7)
        for attr in ("wire_bits", "n_symbols", "_steps", "conv",
                     "conv_window", "ldpc_iters", "ldpc_early_exit"):
            assert getattr(tl, attr) == getattr(jl, attr), attr
        assert tl.ldpc_msg_dtype == torch.bfloat16
        with pytest.raises(ValueError) as want:
            JFramedLink(jchain, payload_bits=1002, ldpc=JLdpc())
        with pytest.raises(ValueError) as got:
            FramedLink(chain, payload_bits=1002, ldpc=QcLdpc())
        assert str(got.value) == str(want.value)
        assert "LDPC data size 324" in str(got.value)
        return
    msg = "polar_list needs a polar inner code"
    with pytest.raises(ValueError, match=msg):
        FramedLink(chain, payload_bits=1002, polar_list=8)
    with pytest.raises(ValueError, match=msg):
        JFramedLink(jchain, payload_bits=1002, polar_list=8)


# ---- the turbo and polar inner codes ----

def _fec_link(route, jax_side=False):
    """A link per inner-code route: the turbo preset's shape, a plain
    polar (256, 128) with SC, the rate-matched polar preset with SC, and
    the preset (SCL-8)."""
    pk = jpresets if jax_side else presets
    chain = (pk.qpsk_reference_chain(pk.REFERENCE_RATES) if jax_side else
             pk.qpsk_reference_chain(pk.REFERENCE_RATES, device=CPU))
    link = JFramedLink if jax_side else FramedLink
    if route == "turbo":
        return (jpresets.lte_like_turbo_link() if jax_side
                else presets.lte_like_turbo_link(device=CPU))
    if route == "polar_sc":
        code = JPolar(256, 128) if jax_side else PolarCode(256, 128)
        return link(chain, payload_bits=2 * 128 - 16, polar=code)
    if route == "rm_polar_sc":
        return (jpresets.nr_like_control_link(list_size=None) if jax_side
                else presets.nr_like_control_link(list_size=None,
                                                  device=CPU))
    return (jpresets.nr_like_control_link() if jax_side
            else presets.nr_like_control_link(device=CPU))


FEC_ROUTES = ["turbo", "polar_sc", "rm_polar_sc", "rm_polar_scl8"]


@pytest.mark.parametrize("route", FEC_ROUTES)
def test_fec_geometry_and_wire_bits_equal(route):
    jl, tl = _fec_link(route, True), _fec_link(route)
    for attr in ("payload_bits", "wire_bits", "n_symbols", "_steps", "rows",
                 "conv_window", "polar_list", "turbo_iters",
                 "turbo_early_exit"):
        assert getattr(tl, attr) == getattr(jl, attr), attr
    assert tl.conv is None
    payload = np.random.default_rng(11).integers(
        0, 2, (3, jl.payload_bits)).astype(np.int32)
    got = tl.frame(_t(payload))
    assert got.dtype == torch.int32 and got.shape == (3, tl.wire_bits)
    _eq(got, jax.jit(jl.frame)(jnp.asarray(payload)))


@pytest.mark.parametrize("route", FEC_ROUTES)
def test_fec_decode_of_shared_llrs_equal(route):
    """The same noisy wire LLRs through both packages' ``decode``."""
    jl, tl = _fec_link(route, True), _fec_link(route)
    payload = np.random.default_rng(12).integers(
        0, 2, (2, jl.payload_bits)).astype(np.int32)
    snr = -6.0 if route == "turbo" else 0.0
    run = _jax_run(jl, payload, snr, 13)
    out, ok = tl.decode(_t(run["llr"]))
    assert out.dtype == torch.int32 and ok.dtype == torch.bool
    _eq(out, run["out"])
    _eq(ok, run["ok"])


@pytest.mark.parametrize("name", sorted(FEC_PRESETS))
def test_fec_preset_frame_and_tx_waveform_equal(name, runs):
    run, tl = runs[name], _link(name)
    _eq(tl.frame(_t(run["payload"])), run["frame"])
    for got, want in zip(tl.tx(_t(run["payload"])), run["wave"]):
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("name", sorted(FEC_PRESETS))
def test_fec_preset_payload_and_ok_equal_at_operating_snr(name, runs):
    """The same noisy waveform at the preset's operating SNR through both
    packages' staged RX: payloads back exactly, every CRC true."""
    run = runs[name]
    tl = _link(name)
    out, ok = tl.rx(tuple(_t(r) for r in run["noisy"]), run["nv"])
    _eq(out, run["out"])
    _eq(ok, run["ok"])
    assert ok.all() and np.array_equal(out.numpy(), run["payload"])
    out, ok = tl.decode(_t(run["llr"]))
    _eq(out, run["out"])
    _eq(ok, run["ok"])


def test_fec_preset_geometry():
    tl, pl = _link("lte_like_turbo_link"), _link("nr_like_control_link")
    assert (tl.payload_bits, tl.n_symbols, tl.wire_bits) == (1008, 1542, 3084)
    assert (pl.payload_bits, pl.n_symbols, pl.wire_bits) == (384, 360, 720)
    assert tl.turbo_iters == 6 and tl.turbo_early_exit
    assert pl.polar_list == 8 and pl._polar_wire == 180
    assert presets.lte_like_turbo_link(turbo_iters=3,
                                       device=CPU).turbo_iters == 3


def test_constructor_takes_the_jax_keywords_in_order():
    """The port's ``FramedLink`` takes every keyword of the JAX one, in the
    same order and with the same defaults."""
    import inspect

    got = inspect.signature(FramedLink.__init__).parameters
    want = inspect.signature(JFramedLink.__init__).parameters
    assert list(got) == list(want)
    for name, p in want.items():
        assert got[name].default == p.default, name
    chain = presets.qpsk_reference_chain(presets.REFERENCE_RATES, device=CPU)
    tl = FramedLink(chain, payload_bits=1002, turbo_iters=6, ldpc_iters=5,
                    ldpc_early_exit=False)
    assert (tl.turbo_iters, tl.ldpc_iters, tl.ldpc_early_exit) == (6, 5,
                                                                   False)
    assert tl.conv is not None and tl.conv_window == 512


@pytest.mark.parametrize("case", ["conv_turbo", "polar_turbo",
                                  "turbo_puncture", "polar_puncture",
                                  "turbo_size", "polar_size"])
def test_fec_constructor_errors_equal(case):
    """The JAX constructor's ``ValueError``s, message for message."""
    chain = presets.qpsk_reference_chain(presets.REFERENCE_RATES, device=CPU)
    jchain = jpresets.qpsk_reference_chain(jpresets.REFERENCE_RATES)
    from modem_tpu.fec import ConvCode as JConv
    from modem_tpu_torch.fec import ConvCode

    def kw(side):
        jx = side == "jax"
        turbo = JTurbo(40) if jx else TurboCode(40)
        polar = JPolar(64, 32) if jx else PolarCode(64, 32)
        punct = (JPuncturer if jx else Puncturer)(rate34_pattern())
        conv = (JConv if jx else ConvCode)(7, (0o171, 0o133))
        return {"conv_turbo": dict(conv=conv, turbo=turbo),
                "polar_turbo": dict(polar=polar, turbo=turbo),
                "turbo_puncture": dict(turbo=turbo, puncturer=punct),
                "polar_puncture": dict(polar=polar, puncturer=punct),
                "turbo_size": dict(turbo=turbo),
                "polar_size": dict(polar=polar)}[case]

    with pytest.raises(ValueError) as want:
        JFramedLink(jchain, payload_bits=1002, **kw("jax"))
    with pytest.raises(ValueError) as got:
        FramedLink(chain, payload_bits=1002, **kw("port"))
    assert str(got.value) == str(want.value)


# ---- the LDPC-coded OFDM link ----

#: SNR per complex sample -> noise seed: the preset's operating point and
#: one where every frame fails
WIFI_SNRS = {8.0: 40, -5.0: 41}


def _wifi_link(jax_side, early_exit):
    """``wifi_like_ofdm_link`` with its 20 iterations and the early exit set
    explicitly (``ROADMAP.md`` queue 3's caveat on the defaults)."""
    link = (jpresets.wifi_like_ofdm_link(ldpc_iters=20) if jax_side else
            presets.wifi_like_ofdm_link(ldpc_iters=20, device=CPU))
    link.ldpc_early_exit = early_exit
    return link


@pytest.fixture(scope="module")
def wifi_runs():
    """The JAX wifi link on 2 frames: wire bits, waveform, and at each SNR
    the noisy waveform, its LLRs and the decode with and without early
    exit."""
    jl = _wifi_link(True, True)
    payload = np.random.default_rng(42).integers(
        0, 2, (FRAMES, jl.payload_bits)).astype(np.int32)
    frame = np.asarray(jax.jit(jl.frame)(jnp.asarray(payload)))
    i, q = (np.asarray(v) for v in jax.jit(jl.tx)(jnp.asarray(payload)))
    out = dict(payload=payload, frame=frame, wave=(i, q))
    for snr, seed in WIFI_SNRS.items():
        ni, nq, nv = _noisy(i, q, snr, seed)
        llr = np.asarray(jl.chain.rx_soft((jnp.asarray(ni), jnp.asarray(nq)),
                                          jl.n_symbols, noise_var=nv))
        dec = {}
        for ee in (False, True):
            jl.ldpc_early_exit = ee
            o, ok = jax.jit(jl.decode)(jnp.asarray(llr))
            dec[ee] = (np.asarray(o), np.asarray(ok))
        out[snr] = dict(noisy=(ni, nq), nv=nv, llr=llr, dec=dec)
    return out


def test_wifi_geometry_equal():
    jl, tl = _wifi_link(True, True), _wifi_link(False, True)
    for attr in ("payload_bits", "wire_bits", "n_symbols", "_steps", "rows",
                 "ldpc_iters", "conv_window"):
        assert getattr(tl, attr) == getattr(jl, attr), attr
    assert (tl.payload_bits, tl.n_symbols, tl.wire_bits) == (2576, 54, 5184)
    tl.ldpc.check_tables(QcLdpc.tables_of(jl.ldpc))
    assert presets.wifi_like_ofdm_link(device=CPU).ldpc_early_exit


def test_wifi_frame_and_waveform_equal(wifi_runs):
    run, tl = wifi_runs, _wifi_link(False, True)
    _eq(tl.frame(_t(run["payload"])), run["frame"])
    for fn in (tl.tx, tl.tx_fused):
        for got, want in zip(fn(_t(run["payload"])), run["wave"]):
            np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("early_exit", [False, True],
                         ids=["fixed", "early_exit"])
@pytest.mark.parametrize("snr", list(WIFI_SNRS))
def test_wifi_payload_and_ok_equal(wifi_runs, snr, early_exit):
    """One shared noisy waveform through both packages' RX (the port's
    staged and fused routes: the OFDM chain has no fused forms), and the
    JAX LLRs through the port's decode: payloads and verdicts equal; every
    frame back with its CRC true at 8 dB, every CRC false at -5 dB."""
    run, tl = wifi_runs[snr], _wifi_link(False, early_exit)
    want_out, want_ok = run["dec"][early_exit]
    wave = tuple(_t(r) for r in run["noisy"])
    for fn in (tl.rx, tl.rx_fused):
        out, ok = fn(wave, run["nv"])
        _eq(out, want_out)
        _eq(ok, want_ok)
    out, ok = tl.decode(_t(run["llr"]))
    _eq(out, want_out)
    _eq(ok, want_ok)
    if snr > 0:
        assert ok.all() and np.array_equal(out.numpy(), wifi_runs["payload"])
    else:
        assert not ok.any()


def test_wifi_cli_equal_jax(wifi_runs):
    """``link tx`` and ``link rx --preset wifi_like_ofdm`` against the JAX
    CLI: the waveform bytes to f32 tolerance, and on the same noisy
    waveform the same decoded bytes and verdict lines."""
    payload = wifi_runs["payload"]
    text = "".join("01"[b] for b in payload.reshape(-1)).encode()
    argv = ["tx", "--preset", "wifi_like_ofdm", "--batch-frames", "2"]
    jrc, jout, jerr = _cli(jcli, argv, text)
    rc, out, err = _cli(cli, argv, text)
    assert rc == jrc == 0 and err == jerr
    got, want = np.frombuffer(out, "<f4"), np.frombuffer(jout, "<f4")
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    run = wifi_runs[8.0]
    noisy = np.stack(run["noisy"], -1).astype("<f4").tobytes()
    argv = ["rx", "--preset", "wifi_like_ofdm", "--noise-var",
            f"{run['nv']:.6f}", "--batch-frames", "2"]
    jrc, jout, jerr = _cli(jcli, argv, noisy)
    rc, out, err = _cli(cli, argv, noisy)
    assert rc == jrc == 0 and out == jout and err == jerr
    assert err.count("frame: OK") == FRAMES
    got = np.array([int(c) for c in "".join(out.decode().split())])
    assert np.array_equal(got, payload.reshape(-1))


def test_burst_receiver_decodes_a_wifi_frame():
    """A ``wifi_like_ofdm_link`` frame at an unknown offset in a noisy
    stream: ``burst_ofdm_receiver`` finds it, and the link decodes its
    payload with a true CRC."""
    tl = presets.wifi_like_ofdm_link(device=CPU)
    rx = presets.burst_ofdm_receiver(device=CPU)
    rng = np.random.default_rng(43)
    payload = _t(rng.integers(0, 2, (1, tl.payload_bits)).astype(np.int32))
    i, q = (w[0].numpy() for w in tl.tx(payload))
    gap = (0.02 * rng.standard_normal((2, 333))).astype(np.float32)
    si = np.concatenate([gap[0], 0.8 * i, gap[1]])
    sq = np.concatenate([gap[1], 0.8 * q, gap[0]])
    si = si + (0.05 * rng.standard_normal(si.size)).astype(np.float32)
    sq = sq + (0.05 * rng.standard_normal(sq.size)).astype(np.float32)
    frames = rx.push(si[:1000], sq[:1000]) + rx.push(si[1000:], sq[1000:])
    frames += rx.flush()
    assert len(frames) == 1 and frames[0][1]["start"] == 333
    m = tl.chain.modem
    start = frames[0][1]["start"]
    fi = _t(si[start:start + m.frame_len(tl.n_symbols)])[None]
    fq = _t(sq[start:start + m.frame_len(tl.n_symbols)])[None]
    out, ok = tl.rx((fi, fq), 0.05)
    assert bool(ok.all()) and torch.equal(out, payload)


# ---- presets ----

def test_reference_rates_and_gmsk_preset_equal():
    r, jr = presets.REFERENCE_RATES, jpresets.REFERENCE_RATES
    assert (r.baud_rate, r.sample_rate) == (jr.baud_rate, jr.sample_rate)
    jc, tc = jpresets.gsm_like_gmsk(), presets.gsm_like_gmsk(device=CPU)
    assert tc.bt == jc.bt == 0.3
    bits = np.random.default_rng(9).integers(0, 2, (2, 128)).astype(np.int32)
    for got, want in zip(tc.tx(_t(bits)), jc.tx(jnp.asarray(bits))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=0)
    _eq(tc.roundtrip(_t(bits)), bits)


def test_presets_default_to_the_card():
    """``device=None`` means the card; without one the presets raise."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for make in (presets.reference_link, presets.dvb_like_link,
                 presets.ccsds_deep_space_link, presets.gsm_like_gmsk,
                 presets.lte_like_turbo_link, presets.nr_like_control_link,
                 presets.wifi_like_ofdm_link, presets.burst_ofdm_receiver):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert cli.build_parser().parse_args(
        ["tx", "--preset", "reference"]).device == "cuda"


# ---- the link CLI ----

def _cli(module, argv, stdin, device=True):
    if device and module is cli:
        argv = argv + ["--device", CPU]
    out, err = io.BytesIO(), io.StringIO()
    rc = module.run(module.build_parser().parse_args(argv), stdin, out,
                    stderr=err)
    return rc, out.getvalue(), err.getvalue()


@pytest.fixture(scope="module")
def cli_runs():
    """The JAX CLI's tx of 3 frames (batches of 2) and its rx of that
    waveform with noise at 0 dB per complex sample, run once."""
    rng = np.random.default_rng(30)
    bits = rng.integers(0, 2, 3 * 1002 + 17)  # 17 trailing bits dropped
    text = "".join("01"[b] for b in bits).encode()
    tx = _cli(jcli, ["tx", "--preset", "reference", "--batch-frames", "2"],
              text)
    wave = np.frombuffer(tx[1], "<f4").reshape(3, -1, 2)
    ni, nq, _ = _noisy(wave[..., 0], wave[..., 1], 0.0, 31)
    noisy = np.stack([ni, nq], -1).astype("<f4").tobytes()
    rx = _cli(jcli, ["rx", "--preset", "reference", "--noise-var", "0.3",
                     "--batch-frames", "2"], noisy)
    return dict(bits=bits, text=text, tx=tx, noisy=noisy, rx=rx)


def test_cli_tx_equal_jax(cli_runs):
    rc, out, err = _cli(cli, ["tx", "--preset", "reference",
                              "--batch-frames", "2"], cli_runs["text"])
    jrc, jout, jerr = cli_runs["tx"]
    assert rc == jrc == 0 and err == jerr
    assert "dropped 17 trailing bits" in err
    got, want = np.frombuffer(out, "<f4"), np.frombuffer(jout, "<f4")
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_cli_rx_equal_jax(cli_runs):
    rc, out, err = _cli(cli, ["rx", "--preset", "reference", "--noise-var",
                              "0.3", "--batch-frames", "2"],
                        cli_runs["noisy"])
    jrc, jout, jerr = cli_runs["rx"]
    assert rc == jrc == 0
    assert out == jout and err == jerr and err.count("frame: OK") == 3
    got = np.array([int(c) for c in "".join(out.decode().split())])
    assert np.array_equal(got, cli_runs["bits"][:3 * 1002])


def test_cli_rx_flags_a_corrupted_frame(cli_runs):
    wave = np.frombuffer(cli_runs["tx"][1], "<f4").copy()
    n = wave.size // 3
    wave[n + n // 3: n + 2 * n // 3] = 0.0  # a burst erasure in frame 1
    rc, out, err = _cli(cli, ["rx", "--preset", "reference", "--noise-var",
                              "0.05"], wave.tobytes() + b"\x00" * 5)
    assert rc == 1
    assert err.splitlines()[:3] == ["frame: OK", "frame: BAD", "frame: OK"]
    assert "dropped 5 trailing bytes" in err
    assert len(out.split()) == 3


@pytest.mark.parametrize("preset", ["wifi_like_ofdm"])
def test_cli_refuses_presets_not_ported(preset):
    """Every preset of the JAX command is ported, the last refused one
    included: it runs; a name the JAX command lacks is refused."""
    rc, out, err = _cli(cli, ["tx", "--preset", preset], b"01" * 1288)
    assert rc == 0 and len(out) == 4560 * 2 * 4 and not err
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(["tx", "--preset", "mimo_ofdm"])


def test_cli_presets_are_the_ported_ones():
    assert sorted(cli.PRESETS) == ["ccsds_deep_space", "dvb_like",
                                   "lte_like_turbo", "nr_like_control",
                                   "reference", "wifi_like_ofdm"]
    assert not hasattr(cli, "NOT_PORTED")
    assert set(cli.PRESETS) == set(jcli.PRESETS)


@pytest.mark.parametrize("preset,snr", [("lte_like_turbo", -6.0),
                                        ("nr_like_control", 1.0)])
def test_cli_turbo_and_polar_presets_equal_jax(preset, snr):
    """``link tx`` and ``link rx`` for the turbo and polar presets against
    the JAX CLI: the same waveform bytes (to f32 tolerance), and on the
    same noisy waveform the same decoded bytes and verdict lines."""
    pb = {"lte_like_turbo": 1008, "nr_like_control": 384}[preset]
    bits = np.random.default_rng(32).integers(0, 2, 2 * pb)
    text = "".join("01"[b] for b in bits).encode()
    argv = ["tx", "--preset", preset, "--batch-frames", "2"]
    jrc, jout, jerr = _cli(jcli, argv, text)
    rc, out, err = _cli(cli, argv, text)
    assert rc == jrc == 0 and err == jerr
    got, want = np.frombuffer(out, "<f4"), np.frombuffer(jout, "<f4")
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    wave = want.reshape(2, -1, 2)
    ni, nq, nv = _noisy(wave[..., 0], wave[..., 1], snr, 33)
    noisy = np.stack([ni, nq], -1).astype("<f4").tobytes()
    argv = ["rx", "--preset", preset, "--noise-var", f"{nv:.6f}",
            "--batch-frames", "2"]
    jrc, jout, jerr = _cli(jcli, argv, noisy)
    rc, out, err = _cli(cli, argv, noisy)
    assert rc == jrc == 0 and out == jout and err == jerr
    assert err.count("frame: OK") == 2
    got = np.array([int(c) for c in "".join(out.decode().split())])
    assert np.array_equal(got, bits)


def test_rx_takes_iq_by_keyword(runs):
    """``FramedLink.rx(iq=..., noise_var=...)`` and ``rx_fused(iq=...)``
    (the JAX package's parameter names) equal the positional calls."""
    run, tl = runs["reference_link"], _link("reference_link")
    wave = tuple(_t(r) for r in run["noisy"])
    for fn in (tl.rx, tl.rx_fused):
        want = fn(wave, run["nv"])
        got = fn(iq=wave, noise_var=run["nv"])
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        _eq(got[0], run["out"])
