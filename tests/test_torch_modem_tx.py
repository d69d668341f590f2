"""The port's transmit side vs the JAX package's on the same numpy bits: the
15 schemes of the reference CLI (``make_scheme``), their programs and
states, ``Modulator.baseband``/``passband``/``preamble``, streaming and
``TxState.from_numpy`` continuation, plus the foundations they stand on
(``Freq``, ``mod_trig``, ``max_symbol``, ``bit_to_sign``, ``cummod``,
``carrier_phase``) and the device default of every entry point.

Tolerances: integer programs and states exactly; IQ-scheme baseband exactly;
phase-scheme baseband, DMPSK turns and every passband ``atol=1e-6`` (the
trig of two libraries); against the float64 golden model as
``tests/test_schemes.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from modem_tpu import Modulator as JModulator
from modem_tpu import Rates as JRates
from modem_tpu import config as jconfig
from modem_tpu.models import make_scheme as j_make_scheme
from modem_tpu.models.base import PhaseProgram as JPhaseProgram
from modem_tpu.ops import nco as jnco
from modem_tpu.utils import bits as jbits
from modem_tpu.utils import scan as jscan

from modem_tpu_torch import (Demodulator, Modulator, PulseShapedChain, Rates,
                             SCHEME_NAMES, TxState, make_scheme,
                             qpsk_reference_chain)
from modem_tpu_torch import config as tconfig
from modem_tpu_torch.models import APSK, Ring
from modem_tpu_torch.models.base import PhaseProgram
from modem_tpu_torch.ops import nco as tnco
from modem_tpu_torch.utils import bits as tbits
from modem_tpu_torch.utils import scan as tscan

from golden import golden_modulate

torch.set_num_threads(1)

SR, BR, CF = 10000, 500, 1000  # sps 20, even for msk/oqpsk
N_SYM = 96
ATOL = 1e-6
PHASE_SCHEMES = ("bfsk", "msk", "mfsk", "16cpfsk")
CPU = "cpu"


def _rates():
    return JRates(BR, SR), Rates(BR, SR)


def _bits(name, shape=(), n_sym=N_SYM, seed=0):
    bps = j_make_scheme(name, JRates(BR, SR)).bits_per_symbol
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2, shape + (n_sym * bps,)).astype(np.int32)


def _mods(name, carrier=CF):
    jr, tr = _rates()
    return (JModulator(j_make_scheme(name, jr), jr, carrier),
            Modulator(make_scheme(name, tr), tr, carrier, device=CPU))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_tree(got, want, atol=0.0):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _assert_tree(got[k], want[k], atol)
        return
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            _assert_tree(g, w, atol)
        return
    w = np.asarray(want)
    g = got.numpy()
    assert g.dtype == w.dtype and g.shape == w.shape
    if np.issubdtype(w.dtype, np.integer) or atol == 0.0:
        np.testing.assert_array_equal(g, w)
    else:
        np.testing.assert_allclose(g, w, atol=atol, rtol=0)


# ---- foundations ----

def test_freq_and_mod_trig():
    for hz, sr in ((1000, 10000), (900, 44100), (1, 7)):
        jf, tf = jconfig.Freq(hz, sr), tconfig.Freq(hz, sr)
        assert (tf.ang_freq, tf.sample_freq) == (jf.ang_freq, jf.sample_freq)
    for x in (-7.5, -1e-9, 0.0, 3.0, 6.2831853, 1e6):
        assert tconfig.mod_trig(x) == jconfig.mod_trig(x)
    assert tconfig.TWO_PI == jconfig.TWO_PI


def test_max_symbol_and_bit_to_sign():
    for bps in range(1, 9):
        assert tbits.max_symbol(bps) == jbits.max_symbol(bps)
    b = np.array([[0, 1, 1], [1, 0, 0]], np.int32)
    got = tbits.bit_to_sign(torch.as_tensor(b))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jbits.bit_to_sign(jnp.asarray(b))))


@pytest.mark.parametrize("n", [1, 256, 257, 3000])
def test_cummod_int_exact(n):
    rng = np.random.default_rng(n)
    x = rng.integers(-2**30, 2**30, (2, n)).astype(np.int32)
    got = tscan.cummod(torch.as_tensor(x), 9973)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jscan.cummod(jnp.asarray(x), 9973)))


@pytest.mark.parametrize("n", [5, 256, 700, 70000])
def test_cummod_float(n):
    """DMPSK's deltas (multiples of a power-of-two fraction of a turn) sum
    exactly in f32, so the two packages agree exactly whatever order their
    cumsums take."""
    turns = (np.random.default_rng(n).integers(-48, 48, (2, n)) / 16
             ).astype(np.float32)
    got = tscan.cummod(torch.as_tensor(turns), 1.0)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jscan.cummod(jnp.asarray(turns), 1.0)))


@pytest.mark.parametrize("hz,sr,s0", [(1000, 10000, 0), (2000, 10000, 9990),
                                      (900, 44100, 12345), (7, 13, 5)])
def test_carrier_phase_exact(hz, sr, s0):
    got = tnco.carrier_phase(hz, sr, 3000, torch.tensor(s0, dtype=torch.int32))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jnco.carrier_phase(hz, sr, 3000, s0)))


def test_mix_up_down():
    rng = np.random.default_rng(3)
    i, q, th = (rng.normal(size=200).astype(np.float32) for _ in range(3))
    for tf, jf, args in ((tnco.mix_up, jnco.mix_up, (i, q, th)),
                         (tnco.mix_down, jnco.mix_down, (i, th))):
        for g, w in zip(tf(*map(torch.as_tensor, args)),
                        jf(*map(jnp.asarray, args))):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)


# ---- schemes ----

def test_scheme_table():
    assert SCHEME_NAMES == tuple(__import__("modem_tpu.models", fromlist=["x"])
                                 .SCHEME_NAMES)
    with pytest.raises(ValueError, match="invalid"):
        make_scheme("nope", Rates(BR, SR))


@pytest.mark.parametrize("name", SCHEME_NAMES)
def test_scheme_constants(name):
    jr, tr = _rates()
    js, ts = j_make_scheme(name, jr), make_scheme(name, tr)
    assert ts.bits_per_symbol == js.bits_per_symbol and ts.den == js.den
    if hasattr(js, "lut"):
        np.testing.assert_array_equal(np.asarray(ts.lut, np.float32),
                                      np.asarray(js.lut, np.float32))


@pytest.mark.parametrize("cls,args", [
    ("MPSK", (3, 0.1, 1.0)), ("MPSK", (4, 0.0, 0.5)),
    ("QAM", (4, 0.2, 1.0)), ("QAM", (6, 0.0, 1.0)), ("QAM", (5, 0.3, 1.0)),
], ids=str)
def test_gray_tables(cls, args):
    """The Gray-coded tables (no CLI scheme uses them) equal the JAX ones."""
    import modem_tpu.models as jmodels
    import modem_tpu_torch.models as tmodels

    for gray in (False, True):
        np.testing.assert_array_equal(
            np.asarray(getattr(tmodels, cls)(*args, gray=gray).lut, np.float32),
            np.asarray(getattr(jmodels, cls)(*args, gray=gray).lut,
                       np.float32))


def test_apsk_ring_coverage():
    with pytest.raises(ValueError, match="contiguous"):
        APSK(1.0, 4, [Ring(0, 4, 0.5, 0.0), Ring(5, 16, 1.0, 0.0)])
    with pytest.raises(ValueError, match="cover"):
        APSK(1.0, 4, [Ring(0, 4, 0.5, 0.0), Ring(4, 12, 1.0, 0.0)])
    with pytest.raises(ValueError, match="radius"):
        Ring(0, 4, 1.5, 0.0)


@pytest.mark.parametrize("name", SCHEME_NAMES)
def test_program_and_state(name):
    """Two consecutive blocks of ``scheme.program``: integer programs and
    states exactly, float ones to 1e-6."""
    jr, tr = _rates()
    js, ts = j_make_scheme(name, jr), make_scheme(name, tr)
    bits = _bits(name, (3,), seed=4)
    syms = np.asarray(jbits.pack_bits(jnp.asarray(bits), js.bits_per_symbol))
    jstate, tstate = js.init_state((3,)), ts.init_state((3,), CPU)
    _assert_tree(tstate, _np_tree(jstate))
    t0 = 0
    for half in (syms[:, :40], syms[:, 40:]):
        jprog, jstate = js.program(jnp.asarray(half), jstate, jr, t0)
        tprog, tstate = ts.program(torch.as_tensor(half), tstate, tr,
                                   torch.tensor(t0, dtype=torch.int32))
        assert type(tprog).__name__ == type(jprog).__name__
        assert tprog.slots_per_symbol == jprog.slots_per_symbol
        fields = [f.name for f in dataclasses.fields(jprog)
                  if f.name != "slots_per_symbol"]
        for f in fields:
            want, got = getattr(jprog, f), getattr(tprog, f)
            if isinstance(want, (int, float)):
                assert got == want
            else:
                _assert_tree(got, np.asarray(want),
                             0.0 if name not in ("dqpsk", "dbpsk") else ATOL)
        _assert_tree(tstate, _np_tree(jstate), ATOL)
        den = js.den or SR
        t0 = (t0 + half.shape[-1] * jr.samples_per_symbol) % den
    if isinstance(jprog, JPhaseProgram):
        assert isinstance(tprog, PhaseProgram)
        assert tprog.fnum.dtype == tprog.pnum.dtype == torch.int32


# ---- the modulator ----

@pytest.mark.parametrize("name", SCHEME_NAMES)
def test_baseband_matches_jax(name):
    jm, tm = _mods(name)
    bits = _bits(name, (2,))
    (ji, jq), jst = jm.baseband(jnp.asarray(bits), jm.init_state((2,)))
    (ti, tq), tst = tm.baseband(torch.as_tensor(bits), tm.init_state((2,)))
    atol = ATOL if name in PHASE_SCHEMES or name in ("dqpsk", "dbpsk") else 0.0
    for g, w in ((ti, ji), (tq, jq)):
        assert g.dtype == torch.float32 and g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=atol, rtol=0)
    assert int(tst.s_mod_sr) == int(jst.s_mod_sr)
    assert int(tst.s_mod_den) == int(jst.s_mod_den)
    _assert_tree(tst.scheme, _np_tree(jst.scheme), ATOL)


@pytest.mark.parametrize("name", SCHEME_NAMES)
def test_passband_matches_jax_and_golden(name):
    jm, tm = _mods(name)
    bits = _bits(name, seed=1)
    jw, _ = jm.passband(jnp.asarray(bits), jm.init_state())
    tw, _ = tm.passband(torch.as_tensor(bits), tm.init_state())
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=ATOL, rtol=0)
    want = golden_modulate(name, bits, SR, BR, CF, mode="passband")
    tol = 2e-3 if name in ("dqpsk", "dbpsk") else 3e-4
    np.testing.assert_allclose(tw.numpy(), want, atol=tol)


@pytest.mark.parametrize("name", SCHEME_NAMES)
def test_streaming_uneven_chunks_match_one_shot(name):
    """3 uneven chunks with the carried TxState == one shot."""
    _, tm = _mods(name)
    bits = torch.as_tensor(_bits(name, (2,), seed=2))
    one, _ = tm.passband(bits, tm.init_state((2,)))
    bps = tm.scheme.bits_per_symbol
    cuts = [0, 7 * bps, 50 * bps, N_SYM * bps]
    state, outs = tm.init_state((2,)), []
    for a, b in zip(cuts[:-1], cuts[1:]):
        w, state = tm.passband(bits[:, a:b], state)
        outs.append(w)
    np.testing.assert_allclose(torch.cat(outs, -1).numpy(), one.numpy(),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("name", ["qpsk", "mfsk", "dqpsk", "msk"])
def test_preamble_then_digital(name):
    jm, tm = _mods(name)
    bits = _bits(name, n_sym=32, seed=3)
    jp, jst = jm.preamble(3, jm.init_state())
    jw, _ = jm.passband(jnp.asarray(bits), jst)
    tp, tst = tm.preamble(3, tm.init_state())
    tw, _ = tm.passband(torch.as_tensor(bits), tst)
    got = torch.cat([tp, tw]).numpy()
    np.testing.assert_allclose(got, np.concatenate([jp, jw]), atol=ATOL)
    want = golden_modulate(name, bits, SR, BR, CF, mode="passband",
                           preamble_cycles=3)
    tol = 2e-3 if name in ("dqpsk", "dbpsk") else 3e-4
    np.testing.assert_allclose(got, want, atol=tol)


def test_batched_stateful_channels():
    _, tm = _mods("mfsk")
    bits = np.random.default_rng(8).integers(0, 2, (3, 24 * 4)).astype(np.int32)
    wave, _ = tm.passband(torch.as_tensor(bits), tm.init_state((3,)))
    for c in range(3):
        want = golden_modulate("mfsk", bits[c], SR, BR, CF, mode="passband")
        np.testing.assert_allclose(wave[c].numpy(), want, atol=3e-4)


@pytest.mark.parametrize("name", ["bfsk", "mfsk", "msk", "oqpsk", "dcqpsk",
                                  "dqpsk"])
def test_from_numpy_continuation(name):
    """JAX first half + port second half (TxState.from_numpy) == JAX one
    shot."""
    jm, tm = _mods(name)
    bits = _bits(name, (2,), seed=5)
    half = bits.shape[-1] // 2 // tm.scheme.bits_per_symbol \
        * tm.scheme.bits_per_symbol
    one, _ = jm.passband(jnp.asarray(bits), jm.init_state((2,)))
    w1, jst = jm.passband(jnp.asarray(bits[:, :half]), jm.init_state((2,)))
    st = TxState.from_numpy(_np_tree(jst), device=CPU)
    w2, _ = tm.passband(torch.as_tensor(bits[:, half:]), st)
    got = np.concatenate([np.asarray(w1), w2.numpy()], -1)
    np.testing.assert_allclose(got, np.asarray(one), atol=ATOL, rtol=0)


def test_modulator_checks():
    tr = Rates(BR, SR)
    with pytest.raises(ValueError, match="Nyquist"):
        Modulator(make_scheme("bpsk", tr), tr, 6000, device=CPU)
    m = Modulator(make_scheme("bpsk", tr), tr, device=CPU)
    with pytest.raises(ValueError, match="carrier"):
        m.passband(torch.zeros(4, dtype=torch.int32), m.init_state())
    with pytest.raises(ValueError, match="divisib|sr % carrier"):
        Modulator(make_scheme("bpsk", tr), tr, 900, device=CPU).preamble(
            1, m.init_state())


# ---- the device default ----

@pytest.mark.parametrize("build", [
    lambda: Modulator(make_scheme("qpsk", Rates(BR, SR)), Rates(BR, SR), CF),
    lambda: Demodulator(2000, 10000),
    lambda: qpsk_reference_chain(Rates(1250, 10000)),
    lambda: PulseShapedChain(make_scheme("qpsk", Rates(1250, 10000)),
                             Rates(1250, 10000)),
    lambda: TxState.from_numpy(_np_tree(JModulator(
        j_make_scheme("qpsk", JRates(BR, SR)), JRates(BR, SR)).init_state())),
], ids=["Modulator", "Demodulator", "qpsk_reference_chain",
        "PulseShapedChain", "TxState.from_numpy"])
def test_device_none_is_the_card(build, monkeypatch):
    """``device=None`` means CUDA; without a CUDA device it raises and
    builds nothing on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build()
