"""The port's receive side vs the JAX package's on the same numpy inputs:
``fir_filter`` (kernel K4's plain version) vs ``pallas_fir`` in interpret
mode and ``np.convolve``; ``fused_product_detect`` (K5's plain version) vs
the JAX one in interpret mode; ``pll_lock``; ``Demodulator.lock_phase``,
``demodulate`` and ``demodulate_fused`` vs ``modem_tpu.rx.Demodulator`` and
the float64 golden receiver of ``tests/test_rx.py``; streaming and
``RxState.from_numpy`` continuation.

Tolerances: ``atol=1e-5`` on unit-scale inputs (f32 reassociation and the
trig of two libraries); fused pushes vs fused one shot exactly; the golden
receiver ``atol=2e-4`` as ``tests/test_rx.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from modem_tpu import Modulator as JModulator
from modem_tpu import Rates as JRates
from modem_tpu import make_scheme as j_make_scheme
from modem_tpu.ops import pallas_demod as jdemod
from modem_tpu.ops import pll as jpll
from modem_tpu.ops.pallas_fir import pallas_fir
from modem_tpu.rx import Demodulator as JDemodulator

from modem_tpu_torch import Demodulator, RxState
from modem_tpu_torch.ops import demod_kernel, fir, filters, pll
from modem_tpu_torch.ops.fir import fir_filter

from test_rx import golden_demodulate, _tx_passband

torch.set_num_threads(1)

ATOL = 1e-5
CPU = "cpu"


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol,
                               rtol=0)


# ---- K4: the FIR ----

@pytest.mark.parametrize("k", [1, 2, 23, 64, 65, 200])
def test_fir_matches_pallas_and_convolve(k):
    """Three blocks with the carried state vs one ``pallas_fir`` call
    (interpret mode) and ``np.convolve`` in float64."""
    rng = np.random.default_rng(k)
    taps = rng.normal(size=k).astype(np.float32) / np.sqrt(k)
    x = rng.normal(size=(2, 3, 1500)).astype(np.float32)
    want_j, jstate = pallas_fir(jnp.asarray(x), taps)
    state, outs = None, []
    for a, b in ((0, 37), (37, 900), (900, 1500)):
        y, state = fir_filter(torch.as_tensor(x[..., a:b]), taps, state)
        outs.append(y)
    got = torch.cat(outs, -1)
    assert got.shape == x.shape and got.dtype == torch.float32
    _close(got, want_j)
    ref = np.stack([np.convolve(r, taps.astype(np.float64))[:1500]
                    for r in x.reshape(-1, 1500)]).reshape(x.shape)
    _close(got, ref)
    _close(state, jstate, 0.0)
    assert state.shape == x.shape[:-1] + (k - 1,)


def test_fir_short_block_keeps_history():
    """A block shorter than the history shifts it (new_state semantics of
    ``pallas_fir``)."""
    taps = np.random.default_rng(0).normal(size=16).astype(np.float32)
    x = np.random.default_rng(1).normal(size=(2, 40)).astype(np.float32)
    s0 = np.random.default_rng(2).normal(size=(2, 15)).astype(np.float32)
    for n in (0, 5, 15, 40):
        want, jst = pallas_fir(jnp.asarray(x[:, :n]), taps, jnp.asarray(s0))
        got, st = fir_filter(torch.as_tensor(x[:, :n]), taps,
                             torch.as_tensor(s0))
        _close(got, want)
        _close(st, jst, 0.0)


def test_fir_kernel_limits():
    assert fir.fir_smem_bytes(fir.FIR_MAX_TAPS) <= 232448
    assert fir.fir_smem_bytes(fir.FIR_MAX_TAPS + 1) > 232448


# ---- K5: the product detector ----

@pytest.mark.parametrize("hist", [0, 63, 100])
def test_fused_product_detect_matches_jax(hist):
    """The port (plain version) vs the JAX kernel (interpret) on
    ``history ++ x`` with per-channel phases and a stream counter."""
    rng = np.random.default_rng(hist)
    e = rng.normal(size=(2, 3, 1200)).astype(np.float32)
    phi = rng.uniform(-3, 3, (2, 3)).astype(np.float32)
    lp = filters.lowpass_taps()
    s0 = 9876  # counter of e[..., 0]
    want = jdemod.fused_product_detect(jnp.asarray(e), 2000, 10000, lp,
                                       phase_offset=jnp.asarray(phi),
                                       s_mod_sr=s0)
    got = demod_kernel.fused_product_detect(
        torch.as_tensor(e[..., hist:]), 2000, 10000, lp,
        phase_offset=torch.as_tensor(phi),
        s_mod_sr=torch.tensor((s0 + hist) % 10000, dtype=torch.int32),
        history=torch.as_tensor(e[..., :hist]))
    for g, w in zip(got, want):
        assert g.shape == e[..., hist:].shape
        _close(g, np.asarray(w)[..., hist:])


def test_fused_product_detect_checks():
    x = torch.zeros(2, 100)
    with pytest.raises(ValueError, match="65"):
        demod_kernel.fused_product_detect(x, 2000, 10000, np.ones(66))
    with pytest.raises(ValueError, match="2\\^31"):
        demod_kernel.fused_product_detect(x, 50000, 100000, np.ones(8))


def test_pll_lock_matches_jax():
    rng = np.random.default_rng(4)
    xi, xq = (rng.normal(size=(3, 64)).astype(np.float32) for _ in range(2))
    th = rng.uniform(0, 6.28, 64).astype(np.float32)
    want = jpll.pll_lock(jnp.asarray(xi), jnp.asarray(xq), jnp.asarray(th))
    got = pll.pll_lock(*map(torch.as_tensor, (xi, xq, th)))
    assert (pll.PLL_GAIN, pll.LOCK_SAMPLES) == (jpll.PLL_GAIN, jpll.LOCK_SAMPLES)
    _close(got, want)


# ---- the Demodulator ----

def _pair(batch=(2,), hz=2000):
    jd = JDemodulator(hz, 10000)
    td = Demodulator(hz, 10000, lowpass=np.asarray(jd.lowpass),
                     hilbert=np.asarray(jd.hilbert), device=CPU)
    return jd, td


def _passband(c=2, n_sym=400, seed=8):
    """QPSK at 2000 Hz, the JAX modulator, [c, n_sym*8] samples."""
    rates = JRates(1250, 10000)
    mod = JModulator(j_make_scheme("qpsk", rates), rates, carrier_hz=2000)
    bits = np.random.default_rng(seed).integers(0, 2, (c, 2 * n_sym))
    wave, _ = mod.passband(jnp.asarray(bits, jnp.int32), mod.init_state((c,)))
    return np.asarray(wave)


@pytest.fixture(scope="module")
def locked():
    """Both demodulators locked on the first 64 samples of one waveform."""
    jd, td = _pair()
    x = _passband()
    jst = jd.lock_phase(jnp.asarray(x[:, :64]), jd.init_state((2,)))
    tst = td.lock_phase(torch.as_tensor(x[:, :64]), td.init_state((2,)))
    return jd, td, x[:, 64:], jst, tst


def test_demodulator_buffers_and_defaults():
    jd, td = _pair()
    assert {n for n, _ in td.named_buffers()} == {"lowpass", "hilbert"}
    dflt = Demodulator(2000, 10000, device=CPU)
    np.testing.assert_array_equal(dflt.lowpass.numpy(), np.asarray(jd.lowpass))
    np.testing.assert_array_equal(dflt.hilbert.numpy(), np.asarray(jd.hilbert))
    assert Demodulator(2000, 10000, fir_backend="fft",
                       device=CPU).fir_backend == "fft"
    with pytest.raises(ValueError, match="unknown FIR backend"):
        Demodulator(2000, 10000, fir_backend="overlap_add", device=CPU)


def test_lock_phase_matches_jax(locked):
    _, _, _, jst, tst = locked
    _close(tst.phase_offset, jst.phase_offset)
    _close(tst.hilbert, jst.hilbert, 0.0)
    assert int(tst.s_mod_sr) == int(jst.s_mod_sr) == 64


@pytest.mark.parametrize("fused", [False, True])
def test_demodulate_matches_jax(locked, fused):
    jd, td, x, jst, tst = locked
    want, jnew = jd.demodulate(jnp.asarray(x), jst)
    if fused:
        got, tnew, tail = td.demodulate_fused(torch.as_tensor(x), tst)
        np.testing.assert_array_equal(tail.numpy(), x[:, -63:])
    else:
        got, tnew = td.demodulate(torch.as_tensor(x), tst)
    for g, w in zip(got, want):
        _close(g, w)
    assert int(tnew.s_mod_sr) == int(jnew.s_mod_sr)
    _close(tnew.lpi, jnew.lpi)
    _close(tnew.lpq, jnew.lpq)


def test_demodulate_fused_matches_jax_fused(locked):
    jd, td, x, jst, tst = locked
    (ji, jq), jnew, jtail = jd.demodulate_fused(jnp.asarray(x), jst)
    (ti, tq), tnew, ttail = td.demodulate_fused(torch.as_tensor(x), tst)
    _close(ti, ji)
    _close(tq, jq)
    _close(ttail, jtail, 0.0)
    _close(tnew.lpi, jnew.lpi)


def test_fused_pushes_equal_one_shot_exactly(locked):
    _, td, x, _, tst = locked
    xt = torch.as_tensor(x)
    (i1, q1), _, _ = td.demodulate_fused(xt, tst)
    st, tail, outs = tst, None, []
    for a, b in ((0, 1000), (1000, 1030), (1030, 1700), (1700, x.shape[-1])):
        (i, q), st, tail = td.demodulate_fused(xt[:, a:b], st, tail)
        outs.append((i, q))
    assert torch.equal(torch.cat([o[0] for o in outs], -1), i1)
    assert torch.equal(torch.cat([o[1] for o in outs], -1), q1)


def test_staged_pushes_equal_one_shot(locked):
    _, td, x, _, tst = locked
    xt = torch.as_tensor(x)
    (i1, _), _ = td.demodulate(xt, tst)
    st, outs = tst, []
    for a, b in ((0, 20), (20, 1500), (1500, x.shape[-1])):
        (i, _), st = td.demodulate(xt[:, a:b], st)
        outs.append(i)
    _close(torch.cat(outs, -1), i1, 1e-6)


def test_mixed_staged_fused_stream(locked):
    _, td, x, _, tst = locked
    xt = torch.as_tensor(x)
    (i_s, q_s), _ = td.demodulate(xt, tst)
    (i1, q1), st, tail = td.demodulate_fused(xt[:, :1000], tst)
    (i2, q2), st = td.demodulate(xt[:, 1000:2000], st)
    (i3, q3), _, _ = td.demodulate_fused(xt[:, 2000:], st, xt[:, 2000 - 63:2000])
    _close(torch.cat([i1, i2, i3], -1), i_s)
    _close(torch.cat([q1, q2, q3], -1), q_s)


def test_rx_from_numpy_continuation(locked):
    """JAX lock + first half, then the port (RxState.from_numpy) for the
    second half == JAX one shot; staged and fused."""
    jd, td, x, jst, _ = locked
    (ji, jq), _ = jd.demodulate(jnp.asarray(x), jst)
    (a_i, a_q), jmid = jd.demodulate(jnp.asarray(x[:, :1111]), jst)
    st = RxState.from_numpy(_np_tree(jmid), device=CPU)
    assert st.s_mod_sr.dtype == torch.int32 and st.lpi.dtype == torch.float32
    (b_i, b_q), _ = td.demodulate(torch.as_tensor(x[:, 1111:]), st)
    _close(torch.cat([torch.as_tensor(np.asarray(a_i)), b_i], -1), ji)
    (f_i, f_q), _, _ = td.demodulate_fused(
        torch.as_tensor(x[:, 1111:]), st, torch.as_tensor(x[:, 1111 - 63:1111]))
    _close(torch.cat([torch.as_tensor(np.asarray(a_q)), f_q], -1), jq)


def test_matches_golden():
    """Lock + staged and fused detection vs the per-sample float64 golden
    receiver (`demodulator.rs:7-57`)."""
    x, _ = _tx_passband()
    lp, hb = filters.lowpass_taps(sample_rate=10000), filters.hilbert_taps()
    want = golden_demodulate(x, 1000, 10000, lp, hb)
    td = Demodulator(1000, 10000, lowpass=lp, hilbert=hb, device=CPU)
    xt = torch.as_tensor(np.asarray(x, np.float32))
    st = td.lock_phase(xt[:64], td.init_state())
    (i, q), _ = td.demodulate(xt[64:], st)
    (fi, fq), _, _ = td.demodulate_fused(xt[64:], st)
    for a, b in ((i, q), (fi, fq)):
        got = torch.stack([a, b], -1).numpy()
        np.testing.assert_allclose(got, want, atol=2e-4)


def test_rx_state_dtypes(locked):
    _, td, _, jst, tst = locked
    for f in dataclasses.fields(RxState):
        g, w = getattr(tst, f.name), np.asarray(getattr(jst, f.name))
        assert g.numpy().dtype == w.dtype and tuple(g.shape) == w.shape
