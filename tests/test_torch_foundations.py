"""Foundations of the PyTorch port vs ``modem_tpu`` on shared numpy inputs:
``Rates``, bit packing, tap design, the PSK tables, LUT map/slice, the
direct FIR, polyphase interp/decim, LLRs, AWGN and the error counts.

Tolerances: integers and tables exactly; filtered values ``atol=1e-5``
(f32 summation order); LLRs ``rtol=1e-4`` with ``atol=1e-5`` for values
near zero, where the difference of two minima cancels.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from modem_tpu import config as jcfg, metrics as jmetrics
from modem_tpu.models.psk import BPSK as JBPSK, MPSK as JMPSK, QPSK as JQPSK
from modem_tpu.models.qam import QAM as JQAM
from modem_tpu.ops import filters as jfilters, fir as jfir, llr as jllr
from modem_tpu.ops import polyphase as jpoly, slicer as jslicer
from modem_tpu.utils import bits as jbits

from modem_tpu_torch import config as tcfg, metrics as tmetrics
from modem_tpu_torch.models.base import LutScheme
from modem_tpu_torch.models.psk import BPSK, QPSK
from modem_tpu_torch.ops import channel as tchannel, filters as tfilters
from modem_tpu_torch.ops import fir as tfir, llr as tllr
from modem_tpu_torch.ops import polyphase as tpoly, slicer as tslicer
from modem_tpu_torch.utils import bits as tbits

torch.set_num_threads(1)

ATOL = 1e-5


def _t(x, dtype=None):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


def _luts():
    """[M, 2] tables of the JAX package's LUT schemes, up to 64 points."""
    return {
        "bpsk": JBPSK(0.3, 1.5).lut,
        "qpsk": JQPSK(0.0, 1.0).lut,
        "8psk_gray": JMPSK(3, 0.1, 1.0, gray=True).lut,
        "16qam": JQAM(4, 0.0, 1.0).lut,
        "64qam_gray": JQAM(6, 0.2, 1.0, gray=True).lut,
    }


LUTS = _luts()


@pytest.mark.parametrize("baud,rate", [(1250, 10000), (1000, 10000), (3, 10),
                                       (7, 7)])
def test_rates(baud, rate):
    assert (tcfg.Rates(baud, rate).samples_per_symbol
            == jcfg.Rates(baud, rate).samples_per_symbol)


@pytest.mark.parametrize("baud,rate", [(0, 10), (10, 5), (5, -1)])
def test_rates_rejects(baud, rate):
    with pytest.raises(ValueError):
        jcfg.Rates(baud, rate)
    with pytest.raises(ValueError):
        tcfg.Rates(baud, rate)


@pytest.mark.parametrize("bps", [1, 2, 3, 4, 6])
def test_pack_unpack_bits(bps):
    bits = np.random.default_rng(bps).integers(0, 2, (2, 3, 40 * bps))
    want = np.asarray(jbits.pack_bits(jnp.asarray(bits, jnp.int32), bps))
    got = tbits.pack_bits(_t(bits, torch.int32), bps)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    back = tbits.unpack_symbols(got, bps)
    assert back.dtype == torch.int32
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jbits.unpack_symbols(jnp.asarray(want), bps)))
    np.testing.assert_array_equal(back.numpy(), bits)


def test_pack_bits_rejects_partial_symbol():
    with pytest.raises(ValueError):
        tbits.pack_bits(torch.zeros(7, dtype=torch.int32), 2)


@pytest.mark.parametrize("sps,span,beta", [(8, 8, 0.35), (4, 6, 0.25),
                                           (2, 10, 0.5), (5, 4, 0.0)])
def test_rrc_taps_identical(sps, span, beta):
    np.testing.assert_array_equal(tfilters.rrc_taps(sps, span, beta),
                                  jfilters.rrc_taps(sps, span, beta))


def test_filter_designers_identical():
    np.testing.assert_array_equal(tfilters.hilbert_taps(23),
                                  jfilters.hilbert_taps(23))
    np.testing.assert_array_equal(tfilters.lowpass_taps(),
                                  jfilters.lowpass_taps())
    np.testing.assert_array_equal(tfilters.rrc_taps(8, 8, 0.35, "unit_peak"),
                                  jfilters.rrc_taps(8, 8, 0.35, "unit_peak"))


@pytest.mark.parametrize("phase,amp", [(0.0, 1.0), (0.7, 2.5), (-1.2, 0.3)])
def test_psk_tables(phase, amp):
    np.testing.assert_array_equal(BPSK(phase, amp).lut, JBPSK(phase, amp).lut)
    np.testing.assert_array_equal(QPSK(phase, amp).lut, JQPSK(phase, amp).lut)
    assert BPSK.bits_per_symbol == 1 and QPSK.bits_per_symbol == 2


def test_lut_scheme_checks_table():
    s = LutScheme(LUTS["16qam"], 4)
    assert s.lut.dtype == np.float32 and s.bits_per_symbol == 4
    with pytest.raises(ValueError):
        LutScheme(LUTS["16qam"], 3)
    with pytest.raises(ValueError):
        LutScheme(np.zeros((4, 3)), 2)


@pytest.mark.parametrize("name", sorted(LUTS))
def test_lut_map(name):
    lut = LUTS[name]
    syms = np.random.default_rng(1).integers(0, len(lut), (3, 200))
    ji, jq = jslicer.lut_map(jnp.asarray(syms, jnp.int32), lut)
    ti, tq = tslicer.lut_map(_t(syms, torch.int32), lut)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))


@pytest.mark.parametrize("name", sorted(LUTS))
def test_lut_slice(name):
    lut = np.asarray(LUTS[name], np.float32)
    rng = np.random.default_rng(2)
    i = rng.normal(0, 0.8, (3, 300)).astype(np.float32)
    q = rng.normal(0, 0.8, (3, 300)).astype(np.float32)
    want = np.asarray(jslicer.lut_slice(jnp.asarray(i), jnp.asarray(q), lut))
    got = tslicer.lut_slice(_t(i), _t(q), lut)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_lut_slice_first_minimum_wins():
    lut = np.array([[1.0, 0.0], [-1.0, 0.0], [1.0, 0.0]], np.float32)
    got = tslicer.lut_slice(torch.zeros(4), torch.zeros(4), lut)
    np.testing.assert_array_equal(got.numpy(), [0, 0, 0, 0])
    got = tslicer.lut_slice(torch.full((2,), 2.0), torch.zeros(2), lut)
    np.testing.assert_array_equal(got.numpy(), [0, 0])


@pytest.mark.parametrize("n_taps", [1, 2, 23, 65])
def test_fir_direct(n_taps):
    rng = np.random.default_rng(n_taps)
    taps = rng.normal(size=n_taps).astype(np.float32)
    x = rng.normal(size=(2, 3, 400)).astype(np.float32)
    jy, js = jfir.fir_filter(jnp.asarray(x), taps)
    ty, ts = tfir.fir_filter(_t(x), taps)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    # carried state: a second block continues the first
    jy2, _ = jfir.fir_filter(jnp.asarray(x[..., :150]), taps, js)
    ty2, _ = tfir.fir_filter(_t(x[..., :150]), taps, ts)
    np.testing.assert_allclose(ty2.numpy(), np.asarray(jy2), atol=ATOL)


def test_fir_init_state():
    taps = np.ones(9, np.float32)
    s = tfir.fir_init_state(taps, (2, 3))
    assert s.shape == (2, 3, 8) and not s.any()
    np.testing.assert_array_equal(s.numpy(),
                                  np.asarray(jfir.fir_init_state(taps, (2, 3))))
    # a block filtered from the zero state equals one from no state
    x = torch.as_tensor(np.random.default_rng(8).normal(size=(2, 3, 50)),
                        dtype=torch.float32)
    assert torch.equal(tfir.fir_filter(x, taps, s)[0],
                       tfir.fir_filter(x, taps)[0])


@pytest.mark.parametrize("sps,n_taps", [(8, 65), (4, 25), (3, 10), (8, 1)])
def test_phase_bank(sps, n_taps):
    taps = np.random.default_rng(sps).normal(size=n_taps).astype(np.float32)
    np.testing.assert_array_equal(tpoly._phase_bank(_t(taps), sps).numpy(),
                                  jpoly._phase_bank(taps, sps))


@pytest.mark.parametrize("sps,span", [(8, 8), (4, 6), (2, 3)])
def test_polyphase_interp(sps, span):
    taps = jfilters.rrc_taps(sps, span, 0.35)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(3, 120)).astype(np.float32)
    jy, js = jpoly.polyphase_interp(jnp.asarray(x), taps, sps)
    ty, ts = tpoly.polyphase_interp(_t(x), taps, sps)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    jy2, _ = jpoly.polyphase_interp(jnp.asarray(x[:, :40]), taps, sps, js)
    ty2, _ = tpoly.polyphase_interp(_t(x[:, :40]), taps, sps, ts)
    np.testing.assert_allclose(ty2.numpy(), np.asarray(jy2), atol=ATOL)


@pytest.mark.parametrize("sps,span", [(8, 8), (4, 6), (2, 3)])
def test_polyphase_decim(sps, span):
    taps = jfilters.rrc_taps(sps, span, 0.35)
    rng = np.random.default_rng(4)
    n_out = 90
    x = rng.normal(size=(2, (n_out + span) * sps)).astype(np.float32)
    state = rng.normal(size=(2, len(taps) - 1)).astype(np.float32)
    for st in (None, state):
        want = jpoly.polyphase_decim(jnp.asarray(x), taps, sps, span * sps,
                                     n_out, None if st is None else jnp.asarray(st))
        got = tpoly.polyphase_decim(_t(x), taps, sps, span * sps, n_out,
                                    None if st is None else _t(st))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    with pytest.raises(ValueError):
        tpoly.polyphase_decim(_t(x[:, :100]), taps, sps, span * sps, n_out)


@pytest.mark.parametrize("name", sorted(LUTS))
def test_lut_llr(name):
    lut = np.asarray(LUTS[name], np.float32)
    bps = int(np.log2(len(lut)))
    rng = np.random.default_rng(5)
    i = rng.normal(0, 0.8, (3, 200)).astype(np.float32)
    q = rng.normal(0, 0.8, (3, 200)).astype(np.float32)
    want = np.asarray(jllr.lut_llr(jnp.asarray(i), jnp.asarray(q), lut, bps,
                                   0.3))
    got = tllr.lut_llr(_t(i), _t(q), lut, bps, 0.3)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=ATOL)
    np.testing.assert_array_equal(
        tllr.llr_hard_bits(got).numpy(),
        np.asarray(jllr.llr_hard_bits(jnp.asarray(got.numpy()))))
    with pytest.raises(ValueError):
        tllr.lut_llr(_t(i), _t(q), lut, bps + 1)


def test_awgn_power_and_generator():
    n = 200_000
    i, q = torch.ones(n), torch.zeros(n)
    g = torch.Generator().manual_seed(7)
    ni, nq = tchannel.awgn(g, i, q, snr_db=10.0)
    # P = 1, N0 = 0.1, per-rail variance 0.05
    assert abs(float(torch.var(ni - i)) / 0.05 - 1) < 0.02
    assert abs(float(torch.var(nq - q)) / 0.05 - 1) < 0.02
    g2 = torch.Generator().manual_seed(7)
    ni2, _ = tchannel.awgn(g2, i, q, snr_db=10.0)
    assert torch.equal(ni, ni2)
    ni3, _ = tchannel.awgn(torch.Generator().manual_seed(7), 2 * i, q, 10.0,
                           signal_power=1.0)
    assert torch.allclose(ni3 - 2 * i, ni - i, atol=1e-6)


def test_error_counts():
    rng = np.random.default_rng(6)
    a = rng.integers(0, 2, (4, 300))
    b = a ^ (rng.random((4, 300)) < 0.1)
    sa, sb = rng.integers(0, 4, 500), rng.integers(0, 4, 500)
    assert int(tmetrics.bit_errors(_t(a), _t(b))) == int(
        jmetrics.bit_errors(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(
        float(tmetrics.ber(_t(a), _t(b))),
        float(jmetrics.ber(jnp.asarray(a), jnp.asarray(b))), rtol=1e-6)
    np.testing.assert_allclose(
        float(tmetrics.ser(_t(sa), _t(sb))),
        float(jmetrics.ser(jnp.asarray(sa), jnp.asarray(sb))), rtol=1e-6)


def test_package_exports_freq_and_nco():
    """``Freq`` at the top and ``nco`` in ``ops``, as ``modem_tpu``
    exports them."""
    import modem_tpu
    import modem_tpu.ops
    import modem_tpu_torch
    import modem_tpu_torch.ops

    assert "Freq" in modem_tpu.__all__ and "Freq" in modem_tpu_torch.__all__
    assert modem_tpu_torch.Freq is tcfg.Freq
    assert modem_tpu_torch.ops.__all__ == modem_tpu.ops.__all__ == ["nco"]
    for name in ("carrier_phase", "mix_up", "mix_down"):
        assert callable(getattr(modem_tpu_torch.ops.nco, name))
        assert callable(getattr(modem_tpu.ops.nco, name))
    jf, tf = modem_tpu.Freq(2000, 10000), modem_tpu_torch.Freq(2000, 10000)
    assert (tf.ang_freq, tf.sample_freq) == (jf.ang_freq, jf.sample_freq)
