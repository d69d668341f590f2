"""The port's adaptive bit loading (``modem_tpu_torch.bitloading``:
``bit_loading``, ``_unit_lut``, ``AdaptiveOfdm`` and its ``FramedLink``
adapter) against the JAX package on the same numpy inputs, on the CPU.

Tolerances: the loading rule, the unit tables, the groups and permutations
and the inner modem's tables (pilot polarity included) equal; waveforms
within 1e-5 absolute (unit power); LLRs within 1e-4 of their largest
magnitude; hard bits and the link's payloads and verdicts exactly. The JAX
functions run once per case, in a module fixture.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from modem_tpu import bitloading as jbl
from modem_tpu.link import FramedLink as JFramedLink
from modem_tpu.ofdm import _default_grid

from modem_tpu_torch import AdaptiveOfdm, FramedLink, bit_loading
from modem_tpu_torch import bitloading

torch.set_num_threads(1)

CPU = "cpu"
S = 4             # payload symbols a frame
DATA, _ = _default_grid(64)
# a frequency-selective channel and its per-bin SNR at a 25 dB floor
SEL_I = np.array([0.75, 0.0, 0.0, 0.55, 0.0, 0.0, 0.3], np.float32)
SEL_Q = np.array([0.0, 0.3, 0.0, 0.0, -0.35, 0.0, 0.0], np.float32)


def _selective_snr_db(floor_db=25.0):
    k = np.asarray(DATA, np.float64)
    h = np.sum((SEL_I + 1j * SEL_Q)
               * np.exp(-2j * np.pi * np.arange(len(SEL_I)) * k[:, None]
                        / 64), axis=-1)
    return floor_db + 20.0 * np.log10(np.abs(h))


#: loading name -> (loading, modem keywords)
LOADINGS = {
    "mixed": (tuple(int(b) for b in np.random.default_rng(0).choice(
        [0, 1, 2, 4, 6, 8], len(DATA))), {}),
    "selective": (bit_loading(_selective_snr_db(), gap_db=8.0, max_bits=6),
                  {}),
    "sfo-denoise": (tuple(int(b) for b in np.random.default_rng(3).choice(
        [1, 2, 4], len(DATA))),
        {"pilot_tracking": "sfo", "channel_denoise": True}),
}


def _pair(name):
    loading, kw = LOADINGS[name]
    return (jbl.AdaptiveOfdm(loading, **kw),
            AdaptiveOfdm(loading, device=CPU, **kw))


def _t(x):
    return torch.as_tensor(np.array(x))


def _channel(i, q, rng, sigma):
    h = SEL_I.astype(np.float64) + 1j * SEL_Q
    z = i.astype(np.float64) + 1j * q
    y = np.stack([np.convolve(r, h)[:z.shape[-1]] for r in z])
    y += sigma * (rng.standard_normal(y.shape)
                  + 1j * rng.standard_normal(y.shape))
    return y.real.astype(np.float32), y.imag.astype(np.float32)


@pytest.fixture(scope="module")
def runs():
    out = {}
    for k, name in enumerate(LOADINGS):
        jm, _ = _pair(name)
        rng = np.random.default_rng(k)
        bits = rng.integers(0, 2, (2, jm.bits_per_frame(S))).astype(np.int32)
        wi, wq = (np.asarray(v) for v in jm.tx_frame(jnp.asarray(bits)))
        if name == "selective":
            ni, nq = _channel(wi, wq, rng, 10 ** (-25 / 20) / np.sqrt(2))
        else:
            ni, nq = _channel(wi, wq, rng, 0.0)
        nv = 10 ** (-25 / 10)
        hard, llr = jax.jit(lambda a, b: (
            jm.rx_frame(a, b, S), jm.rx_soft_frame(a, b, S, noise_var=nv)))(
                jnp.asarray(ni), jnp.asarray(nq))
        out[name] = dict(bits=bits, wave=(wi, wq), rx=(ni, nq), nv=nv,
                         hard=np.asarray(hard), llr=np.asarray(llr))
    return out


def test_bit_loading_equals_jax():
    """The gap rule over random SNRs, gaps, level sets and caps."""
    rng = np.random.default_rng(1)
    snr = rng.uniform(-15.0, 65.0, 200)
    for gap in (6.0, 8.0, 3.5):
        for kw in ({}, {"max_bits": 4}, {"levels": (0, 2, 4)}):
            got = bit_loading(snr, gap_db=gap, **kw)
            assert got == jbl.bit_loading(snr, gap_db=gap, **kw)
            assert isinstance(got, tuple) and all(
                isinstance(b, int) for b in got)
    assert bitloading.LEVELS == jbl.LEVELS


@pytest.mark.parametrize("bits", [1, 2, 4, 6, 8])
def test_unit_lut_equals_jax(bits):
    lut = bitloading._unit_lut(bits)
    np.testing.assert_array_equal(lut, jbl._unit_lut(bits))
    assert abs(float(np.mean(np.sum(lut.astype(np.float64) ** 2, -1)))
               - 1.0) < 1e-6


@pytest.mark.parametrize("name", LOADINGS)
def test_tables_equal(name):
    """Carried across: the groups (size, table, columns, bit indices), the
    two inverse permutations, and the inner modem's bins and tables, its
    seeded pilot values and polarity included."""
    jm, tm = _pair(name)
    assert tm.loads == jm.loads and tm.loading == jm.loading
    assert tm.bits_per_sym == jm.bits_per_sym
    assert len(tm._groups) == len(jm._groups)
    for (b, lut, cols, idx), (jb, jlut, jcols, jidx) in zip(tm._groups,
                                                            jm._groups):
        assert b == jb
        for got, want in ((lut, jlut), (cols, jcols), (idx, jidx)):
            np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tm._col_inv, jm._col_inv)
    np.testing.assert_array_equal(tm._bit_inv, jm._bit_inv)
    for attr in ("_pilot_vals", "_polarity_pn", "_ltf_vals", "_stf_i",
                 "_stf_q", "_tx_c", "_rx_cd", "_preamble_i", "_preamble_q",
                 "_denoise_re"):
        np.testing.assert_array_equal(getattr(tm.m, attr),
                                      np.asarray(getattr(jm.m, attr)))
    for attr in ("data_bins", "pilot_bins", "pilot_tracking",
                 "channel_denoise"):
        assert getattr(tm.m, attr) == getattr(jm.m, attr)
    assert tm.frame_len(S) == jm.frame_len(S)
    assert tm.preamble_len == jm.preamble_len


@pytest.mark.parametrize("name", LOADINGS)
def test_tx_frame_equal(runs, name):
    _, tm = _pair(name)
    run = runs[name]
    for got, want in zip(tm.tx_frame(_t(run["bits"])), run["wave"]):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("name", LOADINGS)
def test_rx_equal(runs, name):
    """Through the selective channel (with noise at 25 dB for the loading
    made from its SNR): hard bits and LLRs equal the JAX modem's, every bit
    right."""
    _, tm = _pair(name)
    run = runs[name]
    ni, nq = (_t(x) for x in run["rx"])
    np.testing.assert_array_equal(tm.rx_frame(ni, nq, S).numpy(),
                                  run["hard"])
    np.testing.assert_array_equal(run["hard"], run["bits"])
    llr = tm.rx_soft_frame(ni, nq, S, noise_var=run["nv"]).numpy()
    want = run["llr"]
    assert llr.shape == want.shape == run["bits"].shape
    assert np.abs(llr - want).max() <= 1e-4 * np.abs(want).max()


def test_conv_link_over_loaded_phy_equal():
    """``FramedLink`` (CRC, scrambler, conv K=7 full-block, set on both
    sides, interleaver) over 24 bins of 16-QAM and 24 of QPSK through the
    selective channel at 14 dB: the waveforms from the same wire bits and
    the LLRs equal the JAX modem's; every payload back with its CRC true,
    and the decode of the JAX receiver's LLRs equal to the decode of the
    port's (the decoders are held to each other in ``test_torch_fec.py``)."""
    loading = tuple(4 if k % 2 else 2 for k in range(len(DATA)))
    jm, tm = jbl.AdaptiveOfdm(loading), AdaptiveOfdm(loading, device=CPU)
    jl = JFramedLink(jm.as_link_chain(), payload_bits=122, conv_window=None)
    tl = FramedLink(tm.as_link_chain(), payload_bits=122, conv_window=None)
    assert tl.n_symbols == jl.n_symbols
    rng = np.random.default_rng(7)
    pay = rng.integers(0, 2, (3, 122)).astype(np.int32)
    wi, wq = (np.asarray(v)
              for v in jm.tx_frame(jnp.asarray(tl.frame(_t(pay)).numpy())))
    for got, want in zip(tl.tx(_t(pay)), (wi, wq)):
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    ci, cq = _channel(wi, wq, rng, 10 ** (-14 / 20) / np.sqrt(2))
    nv = 10 ** (-14 / 10)
    jllr = np.asarray(jm.rx_soft_frame(jnp.asarray(ci), jnp.asarray(cq),
                                       tl.n_symbols, noise_var=nv))
    tllr = tl.chain.rx_soft((_t(ci), _t(cq)), tl.n_symbols, noise_var=nv)
    assert np.abs(tllr.numpy() - jllr).max() <= 1e-4 * np.abs(jllr).max()
    out, ok = tl.rx((_t(ci), _t(cq)), nv)
    jout, jok = tl.decode(_t(jllr))
    assert torch.equal(out, jout) and torch.equal(ok, jok)
    assert ok.all() and np.array_equal(out.numpy(), pay)
    np.testing.assert_array_equal(
        tl.chain.rx((_t(ci), _t(cq)), tl.n_symbols).numpy(),
        np.asarray(jm.rx_frame(jnp.asarray(ci), jnp.asarray(cq),
                               tl.n_symbols)))


@pytest.mark.parametrize("loading,match", [
    ((3,) * len(DATA), "unsupported"),
    ((0,) * len(DATA), "every data bin off"),
    ((2,) * (len(DATA) - 1), "entries")], ids=["size", "off", "length"])
def test_bad_loading_refused(loading, match):
    for make in (lambda: jbl.AdaptiveOfdm(loading),
                 lambda: AdaptiveOfdm(loading, device=CPU)):
        with pytest.raises(ValueError, match=match):
            make()


def test_bit_count_refused():
    _, tm = _pair("mixed")
    with pytest.raises(ValueError, match="must divide by"):
        tm.map_bits(torch.zeros((1, tm.bits_per_sym + 1), dtype=torch.int32))


def test_device_none_is_the_card(monkeypatch):
    """``device=None`` means CUDA; without a CUDA device the entry point
    raises and builds nothing on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AdaptiveOfdm((2,) * len(DATA))
