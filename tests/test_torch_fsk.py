"""The port's FSK kernels' plain versions (K6, K8, K9, K10 of
``modem_tpu_torch.ops.fsk_kernel``), the noise stream, and the slicer and
LLR functions of the FSK and differential families, vs the JAX package on
the same numpy inputs (``modem_tpu.ops.pallas_fsk`` in interpret mode, as
``tests/test_pallas_fsk.py`` runs it).

Tolerances: hash bits exactly, Gaussians ``atol=1e-5``; waveforms (K8, K10)
``atol=2e-6`` (f32 trig of two libraries); discriminator means (K9)
``atol=1e-6`` rad (the same polynomial, sums in another order); noiseless
decisions exactly; noisy K6 decisions on >= 99.9% of symbols; LLRs
``rtol=1e-5``.
"""

import math

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from modem_tpu import Rates as JRates
from modem_tpu.models import fsk as jfsk
from modem_tpu.ops import llr as jllr
from modem_tpu.ops import pallas_chain as jchain
from modem_tpu.ops import pallas_fsk as jpf
from modem_tpu.ops import slicer as jslicer

from modem_tpu_torch import Rates
from modem_tpu_torch.models import fsk as tfsk
from modem_tpu_torch.ops import chain_kernel, fsk_kernel as fk, llr, slicer

torch.set_num_threads(1)

JR, TR = JRates(1250, 10000), Rates(1250, 10000)
SR = 10000

# (id, JAX scheme, port scheme): BFSK, 4-FSK, 16-MFSK with both maps, CPFSK
SCHEMES = [
    ("bfsk", lambda: jfsk.BFSK(200, SR, 1.0), lambda: tfsk.BFSK(200, SR, 1.0)),
    ("4fsk", lambda: jfsk.MFSK(2, 100, SR, 1.0, "increase"),
     lambda: tfsk.MFSK(2, 100, SR, 1.0, "increase")),
    ("16mfsk_increase", lambda: jfsk.MFSK(4, 50, SR, 1.0, "increase"),
     lambda: tfsk.MFSK(4, 50, SR, 1.0, "increase")),
    ("16mfsk_default", lambda: jfsk.MFSK(4, 50, SR, 1.0, "default"),
     lambda: tfsk.MFSK(4, 50, SR, 1.0, "default")),
    ("cpfsk2", lambda: jfsk.CPFSK(2, JR, 1.0, 1), lambda: tfsk.CPFSK(2, TR, 1.0, 1)),
]
IDS = [s[0] for s in SCHEMES]


def _syms(bps, shape, seed):
    return np.random.default_rng(seed).integers(0, 1 << bps, shape).astype(np.int32)


def _program(jscheme, syms):
    """The JAX scheme's phase program of ``syms`` as numpy ``(fnum, pnum,
    den, qshift)``: both sides synthesize from the same integers."""
    prog, _ = jscheme.program(jnp.asarray(syms),
                              jscheme.init_state(syms.shape[:-1]), JR, 0)
    return (np.array(prog.fnum), np.array(prog.pnum), prog.den,
            float(prog.qshift))


def _close(got, want, atol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol, rtol=0)


def _noisy(shape, sigma, seed):
    return np.random.default_rng(seed).normal(0, sigma, shape).astype(np.float32)


# ---- the noise stream ----

def test_hash_bits_equal():
    x = np.random.default_rng(0).integers(0, 2**32, 4096, dtype=np.uint64)
    x[:4] = [0, 1, 2**31, 2**32 - 1]
    want = np.asarray(jchain._hash_u32(jnp.asarray(x.astype(np.uint32))))
    got = chain_kernel.hash_u32(torch.as_tensor(x.astype(np.int64)))
    assert np.array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("key,salt", [(0, 0), (-12345, 0), (2**31 - 1, 0),
                                      (-2**31, 1), (987654, 2)])
def test_gauss_pair_matches_interpret_stream(key, salt):
    shape = (70, 128)
    want = jchain._gauss_pair(shape, True, jnp.int32(key), salt)
    rows = torch.arange(shape[0])[:, None]
    cols = torch.arange(shape[1])[None, :]
    got = chain_kernel.gauss_pair((rows * shape[1] + cols).long(), key, salt)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        _close(g, w, 1e-5)


def test_fsk_noise_tiles_match_the_kernel_keys():
    """The K6 noise of symbol k, channel c, sample j is the JAX tile's draw
    at row (k % cs + 1)*sps + j, column c % 128, tile key seed +
    (c // 128)*1000003 + (k // cs)*7919."""
    sps, cs, seed = 8, 32, -5
    gi, gq = fk.fsk_noise((130, 70), sps, cs, seed, "cpu")
    for c, k in ((0, 0), (129, 69), (127, 31), (128, 32), (5, 64)):
        key = seed + (c // 128) * 1000003 + (k // cs) * 7919
        wi, wq = jchain._gauss_pair(((cs + 1) * sps, 128), True, jnp.int32(key))
        rows = slice((k % cs + 1) * sps, (k % cs + 2) * sps)
        _close(gi[c, k], np.asarray(wi)[rows, c % 128], 1e-5)
        _close(gq[c, k], np.asarray(wq)[rows, c % 128], 1e-5)


# ---- constants ----

def test_atan2_poly_matches_jax():
    rng = np.random.default_rng(1)
    y = rng.normal(size=5000).astype(np.float32)
    x = rng.normal(size=5000).astype(np.float32)
    y[:6], x[:6] = [0, 0, 1, -1, 0, 2], [0, -1, 0, 0, 3, 2]
    got = fk.atan2_poly(torch.as_tensor(y), torch.as_tensor(x))
    _close(got, jpf._atan2(jnp.asarray(y), jnp.asarray(x)), 1e-6)
    _close(got, np.arctan2(y, x), 2e-5)


@pytest.mark.parametrize("scheme", SCHEMES, ids=IDS)
def test_coef_table_equal(scheme):
    _, mj, mt = scheme
    assert fk.fsk_coef_table(mt()) == jpf.fsk_coef_table(mj())


def test_coef_table_nyquist_and_type_errors():
    from modem_tpu import make_scheme as jmake
    from modem_tpu_torch import make_scheme

    with pytest.raises(ValueError, match="Nyquist"):
        jpf.fsk_coef_table(jmake("16cpfsk", JR))
    with pytest.raises(ValueError, match="Nyquist"):
        fk.fsk_coef_table(make_scheme("16cpfsk", TR))
    with pytest.raises(TypeError):
        fk.fsk_coef_table(make_scheme("msk", TR))


@pytest.mark.parametrize("snr", [0.0, 7.5, 22.0])
def test_noise_sigma_equal(snr):
    assert fk.fsk_noise_sigma(0.7, snr) == jpf.fsk_noise_sigma(0.7, snr)


# ---- K8 and K10: synthesis ----

@pytest.mark.parametrize("scheme", SCHEMES, ids=IDS)
def test_fsk_tx_matches_jax(scheme):
    _, mj, _ = scheme
    js = mj()
    syms = _syms(js.bits_per_symbol, (3, 300), 2)
    fnum, pnum, den, qshift = _program(js, syms)
    want = jpf.fused_fsk_tx(jnp.asarray(fnum), jnp.asarray(pnum), den, 8, 1.0,
                            qshift)
    got = fk.fused_fsk_tx(torch.as_tensor(fnum), torch.as_tensor(pnum), den, 8,
                          1.0, qshift)
    for g, w in zip(got, want):
        assert g.shape == (3, 2400) and g.dtype == torch.float32
        _close(g, w, 2e-6)


def test_fsk_tx_batch_dims_and_large_phase_numbers():
    """A [2, 3, K] program with pnum outside [0, den) and negative fnum
    (floor mod)."""
    rng = np.random.default_rng(3)
    fnum = rng.integers(-2000, 2000, (2, 3, 50)).astype(np.int32)
    pnum = rng.integers(-50000, 50000, (2, 3, 50)).astype(np.int32)
    want = jpf.fused_fsk_tx(jnp.asarray(fnum), jnp.asarray(pnum), SR, 4, 0.5,
                            -0.5 * math.pi)
    got = fk.fused_fsk_tx(torch.as_tensor(fnum), torch.as_tensor(pnum), SR, 4,
                          0.5, -0.5 * math.pi)
    for g, w in zip(got, want):
        _close(g, w, 2e-6)


@pytest.mark.parametrize("spb", [4, 8])
def test_msk_tx_matches_jax(spb):
    rng = np.random.default_rng(spb)
    s0 = (2 * rng.integers(0, 2, (3, 400)) - 1).astype(np.int32)
    s1 = (2 * rng.integers(0, 2, (3, 400)) - 1).astype(np.int32)
    want = jpf.fused_msk_tx(jnp.asarray(s0), jnp.asarray(s1), spb, 0.8)
    got = fk.fused_msk_tx(torch.as_tensor(s0), torch.as_tensor(s1), spb, 0.8)
    for g, w in zip(got, want):
        assert g.shape == (3, 400 * spb)
        _close(g, w, 2e-6)


# ---- K9: discriminator means ----

@pytest.mark.parametrize("group,guard", [(8, 1), (8, 3), (4, 1), (16, 2)])
def test_discriminator_means_match_jax(group, guard):
    rng = np.random.default_rng(group + guard)
    n = 300 * group
    ph = np.cumsum(rng.uniform(-1.0, 1.0, (3, n)), axis=-1)
    i = (np.cos(ph) + _noisy((3, n), 0.05, 1)).astype(np.float32)
    q = (np.sin(ph) + _noisy((3, n), 0.05, 2)).astype(np.float32)
    want = jpf.fused_discriminator_means(jnp.asarray(i), jnp.asarray(q), group,
                                         guard)
    got = fk.fused_discriminator_means(torch.as_tensor(i), torch.as_tensor(q),
                                       group, guard)
    assert got.shape == (3, 300) and got.dtype == torch.float32
    _close(got, want, 1e-6)
    # and the exact-atan2 staged statistic, to the polynomial's error
    staged = slicer.fsk_symbol_means(
        slicer.fm_discriminate(torch.as_tensor(i), torch.as_tensor(q)), group,
        guard)
    _close(got, staged.numpy(), 2e-5)


def test_discriminator_means_errors():
    x = torch.zeros(2, 64)
    with pytest.raises(ValueError, match="guard >= 1"):
        fk.fused_discriminator_means(x, x, 8, 0)
    with pytest.raises(ValueError, match="no interior"):
        fk.fused_discriminator_means(x, x, 8, 8)
    with pytest.raises(ValueError, match="whole number"):
        fk.fused_discriminator_means(x[:, :60], x[:, :60], 8, 1)


# ---- K6: the loopback ----

@pytest.mark.parametrize("scheme", SCHEMES, ids=IDS)
def test_fsk_chain_noiseless_exact(scheme):
    _, mj, mt = scheme
    js, ts = mj(), mt()
    syms = _syms(js.bits_per_symbol, (3, 600), 4)
    want = np.asarray(jpf.fused_fsk_chain(jnp.asarray(syms), js, JR))
    got = fk.fused_fsk_chain(torch.as_tensor(syms), ts, TR)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got.numpy(), syms)


@pytest.mark.parametrize("scheme", [SCHEMES[0], SCHEMES[2], SCHEMES[4]],
                         ids=[IDS[0], IDS[2], IDS[4]])
def test_fsk_chain_noisy_matches_interpret_stream(scheme):
    """Noisy decisions from the same seeded stream: equal on >= 99.9% of
    symbols (they may differ only where libm rounding moves a mean across a
    midpoint), and errors at the SNR the schemes make them."""
    _, mj, mt = scheme
    js, ts = mj(), mt()
    syms = _syms(js.bits_per_symbol, (3, 600), 5)
    snr = 18.0 if js.bits_per_symbol == 4 else 6.0
    want = np.asarray(jpf.fused_fsk_chain(jnp.asarray(syms), js, JR,
                                          snr_db=snr, seed=11))
    got = fk.fused_fsk_chain(torch.as_tensor(syms), ts, TR, snr_db=snr,
                             seed=11).numpy()
    assert np.mean(got == want) >= 0.999
    assert 0 < np.mean(want != syms) < 0.5


@pytest.mark.parametrize("snr", [None, 14.0])
def test_fsk_chain_crosses_lane_and_tile_keys(snr):
    """130 channels x 70 symbols with chunk_sym 32: two 128-lane keys and
    three time tiles of the noise stream."""
    js, ts = jfsk.MFSK(4, 50, SR, 1.0, "increase"), tfsk.MFSK(4, 50, SR, 1.0,
                                                             "increase")
    syms = _syms(4, (130, 70), 6)
    want = np.asarray(jpf.fused_fsk_chain(jnp.asarray(syms), js, JR,
                                          chunk_sym=32, snr_db=snr, seed=-3))
    got = fk.fused_fsk_chain(torch.as_tensor(syms), ts, TR, chunk_sym=32,
                             snr_db=snr, seed=-3).numpy()
    assert np.mean(got == want) >= (1.0 if snr is None else 0.999)
    if snr is not None:  # a different tiling draws different noise
        other = fk.fused_fsk_chain(torch.as_tensor(syms), ts, TR,
                                   chunk_sym=64, snr_db=snr, seed=-3).numpy()
        assert not np.array_equal(other, got)


def test_decide_from_program_batch_and_guard():
    js = jfsk.MFSK(2, 100, SR, 1.0, "default")
    syms = _syms(2, (2, 3, 200), 7)
    fnum, pnum, den, qshift = _program(js, syms)
    coefs = jpf.fsk_coef_table(js)
    for guard in (1, 3):
        want = np.asarray(jpf.fsk_decide_from_program(
            jnp.asarray(fnum), jnp.asarray(pnum), coefs, den, 8, 1.0, qshift,
            guard))
        got = fk.fsk_decide_from_program(
            torch.as_tensor(fnum), torch.as_tensor(pnum), coefs, den, 8, 1.0,
            qshift, guard)
        assert got.shape == (2, 3, 200)
        assert np.array_equal(got.numpy(), want)
        assert np.array_equal(want, syms)


@pytest.mark.parametrize("guard", [0, 8])
def test_fsk_chain_guard_errors(guard):
    syms = np.zeros((2, 10), np.int32)
    with pytest.raises(ValueError):
        jpf.fused_fsk_chain(jnp.asarray(syms), jfsk.BFSK(200, SR, 1.0), JR,
                            guard)
    with pytest.raises(ValueError):
        fk.fused_fsk_chain(torch.as_tensor(syms), tfsk.BFSK(200, SR, 1.0), TR,
                           guard)


# ---- K7: the MSK loopback ----

def _slot_signs(shape, seed):
    rng = np.random.default_rng(seed)
    return tuple((2 * rng.integers(0, 2, shape) - 1).astype(np.int32)
                 for _ in range(2))


def _msk_both(s0, s1, spb, **kw):
    want = np.asarray(jpf.fused_msk_slots(jnp.asarray(s0), jnp.asarray(s1),
                                          spb, 0.8, **kw))
    got = fk.fused_msk_slots(torch.as_tensor(s0), torch.as_tensor(s1), spb,
                             0.8, **kw)
    assert got.dtype == torch.int32 and got.shape == s0.shape
    return got.numpy(), want


@pytest.mark.parametrize("spb,guard", [(2, 1), (4, 1), (4, 2), (8, 3)])
def test_msk_loopback_noiseless_matches_jax(spb, guard):
    s0, s1 = _slot_signs((2, 3, 200), spb)
    got, want = _msk_both(s0, s1, spb, guard=guard)
    assert np.array_equal(got, want)
    assert np.array_equal(got, (s0 * s1 > 0).astype(np.int32))  # c = -s0*s1


@pytest.mark.parametrize("spb,snr,seed", [(4, 6.0, 11), (4, 6.0, -2**31),
                                          (2, 8.0, 3)])
def test_msk_loopback_noisy_matches_jax(spb, snr, seed):
    """The JAX interpret stream bit for bit: decisions equal."""
    s0, s1 = _slot_signs((3, 600), seed % 97)
    got, want = _msk_both(s0, s1, spb, snr_db=snr, seed=seed)
    assert np.array_equal(got, want)
    assert 0 < np.mean(want != (s0 * s1 > 0)) < 0.2


def test_msk_loopback_crosses_lane_and_tile_keys():
    """130 channels x 70 slots in tiles of 32 slots: two 128-lane keys and
    three time tiles; another tiling draws other noise."""
    s0, s1 = _slot_signs((130, 70), 21)
    got, want = _msk_both(s0, s1, 4, chunk_slots=32, snr_db=5.0, seed=-3)
    assert np.array_equal(got, want)
    other, _ = _msk_both(s0, s1, 4, chunk_slots=64, snr_db=5.0, seed=-3)
    assert not np.array_equal(other, got)


def test_msk_loopback_noise_is_the_slot_stream():
    """K7's plain version adds fsk_noise over slots of spb samples: its
    waveform sums equal a direct recomputation with those draws."""
    s0, s1 = (torch.as_tensor(v) for v in _slot_signs((2, 50), 22))
    sigma = fk.fsk_noise_sigma(0.8, 5.0)
    gi, gq = fk.fsk_noise((2, 50), 4, 16, 9, "cpu")
    wi, wq = fk.msk_tx_plain(s0, s1, 4, 0.8)
    wi = wi + fk.f32(sigma) * gi.reshape(wi.shape)
    wq = wq + fk.f32(sigma) * gq.reshape(wq.shape)
    want = (fk.disc_means_plain(wi, wq, 4, 1) < 0).to(torch.int32)
    got = fk.fused_msk_slots(s0, s1, 4, 0.8, chunk_slots=16, snr_db=5.0,
                             seed=9)
    assert torch.equal(got, want)


@pytest.mark.parametrize("guard", [0, 4])
def test_msk_loopback_guard_errors(guard):
    s0, s1 = _slot_signs((2, 16), 0)
    with pytest.raises(ValueError):
        jpf.fused_msk_slots(jnp.asarray(s0), jnp.asarray(s1), 4, 1.0, guard)
    with pytest.raises(ValueError, match="guard"):
        fk.fused_msk_slots(torch.as_tensor(s0), torch.as_tensor(s1), 4, 1.0,
                           guard)


def test_msk_loopback_argument_errors():
    s = torch.ones(2, 16, dtype=torch.int32)
    with pytest.raises(ValueError, match="differ"):
        fk.fused_msk_slots(s, s[:, :8], 4, 1.0)
    with pytest.raises(ValueError, match="chunk_slots"):
        fk.fused_msk_slots(s, s, 4, 1.0, chunk_slots=0)


# ---- staged slicers and LLRs ----

def _iq(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape).astype(np.float32),
            rng.normal(size=shape).astype(np.float32))


@pytest.mark.parametrize("with_prev", [False, True])
def test_fm_discriminate_and_diff_phase(with_prev):
    i, q = _iq((2, 3, 50), 8)
    prev = np.stack(_iq((2, 3), 9), -1) if with_prev else None
    jp = None if prev is None else jnp.asarray(prev)
    tp = None if prev is None else torch.as_tensor(prev)
    ti, tq, ji, jq = torch.as_tensor(i), torch.as_tensor(q), jnp.asarray(i), jnp.asarray(q)
    _close(slicer.fm_discriminate(ti, tq, tp),
           jslicer.fm_discriminate(ji, jq, jp), 1e-6)
    _close(slicer.diff_phase(ti, tq, tp), jslicer.diff_phase(ji, jq, jp), 1e-6)


@pytest.mark.parametrize("bps", [1, 2, 3])
def test_diff_phase_slice(bps):
    m = 1 << bps
    shift = 2 * math.pi / m
    rng = np.random.default_rng(bps)
    ph = np.cumsum(rng.integers(0, m, (3, 100)) * shift
                   + rng.normal(0, 0.2, (3, 100)), -1)
    i, q = np.cos(ph).astype(np.float32), np.sin(ph).astype(np.float32)
    want = jslicer.diff_phase_slice(jnp.asarray(i), jnp.asarray(q), shift, bps)
    got = slicer.diff_phase_slice(torch.as_tensor(i), torch.as_tensor(q),
                                  shift, bps)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("scheme", SCHEMES, ids=IDS)
def test_fsk_slice_and_means(scheme):
    _, mj, _ = scheme
    js = mj()
    coefs = np.asarray(jpf.fsk_coef_table(js))
    dev = 2 * math.pi / SR
    rng = np.random.default_rng(10)
    inst = (np.repeat(coefs[rng.integers(0, len(coefs), (3, 80))] * dev, 8,
                      axis=-1) + rng.normal(0, 0.02, (3, 640))).astype(np.float32)
    ji, ti = jnp.asarray(inst), torch.as_tensor(inst)
    for guard in (1, 2):
        _close(slicer.fsk_symbol_means(ti, 8, guard),
               jslicer.fsk_symbol_means(ji, 8, guard), 1e-6)
        got = slicer.fsk_slice(ti, coefs, dev, 8, guard)
        assert np.array_equal(got.numpy(), np.asarray(
            jslicer.fsk_slice(ji, coefs, dev, 8, guard)))
    means = np.array(jslicer.fsk_symbol_means(ji, 8, 1))
    assert np.array_equal(
        slicer.fsk_slice_means(torch.as_tensor(means), coefs, dev).numpy(),
        np.asarray(jslicer.fsk_slice_means(jnp.asarray(means), coefs, dev)))


def _llr_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("scheme", SCHEMES, ids=IDS)
@pytest.mark.parametrize("nv", [1.0, 0.01])
def test_fsk_llr(scheme, nv):
    _, mj, _ = scheme
    js = mj()
    coefs = np.asarray(jpf.fsk_coef_table(js))
    dev = 2 * math.pi / SR
    mean_f = (np.random.default_rng(11).uniform(-0.2, 1.2, (3, 40))
              * coefs.max() * dev).astype(np.float32)
    want = jllr.fsk_llr(jnp.asarray(mean_f), coefs, dev, js.bits_per_symbol, nv)
    got = llr.fsk_llr(torch.as_tensor(mean_f), coefs, dev, js.bits_per_symbol,
                      nv)
    assert got.shape == (3, 40 * js.bits_per_symbol)
    _llr_close(got, want)
    hard = slicer.fsk_slice_means(torch.as_tensor(mean_f), coefs, dev)
    from modem_tpu_torch.utils.bits import unpack_symbols
    assert torch.equal(llr.llr_hard_bits(got),
                       unpack_symbols(hard, js.bits_per_symbol))


def test_fsk_llr_rejects_wrong_table():
    with pytest.raises(ValueError, match="coefs"):
        llr.fsk_llr(torch.zeros(2, 3), np.arange(3), 0.1, 2)


@pytest.mark.parametrize("bps", [1, 2])
@pytest.mark.parametrize("nv", [1.0, 0.05])
def test_dmpsk_llr(bps, nv):
    shift = 2 * math.pi / (1 << bps)
    dphi = np.random.default_rng(bps).uniform(-4, 4, (3, 60)).astype(np.float32)
    want = jllr.dmpsk_llr(jnp.asarray(dphi), shift, bps, nv)
    got = llr.dmpsk_llr(torch.as_tensor(dphi), shift, bps, nv)
    _llr_close(got, want)
