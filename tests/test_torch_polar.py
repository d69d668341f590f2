"""The polar codes in the port (``modem_tpu_torch.fec.polar`` and the plain
versions of kernels K15 and K16, ``modem_tpu_torch.ops.sc_kernel`` and
``scl_kernel``) against the JAX package on the same numpy inputs.

Everything is held exactly (``torch.equal`` on the values): the
construction (``frozen``, ``data_idx``) of plain and rate-matched codes,
codewords, de-matched LLRs, SC decisions against ``decode(backend="xla")``,
and SCL decisions *and path metrics* against the XLA ``_scl`` (which the
JAX package gates as bit-identical to its kernel), including equal
candidate metrics, which must keep ``lax.top_k``'s lower-index-first order.
The JAX decoders are jitted once per module.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from modem_tpu.fec.crc import crc16_ccitt as jcrc16
from modem_tpu.fec.polar import PolarCode as JPolar
from modem_tpu.fec.polar import RateMatchedPolar as JRateMatched

from modem_tpu_torch.fec import PolarCode, RateMatchedPolar, crc16_ccitt
from modem_tpu_torch.ops import sc_kernel as sk, scl_kernel as lk

torch.set_num_threads(1)

CODES = [(64, 32), (128, 64)]
RM_MODES = {"shorten": (100, 180, 256), "puncture": (60, 200, 256),
            "repeat": (100, 300, 256), "none": (100, 256, 256),
            "auto": (100, 180, None)}


def _eq(got, want):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and np.array_equal(got, want)


def _llrs(n, b, seed, ties=False, code=None):
    """``[b, n]`` f32: +-(0, 1, 2) with exact ties and zeros, or +-2 on a
    random JAX codeword (random bits without ``code``) plus noise."""
    rng = np.random.default_rng(seed)
    if ties:
        sign = 1.0 - 2.0 * rng.integers(0, 2, (b, n))
        return (sign * rng.integers(0, 3, (b, n))).astype(np.float32)
    if code is None:
        x = rng.integers(0, 2, (b, n))
    else:
        x = np.asarray(code.encode(jnp.asarray(
            rng.integers(0, 2, (b, code.k)).astype(np.int32))))
    return ((1.0 - 2.0 * x) * 2.0 + rng.normal(0, 1.3, (b, n))).astype(
        np.float32)


def _jax_scl(code, llr, list_size=8):
    """The XLA ``_scl`` from ``decode_list``'s start: (u [B, L, N], pm)."""
    lam = jnp.asarray(llr).reshape(-1, 1, code.n)
    b = lam.shape[0]
    pm0 = jnp.where(jnp.arange(list_size) == 0, 0.0, 2.0 * code._BIG)
    pm0 = jnp.broadcast_to(pm0[None, :], (b, list_size))
    u, _, pm, _ = code._scl(lam, 0, code.n, pm0, list_size)
    return jnp.broadcast_to(u, (b, list_size, code.n)), pm


@pytest.fixture(scope="module")
def jx():
    """JAX codes and their decoders, jitted once."""
    out = {}
    for n, k in CODES + [(16, 8)]:
        jc = JPolar(n, k)
        out[(n, k)] = dict(
            code=jc,
            sc=jax.jit(lambda x, c=jc: c.decode(x, backend="xla")),
            full=jax.jit(jc.decode_full),
            scl=jax.jit(lambda x, c=jc: _jax_scl(c, x)),
            lst=jax.jit(lambda x, c=jc: c.decode_list(x, 8,
                                                      backend="xla")),
            crc=jax.jit(lambda x, c=jc: c.decode_list(
                x, 8, crc=jcrc16(), backend="xla")))
    return out


# ---- construction ----

@pytest.mark.parametrize("n,k", [(16, 8), (64, 32), (256, 128),
                                 (1024, 512), (2048, 700)])
def test_construction_equal(n, k):
    tc, jc = PolarCode(n, k), JPolar(n, k)
    assert np.array_equal(tc.frozen, jc.frozen)
    assert np.array_equal(tc.data_idx, jc.data_idx)


@pytest.mark.parametrize("mode", sorted(RM_MODES))
def test_rate_matched_construction_equal(mode):
    k, e, n = RM_MODES[mode]
    m = "auto" if mode == "auto" else mode
    tr, jr = RateMatchedPolar(k, e, n=n, mode=m), JRateMatched(k, e, n=n,
                                                               mode=m)
    assert (tr.mode, tr.n, tr.e, tr.k) == (jr.mode, jr.n, jr.e, jr.k)
    assert np.array_equal(tr.code.frozen, jr.code.frozen)
    assert np.array_equal(tr.code.data_idx, jr.code.data_idx)


@pytest.mark.parametrize("kwargs,match", [
    ({"n": 24, "k": 8}, "power of two"), ({"n": 16, "k": 0}, "0 < k"),
    ({"n": 8, "k": 4, "force_frozen": np.arange(6)}, "usable channels"),
    ({"n": 8, "k": 5, "channel_z": np.r_[np.ones(4), np.full(4, .5)]},
     "z=1")])
def test_construction_errors(kwargs, match):
    with pytest.raises(ValueError, match=match):
        PolarCode(**kwargs)
    with pytest.raises(ValueError, match=match):
        JPolar(**kwargs)


@pytest.mark.parametrize("args", [(100, 300, 128, "repeat"),
                                  (100, 180, 256, "none"),
                                  (100, 180, 256, "bogus"), (300, 180, 256,
                                                             "auto")])
def test_rate_matched_errors(args):
    k, e, n, mode = args
    with pytest.raises(ValueError):
        RateMatchedPolar(k, e, n=n, mode=mode)
    with pytest.raises(ValueError):
        JRateMatched(k, e, n=n, mode=mode)


# ---- encoding and de-matching ----

@pytest.mark.parametrize("n,k", [(16, 8), (64, 32), (256, 128)])
def test_encode_equal(n, k):
    bits = np.random.default_rng(n).integers(0, 2, (2, 3, k)).astype(
        np.int32)
    got = PolarCode(n, k).encode(torch.as_tensor(bits))
    assert got.dtype == torch.int32
    _eq(got, JPolar(n, k).encode(jnp.asarray(bits)))


@pytest.mark.parametrize("mode", sorted(RM_MODES))
def test_rate_matched_encode_and_dematch_equal(mode):
    k, e, n = RM_MODES[mode]
    m = "auto" if mode == "auto" else mode
    tr, jr = RateMatchedPolar(k, e, n=n, mode=m), JRateMatched(k, e, n=n,
                                                               mode=m)
    rng = np.random.default_rng(1)
    bits = rng.integers(0, 2, (3, k)).astype(np.int32)
    _eq(tr.encode(torch.as_tensor(bits)), jr.encode(jnp.asarray(bits)))
    llr = rng.normal(0, 3, (3, e)).astype(np.float32)
    _eq(tr.dematch(torch.as_tensor(llr)), jr.dematch(jnp.asarray(llr)))
    with pytest.raises(ValueError, match=f"expected {e} LLRs"):
        tr.dematch(torch.zeros((1, e + 1)))


# ---- SC (K15's plain version) ----

@pytest.mark.parametrize("n,k", CODES + [(16, 8)])
@pytest.mark.parametrize("ties", [False, True], ids=["noisy", "ties"])
def test_sc_equal(n, k, ties, jx):
    j = jx[(n, k)]
    llr = _llrs(n, 40, 2 + n, ties, j["code"])
    tc = PolarCode(n, k)
    got = tc.decode(torch.as_tensor(llr))
    assert got.dtype == torch.int32
    _eq(got, j["sc"](jnp.asarray(llr)))
    _eq(tc.decode_full(torch.as_tensor(llr)), j["full"](jnp.asarray(llr)))


def test_sc_plain_is_the_recursion():
    """K15's plain version returns ``_sc``'s u and x as bytes; the CPU
    route takes it."""
    tc = PolarCode(64, 32)
    lam = torch.as_tensor(_llrs(64, 7, 3))
    u, x = sk.sc_plain(tc, lam)
    ru, rx = tc._sc(lam, 0, 64)
    assert u.dtype == x.dtype == torch.uint8
    assert torch.equal(u.int(), ru) and torch.equal(x.int(), rx)
    su, sx = sk.sc_decode(tc, lam)
    assert torch.equal(su, u) and torch.equal(sx, x)
    assert sk.kernel_fits(2) and sk.kernel_fits(1024)
    assert not sk.kernel_fits(2048)


def test_sc_decodes_a_noisy_codeword():
    code = PolarCode(256, 128)
    rng = np.random.default_rng(4)
    bits = rng.integers(0, 2, (50, 128)).astype(np.int32)
    x = code.encode(torch.as_tensor(bits)).numpy()
    llr = (1.0 - 2.0 * x) * 4.0 + rng.normal(0, 1.0, x.shape)
    got = code.decode(torch.as_tensor(llr, dtype=torch.float32))
    _eq(got, bits)
    with pytest.raises(ValueError, match="expected 256 LLRs"):
        code.decode(torch.zeros((1, 255)))


# ---- SCL (K16's plain version) ----

@pytest.mark.parametrize("n,k", CODES + [(16, 8)])
@pytest.mark.parametrize("ties", [False, True], ids=["noisy", "ties"])
def test_scl_bits_and_metrics_equal(n, k, ties, jx):
    """The 8 paths' post-selection decisions and metrics of ``_scl`` (K16's
    plain version) equal the XLA ``_scl``'s."""
    j = jx[(n, k)]
    llr = _llrs(n, 40, 5 + n, ties, j["code"])
    ju, jpm = j["scl"](jnp.asarray(llr))
    u, pm = lk.scl_plain(PolarCode(n, k), torch.as_tensor(llr))
    assert u.dtype == torch.uint8 and pm.dtype == torch.float32
    _eq(u, np.asarray(ju).astype(np.uint8))
    _eq(pm, jpm)


@pytest.mark.parametrize("n,k,crc", [(n, k, c) for n, k in CODES
                                      for c in (False, True)]
                         + [(16, 8, False)])
@pytest.mark.parametrize("ties", [False, True], ids=["noisy", "ties"])
def test_decode_list_equal(n, k, crc, ties, jx):
    """``decode_list`` at list 8, without and with a CRC-16 (of more than
    16 data bits)."""
    j = jx[(n, k)]
    llr = _llrs(n, 40, 6 + n, ties, j["code"])
    want = (j["crc"] if crc else j["lst"])(jnp.asarray(llr))
    got = PolarCode(n, k).decode_list(torch.as_tensor(llr), 8,
                                      crc=crc16_ccitt() if crc else None)
    assert got.dtype == torch.int32
    _eq(got, want)


def test_equal_metric_candidates_pick_topk_order(jx):
    """Integer LLR magnitudes make exact candidate-metric ties (the JAX
    package's own case): the order among them is ``lax.top_k``'s."""
    j = jx[(16, 8)]
    rng = np.random.default_rng(5)
    sign = 1.0 - 2.0 * rng.integers(0, 2, (64, 16))
    mag = rng.integers(0, 3, (64, 16)).astype(np.float64)
    llr = (sign * mag).astype(np.float32)
    _eq(PolarCode(16, 8).decode_list(torch.as_tensor(llr), 8),
        j["lst"](jnp.asarray(llr)))
    ju, jpm = j["scl"](jnp.asarray(llr))
    u, pm = lk.scl_plain(PolarCode(16, 8), torch.as_tensor(llr))
    _eq(pm, jpm)
    _eq(u, np.asarray(ju).astype(np.uint8))


@pytest.mark.parametrize("n,k", CODES)
def test_list_size_one_is_sc(n, k):
    tc = PolarCode(n, k)
    llr = torch.as_tensor(_llrs(n, 30, 7))
    assert torch.equal(tc.decode_list(llr, 1), tc.decode(llr))


@pytest.mark.parametrize("list_size", [2, 4])
def test_other_list_sizes_equal(list_size, jx):
    j = jx[(64, 32)]
    llr = _llrs(64, 20, 8, code=j["code"])
    want = j["code"].decode_list(jnp.asarray(llr), list_size, backend="xla")
    _eq(PolarCode(64, 32).decode_list(torch.as_tensor(llr), list_size), want)
    with pytest.raises(ValueError, match="list_size"):
        PolarCode(64, 32).decode_list(torch.as_tensor(llr), 0)


def test_scl_decode_dispatch_on_cpu_is_plain():
    tc = PolarCode(64, 32)
    lam = torch.as_tensor(_llrs(64, 5, 9))
    u, pm = lk.scl_decode(tc, lam)
    pu, ppm = lk.scl_plain(tc, lam)
    assert torch.equal(u, pu) and torch.equal(pm, ppm)
    assert u.shape == (5, 8, 64) and pm.shape == (5, 8)
    u4, pm4 = lk.scl_decode(tc, lam, 4)
    pu4, ppm4 = lk.scl_plain(tc, lam, 4)
    assert torch.equal(u4, pu4) and torch.equal(pm4, ppm4)
    assert u4.shape == (5, 4, 64) and pm4.shape == (5, 4)


# ---- rate-matched decoding ----

@pytest.mark.parametrize("list_size", [None, 8], ids=["sc", "scl8"])
def test_rate_matched_decode_equal(list_size):
    tr, jr = RateMatchedPolar(100, 180, n=256), JRateMatched(100, 180, n=256)
    rng = np.random.default_rng(10)
    bits = rng.integers(0, 2, (6, 100)).astype(np.int32)
    x = np.asarray(jr.encode(jnp.asarray(bits)))
    llr = ((1.0 - 2.0 * x) * 2.0 + rng.normal(0, 1.0, x.shape)).astype(
        np.float32)
    if list_size is None:
        want = jr.decode(jnp.asarray(llr), backend="xla")
        got = tr.decode(torch.as_tensor(llr))
    else:
        want = jr.decode_list(jnp.asarray(llr), 8, backend="xla")
        got = tr.decode_list(torch.as_tensor(llr), 8)
    _eq(got, want)
    _eq(got, bits)
