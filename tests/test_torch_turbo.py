"""The turbo code in the port (``modem_tpu_torch.fec.turbo`` and kernel
K14's plain version, ``modem_tpu_torch.ops.bcjr_kernel``) against the JAX
package on the same numpy inputs.

Everything is held exactly (``torch.equal`` on the values): codewords,
extrinsics of the full-block and windowed BCJR with and without a-priori
LLRs, K14's plain version against ``pallas_bcjr.bcjr_windowed`` in
interpret mode (as the JAX tests run it on the CPU) at ``pick_geometry``
and at ``pick_guard`` geometry, and hard decisions of ``decode``. The JAX
functions are jitted once per module.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from modem_tpu.fec.turbo import TurboCode as JTurbo
from modem_tpu.ops import pallas_bcjr

from modem_tpu_torch.fec import TurboCode
from modem_tpu_torch.ops import bcjr_kernel as bk

torch.set_num_threads(1)

K = 40


def _case(k, cws, sigma, seed):
    """Info bits, the JAX codeword and its noisy LLRs (numpy)."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (cws, k)).astype(np.int32)
    cw = np.asarray(JTurbo(k).encode(jnp.asarray(bits)))
    llr = ((1.0 - 2.0 * cw) * 2.0
           + rng.normal(0, sigma, cw.shape)).astype(np.float32)
    return bits, cw, llr


def _parts(llr, k, apriori, seed=3):
    """(lsys, lpar, la, t_sys, t_par) of the first constituent."""
    la = (np.random.default_rng(seed).normal(0, 1.5, (llr.shape[0], k))
          .astype(np.float32) if apriori else
          np.zeros((llr.shape[0], k), np.float32))
    return (llr[:, :k], llr[:, k:2 * k], la, llr[:, 3 * k:3 * k + 3],
            llr[:, 3 * k + 3:3 * k + 6])


def _eq(got, want):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and np.array_equal(got, want)


def _t(parts):
    return [torch.as_tensor(p) for p in parts]


@pytest.fixture(scope="module")
def jx():
    """The JAX forms, jitted once."""
    jt = JTurbo(K)
    return {
        "full": jax.jit(jt._bcjr),
        "win": jax.jit(jt._bcjr_windowed, static_argnames=("window",
                                                            "guard")),
        "pallas": jax.jit(pallas_bcjr.bcjr_windowed, static_argnames=(
            "window", "guard", "interpret")),
        "decode": jax.jit(jt.decode, static_argnames=(
            "iters", "window", "guard", "backend", "early_exit")),
    }


# ---- construction and encoding ----

@pytest.mark.parametrize("k", [40, 64, 1024, 2048])
def test_encode_equal(k):
    bits, cw, _ = _case(k, 3, 0.0, k)
    got = TurboCode(k).encode(torch.as_tensor(bits))
    assert got.dtype == torch.int32
    _eq(got, cw)


def test_encode_batch_dims_and_length():
    rng = np.random.default_rng(4)
    bits = rng.integers(0, 2, (2, 3, K)).astype(np.int32)
    tc, jt = TurboCode(K), JTurbo(K)
    _eq(tc.encode(torch.as_tensor(bits)), jt.encode(jnp.asarray(bits)))
    assert tc.n == jt.n == 3 * K + 12
    with pytest.raises(ValueError, match="expected 40 bits"):
        tc.encode(torch.zeros((1, 39), dtype=torch.int32))


@pytest.mark.parametrize("args,match", [
    ((41,), "no built-in QPP"), ((40, 2, 0), "not a permutation"),
    ((40, 4, 10), "not a permutation")])
def test_qpp_guard(args, match):
    with pytest.raises(ValueError, match=match):
        TurboCode(*args)
    with pytest.raises(ValueError, match=match):
        JTurbo(*args)


def test_interleaver_equal():
    tc, jt = TurboCode(1024), JTurbo(1024)
    x = np.random.default_rng(5).normal(0, 2, (2, 1024)).astype(np.float32)
    _eq(tc._il(torch.as_tensor(x)), jt._il(jnp.asarray(x)))
    _eq(tc._dil(torch.as_tensor(x)), jt._dil(jnp.asarray(x)))
    _eq(tc._dil(tc._il(torch.as_tensor(x))), x)


# ---- one half-iteration ----

@pytest.mark.parametrize("apriori", [False, True], ids=["noap", "ap"])
def test_full_block_bcjr_equal(apriori, jx):
    _, _, llr = _case(K, 6, 1.2, 10)
    parts = _parts(llr, K, apriori)
    _eq(TurboCode(K)._bcjr(*_t(parts)),
        jx["full"](*(jnp.asarray(p) for p in parts)))


@pytest.mark.parametrize("window,guard", [(16, 8), (24, 32), (43, 3)])
@pytest.mark.parametrize("apriori", [False, True], ids=["noap", "ap"])
def test_windowed_bcjr_equal(window, guard, apriori, jx):
    _, _, llr = _case(K, 6, 1.2, 11)
    parts = _parts(llr, K, apriori)
    _eq(bk.bcjr_windowed(*_t(parts), window, guard),
        jx["win"](*(jnp.asarray(p) for p in parts), window=window,
                  guard=guard))


@pytest.mark.parametrize("window", [None, 16, 32], ids=["geometry", "w16",
                                                        "w32"])
@pytest.mark.parametrize("apriori", [False, True], ids=["noap", "ap"])
def test_k14_plain_equal_pallas_interpret(window, apriori, jx):
    """K14's plain version on its rows, at ``pick_geometry`` (window None)
    and at ``pick_guard``'s guard for an explicit window, against the JAX
    kernel in interpret mode: extrinsics exact."""
    _, _, llr = _case(K, 5, 1.2, 12)
    parts = _parts(llr, K, apriori)
    guard = 32 if window is None else bk.pick_guard(window, 32)
    want = jx["pallas"](*(jnp.asarray(p) for p in parts), window=window,
                        guard=guard, interpret=True)
    _eq(bk.bcjr_windowed(*_t(parts), window, guard), want)


@pytest.mark.parametrize("k", [40, 1024])
def test_k14_plain_at_geometry_equals_full_block(k):
    """One window over the whole trellis (``pick_geometry``) gives the
    full-block BCJR bit for bit: the guards' pins set state 0 exactly, and
    the dead states they leave at other values never decide a max. So the
    card (K14 at this geometry) and the CPU route (full block) agree."""
    _, _, llr = _case(k, 4, 1.0, 13 + k)
    for apriori in (False, True):
        parts = _t(_parts(llr, k, apriori))
        _eq(bk.bcjr_windowed(*parts, None, 32), TurboCode(k)._bcjr(*parts))


def test_rows_layout_and_pins():
    """``make_rows``: row ``w*C + c`` holds window ``w`` of codeword ``c``;
    the pin mask is 1 exactly outside the data steps."""
    _, _, llr = _case(K, 3, 1.0, 14)
    ls, lp, la, ts, tp = _t(_parts(llr, K, True))
    rows, n_win = bk.make_rows(ls, lp, la, ts, tp, 16, 5)
    assert n_win == 3 and rows.shape == (3, 9, 26)
    lu = torch.cat([ls + la, ts], -1)
    assert torch.equal(rows[0, 3 * 1 + 2, 5:21], lu[2, 16:32])
    pin = rows[2].reshape(3, 3, 26)
    assert torch.equal(pin[0, :, :5], torch.ones(3, 5))
    assert not pin[1].any()
    assert torch.equal(pin[2, :, 5 + 11:], torch.ones(3, 26 - 16))


@pytest.mark.parametrize("t,guard", [(43, 32), (515, 32), (1027, 32),
                                     (2051, 32), (6147, 32), (1027, 0),
                                     (1027, 40)])
def test_geometry_equal_jax_chip_route(t, guard):
    w, g, _ = pallas_bcjr.pick_geometry(t, guard)
    assert bk.pick_geometry(t, guard) == (w, g)


def test_pick_guard_equal_and_odd_window_refused():
    for window, guard in ((16, 32), (256, 32), (2016, 32), (64, 5)):
        assert bk.pick_guard(window, guard) == pallas_bcjr.pick_guard(
            window, guard)
    with pytest.raises(ValueError, match="odd window"):
        bk.pick_guard(15, 32)
    with pytest.raises(ValueError):
        pallas_bcjr.pick_guard(15, 32)


def test_rows_plain_keeps_a_range():
    rng = np.random.default_rng(15)
    x = rng.normal(0, 3, (3, 4, 30)).astype(np.float32)
    x[2] = rng.random((4, 30)) < 0.3
    rows = torch.as_tensor(x)
    whole = bk.rows_plain(rows, 0, 30)
    assert torch.equal(bk.rows_plain(rows, 7, 11), whole[:, 7:18])
    assert bk.bcjr_rows(rows, 2, 3).shape == (4, 3)


# ---- decode ----

@pytest.mark.parametrize("window", [None, 16], ids=["full", "w16"])
@pytest.mark.parametrize("early", [False, True], ids=["fixed", "early"])
def test_decode_equal(window, early, jx):
    bits, _, llr = _case(K, 8, 1.3, 16)
    want = jx["decode"](jnp.asarray(llr), iters=4, window=window,
                        guard=32, backend="xla", early_exit=early)
    got = TurboCode(K).decode(torch.as_tensor(llr), iters=4, window=window,
                              early_exit=early)
    assert got.dtype == torch.int32
    _eq(got, want)


def test_decode_corrects_errors_and_batches():
    bits, _, llr = _case(K, 6, 1.0, 17)
    hard = (llr[:, :K] < 0).astype(np.int32)
    assert (hard != bits).sum() > 0
    tc = TurboCode(K)
    got = tc.decode(torch.as_tensor(llr))
    _eq(got, bits)
    _eq(tc.decode(torch.as_tensor(llr.reshape(2, 3, -1))),
        bits.reshape(2, 3, K))
    with pytest.raises(ValueError, match="expected 132 LLRs"):
        tc.decode(torch.zeros((1, 131)))


def test_decode_on_cpu_is_the_jax_off_tpu_route():
    """A CPU tensor takes the full-block BCJR for ``window=None`` and the
    windowed one at the caller's guard for an explicit window."""
    tc = TurboCode(K)
    assert tc._half(None, 32, False) == tc._bcjr
    _, _, llr = _case(K, 3, 1.2, 18)
    parts = _t(_parts(llr, K, True))
    _eq(tc._half(16, 8, False)(*parts), bk.bcjr_windowed(*parts, 16, 8))
