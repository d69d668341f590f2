"""The binary BCH codes of the port (``modem_tpu_torch.fec.bch``) against
the JAX package's (``modem_tpu.fec.bch``) on the same numpy inputs, on the
CPU. The cases mirror ``tests/test_bch.py``.

Everything is exact: the host tables equal the JAX object's, and
``encode``, ``syndromes`` and ``decode``'s messages and ``ok`` flags equal
the JAX code's bit for bit, up to ``t`` errors and beyond (the GF(256)
products come from a table here and bit by bit there: the same values).
The JAX decoders are jitted once per code in a module fixture.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from modem_tpu.fec import bch as jbch

from modem_tpu_torch import Rates, qpsk_reference_chain
from modem_tpu_torch.fec import bch as tbch

torch.set_num_threads(1)


def _equal(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.array_equal(got, want)


@pytest.fixture(scope="module")
def codes():
    """t -> (JAX code, port code, jitted JAX decode, jitted syndromes)."""
    out = {}
    for t in (2, 8):
        j = jbch.Bch(t=t)
        out[t] = (j, tbch.Bch(t=t), jax.jit(j.decode), jax.jit(j.syndromes))
    return out


@pytest.mark.parametrize("t", [2, 5, 8])
def test_tables_equal_jax(t):
    code = tbch.Bch(t=t)
    code.check_tables(tbch.Bch.tables_of(jbch.Bch(t=t)))
    assert (code.n, code.k, code.p) == (255, jbch.Bch(t=t).k,
                                        jbch.Bch(t=t).p)
    other = tbch.Bch.tables_of(jbch.Bch(t=t + 1))
    with pytest.raises(ValueError, match="differs"):
        code.check_tables(other)


def test_standard_dimensions():
    want = {1: 247, 2: 239, 3: 231, 4: 223, 5: 215, 6: 207, 7: 199, 8: 191}
    for t, k in want.items():
        assert tbch.Bch(t=t).k == k
    assert tbch.bch_255_191().k == 191 and tbch.bch_255_239().k == 239
    g = tbch.bch_255_239()._gen
    r = np.zeros(256, np.int64)
    r[255] = r[0] = 1                      # x^255 - 1 over GF(2)
    for d in range(255, len(g) - 2, -1):
        if r[d]:
            r[d - len(g) + 1: d + 1] ^= g
    assert not r.any()


@pytest.mark.parametrize("t", [2, 8])
def test_encode_and_syndromes_equal_jax(codes, t):
    j, code, _, jsyn = codes[t]
    rng = np.random.default_rng(t)
    bits = rng.integers(0, 2, (7, code.k)).astype(np.int32)
    cw = code.encode(torch.as_tensor(bits))
    assert cw.dtype == torch.int32
    _equal(cw, j.encode(jnp.asarray(bits)))
    assert not code.syndromes(cw).any()
    noisy = cw.numpy() ^ (rng.random(cw.shape) < 0.03).astype(np.int32)
    _equal(code.syndromes(torch.as_tensor(noisy)), jsyn(jnp.asarray(noisy)))


@pytest.mark.parametrize("t,nerr", [(8, 0), (8, 1), (8, 4), (8, 8), (8, 9),
                                    (8, 12), (2, 1), (2, 2), (2, 3), (2, 6)])
def test_decode_equals_jax(codes, t, nerr):
    """Up to t errors every message back and every ``ok`` true; beyond t
    the port decides as the JAX decoder does, flags and (mis)corrections
    included."""
    j, code, jdec, _ = codes[t]
    rng = np.random.default_rng(10 * t + nerr)
    bits = rng.integers(0, 2, (12, code.k)).astype(np.int32)
    cw = code.encode(torch.as_tensor(bits)).numpy().copy()
    for r in range(cw.shape[0]):
        cw[r, rng.choice(code.n, size=nerr, replace=False)] ^= 1
    msg, ok = code.decode(torch.as_tensor(cw))
    jmsg, jok = jdec(jnp.asarray(cw))
    _equal(msg, jmsg)
    _equal(ok, jok)
    assert ok.dtype == torch.bool
    if nerr <= t:
        assert bool(ok.all())
        _equal(msg, bits)
    elif t == 8:
        assert not bool(ok.any())


def test_batched_and_hooks():
    code = tbch.bch_255_239()
    rng = np.random.default_rng(4)
    bits = torch.as_tensor(rng.integers(0, 2, (2, 3, code.k)),
                           dtype=torch.int32)
    cw = code.encode_bits(bits)
    assert cw.shape == (2, 3, 255)
    cw[..., 7] ^= 1
    msg, ok = code.decode_bits(cw)
    assert ok.shape == (2, 3) and bool(ok.all())
    assert torch.equal(msg, bits)


def test_checks():
    for t in (0, 32):
        with pytest.raises(ValueError, match="1 <= t <= 31"):
            tbch.Bch(t=t)
    code = tbch.bch_255_191()
    with pytest.raises(ValueError, match="expected 191 bits"):
        code.encode(torch.zeros((2, 190), dtype=torch.int32))
    with pytest.raises(ValueError, match="expected 255 bits"):
        code.decode(torch.zeros((2, 254), dtype=torch.int32))


def test_bch_cleans_sparse_chain_errors(codes):
    """BCH(255, 191) over the flagship chain at -2 dB (test_bch.py's chain
    case, noise drawn by numpy): the raw stream has sparse errors, every
    codeword decodes exactly, as the JAX decoder decodes it."""
    j, code, jdec, _ = codes[8]
    chain = qpsk_reference_chain(Rates(1250, 10000), device="cpu")
    rng = np.random.default_rng(5)
    data = torch.as_tensor(rng.integers(0, 2, (16, code.k)), dtype=torch.int32)
    cw = code.encode(data)
    i, q = chain.tx(torch.cat([cw, torch.zeros((16, 1), dtype=torch.int32)],
                              -1))
    p = float(torch.mean(i * i + q * q))
    sigma = (p / 10 ** (-2.0 / 10) / 2) ** 0.5
    ni = i + sigma * torch.as_tensor(rng.standard_normal(i.shape),
                                     dtype=torch.float32)
    nq = q + sigma * torch.as_tensor(rng.standard_normal(q.shape),
                                     dtype=torch.float32)
    hard = chain.rx((ni, nq), 128)[..., :code.n]
    assert int((hard != cw).sum()) > 3
    msg, ok = code.decode(hard)
    jmsg, jok = jdec(jnp.asarray(hard.numpy()))
    _equal(msg, jmsg)
    _equal(ok, jok)
    assert bool(ok.all()) and torch.equal(msg, data)
