"""The QC-LDPC code of the port (``modem_tpu_torch.fec.QcLdpc``) against the
JAX package's ``modem_tpu.fec.QcLdpc`` on the same numpy inputs.

Tolerances: none. The code tables, codewords, syndrome verdicts, hard
decisions and the decoder's posterior totals are equal bit for bit. The JAX
posteriors are read from the decoder's own program: its jaxpr is evaluated
with the operand of the final sign test as an extra output. Each JAX
configuration runs once, in a module fixture.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from modem_tpu.fec import QcLdpc as JLdpc

from modem_tpu_torch.fec import QcLdpc

torch.set_num_threads(1)

BATCH = 4
#: (schedule, iterations, message dtype, early exit)
CASES = [("layered", 1, None, False), ("layered", 10, None, False),
         ("layered", 1, "bf16", False), ("layered", 10, "bf16", False),
         ("layered", 10, None, True), ("flooding", 1, None, False),
         ("flooding", 10, None, False)]
DTYPES = {None: (None, None), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _case_id(case):
    sched, it, dt, ee = case
    return f"{sched}-{it}-{dt or 'f32'}{'-early' if ee else ''}"


def _llrs(code, seed=0, snr_db=2.0):
    """Codewords of random data through BPSK and AWGN at ``snr_db`` Eb/N0,
    as LLRs; codeword 1 has bits pinned to their values by ±inf LLRs (a
    shortened code's known bits), of both signs."""
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 2, (BATCH, code.k)).astype(np.int32)
    cw = np.asarray(code.encode(jnp.asarray(data)))
    sigma2 = 1.0 / (2.0 * 0.5 * 10.0 ** (snr_db / 10.0))
    y = 1.0 - 2.0 * cw + rng.normal(0.0, np.sqrt(sigma2), cw.shape)
    llr = (2.0 * y / sigma2).astype(np.float32)
    for j in (5, 6, 7, 400, 401, 402):
        llr[1, j] = np.inf if cw[1, j] == 0 else -np.inf
    assert np.isinf(llr[1]).sum() == 6 and (llr[1] == -np.inf).any()
    return data, cw, llr


def _jax_decode(code, llr, nlt, **kw):
    """``(decode_full, posteriors)`` of the JAX decoder: its jaxpr evaluated
    with the operand of its last ``nlt`` sign tests (``t < 0``) as extra
    outputs, in the public ``[..., n]`` layout."""
    x = jnp.asarray(llr)
    closed = jax.make_jaxpr(lambda v: code.decode_full(v, **kw))(x)
    lts = [e for e in closed.jaxpr.eqns if e.primitive.name == "lt"][-nlt:]
    prog = closed.jaxpr.replace(
        outvars=list(closed.jaxpr.outvars) + [e.invars[0] for e in lts])
    out, *post = (np.asarray(v) for v in
                  jax.core.eval_jaxpr(prog, closed.consts, x))
    if nlt == 1:  # layered: one [nb, z, *batch] tensor
        post = np.moveaxis(post[0], (0, 1), (-2, -1)).reshape(llr.shape)
    else:         # flooding: one [*batch, z] tensor a block column
        post = np.stack(post, axis=-2).reshape(llr.shape)
    return out, post


@pytest.fixture(scope="module")
def runs():
    code = JLdpc()
    data, cw, llr = _llrs(code)
    out = {}
    for case in CASES:
        sched, it, dt, ee = case
        out[case] = _jax_decode(
            code, llr, 1 if sched == "layered" else code.nb, iters=it,
            schedule=sched, msg_dtype=DTYPES[dt][0], early_exit=ee)
    return dict(data=data, cw=cw, llr=llr, dec=out)


@pytest.mark.parametrize("args", [(27, 12, 24, 3, 11), (27, 6, 24, 3, 11),
                                  (27, 12, 24, 3, 5)],
                         ids=["648-324", "648-486", "seed5"])
def test_code_tables_equal(args):
    code = QcLdpc(*args)
    code.check_tables(QcLdpc.tables_of(JLdpc(*args)))
    assert (code.n, code.k, code.kb) == (args[2] * args[0],
                                         (args[2] - args[1]) * args[0],
                                         args[2] - args[1])


def test_check_tables_catches_a_difference():
    tables = QcLdpc.tables_of(JLdpc(seed=5))
    with pytest.raises(ValueError, match="differs"):
        QcLdpc().check_tables(tables)


def test_encode_and_syndrome_equal(runs):
    code, jcode = QcLdpc(), JLdpc()
    got = code.encode(torch.as_tensor(runs["data"]))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), runs["cw"])
    bad = runs["cw"].copy()
    bad[2, 7] ^= 1
    bad[3, 600] ^= 1
    for cw in (runs["cw"], bad):
        want = np.asarray(jcode.syndrome_ok(jnp.asarray(cw)))
        np.testing.assert_array_equal(
            code.syndrome_ok(torch.as_tensor(cw)).numpy(), want)
    assert list(code.syndrome_ok(torch.as_tensor(bad)).numpy()) == [
        True, True, False, False]


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_decode_full_and_posteriors_equal(runs, case):
    sched, it, dt, ee = case
    code = QcLdpc()
    llr = torch.as_tensor(runs["llr"])
    kw = dict(iters=it, schedule=sched, msg_dtype=DTYPES[dt][1],
              early_exit=ee)
    want, want_post = runs["dec"][case]
    post = code.posteriors(llr, **kw)
    assert not torch.isnan(post).any()
    np.testing.assert_array_equal(post.numpy(), want_post)
    np.testing.assert_array_equal(code.decode_full(llr, **kw).numpy(), want)
    np.testing.assert_array_equal(code.decode(llr, **kw).numpy(),
                                  want[..., :code.k])


def test_decode_converges_with_pinned_bits():
    """At 3 dB the layered decoder clears every codeword, the pinned one
    included, and early exit stops with the same decisions."""
    code = QcLdpc()
    _, cw, llr = _llrs(JLdpc(), snr_db=3.0)
    llr = torch.as_tensor(llr)
    for ee in (False, True):
        full = code.decode_full(llr, iters=10, early_exit=ee)
        np.testing.assert_array_equal(full.numpy(), cw)


def test_batch_shapes(runs):
    code = QcLdpc()
    llr = torch.as_tensor(runs["llr"])
    both = code.decode(llr.reshape(2, 2, -1), iters=3)
    assert both.shape == (2, 2, code.k)
    np.testing.assert_array_equal(both.reshape(BATCH, -1).numpy(),
                                  code.decode(llr, iters=3).numpy())
    one = code.encode(torch.as_tensor(runs["data"][0]))
    np.testing.assert_array_equal(one.numpy(), runs["cw"][0])


@pytest.mark.parametrize("call,match", [
    (lambda c, llr: c.decode(llr, schedule="bogus"), "unknown schedule"),
    (lambda c, llr: c.decode(llr, schedule="flooding", early_exit=True),
     "early_exit requires schedule='layered'"),
    (lambda c, llr: c.decode(llr[..., :-1]), "expected 648 LLRs, got 647"),
    (lambda c, llr: c.decode(llr[..., :-1], schedule="flooding"),
     "expected 648 LLRs, got 647"),
    (lambda c, llr: c.encode((llr[..., :323] > 0) * 1),
     "expected 324 data bits, got 323"),
], ids=["schedule", "early-flooding", "llrs", "llrs-flooding", "data"])
def test_value_errors_equal(runs, call, match):
    llr = runs["llr"]
    with pytest.raises(ValueError, match=match):
        call(QcLdpc(), torch.as_tensor(llr))
    with pytest.raises(ValueError, match=match):
        call(JLdpc(), jnp.asarray(llr))


@pytest.mark.parametrize("kwargs,match", [
    (dict(mb=24, nb=24), "need nb > mb"),
    (dict(mb=2, nb=24, col_weight=3), "col_weight cannot exceed mb"),
])
def test_constructor_errors_equal(kwargs, match):
    for cls in (QcLdpc, JLdpc):
        with pytest.raises(ValueError, match=match):
            cls(**kwargs)
