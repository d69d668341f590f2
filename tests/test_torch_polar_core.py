"""K15's skip plan (``modem_tpu_torch.ops.sc_kernel``) on the CPU: the
maximal all-frozen subtrees the kernel jumps past, the per-leaf codes and
the packed ``ScPlan`` parameter it reads them from, and SC that skips
exactly those subtrees against the plain version and the JAX package.

* ``skip_plan`` equals a brute-force listing of the maximal aligned
  all-frozen subtrees (every node of the tree whose leaves are all frozen
  and whose parent's are not), for plain codes from n = 2 to 1024 with k =
  1, k = n and between, the shortened and punctured rate-matched codes and
  random masks;
* ``plan_codes`` marks them leaf by leaf, and ``host_plan`` packs the codes
  and the information leaves as ``csrc/polar.cu`` unpacks them;
* a recursion that writes zeros for exactly the plan's subtrees (and so
  never reaches a frozen leaf) decides ``u`` and ``x`` bit for bit as
  ``sc_plain`` and the JAX ``PolarCode._sc`` do, on noisy LLRs and on LLRs
  with exact ties and zeros. The JAX recursion runs eagerly on the CPU, as
  the XLA route it is.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from modem_tpu.fec.polar import PolarCode as JPolar
from modem_tpu.fec.polar import RateMatchedPolar as JRateMatched

from modem_tpu_torch.fec import PolarCode, RateMatchedPolar
from modem_tpu_torch.ops import sc_kernel as sk

torch.set_num_threads(1)

PLAIN = [(2, 1), (2, 2), (4, 1), (4, 3), (8, 1), (8, 4), (8, 8), (16, 1),
         (16, 9), (32, 16), (32, 32), (64, 1), (64, 20), (128, 64),
         (256, 1), (256, 128), (256, 256), (512, 300), (1024, 1),
         (1024, 512), (1024, 1024)]
#: (k, e, n): shortened (rate > 7/16) and punctured codes; the first is
#: nr_like_control_link's
MATCHED = [(100, 180, 256), (300, 400, 512), (60, 200, 256), (40, 100, 128)]
#: (n, share of frozen leaves, seed)
RANDOM = [(16, 0.5, 1), (64, 0.1, 2), (64, 0.9, 3), (256, 0.5, 4),
          (256, 0.95, 5), (1024, 0.7, 6)]


def _random_mask(n, share, seed):
    rng = np.random.default_rng(seed)
    mask = rng.random(n) < share
    mask[rng.integers(n)] = False  # at least one information leaf
    return mask


def _cases():
    out = [(f"plain_{n}_{k}", ("plain", n, k)) for n, k in PLAIN]
    out += [(f"matched_{k}_{e}_{n}", ("matched", k, e, n))
            for k, e, n in MATCHED]
    out += [(f"random_{n}_{int(100 * s)}", ("random", n, s, seed))
            for n, s, seed in RANDOM]
    return out


CASES = _cases()
IDS = [c[0] for c in CASES]


def _code(spec):
    """The port's code of a case and the JAX package's same code."""
    kind = spec[0]
    if kind == "plain":
        return PolarCode(spec[1], spec[2]), JPolar(spec[1], spec[2])
    if kind == "matched":
        k, e, n = spec[1:]
        return (RateMatchedPolar(k, e, n=n).code,
                JRateMatched(k, e, n=n).code)
    n, share, seed = spec[1:]
    mask = _random_mask(n, share, seed)
    code, jcode = PolarCode(n, 1), JPolar(n, 1)
    code.frozen, jcode.frozen = mask.copy(), mask.copy()
    return code, jcode


def _brute_force(frozen):
    """Every node (first leaf, leaves) whose leaves are all frozen and whose
    parent's are not (or the root), in leaf order."""
    n, out = len(frozen), []
    w = n
    while w >= 1:
        for lo in range(0, n, w):
            if not frozen[lo:lo + w].all():
                continue
            plo = lo - lo % (2 * w)
            if w < n and frozen[plo:plo + 2 * w].all():
                continue
            out.append((lo, w))
        w //= 2
    return sorted(out)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_skip_plan_is_the_maximal_all_frozen_subtrees(case):
    code, _ = _code(case[1])
    plan = sk.skip_plan(code.frozen)
    assert plan == _brute_force(code.frozen)
    covered = np.zeros(code.n, bool)
    for lo, w in plan:
        assert lo % w == 0 and not covered[lo:lo + w].any()
        covered[lo:lo + w] = True
    assert np.array_equal(covered, code.frozen)  # every frozen leaf, once


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plan_codes_and_the_packed_parameter(case):
    code, _ = _code(case[1])
    codes = sk.plan_codes(code.frozen)
    want = np.full(code.n, sk.INFO)
    for lo, w in sk.skip_plan(code.frozen):
        want[lo:lo + w] = sk.INSIDE
        want[lo] = int(np.log2(w))
    assert codes.dtype == np.uint8 and np.array_equal(codes, want)
    sk.host_plan(code)
    plan = code._sc_plan
    assert sk.host_plan(code) == sk.host_plan(code)  # built once, kept
    words = np.array(plan.w[:], np.int64)
    info = np.array(plan.info[:], np.int64)
    i = np.arange(code.n)
    assert np.array_equal((words[i >> 3] >> (4 * (i & 7))) & 15, codes)
    assert np.array_equal((info[i >> 5] >> (i & 31)) & 1, ~code.frozen)
    assert not words[(code.n + 7) // 8:].any()
    assert not info[(code.n + 31) // 32:].any()


def _skipping_sc(code, lam):
    """SC that writes zeros for exactly the plan's subtrees: the walk K15
    takes, as a recursion."""
    skipped = set(sk.skip_plan(code.frozen))

    def rec(llr, lo, hi):
        if (lo, hi - lo) in skipped:
            z = torch.zeros(llr.shape[:-1] + (hi - lo,), dtype=torch.int32)
            return z, z
        if hi - lo == 1:
            assert not code.frozen[lo]  # every frozen leaf was skipped
            u = (llr < 0).to(torch.int32)
            return u, u
        half = (hi - lo) // 2
        la, lb = llr[..., :half], llr[..., half:]
        u1, x1 = rec(code._f(la, lb), lo, lo + half)
        u2, x2 = rec(code._g(la, lb, x1), lo + half, hi)
        return torch.cat([u1, u2], -1), torch.cat([x1 ^ x2, x2], -1)

    return rec(lam, 0, code.n)


def _llrs(n, seed):
    """Six noisy rows (+-2 plus Gaussian noise) and six of +-(0, 1, 2),
    with exact ties and zeros."""
    rng = np.random.default_rng(seed)
    noisy = 2.0 * (1.0 - 2.0 * rng.integers(0, 2, (6, n))) + rng.normal(
        0, 1.3, (6, n))
    ties = (1.0 - 2.0 * rng.integers(0, 2, (6, n))) * rng.integers(
        0, 3, (6, n))
    return np.concatenate([noisy, ties]).astype(np.float32)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_skipping_sc_equals_plain_and_jax(case):
    code, jcode = _code(case[1])
    lam = _llrs(code.n, 31 + CASES.index(case))
    u, x = _skipping_sc(code, torch.as_tensor(lam))
    pu, px = sk.sc_plain(code, torch.as_tensor(lam))
    assert torch.equal(u.to(torch.uint8), pu)
    assert torch.equal(x.to(torch.uint8), px)
    ju, jx = jcode._sc(jnp.asarray(lam), 0, code.n)
    assert np.array_equal(u.numpy(), np.asarray(ju))
    assert np.array_equal(x.numpy(), np.asarray(jx))
