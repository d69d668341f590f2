"""The host side of K6's and K7's core (``modem_tpu_torch.ops.fsk_kernel``):
the tone table's plain twin against the samples of ``fsk_tx_plain``, the
route pickers against ``csrc/fsk.cu``'s caps, the table cache, and the
loopbacks on CPU tensors (their plain versions) against
``modem_tpu.ops.pallas_fsk`` in interpret mode, as ``tests/test_pallas_fsk.py``
runs it.

Tolerances: the table and the samples exactly (the same float32 operations
in the same order); noiseless decisions exactly; noisy K6 decisions on
>= 99.9% of symbols (libm rounding may move a mean across a midpoint), noisy
K7 decisions exactly (as ``tests/test_torch_fsk.py`` holds them).
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from modem_tpu import Rates as JRates
from modem_tpu.models import fsk as jfsk
from modem_tpu.ops import pallas_fsk as jpf

from modem_tpu_torch import Rates
from modem_tpu_torch.models import fsk as tfsk
from modem_tpu_torch.models.base import f32
from modem_tpu_torch.ops import fsk_kernel as fk

torch.set_num_threads(1)

SR = 10000
JR, TR = JRates(1250, SR), Rates(1250, SR)
FSK_CU = Path(fk.__file__).resolve().parents[1] / "csrc" / "fsk.cu"


def _phase_units(fnum, pnum, den, sps):
    """u of every sample of a ``[C, K]`` program, ``[C, K*sps]`` int64."""
    n = fnum.shape[-1] * sps
    t = (torch.arange(n, dtype=torch.int64) + 1) % den
    f = torch.repeat_interleave(fnum.to(torch.int64), sps, dim=-1)
    p = torch.repeat_interleave(pnum.to(torch.int64), sps, dim=-1)
    return (f * t + p) % den


@pytest.mark.parametrize("den", [10000, 9973, fk.TONE_CAP])
@pytest.mark.parametrize("qshift", [f32(-math.pi / 2), f32(0.3)])
def test_tone_table_is_the_samples(den, qshift):
    """Row u of the table is, bit for bit, every sample of phase u that the
    plain synthesis makes, for programs with negative and large values."""
    rng = np.random.default_rng(den)
    fnum = torch.as_tensor(rng.integers(-den // 2, den // 2, (8, 400))
                           .astype(np.int32))
    pnum = torch.as_tensor(rng.integers(-3 * den, 3 * den, (8, 400))
                           .astype(np.int32))
    amp = f32(0.7)
    table = fk.tone_table_plain(den, amp, qshift)
    assert table.shape == (den, 2) and table.dtype == torch.float32
    i, q = fk.fsk_tx_plain(fnum, pnum, den, 8, amp, qshift)
    u = _phase_units(fnum, pnum, den, 8)
    assert torch.equal(i, table[u, 0]) and torch.equal(q, table[u, 1])
    assert len(torch.unique(u)) > den // 2  # most of the table was read


def test_caps_agree_with_the_c_source():
    """The wrappers' caps are the C entries' (which refuse the core past
    them), so the two choose alike."""
    src = FSK_CU.read_text()
    cap = int(re.search(r"constexpr int kToneCap = (\d+);", src).group(1))
    msk = int(re.search(r"constexpr int kMskCap = (\d+);", src).group(1))
    assert (cap, msk) == (fk.TONE_CAP, fk.MSK_CAP)


def test_route_pickers():
    assert [fk.fsk_route(d) for d in (1, 10000, fk.TONE_CAP)] == ["core"] * 3
    assert [fk.fsk_route(d) for d in (fk.TONE_CAP + 1, 20000)] == ["long"] * 2
    assert [fk.msk_route(s) for s in (1, 4, fk.MSK_CAP)] == ["core"] * 3
    assert fk.msk_route(fk.MSK_CAP + 1) == "long"
    for bad in (0, -4):
        with pytest.raises(ValueError):
            fk.fsk_route(bad)
        with pytest.raises(ValueError):
            fk.msk_route(bad)


@pytest.fixture
def launches(monkeypatch):
    """The route each launch would take: ``_fsk_launch``'s tone and
    ``_msk_launch``'s core flag, recorded instead of launching."""
    seen = []

    def fsk(*args, tone):
        seen.append(("fsk", args[3], tone))
        return args[0]

    def msk(*args, core):
        seen.append(("msk", args[2], core))
        return args[0]

    monkeypatch.setattr(fk, "_fsk_launch", fsk)
    monkeypatch.setattr(fk, "_msk_launch", msk)
    fk.tone_table.cache_clear()
    yield seen
    fk.tone_table.cache_clear()


@pytest.mark.parametrize("den", [10000, fk.TONE_CAP, fk.TONE_CAP + 1, 20000])
def test_fsk_wrapper_routes_by_den(launches, den):
    """Dens up to the cap go to the core with their table, past it to the
    long route with none; an empty input makes no table."""
    f = torch.zeros((2, 5), dtype=torch.int32)
    targets = torch.zeros(2)
    fk.fsk_chain_kernel(f, f, targets, den, 8, 1.0, 0.5, 1, 256, None, 0)
    fk.fsk_chain_kernel(f[:, :0], f[:, :0], targets, den, 8, 1.0, 0.5, 1, 256,
                        None, 0)
    (_, d, tone), (_, _, none) = launches
    assert d == den and none is None
    if den <= fk.TONE_CAP:
        assert torch.equal(tone, fk.tone_table_plain(den, 1.0, 0.5))
    else:
        assert tone is None
    with pytest.raises(ValueError):
        fk.fsk_chain_kernel(f, f, targets, 0, 8, 1.0, 0.5, 1, 256, None, 0)


def test_msk_wrapper_routes_by_spb(launches):
    s = torch.ones((2, 5), dtype=torch.int32)
    for spb in (2, 4, fk.MSK_CAP, fk.MSK_CAP + 1, 100):
        fk.msk_chain_kernel(s, s, spb, 1.0, 1, 256, None, 0)
    assert [(spb, core) for _, spb, core in launches] == [
        (2, True), (4, True), (fk.MSK_CAP, True), (fk.MSK_CAP + 1, False),
        (100, False)]
    with pytest.raises(ValueError):
        fk.msk_chain_kernel(s, s, 0, 1.0, 1, 256, None, 0)


def test_tone_table_cache(launches):
    """One table per (den, amp, qshift, device): later calls get the same
    tensor; another value of any key makes another."""
    cpu, meta = torch.device("cpu"), torch.device("meta")
    first = fk.tone_table(10000, 1.0, 0.5, cpu)
    assert fk.tone_table(10000, 1.0, 0.5, cpu) is first
    others = [fk.tone_table(*key) for key in (
        (9973, 1.0, 0.5, cpu), (10000, 0.5, 0.5, cpu), (10000, 1.0, 0.0, cpu),
        (10000, 1.0, 0.5, meta))]
    assert all(o is not first for o in others)
    assert others[-1].device == meta
    info = fk.tone_table.cache_info()
    assert (info.hits, info.misses) == (1, 5)
    f = torch.zeros((2, 5), dtype=torch.int32)
    before = fk.FSK_TONE_KERNEL.launches
    for _ in range(3):
        fk.fsk_chain_kernel(f, f, torch.zeros(2), 10000, 8, 1.0, 0.5, 1, 256,
                            None, 0)
    assert fk.tone_table.cache_info().misses == 5
    assert fk.FSK_TONE_KERNEL.launches == before  # no kernel on the CPU


@pytest.fixture
def plain_only(monkeypatch):
    """Fails any launch; counts the plain versions' calls."""
    calls = {"fsk": 0, "msk": 0}

    def refuse(*a, **k):
        raise AssertionError("a CPU tensor reached a kernel launcher")

    for name in ("_fsk_launch", "_msk_launch", "fsk_chain_kernel",
                 "msk_chain_kernel", "tone_table_kernel"):
        monkeypatch.setattr(fk, name, refuse)
    for kind, name in (("fsk", "fsk_chain_plain"), ("msk", "msk_chain_plain")):
        real = getattr(fk, name)

        def counted(*a, _real=real, _kind=kind):
            calls[_kind] += 1
            return _real(*a)

        monkeypatch.setattr(fk, name, counted)
    return calls


SCHEMES = [
    ("bfsk", lambda: jfsk.BFSK(200, SR, 1.0), lambda: tfsk.BFSK(200, SR, 1.0)),
    ("16mfsk_default", lambda: jfsk.MFSK(4, 50, SR, 1.0, "default"),
     lambda: tfsk.MFSK(4, 50, SR, 1.0, "default")),
]


@pytest.mark.parametrize("snr", [None, 16.0])
@pytest.mark.parametrize("scheme", SCHEMES, ids=[s[0] for s in SCHEMES])
def test_fused_fsk_chain_on_cpu_is_the_plain_version(plain_only, scheme, snr):
    _, mj, mt = scheme
    js, ts = mj(), mt()
    syms = np.random.default_rng(31).integers(
        0, 1 << js.bits_per_symbol, (5, 64)).astype(np.int32)
    kw = {"chunk_sym": 32, "snr_db": snr, "seed": 17}
    want = np.asarray(jpf.fused_fsk_chain(jnp.asarray(syms), js, JR, **kw))
    got = fk.fused_fsk_chain(torch.as_tensor(syms), ts, TR, **kw).numpy()
    assert plain_only["fsk"] == 1
    if snr is None:
        assert np.array_equal(got, want) and np.array_equal(got, syms)
    else:
        assert np.mean(got == want) >= 0.999


@pytest.mark.parametrize("snr", [None, 5.0])
@pytest.mark.parametrize("spb", [2, 4])
def test_fused_msk_slots_on_cpu_is_the_plain_version(plain_only, spb, snr):
    rng = np.random.default_rng(spb)
    s0, s1 = ((2 * rng.integers(0, 2, (5, 64)) - 1).astype(np.int32)
              for _ in range(2))
    kw = {"chunk_slots": 32, "snr_db": snr, "seed": -9}
    want = np.asarray(jpf.fused_msk_slots(jnp.asarray(s0), jnp.asarray(s1),
                                          spb, 0.8, **kw))
    got = fk.fused_msk_slots(torch.as_tensor(s0), torch.as_tensor(s1), spb,
                             0.8, **kw).numpy()
    assert plain_only["msk"] == 1
    assert np.array_equal(got, want)
    if snr is None:
        assert np.array_equal(got, (s0 * s1 > 0).astype(np.int32))
