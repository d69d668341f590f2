"""The host side of K6's and K7's core and of K8's and K10's TX core
(``modem_tpu_torch.ops.fsk_kernel``): the tone table's plain twin against
the samples of ``fsk_tx_plain``; NumPy models of the TX core's walk (its
32-bit expressions, step by step) against the plain phase and the plain
waveforms; the route pickers against ``csrc/fsk.cu``'s caps, the wrappers'
routes, the table cache shared by K6 and K8; and the loopbacks on CPU
tensors (their plain versions) against ``modem_tpu.ops.pallas_fsk`` in
interpret mode, as ``tests/test_pallas_fsk.py`` runs it.

Tolerances: the table, the walks and the samples exactly (the same float32
operations in the same order); noiseless decisions exactly; noisy K6
decisions on >= 99.9% of symbols (libm rounding may move a mean across a
midpoint), noisy K7 decisions exactly (as ``tests/test_torch_fsk.py`` holds
them).
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

from modem_tpu_torch import FskChain, Rates
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
    sps = int(re.search(r"constexpr int kTxSps = (\d+);", src).group(1))
    assert (cap, msk, sps) == (fk.TONE_CAP, fk.MSK_CAP, fk.TX_SPS)


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


def test_fsk_tx_route_picker():
    """K8's core at sps TX_SPS up to the tone table's cap; past it, and at
    any other sps, the long route. (K10 routes by K7's ``msk_route``.)"""
    assert [fk.fsk_tx_route(d, 8) for d in (1, 10000, fk.TONE_CAP)] == [
        "core"] * 3
    assert [fk.fsk_tx_route(d, s) for d, s in (
        (fk.TONE_CAP + 1, 8), (20000, 8), (10000, 2), (10000, 4),
        (10000, 16))] == ["long"] * 5
    for den, sps in ((0, 8), (-4, 8), (10000, 0), (10000, -8)):
        with pytest.raises(ValueError):
            fk.fsk_tx_route(den, sps)


def _tx_walk(n_pieces, n, den, stride):
    """The TX core's ``TxWalk``: for each step of the grid, the active
    threads' pieces ``p`` with their ``s`` (row position of the piece's
    first sample) and ``t = (s + 1) mod den``, from the kernel's 32-bit
    expressions (a thread's start, then the stride's residues and one
    less-n where s wraps); ``stride`` threads in the grid. Asserts that each
    unsigned intermediate fits 32 bits."""
    p0 = np.arange(min(stride, n_pieces), dtype=np.int64)
    assert 4 * stride < 2 ** 32
    s = 4 * p0 % n
    t = (s + 1) % den
    ds = 4 * stride % n
    dt, nd = ds % den, n % den
    p = p0.copy()
    while len(p):
        yield p, s, t
        p = p + stride
        s, t = s + ds, t + dt
        assert s.max(initial=0) < 2 ** 32
        t = np.where(t >= den, t - den, t)
        wrap = s >= n
        s = np.where(wrap, s - n, s)
        t = np.where(wrap, np.where(t >= nd, t - nd, t + den - nd), t)
        keep = p < n_pieces
        p, s, t = p[keep], s[keep], t[keep]


def _k8_units(fnum, pnum, den, stride):
    """The phase units of every sample as K8's core makes them, ``[C,
    K*8]``: the piece's first u = (fm*t + pm) mod den (residues of the
    symbol's program), then u + fm less den, 4 samples a piece."""
    c, k = fnum.shape
    ff, fp = fnum.reshape(-1).astype(np.int64), pnum.reshape(-1).astype(
        np.int64)
    out = np.full(c * k * 8, -1, np.int64)
    for p, _, t in _tx_walk(2 * c * k, 8 * k, den, stride):
        fm, pm = ff[p // 2] % den, fp[p // 2] % den
        assert (fm * t + pm).max(initial=0) < 2 ** 32
        u = (fm * t + pm) % den
        for i in range(4):
            out[4 * p + i] = u
            u = u + fm
            u = np.where(u >= den, u - den, u)
    return out.reshape(c, 8 * k)


# (den, fnum range, pnum range, shape, strides): MFSK's default map
# (negative fnum), large and negative pnum, rows past den (10400 samples
# a row at 1300 symbols), rows shorter than a stride; strides of one
# thread, a block, and the card's persistent grid
TX_WALKS = [
    (10000, (-5000, 5000), (-3 * 10000, 3 * 10000), (3, 1300), (1, 1024)),
    (9973, (-4986, 4986), (-2 ** 31, 2 ** 31 - 1), (5, 7), (3, 1024)),
    (fk.TONE_CAP, (-2 ** 31, 2 ** 31 - 1), (-2 ** 31, 2 ** 31 - 1),
     (2, 1600), (264 * 1024, 7)),
    (10000, (-15, 16), (0, 10000), (130, 3), (1024, 2048)),
]


@pytest.mark.parametrize("case", TX_WALKS, ids=lambda c: f"den{c[0]}_{c[3]}")
def test_k8_core_walk_is_the_plain_phase(case):
    """K8's core's phase at every sample, walked from its 32-bit
    expressions over each stride, is the plain ``_phase_units``; the tone
    table gathered in the core's order is ``fsk_tx_plain`` bit for bit."""
    den, fr, pr, shape, strides = case
    rng = np.random.default_rng(den + shape[1])
    fnum = rng.integers(*fr, shape, endpoint=True).astype(np.int32)
    pnum = rng.integers(*pr, shape, endpoint=True).astype(np.int32)
    want = _phase_units(torch.as_tensor(fnum), torch.as_tensor(pnum), den,
                        8).numpy()
    for stride in strides:
        assert np.array_equal(_k8_units(fnum, pnum, den, stride), want)
    amp, qshift = f32(0.9), f32(-math.pi / 2)
    table = fk.tone_table_plain(den, amp, qshift)
    u = torch.as_tensor(_k8_units(fnum, pnum, den, strides[0]))
    i, q = fk.fsk_tx_plain(torch.as_tensor(fnum), torch.as_tensor(pnum), den,
                           8, amp, qshift)
    assert torch.equal(table[u, 0], i) and torch.equal(table[u, 1], q)


def _k10_samples(s0, s1, spb, amp, stride):
    """K10's core, modelled: the walk's entry e = (s + 1) mod 4spb and the
    slot (its place j walked beside, the gains reloaded where j wraps)
    of every sample, then the pairs times the gains, in the kernel's
    order; the last piece stops at the last sample. Returns ``(i, q)``."""
    c, k = s0.shape
    n, den = k * spb, 4 * spb
    total = c * n
    w = f32(2 * math.pi / den)
    theta = torch.arange(den, dtype=torch.int64).to(torch.float32) * w
    pairs = torch.stack([torch.cos(theta), torch.sin(theta)], -1)
    gi = amp * torch.as_tensor(s0.reshape(-1)).to(torch.float32)
    gq = -amp * torch.as_tensor(s1.reshape(-1)).to(torch.float32)
    entry = np.full(total, -1, np.int64)
    slot_of = np.full(total, -1, np.int64)
    f0 = 4 * np.arange(min(stride, (total + 3) // 4), dtype=np.int64)
    g, j = f0 // spb, f0 % spb
    dg, dj = 4 * stride // spb, 4 * stride % spb
    for p, s, t in _tx_walk((total + 3) // 4, n, den, stride):
        g, j = g[:len(p)], j[:len(p)]
        slot, jj, ss, e = g.copy(), j.copy(), s.copy(), t.copy()
        for i in range(4):
            if i:
                jj = jj + 1
                nxt = jj == spb
                jj, slot = np.where(nxt, 0, jj), np.where(nxt, slot + 1, slot)
                ss = ss + 1
                row = ss == n
                e = np.where(row, 1, np.where(e + 1 == den, 0, e + 1))
                ss = np.where(row, 0, ss)
            f = 4 * p + i
            ok = f < total
            entry[f[ok]], slot_of[f[ok]] = e[ok], slot[ok]
        g, j = g + dg, j + dj
        g, j = np.where(j >= spb, g + 1, g), np.where(j >= spb, j - spb, j)
    flat = np.arange(total)
    assert np.array_equal(entry, (flat % n + 1) % den)
    assert np.array_equal(slot_of, flat // spb)
    e, sl = torch.as_tensor(entry), torch.as_tensor(slot_of)
    return ((gi[sl] * pairs[e, 0]).reshape(c, n),
            (gq[sl] * pairs[e, 1]).reshape(c, n))


@pytest.mark.parametrize("spb", [1, 2, 3, 4, 8, fk.MSK_CAP])
@pytest.mark.parametrize("shape", [(7, 1), (7, 3), (130, 3), (3, 603)],
                         ids=str)
def test_k10_core_pairs_are_the_plain_samples(spb, shape):
    """K10's core, its 4*spb pairs times the slots' gains in the walk's
    order, is ``msk_tx_plain`` bit for bit, rows off 16-byte boundaries and
    a last piece of fewer than 4 samples among them, at strides of a few
    threads, a block and the card's grid."""
    rng = np.random.default_rng(spb * 1000 + shape[1])
    s0, s1 = ((2 * rng.integers(0, 2, shape) - 1).astype(np.int32)
              for _ in range(2))
    amp = f32(0.7)
    want = fk.msk_tx_plain(torch.as_tensor(s0), torch.as_tensor(s1), spb, amp)
    for stride in (5, 1024, 264 * 1024):
        got = _k10_samples(s0, s1, spb, amp, stride)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.fixture
def launches(monkeypatch):
    """The route each launch would take: ``_fsk_launch``'s and
    ``_fsk_tx_launch``'s tone, ``_msk_launch``'s and ``_msk_tx_launch``'s
    core flag, recorded instead of launching."""
    seen = []

    def fsk(*args, tone):
        seen.append(("fsk", args[3], tone))
        return args[0]

    def msk(*args, core):
        seen.append(("msk", args[2], core))
        return args[0]

    def fsk_tx(*args, tone):
        seen.append(("fsk_tx", args[2:4], tone))
        return args[0], args[0]

    def msk_tx(*args, core):
        seen.append(("msk_tx", args[2], core))
        return args[0], args[0]

    monkeypatch.setattr(fk, "_fsk_launch", fsk)
    monkeypatch.setattr(fk, "_msk_launch", msk)
    monkeypatch.setattr(fk, "_fsk_tx_launch", fsk_tx)
    monkeypatch.setattr(fk, "_msk_tx_launch", msk_tx)
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


@pytest.mark.parametrize("sps", [8, 4])
@pytest.mark.parametrize("den", [10000, fk.TONE_CAP, fk.TONE_CAP + 1, 20000])
def test_fsk_tx_wrapper_routes(launches, den, sps):
    """K8 at sps 8 up to the cap goes to the core with K6's table, else to
    the long route with none; an empty input makes no table."""
    f = torch.zeros((2, 5), dtype=torch.int32)
    fk.fsk_tx_kernel(f, f, den, sps, 1.0, 0.5)
    fk.fsk_tx_kernel(f[:, :0], f[:, :0], den, sps, 1.0, 0.5)
    (kind, (d, s), tone), (_, _, none) = launches
    assert (kind, d, s) == ("fsk_tx", den, sps) and none is None
    if sps == 8 and den <= fk.TONE_CAP:
        assert tone is fk.tone_table(den, 1.0, 0.5, torch.device("cpu"))
    else:
        assert tone is None


def test_msk_tx_wrapper_routes(launches):
    s = torch.ones((2, 5), dtype=torch.int32)
    for spb in (1, 2, 4, 8, fk.MSK_CAP, fk.MSK_CAP + 1, 100):
        fk.msk_tx_kernel(s, s, spb, 1.0)
    assert [(k, spb, core) for k, spb, core in launches] == [
        ("msk_tx", spb, spb <= fk.MSK_CAP)
        for spb in (1, 2, 4, 8, fk.MSK_CAP, fk.MSK_CAP + 1, 100)]
    with pytest.raises(ValueError):
        fk.msk_tx_kernel(s, s, 0, 1.0)


@pytest.mark.parametrize("map_", ["increase", "default"])
def test_chain_tx_and_loopback_share_one_tone_table(launches, monkeypatch,
                                                    map_):
    """A chain's ``tx_fused`` then ``roundtrip_fused`` (their kernel
    wrappers, reached here from CPU tensors) make one tone table in all, and
    K8 and K6 get the same tensor; the far chain's den makes none."""
    monkeypatch.setattr(fk, "fsk_tx_plain", fk.fsk_tx_kernel)
    monkeypatch.setattr(fk, "fsk_chain_plain", fk.fsk_chain_kernel)
    for sr, tables in ((SR, 1), (20000, 0)):
        fk.tone_table.cache_clear()
        rates = Rates(sr // 8, sr)
        chain = FskChain(tfsk.MFSK(4, 50, sr, 1.0, map_), rates,
                         2 * np.arange(16), 2 * math.pi * 50 / sr,
                         device="cpu")
        bits = torch.randint(0, 2, (3, 4 * 40), generator=torch.Generator()
                             .manual_seed(sr))
        chain.tx_fused(bits)
        chain.roundtrip_fused(bits)
        chain.tx_fused(bits)
        assert fk.tone_table.cache_info().misses == tables
        tones = [t for _, _, t in launches[-3:]]
        assert [k for k, _, _ in launches[-3:]] == ["fsk_tx", "fsk", "fsk_tx"]
        if tables:
            assert tones[0] is tones[1] is tones[2]
        else:
            assert tones == [None] * 3


@pytest.fixture
def plain_only(monkeypatch):
    """Fails any launch; counts the plain versions' calls."""
    calls = {"fsk": 0, "msk": 0}

    def refuse(*a, **k):
        raise AssertionError("a CPU tensor reached a kernel launcher")

    for name in ("_fsk_launch", "_msk_launch", "fsk_chain_kernel",
                 "msk_chain_kernel", "tone_table_kernel", "_fsk_tx_launch",
                 "_msk_tx_launch", "fsk_tx_kernel", "msk_tx_kernel"):
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


@pytest.mark.parametrize("scheme", SCHEMES, ids=[s[0] for s in SCHEMES])
def test_fused_tx_on_cpu_is_the_plain_version(plain_only, scheme):
    """K8 and K10 on CPU tensors reach no launcher: their plain versions,
    against ``pallas_fsk`` in interpret mode."""
    _, mj, mt = scheme
    js, ts = mj(), mt()
    syms = np.random.default_rng(5).integers(
        0, 1 << js.bits_per_symbol, (3, 61)).astype(np.int32)
    jp, _ = js.program(jnp.asarray(syms), js.init_state(syms.shape[:-1]), JR,
                       0)
    tp, _ = ts.program(torch.as_tensor(syms), ts.init_state(syms.shape[:-1]),
                       TR, 0)
    want = jpf.fused_fsk_tx(jp.fnum, jp.pnum, jp.den, 8, 1.0, jp.qshift)
    got = fk.fused_fsk_tx(tp.fnum, tp.pnum, tp.den, 8, 1.0, tp.qshift)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=2e-6)
    s0, s1 = (2 * (syms >> b & 1) - 1 for b in (0, js.bits_per_symbol - 1))
    want = jpf.fused_msk_tx(jnp.asarray(s0), jnp.asarray(s1), 4, 0.8)
    got = fk.fused_msk_tx(torch.as_tensor(s0), torch.as_tensor(s1), 4, 0.8)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=2e-6)
