"""The long core of K1 and K3 on the CPU: the host's route rule
(``ops.txrx.pulse_long_route``) and the plans it rests on, the wrappers
handing each route's C entry its arguments (stand-in kernels), NumPy
mirrors of the core's addressing (``csrc/common.cuh``'s ``matched_long``
and run-skewed buffers, ``csrc/chain.cu``'s ``synth_item``), and the plain
K1 and K3 at the reference CLI's rates (sps 45, span 8) against the JAX
package (its K2 in interpret mode, then its exact FIR at the decision
instants and its slice: its K3 takes span*sps a multiple of 32 alone, and
its K1 in interpret mode takes 15 s): decisions exactly, soft points
within 1e-5 (the two sum the taps in other orders)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from modem_tpu.ops import pallas_txrx as jtxrx
from modem_tpu.ops.filters import rrc_taps as jrrc_taps
from modem_tpu.ops.fir import fir_filter as jfir
from modem_tpu.ops.slicer import lut_slice as jslice

from modem_tpu_torch.ops import chain_kernel, txrx
from modem_tpu_torch.ops.filters import rrc_taps

R = txrx.LONG_R
QPSK = (np.array([[-1, -1], [-1, 1], [1, -1], [1, 1]], np.float32)
        / np.sqrt(2.0)).astype(np.float32)
#: (sps, span) the route rule sends to the core, and past its budget
CORE = [(8, 32), (20, 16), (96, 1), (45, 8), (96, 40)]
FIRST = [(256, 1), (96, 64), (128, 32)]


def _fits(sps: int, span: int) -> bool:
    side = txrx.SIDE_FLOATS_MAX
    return (txrx.chain_core_pass(txrx.CHAIN_PASS_MIN, sps, span, side) > 0
            and txrx.rx_core_threads(sps, span, side) > 0)


@pytest.mark.parametrize("sps,span", CORE + FIRST)
def test_route_rule_at_the_measured_shapes(sps, span):
    """Sps 8 span 32, sps 20 span 16, sps 96 span 1, the reference CLI's
    sps 45 span 8 and sps 96 span 40 (a lookahead longer than the first
    version's tile) take the core; 256 samples a symbol, sps 96 span 64 and
    sps 128 span 32, past its shared memory, the first version."""
    want = "core" if (sps, span) in CORE else "first"
    assert txrx.pulse_long_route(sps, span) == want


@pytest.mark.parametrize("sps", [1, 8, 20, 45, 64, 65, 96, 112])
def test_route_rule_is_the_cores_budget(sps):
    """The rule says "core" exactly where both cores' smallest blocks fit
    a block's shared memory with the largest tables, and the spans that
    fit are those below a limit."""
    routes = [txrx.pulse_long_route(sps, span) for span in range(0, 400)]
    assert routes == ["core" if _fits(sps, s) else "first"
                      for s in range(0, 400)]
    last = max((s for s, r in enumerate(routes) if r == "core"), default=-1)
    assert routes == ["core"] * (last + 1) + ["first"] * (399 - last)


@pytest.mark.parametrize("sps,span,nsub,nt", [
    (8, 32, 256, 128), (20, 16, 256, 64), (96, 1, 64, 32), (45, 8, 128, 32),
    (96, 40, 16, 32)])
def test_core_plans_at_the_measured_shapes(sps, span, nsub, nt):
    """K1's passes (tiles of 256) and K3's threads with a QPSK table:
    whole passes where the budget allows, halved past it; every plan
    within a block's shared memory, with a carrier's table too."""
    side = 8
    assert txrx.chain_core_pass(256, sps, span, side) == nsub
    assert txrx.chain_core_smem(nsub, sps, span, side) <= txrx.SMEM_MAX
    assert txrx.rx_core_threads(sps, span, side) == nt
    for sd in (side, txrx.SIDE_FLOATS_MAX):
        n = txrx.rx_core_threads(sps, span, sd)
        assert n in txrx.RX_CORE_THREADS
        assert txrx.rx_core_smem(n, sps, span, sd) <= txrx.SMEM_MAX


@pytest.mark.parametrize("cs", [1, 16, 100, 256, 1000])
def test_chain_passes_follow_the_tile(cs):
    """A pass is the tile rounded up to whole register blocks, at most 256
    decisions, and never more shared memory than the budget where it was
    halved."""
    for sps, span in CORE:
        nsub = txrx.chain_core_pass(cs, sps, span)
        assert nsub % R == 0 and nsub <= max(txrx.CHAIN_PASS_MAX,
                                             -(-cs // R) * R)
        assert nsub <= -(-min(cs, txrx.CHAIN_PASS_MAX) // R) * R
        if nsub < -(-min(cs, txrx.CHAIN_PASS_MAX) // R) * R:
            assert (nsub <= txrx.CHAIN_PASS_MIN or
                    txrx.chain_core_smem(nsub, sps, span)
                    <= txrx.CHAIN_PASS_BUDGET)


@pytest.mark.parametrize("sps,span", CORE + FIRST)
def test_kernel_taps_send_every_long_shape_past_the_parameter(sps, span):
    """Past 256 taps or 64 samples a symbol: no host copy, so the long
    route (core or first version) reads the device taps."""
    taps = torch.as_tensor(rrc_taps(sps, span, 0.35))
    assert taps.shape[0] > txrx.MAX_KERNEL_TAPS or sps > txrx.MAX_KERNEL_SPS
    assert txrx.kernel_taps(taps, sps) == (None, taps.data_ptr())


@pytest.mark.parametrize("sps,span", [(8, 8), (4, 6), (64, 3)] + CORE + FIRST)
@pytest.mark.parametrize("first", [False, True], ids=["rule", "forced"])
def test_long_first_takes_the_first_version_by_rule_or_when_forced(
        sps, span, first):
    taps = torch.as_tensor(rrc_taps(sps, span, 0.35))
    long = taps.shape[0] > txrx.MAX_KERNEL_TAPS or sps > txrx.MAX_KERNEL_SPS
    want = first or (long and (sps, span) in FIRST)
    assert txrx.long_first(taps, sps, span, first) == want


# ---- the wrappers hand each route's C entry its arguments ----

class _Stub:
    """Stands in for a Kernel: records each launch's arguments."""

    def __init__(self):
        self.calls = []

    def launch(self, device, *args):
        self.calls.append(args)


@pytest.fixture
def stubs(monkeypatch):
    names = ("CHAIN_KERNEL", "CHAIN_FIRST_KERNEL")
    out = {n: _Stub() for n in names}
    for n in names:
        monkeypatch.setattr(chain_kernel, n, out[n])
    rx = ("RX_HARD_KERNEL", "RX_SOFT_KERNEL", "RX_HARD_FIRST_KERNEL",
          "RX_SOFT_FIRST_KERNEL")
    out.update({n: _Stub() for n in rx})
    for n in rx:
        monkeypatch.setattr(txrx, n, out[n])
    monkeypatch.setattr(chain_kernel, "check_cuda", lambda *a: None)
    monkeypatch.setattr(txrx, "check_cuda", lambda *a: None)
    return out


@pytest.mark.parametrize("sps,span,first,route", [
    (8, 8, False, "short"), (8, 32, False, "core"), (45, 8, False, "core"),
    (256, 1, False, "first"), (8, 32, True, "first"), (8, 8, True, "first")])
def test_wrappers_launch_each_routes_entry(stubs, sps, span, first, route):
    """The short route and the core through ``modem_chain``,
    ``modem_rx_hard`` and ``modem_rx_soft`` (the host taps, null on the
    core, then the device taps); the first version, by the rule or forced,
    through their ``_first`` entries with the device taps alone."""
    taps = torch.as_tensor(rrc_taps(sps, span, 0.35))
    lut = torch.as_tensor(QPSK)
    syms = torch.zeros((3, 20), dtype=torch.int32)
    chain_kernel.chain_kernel(syms, lut, taps, sps, span, first=first)
    n = (20 + span) * sps
    wi, wq = torch.zeros((3, n)), torch.zeros((3, n))
    txrx.rx_kernel(wi, wq, 20, lut, taps, sps, span, False, first=first)
    txrx.rx_kernel(wi, wq, 20, lut, taps, sps, span, True, first=first)
    fv = route == "first"
    used = {k: len(v.calls) for k, v in stubs.items()}
    assert used == {"CHAIN_KERNEL": int(not fv), "CHAIN_FIRST_KERNEL": int(fv),
                    "RX_HARD_KERNEL": int(not fv), "RX_SOFT_KERNEL": int(not fv),
                    "RX_HARD_FIRST_KERNEL": int(fv),
                    "RX_SOFT_FIRST_KERNEL": int(fv)}
    pick = "_FIRST_KERNEL" if fv else "_KERNEL"
    (chain,) = stubs["CHAIN" + pick].calls
    (hard,) = stubs["RX_HARD" + pick].calls
    (soft,) = stubs["RX_SOFT" + pick].calls
    host = txrx.kernel_taps(taps, sps)[0] if route == "short" else None
    want = ((taps.data_ptr(),) if fv else (host, taps.data_ptr())) + (
        taps.shape[0], sps, span)
    assert chain[11:11 + len(want)] == want
    assert hard[6:6 + len(want)] == want and soft[6:6 + len(want)] == want


# ---- NumPy mirrors of the core's addressing ----

def _run_pos(i: int, run: int) -> int:
    return i + 4 * (i // run)


def _tap4(a: int, st: int) -> int:
    c = (-a) & 3
    return c * st + a + c


def _copies(n_taps: int) -> np.ndarray:
    """stage_long_taps of taps 1 .. L (so that a read's value names its
    tap, 0 a zero of the padding)."""
    st = txrx.long_tap_stride(n_taps)
    out = np.zeros(4 * st)
    for i in range(4 * st):
        c, j = divmod(i, st)
        j -= c
        if 0 <= j < n_taps:
            out[i] = j + 1
    return out


SHAPES = [(8, 32), (20, 16), (96, 1), (45, 8), (6, 50), (3, 90), (1, 300),
          (72, 0), (65, 2), (20, 200)]


def _walk(r0, sps, span, rb, re, taps4, got):
    """long_walk over decisions rb .. re - 1, group by group: its position
    counter against run_pos; each tap read appended to got[r] as (tap,
    sample); the groups without tests read no zero tap."""
    n_taps = span * sps + 1
    st = txrx.long_tap_stride(n_taps)
    run, qr, e0 = R * sps, (R // 4) * sps, span * sps
    tb = {r: _tap4(e0 + r * sps - 3, st) for r in range(rb, re)}
    q = (e0 + (re - 1) * sps) >> 2
    q_bot = (rb * sps) >> 2
    cnt = q % qr
    addr = r0 * sps + 4 * (r0 // R) + 4 * q + 4 * (q // qr)
    f_lo = ((re - 1) * sps + 3) >> 2
    f_hi = (e0 + rb * sps - 3) >> 2
    while q >= q_bot:
        edge = not f_lo <= q <= f_hi
        assert addr == _run_pos(r0 * sps + 4 * q, run)
        for r in range(rb, re):
            J = e0 + r * sps - 4 * q
            if edge and (J < 0 or J > n_taps + 2):
                continue
            t = taps4[tb[r] - 4 * q: tb[r] - 4 * q + 4]
            full = J >= 3 and J < n_taps
            assert edge or full
            for u in (3, 2, 1, 0):
                if full or 0 <= J - u < n_taps:
                    assert t[3 - u] != 0
                    got[r].append((int(t[3 - u]) - 1, r0 * sps + 4 * q + u))
        if cnt == 0:
            cnt, addr = qr - 1, addr - 8
        else:
            cnt, addr = cnt - 1, addr - 4
        q -= 1


@pytest.mark.parametrize("sps,span", SHAPES)
@pytest.mark.parametrize("r0", [0, R, 3 * R])
def test_matched_long_reads_every_tap_in_order(sps, span, r0):
    """matched_long's walks (one over the union of the decisions' windows
    at span >= 6, else one a decision): each position counter is the
    run-skewed position of its group's first sample; every decision gets
    each tap j = 0 .. L-1 once, in that order, against sample
    (r0 + r)*sps + L-1-j."""
    n_taps = span * sps + 1
    taps4 = _copies(n_taps)
    got = [[] for _ in range(R)]
    if span >= 2 * (R - 1):
        _walk(r0, sps, span, 0, R, taps4, got)
    else:
        for r in range(R):
            _walk(r0, sps, span, r, r + 1, taps4, got)
    for r in range(R):
        assert got[r] == [(j, (r0 + r) * sps + n_taps - 1 - j)
                          for j in range(n_taps)]


@pytest.mark.parametrize("sps,span", [(8, 32), (20, 16), (45, 8), (3, 90)])
def test_one_walk_a_decision_equals_the_union(sps, span):
    """At spans where the union walk runs, walks one a decision read the
    same taps against the same samples in the same order."""
    taps4 = _copies(span * sps + 1)
    union, single = [[] for _ in range(R)], [[] for _ in range(R)]
    _walk(R, sps, span, 0, R, taps4, union)
    for r in range(R):
        _walk(R, sps, span, r, r + 1, taps4, single)
    assert union == single


@pytest.mark.parametrize("sps,span", SHAPES)
def test_synthesis_window_and_taps(sps, span):
    """synth_item's register window: at tap k row g reads the point of row
    g + span - k (slot (g - k) mod 4, no move), and the four phases' taps
    t[k*sps + p0 + p] from one aligned read of the copies; tap span for
    phase 0 alone; its stores land at the rows' run-skewed positions."""
    G = 4
    n_taps = span * sps + 1
    st = txrx.long_tap_stride(n_taps)
    taps4 = _copies(n_taps)
    for r_first in (0, 4, 12):
        for p0 in range(0, sps, 4):
            b = r_first + span
            w = [None] * G
            for g in range(1, G):
                w[g] = b + g
            seen = {g: [] for g in range(G)}
            for k0 in range(0, span, G):
                for s in range(G):
                    k = k0 + s
                    if k >= span:
                        continue
                    w[(G - s) % G] = b - k
                    off = _tap4(k * sps + p0, st)
                    assert off % 4 == 0
                    t = taps4[off:off + 4]
                    for g in range(G):
                        seen[g].append((k, w[(g - s + G) % G], tuple(t)))
            for g in range(G):
                assert [x[:2] for x in seen[g]] == [(k, b - k + g)
                                                    for k in range(span)]
                for k, _, t in seen[g]:
                    for p in range(4):
                        if p0 + p < sps:
                            assert t[p] == k * sps + p0 + p + 1
                rl = r_first + g
                for p in range(4):
                    if p0 + p < sps:
                        assert (rl * sps + p0 + p + 4 * (rl // R)
                                == _run_pos(rl * sps + p0 + p, R * sps))
            assert taps4[span * sps] == n_taps  # tap L-1, copy 0


@pytest.mark.parametrize("sps,span,nt", [(8, 32, 64), (45, 8, 32),
                                         (96, 1, 32), (3, 90, 128)])
def test_run_walk_and_the_tail_copy(sps, span, nt):
    """RunWalk's positions equal run_pos's at every stride the core walks
    (pieces of 4 and single samples across the block), and a tile's tail
    lies body + 4*nt floats past the head it becomes."""
    run = R * sps
    body, halo = R * nt * sps, span * sps
    for stride in (4 * nt, nt):
        for start in (0, 4 * 3, halo, halo + 4 * 5):
            u, rem = divmod(start, run)
            pos = start + 4 * u
            du, d_rem = divmod(stride, run)
            for m in range(60):
                assert pos == _run_pos(start + m * stride, run)
                pos += stride + 4 * du
                rem += d_rem
                if rem >= run:
                    rem -= run
                    pos += 4
    for e in range(0, max(halo, 1)):
        assert _run_pos(body + e, run) == _run_pos(e, run) + body + 4 * nt
    assert txrx.run_len(body + halo + 4, run) >= _run_pos(body + halo + 3,
                                                          run) + 1


# ---- the plain K1 and K3 at the reference CLI's rates against JAX ----

def test_plain_k1_k3_at_sps45_span8_match_jax():
    """``PulseShapedChain(QPSK, Rates(220, 10000))``'s shape (sps 45, span
    8: 361 taps, the long route on the card), 2 channels x 48 symbols,
    against the JAX package's one-way pair: its K2 (interpret mode), then
    its exact FIR (``fir_filter``, ``direct``) at the decision instants
    and ``lut_slice``. The plain K1 decides as that pair on the clean
    waveform, and gives the symbols back; on the waveform with noise K3
    hard decides as it, exactly, and K3 soft is within 1e-5 of its
    decision points."""
    sps, span, k = 45, 8, 48
    rrc = jrrc_taps(sps, span, 0.35)
    np.testing.assert_allclose(rrc, rrc_taps(sps, span, 0.35), atol=1e-7)
    syms = np.random.default_rng(45).integers(0, 4, (2, k)).astype(np.int32)
    wave = np.stack([np.asarray(w) for w in jtxrx.fused_tx(
        jnp.asarray(syms), QPSK, rrc, sps, span)])
    noisy = wave + np.random.default_rng(46).normal(
        0.0, 0.3, wave.shape).astype(np.float32)

    def jax_rx(rails):
        y = np.asarray(jfir(jnp.asarray(rails), rrc, backend="direct")[0])
        d = y[..., span * sps::sps][..., :k]
        return d, np.asarray(jslice(jnp.asarray(d[0]), jnp.asarray(d[1]),
                                    QPSK))

    _, jclean = jax_rx(wave)
    got = chain_kernel.fused_pulse_chain(torch.as_tensor(syms), QPSK, rrc,
                                         sps, span)
    np.testing.assert_array_equal(got.numpy(), jclean)
    np.testing.assert_array_equal(got.numpy(), syms)
    jsoft, jhard = jax_rx(noisy)
    trails = tuple(torch.as_tensor(r) for r in noisy)
    hard = txrx.fused_rx(trails, k, QPSK, rrc, sps, span)
    soft = txrx.fused_rx(trails, k, QPSK, rrc, sps, span, soft=True)
    np.testing.assert_array_equal(hard.numpy(), jhard)
    for g, w in zip(soft, jsoft):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5)
