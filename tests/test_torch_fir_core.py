"""The host side of K4 and K5 on the FIR core (``csrc/common.cuh``,
``csrc/fir.cu``, ``csrc/demod.cu``), on the CPU: which route K4 takes for a
tap count (``ops.fir.fir_route``) and which kernel its long route runs
(``ops.fir.fir_long_route``: the long core or the first version), the long
core's shared memory and its samples (the addressing of ``fir.cu``'s
``long_filter`` mirrored chunk by chunk), the host copy of the taps that
K1, K3, K4 and K5 take by value (``cuda.host_taps``), and K5's carrier walk
(``ops.demod_kernel.carrier_walk``): the phase the kernel walks in 32-bit
steps, tile by tile and thread by thread (mirrored here step for step), is
``ops.nco.carrier_phase``'s exactly, over ragged pushes."""

import ctypes
import math

import numpy as np
import pytest
import torch

from modem_tpu_torch import cuda
from modem_tpu_torch.ops import demod_kernel as dk, fir, txrx
from modem_tpu_torch.ops.filters import lowpass_taps
from modem_tpu_torch.ops.nco import carrier_phase


@pytest.mark.parametrize("k,route", [
    (1, "generic"), (22, "generic"), (23, "fixed"), (24, "generic"),
    (31, "generic"), (32, "fixed"), (33, "generic"), (63, "generic"),
    (64, "fixed"), (65, "fixed"), (66, "generic"), (256, "generic"),
    (257, "long"), (fir.FIR_MAX_TAPS, "long")])
def test_fir_route(k, route):
    assert fir.fir_route(k) == route


@pytest.mark.parametrize("k", [0, fir.FIR_MAX_TAPS + 1])
def test_fir_route_refuses(k):
    with pytest.raises(ValueError, match="at most"):
        fir.fir_route(k)


def test_fir_routes_match_the_parameter_and_the_instantiations():
    """The short route is exactly what a Taps parameter holds; the compiled
    counts are the paths' filters."""
    assert fir.fir_route(cuda.TAPS_PARAM) != "long"
    assert fir.fir_route(cuda.TAPS_PARAM + 1) == "long"
    assert fir.FIR_FIXED_TAPS == (23, 32, 64, 65)
    assert txrx.MAX_KERNEL_TAPS == cuda.TAPS_PARAM


@pytest.mark.parametrize("k,way", [
    (1, "core"), (256, "core"), (257, "core"), (1000, "core"),
    (4096, "core"), (fir.FIR_CORE_MAX_TAPS, "core"),
    (fir.FIR_CORE_MAX_TAPS + 1, "first"), (fir.FIR_MAX_TAPS, "first")])
def test_fir_long_route(k, way):
    assert fir.fir_long_route(k) == way


@pytest.mark.parametrize("k", [0, fir.FIR_MAX_TAPS + 1])
def test_fir_long_route_refuses(k):
    with pytest.raises(ValueError, match="at most"):
        fir.fir_long_route(k)


# fir.cu's long core: outputs a thread, threads a block, taps a chunk; the
# shared memory a block may have and an SM holds (1 KB of it a block's)
CORE_R, CORE_THREADS, CHUNK = 32, 128, 16
MAX_SMEM, SM_SMEM = 232448, 233472


def test_fir_core_shared_memory():
    """The long core takes every count whose block fits, and no more: its
    limit is the last; at the path's 257 and 1000 taps four blocks share
    an SM (as many as its registers allow). By hand: 257 taps, lead 32,
    buffers of skew_len(4384) = 4932 floats, the taps 272: 40,544 bytes."""
    top = fir.FIR_CORE_MAX_TAPS
    assert fir.fir_core_smem_bytes(top) <= MAX_SMEM
    assert fir.fir_core_smem_bytes(top + 1) > MAX_SMEM
    assert all(fir.fir_core_smem_bytes(k) <= MAX_SMEM
               for k in range(1, top + 1, 97))
    assert fir.fir_core_smem_bytes(257) == 4 * (272 + 2 * 4932)
    for k in (257, 1000):
        assert 4 * (fir.fir_core_smem_bytes(k) + 1024) <= SM_SMEM
    assert fir.FIR_CORE_MAX_TAPS < fir.FIR_MAX_TAPS


def _skew(i):
    return i + ((i >> 5) << 2)


def _core_reads(k: int, r0: int):
    """``fir.cu``'s ``long_filter`` for the thread whose outputs start at
    ``r0``, walked as the kernel walks it: for each chunk, the physical
    index of every float its 16-byte window loads (-1 where it loads none),
    its first tap, its count of taps and its window's skewed start."""
    lead = ((1 - k) & 31) + 32
    pos0 = lead + k - 1
    whole, rem = divmod(k, CHUNK)
    chunks = []

    def chunk(p, t, phase, cnt):
        # a partial chunk loads the pieces its taps read (-1: not loaded)
        offs = np.array([p + 4 * g + 4 * ((phase + 4 * g) >> 5) + e
                         if 4 * g + 3 >= CHUNK + 1 - cnt else -1
                         for g in range((CORE_R + CHUNK) // 4)
                         for e in range(4)])
        chunks.append((offs, t, cnt, p))

    p, t, c = _skew(pos0 + r0 - CHUNK), 0, 0
    while c + 2 <= whole:
        chunk(p, t, 16, CHUNK)
        chunk(p - 16, t + CHUNK, 0, CHUNK)
        c, p, t = c + 2, p - 36, t + 2 * CHUNK
    if c < whole:
        chunk(p, t, 16, CHUNK)
        p, t = p - 16, t + CHUNK
    if rem:
        chunk(p, t, 0 if whole & 1 else 16, rem)
    return lead, pos0, chunks


@pytest.mark.parametrize("k", [1, 2, 15, 16, 17, 31, 32, 33, 48, 257, 271,
                               1000, 1025, 4096, fir.FIR_CORE_MAX_TAPS])
def test_fir_core_reads_each_output_s_samples(k):
    """Every FFMA of the long core reads the sample it must: output r0 + q
    at tap j reads the tile's position pos0 + r0 + q - j, the taps in the
    order j = 0, 1, ..., K-1 for every output; no window starts before the
    buffer or reads past its tile, every 16-byte load is aligned, and the
    8 threads of a quarter warp load from 8 different groups of 4 banks."""
    tile = CORE_R * CORE_THREADS
    lead = pos0 = None
    starts = {}
    for t in (0, 1, 2, 3, 4, 5, 6, 7, CORE_THREADS - 1):
        r0 = CORE_R * t
        lead, pos0, chunks = _core_reads(k, r0)
        assert pos0 % 32 == 0 and 32 <= lead < 64
        size = _skew(pos0 + tile)
        logical = np.full(size, -1, np.int64)  # the slack before lead: -1
        pos = np.arange(lead, pos0 + tile)
        logical[_skew(pos)] = pos
        order = []  # the taps of every output's chain, chunk by chunk
        q = np.arange(CORE_R)[None, :]
        for i, (offs, t0, cnt, p) in enumerate(chunks):
            loaded = offs[offs >= 0]
            assert loaded.min() >= 0 and loaded.max() < size
            assert p % 4 == 0 and t0 + CHUNK <= -(-k // CHUNK) * CHUNK
            starts.setdefault(i, []).append(p)
            e = np.where(offs >= 0, logical[np.maximum(offs, 0)], -2)
            m = np.arange(cnt)[:, None]
            np.testing.assert_array_equal(e[CHUNK + q - m],
                                          pos0 + r0 + q - (t0 + m))
            order.extend(t0 + np.arange(cnt))
        assert order == list(range(k))
    for ps in starts.values():  # threads 0-7: one quarter warp
        assert len({(p // 4) % 8 for p in ps[:8]}) == 8


def _read(addr: int, n: int) -> np.ndarray:
    return np.ctypeslib.as_array(
        (ctypes.c_float * cuda.TAPS_PARAM).from_address(addr))[:n].copy()


@pytest.mark.parametrize("k", [7, 23, 64, 65, 256])
def test_host_taps_hold_the_taps(k):
    taps = torch.as_tensor(np.random.default_rng(k).normal(size=k)
                           .astype(np.float32))
    np.testing.assert_array_equal(_read(cuda.host_taps(taps), k),
                                  taps.numpy())


def test_host_taps_are_shared_reused_and_refreshed():
    """One host copy per taps tensor for every kernel that takes them (K1's
    and K3's ``kernel_taps``, K4, K5); an in-place change makes a new one
    with the new values; another tensor gets its own."""
    taps = torch.as_tensor(lowpass_taps())
    addr = cuda.host_taps(taps)
    assert cuda.host_taps(taps) == addr
    assert txrx.kernel_taps(taps, 1)[0] == addr
    taps.mul_(0.5)
    addr2 = cuda.host_taps(taps)
    np.testing.assert_array_equal(_read(addr2, 64), taps.numpy())
    assert cuda.host_taps(taps) == addr2
    assert txrx.kernel_taps(taps, 1)[0] == addr2
    other = taps.clone()
    assert cuda.host_taps(other) != addr2
    np.testing.assert_array_equal(_read(cuda.host_taps(other), 64),
                                  taps.numpy())


def test_host_taps_of_an_inference_tensor_and_past_the_parameter():
    with torch.inference_mode():
        taps = torch.as_tensor(lowpass_taps()) + 0.0
    np.testing.assert_array_equal(_read(cuda.host_taps(taps), 64),
                                  taps.numpy())
    with pytest.raises(ValueError, match="at most 256"):
        cuda.host_taps(torch.zeros(257))


@pytest.mark.parametrize("hz,sr,want", [
    (2000, 10000, (5, 1, 2000, True)),
    (1700, 10000, (100, 17, 100, True)),
    (2001, 10007, (10007, 2001, 1, False)),
    (0, 10000, (1, 0, 10000, True)),
    (12000, 10000, (5, 1, 2000, True))])
def test_carrier_walk(hz, sr, want):
    assert dk.carrier_walk(hz, sr) == want


# csrc/demod.cu's kTile (kR * kCoreThreads) and common.cuh's kCoreThreads
TILE, THREADS = 1024, 128


def _kernel_u(hz, sr, s_mod, h, n, lb, shift):
    """The carrier phase u of x's samples -lb .. n-1 as ``demod_kernel``
    walks it: x[0]'s phase from the stream counter; the row's tiles
    starting ``shift`` samples early (its misalignment); each tile's first
    sample from the tile before (or, for a block's first tile, by a skip),
    each thread's offset, its passes of 4 samples; a tile's history of lb
    samples a whole period on, less them."""
    period, step, unit, _ = dk.carrier_walk(hz, sr)

    def add(k, d):
        k += d
        return k - period if k >= period else k

    def skip(k, d):
        return add(k, d % period * step % period)

    off = (s_mod - h) % sr  # e[0]'s counter, as fused_product_detect has it
    k_x0 = (h % sr + off) % sr * hz % sr // unit
    k_thr = [skip(0, 4 * t) for t in range(THREADS)]
    k_pass, k_tile = skip(0, 4 * THREADS), skip(0, TILE)
    u = np.full(n + lb, -1, np.int64)

    def put(i, k):  # x's sample i at phase k
        if -lb <= i < n:
            u[lb + i] = k * unit

    kt = 0
    for ti in range(-(-(n + shift) // TILE)):
        n0 = ti * TILE - shift
        # even tiles start a block's range (a skip), odd ones follow on
        kt = add(kt, k_tile) if ti % 2 else skip(k_x0, n0 + 4 * period)
        for t in range(THREADS):
            kq = add(kt, k_thr[t])
            for q in range(t, TILE // 4, THREADS):
                ke = kq
                for e in range(4):
                    put(n0 + 4 * q + e, ke)
                    ke = add(ke, step)
                kq = add(kq, k_pass)
        if ti == 0:  # the history of the first tile
            for d in range(lb):
                put(n0 - lb + d, skip(kt, period * 64 - (lb - d)))
    return u


@pytest.mark.parametrize("hz,sr", [(2000, 10000), (2001, 10007),
                                   (1700, 10000)])
@pytest.mark.parametrize("s0", [9971, -12345])
@pytest.mark.parametrize("shift", [0, 3])
def test_kernel_carrier_walk_equals_carrier_phase(hz, sr, s0, shift):
    """Over ragged pushes of a stream (one sample, under the history, a
    tile and one, several tiles), from a positive and a negative counter,
    for a row on a 16-byte boundary and one 3 samples past it: every phase
    the kernel walks, history included, is carrier_phase's."""
    lb = 63
    w = np.float32(2 * math.pi / sr)
    s = s0
    for n in (1, 5, 1025, 9000, 4096):
        u = _kernel_u(hz, sr, s, lb, n, lb, shift)
        want = carrier_phase(hz, sr, n + lb, (s - lb) % sr).numpy()
        got = u.astype(np.float32) * w
        np.testing.assert_array_equal(got, want)
        s += n
