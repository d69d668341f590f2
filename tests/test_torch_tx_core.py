"""K2's short route (``modem_tpu_torch/csrc/txrx.cu``, ``pulse_tx_core``,
compiled for sps 8, span 8) on the CPU: a numpy model of its walk over the
waveform, the route its wrapper hands the C entry, and the fused TX on CPU
tensors (the plain version) against ``modem_tpu.ops.pallas_txrx.fused_tx``
in interpret mode.

The model reads the kernel's geometry (threads a block, rows a thread) from
the CUDA source and replays which thread makes which row, the window of
``span + 1`` points each row is made of, and how the block writes its tile
out (16-byte pieces, consecutive threads on consecutive pieces): every
sample of ``[C, (K+span)*sps]`` must be written exactly once, and the
windows, through the polyphase bank, must give the plain version's
waveform (``atol=1e-5``, f32 against the model's f64). The kernel itself is
held to the long route bit for bit by the ``cuda`` tests.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from modem_tpu.ops import pallas_txrx as jtxrx
from modem_tpu.ops.filters import rrc_taps as j_rrc_taps

from modem_tpu_torch import cuda
from modem_tpu_torch.ops import txrx
from modem_tpu_torch.ops.filters import rrc_taps

torch.set_num_threads(1)

ATOL = 1e-5
SRC = (Path(txrx.__file__).resolve().parents[1] / "csrc" / "txrx.cu"
       ).read_text()
SPS, SPAN = 8, 8  # the shape the short route is compiled for


def _const(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC).group(1))


THREADS, ROWS = _const("kTxThreads"), _const("kTxRows")
TILE = THREADS * ROWS  # rows a block makes
QPSK = (np.stack([2.0 * (np.arange(4) >> 1) - 1, 2.0 * (np.arange(4) & 1)
                  - 1], -1) * np.sqrt(0.5)).astype(np.float32)


def walk(syms: np.ndarray, itemsize: int):
    """Replay the kernel over ``syms [C, K]``: the waveform the windows make
    (float64, both rails), how many times each sample is written, and the
    points each thread of each block loaded."""
    c_n, k = syms.shape
    taps = rrc_taps(SPS, SPAN, 0.35).astype(np.float64)
    kp = SPAN + 1
    bank = np.zeros((SPS, kp))
    for p in range(SPS):
        for j in range(kp):
            if j * SPS + p < taps.shape[0]:
                bank[p, j] = taps[j * SPS + p]
    n_rows = k + SPAN
    n_out = n_rows * SPS
    wave = np.zeros((2, c_n * n_out))
    writes = np.zeros(c_n * n_out, np.int64)
    loads = []
    v = 16 // itemsize
    for c in range(c_n):
        valid = syms[c] >= 0
        pts = np.where(valid[:, None], QPSK[np.where(valid, syms[c], 0)], 0.0)
        for m0 in range(0, n_rows, TILE):
            rows = min(TILE, n_rows - m0)
            # the tile's points: symbols m0 - span .. m0 + rows - 1
            g = m0 - SPAN + np.arange(rows + SPAN)
            zp = np.where(((g >= 0) & (g < k))[:, None],
                          pts[np.clip(g, 0, k - 1)], 0.0)
            staged = np.full((2, rows * SPS), np.nan)
            for t in range(THREADS):
                mine = [r for r in range(ROWS * t, ROWS * t + ROWS)
                        if r < rows]
                if not mine:
                    continue
                loads.append(len(mine) + SPAN)
                for rl in mine:
                    window = zp[rl: rl + kp]  # oldest first
                    assert np.all(np.isnan(staged[:, rl * SPS]))
                    staged[:, rl * SPS:(rl + 1) * SPS] = \
                        (bank @ window[::-1]).T
            base = c * n_out + m0 * SPS
            n = rows * SPS
            # every row is whole 16-byte pieces from a 16-byte boundary
            assert (base * itemsize) % 16 == 0 and n % v == 0
            for q in range(n // v):  # thread q % THREADS's piece
                writes[base + q * v: base + q * v + v] += 1
            wave[:, base: base + n] = staged
    shape = (c_n, n_out)
    return (wave[0].reshape(shape), wave[1].reshape(shape),
            writes.reshape(shape), loads)


def _syms(shape, seed, sentinels=True):
    rng = np.random.default_rng(seed)
    syms = rng.integers(0, 4, shape).astype(np.int32)
    if sentinels and shape[-1] > 20:
        syms[0, :16] = -1  # a stream's first block
        syms[-1, -3:] = -1
    return syms


#: K at the tile edges: one row short of a tile's end and past it
WALKS = [1, 31, 248, 257]
WALK_IDS = [f"sps8_span8_k{k}" for k in WALKS]


@pytest.mark.parametrize("itemsize", [4, 2], ids=["f32", "bf16_i16"])
@pytest.mark.parametrize("k", WALKS, ids=WALK_IDS)
def test_walk_writes_every_sample_once(k, itemsize):
    syms = _syms((3, k), SPS + k)
    _, _, writes, _ = walk(syms, itemsize)
    assert writes.shape == (3, (k + SPAN) * SPS)
    assert np.all(writes == 1)


@pytest.mark.parametrize("k", WALKS, ids=WALK_IDS)
def test_walk_windows_make_the_plain_waveform(k):
    """Each row from its window of span + 1 points, through the bank: the
    plain version's waveform, sentinels and flush rows included."""
    syms = _syms((3, k), 2 * SPS + k)
    wi, wq, _, _ = walk(syms, 4)
    taps = torch.as_tensor(rrc_taps(SPS, SPAN, 0.35))
    pi, pq = txrx.tx_plain(torch.as_tensor(syms), torch.as_tensor(QPSK),
                           taps, SPS, SPAN)
    np.testing.assert_allclose(wi, pi.numpy(), atol=ATOL, rtol=0)
    np.testing.assert_allclose(wq, pq.numpy(), atol=ATOL, rtol=0)


def test_fixed_rows_load_one_new_point_a_row():
    """A thread loads span points, then one a row."""
    syms = _syms((2, 600), 5)
    _, _, _, loads = walk(syms, 4)
    assert max(loads) == ROWS + SPAN


@pytest.mark.parametrize("sps,span,short", [
    (8, 8, True), (8, 31, True), (8, 32, False), (64, 3, True),
    (65, 1, False), (20, 12, True), (20, 13, False), (2, 127, True),
    (2, 128, False)])
def test_kernel_taps_pick_k2s_route(sps, span, short):
    """The host taps up to 256 taps and 64 samples a symbol, none past
    either limit; K2's C entry takes its short route at sps 8, span 8 with
    host taps alone."""
    taps = torch.as_tensor(rrc_taps(sps, span, 0.35))
    assert (taps.shape[0] <= 256 and sps <= 64) == short
    host, dev = txrx.kernel_taps(taps, sps)
    assert dev == taps.data_ptr()
    assert (host == cuda.host_taps(taps)) if short else host is None


class _Calls:
    def __init__(self):
        self.args = []

    def launch(self, device, *args):
        self.args.append(args)


@pytest.mark.parametrize("sps,span", [(8, 8), (4, 6), (8, 32), (65, 1)])
@pytest.mark.parametrize("long_route", [False, True],
                         ids=["tx_kernel", "host_none"])
def test_tx_kernel_hands_the_route(monkeypatch, sps, span, long_route):
    """``tx_kernel`` passes ``modem_tx`` one argument fewer than
    ``cuda.SIGNATURES`` lists (the stream is added at the launch): the
    host taps where :func:`kernel_taps` gives them, else null, then the
    device taps; ``_tx_launch(..., host=None)`` null at any shape."""
    monkeypatch.setattr(txrx, "check_cuda", lambda *a: None)
    calls = _Calls()
    monkeypatch.setattr(txrx, "TX_KERNEL", calls)
    taps = torch.as_tensor(rrc_taps(sps, span, 0.35))
    syms = torch.zeros((2, 30), dtype=torch.int32)
    for carrier, dtype in ((None, torch.float32), ((2000, 10000),
                                                   torch.bfloat16)):
        args = (syms, torch.as_tensor(QPSK), taps, sps, span)
        kw = {"carrier": carrier, "out_dtype": dtype}
        if long_route:
            txrx._tx_launch(*args, **kw, host=None)
        else:
            txrx.tx_kernel(*args, **kw)
    assert len(calls.args) == 2
    for args in calls.args:
        assert len(args) == len(cuda.SIGNATURES["modem_tx"]) - 1
        short = taps.shape[0] <= 256 and sps <= 64 and not long_route
        assert args[10] == (cuda.host_taps(taps) if short else None)
        assert args[11] == taps.data_ptr() and args[12] == taps.shape[0]
        assert args[13:15] == (sps, span)


#: (id, keywords of fused_tx) at 3 x 120 symbols
CPU_MODES = [
    ("baseband", {}),
    ("pb2000", {"carrier_hz": 2000, "sample_rate": 10000, "sym_offset": -16}),
    ("pb1700", {"carrier_hz": 1700, "sample_rate": 10000, "sym_offset": 37}),
    ("int16", {"out_scale": 1000.0}),
]


@pytest.mark.parametrize("name,kw", CPU_MODES, ids=[m[0] for m in CPU_MODES])
def test_fused_tx_on_cpu_is_the_plain_version(monkeypatch, name, kw):
    """``fused_tx`` on CPU tensors takes ``tx_plain`` (never the kernel
    wrapper) and equals the JAX kernel in interpret mode: waveforms within
    ``atol=1e-5``, int16 within one step."""
    def no_kernel(*a, **k):
        raise AssertionError("a CPU tensor reached the kernel wrapper")

    monkeypatch.setattr(txrx, "tx_kernel", no_kernel)
    rrc = j_rrc_taps(8, 8, 0.35)
    syms = _syms((3, 120), 7)
    got = txrx.fused_tx(torch.as_tensor(syms), QPSK, rrc, 8, 8, **kw)
    want = jtxrx.fused_tx(jnp.asarray(syms), QPSK, rrc, 8, 8,
                          interpret=True, **kw)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        if name == "int16":
            assert g.dtype == torch.int16
            assert np.abs(g.numpy().astype(np.int32) - w.astype(np.int32)
                          ).max() <= 1
        else:
            np.testing.assert_allclose(g.numpy(), w, atol=ATOL, rtol=0)
