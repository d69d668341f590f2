"""The FIR engine's four backends (``modem_tpu_torch.ops.fir.fir_filter``:
``direct``, ``conv``, ``matmul``, ``fft``) against the JAX backend of the
same name and ``np.convolve``, and the entry points that take
``fir_backend=`` (``Demodulator``, ``qpsk_reference_chain``'s staged
forms) against the JAX ones with the same backend, on the CPU.

The JAX calls run once, in module fixtures. Inputs are numpy from
``np.random.default_rng(seed)``. Tolerances: the JAX tests' ``atol=1e-4``
against ``np.convolve`` and between backends (``tests/test_fir.py``,
``tests/test_rx.py``); ``1e-5`` for a streaming seam and between the two
packages' same backend on unit-scale inputs; the chain's waveforms within
``1e-5`` of their largest value, its bits equal.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from modem_tpu import Modulator as JModulator
from modem_tpu import Rates as JRates
from modem_tpu import make_scheme as j_make_scheme
from modem_tpu.chain import qpsk_reference_chain as j_qpsk_chain
from modem_tpu.ops import fir as jfir
from modem_tpu.rx import Demodulator as JDemodulator

from modem_tpu_torch import Demodulator, Rates, qpsk_reference_chain
from modem_tpu_torch.ops import fir, filters
from modem_tpu_torch.ops.fir import BACKENDS, fir_filter, fir_init_state

torch.set_num_threads(1)

ATOL = 1e-4           # tests/test_fir.py's bar against np.convolve
SEAM_ATOL = 1e-5      # tests/test_fir.py's bar for the streaming seam
TAP_COUNTS = (1, 23, 64)
CF, SR, LOCK = 2000, 10000, 64
C, K = 2, 400          # the chain's channels and symbols


def _ref_causal(x, taps):
    return np.convolve(x, taps)[: len(x)]


def _unit_case(k, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(1000).astype(np.float32),
            rng.standard_normal(k).astype(np.float32))


@pytest.fixture(scope="module")
def jax_filtered():
    """The JAX ``fir_filter`` of every backend and tap count, jitted once a
    case, and its new state."""
    out = {}
    for k in TAP_COUNTS:
        x, taps = _unit_case(k, k)
        for b in BACKENDS:
            y, s = jax.jit(lambda a, b=b, t=taps: jfir.fir_filter(
                a, t, backend=b))(x)
            out[b, k] = (np.asarray(y), np.asarray(s))
    return out


def test_backends_are_the_jax_tuple():
    assert BACKENDS == jfir.BACKENDS == ("direct", "conv", "matmul", "fft")


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("k", TAP_COUNTS)
def test_backend_matches_jax_and_convolve(jax_filtered, backend, k):
    """Each backend against ``np.convolve`` at the JAX tests' 1e-4 and
    against the JAX backend of the same name; the state is the JAX one
    exactly."""
    x, taps = _unit_case(k, k)
    y, state = fir_filter(torch.as_tensor(x), taps, backend=backend)
    jy, jstate = jax_filtered[backend, k]
    np.testing.assert_allclose(y.numpy(), _ref_causal(x, taps), atol=ATOL)
    np.testing.assert_allclose(y.numpy(), jy, atol=ATOL, rtol=0)
    assert y.dtype == torch.float32 and y.shape == x.shape
    np.testing.assert_array_equal(state.numpy(), jstate)


@pytest.mark.parametrize("backend", BACKENDS)
def test_streaming_tail(backend):
    """Four chunks with the carried state equal one shot (the overlap-save
    seam), as tests/test_fir.py holds the JAX backends."""
    x = np.random.default_rng(1).standard_normal(512).astype(np.float32)
    taps = filters.lowpass_taps()
    one, _ = fir_filter(torch.as_tensor(x), taps, backend=backend)
    state = fir_init_state(taps)
    outs = []
    for c in range(4):
        y, state = fir_filter(torch.as_tensor(x[c * 128:(c + 1) * 128]), taps,
                              state, backend)
        outs.append(y.numpy())
    np.testing.assert_allclose(np.concatenate(outs), one.numpy(),
                               atol=SEAM_ATOL, rtol=0)
    np.testing.assert_array_equal(state.numpy(), x[-(len(taps) - 1):])


@pytest.mark.parametrize("backend", BACKENDS)
def test_batched(backend):
    """``[3, 300]`` rows, each its own causal filter, against
    ``np.convolve`` and the JAX backend."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 300)).astype(np.float32)
    taps = rng.standard_normal(23).astype(np.float32)
    y, _ = fir_filter(torch.as_tensor(x), taps, backend=backend)
    jy, _ = jfir.fir_filter(jnp.asarray(x), taps, backend=backend)
    for c in range(3):
        np.testing.assert_allclose(y[c].numpy(), _ref_causal(x[c], taps),
                                   atol=ATOL)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=SEAM_ATOL,
                               rtol=0)


@pytest.mark.parametrize("backend", BACKENDS)
def test_short_blocks_and_carried_state(backend):
    """Blocks shorter than the history (the state is the tail of ``state ++
    x``) and an empty block, from a nonzero state, as the JAX backend."""
    rng = np.random.default_rng(3)
    taps = rng.standard_normal(9).astype(np.float32)
    state = rng.standard_normal((2, 8)).astype(np.float32)
    for n in (0, 3, 8, 40):
        x = rng.standard_normal((2, n)).astype(np.float32)
        y, s = fir_filter(torch.as_tensor(x), taps, torch.as_tensor(state),
                          backend)
        jy, js = jfir.fir_filter(jnp.asarray(x), taps, jnp.asarray(state),
                                 backend)
        assert y.shape == (2, n)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=SEAM_ATOL,
                                   rtol=0)
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
        state = np.array(js)
    y, s = fir_filter(torch.ones(2, 3), taps, None, backend)
    np.testing.assert_array_equal(s.numpy(), np.pad(np.ones((2, 3)),
                                                    ((0, 0), (5, 0))))


@pytest.mark.parametrize("extra", [-2, 2], ids=["k_minus_3", "k_plus_1"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_state_of_another_length(backend, extra):
    """A state of K-3 and of K+1 samples, as the JAX backend of the same
    name takes it: ``y`` over ``state ++ x``, ``n + len(state) - (K-1)``
    samples (the JAX tests' seam bar), and the new state, the last K-1
    samples of ``state ++ x``, exactly."""
    rng = np.random.default_rng(5)
    taps = rng.standard_normal(9).astype(np.float32)
    state = rng.standard_normal((2, 8 + extra)).astype(np.float32)
    for n in ((3, 40) if extra < 0 else (0, 3, 40)):
        x = rng.standard_normal((2, n)).astype(np.float32)
        y, s = fir_filter(torch.as_tensor(x), taps, torch.as_tensor(state),
                          backend)
        jy, js = jfir.fir_filter(jnp.asarray(x), taps, jnp.asarray(state),
                                 backend)
        assert y.shape == (2, n + extra) == jy.shape
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=SEAM_ATOL,
                                   rtol=0)
        assert s.shape == js.shape
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))


def test_fft_long_block_is_chunked():
    """A block far longer than the FFT window: many stitched chunks, as
    tests/test_fir.py's ``test_long_block_matches_convolve``, and the JAX
    fft backend."""
    rng = np.random.default_rng(10)
    taps = rng.normal(size=65).astype(np.float32)
    x = rng.normal(size=(2, 5000)).astype(np.float32)
    y, _ = fir_filter(torch.as_tensor(x), taps, backend="fft")
    ref = np.stack([np.convolve(r, taps)[:5000] for r in x])
    np.testing.assert_allclose(y.numpy(), ref, atol=2e-4)
    jy, _ = jfir.fir_filter(jnp.asarray(x), taps, backend="fft")
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=2e-5, rtol=0)


def test_fft_size_is_bounded(monkeypatch):
    """The window size depends on the taps, not the block: 17 taps on a
    65,552-sample block take transforms of at most 512 points (8 * K
    rounded up to a power of two, at least 256), not 2^17."""
    sizes = []
    real = torch.fft.rfft

    def rfft(a, n=None, *args, **kw):
        sizes.append(n)
        return real(a, n, *args, **kw)

    monkeypatch.setattr(torch.fft, "rfft", rfft)
    taps = np.ones(17, np.float32)
    x = torch.as_tensor(np.random.default_rng(4).standard_normal(
        (1 << 16) + 16).astype(np.float32))
    y, _ = fir_filter(x, taps, backend="fft")
    assert sizes and max(sizes) <= 512
    np.testing.assert_allclose(y.numpy()[-1000:], _ref_causal(
        x.numpy(), taps)[-1000:], atol=ATOL)


def test_fft_window_too_small_and_unknown_backend_rejected():
    with pytest.raises(ValueError, match="too small"):
        fir._fir_fft(torch.zeros(100 + 32), torch.ones(33), fft_n=48)
    with pytest.raises(ValueError, match="unknown FIR backend"):
        fir_filter(torch.zeros(10), np.ones(3), backend="overlap_add")


def test_single_window_path():
    rng = np.random.default_rng(11)
    taps = rng.normal(size=9).astype(np.float32)
    x = rng.normal(size=40).astype(np.float32)
    y, _ = fir_filter(torch.as_tensor(x), taps, backend="fft")
    np.testing.assert_allclose(y.numpy(), np.convolve(x, taps)[:40],
                               atol=ATOL)


def test_toeplitz_bank_is_the_jax_bank():
    taps = np.random.default_rng(5).normal(size=23).astype(np.float32)
    np.testing.assert_array_equal(fir._toeplitz_bank(taps, 256),
                                  np.asarray(jfir._toeplitz_bank(taps, 256)))


def test_derived_tables_are_made_once_per_taps(monkeypatch):
    """The bank (and the reversed taps, the taps' transform) is made on the
    host once per taps tensor, again after an in-place change."""
    made = []
    real = fir._toeplitz_bank
    monkeypatch.setattr(fir, "_toeplitz_bank",
                        lambda t, block: made.append(block) or real(t, block))
    taps = torch.as_tensor(np.random.default_rng(6).normal(size=23)
                           .astype(np.float32))
    x = torch.as_tensor(np.random.default_rng(7).normal(size=(2, 700))
                        .astype(np.float32))
    y1, _ = fir_filter(x, taps, backend="matmul")
    y2, _ = fir_filter(x, taps, backend="matmul")
    assert made == [256] and torch.equal(y1, y2)
    taps.mul_(2.0)
    y3, _ = fir_filter(x, taps, backend="matmul")
    assert made == [256, 256]
    np.testing.assert_allclose(y3.numpy(), 2 * y1.numpy(), atol=1e-5)


def test_numpy_taps_cross_to_a_device_once():
    """Host taps made into a tensor off the CPU are kept by value (the
    ``meta`` device stands in for the card here): the same taps give the
    same tensor, other taps another; an in-place change makes a new one."""
    taps = np.random.default_rng(8).normal(size=13).astype(np.float32)
    t = fir.as_taps(taps, "meta")
    assert t.device.type == "meta" and t.shape == (13,)
    assert fir.as_taps(taps.copy(), "meta") is t
    assert fir.as_taps(list(taps), "meta") is t
    assert fir.as_taps(taps * 2, "meta") is not t
    t.mul_(2.0)
    assert fir.as_taps(taps, "meta") is not t
    cpu = fir.as_taps(taps, "cpu")
    assert cpu.device.type == "cpu" and cpu is not fir.as_taps(taps, "cpu")


def test_direct_state_is_a_view_and_none_is_no_fill(monkeypatch):
    """K4's wrapper: ``new_state`` is a view of ``x`` (no copy), and
    ``state=None`` reaches the kernel's plain version as None (no zero
    history is made for it)."""
    seen = []
    real = fir.fir_plain
    monkeypatch.setattr(fir, "fir_plain",
                        lambda x, t, s: seen.append(s) or real(x, t, s))
    x = torch.as_tensor(np.random.default_rng(9).normal(size=(3, 200))
                        .astype(np.float32))
    taps = filters.lowpass_taps()
    y, state = fir_filter(x, taps)
    assert seen == [None]
    assert state.data_ptr() == x[:, 200 - 63:].data_ptr()
    assert not state.is_contiguous()
    y2, _ = fir_filter(x, taps, torch.zeros(3, 63))
    assert torch.equal(y, y2)


def test_f32_math_pins_tf32_off_and_restores():
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        with fir._f32_math():
            assert not torch.backends.cudnn.allow_tf32
            assert not torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


# ---- the entry points that take fir_backend= ----

@pytest.fixture(scope="module")
def passband():
    """QPSK at 2000 Hz from the JAX modulator, ``[2, 400*8]``."""
    rates = JRates(1250, SR)
    mod = JModulator(j_make_scheme("qpsk", rates), rates, carrier_hz=CF)
    bits = np.random.default_rng(12).integers(0, 2, (2, 800))
    wave, _ = mod.passband(jnp.asarray(bits, jnp.int32), mod.init_state((2,)))
    return np.array(wave)


@pytest.fixture(scope="module")
def jax_demodulated(passband):
    """``Demodulator(fir_backend=b)``: ``lock_phase`` then ``demodulate``,
    every backend, in JAX."""
    out = {}
    xj = jnp.asarray(passband)
    for b in BACKENDS:
        d = JDemodulator(CF, SR, fir_backend=b)
        st = d.lock_phase(xj[:, :LOCK], d.init_state((2,)))
        (i, q), st2 = d.demodulate(xj[:, LOCK:], st)
        out[b] = (np.asarray(i), np.asarray(q), np.asarray(st.phase_offset),
                  np.asarray(st2.lpi))
    return out


@pytest.mark.parametrize("backend", BACKENDS)
def test_demodulator_backend_matches_jax(passband, jax_demodulated, backend):
    """``Demodulator(fir_backend=b)`` against the JAX one with the same
    backend (its outputs and lowpass tail), and against the port's
    ``direct`` at the JAX test's 1e-4 (``tests/test_rx.py``)."""
    jd = JDemodulator(CF, SR)
    td = Demodulator(CF, SR, lowpass=np.asarray(jd.lowpass),
                     hilbert=np.asarray(jd.hilbert), fir_backend=backend,
                     device="cpu")
    x = torch.as_tensor(passband)
    st = td.lock_phase(x[:, :LOCK], td.init_state((2,)))
    (i, q), st2 = td.demodulate(x[:, LOCK:], st)
    ji, jq, jphi, jlpi = jax_demodulated[backend]
    np.testing.assert_allclose(st.phase_offset.numpy(), jphi, atol=SEAM_ATOL,
                               rtol=0)
    np.testing.assert_allclose(i.numpy(), ji, atol=SEAM_ATOL, rtol=0)
    np.testing.assert_allclose(q.numpy(), jq, atol=SEAM_ATOL, rtol=0)
    np.testing.assert_allclose(st2.lpi.numpy(), jlpi, atol=SEAM_ATOL, rtol=0)
    di, dq, _, _ = jax_demodulated["direct"]
    np.testing.assert_allclose(i.numpy(), di, atol=ATOL, rtol=0)
    np.testing.assert_allclose(q.numpy(), dq, atol=ATOL, rtol=0)


@pytest.fixture(scope="module")
def chain_bits():
    return np.random.default_rng(13).integers(0, 2, (C, 2 * K)).astype(
        np.int32)


@pytest.fixture(scope="module")
def jax_chain_runs(chain_bits):
    """``qpsk_reference_chain(fir_backend=b)``'s staged ``tx`` then ``rx``
    in JAX, every backend."""
    out = {}
    for b in BACKENDS:
        jc = j_qpsk_chain(JRates(1250, SR), fir_backend=b)
        wave = jc.tx(jnp.asarray(chain_bits))
        out[b] = (tuple(np.array(w) for w in wave),
                  np.asarray(jc.rx(wave, K)))
    return out


@pytest.mark.parametrize("backend", BACKENDS)
def test_reference_chain_backend_matches_jax(chain_bits, jax_chain_runs,
                                             backend):
    """The staged ``tx`` and ``rx`` of ``qpsk_reference_chain(fir_backend=
    b)``: waveforms within 1e-5 of their largest value of the JAX chain's
    with the same backend, bits equal to JAX's and to the sent bits; ``rx``
    of the JAX waveform decides the same bits."""
    tc = qpsk_reference_chain(Rates(1250, SR), fir_backend=backend,
                              device="cpu")
    assert tc.fir_backend == backend
    wave = tc.tx(torch.as_tensor(chain_bits))
    jwave, jbits = jax_chain_runs[backend]
    for w, jw in zip(wave, jwave):
        peak = np.abs(jw).max()
        np.testing.assert_allclose(w.numpy(), jw, atol=1e-5 * peak, rtol=0)
    bits = tc.rx(wave, K)
    np.testing.assert_array_equal(bits.numpy(), jbits)
    np.testing.assert_array_equal(bits.numpy(), chain_bits)
    again = tc.rx(tuple(torch.as_tensor(w) for w in jwave), K)
    np.testing.assert_array_equal(again.numpy(), jbits)
