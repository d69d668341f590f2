"""The port's CUDA kernels (K1 loopback, K2 TX, K3 RX hard and soft, K4 FIR,
K5 product detector, K6 FSK loopback, K7 MSK loopback, K8 FSK TX, K9
discriminator means, K10 MSK TX (K6, K7, K8 and K10 on both routes), K11
resampled TX, K12 resampled RX hard and soft, K13 windowed Viterbi, K14
max-log BCJR, K15 polar SC, K16 polar CA-SCL-8) against their plain
PyTorch versions on the card,
and the coded link (CRC, scrambler, RS, ``FramedLink``, the ``link`` CLI)
against the CPU. Marked
``cuda``: every test skips without a CUDA device. On the card
(``--noconftest`` because the suite's conftest imports jax, which the
port's machine need not have)::

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -m cuda -q

Tolerances: decisions exactly (K6 and K7 with noise: on >= 99.99%; K13,
K14's extrinsics, K15's u and x, K16's u and path metrics, and the links'
payloads and verdicts bit for bit); waveforms,
means and soft points ``atol=1e-5`` (``nvcc`` contracts multiply-adds to
FMA, the plain version does not).
"""

import functools
import math

import numpy as np
import pytest
import torch

from modem_tpu_torch import Rates, qpsk_reference_chain
from modem_tpu_torch.models.psk import BPSK
from modem_tpu_torch.ops import chain_kernel, fir, txrx
from modem_tpu_torch.ops.filters import rrc_taps

pytestmark = pytest.mark.cuda

ATOL = 1e-5


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _qpsk():
    s = np.arange(4)
    return np.stack([2.0 * (s >> 1) - 1, 2.0 * (s & 1) - 1], -1) * np.sqrt(0.5)


def _mpsk(m):
    ph = 2 * np.pi * np.arange(m) / m + 0.1
    return np.stack([np.cos(ph), np.sin(ph)], -1)


def _qam64():
    lv = 2.0 * np.arange(8) - 7.0
    return np.stack(np.meshgrid(lv, lv, indexing="ij"), -1).reshape(64, 2) / 7.0


# (name, lut, sps, span, symbol shape)
CASES = [
    ("qpsk_3x500", _qpsk(), 8, 8, (3, 500)),
    ("qpsk_batch_2x3x90", _qpsk(), 8, 8, (2, 3, 90)),
    ("qpsk_short_1", _qpsk(), 8, 8, (2, 1)),
    ("qpsk_short_31", _qpsk(), 8, 8, (2, 31)),
    ("qpsk_tile_edge_257", _qpsk(), 8, 8, (2, 257)),
    ("bpsk_sps4_span6", BPSK(0.0, 1.0).lut, 4, 6, (2, 300)),
    ("8psk_sps16_span4", _mpsk(8), 16, 4, (2, 200)),
    ("64qam_sps2_span10", _qam64(), 2, 10, (2, 600)),
]
IDS = [c[0] for c in CASES]


def _setup(case, dev, sentinels=True):
    _, lut, sps, span, shape = case
    rng = np.random.default_rng(len(shape) + shape[-1])
    syms = rng.integers(0, len(lut), shape).astype(np.int32)
    if sentinels and shape[-1] > 20:
        syms[..., 0, :16] = -1  # the streaming loopback's first block
        syms[..., -1, -3:] = -1
    taps = torch.as_tensor(rrc_taps(sps, span, 0.35), device=dev)
    lut = torch.as_tensor(np.asarray(lut, np.float32), device=dev)
    return torch.as_tensor(syms, device=dev), lut, taps, sps, span


def _launches(kernel, fn, *args, **kwargs):
    before = kernel.launches
    out = fn(*args, **kwargs)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    return out


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_tx_kernel(case, dev):
    syms, lut, taps, sps, span = _setup(case, dev)
    got = _launches(txrx.TX_KERNEL, txrx.fused_tx, syms, lut, taps, sps, span)
    want = txrx.tx_plain(syms, lut, taps, sps, span)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        torch.testing.assert_close(g, w, atol=ATOL, rtol=0)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_rx_kernel_hard(case, dev):
    syms, lut, taps, sps, span = _setup(case, dev, sentinels=False)
    wi, wq = txrx.tx_plain(syms, lut, taps, sps, span)
    k = syms.shape[-1]
    got = _launches(txrx.RX_HARD_KERNEL, txrx.fused_rx, (wi, wq), k, lut,
                    taps, sps, span)
    assert got.dtype == torch.int32
    assert torch.equal(got, txrx.rx_plain(wi, wq, k, lut, taps, sps, span,
                                          False))
    assert torch.equal(got, syms)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_rx_kernel_soft(case, dev):
    syms, lut, taps, sps, span = _setup(case, dev)
    wi, wq = txrx.tx_plain(syms, lut, taps, sps, span)
    g = torch.Generator(device=dev).manual_seed(0)
    wi = wi + 0.3 * torch.randn(wi.shape, generator=g, device=dev)
    wq = wq + 0.3 * torch.randn(wq.shape, generator=g, device=dev)
    k = syms.shape[-1]
    got = _launches(txrx.RX_SOFT_KERNEL, txrx.fused_rx, (wi, wq), k, lut,
                    taps, sps, span, soft=True)
    want = txrx.rx_plain(wi, wq, k, lut, taps, sps, span, True)
    for g_, w in zip(got, want):
        torch.testing.assert_close(g_, w, atol=ATOL, rtol=0)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_chain_kernel(case, dev):
    syms, lut, taps, sps, span = _setup(case, dev)
    got = _launches(chain_kernel.CHAIN_KERNEL, chain_kernel.fused_pulse_chain,
                    syms, lut, taps, sps, span)
    want = chain_kernel.chain_plain(syms, lut, taps, sps, span)
    # positions without a symbol (-1) decide a tie of rounding noise
    real = syms >= 0
    assert torch.equal(got[real], want[real])
    assert torch.equal(got[real], syms[real])


def test_rx_reads_zero_beyond_the_waveform(dev):
    """A waveform exactly (K+span)*sps long, and one longer."""
    syms, lut, taps, sps, span = _setup(CASES[0], dev, sentinels=False)
    wi, wq = txrx.tx_plain(syms, lut, taps, sps, span)
    k = syms.shape[-1]
    ones = torch.ones(wi.shape[:-1] + (5,), device=dev)
    for a, b in ((wi, wq), (torch.cat([wi, ones], -1), torch.cat([wq, ones], -1))):
        for soft in (False, True):
            got = txrx.fused_rx((a, b), k, lut, taps, sps, span, soft=soft)
            want = txrx.rx_plain(a, b, k, lut, taps, sps, span, soft)
            if soft:
                for g, w in zip(got, want):
                    torch.testing.assert_close(g, w, atol=ATOL, rtol=0)
            else:
                assert torch.equal(got, want)


def test_flagship_chain_on_card(dev):
    chain = qpsk_reference_chain(Rates(1250, 10000), device=dev)
    g = torch.Generator(device=dev).manual_seed(1)
    bits = torch.randint(0, 2, (16, 2 * 1024), generator=g, device=dev,
                         dtype=torch.int32)
    assert torch.equal(chain.roundtrip_fused(bits), bits)
    wave = chain.tx_fused(bits)
    for f, s in zip(wave, chain.tx(bits)):
        torch.testing.assert_close(f, s, atol=ATOL, rtol=0)
    assert torch.equal(chain.rx_fused(wave, 1024), bits)
    llr = chain.rx_soft_fused(wave, 1024)
    assert torch.equal((llr < 0).int(), bits)


def test_empty_inputs_launch_nothing(dev):
    _, lut, taps, sps, span = _setup(CASES[0], dev)
    before = (txrx.TX_KERNEL.launches, chain_kernel.CHAIN_KERNEL.launches)
    empty = torch.zeros((0, 10), dtype=torch.int32, device=dev)
    wi, _ = txrx.fused_tx(empty, lut, taps, sps, span)
    assert wi.shape == (0, (10 + span) * sps)
    assert chain_kernel.fused_pulse_chain(empty, lut, taps, sps, span).shape == (0, 10)
    assert before == (txrx.TX_KERNEL.launches, chain_kernel.CHAIN_KERNEL.launches)


@pytest.mark.parametrize("kwargs", [{"carrier_hz": 2000}, {"out_scale": 10.0}])
def test_unported_modes_raise_on_card(dev, kwargs):
    """The modes once refused launch K2 on the card; a carrier past the
    int32 NCO is refused before any launch."""
    syms, lut, taps, sps, span = _setup(CASES[0], dev)
    kwargs = {**kwargs, "sample_rate": 10000} if "carrier_hz" in kwargs \
        else kwargs
    before = txrx.TX_KERNEL.launches
    with pytest.raises(ValueError, match="2\\^31"):
        txrx.fused_tx(syms, lut, taps, sps, span, carrier_hz=50000,
                      sample_rate=50000)
    assert txrx.TX_KERNEL.launches == before
    _launches(txrx.TX_KERNEL, txrx.fused_tx, syms, lut, taps, sps, span,
              **kwargs)


# ---- the K1-K3 modes: passband, algebraic QAM, bf16/int16, noise ----

QAM256 = txrx.qam_mparams(8, 0.1, 1.0)
#: (id, keywords of the mode, bits per symbol); offsets negative as on a
#: stream's first block
MODES = [
    ("pb2000", {"carrier": (2000, 10000), "sym_offset": -16}, 2),
    ("pb1700", {"carrier": (1700, 10000), "sym_offset": 4099}, 2),
    ("qam256", {"qam": QAM256}, 8),
    ("qam256_pb1700", {"qam": QAM256, "carrier": (1700, 10000),
                       "sym_offset": -5}, 8),
]
MODE_IDS = [m[0] for m in MODES]


def _mode_setup(mode, dev, shape=(130, 300)):
    _, kw, bps = mode
    g = torch.Generator(device=dev).manual_seed(len(kw))
    syms = torch.randint(0, 1 << bps, shape, generator=g, device=dev,
                         dtype=torch.int32)
    taps = torch.as_tensor(rrc_taps(8, 8, 0.35), device=dev)
    lut = None if "qam" in kw else torch.as_tensor(
        _qpsk().astype(np.float32), device=dev)
    return syms, lut, taps, kw


def _close_waves(got, want, dtype=torch.float32):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == dtype and g.shape == w.shape
        if dtype == torch.int16:
            assert int((g.int() - w.int()).abs().max()) <= 1
        elif dtype == torch.bfloat16:
            g, w = g.float(), w.float()
            ulp = torch.maximum(g.abs(), w.abs()) * 2.0 ** -7 + 1e-7
            assert bool(((g - w).abs() <= ulp).all())
        else:
            torch.testing.assert_close(g, w, atol=ATOL, rtol=0)


@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
@pytest.mark.parametrize("store", ["f32", "bf16", "i16"])
def test_tx_kernel_modes(mode, store, dev):
    syms, lut, taps, kw = _mode_setup(mode, dev)
    out = {"f32": (None, torch.float32), "bf16": (None, torch.bfloat16),
           "i16": (1000.0, torch.int16)}[store]
    args = (syms, lut, taps, 8, 8, kw.get("qam"), kw.get("carrier"),
            kw.get("sym_offset", 0), *out)
    got = _launches(txrx.TX_KERNEL, txrx.tx_kernel, *args)
    _close_waves(got, txrx.tx_plain(*args), out[1])


@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
@pytest.mark.parametrize("soft", [False, True], ids=["hard", "soft"])
def test_rx_kernel_modes(mode, soft, dev):
    syms, lut, taps, kw = _mode_setup(mode, dev)
    common = (kw.get("qam"), kw.get("carrier"), kw.get("sym_offset", 0))
    wave = txrx.tx_plain(syms, lut, taps, 8, 8, *common)
    g = torch.Generator(device=dev).manual_seed(3)
    sigma = 0.1 if "qam" not in kw else 0.002
    wave = tuple(w + sigma * torch.randn(w.shape, generator=g, device=dev)
                 for w in (wave if isinstance(wave, tuple) else (wave,)))
    rails = wave if len(wave) == 2 else (wave[0], None)
    args = (*rails, syms.shape[-1], lut, taps, 8, 8, soft, *common)
    kernel = txrx.RX_SOFT_KERNEL if soft else txrx.RX_HARD_KERNEL
    got = _launches(kernel, txrx.rx_kernel, *args)
    want = txrx.rx_plain(*args)
    if soft:
        _close_waves(got, want)
    else:
        assert torch.equal(got, want)
        assert float((got == syms).double().mean()) > 0.99


def test_rx_kernel_reads_bf16(dev):
    """bf16 waveforms (baseband and passband) are read as they are: the
    kernel equals the plain version on the same bf16 input."""
    syms, lut, taps, _ = _mode_setup(MODES[0], dev)
    for carrier in (None, (2000, 10000)):
        wave = txrx.tx_plain(syms, lut, taps, 8, 8, None, carrier, -16, None,
                             torch.bfloat16)
        rails = wave if carrier is None else (wave, None)
        for soft in (False, True):
            args = (*rails, syms.shape[-1], lut, taps, 8, 8, soft, None,
                    carrier, -16)
            got, want = txrx.rx_kernel(*args), txrx.rx_plain(*args)
            if soft:
                _close_waves(got, want)
            else:
                assert torch.equal(got, want) and torch.equal(got, syms)


@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
def test_chain_kernel_modes(mode, dev):
    syms, lut, taps, kw = _mode_setup(mode, dev)
    syms[0, :16] = -1
    args = (syms, lut, taps, 8, 8, kw.get("qam"), kw.get("carrier"),
            kw.get("sym_offset", 0))
    got = _launches(chain_kernel.CHAIN_KERNEL, chain_kernel.chain_kernel,
                    *args)
    real = syms >= 0
    want = chain_kernel.chain_plain(*args)
    assert torch.equal(got[real], want[real])
    assert torch.equal(got[real], syms[real])


@pytest.mark.parametrize("carrier", [None, (2000, 10000)],
                         ids=["baseband", "pb2000"])
def test_chain_kernel_noise(carrier, dev):
    """K1's noise on the card draws the plain version's stream: 130 x 300
    symbols in tiles of 32 (both lane tiles, ten time tiles); decisions
    equal on >= 99.99%, and the tile of 256 as well."""
    syms, lut, taps, _ = _mode_setup(MODES[0], dev)
    sigma = chain_kernel.snr_sigma(1.0, 6.0, carrier)
    for cs in (32, 256):
        args = (syms, lut, taps, 8, 8, None, carrier, -8, sigma, 5, cs)
        got = _launches(chain_kernel.CHAIN_KERNEL, chain_kernel.chain_kernel,
                        *args)
        want = chain_kernel.chain_plain(*args)
        assert float((got == want).double().mean()) >= 0.9999
        assert 0.03 < float((got != syms).double().mean()) < 0.07


def test_passband_chain_on_card(dev):
    """``PulseShapedChain(carrier_hz=2000)``: every fused form gives the
    bits back and launches its kernel; the streaming classes in pushes
    equal one shot; ``DifferentialChain``'s noisy loopback honours its
    seed."""
    from modem_tpu_torch import (DifferentialChain, StreamingFusedChain,
                                 StreamingFusedRx, StreamingFusedTx,
                                 make_scheme)
    from modem_tpu_torch.chain import PulseShapedChain
    from modem_tpu_torch.models.psk import QPSK

    r = Rates(1250, 10000)
    chain = PulseShapedChain(QPSK(0.0, 1.0), r, carrier_hz=2000, device=dev)
    g = torch.Generator(device=dev).manual_seed(4)
    bits = torch.randint(0, 2, (16, 2 * 400), generator=g, device=dev,
                         dtype=torch.int32)
    assert torch.equal(_launches(chain_kernel.CHAIN_KERNEL,
                                 chain.roundtrip_fused, bits), bits)
    wave = _launches(txrx.TX_KERNEL, chain.tx_fused, bits)
    assert torch.equal(_launches(txrx.RX_HARD_KERNEL, chain.rx_fused, wave,
                                 400), bits)
    torch.testing.assert_close(wave, chain.tx(bits), atol=ATOL, rtol=0)
    assert torch.equal(chain.rx(wave, 400), bits)
    st, sr, sc = (StreamingFusedTx(chain, (16,)), StreamingFusedRx(chain, (16,)),
                  StreamingFusedChain(chain, (16,)))
    cuts = [0, 74, 190, 400]
    parts = [st.push(bits[:, 2 * a:2 * b]) for a, b in zip(cuts, cuts[1:])]
    streamed = torch.cat(parts + [st.flush()], -1)
    assert torch.equal(streamed, wave)
    out = [sr.push(streamed[:, 8 * a:8 * b])
           for a, b in zip(cuts + [400], cuts[1:] + [408])]
    assert torch.equal(torch.cat(out, -1), bits)
    out = [sc.push(bits[:, 2 * a:2 * b]) for a, b in zip(cuts, cuts[1:])]
    assert torch.equal(torch.cat(out + [sc.flush()], -1), bits)
    dq = DifferentialChain(make_scheme("dqpsk", r), r, device=dev)
    a = dq.roundtrip_fused(bits, snr_db=6.0, seed=1)
    assert torch.equal(a, dq.roundtrip_fused(bits, snr_db=6.0, seed=1))
    assert not torch.equal(a, dq.roundtrip_fused(bits, snr_db=6.0, seed=2))


def test_link_without_fused_forms_on_card(dev):
    """``FramedLink`` over a chain that has only ``tx`` and ``rx_soft``
    takes the staged route on the card too."""
    from modem_tpu_torch import presets
    from modem_tpu_torch.link import FramedLink

    chain = presets.qpsk_reference_chain(presets.REFERENCE_RATES, device=dev)

    class StagedOnly:
        scheme, tx, rx_soft = chain.scheme, chain.tx, chain.rx_soft

    link = FramedLink(StagedOnly(), payload_bits=1002)
    pay = torch.randint(0, 2, (4, 1002), device=dev, dtype=torch.int32)
    before = txrx.TX_KERNEL.launches
    out, ok = link.rx_fused(link.tx_fused(pay), 0.05)
    assert txrx.TX_KERNEL.launches == before
    assert torch.equal(out, pay) and bool(ok.all())


def test_kernels_refuse_mismatched_taps(dev):
    """K1 and K3 read exactly a span*sps+1-tap window; other lengths are
    refused at the launch, before the kernel runs."""
    syms, lut, taps, sps, span = _setup(CASES[0], dev, sentinels=False)
    wi, wq = txrx.tx_plain(syms, lut, taps, sps, span)
    short = taps[:-1].contiguous()
    with pytest.raises(RuntimeError, match="CUDA error"):
        txrx.rx_kernel(wi, wq, syms.shape[-1], lut, short, sps, span, False)
    with pytest.raises(RuntimeError, match="CUDA error"):
        chain_kernel.chain_kernel(syms, lut, short, sps, span)


# ---- K1 and K3 redesigned: register blocks, persistent tiles, taps by
# value, the 32-bit NCO phase ----

def _taps(sps, span):
    return torch.as_tensor(rrc_taps(sps, span, 0.35))


def _syms(shape, dev, seed, bps=2, sentinels=False):
    g = torch.Generator(device=dev).manual_seed(seed)
    syms = torch.randint(0, 1 << bps, shape, generator=g, device=dev,
                         dtype=torch.int32)
    if sentinels:
        syms[0, :16] = -1
        syms[-1, -3:] = -1
    return syms


def _k1_counter(taps, sps, span):
    """The launch count of the K1 entry a chain takes: the first version's
    past the long core's shared memory (``txrx.pulse_long_route``)."""
    return (chain_kernel.CHAIN_FIRST_KERNEL
            if txrx.long_first(taps, sps, span) else chain_kernel.CHAIN_KERNEL)


def _k3_counter(taps, sps, span, soft):
    if txrx.long_first(taps, sps, span):
        return txrx.RX_SOFT_FIRST_KERNEL if soft else txrx.RX_HARD_FIRST_KERNEL
    return txrx.RX_SOFT_KERNEL if soft else txrx.RX_HARD_KERNEL


def _chain_exact(syms, lut, taps, sps, span, sent=True, **kw):
    """K1 against ``chain_plain``: decisions equal wherever there is a
    symbol, and (``sent``) equal to the symbols sent."""
    args = (syms, lut, taps, sps, span, kw.get("qam"), kw.get("carrier"),
            kw.get("sym_offset", 0), None, 0, kw.get("cs", 256))
    got = _launches(_k1_counter(taps, sps, span), chain_kernel.chain_kernel,
                    *args)
    want = chain_kernel.chain_plain(*args)
    real = syms >= 0
    assert torch.equal(got[real], want[real])
    assert not sent or torch.equal(got[real], syms[real])


def _rx_exact(rails, k, lut, taps, sps, span, want_rails=None, **kw):
    """K3 hard equal to ``rx_plain`` and soft within ATOL, on ``rails``
    (the plain version on ``want_rails``, default the same)."""
    want_rails = rails if want_rails is None else want_rails
    common = (kw.get("qam"), kw.get("carrier"), kw.get("sym_offset", 0))
    for soft in (False, True):
        got = _launches(_k3_counter(taps, sps, span, soft), txrx.rx_kernel,
                        *rails, k, lut, taps, sps, span, soft, *common)
        want = txrx.rx_plain(*want_rails, k, lut, taps, sps, span, soft,
                             *common)
        if soft:
            _close_waves(got, want)
        else:
            assert torch.equal(got, want)


@pytest.mark.parametrize("k", [1, 3, 5, 255, 257, 513, 1030])
def test_k1_k3_lengths_off_the_register_block(k, dev):
    """Lengths that are not multiples of the 4 decisions a thread, of K1's
    256-decision pass or of K3's 512-symbol tile; K1 noiseless in tiles of
    256, of 100 (a pass that ends inside a register block) and of 600
    (passes after the first)."""
    lut = torch.as_tensor(_qpsk().astype(np.float32), device=dev)
    taps = _taps(8, 8).to(dev)
    syms = _syms((3, k), dev, k, sentinels=k > 20)
    for cs in (256, 100, 600):
        _chain_exact(syms, lut, taps, 8, 8, cs=cs)
    syms = _syms((3, k), dev, k + 1)
    wi, wq = txrx.tx_plain(syms, lut, taps, 8, 8)
    _rx_exact((wi, wq), k, lut, taps, 8, 8)


def test_k1_lane_boundary_and_sentinels(dev):
    """130 channels cross the noise keys' 128-lane boundary; streaming
    sentinels (-1) decide nothing and zero the waveform; noiseless
    decisions exact, noisy ones agree on >= 99.99% with the plain version
    (MODE_AGREE in chip_smoke.py), in tiles of 32, 256 and 600."""
    lut = torch.as_tensor(_qpsk().astype(np.float32), device=dev)
    taps = _taps(8, 8).to(dev)
    syms = _syms((130, 700), dev, 11, sentinels=True)
    syms[64, 100:140] = -1
    _chain_exact(syms, lut, taps, 8, 8)
    sigma = chain_kernel.snr_sigma(1.0, 7.0, None)
    for cs in (32, 256, 600):
        args = (syms, lut, taps, 8, 8, None, None, 0, sigma, 9, cs)
        got = chain_kernel.chain_kernel(*args)
        want = chain_kernel.chain_plain(*args)
        real = syms >= 0
        assert float((got[real] == want[real]).double().mean()) >= 0.9999


def test_rx_short_and_misaligned_rows(dev):
    """K3 reads a waveform shorter than (k + span) * sps as zeros past its
    end, and rows that do not start on 16 bytes: an odd n_wave, the second
    rail of a [2, C, N] tensor with C * N odd, bf16 rows of odd length."""
    lut = torch.as_tensor(_qpsk().astype(np.float32), device=dev)
    taps = _taps(8, 8).to(dev)
    k = 1001
    syms = _syms((3, k), dev, 12)
    wi, wq = txrx.tx_plain(syms, lut, taps, 8, 8)
    short = (wi[:, :-21].contiguous(), wq[:, :-21].contiguous())
    padded = tuple(torch.nn.functional.pad(w, (0, 21)) for w in short)
    _rx_exact(short, k, lut, taps, 8, 8, want_rails=padded)
    odd = tuple(torch.cat([w, torch.ones_like(w[:, :3])], -1)
                for w in (wi, wq))
    _rx_exact(odd, k, lut, taps, 8, 8)
    stacked = torch.stack([w[:, :-1] for w in (wi, wq)])  # 3 * 8063 odd
    assert stacked[1].data_ptr() % 16 != 0
    _rx_exact((stacked[0], stacked[1]), k - 1, lut, taps, 8, 8,
              want_rails=(stacked[0].clone(), stacked[1].clone()))
    for carrier in (None, (2000, 10000)):
        wave = txrx.tx_plain(syms, lut, taps, 8, 8, None, carrier, -16, None,
                             torch.bfloat16)
        rails = wave if carrier is None else (wave, None)
        rails = tuple(None if w is None else w[:, :-1].contiguous()
                      for w in rails)
        assert rails[0].shape[-1] % 2 == 1
        _rx_exact(rails, k - 1, lut, taps, 8, 8, carrier=carrier,
                  sym_offset=-16)


@pytest.mark.parametrize("sps,span", [(4, 6), (2, 10), (16, 4), (64, 3)])
def test_k1_k3_generic_instantiation(sps, span, dev):
    """Shapes other than the flagship's sps 8, span 8 take the generic
    instantiation, baseband and passband (a carrier at a fifth of the
    sample rate, which at sps 2 folds the band onto itself: there the
    decisions equal the plain version's, not the symbols)."""
    lut = torch.as_tensor(_qpsk().astype(np.float32), device=dev)
    taps = _taps(sps, span).to(dev)
    syms = _syms((3, 700), dev, sps, sentinels=True)
    sr = 10000 if sps * 1250 == 10000 else sps * 1000
    for carrier, off in ((None, 0), ((sr // 5, sr), -7)):
        _chain_exact(syms, lut, taps, sps, span, carrier is None or sps > 2,
                     carrier=carrier, sym_offset=off)
        clean = syms.clamp(min=0)
        wave = txrx.tx_plain(clean, lut, taps, sps, span, None, carrier, off)
        rails = wave if carrier is None else (wave, None)
        _rx_exact(rails, 700, lut, taps, sps, span, carrier=carrier,
                  sym_offset=off)


@pytest.mark.parametrize("sps,span", [(2, 10), (4, 6), (3, 5), (8, 8)],
                         ids=["halo20", "halo24", "halo15", "flagship"])
@pytest.mark.parametrize("mode", ["f32", "bf16", "passband", "passband_bf16"])
def test_k3_continued_tiles(sps, span, mode, dev):
    """300 channels x 2100 symbols give about 1500 (channel, tile) items,
    more than K3's persistent grid, so a block walks consecutive tiles of a
    channel and keeps each tile's lookahead on chip for the next: direct
    f32, bf16 and passband staging (sym_offset -7), halos of 20, 24, 15
    (partial stores and scalar loads) and 64 samples. K1 noiseless in
    tiles of 600 (passes after the first) on the same symbols."""
    lut = torch.as_tensor(_qpsk().astype(np.float32), device=dev)
    taps = _taps(sps, span).to(dev)
    k = 2100
    syms = _syms((300, k), dev, 100 + sps)
    carrier = (sps * 200, sps * 1000) if mode.startswith("passband") else None
    off = -7 if carrier else 0
    if mode == "f32":
        _chain_exact(syms, lut, taps, sps, span, cs=600)
    dtype = torch.bfloat16 if mode.endswith("bf16") else torch.float32
    wave = txrx.tx_plain(syms, lut, taps, sps, span, None, carrier, off)
    rails = (wave, None) if carrier else wave
    g = torch.Generator(device=dev).manual_seed(sps)
    rails = tuple(None if w is None else
                  (w + 0.3 * torch.randn(w.shape, generator=g, device=dev))
                  .to(dtype) for w in rails)
    _rx_exact(rails, k, lut, taps, sps, span, carrier=carrier, sym_offset=off)


#: K1's and K3's long route: more than 256 taps, more than 64 samples a
#: symbol, or both; (96, 40) has a lookahead longer than the first
#: version's K3 tile
LONG = [(8, 32), (20, 16), (96, 1), (96, 40)]


@pytest.mark.parametrize("sps,span", LONG, ids=[f"sps{a}_span{b}"
                                                for a, b in LONG])
@pytest.mark.parametrize("carrier", [False, True],
                         ids=["baseband", "passband"])
def test_k1_k3_long_route(sps, span, carrier, dev):
    """Chains past the short route's limits take the long route (taps from
    a device array, staged in shared memory): K1 and K3 hard bit for bit
    against the plain version, K3 soft within ATOL, baseband and passband
    (a carrier at a fifth of the sample rate, sym_offset -7), over 300
    channels, so that K3's persistent blocks walk consecutive tiles."""
    assert (sps * span + 1 > txrx.MAX_KERNEL_TAPS
            or sps > txrx.MAX_KERNEL_SPS)
    lut = torch.as_tensor(_qpsk().astype(np.float32), device=dev)
    taps = _taps(sps, span).to(dev)
    assert txrx.kernel_taps(taps, sps)[0] is None
    k = 400
    syms = _syms((300, k), dev, sps + span, sentinels=True)
    sr = sps * 1000
    c, off = ((sr // 5, sr), -7) if carrier else (None, 0)
    _chain_exact(syms, lut, taps, sps, span, carrier=c, sym_offset=off)
    _chain_exact(syms, lut, taps, sps, span, carrier=c, sym_offset=off,
                 cs=100)
    clean = syms.clamp(min=0)
    wave = txrx.tx_plain(clean, lut, taps, sps, span, None, c, off)
    rails = (wave, None) if carrier else wave
    g = torch.Generator(device=dev).manual_seed(sps)
    rails = tuple(None if w is None else
                  w + 0.2 * torch.randn(w.shape, generator=g, device=dev)
                  for w in rails)
    _rx_exact(rails, k, lut, taps, sps, span, carrier=c, sym_offset=off)


def test_k1_k3_long_route_modes(dev):
    """The long route keeps every mode: algebraic 256-QAM, bf16 input and
    K1's in-kernel noise (the plain version's stream, decisions equal on
    >= 99.99%), at sps 20, span 16."""
    sps, span = 20, 16
    taps = _taps(sps, span).to(dev)
    lut = torch.as_tensor(_qpsk().astype(np.float32), device=dev)
    syms = _syms((130, 300), dev, 21, bps=8)
    _chain_exact(syms, None, taps, sps, span, qam=QAM256)
    wave = txrx.tx_plain(syms, None, taps, sps, span, QAM256)
    _rx_exact(wave, 300, None, taps, sps, span, qam=QAM256)
    qsyms = _syms((130, 300), dev, 22)
    for c in (None, (4000, 20000)):
        wave = txrx.tx_plain(qsyms, lut, taps, sps, span, None, c, -16, None,
                             torch.bfloat16)
        rails = wave if c is None else (wave, None)
        _rx_exact(rails, 300, lut, taps, sps, span, carrier=c, sym_offset=-16)
        sigma = chain_kernel.snr_sigma(1.0, 6.0, c)
        args = (qsyms, lut, taps, sps, span, None, c, -8, sigma, 5, 32)
        got = _launches(chain_kernel.CHAIN_KERNEL, chain_kernel.chain_kernel,
                        *args)
        want = chain_kernel.chain_plain(*args)
        assert float((got == want).double().mean()) >= 0.9999


# ---- K1's and K3's long core against their first version ----

#: the long core's shapes: LONG's and the reference CLI's rates, 220 baud
#: at 10 kHz (sps 45, span 8); (256, 1) takes the first version by the rule
LONG_CORE = LONG + [(45, 8), (256, 1)]
LONG_CORE_IDS = [f"sps{a}_span{b}" for a, b in LONG_CORE]


def _same(a, b) -> bool:
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    return all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))


def _core_first(fn, counter, first_counter, *args, **kw):
    """``fn`` on its route (counted on ``counter``) and with the first
    version forced (``first_counter``), bit for bit; the route's output."""
    got = _launches(counter, fn, *args, **kw)
    want = _launches(first_counter, fn, *args, first=True, **kw)
    assert _same(got, want)
    return got


def _k1_core_first(syms, lut, taps, sps, span, qam=None, carrier=None,
                   off=0, sigma=None, seed=0, cs=256):
    return _core_first(chain_kernel.chain_kernel, _k1_counter(taps, sps, span),
                       chain_kernel.CHAIN_FIRST_KERNEL, syms, lut, taps, sps,
                       span, qam, carrier, off, sigma, seed, cs)


def _k3_core_first(rails, k, lut, taps, sps, span, qam=None, carrier=None,
                   off=0):
    """K3 hard and soft on the core against the first version forced."""
    for soft in (False, True):
        first = (txrx.RX_SOFT_FIRST_KERNEL if soft
                 else txrx.RX_HARD_FIRST_KERNEL)
        _core_first(txrx.rx_kernel, _k3_counter(taps, sps, span, soft), first,
                    *rails, k, lut, taps, sps, span, soft, qam, carrier, off)


@pytest.mark.parametrize("sps,span", LONG_CORE, ids=LONG_CORE_IDS)
@pytest.mark.parametrize("carrier", [False, True],
                         ids=["baseband", "passband"])
def test_long_core_equals_first_version(sps, span, carrier, dev):
    """test_k1_k3_long_route's modes (baseband and passband, a carrier at a
    fifth of the sample rate, sym_offset -7; K1 in tiles of 256 and of 100,
    passes cut inside a register block) over 300 channels of 401 symbols,
    a length that is no multiple of any tile or pass: K1, K3 hard and K3
    soft on the long core equal the first version forced on the same
    inputs, bit for bit (at (256, 1) both are the first version)."""
    lut = torch.as_tensor(_qpsk().astype(np.float32), device=dev)
    taps = _taps(sps, span).to(dev)
    k = 401
    syms = _syms((300, k), dev, sps + span + 1, sentinels=True)
    sr = sps * 200  # hz * sr < 2^31 at every sps
    c, off = ((sr // 5, sr), -7) if carrier else (None, 0)
    for cs in (256, 100):
        _k1_core_first(syms, lut, taps, sps, span, None, c, off, cs=cs)
    clean = syms.clamp(min=0)
    wave = txrx.tx_plain(clean, lut, taps, sps, span, None, c, off)
    rails = (wave, None) if carrier else wave
    g = torch.Generator(device=dev).manual_seed(sps + 1)
    rails = tuple(None if w is None else
                  w + 0.2 * torch.randn(w.shape, generator=g, device=dev)
                  for w in rails)
    _k3_core_first(rails, k, lut, taps, sps, span, None, c, off)


@pytest.mark.parametrize("sps,span", LONG_CORE, ids=LONG_CORE_IDS)
def test_long_core_equals_first_version_modes(sps, span, dev):
    """test_k1_k3_long_route_modes's modes on the core against the first
    version, bit for bit: algebraic 256-QAM, bf16 input at baseband and at
    passband (sym_offset -16), and K1's in-kernel noise (the same draws,
    so the same decisions), in tiles of 32 (more passes than decisions a
    block)."""
    taps = _taps(sps, span).to(dev)
    lut = torch.as_tensor(_qpsk().astype(np.float32), device=dev)
    syms = _syms((130, 300), dev, 23, bps=8)
    _k1_core_first(syms, None, taps, sps, span, QAM256)
    wave = txrx.tx_plain(syms, None, taps, sps, span, QAM256)
    _k3_core_first(wave, 300, None, taps, sps, span, QAM256)
    qsyms = _syms((130, 300), dev, 24)
    sr = sps * 200
    for c in (None, (sr // 5, sr)):
        wave = txrx.tx_plain(qsyms, lut, taps, sps, span, None, c, -16, None,
                             torch.bfloat16)
        rails = wave if c is None else (wave, None)
        _k3_core_first(rails, 300, lut, taps, sps, span, None, c, -16)
        sigma = chain_kernel.snr_sigma(1.0, 6.0, c)
        _k1_core_first(qsyms, lut, taps, sps, span, None, c, -8, sigma, 5, 32)


@pytest.mark.parametrize("sps,span", [(8, 32), (45, 8)])
@pytest.mark.parametrize("carrier", [False, True],
                         ids=["baseband", "passband"])
def test_long_core_streams_in_ragged_pushes_equal_one_shot(sps, span,
                                                           carrier, dev):
    """``StreamingFusedRx`` and ``StreamingFusedChain`` on a chain the
    long core takes, in ragged pushes (its tiles and passes cut at every
    offset), equal the one-shot ``rx_fused`` and ``roundtrip_fused``, each
    push on the core."""
    from modem_tpu_torch import StreamingFusedChain, StreamingFusedRx
    from modem_tpu_torch.chain import PulseShapedChain
    from modem_tpu_torch.models.psk import QPSK

    sr = sps * 220
    chain = PulseShapedChain(QPSK(0.0, 1.0), Rates(220, sr),
                             span_symbols=span,
                             carrier_hz=sr // 5 if carrier else None,
                             device=dev)
    assert chain.sps == sps and txrx.pulse_long_route(sps, span) == "core"
    k = 1500
    g = torch.Generator(device=dev).manual_seed(sps)
    bits = torch.randint(0, 2, (7, 2 * k), generator=g, device=dev,
                         dtype=torch.int32)
    cuts = [0, 1, 7, 300, 813, 1024, 1499, k]
    sc = StreamingFusedChain(chain, (7,))
    out = [_launches(chain_kernel.CHAIN_KERNEL, sc.push, bits[:, 2 * a:2 * b])
           for a, b in zip(cuts, cuts[1:])]
    assert torch.equal(torch.cat(out + [sc.flush()], -1),
                       chain.roundtrip_fused(bits))
    wave = chain.tx_fused(bits)
    rails = (wave,) if carrier else wave
    n = rails[0].shape[-1]
    st = StreamingFusedRx(chain, (7,))
    scuts = [sps * c for c in cuts] + [n]
    out = []
    for a, b in zip(scuts, scuts[1:]):
        part = tuple(r[:, a:b] for r in rails)
        out.append(st.push(part[0] if carrier else part))
    assert torch.equal(torch.cat(out, -1), chain.rx_fused(wave, k))
    assert torch.equal(torch.cat(out, -1), bits)


@pytest.mark.parametrize("sps,span,core", [(8, 32, True), (45, 8, True),
                                           (96, 40, True), (256, 1, False)],
                         ids=["sps8_span32", "sps45_span8", "sps96_span40",
                              "sps256_span1"])
def test_long_routes_by_the_profiler(sps, span, core, dev):
    """Which kernel each long-route call ran, by the profiler: the long
    core (``pulse_chain_long_core``, ``pulse_rx_long_core``) where the
    rule takes it, the first version (``pulse_chain_kernel``,
    ``pulse_rx_kernel``) past its shared memory and wherever
    ``first=True`` forces it."""
    lut = torch.as_tensor(_qpsk().astype(np.float32), device=dev)
    taps = _taps(sps, span).to(dev)
    syms = _syms((4, 300), dev, sps)
    wi, wq = txrx.tx_plain(syms, lut, taps, sps, span)
    cases = [("_chain_", chain_kernel.chain_kernel, (syms, lut, taps, sps,
                                                     span), "pulse_chain"),
             ("pulse_rx_", txrx.rx_kernel, (wi, wq, 300, lut, taps, sps, span,
                                            False), "pulse_rx"),
             ("pulse_rx_", txrx.rx_kernel, (wi, wq, 300, lut, taps, sps, span,
                                            True), "pulse_rx")]
    for family, fn, args, stem in cases:
        want = f"{stem}_long_core" if core else f"{stem}_kernel"
        names = _kernel_names(fn, *args, family=family)
        assert len(names) == 1 and want in next(iter(names)), names
        forced = _kernel_names(functools.partial(fn, first=True), *args,
                               family=family)
        assert (len(forced) == 1
                and f"{stem}_kernel" in next(iter(forced))), forced


#: the sps at which the host's rule is held to the C code at its edge
ROUTE_EDGE_SPS = (8, 45, 96, 200)


@pytest.mark.parametrize("sps", ROUTE_EDGE_SPS)
def test_long_route_rule_holds_at_its_edge(sps, dev):
    """The host's rule (``txrx.pulse_long_route``) mirrors the C code's
    plans (``chain.cu``'s ``core_pass``, ``txrx.cu``'s
    ``rx_core_threads``): at the last span of ``sps`` that the rule sends to
    the long core, K1, K3 hard and K3 soft launch on the core with the
    largest tables the rule allows for (a 64-point table and a carrier of
    2048 phases, ``SIDE_FLOATS_MAX`` floats), and at the next span on the
    first version, each launch counted on its entry and bit for bit with
    the first version forced. (Against the first version, not the plain
    version: the plain version's loop over thousands of taps would launch
    about a million small kernels.)"""
    last = 1
    while txrx.pulse_long_route(sps, last + 1) == "core":
        last += 1
    assert txrx.pulse_long_route(sps, last) == "core"
    grid = np.arange(8) * 2.0 - 7
    lut = torch.as_tensor(np.stack(np.meshgrid(grid, grid), -1)
                          .reshape(64, 2).astype(np.float32) / 7, device=dev)
    carrier = (409, 2048)  # 2048 phases, the largest carrier table
    assert 2 * 64 + 2 * 2048 == txrx.SIDE_FLOATS_MAX
    for span, core in ((last, True), (last + 1, False)):
        taps = _taps(sps, span).to(dev)
        assert txrx.kernel_taps(taps, sps)[0] is None
        assert txrx.long_first(taps, sps, span) is not core
        syms = _syms((2, 64), dev, sps + span, bps=6)
        _k1_core_first(syms, lut, taps, sps, span, None, carrier)
        wave = txrx.tx_kernel(syms, lut, taps, sps, span, None, carrier)
        _k3_core_first((wave, None), 64, lut, taps, sps, span, None, carrier)


# ---- K2's routes: the short route (pulse_tx_core) against the long route
# (the first version's body), bit for bit ----

#: (id, keywords of tx_kernel, bits per symbol): every mode, sym_offset
#: other than 0 on the carriers; 1999 Hz of 10000 has more phases than the
#: table holds (cosf and sinf a sample)
TX_MODES = [
    ("f32", {}, 2),
    ("bf16", {"out_dtype": torch.bfloat16}, 2),
    ("i16", {"out_scale": 1000.0, "out_dtype": torch.int16}, 2),
    ("pb2000", {"carrier": (2000, 10000), "sym_offset": -16}, 2),
    ("pb1999", {"carrier": (1999, 10000), "sym_offset": 987654321}, 2),
    ("pb1700_bf16", {"carrier": (1700, 10000), "sym_offset": 4099,
                     "out_dtype": torch.bfloat16}, 2),
    ("pb1700_i16", {"carrier": (1700, 10000), "sym_offset": -5,
                    "out_scale": 1000.0, "out_dtype": torch.int16}, 2),
    ("qam256", {"qam": QAM256}, 8),
    ("qam256_pb2000", {"qam": QAM256, "carrier": (2000, 10000),
                       "sym_offset": 7}, 8),
]
TX_MODE_IDS = [m[0] for m in TX_MODES]


def _tx_both(syms, lut, taps, sps, span, kw):
    """K2 on the route its shape picks and on the long route: bit for bit
    equal, and within the plain version's bars."""
    kw = dict(kw)
    qam = kw.pop("qam", None)
    args = (syms, None if qam is not None else lut, taps, sps, span, qam)
    got = _launches(txrx.TX_KERNEL, txrx.tx_kernel, *args, **kw)
    ref = _launches(txrx.TX_KERNEL, txrx._tx_launch, *args, **kw, host=None)
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and torch.equal(g, r)
    want = txrx.tx_plain(*args, kw.get("carrier"), kw.get("sym_offset", 0),
                         kw.get("out_scale"),
                         kw.get("out_dtype", torch.float32))
    _close_waves(got if len(got) == 2 else got[0], want,
                 kw.get("out_dtype", torch.float32))


@pytest.mark.parametrize("mode", TX_MODES, ids=TX_MODE_IDS)
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_tx_short_route_equals_long_route(case, mode, dev):
    """K2's short route (sps 8, span 8; K = 1, 31, 257, batched) equals the
    long route bit for bit in every mode, with the streaming sentinels;
    the other shapes (sps 2, 4 and 16) take the long route both ways."""
    syms, lut, taps, sps, span = _setup(case, dev)
    _, kw, bps = mode
    if bps != 2:
        syms = _syms(syms.shape, dev, syms.shape[-1], bps=bps,
                     sentinels=syms.shape[-1] > 20)
    _tx_both(syms, lut, taps, sps, span, kw)


def _tx_ran(fn, *args, **kw) -> list:
    """The names of the K2 kernels five calls of ``fn`` ran, by the
    profiler (again only where a profile lost every record)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                fn(*args, **kw)
            torch.cuda.synchronize()
        ran = [e.key.replace(" ", "") for e in prof.key_averages()
               if "pulse_tx_" in e.key]
        if ran:
            return ran
    return ran


@pytest.mark.parametrize("sps,span,k", [(8, 8, 4096), (8, 8, 1), (2, 10, 31),
                                        (4, 6, 257), (16, 4, 257)])
@pytest.mark.parametrize("mode", TX_MODES[:5], ids=TX_MODE_IDS[:5])
def test_tx_kernel_routes(sps, span, k, mode, dev):
    """K2 runs the kernel its route names, as the profiler sees it: the
    short route's ``pulse_tx_core`` at sps 8, span 8 (the flagship's 4096
    symbols over 5 channels, and K = 1), the long route's
    ``pulse_tx_kernel`` at every other shape; and equals the long route."""
    lut = torch.as_tensor(_qpsk().astype(np.float32), device=dev)
    syms = _syms((5, k), dev, sps + k, sentinels=k > 20)
    taps = _taps(sps, span).to(dev)
    ran = _tx_ran(txrx.tx_kernel, syms, lut, taps, sps, span, **mode[1])
    want = "pulse_tx_core" if (sps, span) == (8, 8) else "pulse_tx_kernel"
    assert len(ran) == 1 and want in ran[0], ran
    _tx_both(syms, lut, taps, sps, span, mode[1])


@pytest.mark.parametrize("sps,span,carrier", [
    (8, 8, None), (8, 8, 2000), (4, 6, None), (16, 4, 1700)])
@pytest.mark.parametrize("int16", [False, True], ids=["f32", "i16"])
def test_tx_stream_pushes_equal_one_shot(sps, span, carrier, int16, dev):
    """``StreamingFusedTx`` in ragged pushes (each one K2 launch: the short
    route at sps 8, as the profiler sees on a push of a fresh stream, the
    long route at sps 4 and 16) equals ``tx_fused`` in one shot, bit for
    bit."""
    from modem_tpu_torch import StreamingFusedTx
    from modem_tpu_torch.chain import PulseShapedChain
    from modem_tpu_torch.models.psk import QPSK

    chain = PulseShapedChain(QPSK(0.0, 1.0), Rates(10000 // sps, 10000),
                             span_symbols=span, carrier_hz=carrier,
                             device=dev)
    g = torch.Generator(device=dev).manual_seed(sps)
    bits = torch.randint(0, 2, (6, 2 * 1000), generator=g, device=dev,
                         dtype=torch.int32)
    scale = 3000.0 if int16 else None
    ran = _tx_ran(lambda: StreamingFusedTx(chain, (6,), out_scale=scale)
                  .push(bits[:, :700]))
    want = "pulse_tx_core" if sps == 8 else "pulse_tx_kernel"
    assert len(ran) == 1 and want in ran[0], ran
    one = chain.tx_fused(bits, out_scale=scale)
    st = StreamingFusedTx(chain, (6,), out_scale=scale)
    cuts = [0, 2, 66, 700, 1234, 2000]
    parts = [_launches(txrx.TX_KERNEL, st.push, bits[:, a:b])
             for a, b in zip(cuts, cuts[1:])] + [st.flush()]
    one = one if isinstance(one, tuple) else (one,)
    parts = [p if isinstance(p, tuple) else (p,) for p in parts]
    for r, o in enumerate(one):
        assert torch.equal(torch.cat([p[r] for p in parts], -1), o)


@pytest.mark.parametrize("preset", ["reference_link", "lte_like_turbo_link",
                                    "nr_like_control_link"])
def test_tx_links_take_the_short_route(preset, dev):
    """Every link's ``tx_fused`` (the flagship's QPSK chain, sps 8, span 8)
    launches K2's short route once, as the profiler sees it, and gives the
    staged ``tx``'s waveform."""
    from modem_tpu_torch import presets

    link = getattr(presets, preset)(device=dev)
    g = torch.Generator(device=dev).manual_seed(len(preset))
    payload = torch.randint(0, 2, (4, link.payload_bits), generator=g,
                            device=dev, dtype=torch.int32)
    ran = _tx_ran(link.tx_fused, payload)
    assert len(ran) == 1 and "pulse_tx_core" in ran[0], ran
    wave = _launches(txrx.TX_KERNEL, link.tx_fused, payload)
    _close_waves(wave, link.tx(payload))


def test_tx_long_route_on_its_chains(dev):
    """A chain past 256 taps or 64 samples a symbol launches K2's long
    route through ``tx_fused``: the plain version's waveform."""
    from modem_tpu_torch.chain import PulseShapedChain
    from modem_tpu_torch.models.psk import QPSK

    for baud, sr, span in ((1250, 10000, 32), (100, 6500, 1)):
        chain = PulseShapedChain(QPSK(0.0, 1.0), Rates(baud, sr),
                                 span_symbols=span, device=dev)
        assert txrx.kernel_taps(chain.rrc, chain.sps)[0] is None
        g = torch.Generator(device=dev).manual_seed(span)
        bits = torch.randint(0, 2, (4, 600), generator=g, device=dev,
                             dtype=torch.int32)
        wave = _launches(txrx.TX_KERNEL, chain.tx_fused, bits)
        _close_waves(wave, chain.tx(bits))


@pytest.mark.parametrize("hz", [2000, 1700, 1999, 3000],
                         ids=["5_phases", "100_phases", "10000_phases",
                              "10_phases"])
@pytest.mark.parametrize("off", [-16, 4099, -(1 << 40) + 3, (1 << 40) - 5],
                         ids=["neg", "pos", "minus_2p40", "plus_2p40"])
def test_passband_nco_phase(hz, off, dev):
    """The 32-bit NCO walk against the plain version's phase: tables of 5,
    10 and 100 phases, 10000 phases per sample (past the table's 2048);
    sym_offset negative, positive and near +-2^40. K1 and K3 exact (K3
    soft within ATOL), K2 within ATOL."""
    lut = torch.as_tensor(_qpsk().astype(np.float32), device=dev)
    taps = _taps(8, 8).to(dev)
    syms = _syms((3, 600), dev, hz + 1)
    carrier = (hz, 10000)
    _chain_exact(syms, lut, taps, 8, 8, carrier=carrier, sym_offset=off)
    args = (syms, lut, taps, 8, 8, None, carrier, off)
    wave = _launches(txrx.TX_KERNEL, txrx.tx_kernel, *args)
    _close_waves(wave, txrx.tx_plain(*args))
    g = torch.Generator(device=dev).manual_seed(hz)
    noisy = txrx.tx_plain(*args) + 0.1 * torch.randn(
        wave.shape, generator=g, device=dev)
    _rx_exact((noisy, None), 600, lut, taps, 8, 8, carrier=carrier,
              sym_offset=off)


@pytest.mark.parametrize("carrier_hz", [None, 1700])
def test_streams_in_ragged_pushes_equal_one_shot(carrier_hz, dev):
    """``StreamingFusedRx`` and ``StreamingFusedChain`` in ragged pushes
    (K3's tiles and K1's passes cut at every offset) equal the one-shot
    ``rx_fused`` and ``roundtrip_fused``."""
    from modem_tpu_torch import StreamingFusedChain, StreamingFusedRx
    from modem_tpu_torch.chain import PulseShapedChain
    from modem_tpu_torch.models.psk import QPSK

    chain = PulseShapedChain(QPSK(0.0, 1.0), Rates(1250, 10000),
                             carrier_hz=carrier_hz, device=dev)
    k = 1500
    g = torch.Generator(device=dev).manual_seed(14)
    bits = torch.randint(0, 2, (5, 2 * k), generator=g, device=dev,
                         dtype=torch.int32)
    cuts = [0, 1, 7, 300, 813, 1024, 1499, k]
    sc = StreamingFusedChain(chain, (5,))
    out = [sc.push(bits[:, 2 * a:2 * b]) for a, b in zip(cuts, cuts[1:])]
    assert torch.equal(torch.cat(out + [sc.flush()], -1),
                       chain.roundtrip_fused(bits))
    wave = chain.tx_fused(bits)
    rails = (wave,) if carrier_hz else wave
    n = rails[0].shape[-1]
    sr = StreamingFusedRx(chain, (5,))
    scuts = [8 * c for c in cuts] + [n]
    out = []
    for a, b in zip(scuts, scuts[1:]):
        part = tuple(r[:, a:b] for r in rails)
        out.append(sr.push(part[0] if carrier_hz else part))
    assert torch.equal(torch.cat(out, -1), chain.rx_fused(wave, k))
    assert torch.equal(torch.cat(out, -1), bits)


# ---- K4 (fir.cu) and K5 (demod.cu) ----

def _unit(shape, seed):
    return torch.as_tensor(np.random.default_rng(seed).uniform(
        -1, 1, shape).astype(np.float32))


#: K4's routes: the compiled tap counts, generic ones and the long route
FIR_KS = [23, 32, 64, 65, 2, 7, 256, 257, 300, 1000]


@pytest.mark.parametrize("k", FIR_KS)
@pytest.mark.parametrize("shape", [(3, 1000), (2, 2, 4097), (3, 1), (2, 5),
                                   (2, 4096), (64, 40001)], ids=str)
def test_fir_kernel(k, shape, dev):
    """K4 vs fir_plain with a carried state, unit-scale inputs, on every
    route: rows of one sample, shorter than the history, odd (misaligned
    from the second row on), whole tiles, and more tiles than the card has
    blocks (a block walks several)."""
    from modem_tpu_torch.ops import fir

    taps = _unit(k, k).to(dev) / k ** 0.5
    x, st = _unit(shape, 1).to(dev), _unit(shape[:-1] + (k - 1,), 2).to(dev)
    got = _launches(fir.FIR_KERNEL, fir.fir_kernel, x, taps, st)
    torch.testing.assert_close(got, fir.fir_plain(x, taps, st), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("k", [23, 64, 7])
@pytest.mark.parametrize("skip", [1, 2, 3])
def test_fir_kernel_off_a_16_byte_boundary(k, skip, dev):
    """K4 on rows whose storage starts 1-3 floats past a 16-byte boundary
    (a contiguous slice), of odd and even lengths: the tiles shift, the
    outputs do not."""
    from modem_tpu_torch.ops import fir

    taps = _unit(k, k).to(dev) / k ** 0.5
    for c, n in ((3, 5001), (4, 4096), (2, 3)):
        x = _unit((c * n + skip,), 9).to(dev)[skip:].view(c, n)
        st = _unit((c, k - 1), 10).to(dev)
        got = fir.fir_kernel(x, taps, st)
        torch.testing.assert_close(got, fir.fir_plain(x, taps, st),
                                   atol=ATOL, rtol=0)
        assert torch.equal(got, _fir_long(x, taps, st))


def _fir_long(x, taps, st):
    """K4's long route whatever the tap count (the taps from the device):
    the long core up to ``FIR_CORE_MAX_TAPS``."""
    from modem_tpu_torch.ops import fir

    c, n, k = math.prod(x.shape[:-1]), x.shape[-1], taps.shape[0]
    y = torch.empty_like(x)
    fir.FIR_KERNEL.launch(x.device, x.data_ptr(), st.data_ptr(), c, n, None,
                          taps.data_ptr(), k, y.data_ptr())
    return y


@pytest.mark.parametrize("k", [23, 32, 64, 65, 2, 7, 256])
def test_fir_routes_agree_bit_for_bit(k, dev):
    """The short route (compiled or generic) equals the long route bit for
    bit: one fmaf chain an output, taps from j = 0, on both."""
    from modem_tpu_torch.ops import fir

    taps = _unit(k, k + 1).to(dev) / k ** 0.5
    x, st = _unit((5, 9001), 3).to(dev), _unit((5, k - 1), 4).to(dev)
    assert torch.equal(fir.fir_kernel(x, taps, st), _fir_long(x, taps, st))


@pytest.mark.parametrize("k", [23, 32, 64, 65, 7, 256, 257, 1000])
def test_fir_kernel_pushes_equal_one_shot(k, dev):
    from modem_tpu_torch.ops.fir import fir_filter

    taps, x = _unit(k, 3).to(dev) / k ** 0.5, _unit((4, 9000), 4).to(dev)
    one, _ = fir_filter(x, taps)
    state, outs = None, []
    for a, b in ((0, 5), (5, 6), (6, 9), (9, 2100), (2100, 2150),
                 (2150, 2151), (2151, 9000)):
        y, state = fir_filter(x[:, a:b], taps, state)
        outs.append(y)
    assert torch.equal(torch.cat(outs, -1), one)


def test_fir_kernel_refuses_too_many_taps(dev):
    from modem_tpu_torch.ops import fir

    k = fir.FIR_MAX_TAPS + 1
    before = fir.FIR_KERNEL.launches
    with pytest.raises(ValueError, match="at most"):
        fir.fir_filter(torch.zeros(2, 10, device=dev), torch.ones(k))
    assert fir.FIR_KERNEL.launches == before
    # the short route's parameter holds 256 taps: more by value is refused
    taps = torch.ones(257, device=dev)
    x, st = torch.zeros(2, 10, device=dev), torch.zeros(2, 256, device=dev)
    y = torch.empty_like(x)
    with pytest.raises(RuntimeError, match="modem_fir"):
        fir.FIR_KERNEL.launch(dev, x.data_ptr(), st.data_ptr(), 2, 10,
                              fir.host_taps(taps[:256]), taps.data_ptr(),
                              257, y.data_ptr())
    assert fir.FIR_KERNEL.launches == before


#: the long core's tap counts, its last among them, and one past it (the
#: first version)
CORE_KS = [257, 300, 1000, 1025, 4096, fir.FIR_CORE_MAX_TAPS,
           fir.FIR_CORE_MAX_TAPS + 1]


@pytest.mark.parametrize("with_state", [True, False],
                         ids=["state", "no_state"])
@pytest.mark.parametrize("k", CORE_KS)
def test_fir_long_core_equals_first_version(k, with_state, dev):
    """The long route (the core up to its last count, the first version one
    past it) against the first version forced, bit for bit: rows of 1, 5,
    5001 and 40001 samples, rows 1-3 floats off a 16-byte boundary, a
    carried and a null state, and more items than the card has blocks (64
    rows of 40001: 640 tiles of the core)."""
    taps = _unit(k, k + 5).to(dev) / k ** 0.5
    for (c, n), skip in (((3, 1), 0), ((2, 5), 1), ((4, 5001), 0),
                         ((3, 5001), 3), ((2, 40001), 2), ((64, 40001), 0)):
        x = _unit((c * n + skip,), c + n).to(dev)[skip:].view(c, n)
        st = _unit((c, k - 1), n).to(dev) if with_state else None
        got = _launches(fir.FIR_KERNEL, fir.fir_kernel, x, taps, st)
        want = _launches(fir.FIR_FIRST_KERNEL, fir.fir_kernel, x, taps, st,
                         first=True)
        assert torch.equal(got, want), (k, c, n, skip)
    if with_state:  # and against the plain version on a short row
        x, st = _unit((2, 3001), 7).to(dev), _unit((2, k - 1), 8).to(dev)
        torch.testing.assert_close(fir.fir_kernel(x, taps, st),
                                   fir.fir_plain(x, taps, st), atol=ATOL,
                                   rtol=0)


def test_fir_long_routes_by_the_profiler(dev):
    """K4's device-taps path runs the long core to its last count (at 257
    and 1000 taps, and at 23 and 256 when a caller hands the taps that way)
    and the first version past it; ``first=True`` the first version at any
    count."""
    x = _unit((4, 9000), 11).to(dev)
    top = fir.FIR_CORE_MAX_TAPS
    for k, first, want in ((257, False, "fir_long_core"),
                           (1000, False, "fir_long_core"),
                           (top, False, "fir_long_core"),
                           (top + 1, False, "fir_long_kernel"),
                           (257, True, "fir_long_kernel"),
                           (23, True, "fir_long_kernel")):
        taps = _unit(k, 12).to(dev) / k ** 0.5
        ran = _kernel_names(fir.fir_kernel, x, taps, None, first,
                            family="fir_")
        assert len(ran) == 1 and f"::{want}(" in ran.pop(), (k, first, ran)
    for k in (23, 256):
        taps = _unit(k, 13).to(dev)
        st = torch.zeros(4, k - 1, device=dev)
        ran = _kernel_names(_fir_long, x, taps, st, family="fir_")
        assert len(ran) == 1 and "::fir_long_core(" in ran.pop(), (k, ran)


def test_fir_long_core_holds_its_inputs_at_the_limit(dev):
    """At its last count the core's shared memory is nearly all a block
    may have; a carried history of 15,008 samples across ragged pushes
    still equals one shot bit for bit."""
    k = fir.FIR_CORE_MAX_TAPS
    taps, x = _unit(k, 14).to(dev) / k ** 0.5, _unit((3, 30000), 15).to(dev)
    one, _ = fir.fir_filter(x, taps)
    state, outs = None, []
    for a, b in ((0, 7), (7, 13000), (13000, 13001), (13001, 30000)):
        y, state = fir.fir_filter(x[:, a:b], taps, state)
        outs.append(y)
    assert torch.equal(torch.cat(outs, -1), one)


def _device_ops(fn, *args):
    """CUDA kernels and copies one call runs, by the profiler: the most of
    three profiles of one call each (a profile now and then loses
    records)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    most = 0
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn(*args)
            torch.cuda.synchronize()
        most = max(most, sum(e.count for e in prof.key_averages()
                             if e.device_type == DeviceType.CUDA))
    return most


@pytest.mark.parametrize("k", [23, 7, 257])
def test_fir_kernel_takes_no_state(k, dev):
    """``state=None`` is a zero history the kernel makes itself, bit for
    bit with a zero state on every route; ``fir_filter`` then runs K4
    alone (no zero fill, no copy of the new state, which is a view of x),
    and numpy taps cross to the card once."""
    from modem_tpu_torch.ops import fir

    taps = (_unit(k, k + 5) / k ** 0.5).numpy()
    x = _unit((5, 9001), 6).to(dev)
    t = fir.as_taps(taps, dev)
    want = fir.fir_kernel(x, t, torch.zeros(5, k - 1, device=dev))
    assert torch.equal(fir.fir_kernel(x, t, None), want)
    y, state = fir.fir_filter(x, taps)
    assert torch.equal(y, want) and fir.as_taps(taps.copy(), dev) is t
    assert state.data_ptr() == x[:, 9001 - (k - 1):].data_ptr()
    assert _device_ops(fir.fir_filter, x, taps) == 1


@pytest.mark.parametrize("extra", [-2, 2], ids=["k_minus_3", "k_plus_1"])
@pytest.mark.parametrize("k", [23, 65, 100, 257])
def test_fir_kernel_state_of_another_length(k, extra, dev):
    """A state of K-3 and of K+1 samples through K4 (one launch over
    ``state ++ x`` with the zero history) and through ``fir_filter``,
    against ``fir_plain`` on the same rows: ``n + len(state) - (K-1)``
    outputs within 1e-5, the new state the last K-1 samples of ``state ++
    x``."""
    from modem_tpu_torch.ops import fir

    taps = (_unit(k, k + 7) / k ** 0.5).to(dev)
    st = _unit((3, k - 1 + extra), k + 8).to(dev)
    for n in ((5, 3001) if extra < 0 else (0, 5, 3001)):
        x = _unit((3, n), k + n).to(dev)
        before = fir.FIR_KERNEL.launches
        got = fir.fir_kernel(x, taps, st)
        assert fir.FIR_KERNEL.launches == before + 1
        want = fir.fir_plain(x, taps, st)
        assert got.shape == want.shape == (3, n + extra)
        torch.testing.assert_close(got, want, atol=ATOL, rtol=0)
        y, s = fir.fir_filter(x, taps, st)
        assert torch.equal(y, got)
        assert torch.equal(s, torch.cat([st, x], -1)[:, -(k - 1):])


#: the FIR engine's backends beside K4
FIR_BACKENDS = ["conv", "matmul", "fft"]


@pytest.mark.parametrize("k", [23, 64, 65, 257])
@pytest.mark.parametrize("backend", FIR_BACKENDS)
def test_fir_backend_on_card_equals_cpu(backend, k, dev):
    """Each backend on the card against its CPU run and float64
    ``np.convolve`` (the JAX tests' 1e-4), with a carried state; with TF32
    allowed in both of PyTorch's global flags (cuDNN's default) the result
    is the same, since the backend pins float32 itself, and the flags come
    back as they were."""
    from modem_tpu_torch.ops.fir import fir_filter

    taps = _unit(k, k + 7) / k ** 0.5
    x, st = _unit((4, 9000), 8), _unit((4, k - 1), 9)
    cpu, cpu_state = fir_filter(x, taps, st, backend)
    xp = torch.cat([st, x], -1).double().numpy()
    ref = np.stack([np.convolve(r, taps.double().numpy())[k - 1: k - 1 + 9000]
                    for r in xp])
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    try:
        outs = []
        for tf32 in (False, True):
            torch.backends.cudnn.allow_tf32 = tf32
            torch.backends.cuda.matmul.allow_tf32 = tf32
            y, state = fir_filter(x.to(dev), taps.to(dev), st.to(dev),
                                  backend)
            assert (torch.backends.cudnn.allow_tf32,
                    torch.backends.cuda.matmul.allow_tf32) == (tf32, tf32)
            assert y.is_cuda and y.dtype == torch.float32
            assert torch.equal(state.cpu(), cpu_state)
            np.testing.assert_allclose(y.cpu().numpy(), ref, atol=1e-4)
            np.testing.assert_allclose(y.cpu().numpy(), cpu.numpy(),
                                       atol=1e-4, rtol=0)
            outs.append(y)
        assert torch.equal(outs[0], outs[1])
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


@pytest.mark.parametrize("backend", FIR_BACKENDS)
def test_fir_backend_entry_points_on_card(backend, dev):
    """``Demodulator(fir_backend=b)``'s ``lock_phase`` and ``demodulate``,
    and ``qpsk_reference_chain(fir_backend=b)``'s staged ``tx`` and ``rx``,
    on the card against the CPU (within 1e-5 of the largest value) and
    against K4's ``direct`` (the JAX test's 1e-4); the chain's bits back
    exactly."""
    from modem_tpu_torch import Demodulator, Modulator, make_scheme

    r = Rates(1250, 10000)
    mod = Modulator(make_scheme("qpsk", r), r, carrier_hz=2000, device="cpu")
    g = torch.Generator().manual_seed(10)
    bits = torch.randint(0, 2, (3, 2 * 600), generator=g, dtype=torch.int32)
    wave, _ = mod.passband(bits, mod.init_state((3,)))
    runs = {}
    for name, device in (("cpu", "cpu"), (backend, dev), ("direct", dev)):
        d = Demodulator(2000, 10000, device=device,
                        fir_backend="direct" if name == "direct" else backend)
        x = wave.to(device)
        st = d.lock_phase(x[:, :64], d.init_state((3,)))
        (i, q), _ = d.demodulate(x[:, 64:], st)
        runs[name] = torch.stack([i, q]).cpu()
    peak = float(runs["cpu"].abs().max())
    assert float((runs[backend] - runs["cpu"]).abs().max()) <= 1e-5 * peak
    assert float((runs[backend] - runs["direct"]).abs().max()) <= 1e-4
    chain = qpsk_reference_chain(r, fir_backend=backend, device=dev)
    cpu = qpsk_reference_chain(r, fir_backend=backend, device="cpu")
    cb = bits.to(dev)
    tx = chain.tx(cb)
    for a, b in zip(tx, cpu.tx(bits)):
        assert float((a.cpu() - b).abs().max()) <= 1e-5 * float(b.abs().max())
    assert torch.equal(chain.rx(tx, 600), cb)
    assert torch.equal(chain.roundtrip(cb), cb)


#: K5's carriers: a table of 5 phases (the reference path's), of 100, and
#: none (10007 phases: one sincosf a sample)
DEMOD_CARRIERS = [(2000, 10000), (1700, 10000), (2001, 10007)]


@pytest.mark.parametrize("carrier", DEMOD_CARRIERS, ids=str)
@pytest.mark.parametrize("k", [64, 65, 23])
@pytest.mark.parametrize("hist", [0, 63, 100])
def test_demod_kernel(hist, k, carrier, dev):
    """K5 vs demod_plain: phases per channel, a stream counter, a
    history read in place; 64 and 65 taps compiled, 23 generic; the
    carrier's phases from a table and without one."""
    from modem_tpu_torch.ops import demod_kernel as dk
    from modem_tpu_torch.ops.filters import lowpass_taps

    taps = (torch.as_tensor(lowpass_taps(), device=dev) if k == 64
            else _unit(k, k).to(dev) / k ** 0.5)
    hz, sr = carrier
    x, h = _unit((2, 3, 5000), 5).to(dev), _unit((2, 3, hist), 6).to(dev)
    phi = _unit((2, 3), 7).to(dev) * 3
    off = torch.tensor(9971, dtype=torch.int32, device=dev)
    got = _launches(dk.DEMOD_KERNEL, dk.demod_kernel, x, h, taps, hz, sr,
                    off, phi)
    want = dk.demod_plain(x, h, taps, hz, sr, off, phi)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=ATOL, rtol=0)


@pytest.mark.parametrize("carrier", DEMOD_CARRIERS, ids=str)
@pytest.mark.parametrize("k", [64, 65, 23])
def test_demod_kernel_pushes_equal_one_shot(k, carrier, dev):
    """K5 in ragged pushes (shorter than the history, odd, across tiles,
    more tiles than the card has blocks) equals one shot bit for bit, from
    a negative stream counter."""
    from modem_tpu_torch.ops.demod_kernel import fused_product_detect

    taps = _unit(k, k + 2).to(dev) / k ** 0.5
    hz, sr = carrier
    x = _unit((70, 20011), 8).to(dev)
    phi = _unit((70,), 9).to(dev) * 3
    s0 = -12345
    one = fused_product_detect(x, hz, sr, taps, phi, s0)
    hist = x.new_zeros((70, k - 1))
    parts = []
    for a, b in ((0, 1), (1, 4), (4, 2049), (2049, 2050), (2050, 20011)):
        part = fused_product_detect(x[:, a:b], hz, sr, taps, phi, s0 + a,
                                    hist)
        parts.append(torch.stack(part))
        hist = torch.cat([hist, x[:, a:b]], -1)[:, -(k - 1):]
    assert torch.equal(torch.cat(parts, -1), torch.stack(one))


@pytest.mark.parametrize("skip", [1, 3])
def test_demod_kernel_off_a_16_byte_boundary(skip, dev):
    """K5 on rows whose storage starts past a 16-byte boundary, with a
    history: the tiles shift, the outputs do not."""
    from modem_tpu_torch.ops import demod_kernel as dk
    from modem_tpu_torch.ops.filters import lowpass_taps

    taps = torch.as_tensor(lowpass_taps(), device=dev)
    c, n = 3, 5001
    x = _unit((c * n + skip,), 11).to(dev)[skip:].view(c, n)
    h, phi = _unit((c, 63), 12).to(dev), _unit((c,), 13).to(dev)
    off = torch.tensor(-77, dtype=torch.int32, device=dev)
    for hz, sr in DEMOD_CARRIERS:
        got = dk.demod_kernel(x, h, taps, hz, sr, off, phi)
        want = dk.demod_plain(x, h, taps, hz, sr, off, phi)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, atol=ATOL, rtol=0)


def test_demod_kernel_refuses_what_it_does_not_take(dev):
    from modem_tpu_torch.ops import demod_kernel as dk

    x, h = torch.zeros(2, 10, device=dev), torch.zeros(2, 65, device=dev)
    phi = torch.zeros(2, device=dev)
    off = torch.tensor(0, dtype=torch.int32, device=dev)
    before = dk.DEMOD_KERNEL.launches
    with pytest.raises(RuntimeError, match="modem_demod"):
        dk.demod_kernel(x, h, torch.ones(66, device=dev), 2000, 10000, off,
                        phi)
    with pytest.raises(ValueError, match="65 taps"):
        dk.fused_product_detect(x, 2000, 10000, torch.ones(66, device=dev))
    assert dk.DEMOD_KERNEL.launches == before


def test_demodulator_on_card(dev):
    """Lock, staged (K4) and fused (K5) detection on the card vs the CPU;
    fused pushes equal fused one shot exactly."""
    from modem_tpu_torch import Demodulator, Modulator, make_scheme

    rates = Rates(1250, 10000)
    bits = torch.as_tensor(np.random.default_rng(8).integers(
        0, 2, (4, 2 * 3000)).astype(np.int32))
    outs = {}
    for d in ("cpu", dev):
        mod = Modulator(make_scheme("qpsk", rates), rates, 2000, device=d)
        wave, _ = mod.passband(bits.to(d), mod.init_state((4,)))
        dem = Demodulator(2000, 10000, device=d)
        st = dem.lock_phase(wave[:, :64], dem.init_state((4,)))
        staged, _ = dem.demodulate(wave[:, 64:], st)
        fused, _, _ = dem.demodulate_fused(wave[:, 64:], st)
        outs[str(d)] = (wave, st.phase_offset, staged, fused)
        if d == dev:
            x, parts, s, tail = wave[:, 64:], [], st, None
            for a, b in ((0, 1000), (1000, 1030), (1030, x.shape[-1])):
                (i, q), s, tail = dem.demodulate_fused(x[:, a:b], s, tail)
                parts.append(torch.stack([i, q]))
            assert torch.equal(torch.cat(parts, -1), torch.stack(fused))
            for a, b in zip(staged, fused):
                torch.testing.assert_close(a, b, atol=ATOL, rtol=0)
    cpu, gpu = outs["cpu"], outs[str(dev)]
    torch.testing.assert_close(gpu[0].cpu(), cpu[0], atol=1e-6, rtol=0)
    torch.testing.assert_close(gpu[1].cpu(), cpu[1], atol=ATOL, rtol=0)
    for g, c in zip(gpu[2] + gpu[3], cpu[2] + cpu[3]):
        torch.testing.assert_close(g.cpu(), c, atol=ATOL, rtol=0)


def test_staged_chain_runs_k4(dev):
    from modem_tpu_torch.ops import fir

    chain = qpsk_reference_chain(Rates(1250, 10000), device=dev)
    bits = torch.randint(0, 2, (8, 2 * 512), device=dev, dtype=torch.int32)
    before = fir.FIR_KERNEL.launches
    assert torch.equal(chain.roundtrip(bits), bits)
    assert fir.FIR_KERNEL.launches == before + 4


# ---- K6, K8, K9, K10 (fsk.cu) ----

def _fsk_schemes():
    from modem_tpu_torch.models import fsk

    r = Rates(1250, 10000)
    return {"bfsk": fsk.BFSK(200, 10000, 1.0),
            "mfsk_increase": fsk.MFSK(4, 50, 10000, 1.0, "increase"),
            "mfsk_default": fsk.MFSK(4, 50, 10000, 1.0, "default"),
            "cpfsk2": fsk.CPFSK(2, r, 1.0, 1)}


FSK_NAMES = ["bfsk", "mfsk_increase", "mfsk_default", "cpfsk2"]


def _fsk_program(name, shape, dev, seed=0):
    scheme = _fsk_schemes()[name]
    rng = np.random.default_rng(seed)
    syms = torch.as_tensor(rng.integers(0, 1 << scheme.bits_per_symbol, shape)
                           .astype(np.int32), device=dev)
    prog, _ = scheme.program(syms, scheme.init_state(shape[:-1], dev),
                             Rates(1250, 10000), 0)
    return scheme, syms, prog


@pytest.mark.parametrize("name", FSK_NAMES)
@pytest.mark.parametrize("shape", [(3, 600), (2, 2, 257), (1, 1)], ids=str)
def test_fsk_tx_kernel(name, shape, dev):
    from modem_tpu_torch.ops import fsk_kernel as fk

    _, _, prog = _fsk_program(name, shape, dev)
    args = (prog.fnum, prog.pnum, prog.den, 8, 1.0, prog.qshift)
    got = _launches(fk.FSK_TX_KERNEL, fk.fused_fsk_tx, *args)
    want = fk.fsk_tx_plain(*args)
    for g, w in zip(got, want):
        assert g.shape == shape[:-1] + (shape[-1] * 8,)
        torch.testing.assert_close(g, w, atol=ATOL, rtol=0)


@pytest.mark.parametrize("spb", [2, 4, 8])
def test_msk_tx_kernel(spb, dev):
    from modem_tpu_torch.ops import fsk_kernel as fk

    rng = np.random.default_rng(spb)
    s0, s1 = (torch.as_tensor((2 * rng.integers(0, 2, (3, 777)) - 1)
                              .astype(np.int32), device=dev) for _ in range(2))
    got = _launches(fk.MSK_TX_KERNEL, fk.fused_msk_tx, s0, s1, spb, 0.7)
    for g, w in zip(got, fk.msk_tx_plain(s0, s1, spb, 0.7)):
        torch.testing.assert_close(g, w, atol=ATOL, rtol=0)


@pytest.mark.parametrize("group,guard", [(8, 1), (8, 3), (4, 1), (16, 2)])
def test_disc_means_kernel(group, guard, dev):
    from modem_tpu_torch.ops import fsk_kernel as fk

    g = torch.Generator(device=dev).manual_seed(group)
    ph = torch.cumsum(torch.rand((2, 3, 300 * group), generator=g, device=dev)
                      * 2 - 1, dim=-1)
    i = torch.cos(ph) + 0.05 * torch.randn(ph.shape, generator=g, device=dev)
    q = torch.sin(ph) + 0.05 * torch.randn(ph.shape, generator=g, device=dev)
    got = _launches(fk.DISC_MEANS_KERNEL, fk.fused_discriminator_means, i, q,
                    group, guard)
    assert got.shape == (2, 3, 300)
    torch.testing.assert_close(got, fk.disc_means_plain(i, q, group, guard),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("name", FSK_NAMES)
def test_fsk_chain_kernel_noiseless(name, dev):
    from modem_tpu_torch.ops import fsk_kernel as fk

    scheme, syms, _ = _fsk_program(name, (3, 600), dev, seed=1)
    got = _launches(fk.FSK_CHAIN_KERNEL, fk.fused_fsk_chain, syms, scheme,
                    Rates(1250, 10000))
    assert torch.equal(got, syms)


@pytest.mark.parametrize("snr", [14.0, 20.0])
def test_fsk_chain_kernel_noisy(snr, dev):
    """130 ch x 600 sym in tiles of 32 symbols: the kernel draws the plain
    version's noise; decisions equal on >= 99.99% of symbols."""
    from modem_tpu_torch.ops import fsk_kernel as fk

    scheme, syms, prog = _fsk_program("mfsk_increase", (130, 600), dev, 2)
    coefs = fk.fsk_coef_table(scheme)
    sigma = fk.fsk_noise_sigma(1.0, snr)
    args = (prog.fnum, prog.pnum, coefs, prog.den, 8, 1.0, prog.qshift, 1, 32,
            sigma, 1234)
    got = _launches(fk.FSK_CHAIN_KERNEL, fk.fsk_decide_from_program, *args)
    plain = fk.fsk_decide_from_program(*(a.cpu() if torch.is_tensor(a) else a
                                         for a in args)).to(dev)
    assert float((got == plain).float().mean()) >= 0.9999
    assert bool((got != syms).any())


def test_fsk_chains_on_card(dev):
    from modem_tpu_torch import FskChain, MskChain, make_scheme
    from modem_tpu_torch.ops import fsk_kernel as fk

    r = Rates(1250, 10000)
    chain = FskChain(make_scheme("mfsk", r), r, 2 * np.arange(16),
                     2 * np.pi * 50 / 10000, device=dev)
    bits = torch.randint(0, 2, (16, 4 * 1024), device=dev, dtype=torch.int32)
    before = [k.launches for k in (fk.FSK_CHAIN_KERNEL, fk.FSK_TX_KERNEL,
                                   fk.DISC_MEANS_KERNEL, fk.MSK_TX_KERNEL)]
    assert torch.equal(chain.roundtrip_fused(bits), bits)
    wave = chain.tx_fused(bits)
    for f, s in zip(wave, chain.tx(bits)):
        torch.testing.assert_close(f, s, atol=ATOL, rtol=0)
    assert torch.equal(chain.rx_fused(*wave), bits)
    assert torch.equal((chain.rx_soft_fused(*wave) < 0).int(), bits)
    msk = MskChain(r, device=dev)
    mbits = torch.randint(0, 2, (16, 2 * 1024), device=dev, dtype=torch.int32)
    assert torch.equal(msk.rx_fused(*msk.tx_fused(mbits)), mbits)
    after = [k.launches for k in (fk.FSK_CHAIN_KERNEL, fk.FSK_TX_KERNEL,
                                  fk.DISC_MEANS_KERNEL, fk.MSK_TX_KERNEL)]
    assert [a - b for a, b in zip(after, before)] == [1, 1, 3, 1]


def test_fsk_empty_inputs_launch_nothing(dev):
    from modem_tpu_torch.ops import fsk_kernel as fk

    kernels = (fk.FSK_CHAIN_KERNEL, fk.FSK_TX_KERNEL, fk.DISC_MEANS_KERNEL,
               fk.MSK_TX_KERNEL)
    before = [k.launches for k in kernels]
    e = torch.zeros((0, 10), dtype=torch.int32, device=dev)
    assert fk.fused_fsk_tx(e, e, 10000, 8, 1.0, 0.0)[0].shape == (0, 80)
    assert fk.fused_msk_tx(e, e, 4, 1.0)[0].shape == (0, 40)
    assert fk.fsk_decide_from_program(e, e, (0, 100), 10000, 8, 1.0,
                                      0.0).shape == (0, 10)
    assert fk.fused_discriminator_means(e.float(), e.float(), 5).shape == (0, 2)
    assert before == [k.launches for k in kernels]


def test_fsk_kernels_refuse_bad_arguments(dev):
    """The C entry points refuse what the kernels do not take before any
    launch; the wrappers raise ValueError before reaching them."""
    from modem_tpu_torch.ops import fsk_kernel as fk

    before = fk.FSK_CHAIN_KERNEL.launches
    x = torch.zeros((2, 64), device=dev)
    with pytest.raises(RuntimeError, match="CUDA error"):
        fk.disc_means_kernel(x, x, 8, 0)
    with pytest.raises(ValueError, match="guard"):
        fk.fused_discriminator_means(x, x, 8, 8)
    f = torch.zeros((2, 8), dtype=torch.int32, device=dev)
    targets = torch.zeros(2, device=dev)
    with pytest.raises(RuntimeError, match="CUDA error"):  # guard 0
        fk.fsk_chain_kernel(f, f, targets, 10000, 8, 1.0, 0.0, 0, 256, None, 0)
    with pytest.raises(RuntimeError, match="CUDA error"):  # chunk_sym 0
        fk.fsk_chain_kernel(f, f, targets, 10000, 8, 1.0, 0.0, 1, 0, None, 0)
    assert fk.FSK_CHAIN_KERNEL.launches == before


# ---- K7 (fsk.cu) ----

def _slot_signs(shape, dev, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(torch.as_tensor((2 * rng.integers(0, 2, shape) - 1)
                                 .astype(np.int32), device=dev)
                 for _ in range(2))


@pytest.mark.parametrize("spb,guard", [(2, 1), (4, 1), (8, 3)])
def test_msk_chain_kernel_noiseless(spb, guard, dev):
    from modem_tpu_torch.ops import fsk_kernel as fk

    s0, s1 = _slot_signs((2, 3, 777), dev, spb)
    got = _launches(fk.MSK_CHAIN_KERNEL, fk.fused_msk_slots, s0, s1, spb, 0.7,
                    guard)
    assert got.dtype == torch.int32 and got.shape == (2, 3, 777)
    assert torch.equal(got, fk.msk_chain_plain(s0, s1, spb, 0.7, guard, 256,
                                               None, 0))
    assert torch.equal(got, (s0 * s1 > 0).int())


@pytest.mark.parametrize("snr", [4.0, 8.0])
def test_msk_chain_kernel_noisy(snr, dev):
    """130 ch x 600 slots in tiles of 32 slots: the kernel draws the plain
    version's noise; decisions equal on >= 99.99% of slots."""
    from modem_tpu_torch.ops import fsk_kernel as fk

    s0, s1 = _slot_signs((130, 600), dev, 3)
    args = (s0, s1, 4, 1.0, 1, 32, snr, 4321)
    got = _launches(fk.MSK_CHAIN_KERNEL, fk.fused_msk_slots, *args)
    plain = fk.fused_msk_slots(*(a.cpu() if torch.is_tensor(a) else a
                                 for a in args)).to(dev)
    assert float((got == plain).float().mean()) >= 0.9999
    assert bool((got != (s0 * s1 > 0).int()).any())


def test_msk_roundtrip_fused_on_card(dev):
    from modem_tpu_torch import MskChain
    from modem_tpu_torch.ops import fsk_kernel as fk

    msk = MskChain(Rates(1250, 10000), device=dev)
    bits = torch.randint(0, 2, (16, 2 * 1024), device=dev, dtype=torch.int32)
    before = fk.MSK_CHAIN_KERNEL.launches
    assert torch.equal(msk.roundtrip_fused(bits), bits)
    noisy = msk.roundtrip_fused(bits, snr_db=6.0, seed=2)
    assert noisy.shape == bits.shape and bool((noisy != bits).any())
    assert fk.MSK_CHAIN_KERNEL.launches == before + 2


# ---- K6 and K7 on the core (fsk.cu) ----

FSK_ODD = [(130, 600), (7, 603)]  # two lane keys; rows off 16-byte bounds


def _odd_k6(name, sps, shape, dev, seed):
    """K6's arguments for scheme ``name`` at ``sps`` (den 10000): guard 1,
    sps/2 and sps - 1, without noise and at 12 dB in tiles of 32 and 256."""
    from modem_tpu_torch.models.base import f32
    from modem_tpu_torch.ops import fsk_kernel as fk

    scheme = _fsk_schemes()[name]
    rng = np.random.default_rng(seed)
    syms = torch.as_tensor(rng.integers(0, 1 << scheme.bits_per_symbol, shape)
                           .astype(np.int32), device=dev)
    prog, _ = scheme.program(syms, scheme.init_state(shape[:-1], dev),
                             Rates(10000 // sps, 10000), 0)
    targets = fk._candidate_increments(fk.fsk_coef_table(scheme), prog.den,
                                       dev)
    sigma = f32(fk.fsk_noise_sigma(1.0, 12.0))
    return [(prog.fnum, prog.pnum, targets, prog.den, sps, 1.0,
             f32(prog.qshift), guard, cs, sig, seed)
            for guard in sorted({1, sps // 2, sps - 1})
            for cs, sig in ((256, None), (32, sigma), (256, sigma))]


@pytest.mark.parametrize("sps", [2, 8, 16])
@pytest.mark.parametrize("name", ["bfsk", "mfsk_increase", "mfsk_default"])
def test_fsk_core_equals_long_route(name, sps, dev):
    """The core's decisions are the first version's bit for bit, with and
    without noise, at every guard's extremes, at odd shapes; one launch
    each."""
    from modem_tpu_torch.ops import fsk_kernel as fk

    for shape in FSK_ODD:
        for args in _odd_k6(name, sps, shape, dev, sps + shape[1]):
            got = _launches(fk.FSK_CHAIN_KERNEL, fk.fsk_chain_kernel, *args)
            ref = _launches(fk.FSK_CHAIN_KERNEL, fk._fsk_launch, *args,
                            tone=None)
            assert torch.equal(got, ref), (shape, args[7], args[8:10])
            if args[9] is None:
                assert torch.equal(got, fk.fsk_chain_plain(*args))


@pytest.mark.parametrize("sigma", [None, 1e-4])
@pytest.mark.parametrize("guard", [1, 3])
def test_fsk_core_reads_the_same_mean(guard, sigma, dev):
    """One tone at random phases and 256 candidates spread over the range
    of the means: each decision reads the mean to a few ulps, and the two
    routes decide alike."""
    from modem_tpu_torch.ops import fsk_kernel as fk

    shape, qshift = (64, 1024), float(np.float32(-np.pi / 2))
    rng = np.random.default_rng(guard)
    fnum = torch.full(shape, 10, dtype=torch.int32, device=dev)
    pnum = torch.as_tensor(rng.integers(0, 10000, shape).astype(np.int32),
                           device=dev)
    wi, wq = fk.fsk_tx_plain(fnum, pnum, 10000, 8, 1.0, qshift)
    if sigma is not None:
        gi, gq = fk.fsk_noise(shape, 8, 256, 5, dev)
        wi = wi + sigma * gi.reshape(wi.shape)
        wq = wq + sigma * gq.reshape(wq.shape)
    mean = fk.disc_means_plain(wi, wq, 8, guard)
    ladder = torch.linspace(float(mean.min()), float(mean.max()), 256,
                            device=dev)
    args = (fnum, pnum, ladder, 10000, 8, 1.0, qshift, guard, 256, sigma, 5)
    got = fk.fsk_chain_kernel(*args)
    assert torch.equal(got, fk._fsk_launch(*args, tone=None))
    assert len(torch.unique(got)) > 100


@pytest.mark.parametrize("den", [10000, 9973, 12288])
def test_fsk_tone_table_matches_its_twin(den, dev):
    from modem_tpu_torch.ops import fsk_kernel as fk

    got = _launches(fk.FSK_TONE_KERNEL, fk.tone_table_kernel, den, 0.8,
                    float(np.float32(-np.pi / 2)), dev)
    want = fk.tone_table_plain(den, 0.8, float(np.float32(-np.pi / 2)), dev)
    assert got.shape == (den, 2)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)
    with pytest.raises(ValueError):
        fk.tone_table_kernel(fk.TONE_CAP + 1, 1.0, 0.0, dev)


def test_fsk_tone_table_made_once(dev):
    """The first call of a (den, amp, qshift) makes its table, later ones
    launch K6 alone; a den past the cap makes none."""
    from modem_tpu_torch.models import fsk
    from modem_tpu_torch.ops import fsk_kernel as fk

    _, syms, _ = _fsk_program("mfsk_increase", (4, 64), dev, seed=9)
    fk.tone_table.cache_clear()
    counts = []
    for sr in (10000, 10000, 20000):
        scheme = fsk.MFSK(4, 50, sr, 1.0, "increase")
        before = (fk.FSK_TONE_KERNEL.launches, fk.FSK_CHAIN_KERNEL.launches)
        got = fk.fused_fsk_chain(syms, scheme, Rates(sr // 8, sr))
        torch.cuda.synchronize()
        assert torch.equal(got, syms)
        counts.append((fk.FSK_TONE_KERNEL.launches - before[0],
                       fk.FSK_CHAIN_KERNEL.launches - before[1]))
    assert counts == [(1, 1), (0, 1), (0, 1)]


def test_fsk_msk_cores_refuse_past_their_caps(dev):
    """The C entries refuse a core past its cap before any launch."""
    from modem_tpu_torch.ops import fsk_kernel as fk

    f = torch.zeros((2, 8), dtype=torch.int32, device=dev)
    targets = torch.zeros(2, device=dev)
    tone = torch.zeros((fk.TONE_CAP + 1, 2), device=dev)
    before = (fk.FSK_CHAIN_KERNEL.launches, fk.MSK_CHAIN_KERNEL.launches)
    with pytest.raises(RuntimeError, match="CUDA error"):
        fk._fsk_launch(f, f, targets, fk.TONE_CAP + 1, 8, 1.0, 0.0, 1, 256,
                       None, 0, tone=tone)
    s = torch.ones((2, 8), dtype=torch.int32, device=dev)
    with pytest.raises(RuntimeError, match="CUDA error"):
        fk._msk_launch(s, s, fk.MSK_CAP + 1, 1.0, 1, 256, None, 0, core=True)
    assert (fk.FSK_CHAIN_KERNEL.launches,
            fk.MSK_CHAIN_KERNEL.launches) == before


@pytest.mark.parametrize("spb", [2, 4, 8])
def test_msk_core_equals_long_route(spb, dev):
    from modem_tpu_torch.models.base import f32
    from modem_tpu_torch.ops import fsk_kernel as fk

    sigma = f32(fk.fsk_noise_sigma(0.9, 4.0))
    for shape in FSK_ODD:
        s0, s1 = _slot_signs(shape, dev, spb + shape[1])
        for guard in sorted({1, spb - 1}):
            for cs, sig in ((256, None), (32, sigma), (256, sigma)):
                args = (s0, s1, spb, 0.9, guard, cs, sig, 7)
                got = _launches(fk.MSK_CHAIN_KERNEL, fk.msk_chain_kernel,
                                *args)
                ref = _launches(fk.MSK_CHAIN_KERNEL, fk._msk_launch, *args,
                                core=False)
                assert torch.equal(got, ref), (shape, guard, cs, sig)
                if sig is None:
                    assert torch.equal(got, (s0 * s1 > 0).int())


# ---- K8 and K10 on the TX core (fsk.cu) ----

#: (channels, symbols or slots): rows of 1, 3 and 603 (most rows off a
#: 16-byte boundary at spb 2 and 3), 7 and 130 of them, and full width
TX_SHAPES = [(7, 1), (7, 3), (7, 603), (130, 1), (130, 3), (130, 603),
             (256, 4096)]


@pytest.mark.parametrize("shape", TX_SHAPES, ids=str)
@pytest.mark.parametrize("name", FSK_NAMES)
def test_fsk_tx_core_equals_long_route(name, shape, dev):
    """K8's core (K6's tone table) writes the first version's samples bit
    for bit; both within ATOL of the plain version; one launch each."""
    from modem_tpu_torch.ops import fsk_kernel as fk

    _, _, prog = _fsk_program(name, shape, dev, seed=shape[1])
    args = (prog.fnum, prog.pnum, prog.den, 8, 1.0, prog.qshift)
    assert fk.fsk_tx_route(prog.den, 8) == "core"
    got = _launches(fk.FSK_TX_KERNEL, fk.fused_fsk_tx, *args)
    ref = _launches(fk.FSK_TX_KERNEL, fk._fsk_tx_launch, *args, tone=None)
    want = fk.fsk_tx_plain(*args)
    for g, r, w in zip(got, ref, want):
        assert g.shape == shape[:-1] + (shape[-1] * 8,)
        assert torch.equal(g, r)
        torch.testing.assert_close(g, w, atol=ATOL, rtol=0)


@pytest.mark.parametrize("shape", TX_SHAPES, ids=str)
@pytest.mark.parametrize("spb", [2, 3, 4, 8])
def test_msk_tx_core_equals_long_route(spb, shape, dev):
    """K10's core writes the first version's samples bit for bit, rows off
    16-byte boundaries and a last piece of fewer than 4 samples among them;
    both within ATOL of the plain version."""
    from modem_tpu_torch.ops import fsk_kernel as fk

    s0, s1 = _slot_signs(shape, dev, spb + shape[1])
    assert fk.msk_route(spb) == "core"
    got = _launches(fk.MSK_TX_KERNEL, fk.fused_msk_tx, s0, s1, spb, 0.7)
    ref = _launches(fk.MSK_TX_KERNEL, fk._msk_tx_launch, s0, s1, spb, 0.7,
                    core=False)
    for g, r, w in zip(got, ref, fk.msk_tx_plain(s0, s1, spb, 0.7)):
        assert g.shape == shape[:-1] + (shape[-1] * spb,)
        assert torch.equal(g, r)
        torch.testing.assert_close(g, w, atol=ATOL, rtol=0)


def test_tx_cores_refuse_what_they_do_not_take(dev):
    """The C entries refuse the TX core past its caps, at another sps
    (K8) and on outputs off a 16-byte boundary, before any launch."""
    from modem_tpu_torch import cuda
    from modem_tpu_torch.models.base import f32
    from modem_tpu_torch.ops import fsk_kernel as fk

    f = torch.zeros((2, 8), dtype=torch.int32, device=dev)
    tone = fk.tone_table(10000, 1.0, 0.0, dev)
    before = (fk.FSK_TX_KERNEL.launches, fk.MSK_TX_KERNEL.launches)
    for den, sps in ((fk.TONE_CAP + 1, 8), (10000, 4)):
        with pytest.raises(RuntimeError, match="CUDA error"):
            fk._fsk_tx_launch(f, f, den, sps, 1.0, 0.0, tone=tone)
    with pytest.raises(RuntimeError, match="CUDA error"):
        fk._msk_tx_launch(f, f, fk.MSK_CAP + 1, 1.0, core=True)
    out = torch.empty(2 * 64 + 1, device=dev)
    lib = cuda.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
    off = out.data_ptr() + 4  # one float past a boundary
    assert lib.modem_fsk_tx(f.data_ptr(), f.data_ptr(), 2, 8, 8, 10000, 1.0,
                            0.0, f32(2 * math.pi / 10000), tone.data_ptr(),
                            off, off, stream) != 0
    assert lib.modem_msk_tx(f.data_ptr(), f.data_ptr(), 2, 8, 4, 1.0,
                            f32(2 * math.pi / 16), 1, off, off, stream) != 0
    assert (fk.FSK_TX_KERNEL.launches, fk.MSK_TX_KERNEL.launches) == before


def test_chain_tx_and_loopback_make_one_tone_table(dev):
    """``FskChain.tx_fused`` then ``roundtrip_fused`` launch one tone
    table in all; K8 and K6 read the same one."""
    from modem_tpu_torch import FskChain, make_scheme
    from modem_tpu_torch.ops import fsk_kernel as fk

    r = Rates(1250, 10000)
    chain = FskChain(make_scheme("mfsk", r), r, 2 * np.arange(16),
                     2 * np.pi * 50 / 10000, device=dev)
    bits = torch.randint(0, 2, (8, 4 * 512), device=dev, dtype=torch.int32)
    fk.tone_table.cache_clear()
    before = fk.FSK_TONE_KERNEL.launches
    wave = chain.tx_fused(bits)
    assert torch.equal(chain.roundtrip_fused(bits), bits)
    assert torch.equal(chain.rx_fused(*chain.tx_fused(bits)), bits)
    torch.cuda.synchronize()
    assert fk.FSK_TONE_KERNEL.launches == before + 1
    assert torch.equal(chain.rx_fused(*wave), bits)


def test_fsk_msk_tx_routes_by_the_profiler(dev):
    """``tx_fused`` runs the TX core up to the caps, the first versions
    past them: 16-MFSK at den 10000 and 20000, MSK at spb 4 and 100."""
    from modem_tpu_torch import FskChain, MskChain, make_scheme

    for rates, core in ((Rates(1250, 10000), True),
                        (Rates(2500, 20000), False)):
        chain = FskChain(make_scheme("mfsk", rates), rates, 2 * np.arange(16),
                         2 * np.pi * 50 / rates.sample_rate, device=dev)
        bits = torch.randint(0, 2, (8, 4 * 256), device=dev,
                             dtype=torch.int32)
        ran = _kernel_names(chain.tx_fused, bits, family="fsk_tx_")
        want, other = (("fsk_tx_core", "fsk_tx_kernel") if core else
                       ("fsk_tx_kernel", "fsk_tx_core"))
        assert any(want in k for k in ran) and not any(other in k for k in ran)
    for rates, core in ((Rates(1250, 10000), True), (Rates(50, 10000), False)):
        msk = MskChain(rates, device=dev)
        bits = torch.randint(0, 2, (8, 512), device=dev, dtype=torch.int32)
        ran = _kernel_names(msk.tx_fused, bits, family="msk_tx_")
        want, other = (("msk_tx_core", "msk_tx_kernel") if core else
                       ("msk_tx_kernel", "msk_tx_core"))
        assert any(want in k for k in ran) and not any(other in k for k in ran)


ARITHMETIC_CHECK = r"""
// The core's arithmetic against the first versions', bit for bit: this file
// includes csrc/fsk.cu and calls its functions.
#include <cstdio>
#include "fsk.cu"

__device__ unsigned long long bad[5];

__device__ __forceinline__ unsigned mix(unsigned x) {
  return modem::hash_u32(x * 0x9E3779B9u + 0x7F4A7C15u);
}

__device__ __forceinline__ float any_float(unsigned h, int lo_exp,
                                           int hi_exp) {
  const int e = lo_exp + static_cast<int>(h % (hi_exp - lo_exp + 1));
  const float v = ldexpf(1.f + (mix(h) >> 9) * 0x1p-23f, e);
  return (mix(h + 1) & 1) ? -v : v;
}

// sincosf against sinf and cosf at every angle 2*pi*u2 the noise draws,
// and the noise itself against common.cuh's gauss_pair
__global__ void noise(unsigned salt) {
  const unsigned b = blockIdx.x * blockDim.x + threadIdx.x;  // 2^24
  volatile float vu = (static_cast<float>(b) + 0.5f) * 5.9604644775390625e-8f;
  const float ang = 6.283185307179586f * vu;
  float s, c;
  sincosf(ang, &s, &c);
  volatile float va = ang;
  if (__float_as_uint(s) != __float_as_uint(sinf(va)) ||
      __float_as_uint(c) != __float_as_uint(cosf(va)))
    atomicAdd(&bad[0], 1ull);
  float g1, g2, h1, h2;
  gauss_pair_sincos(mix(b), mix(b ^ salt), g1, g2);
  modem::gauss_pair(mix(b), mix(b ^ salt), h1, h2);
  if (__float_as_uint(g1) != __float_as_uint(h1) ||
      __float_as_uint(g2) != __float_as_uint(h2))
    atomicAdd(&bad[1], 1ull);
}

// quotient_fast against IEEE division wherever quotient_in_range admits
// the operands: every mantissa of lo at exponent offsets 0..100 below d
__global__ void quotients(unsigned salt, int offset) {
  const unsigned m = blockIdx.x * blockDim.x + threadIdx.x;  // 2^23
  const float d = fabsf(any_float(mix(blockIdx.y * 7919u + salt), -100, 99));
  float lo = ldexpf(1.f + m * 0x1p-23f, ilogbf(d) - offset);
  lo = fminf(lo, d);
  if (!quotient_in_range(lo, d)) return;
  volatile float vd = d;
  if (__float_as_uint(quotient_fast(lo, d)) != __float_as_uint(lo / vd))
    atomicAdd(&bad[2], 1ull);
}

// increment_fma and increment_sum against increment and its running sum,
// on samples of every size, zeros among them (the slow path)
__global__ void increments(unsigned salt) {
  const unsigned t = blockIdx.x * blockDim.x + threadIdx.x;
  float ci[8], cq[8];
  for (int j = 0; j < 8; ++j) {
    const unsigned h = mix(t * 16u + j + salt);
    const int range = h % 4;  // the samples' sizes: one of four ranges
    const int lo = range == 0 ? -149 : -40 * range, hi = range == 3 ? 60 : 2;
    ci[j] = mix(h) % 61 == 0 ? 0.f : any_float(mix(h + 2), lo, hi);
    cq[j] = mix(h) % 59 == 0 ? 0.f : any_float(mix(h + 3), lo, hi);
  }
  float acc = 0.f;
  for (int j = 1; j < 8; ++j) {
    const float a = increment(ci[j], cq[j], ci[j - 1], cq[j - 1]);
    const float b = increment_fma(ci[j], cq[j], ci[j - 1], cq[j - 1]);
    if (__float_as_uint(a) != __float_as_uint(b)) atomicAdd(&bad[3], 1ull);
    acc += a;
  }
  if (__float_as_uint(acc) != __float_as_uint(increment_sum(ci, cq)))
    atomicAdd(&bad[4], 1ull);
}

int main() {
  noise<<<1 << 16, 256>>>(12345u);
  for (int offset = 0; offset <= 100; offset += 5)
    quotients<<<dim3(1 << 15, 32), 256>>>(offset * 31u + 7u, offset);
  for (unsigned salt = 0; salt < 4; ++salt)
    increments<<<1 << 14, 256>>>(salt << 28);
  const cudaError_t err = cudaDeviceSynchronize();
  unsigned long long b[5] = {};
  cudaMemcpyFromSymbol(b, bad, sizeof(b));
  printf("%s %llu %llu %llu %llu %llu\n", cudaGetErrorString(err), b[0], b[1],
         b[2], b[3], b[4]);
  return err != cudaSuccess || b[0] || b[1] || b[2] || b[3] || b[4];
}
"""


def test_fsk_core_arithmetic_is_the_first_versions(dev, tmp_path):
    """What makes the core's decisions the first versions': sincosf is
    cosf and sinf at all 2^24 angles the noise draws, so gauss_pair_sincos
    is gauss_pair; quotient_fast is IEEE division in its range (every
    mantissa of the dividend, 21 exponent offsets, 32 divisors each);
    increment_fma is increment, and increment_sum their running sum, on
    samples of every size (built with the library's nvcc flags)."""
    import subprocess

    from modem_tpu_torch import cuda

    src = tmp_path / "check.cu"
    src.write_text(ARITHMETIC_CHECK)
    exe = tmp_path / "check"
    flags = [f for f in cuda.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC")]
    subprocess.run([cuda._nvcc(), *flags, "-I", str(cuda.CSRC), "-o",
                    str(exe), str(src)], check=True, capture_output=True,
                   timeout=600)
    out = subprocess.run([str(exe)], capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0 and out.stdout.split() == [
        "no", "error", "0", "0", "0", "0", "0"], out.stdout + out.stderr


def _kernel_names(fn, *args, family="_chain_"):
    """Names of the ``family`` kernels in a profile of 5 calls, work queued
    before it finished first (so no earlier launch is recorded). A profile
    now and then loses its records, so one that holds none of the family is
    taken again, three profiles in all; the first that holds any is the
    one returned, and judged once."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                fn(*args)
            torch.cuda.synchronize()
        names = {e.key.replace(" ", "") for e in prof.key_averages()
                 if family in e.key}
        if names:
            break
    return names


def test_fsk_msk_routes_by_the_profiler(dev):
    """The core's kernels run up to the caps, the first versions past
    them."""
    from modem_tpu_torch import FskChain, MskChain, make_scheme

    for rates, core in ((Rates(1250, 10000), True),
                        (Rates(2500, 20000), False)):
        chain = FskChain(make_scheme("mfsk", rates), rates, 2 * np.arange(16),
                         2 * np.pi * 50 / rates.sample_rate, device=dev)
        bits = torch.randint(0, 2, (8, 4 * 256), device=dev,
                             dtype=torch.int32)
        ran = _kernel_names(chain.roundtrip_fused, bits)
        want, other = (("fsk_chain_core", "fsk_chain_kernel") if core else
                       ("fsk_chain_kernel", "fsk_chain_core"))
        assert any(want in k for k in ran) and not any(other in k for k in ran)
    for rates, core in ((Rates(1250, 10000), True), (Rates(50, 10000), False)):
        msk = MskChain(rates, device=dev)
        bits = torch.randint(0, 2, (8, 512), device=dev, dtype=torch.int32)
        ran = _kernel_names(msk.roundtrip_fused, bits)
        want, other = (("msk_chain_core", "msk_chain_kernel") if core else
                       ("msk_chain_kernel", "msk_chain_core"))
        assert any(want in k for k in ran) and not any(other in k for k in ran)


# ---- K11 and K12 (resampled.cu) ----

# (up, down, bits per symbol, symbol shape): P = 1 (3/2, 5/4, 2/1, 1/2) and
# P = 3 (2/3); 64-QAM; tile edges. The routes (csrc/resampled.cu's C
# entries): 3/2 and 2/3 the core's compiled instantiations, 5/4, 2/1 and
# 1/2 the long route; rows of 1, 257 and 500 symbols, three rows so that two
# start off a 16-byte boundary (the channel rows are odd at 500 and 257
# symbols); tables past the parameter below
RESAMPLED = [(3, 2, 4, (3, 500)), (2, 3, 4, (2, 3, 300)), (5, 4, 6, (2, 257)),
             (2, 1, 4, (2, 700)), (1, 2, 4, (2, 1000)), (3, 2, 4, (2, 1)),
             (3, 2, 4, (3, 257)), (3, 2, 6, (3, 500)), (2, 3, 4, (3, 1)),
             (2, 3, 4, (3, 257)), (2, 3, 6, (3, 500)), (5, 4, 4, (3, 500)),
             (1, 2, 4, (3, 257))]
RESAMPLED_IDS = [f"{u}_{d}_qam{1 << b}_{'x'.join(map(str, s))}"
                 for u, d, b, s in RESAMPLED]


def _resampled(case, dev):
    from modem_tpu_torch import ResampledChain
    from modem_tpu_torch.models.qam import QAM

    up, down, bps, shape = case
    chain = ResampledChain(QAM(bps, 0.0, 1.0), Rates(1250, 10000), up, down,
                           device=dev)
    rng = np.random.default_rng(up * 10 + down)
    syms = torch.as_tensor(rng.integers(0, 1 << bps, shape).astype(np.int32),
                           device=dev)
    return chain, syms


@pytest.mark.parametrize("case", RESAMPLED, ids=RESAMPLED_IDS)
def test_resampled_tx_kernel(case, dev):
    from modem_tpu_torch.ops import resampled_kernel as rk

    chain, syms = _resampled(case, dev)
    if syms.shape[-1] > 20:
        syms[..., 0, :16] = -1  # the streaming sentinel
    h = chain._host
    n_modem = chain._padded_len(syms.shape[-1])
    got = _launches(rk.RESAMPLED_TX_KERNEL, rk.fused_resampled_tx, syms,
                    chain.lut, h["rrc"], chain.sps, chain.span, chain.up,
                    chain.down, h["taps1"], n_modem)
    params = rk._tx_params(h["rrc"].tobytes(), h["taps1"].tobytes(), chain.up,
                           chain.down, dev)
    want = rk.resampled_tx_plain(syms, chain.lut, *params, chain.sps, chain.up,
                                 chain.down, n_modem)
    for g, w in zip(got, want):
        assert g.shape == syms.shape[:-1] + (n_modem * chain.up // chain.down,)
        torch.testing.assert_close(g, w, atol=ATOL, rtol=0)


@pytest.mark.parametrize("case", RESAMPLED, ids=RESAMPLED_IDS)
@pytest.mark.parametrize("soft", [False, True])
def test_resampled_rx_kernel(case, soft, dev):
    from modem_tpu_torch.ops import resampled_kernel as rk

    chain, syms = _resampled(case, dev)
    k = syms.shape[-1]
    wi, wq = chain.tx_fused(_unpack(syms, chain))
    g = torch.Generator(device=dev).manual_seed(0)
    wi = wi + 0.02 * torch.randn(wi.shape, generator=g, device=dev)
    wq = wq + 0.02 * torch.randn(wq.shape, generator=g, device=dev)
    h = chain._host
    got = _launches(rk.RESAMPLED_RX_KERNEL, rk.fused_resampled_rx, (wi, wq), k,
                    chain.lut, h["rrc"], chain.sps, chain.span, chain.up,
                    chain.down, h["taps2"], chain.delay, soft=soft)
    params = rk._rx_params(h["rrc"].tobytes(), h["taps2"].tobytes(), chain.sps,
                           chain.up, chain.down, chain.delay, dev)
    want = rk.resampled_rx_plain(wi, wq, k, chain.lut, *params, soft)
    if soft:
        for g_, w in zip(got, want):
            torch.testing.assert_close(g_, w, atol=ATOL, rtol=0)
    else:
        assert torch.equal(got, want)


# (up, down, RRC span, symbol shape): tables past the parameter's 256 floats
# (257 RRC taps), the first version's kernels
RESAMPLED_LONG = [(3, 2, 32, (3, 500)), (3, 2, 32, (2, 1)),
                  (2, 3, 32, (3, 257))]


@pytest.mark.parametrize("case", [c + (8,) for c in RESAMPLED]
                         + [(u, d, 4, s, sp) for u, d, sp, s in RESAMPLED_LONG],
                         ids=RESAMPLED_IDS + [f"long_{u}_{d}_{s[-1]}"
                                              for u, d, _, s in RESAMPLED_LONG])
def test_resampled_kernel_routes(case, dev):
    """Each case runs the kernel its route names, as the profiler sees it:
    config #4's tables at 3/2 and 2/3 the core's compiled instantiations,
    every other shape the long route (the first version); every launch
    counted once."""
    from torch.profiler import ProfilerActivity, profile

    from modem_tpu_torch import ResampledChain
    from modem_tpu_torch.models.qam import QAM
    from modem_tpu_torch.ops import resampled_kernel as rk

    up, down, bps, shape, span = case
    chain = ResampledChain(QAM(bps, 0.0, 1.0), Rates(1250, 10000), up, down,
                           span_symbols=span, device=dev)
    want = {(3, 2, 8): ("resampled_tx_core<8,65,3,2,17>",
                        "resampled_rx_core<false,1,12,112>"),
            (2, 3, 8): ("resampled_tx_core<8,65,2,3,17>",
                        "resampled_rx_core<false,3,16,71>")}.get(
        (up, down, span), ("resampled_tx_kernel", "resampled_rx_kernel<false>"))
    bits = _unpack(torch.randint(0, 1 << bps, shape, device=dev,
                                 dtype=torch.int32), chain)
    before = (rk.RESAMPLED_TX_KERNEL.launches, rk.RESAMPLED_RX_KERNEL.launches)
    assert torch.equal(chain.roundtrip_fused(bits), bits)
    after = (rk.RESAMPLED_TX_KERNEL.launches, rk.RESAMPLED_RX_KERNEL.launches)
    assert (after[0] - before[0], after[1] - before[1]) == (1, 1)
    for _ in range(3):  # again only where a profile lost every record
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            chain.roundtrip_fused(bits)
            torch.cuda.synchronize(dev)
        ran = [e.key.replace(" ", "") for e in prof.key_averages()
               if "resampled_" in e.key]
        if ran:
            break
    for name in want:
        assert [k for k in ran if name in k], (name, ran)
    assert len(ran) == 2, ran


@pytest.mark.parametrize("case", RESAMPLED_LONG,
                         ids=[f"{u}_{d}_span{sp}_{s[-1]}"
                              for u, d, sp, s in RESAMPLED_LONG])
@pytest.mark.parametrize("soft", [False, True])
def test_resampled_long_route(case, soft, dev):
    """K11 and K12 on the long route against their plain versions: waveforms
    and soft points within ATOL, decisions equal; sentinels in front."""
    from modem_tpu_torch import ResampledChain
    from modem_tpu_torch.models.qam import QAM
    from modem_tpu_torch.ops import resampled_kernel as rk

    up, down, span, shape = case
    chain = ResampledChain(QAM(4, 0.0, 1.0), Rates(1250, 10000), up, down,
                           span_symbols=span, device=dev)
    rng = np.random.default_rng(span + shape[-1])
    syms = torch.as_tensor(rng.integers(0, 16, shape).astype(np.int32),
                           device=dev)
    if shape[-1] > 20:
        syms[0, :16] = -1
    h = chain._host
    n_modem = chain._padded_len(shape[-1])
    params = rk._tx_params(h["rrc"].tobytes(), h["taps1"].tobytes(), up,
                           down, dev)
    got = _launches(rk.RESAMPLED_TX_KERNEL, rk.fused_resampled_tx, syms,
                    chain.lut, h["rrc"], chain.sps, chain.span, up, down,
                    h["taps1"], n_modem)
    want = rk.resampled_tx_plain(syms, chain.lut, *params, chain.sps, up,
                                 down, n_modem)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=ATOL, rtol=0)
    g = torch.Generator(device=dev).manual_seed(1)
    wi = want[0] + 0.02 * torch.randn(want[0].shape, generator=g, device=dev)
    wq = want[1] + 0.02 * torch.randn(want[1].shape, generator=g, device=dev)
    k = shape[-1]
    got = _launches(rk.RESAMPLED_RX_KERNEL, rk.fused_resampled_rx, (wi, wq), k,
                    chain.lut, h["rrc"], chain.sps, chain.span, up, down,
                    h["taps2"], chain.delay, soft=soft)
    rparams = rk._rx_params(h["rrc"].tobytes(), h["taps2"].tobytes(),
                            chain.sps, up, down, chain.delay, dev)
    want = rk.resampled_rx_plain(wi, wq, k, chain.lut, *rparams, soft)
    if soft:
        for g_, w in zip(got, want):
            torch.testing.assert_close(g_, w, atol=ATOL, rtol=0)
    else:
        assert torch.equal(got, want)


def _unpack(syms, chain):
    from modem_tpu_torch.utils.bits import unpack_symbols

    return unpack_symbols(syms, chain.bits_per_symbol)


@pytest.mark.parametrize("up,down", [(3, 2), (2, 3)])
def test_resampled_chain_on_card(up, down, dev):
    from modem_tpu_torch import ResampledChain, StreamingResampledChain
    from modem_tpu_torch.models.qam import QAM
    from modem_tpu_torch.ops import resampled_kernel as rk

    chain = ResampledChain(QAM(4, 0.0, 1.0), Rates(1250, 10000), up, down,
                           device=dev)
    bits = torch.randint(0, 2, (16, 4 * 1024), device=dev, dtype=torch.int32)
    before = (rk.RESAMPLED_TX_KERNEL.launches, rk.RESAMPLED_RX_KERNEL.launches)
    assert torch.equal(chain.roundtrip_fused(bits), bits)
    wave = chain.tx_fused(bits)
    for f, s in zip(wave, chain.tx(bits)):
        torch.testing.assert_close(f, s, atol=ATOL, rtol=0)
    assert torch.equal(chain.rx_fused(wave, 1024), bits)
    assert torch.equal(chain.rx_fused(wave, 1024), chain.rx(wave, 1024))
    assert torch.equal((chain.rx_soft_fused(wave, 1024) < 0).int(), bits)
    after = (rk.RESAMPLED_TX_KERNEL.launches, rk.RESAMPLED_RX_KERNEL.launches)
    assert (after[0] - before[0], after[1] - before[1]) == (2, 4)
    st = StreamingResampledChain(chain, (2,))
    parts = [st.push(bits[:2, a * 4:b * 4])
             for a, b in ((0, 100), (100, 101), (101, 700), (700, 1024))]
    assert torch.equal(torch.cat(parts + [st.flush()], -1), bits[:2])


def test_resampled_empty_inputs_launch_nothing(dev):
    from modem_tpu_torch.ops import resampled_kernel as rk

    chain, _ = _resampled(RESAMPLED[0], dev)
    h = chain._host
    before = (rk.RESAMPLED_TX_KERNEL.launches, rk.RESAMPLED_RX_KERNEL.launches)
    e = torch.zeros((0, 10), dtype=torch.int32, device=dev)
    n_modem = chain._padded_len(10)
    wi, _ = rk.fused_resampled_tx(e, chain.lut, h["rrc"], 8, 8, 3, 2,
                                  h["taps1"], n_modem)
    assert wi.shape == (0, n_modem * 3 // 2)
    w = torch.zeros((0, n_modem * 3 // 2), device=dev)
    for soft in (False, True):
        out = rk.fused_resampled_rx((w, w), 10, chain.lut, h["rrc"], 8, 8, 3,
                                    2, h["taps2"], chain.delay, soft=soft)
        assert (out[0] if soft else out).shape == (0, 10)
    assert before == (rk.RESAMPLED_TX_KERNEL.launches,
                      rk.RESAMPLED_RX_KERNEL.launches)


def test_resampled_kernels_refuse_bad_arguments(dev):
    """The C entry point refuses a period the kernel does not take before
    any launch."""
    from modem_tpu_torch.ops import resampled_kernel as rk

    chain, _ = _resampled(RESAMPLED[0], dev)
    before = rk.RESAMPLED_RX_KERNEL.launches
    w = torch.zeros((2, 500), device=dev)
    table = torch.zeros((300, 4), device=dev)
    with pytest.raises(RuntimeError, match="CUDA error"):
        rk.resampled_rx_kernel(w, w, 10, chain.lut, table, 300, 4, 0, False)
    assert rk.RESAMPLED_RX_KERNEL.launches == before


# ---- K13 (viterbi.cu) and the coded link ----

# (K, polynomials): K=7 rate 1/2 (CCSDS) and 1/3, K=5, and the state-count
# edges S = 8 (K=4), 32 (K=6), 256 (K=9)
CODES = [(7, (0o171, 0o133)), (7, (0o171, 0o133, 0o165)), (5, (0o23, 0o35)),
         (4, (0o15, 0o17)), (6, (0o53, 0o75)), (9, (0o561, 0o753))]
CODE_IDS = [f"k{k}_r1_{len(p)}" for k, p in CODES]


def _code_llrs(k, polys, shape, t, sigma, seed, dev):
    from modem_tpu_torch.fec import ConvCode

    code = ConvCode(k, polys)
    g = torch.Generator(device=dev).manual_seed(seed)
    bits = torch.randint(0, 2, shape + (t,), generator=g, device=dev,
                         dtype=torch.int32)
    cw = code.encode(bits).to(torch.float32)
    llr = (1.0 - 2.0 * cw) * 2.0 + sigma * torch.randn(
        cw.shape, generator=g, device=dev)
    return code, bits, llr


@pytest.mark.parametrize("case", CODES, ids=CODE_IDS)
def test_viterbi_windows_kernel(case, dev):
    """Free-start windows, pinned and free rows mixed, noisy: decisions bit
    for bit the plain version's."""
    from modem_tpu_torch.ops import viterbi_kernel as vk

    code, _, llr = _code_llrs(*case, (6,), 300, 2.0, 13, dev)
    win = llr.reshape(6, -1, code.n)[:, :251]
    pin = torch.tensor([0.0, 1.0, 0.0, 1.0, 1.0, 0.0], device=dev)
    got = _launches(vk.VITERBI_KERNEL, vk.viterbi_decode_windows, code,
                    win.reshape(2, 3, 251, code.n), pin.reshape(2, 3))
    want = vk.windows_plain(code, win, pin)
    assert got.dtype == torch.int32 and got.shape == (2, 3, 251)
    assert torch.equal(got.reshape(6, 251), want)


@pytest.mark.parametrize("case", CODES[:3], ids=CODE_IDS[:3])
def test_viterbi_stream_kernel(case, dev):
    """decode_soft_windowed on a 2-D batch: the kernel's windows, built from
    the compact stream, equal the plain version's gathered ones."""
    from modem_tpu_torch.ops import viterbi_kernel as vk

    code, bits, llr = _code_llrs(*case, (2, 3), 700, 1.5, 14, dev)
    got = _launches(vk.VITERBI_KERNEL, code.decode_soft_windowed, llr, 128)
    lam = llr.reshape(llr.shape[:-1] + (-1, code.n))
    want = vk.stream_plain(code, lam, 128, 10 * code.k, 1e6)
    assert got.shape == bits.shape and torch.equal(got, want)


@pytest.mark.parametrize("block", [256, 512, 1024])
def test_viterbi_stream_kernel_bench_fec_width(block, dev):
    """bench_fec.py's width: 256 channels x 4096 data bits, halo 70."""
    from modem_tpu_torch.ops import viterbi_kernel as vk

    code, bits, llr = _code_llrs(7, (0o171, 0o133), (256,), 4096, 1.2, 15,
                                 dev)
    lam = llr.reshape(256, -1, 2)
    got = vk.stream_kernel(code, lam, block, 70, 1e6)
    assert torch.equal(got, vk.stream_plain(code, lam, block, 70, 1e6))
    assert float((got != bits).double().mean()) < 1e-3


def test_viterbi_kernel_refuses_what_it_does_not_take(dev):
    """The C entry points refuse, before any launch, what their callers
    route elsewhere: the warp route a state count over 256, a warp over the
    card's shared memory per block and more rows a warp than its state
    count packs, the block route a block that is no whole number of
    warps."""
    from modem_tpu_torch.ops import viterbi_kernel as vk

    before = (vk.VITERBI_KERNEL.launches, vk.VITERBI_BLOCK_KERNEL.launches)
    lam = torch.zeros((1, 64, 2), device=dev)
    out = torch.zeros((1, 64), dtype=torch.int32, device=dev)
    masks = torch.zeros((2, 512), dtype=torch.int32, device=dev)
    for s, layout in ((512, vk.row_layout(512, 2, 64)),
                      (64, (1, 128, 128, 1 << 20)),
                      (64, (2, 128, 256, 384))):
        with pytest.raises(RuntimeError, match="CUDA error"):
            vk.VITERBI_KERNEL.launch(dev, lam.data_ptr(), None,
                                     masks.data_ptr(), 1, 64, 2, s,
                                     s.bit_length() - 2, 1, 64, *layout, 0,
                                     0, 1, 0.0, 0, 64, 64, out.data_ptr())
    with pytest.raises(RuntimeError, match="CUDA error"):
        vk.VITERBI_BLOCK_KERNEL.launch(
            dev, lam.data_ptr(), None, masks.data_ptr(), 1, 64, 2, 64, 5, 64,
            48, 1, 1, 4096, 0, 1, None, None, 0, 0, 1, 0.0, 0, 64, 64,
            out.data_ptr())
    assert (vk.VITERBI_KERNEL.launches,
            vk.VITERBI_BLOCK_KERNEL.launches) == before


#: (K, polynomials) of each state count that the warp route packs several
#: rows a warp for (S = 2 .. 32: 64 / S rows), and S = 64 (one)
PACKED = [(2, (0o3, 0o1)), (3, (0o7, 0o5)), (4, (0o15, 0o17)),
          (5, (0o23, 0o35)), (6, (0o53, 0o75)), (7, (0o171, 0o133))]


def _hazard_llrs(kind, code, shape, t, seed, dev):
    """LLRs ``[*shape, n * t]`` of a kind that stresses the recursion:
    ``noisy`` (a codeword at sigma 1), ``zero`` (+0 and -0 only: every
    compare ties), ``ties`` (-1, +1 and signed zeros: many tie) and
    ``large`` (the noisy ones times 1e4)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    if kind in ("noisy", "large"):
        _, _, llr = _code_llrs(code.k, code.polys, shape, t - code.k + 1,
                               1.0, seed, dev)
        return llr * (1e4 if kind == "large" else 1.0)
    n = code.n * t
    sign = torch.where(torch.rand(shape + (n,), generator=g, device=dev)
                       < 0.5, 1.0, -1.0)
    zero = 0.0 * sign  # +0 or -0
    if kind == "zero":
        return zero
    v = torch.randint(-1, 2, shape + (n,), generator=g,
                      device=dev).to(torch.float32)
    return torch.where(v == 0, zero, v)


@pytest.mark.parametrize("kind", ["noisy", "zero", "ties", "large"])
@pytest.mark.parametrize("case", PACKED, ids=[f"k{k}" for k, _ in PACKED])
def test_viterbi_kernel_packed_rows(case, kind, dev):
    """The warp route's packed rows: a row count that leaves the last warp
    partly empty, free and pinned ends mixed, windows whose length is no
    multiple of 8 (the renormalisation cadence runs from the window's
    end), on noisy, all-zero and signed-zero, tie-heavy and 1e4-large
    LLRs: ready windows and the stream form bit for bit the plain
    version's."""
    from modem_tpu_torch.fec import ConvCode
    from modem_tpu_torch.ops import viterbi_kernel as vk

    code = ConvCode(*case)
    rpw = vk.rows_per_warp_max(code.n_states)
    rows = 3 * rpw + rpw // 2 + 1
    for t_w in (61, 100, 203):
        llr = _hazard_llrs(kind, code, (rows,), t_w, 30 + t_w, dev)
        win = llr.reshape(rows, t_w, code.n)
        pin = (torch.arange(rows, device=dev) % 3 == 1).float()
        assert vk.warp_route(code, t_w)
        got = _launches(vk.VITERBI_KERNEL, vk.viterbi_decode_windows, code,
                        win, pin)
        assert torch.equal(got, vk.windows_plain(code, win, pin)), t_w
    llr = _hazard_llrs(kind, code, (rows,), 300, 29, dev)
    got = _launches(vk.VITERBI_KERNEL, code.decode_soft_windowed, llr, 37)
    lam = llr.reshape(rows, -1, code.n)
    assert torch.equal(got, vk.stream_plain(code, lam, 37, 10 * code.k, 1e6))


#: (K, polynomials, channels, data bits, block steps): every code shape of
#: F1's repair: S = 2 and 4 in the warp route with idle lanes; K = 10
#: (S = 512) to 15 (S = 16384) in the block core, at 2, 3, 4, 6 and 8 code
#: bits, codes whose transitions mirror and codes whose do not (a
#: generator that skips the newest or the oldest register bit); a tiny
#: K = 16 (metrics in the global scratch) and 9 code bits at K = 10 in the
#: long route; rate 1/40 (more code bits than a mask word)
WIDE_CODES = [
    ("k2", 2, (0o3, 0o1), (4,), 300, 64),
    ("k3", 3, (0o7, 0o5), (4,), 300, 64),
    ("k10", 10, (0o1731, 0o1373), (3,), 200, 64),
    ("k11", 11, (0o2335, 0o3661), (3,), 150, 64),
    ("k12_r1_3", 12, (0o4335, 0o5723, 0o6746), (2,), 150, 64),
    ("k13", 13, (0o13535, 0o07463), (2,), 120, 48),
    ("k14", 14, (0o32345, 0o26613), (2,), 120, 48),
    ("k15", 15, (0o74653, 0o61535), (2,), 120, 48),
    ("k15_r1_4", 15, (0o46321, 0o51271, 0o63667, 0o70535), (2,), 120, 48),
    ("k15_r1_6", 15, (0o74653, 0o61535, 0o52447, 0o43555, 0o71263,
                      0o66421), (1,), 120, 48),
    ("k10_r1_8", 10, (0o1731, 0o1373, 0o1555, 0o1267, 0o1143, 0o1721,
                      0o1035, 0o1466), (2,), 100, 32),
    ("k10_r1_9", 10, (0o1731, 0o1373, 0o1555, 0o1267, 0o1143, 0o1721,
                      0o1035, 0o1467, 0o1111), (1,), 60, 32),
    ("k16_tiny", 16, (0o172675, 0o137323), (1,), 24, 16),
    ("k5_r1_40", 5, tuple(0o20 | (j % 15 + 1) for j in range(40)), (2,),
     100, 32),
]


def _route_kernel(vk, code, t_w):
    """The launch count of the route a row of ``t_w`` steps takes."""
    return {"warp": vk.VITERBI_KERNEL, "core": vk.VITERBI_CORE_KERNEL,
            "long": vk.VITERBI_BLOCK_KERNEL}[vk.route(code, t_w)]


@pytest.mark.parametrize("case", WIDE_CODES, ids=[c[0] for c in WIDE_CODES])
def test_viterbi_kernel_widened_shapes(case, dev):
    """decode_soft_windowed of every code shape on the card, bit for bit
    the plain version's, with the route the shape calls for (its launch
    counted); and ready windows with pinned and free ends."""
    from modem_tpu_torch.ops import viterbi_kernel as vk

    _, k, polys, shape, t, b = case
    code, bits, llr = _code_llrs(k, polys, shape, t, 1.0, 21, dev)
    lam = llr.reshape(llr.shape[:-1] + (-1, code.n))
    h = 10 * code.k
    way = vk.route(code, b + 2 * h)
    assert way == ("warp" if k <= 9 and code.n <= 32 else
                   "core" if k <= 15 and code.n <= 8 else "long")
    kernel = _route_kernel(vk, code, b + 2 * h)
    got = _launches(kernel, code.decode_soft_windowed, llr, b)
    assert torch.equal(got, vk.stream_plain(code, lam, b, h, 1e6))
    assert float((got != bits).double().mean()) < 0.05
    win = lam[..., :b + 2 * h, :]
    pin = (torch.arange(win.shape[0], device=dev) % 2).float()
    assert torch.equal(_launches(kernel, vk.windows_kernel, code, win, pin),
                       vk.windows_plain(code, win, pin))


#: the block core's hazards: (K, polynomials) at both ends of its state
#: range
CORE_HAZARD = [(10, (0o1731, 0o1373)), (15, (0o74653, 0o61535))]


@pytest.mark.parametrize("kind", ["zero", "ties", "large"])
@pytest.mark.parametrize("case", CORE_HAZARD,
                         ids=[f"k{k}" for k, _ in CORE_HAZARD])
def test_viterbi_core_hazards(case, kind, dev):
    """The block core on all-zero and signed-zero LLRs (every compare
    ties), -1/0/+1 ties and 1e4-large LLRs: windows of 1, 7, 203 and 1000
    steps (a step, no whole cost chunk or decision group, and rows of many
    32-step traceback pages), free and pinned ends mixed, and the stream
    form: bit for bit the plain version's, one core launch each (the large
    LLRs are a noisy codeword's, so their windows start at 16 steps)."""
    from modem_tpu_torch.fec import ConvCode
    from modem_tpu_torch.ops import viterbi_kernel as vk

    code = ConvCode(*case)
    for t_w in ((16, 203, 1000) if kind == "large" else (1, 7, 203, 1000)):
        llr = _hazard_llrs(kind, code, (3,), t_w, 40 + t_w, dev)
        win = llr.reshape(3, t_w, code.n)
        pin = torch.tensor([0.0, 1.0, 1.0], device=dev)
        assert vk.route(code, t_w) == "core"
        got = _launches(vk.VITERBI_CORE_KERNEL, vk.viterbi_decode_windows,
                        code, win, pin)
        assert torch.equal(got, vk.windows_plain(code, win, pin)), t_w
    llr = _hazard_llrs(kind, code, (2,), 300, 39, dev)
    got = _launches(vk.VITERBI_CORE_KERNEL, code.decode_soft_windowed, llr,
                    37)
    lam = llr.reshape(2, -1, code.n)
    assert torch.equal(got, vk.stream_plain(code, lam, 37, 10 * code.k, 1e6))


def test_viterbi_core_equals_long_route(dev):
    """K = 15 at 4 channels x 300 bits, windows of 64: the core and the
    long route forced on the same shape (``long_route=True``) decide bit
    for bit alike, each counted on its own kernel."""
    from modem_tpu_torch.ops import viterbi_kernel as vk

    code, _, llr = _code_llrs(15, (0o74653, 0o61535), (4,), 300, 1.0, 23,
                              dev)
    lam = llr.reshape(4, -1, 2)
    core = _launches(vk.VITERBI_CORE_KERNEL, vk.stream_kernel, code, lam, 64,
                     150, 1e6)
    long = _launches(vk.VITERBI_BLOCK_KERNEL, vk.stream_kernel, code, lam, 64,
                     150, 1e6, long_route=True)
    assert torch.equal(core, long)


def test_viterbi_window_longer_than_shared_memory(dev):
    """A K = 9 window of 8000 steps: its decisions (32 B a step) leave the
    block's shared memory for the global scratch, the traceback reads them
    there; bit for bit the plain version's."""
    from modem_tpu_torch.ops import viterbi_kernel as vk

    code, _, llr = _code_llrs(9, (0o561, 0o753), (2,), 8000 - 8, 1.0, 22, dev)
    win = llr.reshape(2, -1, 2)
    assert win.shape[1] == 8000 and not vk.warp_route(code, 8000)
    assert vk.block_plan(code.n_states, 2, 8000)[2] == 0
    pin = torch.tensor([0.0, 1.0], device=dev)
    got = _launches(vk.VITERBI_BLOCK_KERNEL, vk.viterbi_decode_windows, code,
                    win, pin)
    assert torch.equal(got, vk.windows_plain(code, win, pin))


def test_viterbi_empty_batch_launches_nothing(dev):
    from modem_tpu_torch.fec import ccsds_code
    from modem_tpu_torch.ops import viterbi_kernel as vk

    before = vk.VITERBI_KERNEL.launches
    got = ccsds_code().decode_soft_windowed(torch.zeros((0, 400), device=dev),
                                            64)
    assert got.shape == (0, 194)
    assert vk.VITERBI_KERNEL.launches == before


def test_streaming_viterbi_on_card(dev):
    """Pushes equal one shot, and each window decode is one launch."""
    from modem_tpu_torch.fec import StreamingViterbi
    from modem_tpu_torch.ops import viterbi_kernel as vk

    code, bits, llr = _code_llrs(7, (0o171, 0o133), (4,), 1024 - 6, 1.5, 16,
                                 dev)
    one = code.decode_soft_windowed(llr, 128)
    sv = StreamingViterbi(code, 128)
    before = vk.VITERBI_KERNEL.launches
    outs = [sv.push(llr[:, a:a + 256]) for a in range(0, llr.shape[-1], 256)]
    outs = [o for o in outs if o is not None] + [sv.flush()]
    assert vk.VITERBI_KERNEL.launches == before + 8
    assert torch.equal(torch.cat(outs, -1), one)


def test_crc_scrambler_rs_on_card(dev):
    """The framing stack's float32 products and GF tables on CUDA tensors
    equal the CPU's, RS errors up to t corrected."""
    from modem_tpu_torch.fec import crc16_ccitt, dvb_scrambler, rs_255_223

    g = torch.Generator(device="cpu").manual_seed(17)
    bits = torch.randint(0, 2, (8, 1002), generator=g, dtype=torch.int32)
    crc, scr, rs = crc16_ccitt(), dvb_scrambler(), rs_255_223()
    assert torch.equal(crc.append(bits.to(dev)).cpu(), crc.append(bits))
    framed = crc.append(bits.to(dev))
    flip = framed.clone()
    flip[::2, 100] ^= 1
    assert crc.check(flip).cpu().tolist() == [False, True] * 4
    st = scr.init_state((8,), dev)
    ks, nxt = scr.keystream(st, 1018)
    ks_c, nxt_c = scr.keystream(scr.init_state((8,), "cpu"), 1018)
    assert torch.equal(ks.cpu(), ks_c) and torch.equal(nxt.cpu(), nxt_c)
    msg = torch.randint(0, 256, (8, 223), generator=g, dtype=torch.int32)
    cw = rs.encode(msg.to(dev))
    assert torch.equal(cw.cpu(), rs.encode(msg))
    bad = cw.clone()
    for r in range(8):  # r*4 symbol errors: up to 16 = t corrected, 20, 24, 28 not
        bad[r, torch.randperm(255, generator=g)[:r * 4].to(dev)] ^= 0x5A
    got, ok = rs.decode(bad)
    want, ok_c = rs.decode(bad.cpu())
    assert torch.equal(got.cpu(), want) and torch.equal(ok.cpu(), ok_c)
    assert ok.cpu().tolist()[:5] == [True] * 5
    assert torch.equal(got[:5], msg[:5].to(dev))


@pytest.mark.parametrize("preset,snr", [("reference_link", 2.0),
                                        ("dvb_like_link", 3.0),
                                        ("ccsds_deep_space_link", 0.0)])
def test_link_on_card(preset, snr, dev):
    """tx_fused -> seeded noise -> rx_fused on the card: payloads back with
    every CRC true, through K2, K3 soft and K13; the decode of the card's
    LLRs equal to the CPU's."""
    from modem_tpu_torch import presets
    from modem_tpu_torch.ops import viterbi_kernel as vk

    link = getattr(presets, preset)(device=dev)
    g = torch.Generator(device=dev).manual_seed(18)
    pay = torch.randint(0, 2, (8, link.payload_bits), generator=g, device=dev,
                        dtype=torch.int32)
    before = (txrx.TX_KERNEL.launches, txrx.RX_SOFT_KERNEL.launches,
              vk.VITERBI_KERNEL.launches)
    i, q = link.tx_fused(pay)
    for f, s in zip((i, q), link.tx(pay)):
        torch.testing.assert_close(f, s, atol=ATOL, rtol=0)
    p = float(torch.mean(i * i + q * q))
    nv = p / (2.0 * 10.0 ** (snr / 10.0))
    i = i + math.sqrt(nv) * torch.randn(i.shape, generator=g, device=dev)
    q = q + math.sqrt(nv) * torch.randn(q.shape, generator=g, device=dev)
    out, ok = link.rx_fused((i, q), nv)
    after = (txrx.TX_KERNEL.launches, txrx.RX_SOFT_KERNEL.launches,
             vk.VITERBI_KERNEL.launches)
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1]
    assert torch.equal(out, pay) and bool(ok.all())
    llr = link.chain.rx_soft_fused((i, q), link.n_symbols, noise_var=nv)
    cpu_out, cpu_ok = _cpu_link(preset).decode(llr.cpu())
    assert torch.equal(cpu_out, out.cpu()) and torch.equal(cpu_ok, ok.cpu())


def _cpu_link(preset):
    from modem_tpu_torch import presets

    return getattr(presets, preset)(device="cpu")


def test_link_cli_on_card(dev):
    """The ``link`` CLI pair on the card: payloads and verdicts back, and a
    zeroed burst in one frame exits 1."""
    import io

    from modem_tpu_torch.cli import link as cli

    rng = np.random.default_rng(19)
    bits = rng.integers(0, 2, 3 * 1002)
    wave = io.BytesIO()
    assert cli.run(cli.build_parser().parse_args(
        ["tx", "--preset", "reference", "--batch-frames", "2", "--device",
         str(dev)]), "".join("01"[b] for b in bits).encode(), wave) == 0
    raw = np.frombuffer(wave.getvalue(), "<f4").copy()
    args = cli.build_parser().parse_args(
        ["rx", "--preset", "reference", "--noise-var", "0.05",
         "--batch-frames", "2", "--device", str(dev)])
    dec, err = io.BytesIO(), io.StringIO()
    assert cli.run(args, raw.tobytes(), dec, stderr=err) == 0
    got = np.array([int(c) for c in "".join(dec.getvalue().decode().split())])
    assert np.array_equal(got, bits) and err.getvalue().count("OK") == 3
    raw[len(raw) // 9: 2 * len(raw) // 9] = 0.0  # a burst erasure in frame 0
    dec, err = io.BytesIO(), io.StringIO()
    assert cli.run(args, raw.tobytes(), dec, stderr=err) == 1
    assert "BAD" in err.getvalue()


# ---- K14: the max-log BCJR half-iteration ----

def _turbo_case(k, cws, sigma, seed):
    """A turbo code, its info bits and noisy channel LLRs (numpy) on the
    CPU; ``sigma`` 0: LLRs of +-2 with no noise."""
    from modem_tpu_torch.fec import TurboCode

    code = TurboCode(k)
    rng = np.random.default_rng(seed)
    bits = torch.as_tensor(rng.integers(0, 2, (cws, k)), dtype=torch.int32)
    y = 1.0 - 2.0 * code.encode(bits).numpy()
    llr = 2.0 * y + (rng.normal(0, sigma, y.shape) if sigma else 0.0)
    return code, bits, torch.as_tensor(llr, dtype=torch.float32)


# (K, codewords, window (None: pick_geometry), a-priori sigma)
BCJR_CASES = [(40, 64, None, 0.0), (40, 64, 16, 1.5), (1024, 32, None, 1.5),
              (1024, 32, 256, 0.0)]


@pytest.mark.parametrize("case", BCJR_CASES,
                         ids=[f"k{c[0]}_w{c[2]}" for c in BCJR_CASES])
def test_bcjr_kernel(case, dev):
    """K14 against its plain version on the rows of one half-iteration, at
    ``pick_geometry`` and at an explicit window widened by ``pick_guard``
    (windows pinned at both stream ends), with and without a-priori LLRs:
    extrinsics bit for bit."""
    from modem_tpu_torch.ops import bcjr_kernel as bk

    k, cws, window, ap = case
    code, _, llr = _turbo_case(k, cws, 1.0, 40 + k)
    ls, lp = llr[:, :k], llr[:, k:2 * k]
    ts, tp = llr[:, 3 * k:3 * k + 3], llr[:, 3 * k + 3:3 * k + 6]
    la = torch.as_tensor(np.random.default_rng(41).normal(0, ap, ls.shape)
                         if ap else np.zeros(ls.shape), dtype=torch.float32)
    if window is None:
        w, g = bk.pick_geometry(k + 3, 32)
    else:
        w, g = window, bk.pick_guard(window, 32)
    rows, _ = bk.make_rows(ls, lp, la, ts, tp, w, g)
    got = _launches(bk.BCJR_KERNEL, bk.rows_kernel, rows.to(dev), g, w)
    assert torch.equal(got.cpu(), bk.rows_plain(rows, g, w))
    card = bk.bcjr_windowed(*(t.to(dev) for t in (ls, lp, la, ts, tp)),
                            window, 32 if window is None else g)
    want = (code._bcjr(ls, lp, la, ts, tp) if window is None else
            bk.bcjr_windowed(ls, lp, la, ts, tp, w, g))
    assert torch.equal(card.cpu(), want)


def test_bcjr_kernel_pinned_rows(dev):
    """Rows with random pin masks (fully pinned rows too), a ragged row
    count and a kept range inside the row: bit for bit."""
    from modem_tpu_torch.ops import bcjr_kernel as bk

    rng = np.random.default_rng(42)
    r, tw = 13, 77
    x = rng.normal(0, 3, (3, r, tw)).astype(np.float32)
    x[2] = rng.random((r, tw)) < 0.2
    x[2, 5] = 1.0
    rows = torch.as_tensor(x)
    got = _launches(bk.BCJR_KERNEL, bk.rows_kernel, rows.to(dev), 9, 50)
    assert torch.equal(got.cpu(), bk.rows_plain(rows, 9, 50))


@pytest.mark.parametrize("k,early", [(40, False), (40, True), (1024, False),
                                     (1024, True)])
def test_turbo_decode_on_card(k, early, dev):
    """``TurboCode.decode`` on the card: 2 K14 launches an iteration,
    decisions equal to the CPU route (the full-block BCJR; with a window,
    the windowed one at ``pick_guard``'s guard)."""
    from modem_tpu_torch.ops import bcjr_kernel as bk

    code, bits, llr = _turbo_case(k, 48, 1.1, 43 + k)
    before = bk.BCJR_KERNEL.launches
    got = code.decode(llr.to(dev), iters=4, early_exit=early)
    torch.cuda.synchronize()
    n = bk.BCJR_KERNEL.launches - before
    assert n % 2 == 0 and 2 <= n <= 8 and (early or n == 8)
    assert torch.equal(got.cpu(), code.decode(llr, iters=4,
                                              early_exit=early))
    w = 16 if k == 40 else 256
    got = code.decode(llr.to(dev), iters=4, window=w, early_exit=early)
    want = code.decode(llr, iters=4, window=w, guard=bk.pick_guard(w, 32),
                       early_exit=early)
    assert torch.equal(got.cpu(), want)
    with pytest.raises(ValueError, match="odd window"):
        code.decode(llr.to(dev), window=15)


def _hazard_rows(r, tw, pins, seed):
    """Rows ``[3, r, tw]`` of N(0, 3) LLRs; ``pins`` ``"random"`` (20% of
    the steps) or ``"per_row"``: row 0 pinned throughout, row 1 nowhere,
    row i > 1 every (i+1)-th step from its own offset, or a pinned head or
    tail, so rows of one warp pin different steps."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 3, (3, r, tw)).astype(np.float32)
    if pins == "random":
        x[2] = rng.random((r, tw)) < 0.2
        return torch.as_tensor(x)
    t = np.arange(tw)
    x[2] = 0.0
    for i in range(r):
        if i == 0:
            x[2, i] = 1.0
        elif i % 4 == 2:
            x[2, i] = t < i
        elif i % 4 == 3:
            x[2, i] = t >= tw - i
        elif i > 1:
            x[2, i] = (t + i) % (i + 1) == 0
    return torch.as_tensor(x)


def _turbo_w256_rows(half):
    """One half-iteration's rows of ``TurboCode(1024)`` at window 256 over
    512 codewords: 2560 rows of 324 steps (``pick_guard``: guard 34), the
    second half with the first's extrinsics as a-priori; ``(rows, guard,
    window)``."""
    from modem_tpu_torch.ops import bcjr_kernel as bk

    k, window = 1024, 256
    code, _, llr = _turbo_case(k, 512, 1.2, 45)
    ls, lp1, lp2 = llr[:, :k], llr[:, k:2 * k], llr[:, 2 * k:3 * k]
    tail = [llr[:, 3 * k + 3 * i:3 * k + 3 * i + 3] for i in range(4)]
    g = bk.pick_guard(window, 32)
    zero = torch.zeros_like(ls)
    if half == 1:
        rows, _ = bk.make_rows(ls, lp1, zero, tail[0], tail[1], window, g)
    else:
        le1 = bk.bcjr_windowed(ls, lp1, zero, tail[0], tail[1], window, g)
        rows, _ = bk.make_rows(code._il(ls), lp2, code._il(le1), tail[2],
                               tail[3], window, g)
    return rows, g, window


# (id, rows, tw, keep_lo, keep_n, pins): the kernel meets its two sweeps at
# mid = tw // 2 and takes 16 rows a warp; "turbo1"/"turbo2" are the two
# half-iterations of _turbo_w256_rows, 160 blocks of rows, more than one to
# each of the card's SMs
BCJR_HAZARDS = [
    ("tw1", 5, 1, 0, 1, "random"),
    ("tw2", 5, 2, 1, 1, "random"),
    ("tw7_odd", 17, 7, 1, 5, "random"),
    ("tw77_unaligned", 33, 77, 0, 77, "random"),
    ("tw1093_odd_long", 20, 1093, 32, 1029, "random"),
    ("keep_below_mid", 16, 100, 3, 40, "random"),
    ("keep_above_mid", 16, 100, 60, 35, "random"),
    ("keep_crossing_mid", 16, 101, 20, 60, "random"),
    ("keep_at_mid", 16, 96, 48, 1, "random"),
    ("ragged_rows_37", 37, 64, 8, 48, "random"),
    ("pins_differ_in_warp", 32, 96, 0, 96, "per_row"),
    ("pins_differ_unaligned", 19, 45, 5, 30, "per_row"),
    ("turbo_w256_2560_rows_half1", 2560, 324, 34, 256, "turbo1"),
    ("turbo_w256_2560_rows_half2", 2560, 324, 34, 256, "turbo2"),
]


@pytest.mark.parametrize("case", BCJR_HAZARDS,
                         ids=[c[0] for c in BCJR_HAZARDS])
def test_bcjr_kernel_hazards(case, dev):
    """K14's two sweeps meeting mid-row: odd, tiny and unaligned rows, kept
    ranges below, above and across the meeting point, a row count no
    multiple of a warp's rows, rows of one warp with different pins, and
    more blocks than SMs: extrinsics bit for bit against the plain
    version, one launch each."""
    from modem_tpu_torch.ops import bcjr_kernel as bk

    name, r, tw, lo, n, pins = case
    if pins.startswith("turbo"):
        rows, lo, n = _turbo_w256_rows(int(pins[-1]))
    else:
        rows = _hazard_rows(r, tw, pins, 44 + len(name))
    assert rows.shape == (3, r, tw) and (lo, n) == case[3:5]
    got = _launches(bk.BCJR_KERNEL, bk.rows_kernel, rows.to(dev), lo, n)
    assert torch.equal(got.cpu(), bk.rows_plain(rows, lo, n))


# ---- K15 and K16: polar SC and CA-SCL-8 ----

def _polar_llrs(n, b, seed, ties=False):
    """Channel LLRs ``[b, n]``: +-(0, 1, 2) with exact ties and zeros, or
    +-2 on random bits plus Gaussian noise."""
    rng = np.random.default_rng(seed)
    if ties:
        sign = 1.0 - 2.0 * rng.integers(0, 2, (b, n))
        return torch.as_tensor(sign * rng.integers(0, 3, (b, n)),
                               dtype=torch.float32)
    y = 1.0 - 2.0 * rng.integers(0, 2, (b, n))  # any word: the SC tree
    return torch.as_tensor(2.0 * y + rng.normal(0, 1.2, (b, n)),
                           dtype=torch.float32)


def _polar_codes():
    from modem_tpu_torch.fec import PolarCode, RateMatchedPolar

    return [("n2", PolarCode(2, 1)), ("n4", PolarCode(4, 2)),
            ("n16", PolarCode(16, 8)), ("n64", PolarCode(64, 32)),
            ("n128_k100", PolarCode(128, 100)), ("n256", PolarCode(256, 128)),
            ("rm_shorten", RateMatchedPolar(100, 180, n=256).code),
            ("rm_puncture", RateMatchedPolar(60, 200, n=256).code),
            ("n1024", PolarCode(1024, 512))]


POLAR_IDS = [c[0] for c in _polar_codes()]


@pytest.mark.parametrize("idx", range(len(POLAR_IDS)), ids=POLAR_IDS)
@pytest.mark.parametrize("ties", [False, True], ids=["noisy", "ties"])
def test_sc_kernel(idx, ties, dev):
    """K15 against its plain version (``PolarCode._sc``): u and x bit for
    bit, for several frozen patterns from n = 2 to 1024."""
    from modem_tpu_torch.ops import sc_kernel as sk

    code = _polar_codes()[idx][1]
    lam = _polar_llrs(code.n, 37, 50 + idx, ties)
    u, x = _launches(sk.SC_KERNEL, sk.sc_kernel, code, lam.to(dev))
    pu, px = sk.sc_plain(code, lam)
    assert torch.equal(u.cpu(), pu) and torch.equal(x.cpu(), px)
    assert torch.equal(code.decode(lam.to(dev)).cpu(), code.decode(lam))
    assert torch.equal(code.decode_full(lam.to(dev)).cpu(),
                       code.decode_full(lam))


@pytest.mark.parametrize("idx", range(len(POLAR_IDS)), ids=POLAR_IDS)
@pytest.mark.parametrize("ties", [False, True], ids=["noisy", "ties"])
def test_scl_kernel(idx, ties, dev):
    """K16 against its plain version (``PolarCode._scl``, list 8): the 8
    paths' decisions and metrics bit for bit, equal-metric candidates in
    ``lax.top_k``'s order; ``decode_list`` with and without a CRC equal to
    the CPU's."""
    from modem_tpu_torch.fec import crc16_ccitt
    from modem_tpu_torch.ops import scl_kernel as lk

    code = _polar_codes()[idx][1]
    lam = _polar_llrs(code.n, 29, 60 + idx, ties)
    u, pm = _launches(lk.SCL_KERNEL, lk.scl_kernel, code, lam.to(dev))
    pu, ppm = lk.scl_plain(code, lam)
    assert torch.equal(u.cpu(), pu) and torch.equal(pm.cpu(), ppm)
    crcs = [None] + ([crc16_ccitt()] if code.k > 16 else [])
    for crc in crcs:
        got = _launches(lk.SCL_KERNEL, code.decode_list, lam.to(dev), 8,
                        crc=crc)
        assert torch.equal(got.cpu(), code.decode_list(lam, 8, crc=crc))


#: K16's hazards since its redesign: (id, n, k, codewords, LLR kind).
#: "weak": LLRs of |llr| < 0.3, so that most info leaves keep both
#: children of many paths (many clones a leaf, node buffers shared across
#: slots for long); k = n: no frozen leaf at all; n = 8 and 32: the
#: register-only tree and one word of x; 2500 codewords: more than one
#: wave of the card; ties at n = 1024: equal metrics everywhere, 32 words
#: of x a path
SCL_HAZARDS = [
    ("many_clones_n256_k200", 256, 200, 64, "weak"),
    ("all_info_n64", 64, 64, 64, "weak"),
    ("n32_k16", 32, 16, 64, "noisy"),
    ("n8_k8", 8, 8, 64, "weak"),
    ("wave_2500_n256", 256, 128, 2500, "noisy"),
    ("ties_n1024", 1024, 512, 48, "ties"),
    ("weak_n1024", 1024, 700, 48, "weak"),
]


@pytest.mark.parametrize("case", SCL_HAZARDS, ids=[c[0] for c in SCL_HAZARDS])
def test_scl_kernel_hazards(case, dev):
    """K16 against its plain version on the shapes its path sharing and
    bit-packed partial sums must survive: decisions and metrics bit for
    bit."""
    from modem_tpu_torch.fec import PolarCode
    from modem_tpu_torch.ops import scl_kernel as lk

    _, n, k, b, kind = case
    code = PolarCode(n, k)
    if kind == "weak":
        rng = np.random.default_rng(n + k)
        lam = torch.as_tensor(rng.uniform(-0.3, 0.3, (b, n)),
                              dtype=torch.float32)
    else:
        lam = _polar_llrs(n, b, 70 + n, kind == "ties")
    u, pm = _launches(lk.SCL_KERNEL, lk.scl_kernel, code, lam.to(dev))
    pu, ppm = lk.scl_plain(code, lam.to(dev))
    assert torch.equal(u, pu) and torch.equal(pm, ppm)


#: K15's hazards since its redesign (eight codewords a warp, all-frozen
#: subtrees skipped): (id, code, codewords, LLR kind). k = n: nothing
#: skipped; k = 1: all but one leaf's path skipped; "weak": |llr| < 0.3;
#: n = 8 and 32: the register-only tree and one word of x; 2500 codewords:
#: not a multiple of eight, more than one wave; ties at n = 1024: exact
#: zeros and equal magnitudes, 32 words of x; the link's shortened code;
#: "offset": LLRs whose storage starts one float past a 16-byte boundary
SC_HAZARDS = [
    ("all_info_n256", (256, 256), 64, "noisy"),
    ("k1_n1024", (1024, 1), 64, "noisy"),
    ("k1_n256", (256, 1), 64, "ties"),
    ("weak_n256", (256, 128), 64, "weak"),
    ("n8_k4", (8, 4), 64, "noisy"),
    ("n32_k16", (32, 16), 64, "ties"),
    ("wave_2500_n256", (256, 128), 2500, "noisy"),
    ("ties_n1024", (1024, 512), 48, "ties"),
    ("link_shortened", (100, 180), 1024, "noisy"),
    ("offset_n64", (64, 32), 37, "offset"),
]


@pytest.mark.parametrize("case", SC_HAZARDS, ids=[c[0] for c in SC_HAZARDS])
def test_sc_kernel_hazards(case, dev):
    """K15 against its plain version on the shapes its skipped subtrees,
    shared warps and bit-packed partial sums must survive: one launch, u
    and x bit for bit."""
    from modem_tpu_torch.fec import PolarCode, RateMatchedPolar
    from modem_tpu_torch.ops import sc_kernel as sk

    name, (a, b), cws, kind = case
    code = (RateMatchedPolar(a, b, n=256).code if name == "link_shortened"
            else PolarCode(a, b))
    n = code.n
    if kind == "weak":
        rng = np.random.default_rng(n + code.k)
        lam = torch.as_tensor(rng.uniform(-0.3, 0.3, (cws, n)),
                              dtype=torch.float32)
    else:
        lam = _polar_llrs(n, cws, 80 + n, kind == "ties")
    lam = lam.to(dev)
    if kind == "offset":
        flat = torch.empty(cws * n + 4, device=dev)
        lam = flat[1:1 + cws * n].view(cws, n).copy_(lam)
        assert lam.data_ptr() % 16 == 4
    u, x = _launches(sk.SC_KERNEL, sk.sc_kernel, code, lam)
    pu, px = sk.sc_plain(code, lam)
    assert torch.equal(u, pu) and torch.equal(x, px)


def test_polar_kernels_refuse_what_they_do_not_take(dev):
    from modem_tpu_torch.fec import PolarCode
    from modem_tpu_torch.ops import sc_kernel as sk, scl_kernel as lk

    code = PolarCode(64, 32)
    before = (sk.SC_KERNEL.launches, lk.SCL_KERNEL.launches)
    with pytest.raises(ValueError):
        sk.sc_kernel(code, torch.zeros((3, 32), device=dev))
    with pytest.raises(ValueError):
        lk.scl_kernel(code, torch.zeros((3, 64), device=dev,
                                        dtype=torch.float64))
    big = PolarCode(2048, 1024)
    lam = _polar_llrs(2048, 3, 70)
    assert torch.equal(big.decode(lam.to(dev)).cpu(), big.decode(lam))
    assert torch.equal(code.decode_list(_polar_llrs(64, 5, 71).to(dev),
                                        4).cpu(),
                       code.decode_list(_polar_llrs(64, 5, 71), 4))
    assert (sk.SC_KERNEL.launches, lk.SCL_KERNEL.launches) == before


@pytest.mark.parametrize("preset,snr,kernel", [
    ("lte_like_turbo_link", 1.0, "bcjr"), ("nr_like_control_link", 3.0,
                                           "scl")])
def test_turbo_polar_link_on_card(preset, snr, kernel, dev):
    """tx_fused -> seeded noise -> rx_fused on the card for the turbo and
    polar presets: payloads back with every CRC true through K2, K3 soft
    and K14 (or K16); the decode of the card's LLRs equal to the CPU's."""
    from modem_tpu_torch import presets
    from modem_tpu_torch.ops import bcjr_kernel as bk, scl_kernel as lk

    inner = bk.BCJR_KERNEL if kernel == "bcjr" else lk.SCL_KERNEL
    link = getattr(presets, preset)(device=dev)
    g = torch.Generator(device=dev).manual_seed(44)
    pay = torch.randint(0, 2, (8, link.payload_bits), generator=g, device=dev,
                        dtype=torch.int32)
    before = (txrx.TX_KERNEL.launches, txrx.RX_SOFT_KERNEL.launches,
              inner.launches)
    i, q = link.tx_fused(pay)
    p = float(torch.mean(i * i + q * q))
    nv = p / (2.0 * 10.0 ** (snr / 10.0))
    i = i + math.sqrt(nv) * torch.randn(i.shape, generator=g, device=dev)
    q = q + math.sqrt(nv) * torch.randn(q.shape, generator=g, device=dev)
    out, ok = link.rx_fused((i, q), nv)
    torch.cuda.synchronize()
    after = (txrx.TX_KERNEL.launches, txrx.RX_SOFT_KERNEL.launches,
             inner.launches)
    assert [a - b for a, b in zip(after, before)][:2] == [1, 1]
    assert after[2] > before[2]
    assert torch.equal(out, pay) and bool(ok.all())
    llr = link.chain.rx_soft_fused((i, q), link.n_symbols, noise_var=nv)
    cpu_out, cpu_ok = _cpu_link(preset).decode(llr.cpu())
    assert torch.equal(cpu_out, out.cpu()) and torch.equal(cpu_ok, ok.cpu())


@pytest.mark.parametrize("preset,bits", [("lte_like_turbo", 1008),
                                         ("nr_like_control", 384)])
def test_turbo_polar_link_cli_on_card(preset, bits, dev):
    """The ``link`` CLI pair on the card for the turbo and polar presets."""
    import io

    from modem_tpu_torch.cli import link as cli

    data = np.random.default_rng(45).integers(0, 2, 3 * bits)
    wave = io.BytesIO()
    assert cli.run(cli.build_parser().parse_args(
        ["tx", "--preset", preset, "--batch-frames", "2", "--device",
         str(dev)]), "".join("01"[b] for b in data).encode(), wave) == 0
    dec, err = io.BytesIO(), io.StringIO()
    assert cli.run(cli.build_parser().parse_args(
        ["rx", "--preset", preset, "--noise-var", "0.05", "--batch-frames",
         "2", "--device", str(dev)]), wave.getvalue(), dec, stderr=err) == 0
    got = np.array([int(c) for c in "".join(dec.getvalue().decode().split())])
    assert np.array_equal(got, data) and err.getvalue().count("OK") == 3


# ---- the LDPC-coded OFDM link ----

def test_fir_kernel_at_the_preamble_shape(dev):
    """K4 at 240 taps (its generic route), the OFDM fine timing's shape:
    the reversed preamble as taps, captures of max_lag + 239 samples."""
    from modem_tpu_torch import OfdmModem, make_scheme
    from modem_tpu_torch.ops import fir

    m = OfdmModem(make_scheme("qpsk", Rates(1250, 10000)), device=dev)
    taps = torch.as_tensor(m._preamble_i[::-1].copy(), device=dev)
    assert taps.shape[0] == 240 and fir.fir_route(240) == "generic"
    for shape in ((256, 128 + 239), (3, 64 + 239), (1, 5001)):
        x = _unit(shape, 11).to(dev)
        st = torch.zeros(shape[:-1] + (239,), device=dev)
        got = _launches(fir.FIR_KERNEL, fir.fir_kernel, x, taps, st)
        torch.testing.assert_close(got, fir.fir_plain(x, taps, st),
                                   atol=ATOL, rtol=0)


@pytest.mark.parametrize("kw", [
    dict(iters=10), dict(iters=10, msg_dtype=torch.bfloat16),
    dict(iters=10, early_exit=True), dict(iters=10, schedule="flooding")],
    ids=["layered", "layered-bf16", "early-exit", "flooding"])
def test_ldpc_decode_on_card_equals_cpu(kw, dev):
    """``QcLdpc`` on CUDA tensors (PyTorch ops) against the CPU twin on the
    same LLRs, with pinned ±inf bits: posteriors and decisions bit for
    bit."""
    from modem_tpu_torch.fec import QcLdpc

    code = QcLdpc()
    g = torch.Generator().manual_seed(46)
    data = torch.randint(0, 2, (256, code.k), generator=g, dtype=torch.int32)
    cw = code.encode(data)
    assert torch.equal(code.encode(data.to(dev)).cpu(), cw)
    sigma2 = 1.0 / (2.0 * 0.5 * 10.0 ** (2.0 / 10.0))
    y = 1.0 - 2.0 * cw + math.sqrt(sigma2) * torch.randn(cw.shape,
                                                          generator=g)
    llr = 2.0 * y / sigma2
    llr[3, :8] = torch.where(cw[3, :8] == 0, math.inf, -math.inf)
    want = code.posteriors(llr, **kw)
    got = code.posteriors(llr.to(dev), **kw)
    assert not torch.isnan(got).any()
    assert torch.equal(got.cpu(), want)
    assert torch.equal(code.decode(llr.to(dev), **kw).cpu(),
                       code.decode(llr, **kw))
    assert torch.equal(code.syndrome_ok(cw.to(dev)).cpu(),
                       code.syndrome_ok(cw))


def test_ofdm_acquire_on_card(dev):
    """Blind ``OfdmModem.acquire`` on the card (K4 four times, the DFTs in
    float32 under PyTorch's default of no TF32) against the CPU twin: the
    located starts and bits equal, the LLRs to 1e-4 of their largest."""
    from modem_tpu_torch import OfdmModem, make_scheme
    from modem_tpu_torch.ops import fir

    assert not torch.backends.cuda.matmul.allow_tf32
    r = Rates(1250, 10000)
    mc = OfdmModem(make_scheme("qpsk", r), device="cpu")
    md = OfdmModem(make_scheme("qpsk", r), device=dev)
    g = torch.Generator().manual_seed(47)
    bits = torch.randint(0, 2, (64, mc.bits_per_frame(8)), generator=g,
                         dtype=torch.int32)
    wi, wq = mc.tx_frame(bits)
    assert all(torch.allclose(a.cpu(), b, atol=ATOL, rtol=0)
               for a, b in zip(md.tx_frame(bits.to(dev)), (wi, wq)))
    off = torch.randint(0, 128, (64,), generator=g)
    n = wi.shape[-1] + 128
    ci = torch.zeros((64, n))
    cq = torch.zeros((64, n))
    rot = torch.polar(torch.ones(wi.shape[-1]),
                      0.01 * torch.arange(wi.shape[-1]) + 0.5)
    z = torch.complex(wi, wq) * rot
    for c in range(64):
        ci[c, off[c]:off[c] + z.shape[-1]] = z[c].real
        cq[c, off[c]:off[c] + z.shape[-1]] = z[c].imag
    ci = ci + 0.03 * torch.randn(ci.shape, generator=g)
    cq = cq + 0.03 * torch.randn(cq.shape, generator=g)
    before = fir.FIR_KERNEL.launches
    got, rep = md.acquire(ci.to(dev), cq.to(dev), 8, 128)
    torch.cuda.synchronize()
    assert fir.FIR_KERNEL.launches == before + 4
    want, wrep = mc.acquire(ci, cq, 8, 128)
    assert torch.equal(rep["start"].cpu(), off.to(torch.int32))
    assert torch.equal(rep["start"].cpu(), wrep["start"])
    assert torch.equal(got.cpu(), want) and torch.equal(want, bits)
    llr, _ = md.acquire_soft(ci.to(dev), cq.to(dev), 8, 128, noise_var=0.1)
    wllr, _ = mc.acquire_soft(ci, cq, 8, 128, noise_var=0.1)
    assert (llr.cpu() - wllr).abs().max() <= 1e-4 * wllr.abs().max()


def test_wifi_link_and_burst_receiver_on_card(dev):
    """``wifi_like_ofdm_link`` on the card at 8 dB: payloads back with every
    CRC true through ``rx`` and ``rx_fused``, the decode equal to the CPU
    twin's on the same LLRs; ``burst_ofdm_receiver`` on the card finds a
    frame in a stream (K4 launched) and it decodes."""
    from modem_tpu_torch import presets
    from modem_tpu_torch.ops import fir

    link = presets.wifi_like_ofdm_link(device=dev)
    g = torch.Generator(device=dev).manual_seed(48)
    pay = torch.randint(0, 2, (16, link.payload_bits), generator=g,
                        device=dev, dtype=torch.int32)
    i, q = link.tx_fused(pay)
    p = float(torch.mean(i * i + q * q))
    nv = p / (2.0 * 10.0 ** 0.8)
    i = i + math.sqrt(nv) * torch.randn(i.shape, generator=g, device=dev)
    q = q + math.sqrt(nv) * torch.randn(q.shape, generator=g, device=dev)
    for fn in (link.rx, link.rx_fused):
        out, ok = fn((i, q), nv)
        assert torch.equal(out, pay) and bool(ok.all())
    llr = link.chain.rx_soft((i, q), link.n_symbols, noise_var=nv)
    cpu = presets.wifi_like_ofdm_link(device="cpu")
    cout, cok = cpu.decode(llr.cpu())
    assert torch.equal(cout, out.cpu()) and torch.equal(cok, ok.cpu())
    rx = presets.burst_ofdm_receiver(device=dev)
    gap = torch.zeros(500, device=dev)
    before = fir.FIR_KERNEL.launches
    frames = rx.push(torch.cat([gap, i[0], gap]), torch.cat([gap, q[0], gap]))
    frames += rx.flush()
    assert fir.FIR_KERNEL.launches >= before + 4
    assert len(frames) == 1 and frames[0][1]["start"] == 500


def test_sc_metric_is_zero_over_silence_on_card(dev):
    """The S&C metric on the card over a capture of loud samples, then
    quiet noise, then zeros (a flushed stream's padding): every window of
    zeros scores exactly 0, so no false plateau follows a burst."""
    from modem_tpu_torch.ops.sync_metric import periodic_similarity

    g = torch.Generator(device=dev).manual_seed(49)
    i, q = (torch.cat([30.0 * torch.randn(4000, generator=g, device=dev),
                       0.01 * torch.randn(600, generator=g, device=dev),
                       torch.zeros(5000, device=dev)]) for _ in range(2))
    m, _, _ = periodic_similarity(i, q, 16, 64, 9000)
    assert torch.equal(m[4600:], torch.zeros_like(m[4600:]))
    assert float(m.max()) <= 1.0 + 1e-5


@pytest.mark.parametrize("k", [4, 13, 63])
@pytest.mark.parametrize("shape", [(64, 4800), (3, 1), (3, 5), (3, 5001)],
                         ids=str)
def test_fir_kernel_at_the_acquisition_tap_counts(k, shape, dev):
    """K4's generic route at the blind burst acquisition's tap counts (the
    multipath channels' 4 and 13, ``apply_static_delay``'s 63), each
    ending in a partial chunk of 16 taps, with carried state; and ragged
    pushes equal to one shot."""
    from modem_tpu_torch.ops import fir

    assert fir.fir_route(k) == "generic"
    taps = _unit((k,), k).to(dev)
    x = _unit(shape, 3 * k + shape[-1]).to(dev)
    st = _unit(shape[:-1] + (k - 1,), 5 * k).to(dev)
    got = _launches(fir.FIR_KERNEL, fir.fir_kernel, x, taps, st)
    torch.testing.assert_close(got, fir.fir_plain(x, taps, st), atol=ATOL,
                               rtol=0)
    if shape[-1] > k:
        one, _ = fir.fir_filter(x, taps)
        state, parts = None, []
        for a, b in ((0, 1), (1, k - 1), (k - 1, k + 7),
                     (k + 7, shape[-1])):
            y, state = fir.fir_filter(x[:, a:b], taps, state)
            parts.append(y)
        assert torch.equal(torch.cat(parts, -1), one)


def _acq_capture(seed, channels=8, n_payload=256):
    """A burst of ``qpsk_reference_chain`` through the full impairment stack
    on the CPU: a static delay of 0.37, a CFO of 9 Hz with phase 1.3, a
    gain of 0.8 and AWGN at 30 dB."""
    from modem_tpu_torch import AcquiringReceiver
    from modem_tpu_torch.ops import impairments as imp
    from modem_tpu_torch.ops.channel import awgn

    pre = np.array([0, 1, 3, 2, 2, 0, 1, 1, 3, 0, 2, 3, 0, 0, 1, 2,
                    3, 3, 1, 0, 2, 1, 0, 2, 1, 3, 2, 2, 0, 3, 1, 0])
    cpu = AcquiringReceiver(qpsk_reference_chain(Rates(1250, 10000),
                                                 device="cpu"), pre, 160)
    g = torch.Generator().manual_seed(seed)
    bits = torch.randint(0, 2, (channels, 2 * n_payload), generator=g,
                         dtype=torch.int32)
    i, q = cpu.tx_burst(bits)
    i, q = imp.apply_static_delay(i, q, 0.37)
    i, q = imp.apply_cfo(i, q, 9.0, 10000, phase0=1.3)
    i, q = imp.apply_gain_phase(i, q, gain=0.8)
    i, q = awgn(g, i, q, 30.0)
    return pre, bits, i, q


@pytest.mark.parametrize("kw", [{}, {"eq_taps": 7, "track_block": 16},
                                {"track_block": 16, "track_order": 2}],
                         ids=["plain", "equalized", "second-order"])
def test_acquire_on_card_equals_cpu(kw, dev):
    """``AcquiringReceiver`` on the card (K4 at 65 taps twice) against the
    CPU twin on the same capture: lag equal, timing within 1e-3 samples
    (circular), CFO within 1e-5, phase within 1e-4, gain within 1e-4
    relative, the payload points within 1e-4; every bit right."""
    from modem_tpu_torch import AcquiringReceiver
    from modem_tpu_torch.ops import fir

    pre, bits, i, q = _acq_capture(50)
    rc = AcquiringReceiver(qpsk_reference_chain(Rates(1250, 10000),
                                                device="cpu"), pre, 160, **kw)
    rd = AcquiringReceiver(qpsk_reference_chain(Rates(1250, 10000),
                                                device=dev), pre, 160, **kw)
    before = fir.FIR_KERNEL.launches
    (pi_, pq_), rep = rd.acquire(i.to(dev), q.to(dev), 256)
    torch.cuda.synchronize()
    assert fir.FIR_KERNEL.launches == before + 2
    (wi, wq), want = rc.acquire(i, q, 256)
    assert torch.equal(rep["lag"].cpu(), want["lag"])
    d = (rep["timing"].cpu() - want["timing"]).remainder(8.0)
    assert float(torch.minimum(d, 8.0 - d).max()) < 1e-3
    assert float((rep["cfo_rad_per_symbol"].cpu()
                  - want["cfo_rad_per_symbol"]).abs().max()) < 1e-5
    assert float((rep["phase"].cpu() - want["phase"]).abs().max()) < 1e-4
    assert float(((rep["gain"].cpu() - want["gain"]) / want["gain"]).abs()
                 .max()) < 1e-4
    assert float((pi_.cpu() - wi).abs().max()) < 1e-4
    assert float((pq_.cpu() - wq).abs().max()) < 1e-4
    assert torch.equal(rd.rx(i.to(dev), q.to(dev), 256).cpu(), bits)


@pytest.mark.parametrize("t,nerr", [(8, 4), (8, 9), (2, 2), (2, 3)])
def test_bch_decode_on_card_equals_cpu(t, nerr, dev):
    """``Bch`` on CUDA tensors (PyTorch ops, GF(256) by table) against the
    CPU twin: codewords, messages and ``ok`` flags bit for bit, within and
    beyond t errors."""
    from modem_tpu_torch.fec import Bch

    code = Bch(t=t)
    g = torch.Generator().manual_seed(51 + nerr)
    data = torch.randint(0, 2, (512, code.k), generator=g, dtype=torch.int32)
    cw = code.encode(data)
    assert torch.equal(code.encode(data.to(dev)).cpu(), cw)
    err = torch.zeros_like(cw)
    pos = torch.argsort(torch.rand(cw.shape, generator=g), -1)[:, :nerr]
    err.scatter_(1, pos, 1)
    recv = cw ^ err
    msg, ok = code.decode(recv.to(dev))
    wmsg, wok = code.decode(recv)
    assert torch.equal(msg.cpu(), wmsg) and torch.equal(ok.cpu(), wok)
    if nerr <= t:
        assert bool(wok.all()) and torch.equal(wmsg, data)


# ---- SC-FDE, Alamouti STBC, MIMO and bit loading ----

def test_fir_kernel_at_the_scfde_preamble_shape(dev):
    """K4 at 160 taps (its generic route), SC-FDE's fine timing: the
    reversed CP'd Zadoff–Chu preamble as taps, captures of max_lag + 159
    samples."""
    from modem_tpu_torch import ScFdeModem, make_scheme
    from modem_tpu_torch.ops import fir

    m = ScFdeModem(make_scheme("qpsk", Rates(1250, 10000)), device=dev)
    for tpl in (m._preamble_i, m._preamble_q):
        taps = torch.as_tensor(tpl[::-1].copy(), device=dev)
        assert taps.shape[0] == 160 and fir.fir_route(160) == "generic"
        for shape in ((256, 128 + 159), (3, 64 + 159), (1, 5001)):
            x = _unit(shape, 12).to(dev)
            st = _unit(shape[:-1] + (159,), 13).to(dev)
            got = _launches(fir.FIR_KERNEL, fir.fir_kernel, x, taps, st)
            torch.testing.assert_close(got, fir.fir_plain(x, taps, st),
                                       atol=ATOL, rtol=0)


def _new_phys():
    """Each new entry point built with ``device=None`` (the card), by name."""
    from modem_tpu_torch import (AdaptiveOfdm, AlamoutiOfdm, MimoOfdm,
                                 MimoOfdmN, ScFdeChain, ScFdeModem,
                                 make_scheme, presets)

    q = make_scheme("qpsk", Rates(1250, 10000))
    return {"ScFdeModem": lambda: ScFdeModem(q),
            "ScFdeChain": lambda: ScFdeChain(ScFdeModem(q)).modem,
            "AlamoutiOfdm": lambda: AlamoutiOfdm(q),
            "MimoOfdm": lambda: MimoOfdm(q),
            "MimoOfdmN": lambda: MimoOfdmN(q, nt=3),
            "AdaptiveOfdm": lambda: AdaptiveOfdm((2, 4) * 24),
            "mimo_ofdm_link": lambda: presets.mimo_ofdm_link().chain.mimo}


@pytest.mark.parametrize("name", list(_new_phys()))
def test_new_phys_device_none_builds_on_the_card(name, dev):
    """``device=None`` builds on the card: the tables live there and a frame
    goes out and back on CUDA tensors."""
    phy = _new_phys()[name]()
    assert phy.device.type == "cuda"
    g = torch.Generator(device=dev).manual_seed(52)
    bits = torch.randint(0, 2, (3, phy.bits_per_frame(4)), generator=g,
                         device=dev, dtype=torch.int32)
    if name.startswith("ScFde"):
        got = phy.rx_frame(*phy.tx_frame(bits), 4)
    elif name == "AlamoutiOfdm":
        (ai, aq), (bi, bq) = phy.tx(bits)
        got = phy.rx(ai + 0.5 * bi, aq + 0.5 * bq, 4)
    elif name == "MimoOfdmN":
        ti, tq = phy.tx(bits)
        mix = torch.tensor([[1.0, 0.3, 0.2], [0.2, 1.0, 0.3],
                            [0.3, 0.2, 1.0]], device=dev)
        got = phy.rx_frame(mix @ ti, mix @ tq, 4)
    elif name in ("MimoOfdm", "mimo_ofdm_link"):
        (ai, aq), (bi, bq) = phy.tx(bits)
        got = phy.rx_frame(ai + 0.4 * bi, aq + 0.4 * bq,
                           0.3 * ai + bi, 0.3 * aq + bq, 4)
    else:
        got = phy.rx_frame(*phy.tx_frame(bits), 4)
    assert got.is_cuda and torch.equal(got, bits)


def test_scfde_acquire_on_card_equals_cpu(dev):
    """Blind ``ScFdeModem.acquire`` on the card (K4 four times at 160 taps;
    the DFTs float32 ``torch.matmul`` under PyTorch's default of no TF32)
    against the CPU twin on the same capture: starts and bits equal, the
    LLRs within 1e-4 of their largest."""
    from modem_tpu_torch import ScFdeModem, make_scheme
    from modem_tpu_torch.ops import fir

    assert not torch.backends.cuda.matmul.allow_tf32
    r = Rates(1250, 10000)
    mc = ScFdeModem(make_scheme("qpsk", r), device="cpu")
    md = ScFdeModem(make_scheme("qpsk", r), device=dev)
    g = torch.Generator().manual_seed(53)
    bits = torch.randint(0, 2, (64, mc.bits_per_frame(6)), generator=g,
                         dtype=torch.int32)
    wi, wq = mc.tx_frame(bits)
    assert all(torch.allclose(a.cpu(), b, atol=ATOL, rtol=0)
               for a, b in zip(md.tx_frame(bits.to(dev)), (wi, wq)))
    off = torch.randint(0, 128, (64,), generator=g)
    n = wi.shape[-1] + 128
    ci, cq = torch.zeros((64, n)), torch.zeros((64, n))
    z = torch.complex(wi, wq) * torch.polar(
        torch.ones(wi.shape[-1]), 0.003 * torch.arange(wi.shape[-1]) + 0.5)
    for c in range(64):
        ci[c, off[c]:off[c] + z.shape[-1]] = z[c].real
        cq[c, off[c]:off[c] + z.shape[-1]] = z[c].imag
    ci = ci + 0.03 * torch.randn(ci.shape, generator=g)
    cq = cq + 0.03 * torch.randn(cq.shape, generator=g)
    before = fir.FIR_KERNEL.launches
    got, rep = md.acquire(ci.to(dev), cq.to(dev), 6, 128, noise_var=0.002)
    torch.cuda.synchronize()
    assert fir.FIR_KERNEL.launches == before + 4
    want, wrep = mc.acquire(ci, cq, 6, 128, noise_var=0.002)
    assert torch.equal(rep["start"].cpu(), off.to(torch.int32))
    assert torch.equal(rep["start"].cpu(), wrep["start"])
    assert torch.equal(got.cpu(), want) and torch.equal(want, bits)
    fi, fq, _ = md.locate_frame(ci.to(dev), cq.to(dev), 6, 128)
    llr = md.rx_soft_frame(fi, fq, 6, 0.002)
    wfi, wfq, _ = mc.locate_frame(ci, cq, 6, 128)
    wllr = mc.rx_soft_frame(wfi, wfq, 6, 0.002)
    assert (llr.cpu() - wllr).abs().max() <= 1e-4 * wllr.abs().max()


def test_stbc_mimo_bitloading_on_card_equal_cpu(dev):
    """Alamouti combining, 2x2 and 4x4 MMSE detection and the loaded
    modem's soft demap on the card against the CPU twins on the same
    captures: decision points within 1e-4, LLRs within 1e-4 of their
    largest, hard bits equal."""
    from modem_tpu_torch import (AdaptiveOfdm, AlamoutiOfdm, MimoOfdm,
                                 MimoOfdmN, make_scheme)

    r = Rates(1250, 10000)
    g = torch.Generator().manual_seed(54)

    def both(make):
        return make("cpu"), make(dev)

    def noisy(x):
        return x + 0.01 * torch.randn(x.shape, generator=g)

    def close(a, b, tol=1e-4):
        assert (a.cpu() - b).abs().max() <= tol * max(1.0, b.abs().max())

    sc, sd = both(lambda d: AlamoutiOfdm(make_scheme("qam16", r), device=d))
    bits = torch.randint(0, 2, (32, sc.bits_per_frame(4)), generator=g,
                         dtype=torch.int32)
    (ai, aq), (bi, bq) = sc.tx(bits)
    y = (noisy(ai + 0.6 * bi), noisy(aq + 0.6 * bq))
    for got, want in zip(sd.decision_points(*(v.to(dev) for v in y), 4),
                         sc.decision_points(*y, 4)):
        close(got, want)
    close(sd.rx_soft(*(v.to(dev) for v in y), 4, 1e-3),
          sc.rx_soft(*y, 4, 1e-3))

    mc, md = both(lambda d: MimoOfdm(make_scheme("qpsk", r), device=d))
    bits = torch.randint(0, 2, (32, mc.bits_per_frame(4)), generator=g,
                         dtype=torch.int32)
    (ai, aq), (bi, bq) = mc.tx(bits)
    y = tuple(noisy(v) for v in (ai + 0.5 * bi, aq + 0.5 * bq,
                                 0.3 * ai + bi, 0.3 * aq + bq))
    for got, want in zip(md.detect(*(v.to(dev) for v in y), 4, 2e-4),
                         mc.detect(*y, 4, 2e-4)):
        close(got, want)
    assert torch.equal(md.rx_frame(*(v.to(dev) for v in y), 4).cpu(), bits)

    nc, nd = both(lambda d: MimoOfdmN(make_scheme("qpsk", r), nt=4,
                                      device=d))
    bits = torch.randint(0, 2, (32, nc.bits_per_frame(4)), generator=g,
                         dtype=torch.int32)
    ti, tq = nc.tx(bits)
    mix = torch.eye(4) + 0.25 * torch.randn((4, 4), generator=g)
    y = (noisy(mix @ ti), noisy(mix @ tq))
    for got, want in zip(nd.detect(*(v.to(dev) for v in y), 4, 2e-4),
                         nc.detect(*y, 4, 2e-4)):
        close(got, want)
    assert torch.equal(nd.rx_frame(*(v.to(dev) for v in y), 4, 2e-4).cpu(),
                       nc.rx_frame(*y, 4, 2e-4))

    loading = tuple(int(b) for b in np.random.default_rng(54).choice(
        [0, 1, 2, 4, 6], 48))
    lc, ld = both(lambda d: AdaptiveOfdm(loading, device=d))
    bits = torch.randint(0, 2, (32, lc.bits_per_frame(4)), generator=g,
                         dtype=torch.int32)
    assert torch.equal(ld.rx_frame(*ld.tx_frame(bits.to(dev)), 4).cpu(),
                       bits)
    y = tuple(noisy(v) for v in lc.tx_frame(bits))
    close(ld.rx_soft_frame(*(v.to(dev) for v in y), 4, 1e-3),
          lc.rx_soft_frame(*y, 4, 1e-3))


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8])
def test_cinv_h_on_card(n, dev):
    """The recursive Schur inverse on CUDA tensors against ``np.linalg.inv``
    (float64) at the JAX test's tolerance."""
    from modem_tpu_torch.mimo import _cinv_h

    rng = np.random.default_rng(n)
    b = rng.normal(0, 1, (64, n, n)) + 1j * rng.normal(0, 1, (64, n, n))
    a = np.einsum("bij,bkj->bik", b, b.conj()) + np.eye(n)
    got = _cinv_h((torch.as_tensor(a.real, dtype=torch.float32, device=dev),
                   torch.as_tensor(a.imag, dtype=torch.float32, device=dev)),
                  n)
    want = np.linalg.inv(a)
    for x, w in zip(got, (want.real, want.imag)):
        assert x.is_cuda and x.dtype == torch.float32
        np.testing.assert_allclose(x.cpu().numpy(), w, rtol=2e-3, atol=2e-4)


# ---- the wideband front end: channelizer, DSSS, FHSS, WidebandModem ----

WB_PRE = np.array([0, 1, 3, 2, 2, 0, 1, 1, 3, 0, 2, 3, 0, 0, 1, 2,
                   3, 3, 1, 0, 2, 1, 0, 2, 1, 3, 2, 2, 0, 3, 1, 0])


@pytest.mark.parametrize("dft_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [8, 64, 256])
def test_channelizer_chunked_equals_one_shot_on_card(m, dft_dtype, dev):
    """Both banks on CUDA tensors, in chunks of 3, 1, 40 and the rest of the
    rows (3 and 1 shorter than the filter's history), against one shot: bit
    for bit. One shot against the CPU twin within 1e-4 of the largest
    output; the bf16 DFT gives float32 outputs."""
    from modem_tpu_torch import Channelizer

    assert not torch.backends.cuda.matmul.allow_tf32
    bank = Channelizer(m, dft_dtype=dft_dtype, device=dev)
    cpu = Channelizer(m, dft_dtype=dft_dtype, device="cpu")
    g = torch.Generator().manual_seed(m)
    k = 300
    ci = torch.randn((2, m, k), generator=g)
    cq = torch.randn((2, m, k), generator=g)
    wi, wq = bank.synthesize(ci.to(dev), cq.to(dev))
    assert wi.dtype == torch.float32 and wi.is_cuda
    cwi, cwq = cpu.synthesize(ci, cq)
    for got, want in ((wi, cwi), (wq, cwq)):
        assert (got.cpu() - want).abs().max() <= 1e-4 * want.abs().max()
    cuts = (0, 3, 4, 44, k)
    st, parts = bank.init_synthesize_state((2,)), []
    assert st["zi"].is_cuda
    for a, b in zip(cuts[:-1], cuts[1:]):
        oi, oq, st = bank.synthesize_stream(ci[..., a:b].to(dev),
                                            cq[..., a:b].to(dev), st)
        parts.append((oi, oq))
    assert torch.equal(torch.cat([p[0] for p in parts], -1), wi)
    assert torch.equal(torch.cat([p[1] for p in parts], -1), wq)
    yi, yq = bank.analyze(wi, wq)
    assert yi.dtype == torch.float32 and yi.shape == (2, m, k)
    cyi, cyq = cpu.analyze(wi.cpu(), wq.cpu())
    for got, want in ((yi, cyi), (yq, cyq)):
        assert (got.cpu() - want).abs().max() <= 1e-4 * want.abs().max()
    st, parts = bank.init_analyze_state((2,)), []
    for a, b in zip(cuts[:-1], cuts[1:]):
        oi, oq, st = bank.analyze_stream(wi[..., a * m:b * m],
                                         wq[..., a * m:b * m], st)
        parts.append((oi, oq))
    assert torch.equal(torch.cat([p[0] for p in parts], -1), yi)
    assert torch.equal(torch.cat([p[1] for p in parts], -1), yq)
    if dft_dtype == torch.bfloat16:
        w32, _ = Channelizer(m, device=dev).synthesize(ci.to(dev), cq.to(dev))
        assert (wi - w32).abs().max() < 0.1


def test_dsss_and_wideband_k4_launches_by_the_profiler(dev):
    """DSSS's chip shaping and matched filter, and ``WidebandModem``'s burst
    TX and acquisition: the profiler sees K4's 65-tap instantiation and no
    other FIR kernel, and K4's wrapper counts two launches a call (one a
    rail; a profile now and then loses one record of ten, so the count is
    the wrapper's); the bits come back."""
    from modem_tpu_torch import (AcquiringReceiver, DsssChain, WidebandModem,
                                 make_scheme)
    from modem_tpu_torch.ops import fir

    def k4(fn, *args):
        names = _kernel_names(fn, *args, family="fir_")
        assert names and all("fir_core_kernel<65>" in k for k in names), names
        before = fir.FIR_KERNEL.launches
        fn(*args)
        torch.cuda.synchronize()
        return fir.FIR_KERNEL.launches - before

    r = Rates(1250, 10000)
    ds = DsssChain(make_scheme("qpsk", r), r, 16, device=dev)
    bits = torch.randint(0, 2, (8, 2 * 64), device=dev, dtype=torch.int32)
    assert k4(ds.tx, bits) == 2
    wave = ds.tx(bits)
    assert k4(ds.rx, wave, 64) == 2
    assert torch.equal(ds.rx(wave, 64), bits)
    rxr = AcquiringReceiver(qpsk_reference_chain(r, device=dev), WB_PRE,
                            max_lag=200)
    wm = WidebandModem(rxr, 16, 96)
    bits = torch.randint(0, 2, (16, 2 * 96), device=dev, dtype=torch.int32)
    assert k4(wm.tx, bits) == 2
    wi, wq = wm.tx(bits)
    assert k4(wm.rx, wi, wq) == 2
    assert torch.equal(wm.rx(wi, wq), bits)


def test_wideband_front_end_device_none_builds_on_the_card(dev):
    """``device=None`` builds the bank and the DSSS chain on the card; the
    hopper and the wideband modem follow their chain's device; a frame goes
    out and back on CUDA tensors, FHSS equal to its CPU twin."""
    from modem_tpu_torch import (AcquiringReceiver, Channelizer, DsssChain,
                                 FhssModem, PulseShapedChain, WidebandModem,
                                 make_scheme)

    r = Rates(1250, 10000)
    assert Channelizer(8).device.type == "cuda"
    ds = DsssChain(make_scheme("qpsk", r), r, 8)
    assert ds.pn.is_cuda and ds.rrc.is_cuda
    hop = [3, 6, 1, 4, 6, 2]
    fm = FhssModem(ds, m=8, hop_seq=hop, dwell_symbols=16)
    assert fm.bank.device.type == "cuda"
    g = torch.Generator().manual_seed(55)
    bits = torch.randint(0, 2, (4, fm.bits_per_frame()), generator=g,
                         dtype=torch.int32)
    got = fm.rx(*fm.tx(bits.to(dev)))
    assert got.is_cuda and torch.equal(got.cpu(), bits)
    cpu = FhssModem(DsssChain(make_scheme("qpsk", r), r, 8, device="cpu"),
                    m=8, hop_seq=hop, dwell_symbols=16)
    assert cpu._calibrate() == fm._calibrate()
    ps = PulseShapedChain(make_scheme("qam16", r), r, device=dev)
    fq = FhssModem(ps, m=8, hop_seq=hop, dwell_symbols=32)
    bits = torch.randint(0, 2, (4, fq.bits_per_frame()), generator=g,
                         dtype=torch.int32)
    assert torch.equal(fq.rx(*fq.tx(bits.to(dev))).cpu(), bits)
    rxr = AcquiringReceiver(qpsk_reference_chain(r), WB_PRE, max_lag=200)
    wm = WidebandModem(rxr, 8, 64)
    assert wm.bank.device.type == "cuda"


# --------------------------------------------------------------------------
# the multi-device layer on a world of one over NCCL (``parallel``)
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def nccl_mesh(dev):
    """A 1x1 mesh over an NCCL world of one on the card; the process group
    is taken down after the module."""
    import torch.distributed as dist
    from modem_tpu_torch.parallel.multihost import (_free_port,
                                                    initialize_multihost)

    mesh = initialize_multihost(
        ch=1, time=1, coordinator_address=f"localhost:{_free_port()}",
        num_processes=1, process_id=0, backend="nccl", device=dev)
    yield mesh
    dist.destroy_process_group()


def _sharded_call(counters, fn, *args):
    """``fn(*args)`` and the launches of each named counter over it."""
    before = {k: c.launches for k, c in counters.items()}
    out = fn(*args)
    torch.cuda.synchronize()
    return out, {k: c.launches - before[k] for k, c in counters.items()}


def _world_of_one_case(name, mesh, dev):
    """``(sharded outputs, single-device outputs, {kernel: counter})`` of
    one entry point on a 1x1 mesh."""
    from modem_tpu_torch import (AcquiringReceiver, Channelizer, Demodulator,
                                 DifferentialChain, Modulator, OfdmModem,
                                 WidebandModem, make_scheme)
    from modem_tpu_torch import parallel as par
    from modem_tpu_torch.fec import ccsds_code
    from modem_tpu_torch.models.qam import QAM
    from modem_tpu_torch.ops import fir, fsk_kernel, resampled_kernel as rk
    from modem_tpu_torch.ops import viterbi_kernel as vk
    from modem_tpu_torch.ops.fsk_kernel import fused_fsk_chain
    from modem_tpu_torch.ops.pll import LOCK_SAMPLES
    from modem_tpu_torch.resampled import ResampledChain
    from modem_tpu_torch.utils.bits import pack_bits, unpack_symbols

    r = Rates(1250, 10000)
    g = torch.Generator(device=dev).manual_seed(sum(map(ord, name)))
    bits = torch.randint(0, 2, (8, 2 * 512), generator=g, device=dev,
                         dtype=torch.int32)
    chain = qpsk_reference_chain(r, device=dev)
    if name in ("fused_roundtrip", "staged_roundtrip", "fused_txrx"):
        sc = par.ShardedPulseChain(chain, mesh)
        if name == "fused_roundtrip":
            return ((sc.fused_roundtrip_fn(), bits, 0),
                    (chain.roundtrip_fused(bits),),
                    {"K1": chain_kernel.CHAIN_KERNEL})
        if name == "staged_roundtrip":
            return ((sc.roundtrip_fn(), bits, 0), (chain.roundtrip(bits),),
                    {"K4": fir.FIR_KERNEL})

        def txrx_(b):
            wave, ext = sc.fused_tx_fn()(b)
            return (*wave, *ext, sc.fused_rx_fn()(wave, ext))
        wi, wq = chain.tx_fused(bits)
        n = 512 * chain.sps
        return ((txrx_, bits), (wi[:, :n], wq[:, :n], wi[:, n:], wq[:, n:],
                                chain.rx_fused((wi, wq), 512)),
                {"K2": txrx.TX_KERNEL, "K3": txrx.RX_HARD_KERNEL})
    if name == "differential":
        dch = DifferentialChain(make_scheme("dqpsk", r), r, device=dev)
        sd = par.ShardedDifferentialChain(dch, mesh)
        return ((sd.fused_roundtrip_fn(), bits), (dch.roundtrip_fused(bits),),
                {"K1": chain_kernel.CHAIN_KERNEL})
    if name == "fsk":
        mfsk = make_scheme("mfsk", r)
        fn = par.time_sharded_fsk_roundtrip_fn(mfsk, r, mesh)
        want = unpack_symbols(fused_fsk_chain(pack_bits(bits, 4), mfsk, r), 4)
        return ((fn, bits, 0), (want,),
                {"K6": fsk_kernel.FSK_CHAIN_KERNEL})
    if name == "resampled":
        rch = ResampledChain(QAM(4, 0.0, 1.0), r, 3, 2, device=dev)
        sr = par.ShardedResampledChain(rch, mesh)
        return ((sr.fused_roundtrip_fn(), bits), (rch.roundtrip_fused(bits),),
                {"K11": rk.RESAMPLED_TX_KERNEL,
                 "K12": rk.RESAMPLED_RX_KERNEL})
    if name == "fir_demodulate":
        mod = Modulator(make_scheme("qpsk", r), r, carrier_hz=2000,
                        device=dev)
        pw, _ = mod.passband(bits, mod.init_state((8,)))
        demod = Demodulator(2000, 10000, device=dev)
        st = demod.lock_phase(pw[:, :LOCK_SAMPLES], demod.init_state((8,)))
        (ri, rq), _ = demod.demodulate(pw[:, LOCK_SAMPLES:], st)
        z = torch.zeros((8, LOCK_SAMPLES), device=dev)

        def both(x):
            return (par.sharded_fir(x, chain.rrc, mesh),
                    *par.sharded_demodulate(demod, x, mesh))
        return ((both, pw), (fir.fir_filter(pw, chain.rrc)[0],
                             torch.cat([z, ri], -1), torch.cat([z, rq], -1)),
                {"K4": fir.FIR_KERNEL})
    if name == "viterbi":
        code = ccsds_code()
        y = 1.0 - 2.0 * code.encode(bits[:, :256]).to(torch.float32)
        llr = 2.0 * (y + 0.7 * torch.randn(y.shape, generator=g,
                                           device=dev)) / 0.49
        win = par.channel_sharded(
            lambda a: code.decode_soft_windowed(a, 128), mesh)

        def both(a):
            return par.sharded_viterbi_fn(code, mesh)(a), win(a)
        return ((both, llr), (code.decode_soft(llr),
                              code.decode_soft_windowed(llr, 128)),
                {"K13": vk.VITERBI_KERNEL})
    if name == "acquire_ofdm":
        rxr = AcquiringReceiver(chain, WB_PRE, max_lag=200)
        ai, aq = rxr.tx_burst(bits[:, :128])
        om = OfdmModem(make_scheme("qpsk", r), device=dev)
        ob = bits[:, :om.bits_per_frame(4)]

        def both(i, q, b):
            oi, oq = par.sharded_ofdm_tx_fn(om, mesh)(b)
            return (par.sharded_acquire_fn(rxr, mesh, 64)(i, q), oi, oq,
                    par.sharded_ofdm_rx_fn(om, mesh, 4, max_lag=32)(oi, oq))
        oi, oq = om.tx_frame(ob)
        return ((both, ai, aq, ob), (rxr.rx(ai, aq, 64), oi, oq,
                                     om.acquire(oi, oq, 4, 32)[0]),
                {"K4": fir.FIR_KERNEL})
    # the channelizer and WidebandModem(mesh=)
    bank = Channelizer(16, device=dev)
    ci = torch.randn((16, 256), generator=g, device=dev)
    cq = torch.randn((16, 256), generator=g, device=dev)
    wi, wq = bank.synthesize(ci, cq)
    rxr = AcquiringReceiver(chain, WB_PRE, max_lag=200)
    wm, solo = (WidebandModem(rxr, 16, 96, mesh=mesh),
                WidebandModem(rxr, 16, 96))
    wb = bits[:, :2 * 96].repeat(2, 1)

    def all_(a, b, c, d, x):
        return (*par.wideband_tx_fn(bank, mesh)(a, b),
                *par.wideband_rx_fn(bank, mesh)(c, d),
                *par.sharded_analyze_fn(bank, mesh)(c, d),
                *wm.tx(x), wm.rx(*wm.tx(x)))
    yi, yq = bank.analyze(wi, wq)
    swi, swq = solo.tx(wb)
    return ((all_, ci, cq, wi, wq, wb),
            (wi, wq, yi, yq, yi, yq, swi, swq, solo.rx(swi, swq)),
            {"K4": fir.FIR_KERNEL})


@pytest.mark.parametrize("name", [
    "fused_roundtrip", "staged_roundtrip", "fused_txrx", "differential",
    "fsk", "resampled", "fir_demodulate", "viterbi", "acquire_ofdm",
    "channelizer_wideband"])
def test_sharded_world_of_one_equals_single_device(name, dev, nccl_mesh):
    """Each sharded entry point on a 1x1 mesh over NCCL equals the
    single-device port's call bit for bit, waveforms included, and
    launches its kernels (the counters of its wrappers)."""
    (fn, *args), want, counters = _world_of_one_case(name, nccl_mesh, dev)
    got, launched = _sharded_call(counters, fn, *args)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g_, w in zip(got, want):
        assert g_.is_cuda and g_.shape == w.shape and torch.equal(g_, w)
    assert all(n > 0 for n in launched.values()), launched


def test_nccl_world_of_one_collectives_and_stats(dev, nccl_mesh):
    """NCCL on the card: the world's ``all_reduce``; the collectives of a
    group of one (halos of zeros, the prefix 0, sums and the re-deal the
    value itself); ``LinkStats.psum`` the stats; ``halo_mismatch`` 0."""
    import torch.distributed as dist
    from modem_tpu_torch import LinkStats
    from modem_tpu_torch.debug import halo_mismatch
    from modem_tpu_torch.parallel import (exclusive_prefix, left_halo,
                                          right_halo)
    from modem_tpu_torch.parallel.collectives import all_to_all, psum

    t = torch.arange(4.0, device=dev)
    dist.all_reduce(t)
    assert t.tolist() == [0.0, 1.0, 2.0, 3.0]
    group = nccl_mesh.get_group("time")
    assert dist.get_backend(group) == "nccl"
    x = torch.randn((3, 40), device=dev)
    assert torch.equal(left_halo(x, 5, group), torch.zeros(3, 5, device=dev))
    assert torch.equal(right_halo(x, 7, group), torch.zeros(3, 7, device=dev))
    assert torch.equal(exclusive_prefix(x[:, 0], group),
                       torch.zeros(3, device=dev))
    assert torch.equal(psum(x, group), x)
    assert torch.equal(all_to_all(x, group, 0, 1), x)
    bits = torch.randint(0, 2, (4, 100), device=dev, dtype=torch.int32)
    st = LinkStats.zero(dev).update_bits(bits, 1 - bits)
    tot = st.psum(group)
    assert tot.n_bit_errors == 400 and tot.n_bits == 400
    assert float(halo_mismatch(x, nccl_mesh, 4)) == 0.0


# ---- the launch path: what a launch asks of the runtime, asked once ----

#: every C entry of the kernel library (``cuda.SIGNATURES`` but the count)
LAUNCH_ENTRIES = ["modem_chain", "modem_tx", "modem_rx_hard", "modem_rx_soft",
                  "modem_chain_first", "modem_rx_hard_first",
                  "modem_rx_soft_first",
                  "modem_fir", "modem_fir_long_first", "modem_demod",
                  "modem_fsk_chain",
                  "modem_fsk_tone_table", "modem_msk_chain", "modem_fsk_tx",
                  "modem_disc_means", "modem_msk_tx", "modem_resampled_tx",
                  "modem_resampled_rx", "modem_viterbi",
                  "modem_viterbi_block", "modem_viterbi_block_core",
                  "modem_bcjr", "modem_polar_sc", "modem_polar_scl"]


@pytest.fixture(scope="module")
def launch_cases(dev):
    """``chip_smoke.launch_cases`` at its small shape: each C entry's
    wrapper and arguments."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    sm = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sm)
    chain = qpsk_reference_chain(Rates(1250, 10000), device=dev)
    return sm.launch_cases(chain, dev, sm.LAUNCH_SMALL)


def test_launch_entries_are_the_library_s():
    from modem_tpu_torch import cuda

    assert sorted(LAUNCH_ENTRIES) == sorted(
        s for s in cuda.SIGNATURES if s != "modem_host_queries")


@pytest.mark.parametrize("sym", LAUNCH_ENTRIES)
def test_launches_after_the_first_ask_the_runtime_nothing(sym, dev,
                                                          launch_cases):
    """After its first launch at a shape, a C entry makes no runtime query
    (device attributes, occupancy, shared-memory opt-ins): over 100 K4
    launches, over 20 of each other entry."""
    from modem_tpu_torch import cuda

    _, fn, args = launch_cases[sym]
    fn(*args)
    torch.cuda.synchronize()
    before = cuda.host_queries()
    for _ in range(100 if sym == "modem_fir" else 20):
        fn(*args)
    torch.cuda.synchronize()
    assert cuda.host_queries() == before


def test_fir_kernel_in_turn_at_tap_counts_of_other_shared_memory(dev):
    """K4 at 4, 240, 4 and 1000 taps in turn (the generic route at two
    shared-memory sizes, then the long route): each output equals the plain
    version as test_fir_kernel requires, and the second round asks the
    runtime nothing."""
    from modem_tpu_torch import cuda
    from modem_tpu_torch.ops import fir

    x = _unit((7, 5001), 21).to(dev)
    counts = (4, 240, 4, 1000)
    for rnd in range(2):
        before = cuda.host_queries()
        for k in counts:
            taps = _unit(k, k + 22).to(dev) / k ** 0.5
            st = _unit((7, k - 1), k + 23).to(dev)
            got = fir.fir_kernel(x, taps, st)
            torch.testing.assert_close(got, fir.fir_plain(x, taps, st),
                                       atol=ATOL, rtol=0)
        if rnd:
            assert cuda.host_queries() == before


def test_viterbi_in_turn_at_two_window_lengths(dev):
    """K13 at blocks of 256 and 1024 in turn (each its shared memory a
    warp): bit for bit the plain version's, the second round asking the
    runtime nothing."""
    from modem_tpu_torch import cuda
    from modem_tpu_torch.ops import viterbi_kernel as vk

    code, _, llr = _code_llrs(7, (0o171, 0o133), (64,), 4096, 1.2, 24, dev)
    lam = llr.reshape(64, -1, 2)
    for rnd in range(2):
        before = cuda.host_queries()
        for block in (256, 1024, 256):
            got = vk.stream_kernel(code, lam, block, 70, 1e6)
            assert torch.equal(got, vk.stream_plain(code, lam, block, 70,
                                                    1e6))
        if rnd:
            assert cuda.host_queries() == before
