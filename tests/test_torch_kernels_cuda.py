"""The port's CUDA kernels (K1 loopback, K2 TX, K3 RX hard and soft, K4 FIR,
K5 product detector, K6 FSK loopback, K7 MSK loopback, K8 FSK TX, K9
discriminator means, K10 MSK TX, K11 resampled TX, K12 resampled RX hard and
soft, K13 windowed Viterbi, K14 max-log BCJR, K15 polar SC, K16 polar
CA-SCL-8) against their plain PyTorch versions on the card,
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

import math

import numpy as np
import pytest
import torch

from modem_tpu_torch import Rates, qpsk_reference_chain
from modem_tpu_torch.models.psk import BPSK
from modem_tpu_torch.ops import chain_kernel, txrx
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


def _chain_exact(syms, lut, taps, sps, span, sent=True, **kw):
    """K1 against ``chain_plain``: decisions equal wherever there is a
    symbol, and (``sent``) equal to the symbols sent."""
    args = (syms, lut, taps, sps, span, kw.get("qam"), kw.get("carrier"),
            kw.get("sym_offset", 0), None, 0, kw.get("cs", 256))
    got = _launches(chain_kernel.CHAIN_KERNEL, chain_kernel.chain_kernel,
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
    for soft, kernel in ((False, txrx.RX_HARD_KERNEL),
                         (True, txrx.RX_SOFT_KERNEL)):
        got = _launches(kernel, txrx.rx_kernel, *rails, k, lut, taps, sps,
                        span, soft, *common)
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
#: symbol, or both; (96, 40) has a lookahead longer than K3's tile
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
    """K4's long route whatever the tap count (the taps from the device)."""
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


@pytest.mark.parametrize("k", [23, 32, 64, 65, 7, 256, 257])
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


# ---- K11 and K12 (resampled.cu) ----

# (up, down, bits per symbol, symbol shape): P = 1 (3/2, 5/4, 2/1, 1/2) and
# P = 3 (2/3); 64-QAM; tile edges
RESAMPLED = [(3, 2, 4, (3, 500)), (2, 3, 4, (2, 3, 300)), (5, 4, 6, (2, 257)),
             (2, 1, 4, (2, 700)), (1, 2, 4, (2, 1000)), (3, 2, 4, (2, 1))]
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
#: (S = 512) and 15 (metrics in shared memory, decisions past it) and a
#: tiny K = 16 (metrics in the global scratch) in the block route; rate
#: 1/40 (more code bits than a mask word)
WIDE_CODES = [
    ("k2", 2, (0o3, 0o1), (4,), 300, 64),
    ("k3", 3, (0o7, 0o5), (4,), 300, 64),
    ("k10", 10, (0o1731, 0o1373), (3,), 200, 64),
    ("k15", 15, (0o74653, 0o61535), (2,), 120, 48),
    ("k16_tiny", 16, (0o172675, 0o137323), (1,), 24, 16),
    ("k5_r1_40", 5, tuple(0o20 | (j % 15 + 1) for j in range(40)), (2,),
     100, 32),
]


@pytest.mark.parametrize("case", WIDE_CODES, ids=[c[0] for c in WIDE_CODES])
def test_viterbi_kernel_widened_shapes(case, dev):
    """decode_soft_windowed of every code shape on the card, bit for bit
    the plain version's, with the route the shape calls for; and ready
    windows with pinned and free ends."""
    from modem_tpu_torch.ops import viterbi_kernel as vk

    _, k, polys, shape, t, b = case
    code, bits, llr = _code_llrs(k, polys, shape, t, 1.0, 21, dev)
    lam = llr.reshape(llr.shape[:-1] + (-1, code.n))
    h = 10 * code.k
    warp = vk.warp_route(code, b + 2 * h)
    kernel = vk.VITERBI_KERNEL if warp else vk.VITERBI_BLOCK_KERNEL
    assert warp == (k <= 9 and code.n <= 32)
    got = _launches(kernel, code.decode_soft_windowed, llr, b)
    assert torch.equal(got, vk.stream_plain(code, lam, b, h, 1e6))
    assert float((got != bits).double().mean()) < 0.05
    win = lam[..., :b + 2 * h, :]
    pin = (torch.arange(win.shape[0], device=dev) % 2).float()
    assert torch.equal(vk.windows_kernel(code, win, pin),
                       vk.windows_plain(code, win, pin))


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
