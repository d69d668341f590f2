"""The BER harness, the link metrics and the stream checkpoints of the
PyTorch port vs the JAX package, on shared numpy inputs:
``modem_tpu_torch.harness`` (the closed forms, ``fused_ber_point`` on K1's
noise against the JAX interpret stream, ``release_gates`` on the CPU),
``metrics`` (``evm_rms``, ``snr_estimate_db``, ``LinkStats`` against the
JAX carry on the same updates), ``checkpoint`` (round trips, and a carry
the JAX package saved resuming the port's streams) and
``ops.channel.awgn_real``.

Tolerances: the closed forms to 1e-12 (relative); ``fused_ber_point``'s
bit errors within max(2, 0.1%) of JAX's at 64 channels x 1024 symbols
(the same noise stream, so equal in practice); ``LinkStats`` counts
exactly, its EVM and SNR to 1e-5 relative (float32 sums in another
order); resumed streams exactly.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from modem_tpu import Rates as JRates
from modem_tpu import checkpoint as jckpt
from modem_tpu import harness as jh
from modem_tpu import metrics as jmetrics
from modem_tpu import streaming as jstreaming
from modem_tpu.chain import PulseShapedChain as JChain
from modem_tpu.chain import qpsk_reference_chain as j_qpsk_chain
from modem_tpu.models.psk import QPSK as JQPSK
from modem_tpu.models.qam import QAM as JQAM

from modem_tpu_torch import (LinkStats, Rates, StreamingFusedChain,
                             StreamingFusedRx, StreamingFusedTx, checkpoint,
                             harness, metrics, presets,
                             qpsk_reference_chain)
from modem_tpu_torch.chain import PulseShapedChain
from modem_tpu_torch.models.psk import MPSK, QPSK
from modem_tpu_torch.models.qam import QAM
from modem_tpu_torch.ops.channel import awgn_real

torch.set_num_threads(1)

CPU = "cpu"
JR, TR = JRates(1250, 10000), Rates(1250, 10000)


# ---- the closed forms ----

@pytest.mark.parametrize("snr", [0.0, 7.0, 14.0])
def test_theory_helpers_equal_jax(snr):
    pairs = [
        (harness.q_function(snr / 5), jh.q_function(snr / 5)),
        (harness.qpsk_ber_theory(snr), jh.qpsk_ber_theory(snr)),
        (harness.mqam_ber_theory(snr, 16), jh.mqam_ber_theory(snr, 16)),
        (harness.mqam_ber_theory(snr, 256, gray=True),
         jh.mqam_ber_theory(snr, 256, gray=True)),
        (harness.mpsk_ber_theory(snr, 8), jh.mpsk_ber_theory(snr, 8)),
        (harness.mpsk_ber_theory(snr, 8, gray=True),
         jh.mpsk_ber_theory(snr, 8, gray=True)),
        (harness.rayleigh_ber_theory(snr), jh.rayleigh_ber_theory(snr)),
    ]
    for got, want in pairs:
        assert got == pytest.approx(want, rel=1e-12, abs=0)
    for levels in (2, 4, 16):
        assert (harness.natural_binary_flip_factor(levels)
                == jh.natural_binary_flip_factor(levels))


# ---- fused_ber_point on K1's noise ----

@pytest.mark.parametrize("case", [
    ("qpsk_7db", JQPSK(0.0, 1.0), QPSK(0.0, 1.0), 7.0),
    ("qam16_natural_14db", JQAM(4, 0.0, 1.0), QAM(4, 0.0, 1.0), 14.0),
], ids=lambda c: c[0])
def test_fused_ber_point_matches_jax(case):
    """64 x 1024 symbols: the port's plain K1 draws the JAX interpret
    stream, so the error counts agree within max(2, 0.1%); both near the
    closed form."""
    _, jscheme, tscheme, snr = case
    jp = jh.fused_ber_point(JChain(jscheme, JR), snr, n_symbols=1024,
                            channels=64, seed=3)
    tp = harness.fused_ber_point(PulseShapedChain(tscheme, TR, device=CPU),
                                 snr, n_symbols=1024, channels=64, seed=3)
    assert (tp.snr_db, tp.bits) == (jp.snr_db, jp.bits)
    assert abs(tp.bit_errors - jp.bit_errors) <= max(2, 1e-3 * jp.bit_errors)
    bps = tscheme.bits_per_symbol
    theory = (harness.qpsk_ber_theory(snr) if bps == 2
              else harness.mqam_ber_theory(snr, 16))
    assert 0.7 < tp.ber / theory < 1.3


def test_ber_waterfall_is_monotone():
    chain = qpsk_reference_chain(TR, device=CPU)
    pts = harness.ber_waterfall(chain, [2.0, 5.0, 8.0], n_symbols=256,
                                channels=16, seed=1)
    assert [p.snr_db for p in pts] == [2.0, 5.0, 8.0]
    bers = [p.ber for p in pts]
    assert bers[0] > bers[1] > bers[2] > 0
    assert pts[1] == harness.fused_ber_point(chain, 5.0, 256, 16, seed=18)


def test_chain_awgn_ber_point_near_theory():
    """The staged chain with seeded torch noise: 8-PSK at 12 dB over 64k
    bits, within the statistical spread of the closed form."""
    chain = PulseShapedChain(MPSK(3, 0.0, 1.0), TR, device=CPU)
    pt = harness.chain_awgn_ber_point(chain, 12.0, n_symbols=1024,
                                      channels=16, seed=0)
    assert pt.bits == 16 * 1024 * 3
    assert 0.8 < pt.ber / harness.mpsk_ber_theory(12.0, 8) < 1.25
    assert pt == harness.chain_awgn_ber_point(chain, 12.0, 1024, 16, seed=0)


def test_release_gates_on_the_cpu():
    """Gates 1, 2 and 4 run and pass on the CPU; gates 3 (OFDM) and 5
    (LDPC) are reported as not run, never as passed."""
    gates = {g["gate"]: g for g in harness.release_gates(seed=0, device=CPU)}
    assert list(gates) == ["8psk_awgn_vs_theory", "qam16_gray_awgn_vs_theory",
                           "ofdm_qpsk_rayleigh_vs_theory",
                           "rs_conv_link_zero_errors_at_1db",
                           "ldpc_648_324_zero_errors_at_4p5db"]
    for name in ("8psk_awgn_vs_theory", "qam16_gray_awgn_vs_theory",
                 "rs_conv_link_zero_errors_at_1db"):
        assert gates[name]["passed"] is True, gates[name]
    for name in ("8psk_awgn_vs_theory", "qam16_gray_awgn_vs_theory"):
        assert gates[name]["errors"] > 1000
    for name in ("ofdm_qpsk_rayleigh_vs_theory",
                 "ldpc_648_324_zero_errors_at_4p5db"):
        assert gates[name]["passed"] is None and gates[name]["not_run"]


def test_qam16_gray_chain_preset():
    chain = presets.qam16_gray_chain(device=CPU)
    want = np.asarray(JChain(JQAM(4, 0.0, 6.0, gray=True), JR).lut)
    np.testing.assert_array_equal(chain.lut.numpy(), want)
    assert "qam_params" not in chain._txrx_params()


# ---- metrics ----

def _iq(seed, n=4000):
    rng = np.random.default_rng(seed)
    ref = rng.normal(0, 1, (2, n)).astype(np.float32)
    rx = (ref + rng.normal(0, 0.1, ref.shape)).astype(np.float32)
    return rx, ref


def test_evm_and_snr_estimate_match_jax():
    rx, ref = _iq(0)
    targs = [torch.as_tensor(x) for x in (*rx, *ref)]
    jargs = [jnp.asarray(x) for x in (*rx, *ref)]
    assert float(metrics.evm_rms(*targs)) == pytest.approx(
        float(jmetrics.evm_rms(*jargs)), rel=1e-5)
    assert float(metrics.snr_estimate_db(*targs)) == pytest.approx(
        float(jmetrics.snr_estimate_db(*jargs)), rel=1e-5)


def test_link_stats_match_jax():
    """The same block updates through both carries, merged: every count
    equal, EVM and SNR to float32 order."""
    rng = np.random.default_rng(1)
    ts, js = LinkStats.zero(CPU), jmetrics.LinkStats.zero()
    for b in range(3):
        tx = rng.integers(0, 2, (4, 500)).astype(np.int32)
        rx = tx ^ (rng.random(tx.shape) < 0.01)
        sx = rng.integers(0, 16, (4, 125)).astype(np.int32)
        sr = np.where(rng.random(sx.shape) < 0.05, (sx + 1) % 16, sx)
        ok = rng.random(6) < 0.7
        i, r = _iq(10 + b, 300)
        ts = (ts.update_bits(torch.as_tensor(tx), torch.as_tensor(rx))
              .update_symbols(torch.as_tensor(sx), torch.as_tensor(sr))
              .update_frames(torch.as_tensor(ok))
              .update_evm(*[torch.as_tensor(x) for x in (*i, *r)]))
        js = (js.update_bits(jnp.asarray(tx), jnp.asarray(rx))
              .update_symbols(jnp.asarray(sx), jnp.asarray(sr))
              .update_frames(jnp.asarray(ok))
              .update_evm(*[jnp.asarray(x) for x in (*i, *r)]))
    ts, js = ts.merge(ts), js.merge(js)
    got, want = ts.summary(), js.summary()
    for key in ("blocks", "bits", "bit_errors", "symbols", "symbol_errors",
                "frames", "frame_errors", "ber", "ser", "fer"):
        assert got[key] == want[key], key
    assert got["evm"] == pytest.approx(want["evm"], rel=1e-5)
    assert got["snr_db"] == pytest.approx(want["snr_db"], rel=1e-5)
    assert ts.bit_tot.dtype == torch.int64


def test_awgn_real_power():
    g = torch.Generator().manual_seed(0)
    x = torch.ones(200000)
    y = awgn_real(g, x, 10.0)
    assert float(torch.var(y - x)) == pytest.approx(0.1, rel=0.02)
    z = awgn_real(torch.Generator().manual_seed(0), x, 10.0,
                  signal_power=4.0)
    assert float(torch.var(z - x)) == pytest.approx(0.4, rel=0.02)


# ---- checkpoints ----

def test_checkpoint_round_trip(tmp_path):
    """save_state / load_state on a port carry and on LinkStats; a wrong
    template raises."""
    chain = qpsk_reference_chain(TR, device=CPU)
    sr = StreamingFusedRx(chain, (2,))
    wave = chain.tx_fused(torch.as_tensor(np.random.default_rng(2).integers(
        0, 2, (2, 200)).astype(np.int32)))
    sr.push(tuple(w[..., :400] for w in wave))
    checkpoint.save_state(tmp_path / "rx.npz", sr.get_state())
    fresh = StreamingFusedRx(chain, (2,))
    fresh.set_state(checkpoint.load_state(tmp_path / "rx.npz",
                                          fresh.get_state()))
    rest = tuple(w[..., 400:] for w in wave)
    assert torch.equal(fresh.push(rest), sr.push(rest))
    stats = LinkStats.zero(CPU).update_bits(torch.ones(10), torch.zeros(10))
    checkpoint.save_state(tmp_path / "s.npz", stats)
    back = checkpoint.load_state(tmp_path / "s.npz", LinkStats.zero(CPU))
    assert back.summary() == stats.summary()
    with pytest.raises(ValueError, match="leaves"):
        checkpoint.load_state(tmp_path / "s.npz", fresh.get_state())


def test_jax_saved_carry_resumes_the_port_streams(tmp_path):
    """A carry saved by ``modem_tpu.checkpoint`` mid-stream loads into each
    of the port's streaming classes, which go on as the JAX streams do."""
    jc, tc = j_qpsk_chain(JR), qpsk_reference_chain(TR, device=CPU)
    bits = np.random.default_rng(4).integers(0, 2, (2, 240)).astype(np.int32)
    head, tail = bits[:, :140], bits[:, 140:]
    for jcls, tcls in ((jstreaming.StreamingFusedChain, StreamingFusedChain),
                       (jstreaming.StreamingFusedTx, StreamingFusedTx)):
        js = jcls(jc, (2,))
        js.push(jnp.asarray(head))
        jckpt.save_state(tmp_path / "c.npz", js.get_state())
        ts = tcls(tc, (2,))
        ts.set_state(checkpoint.load_state(tmp_path / "c.npz",
                                           ts.get_state()))
        for g, w in zip(_flat(ts.push(torch.as_tensor(tail))),
                        _flat(js.push(jnp.asarray(tail)))):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)
    wave = tuple(np.array(w) for w in jc.tx(jnp.asarray(bits)))
    jr = jstreaming.StreamingFusedRx(jc, (2,))
    jr.push(tuple(jnp.asarray(w[:, :560]) for w in wave))
    jckpt.save_state(tmp_path / "r.npz", jr.get_state())
    tr = StreamingFusedRx(tc, (2,))
    tr.set_state(checkpoint.load_state(tmp_path / "r.npz", tr.get_state()))
    rest = tuple(w[:, 560:] for w in wave)
    np.testing.assert_array_equal(
        tr.push(tuple(torch.as_tensor(w) for w in rest)).numpy(),
        np.asarray(jr.push(tuple(jnp.asarray(w) for w in rest))))


def _flat(x):
    return x if isinstance(x, tuple) else (x,)


@pytest.mark.parametrize("build", [
    lambda: LinkStats.zero(),
    lambda: harness.release_gates(),
    lambda: presets.qam16_gray_chain(),
], ids=["LinkStats.zero", "release_gates", "qam16_gray_chain"])
def test_device_none_is_the_card(build, monkeypatch):
    """``device=None`` means CUDA; without a CUDA device the new entry
    points raise and build nothing on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build()
