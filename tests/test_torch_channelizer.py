"""The polyphase channelizer in the port (``modem_tpu_torch.ops.channelizer``)
against the JAX package on the same numpy inputs, on the CPU. The cases
mirror ``tests/test_channelizer.py``.

Tolerances: waveforms and channel outputs within 2e-5 absolute plus 2e-5
relative of the JAX package's (a different order of summation in the DFT);
decided bits equal; the port's chunked streams equal its one shot bit for
bit, with the DFT's row tiles at their default size and shrunk to 8 rows so
that a block spans several tiles. Each JAX wideband run is made once, in a
module fixture.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from modem_tpu import Rates as JRates
from modem_tpu import qpsk_reference_chain as jchain_of
from modem_tpu.ops.channelizer import Channelizer as JChannelizer
from modem_tpu.sync import AcquiringReceiver as JAcquiringReceiver

from modem_tpu_torch import AcquiringReceiver, Channelizer, Rates
from modem_tpu_torch import qpsk_reference_chain
from modem_tpu_torch.ops import channelizer as tch

torch.set_num_threads(1)

CPU = "cpu"
TOL = 2e-5
PRE = np.array([0, 1, 3, 2, 2, 0, 1, 1, 3, 0, 2, 3, 0, 0, 1, 2,
                3, 3, 1, 0, 2, 1, 0, 2, 1, 3, 2, 2, 0, 3, 1, 0])
N_PAYLOAD = 128


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def _equal(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.array_equal(got, want)


def _tone(freq, n):
    t = np.arange(n)
    return (np.cos(2 * np.pi * freq * t).astype(np.float32),
            np.sin(2 * np.pi * freq * t).astype(np.float32))


def _j(a):
    return jnp.asarray(np.asarray(a))


def _t(a):
    return torch.tensor(np.asarray(a))


class TestAnalysis:
    @pytest.mark.parametrize("m0", [0, 1, 3, 5, 7])
    def test_tone_lands_in_its_channel(self, m0):
        m = 8
        i, q = _tone(m0 / m, m * 512)
        ji, jq = JChannelizer(m).analyze(_j(i), _j(q))
        yi, yq = Channelizer(m, device=CPU).analyze(_t(i), _t(q))
        _close(yi, ji)
        _close(yq, jq)
        p = (yi[..., 64:] ** 2 + yq[..., 64:] ** 2).mean(-1).numpy()
        target = p[m0]
        others = np.delete(p, m0)
        assert target > 1.0
        assert others.max() < target * 1e-4  # >= 40 dB suppression

    def test_offset_tone_appears_at_channel_rate_offset(self):
        m = 8
        delta = 0.03  # of the channel rate
        i, q = _tone((2 + delta) / m, m * 512)
        ji, jq = JChannelizer(m).analyze(_j(i), _j(q))
        yi, yq = Channelizer(m, device=CPU).analyze(_t(i), _t(q))
        _close(yi, ji)
        _close(yq, jq)
        zi = yi[2, 64:].numpy()
        zq = yq[2, 64:].numpy()
        dphi = np.angle(
            (zi[1:] + 1j * zq[1:]) * (zi[:-1] - 1j * zq[:-1])).mean()
        assert abs(dphi - 2 * np.pi * delta) < 1e-3


def _bits(m, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2, (m, N_PAYLOAD * 2)).astype(np.int32)


@pytest.fixture(scope="module")
def jax_wideband():
    """The JAX package's wideband story at M = 8, f32 and bf16 DFTs: the
    padded bursts, the wideband stream, the channel outputs and the bits."""
    m = 8
    rxr = JAcquiringReceiver(jchain_of(JRates(1250, 10000)), PRE,
                             max_lag=200)
    out = {}
    for name, dt, seed in (("f32", jnp.float32, 0), ("bf16", jnp.bfloat16, 5)):
        bits = _bits(m, seed)
        ci, cq = rxr.tx_burst(jnp.asarray(bits))
        pad = jnp.zeros((m, 256), ci.dtype)
        ci = jnp.concatenate([ci, pad], axis=-1)
        cq = jnp.concatenate([cq, pad], axis=-1)
        bank = JChannelizer(m, dft_dtype=dt)
        wi, wq = bank.synthesize(ci, cq)
        yi, yq = bank.analyze(wi, wq)
        out[name] = {
            "bits": bits, "ci": np.asarray(ci), "cq": np.asarray(cq),
            "wi": np.asarray(wi), "wq": np.asarray(wq),
            "yi": np.asarray(yi), "yq": np.asarray(yq),
            "out": np.asarray(rxr.rx(yi, yq, N_PAYLOAD))}
    return out


def _port_rxr():
    return AcquiringReceiver(qpsk_reference_chain(Rates(1250, 10000),
                                                  device=CPU),
                             PRE, max_lag=200)


class TestWidebandRoundtrip:
    def test_m_bursts_through_one_wideband_stream(self, jax_wideband):
        want = jax_wideband["f32"]
        m = 8
        rxr = _port_rxr()
        ci, cq = rxr.tx_burst(_t(want["bits"]))
        pad = torch.zeros((m, 256))
        ci = torch.cat([ci, pad], dim=-1)
        cq = torch.cat([cq, pad], dim=-1)
        _close(ci, want["ci"])
        bank = Channelizer(m, device=CPU)
        wi, wq = bank.synthesize(ci, cq)
        assert wi.shape[-1] == m * ci.shape[-1]
        _close(wi, want["wi"])
        _close(wq, want["wq"])
        yi, yq = bank.analyze(wi, wq)
        _close(yi, want["yi"])
        _close(yq, want["yq"])
        out = rxr.rx(yi, yq, N_PAYLOAD)
        _equal(out, want["bits"])
        _equal(out, want["out"])

    def test_bf16_dft_exact_decisions(self, jax_wideband):
        want = jax_wideband["bf16"]
        m = 8
        bank16 = Channelizer(m, dft_dtype=torch.bfloat16, device=CPU)
        bank32 = Channelizer(m, device=CPU)
        ci, cq = _t(want["ci"]), _t(want["cq"])
        wi, wq = bank16.synthesize(ci, cq)
        wi32, _ = bank32.synthesize(ci, cq)
        assert wi.dtype == torch.float32
        np.testing.assert_allclose(wi.numpy(), wi32.numpy(), atol=0.1)
        _close(wi, want["wi"])
        _close(wq, want["wq"])
        yi, yq = bank16.analyze(_t(want["wi"]), _t(want["wq"]))
        assert yi.dtype == torch.float32
        _close(yi, want["yi"])
        _close(yq, want["yq"])
        out = _port_rxr().rx(*bank16.analyze(wi, wq), N_PAYLOAD)
        _equal(out, want["bits"])
        _equal(out, want["out"])

    @pytest.mark.parametrize("tile", [None, 64])
    @pytest.mark.parametrize("dft_dtype", ["float32", "bfloat16"])
    def test_streaming_matches_oneshot_bitexact(self, monkeypatch, tile,
                                                dft_dtype):
        # chunked == one-shot through BOTH banks, including chunks shorter
        # than the per-phase filter history (K_chunk < J-1); with tile=64
        # every GEMM holds 8 rows, so blocks span several padded tiles
        if tile is not None:
            monkeypatch.setattr(tch, "DFT_TILE", tile)
        m = 8
        dt = getattr(torch, dft_dtype)
        bank = Channelizer(m, taps_per_phase=6, dft_dtype=dt, device=CPU)
        jbank = JChannelizer(m, taps_per_phase=6,
                             dft_dtype=getattr(jnp, dft_dtype))
        rng = np.random.default_rng(2)
        n_k = 48
        ci = rng.normal(size=(m, n_k)).astype(np.float32)
        cq = rng.normal(size=(m, n_k)).astype(np.float32)
        wi1, wq1 = bank.synthesize(_t(ci), _t(cq))
        jwi, jwq = jbank.synthesize(_j(ci), _j(cq))
        _close(wi1, jwi)
        _close(wq1, jwq)
        st = bank.init_synthesize_state()
        outs = []
        for k0, k1 in ((0, 3), (3, 7), (7, 48)):  # 3 rows < J-1 = 5
            o_i, o_q, st = bank.synthesize_stream(
                _t(ci[:, k0:k1]), _t(cq[:, k0:k1]), st)
            outs.append((o_i, o_q))
        _equal(torch.cat([o[0] for o in outs], -1), wi1)
        _equal(torch.cat([o[1] for o in outs], -1), wq1)

        yi1, yq1 = bank.analyze(wi1, wq1)
        jyi, jyq = jbank.analyze(_j(wi1), _j(wq1))
        _close(yi1, jyi)
        _close(yq1, jyq)
        st = bank.init_analyze_state()
        outs = []
        for s0, s1 in ((0, m * 2), (m * 2, m * 5), (m * 5, m * n_k)):
            o_i, o_q, st = bank.analyze_stream(wi1[s0:s1], wq1[s0:s1], st)
            outs.append((o_i, o_q))
        _equal(torch.cat([o[0] for o in outs], -1), yi1)
        _equal(torch.cat([o[1] for o in outs], -1), yq1)

    def test_batched_banks(self):
        # leading batch dims flow through both directions
        m = 4
        bank = Channelizer(m, device=CPU)
        rng = np.random.default_rng(1)
        ci = rng.normal(size=(2, m, 256)).astype(np.float32)
        cq = rng.normal(size=(2, m, 256)).astype(np.float32)
        wi, wq = bank.synthesize(_t(ci), _t(cq))
        assert wi.shape == (2, m * 256)
        jwi, jwq = JChannelizer(m).synthesize(_j(ci), _j(cq))
        _close(wi, jwi)
        _close(wq, jwq)
        yi, yq = bank.analyze(wi, wq)
        assert yi.shape == (2, m, 256)
        jyi, jyq = JChannelizer(m).analyze(_j(wi), _j(wq))
        _close(yi, jyi)
        _close(yq, jyq)


class TestBankTables:
    @pytest.mark.parametrize("m,j,beta", [(8, 12, 9.0), (4, 6, 7.0),
                                          (64, 12, 9.0)])
    def test_tables_equal_the_jax_package(self, m, j, beta):
        from modem_tpu.ops import channelizer as jch

        hp, cmat, smat = jch._bank(m, j, beta)
        bank = Channelizer(m, j, beta, device=CPU)
        _equal(bank.hp, hp)
        _equal(bank.dft_w, np.concatenate([cmat, smat], axis=1))
        state = bank.init_analyze_state((3,))
        jstate = JChannelizer(m, j, beta).init_analyze_state((3,))
        for k in jstate:
            assert tuple(state[k].shape) == jstate[k].shape
        sstate = bank.init_synthesize_state((2,), device=CPU)
        jsstate = JChannelizer(m, j, beta).init_synthesize_state((2,))
        for k in jsstate:
            assert tuple(sstate[k].shape) == jsstate[k].shape

    def test_dft_rows_depend_on_m_alone(self):
        assert tch.dft_rows(256) * 256 == tch.DFT_TILE
        assert tch.dft_rows(3) * 3 >= tch.DFT_TILE

    def test_validation(self):
        with pytest.raises(ValueError):
            Channelizer(1, device=CPU)
        with pytest.raises(ValueError):
            Channelizer(8, dft_dtype=torch.float16, device=CPU)
        bank = Channelizer(8, device=CPU)
        with pytest.raises(ValueError):
            bank.analyze(torch.zeros(12), torch.zeros(12))
        with pytest.raises(ValueError):
            bank.synthesize(torch.zeros((4, 16)), torch.zeros((4, 16)))


def test_device_none_needs_the_card():
    """``device=None`` means CUDA: without a card the bank does not build."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Channelizer(8)
