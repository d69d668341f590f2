"""Streaming classes of the PyTorch port: chunked == one shot across block
splits, and a stream started in ``modem_tpu`` resumes in the port from the
numpy form of the JAX ``get_state()`` carry, continuing exactly as the JAX
stream does."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from modem_tpu import Rates as JRates
from modem_tpu.chain import qpsk_reference_chain as j_qpsk_chain
from modem_tpu import streaming as jstreaming

from modem_tpu_torch import (Rates, StreamingFusedChain, StreamingFusedRx,
                             StreamingFusedTx, qpsk_reference_chain)

torch.set_num_threads(1)

CHAIN = qpsk_reference_chain(Rates(1250, 10000), device="cpu")
SPS, SPAN = CHAIN.sps, CHAIN.span


def _bits(seed, shape):
    return torch.as_tensor(
        np.random.default_rng(seed).integers(0, 2, shape).astype(np.int32))


def _pieces(x, splits, unit):
    out, start = [], 0
    for n in splits:
        out.append(x[..., start * unit:(start + n) * unit])
        start += n
    return out


@pytest.mark.parametrize("splits", [
    [400], [100, 300], [37, 101, 262], [8, 8, 8, 376], [1, 399], [3],
])
def test_chain_chunked_equals_one_shot(splits):
    bits = _bits(sum(splits), (2, sum(splits) * 2))
    stream = StreamingFusedChain(CHAIN, (2,))
    got = torch.cat([stream.push(b) for b in _pieces(bits, splits, 2)]
                    + [stream.flush()], dim=-1)
    assert torch.equal(got, CHAIN.roundtrip_fused(bits))
    assert torch.equal(got, bits)


@pytest.mark.parametrize("splits", [[64], [17, 47], [1, 2, 61], [30, 4, 30]])
def test_tx_chunked_equals_one_shot(splits):
    bits = _bits(len(splits), (2, 64 * 2))
    one = CHAIN.tx_fused(bits)
    stream = StreamingFusedTx(CHAIN, (2,))
    parts = [stream.push(b) for b in _pieces(bits, splits, 2)] + [stream.flush()]
    for r in range(2):
        assert torch.equal(torch.cat([p[r] for p in parts], dim=-1), one[r])


@pytest.mark.parametrize("splits", [[64], [16, 48], [8, 24, 32], [1, 63]])
def test_rx_chunked_equals_one_shot(splits):
    bits = _bits(10 + len(splits), (2, 64 * 2))
    wave = CHAIN.tx(bits)
    stream = StreamingFusedRx(CHAIN, (2,))
    segs = zip(*(_pieces(w, splits + [SPAN], SPS) for w in wave))
    got = torch.cat([stream.push(s) for s in segs], dim=-1)
    assert torch.equal(got, CHAIN.rx_fused(wave, 64))
    assert torch.equal(got, bits)


def test_rx_truncated_flush():
    """A stream cut before the TX flush tail: flush decides the pending
    symbols against zeros, as the one-shot RX does on a zero-padded wave."""
    bits = _bits(20, (2, 40 * 2))
    wave = CHAIN.tx(bits)
    cut = tuple(w[..., :40 * SPS] for w in wave)
    stream = StreamingFusedRx(CHAIN, (2,))
    got = torch.cat([stream.push(cut), stream.flush()], dim=-1)
    padded = tuple(torch.cat([c, torch.zeros(2, SPAN * SPS)], dim=-1)
                   for c in cut)
    assert torch.equal(got, CHAIN.rx_fused(padded, 40))
    assert stream.flush().shape == (2, 0)


def test_batch_shape_enforced():
    for cls in (StreamingFusedChain, StreamingFusedTx):
        with pytest.raises(ValueError, match="batch shape"):
            cls(CHAIN, (2,)).push(torch.zeros((3, 16), dtype=torch.int32))
    with pytest.raises(ValueError, match="multiple of sps"):
        StreamingFusedRx(CHAIN, (2,)).push(
            (torch.zeros(2, SPS + 1), torch.zeros(2, SPS + 1)))


def test_port_state_round_trip():
    """get_state -> set_state on a fresh stream continues identically."""
    bits = _bits(30, (2, 120 * 2))
    a, b = StreamingFusedChain(CHAIN, (2,)), StreamingFusedChain(CHAIN, (2,))
    a.push(bits[:, :100])
    b.set_state({k: (v.clone() if torch.is_tensor(v) else v)
                 for k, v in a.get_state().items()})
    assert torch.equal(a.push(bits[:, 100:]), b.push(bits[:, 100:]))
    assert torch.equal(a.flush(), b.flush())


def _np_state(state):
    """The numpy form of a JAX carry, as a checkpoint file would hold it."""
    return {k: ([np.asarray(x) for x in v] if isinstance(v, list)
                else np.asarray(v)) for k, v in state.items()}


@pytest.fixture(scope="module")
def j_chain():
    return j_qpsk_chain(JRates(1250, 10000))


def test_chain_resumes_jax_stream(j_chain):
    bits = np.random.default_rng(40).integers(0, 2, (2, 300 * 2)).astype(np.int32)
    js = jstreaming.StreamingFusedChain(j_chain, (2,))
    js.push(jnp.asarray(bits[:, :2 * 130]))
    ts = StreamingFusedChain(CHAIN, (2,))
    ts.set_state(_np_state(js.get_state()))
    want = [js.push(jnp.asarray(bits[:, 2 * 130:])), js.flush()]
    got = [ts.push(torch.as_tensor(bits[:, 2 * 130:])), ts.flush()]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_tx_resumes_jax_stream(j_chain):
    bits = np.random.default_rng(41).integers(0, 2, (2, 90 * 2)).astype(np.int32)
    js = jstreaming.StreamingFusedTx(j_chain, (2,))
    js.push(jnp.asarray(bits[:, :2 * 50]))
    ts = StreamingFusedTx(CHAIN, (2,))
    ts.set_state(_np_state(js.get_state()))
    want = [js.push(jnp.asarray(bits[:, 2 * 50:])), js.flush()]
    got = [ts.push(torch.as_tensor(bits[:, 2 * 50:])), ts.flush()]
    for g, w in zip(got, want):
        for gr, wr in zip(g, w):
            np.testing.assert_allclose(gr.numpy(), np.asarray(wr), atol=1e-5)


def test_rx_resumes_jax_stream(j_chain):
    bits = np.random.default_rng(42).integers(0, 2, (2, 96 * 2)).astype(np.int32)
    wave = [np.array(w) for w in j_chain.tx(jnp.asarray(bits))]
    cut = 40 * SPS
    js = jstreaming.StreamingFusedRx(j_chain, (2,))
    first = js.push(tuple(jnp.asarray(w[:, :cut]) for w in wave))
    ts = StreamingFusedRx(CHAIN, (2,))
    ts.set_state(_np_state(js.get_state()))
    want = js.push(tuple(jnp.asarray(w[:, cut:]) for w in wave))
    got = ts.push(tuple(torch.as_tensor(w[:, cut:]) for w in wave))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        np.concatenate([np.asarray(first), got.numpy()], -1), bits)
