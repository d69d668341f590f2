"""The host side of K11 and K12 on the polyphase core (``csrc/resampled.cu``),
on the CPU: which tables the wrappers hand their C entry points by value
(``ops.resampled_kernel.host_tables``: the host copy where the tables fit
the ``Taps`` parameter, else null, and the C entry point then takes the
long route), and the packing of K11's two tables and K12's one into the
``Taps`` host array (``cuda.host_taps``)."""

import ctypes

import numpy as np
import pytest
import torch

from modem_tpu_torch import Rates, ResampledChain, cuda
from modem_tpu_torch.models.qam import QAM
from modem_tpu_torch.ops import resampled_kernel as rk


class _Table:
    """Stands in for a table tensor of ``n`` floats for host_tables."""

    def __init__(self, n):
        self.n = n

    def numel(self):
        return self.n


@pytest.mark.parametrize("sizes,fits", [
    ((65, 51), True), ((65, 34), True), ((112,), True), ((213,), True),
    ((65, 191), True), ((256,), True), ((65, 192), False), ((257,), False),
    ((257, 51), False), ((1, 1, 255), False)])
def test_host_tables_only_where_they_fit(monkeypatch, sizes, fits):
    """The parameter holds 256 floats: up to that the tables go by value
    (K11's 65 RRC taps and 3 x 17 or 2 x 17 stage table, K12's 112 and
    213), past it null, and host_taps is not asked."""
    asked = []
    monkeypatch.setattr(rk, "host_taps", lambda *t: asked.append(t) or 1)
    tables = [_Table(n) for n in sizes]
    assert rk.host_tables(*tables) == (1 if fits else None)
    assert len(asked) == int(fits)


def _chain(up, down, span=8, bps=4):
    return ResampledChain(QAM(bps, 0.0, 1.0), Rates(1250, 10000), up, down,
                          span_symbols=span, device="cpu")


def _tables(chain):
    h = chain._host
    tx = rk._tx_params(h["rrc"].tobytes(), h["taps1"].tobytes(), chain.up,
                       chain.down, torch.device("cpu"))
    rx = rk._rx_params(h["rrc"].tobytes(), h["taps2"].tobytes(), chain.sps,
                       chain.up, chain.down, chain.delay, torch.device("cpu"))
    return tx, rx


#: (up, down, RRC span, K11's and K12's tables fit the parameter): config
#: #4's ratios, the other ratios of the card tests, a ratio whose K12 table
#: is past the parameter, and a chain of 257 RRC taps
CHAINS = [(3, 2, 8, (True, True)), (2, 3, 8, (True, True)),
          (5, 4, 8, (True, True)), (2, 1, 8, (True, True)),
          (1, 2, 8, (True, True)), (4, 3, 8, (True, False)),
          (3, 2, 32, (False, False))]


@pytest.mark.parametrize("up,down,span,fits", CHAINS)
def test_tables_of_the_chains(up, down, span, fits):
    """Config #4's tables at 3/2 and 2/3 are the shapes resampled.cu
    compiles, (sps, RRC taps, up, down, stage taps a phase) = (8, 65, 3, 2,
    17), (8, 65, 2, 3, 17) and K12's (period, width, taps) = (1, 12, 112),
    (3, 16, 71); each chain's tables fit the parameter or not as listed."""
    chain = _chain(up, down, span)
    (taps, table, _), (rt, period, width, _) = _tables(chain)
    tx = (chain.sps, taps.shape[0], up, down, table.shape[1])
    rx = (period, width, rt.shape[1])
    compiled = {(3, 2): ((8, 65, 3, 2, 17), (1, 12, 112)),
                (2, 3): ((8, 65, 2, 3, 17), (3, 16, 71))}
    if span == 8 and (up, down) in compiled:
        assert (tx, rx) == compiled[up, down]
    else:
        assert all(tx != t and rx != r for t, r in compiled.values())
    assert ((rk.host_tables(taps, table) is not None),
            (rk.host_tables(rt) is not None)) == fits


def _read(addr: int, n: int = cuda.TAPS_PARAM) -> np.ndarray:
    return np.ctypeslib.as_array(
        (ctypes.c_float * cuda.TAPS_PARAM).from_address(addr))[:n].copy()


@pytest.mark.parametrize("up,down", [(3, 2), (2, 3), (5, 4)])
def test_host_tables_pack_both_of_k11s_tables(up, down):
    """K11's parameter: the RRC taps from offset 0, the stage table, row
    after row, from offset n_taps (csrc/resampled.cu reads tabs.v[k*sps +
    ph] and tabs.v[n_taps + p*n_o + o]), zero after; K12's: the composite
    table row after row. One copy per tuple of tables, reused."""
    (taps, table, _), (rt, _, _, _) = _tables(_chain(up, down))
    addr = cuda.host_taps(taps, table)
    got = _read(addr)
    n = taps.shape[0]
    np.testing.assert_array_equal(got[:n], taps.numpy())
    np.testing.assert_array_equal(got[n:n + table.numel()].reshape(
        table.shape), table.numpy())
    assert not got[n + table.numel():].any()
    assert cuda.host_taps(taps, table) == addr
    assert cuda.host_taps(table, taps) != addr
    rx = _read(cuda.host_taps(rt))
    np.testing.assert_array_equal(rx[:rt.numel()].reshape(rt.shape),
                                  rt.numpy())
    assert not rx[rt.numel():].any()


def test_host_tables_refuse_more_than_the_parameter():
    (taps, table, _), (rt, _, _, _) = _tables(_chain(3, 2, span=32))
    with pytest.raises(ValueError, match="at most 256"):
        cuda.host_taps(taps, table)
    with pytest.raises(ValueError, match="at most 256"):
        cuda.host_taps(rt)


class _Calls:
    """Stands in for a wrapper's Kernel: records each launch's arguments."""

    def __init__(self):
        self.args = []

    def launch(self, device, *args):
        self.args.append(args)


@pytest.mark.parametrize("up,down,span,fits", CHAINS)
def test_wrappers_hand_the_tables(monkeypatch, up, down, span, fits):
    """Each wrapper passes its C entry point one argument fewer than
    cuda.SIGNATURES lists (the stream is added at the launch): the host
    tables where they fit, else null, then the device tables."""
    chain = _chain(up, down, span)
    (taps, table, first), (rt, period, width, rfirst) = _tables(chain)
    monkeypatch.setattr(rk, "check_cuda", lambda *a: None)
    tx, rx = _Calls(), _Calls()
    monkeypatch.setattr(rk, "RESAMPLED_TX_KERNEL", tx)
    monkeypatch.setattr(rk, "RESAMPLED_RX_KERNEL", rx)
    syms = torch.zeros((2, 30), dtype=torch.int32)
    n_modem = chain._padded_len(30)
    rk.resampled_tx_kernel(syms, chain.lut, taps, table, first, chain.sps,
                           up, down, n_modem)
    w = torch.zeros((2, n_modem * up // down))
    for soft in (False, True):
        rk.resampled_rx_kernel(w, w, 30, chain.lut, rt, period, width,
                               rfirst, soft)
    (targs,) = tx.args
    assert len(targs) == len(cuda.SIGNATURES["modem_resampled_tx"]) - 1
    assert all(len(a) == len(cuda.SIGNATURES["modem_resampled_rx"]) - 1
               for a in rx.args)
    assert targs[5] == (cuda.host_taps(taps, table) if fits[0] else None)
    assert targs[6] == taps.data_ptr() and targs[9] == table.data_ptr()
    want = cuda.host_taps(rt) if fits[1] else None
    assert all(a[5] == want and a[6] == rt.data_ptr() for a in rx.args)
