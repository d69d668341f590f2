"""The taps K1 and K3 take (``ops.txrx.kernel_taps``): on the short route
the host copy the wrappers pass as the kernels' ``Taps`` parameter, beside
the taps' own address; past the short route's limits no host copy, which
sends the kernels down the long route. Runs on the CPU: the copy is host
memory whatever device the taps lie on."""

import ctypes

import numpy as np
import pytest
import torch

from modem_tpu_torch.ops import txrx
from modem_tpu_torch.ops.filters import rrc_taps


def _read(addr: int, n: int) -> np.ndarray:
    return np.ctypeslib.as_array(
        (ctypes.c_float * txrx.MAX_KERNEL_TAPS).from_address(addr))[:n].copy()


@pytest.mark.parametrize("sps,span", [(8, 8), (4, 6), (2, 10), (64, 3)])
def test_kernel_taps_hold_the_taps(sps, span):
    taps = torch.as_tensor(rrc_taps(sps, span, 0.35))
    addr, dev = txrx.kernel_taps(taps, sps)
    assert dev == taps.data_ptr()
    np.testing.assert_array_equal(_read(addr, taps.shape[0]), taps.numpy())


def test_kernel_taps_are_copied_once_and_follow_changes():
    """One host copy per taps tensor; an in-place change makes a new one."""
    taps = torch.as_tensor(rrc_taps(8, 8, 0.35))
    addr = txrx.kernel_taps(taps, 8)[0]
    assert txrx.kernel_taps(taps, 8)[0] == addr
    taps.mul_(2.0)
    addr2 = txrx.kernel_taps(taps, 8)[0]
    np.testing.assert_array_equal(_read(addr2, 65), taps.numpy())
    other = taps.clone()
    np.testing.assert_array_equal(_read(txrx.kernel_taps(other, 8)[0], 65),
                                  taps.numpy())


def test_kernel_taps_of_an_inference_tensor():
    with torch.inference_mode():
        taps = torch.as_tensor(rrc_taps(8, 8, 0.35)) + 0.0
    np.testing.assert_array_equal(_read(txrx.kernel_taps(taps, 8)[0], 65),
                                  taps.numpy())


@pytest.mark.parametrize("sps,span", [(8, 32), (65, 1), (128, 1), (20, 16)])
def test_kernel_taps_pick_the_long_route(sps, span):
    """More than 256 taps or 64 samples a symbol: no host copy, the taps'
    own address for the long route."""
    taps = torch.as_tensor(rrc_taps(sps, span, 0.35))
    assert txrx.kernel_taps(taps, sps) == (None, taps.data_ptr())


@pytest.mark.parametrize("sps,span", [(8, 31), (64, 3), (32, 7)])
def test_kernel_taps_keep_the_short_route_to_its_limits(sps, span):
    taps = torch.as_tensor(rrc_taps(sps, span, 0.35))
    assert taps.shape[0] <= txrx.MAX_KERNEL_TAPS
    addr, _ = txrx.kernel_taps(taps, sps)
    np.testing.assert_array_equal(_read(addr, taps.shape[0]), taps.numpy())
