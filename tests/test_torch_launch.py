"""The launch path every kernel shares, on the CPU: ``cuda.Kernel.launch``
against a stand-in library (the C function looked up once, the arguments
and the current stream handed on in order, the device guard only off the
current device, a failed launch raised and not counted), K4's wrapper
(``ops.fir.fir_kernel``) handing ``modem_fir`` the same arguments for every
form of input, and the host copy of the taps (``cuda.host_taps``) refreshed
after an in-place change."""

import contextlib
import ctypes

import numpy as np
import pytest
import torch

from modem_tpu_torch import cuda
from modem_tpu_torch.ops import fir

CUDA0 = torch.device("cuda", 0)


class _Lib:
    """A stand-in for the kernel library: records each symbol looked up and
    each call; every C function returns ``rc``."""

    def __init__(self, rc: int = 0):
        self.rc = rc
        self.looked_up = []
        self.calls = []

    def __getattr__(self, name):
        self.looked_up.append(name)
        if name == "modem_error_string":
            return lambda rc: b"stand-in error"
        if name == "modem_host_queries":
            return lambda: 7

        def fn(*args):
            self.calls.append((name, args))
            return self.rc
        return fn


@pytest.fixture
def lib(monkeypatch):
    """A stand-in library on current device 0, whose streams' handles are
    1000 + the device's index; ``torch.cuda.device`` records the indices it
    is entered with."""
    stub = _Lib()
    stub.guards = []

    @contextlib.contextmanager
    def guard(index):
        stub.guards.append(index)
        yield

    monkeypatch.setattr(cuda, "library", lambda: stub)
    monkeypatch.setattr(cuda, "_current_device", lambda: 0)
    monkeypatch.setattr(cuda, "_raw_stream", lambda index: 1000 + index)
    monkeypatch.setattr(torch.cuda, "device", guard)
    return stub


def test_launch_resolves_once_and_hands_the_stream_last(lib):
    k = cuda.Kernel("modem_fir")
    for i in range(5):
        k.launch(CUDA0, i, None, 3.5)
    assert lib.looked_up == ["modem_fir"]
    assert lib.calls == [("modem_fir", (i, None, 3.5, 1000)) for i in range(5)]
    assert k.launches == 5
    assert lib.guards == []


def test_launch_guards_only_another_device(lib):
    k = cuda.Kernel("modem_bcjr")
    k.launch(torch.device("cuda"), 1)  # no index: the current device
    k.launch(torch.device("cuda", 2), 2)
    assert lib.calls == [("modem_bcjr", (1, 1000)), ("modem_bcjr", (2, 1002))]
    assert lib.guards == [2]
    assert k.launches == 2


def test_launch_failure_raises_and_is_not_counted(lib):
    k = cuda.Kernel("modem_demod")
    k.launch(CUDA0)
    lib.rc = 98
    with pytest.raises(RuntimeError,
                       match=r"modem_demod: CUDA error 98 \(stand-in error\)"):
        k.launch(CUDA0)
    assert k.launches == 1
    lib.rc = 0
    k.launch(CUDA0)
    assert k.launches == 2


def test_launch_looks_up_again_in_a_new_library(lib, monkeypatch):
    k = cuda.Kernel("modem_tx")
    k.launch(CUDA0)
    other = _Lib()
    monkeypatch.setattr(cuda, "library", lambda: other)
    k.launch(CUDA0)
    assert lib.looked_up == ["modem_tx"] and other.looked_up == ["modem_tx"]
    assert len(other.calls) == 1 and k.launches == 2


def test_host_queries_is_a_library_function(lib):
    assert cuda.SIGNATURES["modem_host_queries"] == []
    assert cuda.host_queries() == 7


class _Fir:
    """Stands in for ``FIR_KERNEL``: reads what ``modem_fir`` would read at
    the pointers it is given and fills the output rows with x + 1."""

    def __init__(self):
        self.seen = []

    def launch(self, device, x, state, c, n, host, taps_dev, k, y):
        def read(ptr, count):
            return np.ctypeslib.as_array(
                (ctypes.c_float * count).from_address(ptr)).copy()
        xs = read(x, c * n).reshape(c, n)
        ss = None if state is None else read(state, c * (k - 1)).reshape(
            c, k - 1)
        self.seen.append({"x_ptr": x, "x": xs, "state": ss, "c": c, "n": n,
                          "host": host, "taps_dev": taps_dev, "k": k})
        out = np.ctypeslib.as_array((ctypes.c_float * (c * n)).from_address(y))
        out[:] = (xs + 1).reshape(-1)


def _forms(seed: int):
    g = np.random.default_rng(seed)
    base = torch.as_tensor(g.normal(size=(2, 3, 40)).astype(np.float32))
    return {
        "f32": base,
        "f64": base.double(),
        "strided": torch.as_tensor(g.normal(size=(2, 3, 80)).astype(
            np.float32))[..., ::2],
        "transposed": torch.as_tensor(g.normal(size=(40, 3, 2)).astype(
            np.float32)).permute(2, 1, 0),
    }


@pytest.mark.parametrize("form", ["f32", "f64", "strided", "transposed"])
@pytest.mark.parametrize("with_state", [False, True],
                         ids=["no_state", "state"])
@pytest.mark.parametrize("k", [13, 65, 300])
def test_fir_kernel_hands_modem_fir_its_arguments(monkeypatch, form,
                                                  with_state, k):
    """The rows of x (every dimension but the last) as contiguous float32,
    read in place where x already is; the state's rows likewise or null;
    the host taps on the short route, null on the long one; the device
    taps, their count and an output of x's shape that the launch fills."""
    monkeypatch.setattr(fir, "check_cuda", lambda *a: None)
    stub = _Fir()
    monkeypatch.setattr(fir, "FIR_KERNEL", stub)
    x = _forms(k)[form]
    taps = torch.as_tensor(np.hanning(k).astype(np.float32))
    state = None
    if with_state:
        state = torch.as_tensor(np.random.default_rng(k + 1).normal(
            size=(2, 3, 2 * (k - 1))))[..., ::2]  # float64, strided
    y = fir.fir_kernel(x, taps, state)
    (seen,) = stub.seen
    assert (seen["c"], seen["n"], seen["k"]) == (6, 40, k)
    np.testing.assert_array_equal(seen["x"],
                                  x.float().reshape(6, 40).numpy())
    if form == "f32":
        assert seen["x_ptr"] == x.data_ptr()  # no copy
    if with_state:
        np.testing.assert_array_equal(
            seen["state"], state.float().reshape(6, k - 1).numpy())
    else:
        assert seen["state"] is None
    short = fir.fir_route(k) != "long"
    assert seen["host"] == (cuda.host_taps(taps) if short else None)
    assert seen["taps_dev"] == taps.data_ptr()
    assert y.shape == x.shape and y.dtype == torch.float32
    assert torch.equal(y, x.float() + 1)


class _FirFirst(_Fir):
    """Stands in for ``FIR_FIRST_KERNEL`` (``modem_fir_long_first``: no
    host taps)."""

    def launch(self, device, x, state, c, n, taps_dev, k, y):
        super().launch(device, x, state, c, n, "none", taps_dev, k, y)


@pytest.mark.parametrize("with_state", [False, True],
                         ids=["no_state", "state"])
@pytest.mark.parametrize("k", [13, 300, fir.FIR_CORE_MAX_TAPS + 1])
def test_fir_kernel_first_hands_modem_fir_long_first_its_arguments(
        monkeypatch, with_state, k):
    """``first=True`` launches the first version of the long route at any
    tap count, with ``modem_fir``'s arguments but the host taps, and never
    ``modem_fir``; a state of another length goes over ``state ++ x``
    there too."""
    monkeypatch.setattr(fir, "check_cuda", lambda *a: None)
    stub, first = _Fir(), _FirFirst()
    monkeypatch.setattr(fir, "FIR_KERNEL", stub)
    monkeypatch.setattr(fir, "FIR_FIRST_KERNEL", first)
    x = _forms(k)["strided"]
    taps = torch.as_tensor(np.hanning(k).astype(np.float32))
    state = (torch.as_tensor(np.random.default_rng(k).normal(
        size=(2, 3, k - 1)).astype(np.float32)) if with_state else None)
    y = fir.fir_kernel(x, taps, state, first=True)
    (seen,) = first.seen
    assert not stub.seen
    assert (seen["c"], seen["n"], seen["k"], seen["host"]) == (6, 40, k,
                                                               "none")
    np.testing.assert_array_equal(seen["x"], x.reshape(6, 40).numpy())
    assert seen["taps_dev"] == taps.data_ptr()
    if with_state:
        np.testing.assert_array_equal(seen["state"],
                                      state.reshape(6, k - 1).numpy())
    else:
        assert seen["state"] is None
    assert torch.equal(y, x + 1)
    short = fir.fir_kernel(x, taps, torch.zeros(2, 3, 5), first=True)
    assert (first.seen[-1]["n"], first.seen[-1]["state"]) == (45, None)
    assert short.shape[-1] == max(0, 46 - k) and not stub.seen


def test_fir_kernel_refuses_a_state_of_the_wrong_length(monkeypatch):
    """A state whose rows are not x's is refused; one of another length
    than K-1 samples (as the JAX ``fir_filter`` takes it) is one launch over
    ``state ++ x`` with the null history, the outputs from K-1 on kept."""
    monkeypatch.setattr(fir, "check_cuda", lambda *a: None)
    stub = _Fir()
    monkeypatch.setattr(fir, "FIR_KERNEL", stub)
    with pytest.raises(ValueError, match="x's rows"):
        fir.fir_kernel(torch.zeros(2, 40), torch.ones(13), torch.zeros(3, 12))
    assert not stub.seen
    x, state = torch.arange(80.0).reshape(2, 40), -torch.ones(2, 11)
    y = fir.fir_kernel(x, torch.ones(13), state)
    (seen,) = stub.seen
    assert (seen["c"], seen["n"], seen["state"]) == (2, 51, None)
    assert torch.equal(y, torch.cat([state, x], -1)[:, 12:] + 1)


@pytest.mark.parametrize("t,device", [
    (torch.zeros(3), CUDA0),
    (torch.zeros(3, dtype=torch.float64), torch.device("cpu")),
    (torch.zeros(6)[::2], torch.device("cpu")),
])
def test_check_cuda_refuses_what_the_kernels_do_not_take(t, device):
    with pytest.raises(ValueError, match="contiguous torch.float32 CUDA"):
        cuda.check_cuda("x", t, torch.float32, device)


def test_as_taps_returns_float32_taps_on_the_device_as_they_are():
    taps = torch.ones(5)
    assert fir.as_taps(taps, torch.device("cpu")) is taps
    moved = fir.as_taps(taps.double(), torch.device("cpu"))
    assert moved.dtype == torch.float32 and torch.equal(moved, taps)


def _read(addr: int, n: int) -> np.ndarray:
    return np.ctypeslib.as_array(
        (ctypes.c_float * cuda.TAPS_PARAM).from_address(addr))[:n].copy()


def test_host_taps_refresh_after_an_in_place_change():
    """The hit path returns the kept copy; every in-place change makes a
    new one with the new values, for one tensor and for a tuple."""
    taps = torch.arange(9, dtype=torch.float32)
    table = torch.full((4,), 2.0)
    for parts in ((taps,), (taps, table)):
        addr = cuda.host_taps(*parts)
        assert cuda.host_taps(*parts) == addr
        for step in range(3):
            parts[-1].add_(1.0)
            addr = cuda.host_taps(*parts)
            np.testing.assert_array_equal(
                _read(addr, 13 if len(parts) == 2 else 9),
                torch.cat([p.reshape(-1) for p in parts]).numpy())
            assert cuda.host_taps(*parts) == addr
    with torch.inference_mode():
        frozen = torch.arange(5, dtype=torch.float32) + 0.0
    np.testing.assert_array_equal(_read(cuda.host_taps(frozen), 5),
                                  frozen.numpy())
