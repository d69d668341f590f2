"""Causal FIR filtering engine (counterpart of :mod:`modem_tpu.ops.fir`,
and of :func:`modem_tpu.ops.pallas_fir.pallas_fir`): kernel K4, in
``modem_tpu_torch/csrc/fir.cu``, and the JAX package's other backends.

``y[n] = sum_j taps[j] * x[n-j]`` with zero initial history (the reference's
`fir.rs:10-34`), as a block transform over ``[..., n]`` tensors with an
explicit ``taps-1``-sample tail carried between blocks. :func:`fir_filter`
takes one of :data:`BACKENDS`:

* ``direct``: K4 on a CUDA tensor (:func:`fir_kernel`), its plain version
  :func:`fir_plain` on a CPU one, never the plain version on the card;
  :func:`fir_route` says which of the kernel's routes a tap count takes,
  and :func:`fir_long_route` which kernel the long route runs;
* ``conv``: one ``conv1d`` with the reversed taps (cuDNN on the card);
* ``matmul``: the signal framed into overlapping windows times a banded
  Toeplitz bank, one ``torch.matmul``;
* ``fft``: chunked overlap-save, ``torch.fft.rfft``/``irfft`` over windows
  whose size is bounded by the tap count, not by the block.

The last three are the same PyTorch ops on either device, in float32 with
TF32 off whatever the caller's global settings (:func:`_f32_math`); what
they derive from the taps (the reversed taps, the bank, the taps'
transform) is made on the host once per taps tensor and kept on its device.
All four agree up to float32 reassociation.
"""

from __future__ import annotations

import contextlib
import math
import weakref

import numpy as np
import torch
import torch.nn.functional as F

from ..cuda import TAPS_PARAM, Kernel, check_cuda, host_taps

BACKENDS = ("direct", "conv", "matmul", "fft")

FIR_KERNEL = Kernel("modem_fir")
#: the long route's first version forced at any tap count
#: (``fir_kernel(..., first=True)``), for comparisons
FIR_FIRST_KERNEL = Kernel("modem_fir_long_first")

#: outputs per block of the long route (``fir_tile.cuh``'s ``kFirTile``)
_TILE = 2048
#: the tap counts the short route has compiled instantiations for
#: (``csrc/fir.cu``, ``modem_fir``): the Hilbert filter, the GMSK transient,
#: the demodulator's lowpass, the RRC
FIR_FIXED_TAPS = (23, 32, 64, 65)


def _padded(n: int) -> int:
    return n + (n >> 3) + 1


def fir_smem_bytes(k: int) -> int:
    """Shared memory a block of the long route takes for ``k`` taps
    (``fir.cu``)."""
    return 4 * (-(-k // 4) * 4 + _padded(_TILE + k - 1) + _padded(_TILE))


#: the most taps whose tile fits a block's shared memory on the long route
FIR_MAX_TAPS = 25176

#: outputs a tile of the long core (``fir.cu``'s ``kLongTile``: 32 a thread,
#: 128 threads)
_CORE_TILE = 4096


def _skew_len(n: int) -> int:
    """Floats of a skewed buffer of ``n`` samples (``common.cuh``)."""
    n32 = (n + 31) & ~31
    return n32 + n32 // 8


def fir_core_smem_bytes(k: int) -> int:
    """Shared memory a block of the long core takes for ``k`` taps
    (``fir.cu``'s ``long_core_smem``): the taps in whole chunks of 16 and
    two buffers of a tile and its history after a lead that puts the tile's
    first sample at a multiple of 32 (the outputs are staged in the buffer
    just filtered)."""
    lead = ((1 - k) & 31) + 32
    return 4 * (-(-k // 16) * 16 + 2 * _skew_len(lead + k - 1 + _CORE_TILE))


#: the most taps the long core takes (its block fits shared memory); the
#: first version takes the counts past it, to :data:`FIR_MAX_TAPS`
FIR_CORE_MAX_TAPS = 15009


def fir_route(k: int) -> str:
    """The route of K4 for ``k`` taps: ``"fixed"`` (a compiled
    instantiation, :data:`FIR_FIXED_TAPS`), ``"generic"`` (any other count
    up to ``TAPS_PARAM``; on both the taps travel by value in a kernel
    parameter) or ``"long"`` (up to :data:`FIR_MAX_TAPS`, the taps read
    from the device). Raises ``ValueError`` past that."""
    if k < 1 or k > FIR_MAX_TAPS:
        raise ValueError(f"the FIR kernel takes 1 to at most {FIR_MAX_TAPS} "
                         f"taps, got {k}")
    if k in FIR_FIXED_TAPS:
        return "fixed"
    return "generic" if k <= TAPS_PARAM else "long"


def fir_long_route(k: int) -> str:
    """The kernel K4's long route (the taps read from the device) runs for
    ``k`` taps: ``"core"`` (``fir_long_core``, up to
    :data:`FIR_CORE_MAX_TAPS`) or ``"first"`` (the first version,
    ``fir_long_kernel``, to :data:`FIR_MAX_TAPS`). Raises ``ValueError``
    past that."""
    fir_route(k)
    return "core" if k <= FIR_CORE_MAX_TAPS else "first"


#: numpy taps as device tensors, by their bytes and device (off the CPU,
#: where ``torch.as_tensor`` of numpy copies): a filter's taps cross to the
#: card once, not at every call, and keep one host copy in ``host_taps``
_DEVICE_TAPS: dict[tuple, tuple] = {}
#: (id of a taps tensor, what) -> (weak reference, version, tensor): the
#: tables the conv, matmul and fft backends derive from the taps
_DERIVED: dict[tuple, tuple] = {}
_CACHE_CAP = 64


def _bounded(store: dict) -> None:
    """Make room in a cache of at most :data:`_CACHE_CAP` entries."""
    if len(store) >= _CACHE_CAP:
        del store[next(iter(store))]


def as_taps(taps, device) -> torch.Tensor:
    """1-D float32 filter taps on ``device``. Host taps (numpy, lists) made
    into a tensor off the CPU are kept by value, so the same taps give the
    same tensor again without a copy to the device. A float32 tensor
    already on ``device`` is returned as it is, with no dispatch."""
    if isinstance(taps, torch.Tensor):
        t = (taps if taps.dtype is torch.float32 and taps.device == device
             else taps.to(device=device, dtype=torch.float32))
    else:
        a = np.asarray(taps, np.float32)
        dev = torch.device("cpu" if device is None else device)
        if dev.type == "cpu" or a.ndim != 1:
            t = torch.as_tensor(a, device=dev)
        else:
            key = (a.tobytes(), dev)
            hit = _DEVICE_TAPS.get(key)
            if hit is not None and hit[0]._version == hit[1]:
                return hit[0]
            _bounded(_DEVICE_TAPS)
            t = torch.as_tensor(a, device=dev)
            _DEVICE_TAPS[key] = (t, t._version)
    if t.ndim != 1:
        raise ValueError("taps must be 1-D")
    return t


def check_backend(backend: str) -> None:
    """Raise ``ValueError`` for a name not in :data:`BACKENDS`."""
    if backend not in BACKENDS:
        raise ValueError(
            f"unknown FIR backend {backend!r}; choose from {BACKENDS}")


def fir_init_state(taps, batch_shape: tuple[int, ...] = (),
                   device=None) -> torch.Tensor:
    """Zero history of ``taps-1`` samples (matches `fir.rs:12-15`)."""
    return torch.zeros(batch_shape + (len(taps) - 1,), dtype=torch.float32,
                       device=device)


def fir_filter(x: torch.Tensor, taps, state: torch.Tensor | None = None,
               backend: str = "direct") -> tuple[torch.Tensor, torch.Tensor]:
    """Causal FIR: returns ``(y, new_state)``, ``y`` of ``x``'s shape where
    ``state`` is None or has ``K-1`` samples.

    ``state`` is the previous block's last ``K-1`` samples (zeros if None,
    matching the reference's fresh-filter behavior); ``new_state`` is the
    last ``K-1`` samples of ``xp = state ++ x``, a view of ``x`` where it
    holds them (a caller that refills ``x`` in place clones it). A state of
    another length is taken as the JAX package takes it, by every backend
    on either device: ``y`` runs over ``xp``, ``n + len(state) - (K-1)``
    samples. ``backend`` is one of :data:`BACKENDS`. A 1-tap ``direct``
    filter is a scale with an empty state. On CUDA K4 takes up to
    :data:`FIR_MAX_TAPS` taps and raises ``ValueError`` beyond.
    """
    check_backend(backend)
    taps = as_taps(taps, x.device)
    k = taps.shape[0]
    n = x.shape[-1]
    if k == 1:
        new_state = (x.new_zeros(x.shape[:-1] + (0,)) if state is None
                     else state)
    elif n >= k - 1:
        new_state = x[..., n - (k - 1):]
    elif state is None:
        new_state = F.pad(x, (k - 1 - n, 0))
    else:
        new_state = torch.cat([state, x], dim=-1)
        new_state = new_state[..., new_state.shape[-1] - (k - 1):]
    if backend == "direct":
        if k == 1:
            return taps[0] * x, new_state
        run = fir_kernel if x.is_cuda else fir_plain
        return run(x, taps, state), new_state
    xp = (F.pad(x, (k - 1, 0)) if state is None or k == 1
          else torch.cat([state, x], dim=-1)).to(torch.float32)
    if xp.shape[-1] == k - 1:
        return xp[..., k - 1:], new_state
    run = {"conv": _fir_conv, "matmul": _fir_matmul, "fft": _fir_fft}[backend]
    return run(xp, taps), new_state


def fir_plain(x: torch.Tensor, taps: torch.Tensor,
              state: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of K4: ``y[n] = sum_j taps[j] * xp[n + K-1 - j]`` over
    ``xp = state ++ x`` (zeros for ``state=None``), K shifted multiply-adds
    in order of ``j``: ``len(xp) - (K-1)`` outputs."""
    k = taps.shape[0]
    xp = (F.pad(x, (k - 1, 0)) if state is None
          else torch.cat([state, x], dim=-1))
    n = xp.shape[-1] - (k - 1)
    y = torch.zeros(xp.shape[:-1] + (n,), dtype=xp.dtype, device=xp.device)
    for j in range(k):
        y = y + taps[j] * xp[..., k - 1 - j: k - 1 - j + n]
    return y


def _f32_rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the contiguous float32 rows K4 reads: ``t`` itself where it
    already is, else a copy."""
    if t.dtype is torch.float32 and t.is_contiguous():
        return t
    return t.to(torch.float32).contiguous()


def fir_kernel(x: torch.Tensor, taps: torch.Tensor,
               state: torch.Tensor | None = None,
               first: bool = False) -> torch.Tensor:
    """Launch K4 (``modem_fir``) on CUDA tensors, by :func:`fir_route`'s
    route, over ``x``'s rows (every dimension but the last); the history is
    read from ``state`` in place (made contiguous float32 first where it is
    not), and ``state=None`` is a zero history that the kernel makes
    itself. A float32 contiguous ``x`` is read in place too. A state of
    another length than ``K-1`` is one launch over ``xp = state ++ x`` with
    the zero history, its outputs from ``K-1`` on kept: ``len(xp) - (K-1)``
    of them, as :func:`fir_plain`. ``first`` runs the long route's first
    version (``modem_fir_long_first``) whatever the tap count, for
    comparisons."""
    k = taps.shape[0]
    route = fir_route(k)
    if state is not None and state.shape[:-1] != x.shape[:-1]:
        raise ValueError(f"state must have x's rows, got "
                         f"{tuple(state.shape)} for x {tuple(x.shape)}")
    if state is not None and state.shape[-1] != k - 1:
        return fir_kernel(torch.cat([state, x], dim=-1), taps,
                          first=first)[..., k - 1:]
    dev = x.device
    fx = _f32_rows(x)
    check_cuda("x", fx, torch.float32, dev)
    check_cuda("taps", taps, torch.float32, dev)
    fs = None
    if state is not None:
        fs = _f32_rows(state)
        check_cuda("state", fs, torch.float32, dev)
    y = torch.empty_like(fx)
    if y.numel():
        n = x.shape[-1]
        st = None if fs is None else fs.data_ptr()
        if first:
            FIR_FIRST_KERNEL.launch(dev, fx.data_ptr(), st, y.numel() // n, n,
                                    taps.data_ptr(), k, y.data_ptr())
        else:
            host = None if route == "long" else host_taps(taps)
            FIR_KERNEL.launch(dev, fx.data_ptr(), st, y.numel() // n, n,
                              host, taps.data_ptr(), k, y.data_ptr())
    return y


# ---- the conv, matmul and fft backends ----

@contextlib.contextmanager
def _f32_math():
    """cuDNN's and cuBLAS's float32 arithmetic without TF32 for the block
    (the counterpart of JAX's ``Precision.HIGHEST``; cuDNN's convolutions
    use TF32 by default), the caller's settings restored after it."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def _derived(taps: torch.Tensor, what, make, dtype: torch.dtype
             ) -> torch.Tensor:
    """``make(host taps)`` (a numpy array) as a ``dtype`` tensor on the taps'
    device, made once per taps tensor and ``what`` while the tensor lives
    and is not modified in place (its version counter; an inference tensor,
    which has none, makes it at every call)."""
    key = (id(taps), what)
    version = None if taps.is_inference() else taps._version
    hit = _DERIVED.get(key)
    if (version is not None and hit is not None and hit[0]() is taps
            and hit[1] == version):
        return hit[2]
    for dead in [k for k, v in _DERIVED.items() if v[0]() is None]:
        del _DERIVED[dead]
    _bounded(_DERIVED)
    host = taps.detach().cpu().numpy().astype(np.float32)
    t = torch.as_tensor(np.asarray(make(host)), dtype=dtype,
                        device=taps.device)
    _DERIVED[key] = (weakref.ref(taps), version, t)
    return t


def _fir_conv(xp: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """``conv1d`` (a cross-correlation) of ``xp [..., K-1+n]`` with the
    reversed taps, valid padding: ``[B, 1, W]`` in, ``[B, 1, n]`` out."""
    k = taps.shape[0]
    w = _derived(taps, "reversed", lambda t: t[::-1].reshape(1, 1, k).copy(),
                 torch.float32)
    with _f32_math():
        y = F.conv1d(xp.reshape(-1, 1, xp.shape[-1]), w)
    return y.reshape(xp.shape[:-1] + (y.shape[-1],))


def _toeplitz_bank(taps: np.ndarray, block: int) -> np.ndarray:
    """``[block + K - 1, block]`` banded matrix ``T`` with ``T[j + i, i] =
    taps[K-1-j]``: ``window @ T`` is ``block`` consecutive causal FIR
    outputs from a window of ``block + K - 1`` inputs."""
    t = np.asarray(taps, np.float32)
    k = t.shape[0]
    m = np.zeros((block + k - 1, block), np.float32)
    for i in range(block):
        m[i: i + k, i] = t[::-1]
    return m


def _fir_matmul(xp: torch.Tensor, taps: torch.Tensor,
                block: int = 256) -> torch.Tensor:
    """``xp`` framed into ``[n/block, block + K - 1]`` overlapping windows
    times the Toeplitz bank, one float32 ``torch.matmul``."""
    k = taps.shape[0]
    n = xp.shape[-1] - (k - 1)
    nb = -(-n // block)
    xp = F.pad(xp, (0, nb * block - n))
    bank = _derived(taps, ("toeplitz", block),
                    lambda t: _toeplitz_bank(t, block), torch.float32)
    windows = xp.unfold(-1, block + k - 1, block)  # [..., nb, block + K - 1]
    with _f32_math():
        y = torch.matmul(windows, bank)
    return y.reshape(xp.shape[:-1] + (nb * block,))[..., :n]


def _fir_fft(xp: torch.Tensor, taps: torch.Tensor,
             fft_n: int | None = None) -> torch.Tensor:
    """Chunked overlap-save: ``xp`` framed into overlapping ``fft_n``-sample
    windows stepping by ``fft_n - (K-1)``, each one fast-convolved, the
    valid parts joined. ``fft_n`` is bounded by the taps (default: the
    smallest power of two >= 8*K, at least 256), never by the block."""
    k = taps.shape[0]
    n = xp.shape[-1] - (k - 1)
    if fft_n is None:
        fft_n = 1 << max(int(math.ceil(math.log2(max(8 * k, 256)))), 4)
    if fft_n < 2 * k:
        raise ValueError(f"fft_n={fft_n} too small for {k} taps (need >= 2K)")
    tf = _derived(taps, ("rfft", fft_n),
                  lambda t: np.fft.rfft(t, n=fft_n).astype(np.complex64),
                  torch.complex64)
    step = fft_n - (k - 1)  # valid outputs a window
    if n <= step:
        y = torch.fft.irfft(torch.fft.rfft(xp, n=fft_n) * tf, n=fft_n)
        return y[..., k - 1: k - 1 + n]
    nb = -(-n // step)
    xp = F.pad(xp, (0, nb * step + (k - 1) - xp.shape[-1]))
    # window b covers xp[b*step : b*step + fft_n] (K-1 overlap: the "save")
    frames = xp.unfold(-1, fft_n, step)  # [..., nb, fft_n]
    yf = torch.fft.irfft(torch.fft.rfft(frames, n=fft_n) * tf, n=fft_n)
    return yf[..., k - 1:].reshape(xp.shape[:-1] + (nb * step,))[..., :n]
