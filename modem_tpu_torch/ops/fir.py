"""Causal FIR filter (counterpart of :mod:`modem_tpu.ops.fir` with its
``direct`` backend, and of :func:`modem_tpu.ops.pallas_fir.pallas_fir`):
kernel K4, in ``modem_tpu_torch/csrc/fir.cu``.

``y[n] = sum_j taps[j] * x[n-j]`` with zero initial history (the reference's
`fir.rs:10-34`), as a block transform over ``[..., n]`` tensors with an
explicit ``taps-1``-sample tail carried between blocks. :func:`fir_filter`
takes a CPU tensor to :func:`fir_plain` and a CUDA tensor to
:func:`fir_kernel`, never to the plain version. :func:`fir_route` says which
of the kernel's routes a tap count takes. The JAX package's ``conv``,
``matmul`` and ``fft`` backends are not ported yet.
"""

from __future__ import annotations

import math

import torch

from ..cuda import TAPS_PARAM, Kernel, check_cuda, host_taps

FIR_KERNEL = Kernel("modem_fir")

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


def as_taps(taps, device) -> torch.Tensor:
    """1-D float32 filter taps on ``device``."""
    t = torch.as_tensor(taps, dtype=torch.float32, device=device)
    if t.ndim != 1:
        raise ValueError("taps must be 1-D")
    return t


def fir_init_state(taps, batch_shape: tuple[int, ...] = (),
                   device=None) -> torch.Tensor:
    """Zero history of ``taps-1`` samples (matches `fir.rs:12-15`)."""
    return torch.zeros(batch_shape + (len(taps) - 1,), dtype=torch.float32,
                       device=device)


def fir_filter(x: torch.Tensor, taps, state: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Causal FIR: returns ``(y, new_state)`` with ``y.shape == x.shape``.

    ``state`` is the previous block's last ``K-1`` samples (zeros if None,
    matching the reference's fresh-filter behavior); ``new_state`` is the
    last ``K-1`` samples of ``state ++ x``. A 1-tap filter is a scale with
    an empty state. On CUDA the kernel takes up to :data:`FIR_MAX_TAPS`
    taps and raises ``ValueError`` beyond.
    """
    taps = as_taps(taps, x.device)
    k = taps.shape[0]
    if state is None:
        state = torch.zeros(x.shape[:-1] + (k - 1,), dtype=x.dtype,
                            device=x.device)
    if k == 1:
        return taps[0] * x, state
    n = x.shape[-1]
    new_state = (x[..., n - (k - 1):] if n >= k - 1
                 else torch.cat([state[..., n:], x], dim=-1)).contiguous()
    run = fir_kernel if x.is_cuda else fir_plain
    return run(x, taps, state), new_state


def fir_plain(x: torch.Tensor, taps: torch.Tensor,
              state: torch.Tensor) -> torch.Tensor:
    """Plain version of K4: ``y[n] = sum_j taps[j] * xp[n + K-1 - j]`` over
    ``xp = state ++ x``, K shifted multiply-adds in order of ``j``."""
    k = taps.shape[0]
    xp = torch.cat([state, x], dim=-1)
    n = x.shape[-1]
    y = torch.zeros(x.shape, dtype=xp.dtype, device=xp.device)
    for j in range(k):
        y = y + taps[j] * xp[..., k - 1 - j: k - 1 - j + n]
    return y


def fir_kernel(x: torch.Tensor, taps: torch.Tensor,
               state: torch.Tensor) -> torch.Tensor:
    """Launch K4 (``modem_fir``) on CUDA tensors, by :func:`fir_route`'s
    route; the history is read from ``state`` in place."""
    k = taps.shape[0]
    route = fir_route(k)
    if state.shape[:-1] != x.shape[:-1]:
        raise ValueError("state and x differ in batch shape")
    dev = x.device
    c, n = math.prod(x.shape[:-1]), x.shape[-1]
    fx = x.to(torch.float32).reshape(c, n).contiguous()
    fs = state.to(torch.float32).reshape(c, k - 1).contiguous()
    for name, t in (("x", fx), ("state", fs), ("taps", taps)):
        check_cuda(name, t, torch.float32, dev)
    y = torch.empty_like(fx)
    if y.numel():
        host = None if route == "long" else host_taps(taps)
        FIR_KERNEL.launch(dev, fx.data_ptr(), fs.data_ptr(), fx.shape[0], n,
                          host, taps.data_ptr(), k, y.data_ptr())
    return y.reshape(x.shape)
