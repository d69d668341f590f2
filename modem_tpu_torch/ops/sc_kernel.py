"""Polar successive-cancellation decoding of whole codewords (counterpart of
:mod:`modem_tpu.ops.pallas_sc`): kernel K15, in
``modem_tpu_torch/csrc/polar.cu``.

:func:`sc_decode` takes a code (:class:`~modem_tpu_torch.fec.PolarCode`)
and channel LLRs ``[B, n]`` and returns the SC decisions ``u`` and the
re-encoded partial sums ``x``, each ``[B, n]`` uint8. A CUDA tensor of a
code the kernel holds (:func:`kernel_fits`: ``2 <= n <= 1024``, the JAX
chip route's range) launches K15 (:data:`SC_KERNEL`), its frozen mask a
runtime array; a CPU tensor, or a longer code on either device, runs the
plain version (:func:`sc_plain`: ``PolarCode._sc``'s recursion), as the
JAX package leaves those codes to XLA on its chip. The two decide bit for
bit alike.
"""

from __future__ import annotations

import numpy as np
import torch

from ..cuda import Kernel, check_cuda
from ..utils.cache import on_device

SC_KERNEL = Kernel("modem_polar_sc")
#: the longest code the kernels take (shared memory of the SCL kernel)
MAX_N = 1024


def kernel_fits(n: int) -> bool:
    """Whether K15 (and K16) take a code of length ``n``."""
    return 2 <= n <= MAX_N


def frozen_mask(code, device) -> torch.Tensor:
    """The code's frozen mask as a uint8 ``[n]`` tensor on ``device``."""
    return on_device(code, "frozen", lambda: code.frozen.astype(np.uint8),
                     torch.uint8, device)


def sc_decode(code, lam: torch.Tensor):
    """SC over ``lam [B, n]`` f32 -> ``(u, x)`` uint8 ``[B, n]``."""
    run = (sc_kernel if lam.is_cuda and kernel_fits(code.n) else sc_plain)
    return run(code, lam.to(torch.float32))


def sc_plain(code, lam: torch.Tensor):
    """Plain version of K15: ``PolarCode._sc`` over the whole tree."""
    u, x = code._sc(lam, 0, code.n)
    return u.to(torch.uint8), x.to(torch.uint8)


def sc_kernel(code, lam: torch.Tensor):
    """Launch K15 (``modem_polar_sc``) on CUDA LLRs ``[B, n]``, a warp a
    codeword."""
    dev = lam.device
    lam = lam.contiguous()
    check_cuda("lam", lam, torch.float32, dev)
    if lam.dim() != 2 or lam.shape[1] != code.n or not kernel_fits(code.n):
        raise ValueError(f"sc_kernel: need [B, {code.n}] LLRs with 2 <= n "
                         f"<= {MAX_N}, got {tuple(lam.shape)}")
    b = lam.shape[0]
    u = torch.empty((b, code.n), dtype=torch.uint8, device=dev)
    x = torch.empty((b, code.n), dtype=torch.uint8, device=dev)
    if b:
        SC_KERNEL.launch(dev, lam.data_ptr(), b, code.n, code.n_bits,
                         frozen_mask(code, dev).data_ptr(), u.data_ptr(),
                         x.data_ptr())
    return u, x
