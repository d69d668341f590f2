"""Polar CA-SCL list decoding with a list of 8 over whole codewords
(counterpart of :mod:`modem_tpu.ops.pallas_scl`): kernel K16, in
``modem_tpu_torch/csrc/polar.cu``.

:func:`scl_decode` takes a code (:class:`~modem_tpu_torch.fec.PolarCode`)
and channel LLRs ``[B, n]`` and returns the 8 surviving paths'
post-selection decisions ``u [B, 8, n]`` uint8 in list order and their
metrics ``pm [B, 8]`` f32 (smaller is better), the paths sorted at the last
info leaf by ``(metric, candidate index)`` as ``lax.top_k`` orders them. A
CUDA tensor of a code K16 holds (``2 <= n <= 1024``) at a list of 8
launches it (:data:`SCL_KERNEL`); a CPU tensor, another list size or a
longer code runs the plain version (:func:`scl_plain`: ``PolarCode._scl``
over the whole tree). The two agree bit for bit, decisions and metrics. The CRC test and the choice of the
winner stay with ``PolarCode.decode_list``.
"""

from __future__ import annotations

import torch

from ..cuda import Kernel, check_cuda
from .sc_kernel import MAX_N, frozen_mask, kernel_fits

SCL_KERNEL = Kernel("modem_polar_scl")
L = 8  # the kernel's list size


def scl_decode(code, lam: torch.Tensor, list_size: int = L):
    """SCL over ``lam [B, n]`` f32 -> ``(u [B, list_size, n] uint8, pm [B,
    list_size] f32)``."""
    lam = lam.to(torch.float32)
    if lam.is_cuda and list_size == L and kernel_fits(code.n):
        return scl_kernel(code, lam)
    return scl_plain(code, lam, list_size)


def scl_plain(code, lam: torch.Tensor, list_size: int = L):
    """Plain version of K16: ``PolarCode._scl`` over the whole tree from
    path 0 alive (metric 0) and ``list_size - 1`` clones (``2 * _BIG``)."""
    b = lam.shape[0]
    u, _, pm, _ = code._scl(lam.reshape(b, 1, code.n), 0, code.n,
                            code.initial_metrics(b, list_size, lam.device),
                            list_size)
    return u.expand(b, list_size, code.n).to(torch.uint8), pm


def scl_kernel(code, lam: torch.Tensor):
    """Launch K16 (``modem_polar_scl``) on CUDA LLRs ``[B, n]``, a warp (a
    block) a codeword."""
    dev = lam.device
    lam = lam.contiguous()
    check_cuda("lam", lam, torch.float32, dev)
    if lam.dim() != 2 or lam.shape[1] != code.n or not kernel_fits(code.n):
        raise ValueError(f"scl_kernel: need [B, {code.n}] LLRs with 2 <= n "
                         f"<= {MAX_N}, got {tuple(lam.shape)}")
    b = lam.shape[0]
    u = torch.empty((b, L, code.n), dtype=torch.uint8, device=dev)
    pm = torch.empty((b, L), dtype=torch.float32, device=dev)
    if b:
        SCL_KERNEL.launch(dev, lam.data_ptr(), b, code.n, code.n_bits,
                          frozen_mask(code, dev).data_ptr(), u.data_ptr(),
                          pm.data_ptr())
    return u, pm
