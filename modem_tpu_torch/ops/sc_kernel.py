"""Polar successive-cancellation decoding of whole codewords (counterpart of
:mod:`modem_tpu.ops.pallas_sc`): kernel K15, in
``modem_tpu_torch/csrc/polar.cu``.

:func:`sc_decode` takes a code (:class:`~modem_tpu_torch.fec.PolarCode`)
and channel LLRs ``[B, n]`` and returns the SC decisions ``u`` and the
re-encoded partial sums ``x``, each ``[B, n]`` uint8. A CUDA tensor of a
code the kernel holds (:func:`kernel_fits`: ``2 <= n <= 1024``, the JAX
chip route's range) launches K15 (:data:`SC_KERNEL`); a CPU tensor, or a
longer code on either device, runs the plain version (:func:`sc_plain`:
``PolarCode._sc``'s recursion), as the JAX package leaves those codes to
XLA on its chip. The two decide bit for bit alike.

K15 walks only what can change an output. A subtree whose leaves are all
frozen decides 0 at every leaf whatever its LLRs, and re-encodes to x = 0,
so none of its f's and g's is computed: :func:`skip_plan` lists the
maximal such subtrees, :func:`plan_codes` marks them leaf by leaf, and
:func:`host_plan` packs the marks into the kernel's ``ScPlan`` parameter
(passed by value, built once per code). The JAX kernel skips the same
subtrees (their x stays ``None`` at trace time).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..cuda import Kernel, check_cuda
from ..utils.cache import on_device

SC_KERNEL = Kernel("modem_polar_sc")
#: the longest code the kernels take (shared memory of the SCL kernel)
MAX_N = 1024
#: :func:`plan_codes`' mark of an information leaf (a step of one leaf) and
#: of a leaf inside a skipped subtree past its first (never a step's start)
INFO, INSIDE = 15, 14


class _ScPlan(ctypes.Structure):
    """``csrc/polar.cu``'s ``ScPlan``: ``w``, :func:`plan_codes` at 4 bits
    a leaf (leaf i in bits ``4 (i % 8)`` of word ``i // 8``); ``info``, the
    information leaves (leaf i in bit ``i % 32`` of word ``i // 32``)."""
    _fields_ = [("w", ctypes.c_uint * (MAX_N // 8)),
                ("info", ctypes.c_uint * (MAX_N // 32))]


def kernel_fits(n: int) -> bool:
    """Whether K15 (and K16) take a code of length ``n``."""
    return 2 <= n <= MAX_N


def frozen_mask(code, device) -> torch.Tensor:
    """The code's frozen mask as a uint8 ``[n]`` tensor on ``device``."""
    return on_device(code, "frozen", lambda: code.frozen.astype(np.uint8),
                     torch.uint8, device)


def skip_plan(frozen) -> list[tuple[int, int]]:
    """The maximal all-frozen subtrees of the SC tree over the mask
    ``frozen [n]``, as ``(first leaf, leaves)`` in leaf order: left to
    right, the widest aligned all-frozen block starting at each leaf the
    walk reaches (a leaf is its own block of one)."""
    frozen = np.asarray(frozen, bool)
    n, i, out = frozen.size, 0, []
    while i < n:
        w = i & -i or n  # the widest node whose first leaf is i
        while w and not frozen[i:i + w].all():
            w >>= 1
        if w:
            out.append((i, w))
        i += w or 1
    return out


def plan_codes(frozen) -> np.ndarray:
    """The walk's step at each leaf, uint8 ``[n]``: :data:`INFO` an
    information leaf, ``t`` the first leaf of a skipped subtree of ``2^t``
    leaves, :data:`INSIDE` the rest of such a subtree."""
    codes = np.full(np.asarray(frozen).size, INFO, np.uint8)
    for lo, w in skip_plan(frozen):
        codes[lo:lo + w] = INSIDE
        codes[lo] = w.bit_length() - 1
    return codes


def pack_bits(values, width: int) -> list[int]:
    """``values`` (each below ``2^width``) packed ``32 // width`` to a
    32-bit word, the first in the lowest bits, into :data:`MAX_N` ``*
    width // 32`` words."""
    v = np.zeros(MAX_N, np.uint32)
    v[:len(values)] = values
    per = 32 // width
    shifts = (width * np.arange(per)).astype(np.uint32)
    return (v.reshape(-1, per) << shifts).sum(axis=1, dtype=np.uint32
                                              ).tolist()


def host_plan(code) -> int:
    """The address of the code's ``ScPlan`` (:func:`plan_codes` and the
    information leaves, packed), built at the first call and kept on the
    code."""
    plan = code.__dict__.get("_sc_plan")
    if plan is None:
        plan = code.__dict__["_sc_plan"] = _ScPlan()
        plan.w[:] = pack_bits(plan_codes(code.frozen), 4)
        plan.info[:] = pack_bits(~np.asarray(code.frozen, bool), 1)
    return ctypes.addressof(plan)


def sc_decode(code, lam: torch.Tensor):
    """SC over ``lam [B, n]`` f32 -> ``(u, x)`` uint8 ``[B, n]``."""
    run = (sc_kernel if lam.is_cuda and kernel_fits(code.n) else sc_plain)
    return run(code, lam.to(torch.float32))


def sc_plain(code, lam: torch.Tensor):
    """Plain version of K15: ``PolarCode._sc`` over the whole tree."""
    u, x = code._sc(lam, 0, code.n)
    return u.to(torch.uint8), x.to(torch.uint8)


def sc_kernel(code, lam: torch.Tensor):
    """Launch K15 (``modem_polar_sc``) on CUDA LLRs ``[B, n]``, eight
    codewords a warp."""
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
                         host_plan(code), u.data_ptr(), x.data_ptr())
    return u, x
