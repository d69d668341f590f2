"""Halo exchanges, prefix scans, reductions and the re-deal across the ranks
of one mesh dimension (counterpart of :mod:`modem_tpu.parallel.collectives`).

Every function takes the dimension's process group
(``mesh.get_group("time")``) and must be called by every rank of the group,
the edge ranks included. A rank's place along the dimension is its rank in
the group, which is its mesh coordinate (the groups list their ranks in
coordinate order). Ranks with no neighbour receive **zeros**, which is the
reference FIR's zero-initialized history (`fir.rs:12-15`) and the pulse
chain's zero flush. A group of one makes no call at all.

Transport: the group's own backend carries the tensors (NCCL: CUDA tensors
in place). A gloo group's CUDA tensors are copied to the host and back; the
choice is made from ``dist.get_backend(group)``.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def axis_size(group) -> int:
    """Ranks along the group's mesh dimension."""
    return dist.get_world_size(group)


def axis_index(group) -> int:
    """This rank's coordinate along the group's mesh dimension."""
    return dist.get_group_rank(group, dist.get_rank())


def _staged(x: torch.Tensor, group) -> bool:
    """True where the tensor goes through the host: a gloo group's CUDA
    tensor."""
    return x.is_cuda and dist.get_backend(group) == "gloo"


def _wire(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` as the transport takes it: contiguous, on the host if staged."""
    return (x.cpu() if _staged(x, group) else x).contiguous()


def _shift(send: torch.Tensor, group, step: int) -> torch.Tensor:
    """Each rank sends ``send`` to its neighbour ``step`` places along
    (``+1`` right, ``-1`` left) and returns what its other neighbour sent,
    or zeros at the edge. Edge ranks post one operation."""
    n, i = axis_size(group), axis_index(group)
    out = _wire(send, group)
    recv = torch.zeros_like(out)
    ops = []
    if 0 <= i + step < n:
        ops.append(dist.P2POp(dist.isend, out,
                              dist.get_global_rank(group, i + step), group))
    if 0 <= i - step < n:
        ops.append(dist.P2POp(dist.irecv, recv,
                              dist.get_global_rank(group, i - step), group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv.to(send.device)


def _halo_check(x: torch.Tensor, h: int) -> None:
    if not 0 <= h <= x.shape[-1]:
        raise ValueError(f"halo of {h} samples from a block of "
                         f"{x.shape[-1]}: a halo rides one hop")


def left_halo(x: torch.Tensor, h: int, group) -> torch.Tensor:
    """Each rank receives the *last* ``h`` samples of its left neighbour.

    ``x``: local block ``[..., n]``. Returns ``[..., h]``; coordinate 0 gets
    zeros."""
    _halo_check(x, h)
    tail = x[..., x.shape[-1] - h:]
    if axis_size(group) == 1 or h == 0:
        return torch.zeros_like(tail)
    return _shift(tail, group, +1)


def right_halo(x: torch.Tensor, h: int, group) -> torch.Tensor:
    """Each rank receives the *first* ``h`` samples of its right neighbour.

    Returns ``[..., h]``; the last rank gets zeros."""
    _halo_check(x, h)
    head = x[..., :h]
    if axis_size(group) == 1 or h == 0:
        return torch.zeros_like(head)
    return _shift(head, group, -1)


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """``[n_ranks, ...]``: every rank's ``x``, in coordinate order."""
    n = axis_size(group)
    w = _wire(x, group)
    parts = [torch.empty_like(w) for _ in range(n)]
    dist.all_gather(parts, w, group=group)
    return torch.stack(parts).to(x.device)


def exclusive_prefix(x: torch.Tensor, group) -> torch.Tensor:
    """Exclusive prefix sum of per-rank values along the dimension.

    ``x``: this rank's value ``[...]`` (e.g. its block's total phase
    increment). Coordinate ``d`` receives ``sum_{d' < d} x_{d'}``;
    coordinate 0 gets zeros. One gather of O(state) values and a masked
    sum, in ``x``'s dtype."""
    n = axis_size(group)
    if n == 1:
        return torch.zeros_like(x)
    allv = all_gather(x, group)
    mask = (torch.arange(n, device=x.device) < axis_index(group)).to(x.dtype)
    mask = mask.reshape((n,) + (1,) * x.ndim)
    return torch.sum(allv * mask, dim=0).to(x.dtype)


def _reduce(x: torch.Tensor, group, op) -> torch.Tensor:
    if axis_size(group) == 1:
        return x.clone()
    w = _wire(x, group)
    if w is x:
        w = x.clone()
    dist.all_reduce(w, op=op, group=group)
    return w.to(x.device)


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of ``x`` over the dimension's ranks, on every rank."""
    return _reduce(x, group, dist.ReduceOp.SUM)


def pmax(x: torch.Tensor, group) -> torch.Tensor:
    """Elementwise maximum of ``x`` over the dimension's ranks."""
    return _reduce(x, group, dist.ReduceOp.MAX)


def all_to_all(x: torch.Tensor, group, split_axis: int,
               concat_axis: int) -> torch.Tensor:
    """The tiled all-to-all of a 2-D block: ``x`` is cut into ``n`` equal
    pieces along ``split_axis``, piece ``j`` goes to coordinate ``j``, and
    the pieces a rank receives are joined along ``concat_axis`` in the
    order of their senders (``jax.lax.all_to_all(..., tiled=True)``)."""
    if x.ndim != 2 or {split_axis, concat_axis} != {0, 1}:
        raise ValueError("all_to_all re-deals a 2-D block between its axes")
    n = axis_size(group)
    if x.shape[split_axis] % n:
        raise ValueError(f"axis {split_axis} of length "
                         f"{x.shape[split_axis]} does not divide by {n}")
    if n == 1:
        return x.clone()
    a, b = x.shape
    if split_axis == 0:  # [n, a/n, b]: piece j is rows j*a/n ..
        pieces = x.reshape(n, a // n, b)
    else:                # [n, a, b/n]: piece j is columns j*b/n ..
        pieces = x.reshape(a, n, b // n).permute(1, 0, 2)
    send = _wire(pieces, group)
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    recv = recv.to(x.device)   # recv[i]: the piece from coordinate i
    if concat_axis == 1:
        return recv.permute(1, 0, 2).reshape(a // n, n * b)
    return recv.reshape(n * a, b // n)
