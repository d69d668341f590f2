"""Numeric sanity and shard-consistency checks (counterpart of
:mod:`modem_tpu.debug`).

The useful checks are numeric (NaN/Inf creeping through a filter chain) and
at the distributed boundaries (regions that neighbouring ranks compute
twice must agree bit for bit: the overlap-save seams are where the
off-by-one bugs live).
"""

from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh


def _leaves(tree):
    if torch.is_tensor(tree):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)


def finite_fraction(tree) -> torch.Tensor:
    """Fraction of finite elements over the floating-point tensors of a
    tensor or a nested tuple, list or dict of them (1.0: all finite), a
    float32 scalar on the CPU."""
    leaves = [t for t in _leaves(tree) if t.is_floating_point()]
    if not leaves:
        return torch.tensor(1.0)
    tot = sum(t.numel() for t in leaves)
    fin = sum(int(torch.isfinite(t).sum()) for t in leaves)
    return torch.tensor(fin / tot if tot else 1.0, dtype=torch.float32)


def assert_finite(tree, name: str = "value") -> None:
    """Raise ``FloatingPointError`` if any floating-point element of
    ``tree`` is NaN or Inf (a host sync)."""
    frac = float(finite_fraction(tree))
    if frac < 1.0:
        raise FloatingPointError(
            f"{name}: {100 * (1 - frac):.4f}% of elements are NaN/Inf")


def halo_mismatch(x: torch.Tensor, mesh: DeviceMesh, halo: int,
                  time_axis: str = "time",
                  batch_axis: str | None = "ch") -> torch.Tensor:
    """Largest |disagreement| at the boundaries between neighbouring time
    blocks, on every rank.

    ``x`` is this rank's block of a stream sharded along ``time_axis``. Its
    first ``halo`` samples are held against the last ``halo`` samples of
    its left neighbour, which it receives by one hop: this checks regions
    each block *recomputed* (an overlapped layout). For an exact
    overlap-save the result is exactly 0.0; coordinate 0 has no left
    neighbour and counts 0. The maximum is taken over ``time_axis`` and
    then ``batch_axis`` (for a batched ``x``)."""
    from .parallel.collectives import axis_index, left_halo, pmax

    group = mesh.get_group(time_axis)
    recv = left_halo(x, halo, group)
    diff = torch.amax(torch.abs(recv - x[..., :halo]).to(torch.float32)) \
        if halo else torch.zeros((), device=x.device)
    if axis_index(group) == 0:
        diff = torch.zeros_like(diff)
    diff = pmax(diff, group)
    if batch_axis and x.ndim > 1:
        diff = pmax(diff, mesh.get_group(batch_axis))
    return diff
