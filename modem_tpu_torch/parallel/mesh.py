"""Device-mesh construction and the local blocks of global tensors
(counterpart of :mod:`modem_tpu.parallel.mesh`).

One process drives one device, as ``torch.distributed`` expects; a mesh is
a :class:`torch.distributed.device_mesh.DeviceMesh` with the dimension
names ``("ch", "time")`` over the ranks of the default process group, rank
``c*time + t`` at coordinate ``(c, t)``. The sharded functions of this
package take and return a rank's local block: what the body of the JAX
package's ``shard_map`` sees. :func:`shard_block` cuts that block out of a
global tensor.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..cuda import resolve_device

MESH_DIMS = ("ch", "time")


def make_modem_mesh(ch: int = 1, time: int = 1,
                    device_type: str | None = None) -> DeviceMesh:
    """A 2-D ``("ch", "time")`` mesh over every rank of the default process
    group, which must be initialized (:func:`~.multihost
    .initialize_multihost`; a world of one is allowed).

    ``ch`` shards independent channels (no collectives); ``time`` shards the
    sample axis of one stream (halo exchanges). One factor given as -1 takes
    what the world leaves. ``device_type`` None means ``"cuda"``, which
    raises where there is none; the CPU only when the caller asks for it.
    """
    if not dist.is_initialized():
        raise RuntimeError("make_modem_mesh needs an initialized default "
                           "process group (initialize_multihost)")
    dev = resolve_device(device_type)
    n = dist.get_world_size()
    if ch == -1:
        ch = n // time
    if time == -1:
        time = n // ch
    if ch < 1 or time < 1 or ch * time != n:
        raise ValueError(f"mesh {ch}x{time} needs {ch * time} ranks, the "
                         f"world has {n}")
    return init_device_mesh(dev.type, (ch, time), mesh_dim_names=MESH_DIMS)


def shard_block(x: torch.Tensor, mesh: DeviceMesh,
                dims: tuple[str | None, ...]) -> torch.Tensor:
    """This rank's block of the global tensor ``x``: axis ``a`` of ``x`` is
    split over the mesh dimension ``dims[a]`` (None: kept whole), and the
    block is the one at this rank's coordinate. Raises ``ValueError`` where
    an axis does not divide by its dimension's size. ``dims`` names the
    leading axes and may be shorter than ``x.ndim``."""
    if len(dims) > x.ndim:
        raise ValueError(f"{len(dims)} mesh dims for a {x.ndim}-d tensor")
    index = []
    for axis, name in enumerate(dims):
        if name is None:
            index.append(slice(None))
            continue
        size, at = mesh.size(mesh.mesh_dim_names.index(name)), \
            mesh.get_local_rank(name)
        if x.shape[axis] % size:
            raise ValueError(f"axis {axis} of length {x.shape[axis]} does "
                             f"not divide by the {name!r} size {size}")
        step = x.shape[axis] // size
        index.append(slice(at * step, (at + 1) * step))
    return x[tuple(index)].contiguous()
