"""Generic channel sharding: any batched block transform over the ``"ch"``
mesh dimension (counterpart of :mod:`modem_tpu.parallel.generic`).

Every chain of the package is a batched function over a leading channel
axis, so data parallelism needs no bespoke wrapper: each rank runs the
function on its own channels, with no collective. Use the bespoke wrappers
where there is structure across ranks (time sharding, halos, summed
metrics); use this one for chains that are parallel over channels (GMSK,
STBC, per-channel receivers).
"""

from __future__ import annotations

from torch.distributed.device_mesh import DeviceMesh


def channel_sharded(fn, mesh: DeviceMesh, ch_axis: str = "ch"):
    """``fn``: a function of tensors whose leading axis is the channel
    bank (every argument and every output). Returns the sharded function:
    it takes this rank's block of channels (:func:`~.mesh.shard_block`
    along ``ch_axis``, which raises unless the bank divides by the
    dimension's size) and returns ``fn`` of it, the single-device values
    bit for bit, the computation being the same one, narrower. Every
    argument's block must hold the same number of channels."""
    if ch_axis not in mesh.mesh_dim_names:
        raise ValueError(f"the mesh has no {ch_axis!r} dimension")

    def wrapped(*args):
        sizes = {a.shape[0] for a in args}
        if len(sizes) > 1:
            raise ValueError(f"channel blocks of different sizes: "
                             f"{sorted(sizes)}")
        return fn(*args)

    return wrapped
