"""Process bootstrap (counterpart of :mod:`modem_tpu.parallel.multihost`).

The JAX package hands bootstrap to ``jax.distributed``; here it is
``torch.distributed.init_process_group``, over the same names
(``coordinator_address``, ``num_processes``, ``process_id``) or a
launcher's environment (``torchrun``'s ``MASTER_ADDR``/``MASTER_PORT``,
``WORLD_SIZE``, ``RANK``), and then the global ``("ch", "time")`` mesh.
Two arguments are the port's own: ``backend`` (NCCL for ``cuda`` by
default, gloo for ``cpu``; gloo may also carry CUDA tensors, staged through
the host) and ``device``. Typical use, the same script on every process:

    from modem_tpu_torch.parallel.multihost import initialize_multihost
    mesh = initialize_multihost(ch=-1, time=4)
    sc = ShardedPulseChain(chain, mesh)

With no arguments and no launcher environment the process is a world of
one, so the same entry point runs everywhere.
"""

from __future__ import annotations

import os
import socket

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..cuda import resolve_device
from .mesh import make_modem_mesh


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def initialize_multihost(
    ch: int = -1,
    time: int = 1,
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
    device: torch.device | str | None = None,
) -> DeviceMesh:
    """Initialize the default process group unless it is, then build the
    global ``("ch", "time")`` mesh over its ranks.

    ``coordinator_address`` is ``host:port`` of rank 0's store
    (``tcp://`` may be left out); without it a launcher's environment is
    read, and without either the process is a world of one on a free
    local port. ``device`` None means the card (``RuntimeError`` where
    there is none); on ``cuda`` this rank takes card ``LOCAL_RANK`` (else
    ``process_id``) modulo the cards there are, so several ranks may share
    one card. ``backend`` None means NCCL on ``cuda`` and gloo on ``cpu``.
    """
    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if not dist.is_initialized():
        env = os.environ
        if coordinator_address is not None:
            addr = coordinator_address
            if "://" not in addr:
                addr = f"tcp://{addr}"
            world = 1 if num_processes is None else int(num_processes)
            rank = 0 if process_id is None else int(process_id)
        elif env.get("MASTER_ADDR") and env.get("WORLD_SIZE"):
            addr = "env://"
            world = int(env["WORLD_SIZE"])
            rank = int(env.get("RANK", 0) if process_id is None
                       else process_id)
        else:
            if num_processes not in (None, 1):
                raise ValueError("num_processes > 1 needs a "
                                 "coordinator_address or a launcher")
            addr, world, rank = f"tcp://localhost:{_free_port()}", 1, 0
        if dev.type == "cuda":
            local = int(env.get("LOCAL_RANK", rank))
            torch.cuda.set_device(local % torch.cuda.device_count())
        dist.init_process_group(backend, init_method=addr, world_size=world,
                                rank=rank)
    return make_modem_mesh(ch=ch, time=time, device_type=dev.type)
