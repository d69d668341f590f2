"""Time-sharded FIR: overlap-save across ranks by a halo exchange
(counterpart of :mod:`modem_tpu.parallel.fir`).

A causal FIR over a stream split along a mesh dimension needs only the
``taps-1`` last samples of the left neighbour; the exchange is one hop and
the result is the single-device filter's, because
:func:`~modem_tpu_torch.ops.fir.fir_filter` takes the left history as an
explicit ``state`` for every backend (``"direct"``: kernel K4 on a CUDA
tensor, its plain version on a CPU one).
"""

from __future__ import annotations

from torch.distributed.device_mesh import DeviceMesh

from ..ops.fir import as_taps, fir_filter
from .collectives import left_halo


def fir_with_halo(x, taps, group, backend: str = "direct"):
    """This rank's block of a globally causal FIR over ``x [..., n_local]``,
    a stream sharded over the ranks of ``group``. Coordinate 0's history is
    zeros (a fresh filter, `fir.rs:12-15`). ``backend`` is one of
    :data:`~modem_tpu_torch.ops.fir.BACKENDS`."""
    taps = as_taps(taps, x.device)
    k = taps.shape[0]
    state = left_halo(x, k - 1, group) if k > 1 else None
    y, _ = fir_filter(x, taps, state, backend)
    return y


def sharded_fir(x, taps, mesh: DeviceMesh, time_axis: str = "time",
                backend: str = "direct", batch_axis: str | None = "ch"):
    """Globally causal FIR of this rank's block ``x [..., n_local]`` of a
    stream sharded over ``time_axis`` (and its channels over
    ``batch_axis``, which needs no collective). Returns this rank's block
    of the output."""
    return fir_with_halo(x, taps, mesh.get_group(time_axis), backend)
