"""The distributed wideband channelizer, BASELINE config #5's front end
(counterpart of :mod:`modem_tpu.parallel.channelizer`).

One wideband stream is **time-sharded** across the ranks of a mesh
dimension; each rank runs the polyphase analysis bank on its block
(overlap-save: the bank's lookback, ``J*M`` wideband samples, arrives from
the left neighbour as one halo), and one all-to-all re-deals the result
from time sharding to **channel sharding**, where the per-channel receivers
run with no collective (:mod:`.acquire`). The TX direction is the mirror
image: one all-to-all and one halo each way.

Edge ranks receive zeros, the banks' zero streaming history, so the
sharded sums are the single-device
:class:`~modem_tpu_torch.ops.channelizer.Channelizer`'s.
"""

from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..ops.channelizer import Channelizer
from .collectives import all_to_all, left_halo


def _analyze(bank: Channelizer, wi, wq, group):
    """This rank's block of the analysis ``[M, K_local]``."""
    m, j = bank.m, bank.taps_per_phase
    hi = left_halo(wi, j * m, group)
    hq = left_halo(wq, j * m, group)
    yi, yq = bank.analyze(torch.cat([hi, wi], dim=-1),
                          torch.cat([hq, wq], dim=-1))
    return yi[..., j:], yq[..., j:]   # the halo's J warm-up rows dropped


def _synthesize(bank: Channelizer, ci, cq, group):
    """This rank's block of the synthesis ``[M*K_local]``."""
    j = bank.taps_per_phase
    hi = left_halo(ci, j - 1, group)
    hq = left_halo(cq, j - 1, group)
    wi, wq = bank.synthesize(torch.cat([hi, ci], dim=-1),
                             torch.cat([hq, cq], dim=-1))
    return wi[..., (j - 1) * bank.m:], wq[..., (j - 1) * bank.m:]


def sharded_analyze_fn(bank: Channelizer, mesh: DeviceMesh,
                       time_axis: str = "time"):
    """``f(wi_l, wq_l) -> (yi_l, yq_l)``: this rank's block ``[N_l]`` of the
    wideband input sharded over ``time_axis`` -> its block ``[M, N_l/M]``
    of the channels, sharded the same way along time. ``N_l`` must divide
    by ``M`` and be at least the bank's lookback ``J*M``."""
    group = mesh.get_group(time_axis)
    return lambda wi, wq: _analyze(bank, wi, wq, group)


def sharded_synthesize_fn(bank: Channelizer, mesh: DeviceMesh,
                          time_axis: str = "time"):
    """``f(ci_l, cq_l) -> (wi_l, wq_l)``: this rank's block ``[M, K_l]`` of
    the channels, sharded along their samples -> its block ``[M*K_l]`` of
    the wideband stream."""
    group = mesh.get_group(time_axis)
    return lambda ci, cq: _synthesize(bank, ci, cq, group)


def wideband_rx_fn(bank: Channelizer, mesh: DeviceMesh,
                   time_axis: str = "time"):
    """Analysis and re-deal: ``f(wi_l, wq_l) -> (yi_l, yq_l)``, the input
    time-sharded ``[N_l]``, the output **channel-sharded** ``[M/D, K]``
    (coordinate ``d`` holds channels ``d*M/D ..``), ready for the
    per-channel receivers. ``M`` and ``N/M`` must divide by ``D``, the
    dimension's size."""
    group = mesh.get_group(time_axis)

    def local(wi, wq):
        yi, yq = _analyze(bank, wi, wq, group)          # [M, K_local]
        return (all_to_all(yi, group, split_axis=0, concat_axis=1),
                all_to_all(yq, group, split_axis=0, concat_axis=1))

    return local


def wideband_tx_fn(bank: Channelizer, mesh: DeviceMesh,
                   time_axis: str = "time"):
    """Re-deal and synthesis, the mirror of :func:`wideband_rx_fn`:
    ``f(ci_l, cq_l) -> (wi_l, wq_l)``, channel-sharded ``[M/D, K]`` in,
    time-sharded ``[M*K/D]`` out."""
    group = mesh.get_group(time_axis)

    def local(ci, cq):
        ci = all_to_all(ci, group, split_axis=1, concat_axis=0)
        cq = all_to_all(cq, group, split_axis=1, concat_axis=0)
        return _synthesize(bank, ci, cq, group)

    return local
