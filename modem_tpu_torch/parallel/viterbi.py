"""Time-sharded Viterbi decoding over the mesh (counterpart of
:mod:`modem_tpu.parallel.viterbi`).

The add-compare-select recursion is sequential over trellis steps, so one
recursion cannot span ranks. The answer is truncated traceback, as
:meth:`~modem_tpu_torch.fec.conv.ConvCode.decode_soft_windowed` does on one
device: each rank decodes its contiguous slab of the LLR stream with
``halo_steps`` of context from both neighbours (one halo each, the pattern
of the sharded FIR), starts from free path metrics (coordinate 0: the
exact terminated-trellis start) and tracks back from its best final state
(the last rank: from state 0). Survivor paths merge within a few
constraint lengths, so the decisions match the single-device full-block
decode except with vanishing probability.

The slab decode here is the full-block recursion
(:meth:`ConvCode._acs`, a loop over trellis steps on any device): the
parity form. For throughput, shard the *channel* axis instead
(:func:`~.generic.channel_sharded` over ``decode_soft_windowed``, kernel
K13's windowed route on the card).
"""

from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..fec.conv import _GUARD, ConvCode
from .collectives import axis_index, axis_size, left_halo, right_halo


def viterbi_with_halo(llrs: torch.Tensor, code: ConvCode, halo_steps: int,
                      group) -> torch.Tensor:
    """This rank's slab ``[..., n*T_local]`` of a time-sharded LLR stream
    (positive = bit 0) -> the slab's per-step input-bit decisions
    ``[..., T_local]`` (the stream's ``K-1`` flush bits are trimmed by the
    last rank's caller)."""
    n, h = code.n, int(halo_steps)
    t, last = axis_index(group), axis_size(group) - 1
    lh = left_halo(llrs, h * n, group)
    rh = right_halo(llrs, h * n, group)
    # coordinate 0's halo is the pre-stream guard region (the terminated
    # start); the last rank's the post-stream one, its traceback pinned to
    # state 0 (the terminated end)
    if t == 0:
        lh = torch.full_like(lh, float(_GUARD))
    if t == last:
        rh = torch.full_like(rh, float(_GUARD))
    x = torch.cat([lh, llrs, rh], dim=-1)
    steps = x.shape[-1] // n
    lam = x.reshape(x.shape[:-1] + (steps, n))
    dev = llrs.device
    pm0 = torch.zeros((code.n_states,), dtype=torch.float32, device=dev)
    bias = torch.zeros((code.n_states,), dtype=torch.float32, device=dev)
    if t == last:
        bias = torch.full_like(bias, 1e9)
        bias[0] = 0.0
    bits = code._acs(lam, pm0=pm0, end_state="argmin", trim=False,
                     end_bias=bias)
    return bits[..., h:steps - h]


def sharded_viterbi_fn(code: ConvCode, mesh: DeviceMesh,
                       halo_steps: int | None = None,
                       time_axis: str = "time",
                       batch_axis: str | None = "ch"):
    """``f(llrs_l) -> data bits_l``: this rank's slab of the flat LLR
    stream ``[..., n*T]`` sharded over ``time_axis`` (channels over
    ``batch_axis``, no collective) -> its block of the decoded bits
    ``[..., T - (K-1)]`` (the last rank's block short of the ``K-1`` flush
    bits). Each slab must hold whole trellis steps, at least
    ``halo_steps`` (default ``10*K``) of them."""
    h = 10 * code.k if halo_steps is None else int(halo_steps)
    group = mesh.get_group(time_axis)

    def fn(llrs):
        if llrs.shape[-1] % code.n:
            raise ValueError(
                f"slab of {llrs.shape[-1]} LLRs is not whole steps of "
                f"n={code.n}")
        if llrs.shape[-1] // code.n < h:
            raise ValueError(
                f"slab of {llrs.shape[-1] // code.n} steps is smaller than "
                f"the {h}-step halo; use fewer ranks or less halo")
        dec = viterbi_with_halo(llrs, code, h, group)
        if axis_index(group) == axis_size(group) - 1:
            dec = dec[..., : dec.shape[-1] - (code.k - 1)]
        return dec

    return fn
