"""Time-sharded digital modulator: the stateful phase carried across ranks
(counterpart of :mod:`modem_tpu.parallel.modulator`).

The reference's per-symbol ``update()`` accumulators (DMPSK
`dmpsk.rs:29-33`, MFSK `mfsk.rs:68-75`, BFSK `bfsk.rs:43-55`, DCQPSK parity
`dcqpsk.rs:42-44`, the MSK/OQPSK staggered bit `data.rs:97-99`) are modular
prefix sums within a block (:mod:`modem_tpu_torch.models`). Splitting one
stream's symbols along a mesh dimension adds two dependencies across
ranks, each one small collective:

1. **boundary state**: the first symbol of rank ``t`` compares against the
   last of rank ``t-1`` (BFSK's ``prev``, MFSK's ``cur_coef``, the
   staggered bit): one left halo of the last symbol; coordinate 0 receives
   zeros, every scheme's initial state;
2. **phase offset**: the additive accumulator entering rank ``t`` is the
   sum of the earlier ranks' phase totals, an :func:`exclusive_prefix`.
   Integer-turn schemes apply it as a ``pnum`` shift (exact); DMPSK as a
   rotation of its constellation output (to f32 rotation accuracy).

DCQPSK's parity and the time origin are closed-form in the coordinate
(parity ``(t*K_local) % 2``, origin ``t * n_local mod den``).
"""

from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..config import TWO_PI
from ..models.base import IQProgram, PhaseProgram, f32, synthesize
from ..models.fsk import BFSK, MFSK, MSK
from ..models.psk import DCQPSK, DMPSK, OQPSK
from ..tx import REF_TIME_OFFSET, Modulator
from ..utils.bits import pack_bits
from .collectives import axis_index, exclusive_prefix, left_halo


def _boundary_state(scheme, symbols_l: torch.Tensor, group):
    """This rank's initial scheme state, its additive phase parts zero:
    one halo of the previous rank's last symbol; coordinate 0's zeros are
    each scheme's initial state."""
    batch = symbols_l.shape[:-1]
    dev = symbols_l.device
    prev_sym = left_halo(symbols_l, 1, group)[..., 0]
    t = axis_index(group)
    k_local = symbols_l.shape[-1]
    zeros = torch.zeros(batch, dtype=torch.int32, device=dev)
    if isinstance(scheme, BFSK):
        return {"prev": prev_sym, "pnum": zeros}
    if isinstance(scheme, MFSK):
        # coef(0) != 0 for the bipolar map: coordinate 0 keeps the true
        # initial coefficient 0 (`mfsk.rs:57`)
        cur = zeros if t == 0 else scheme.coef(prev_sym)
        return {"cur_coef": cur, "pnum": zeros.clone()}
    if isinstance(scheme, DMPSK):
        return torch.full(batch, scheme.phase0_turns if t == 0 else 0.0,
                          dtype=torch.float32, device=dev)
    if isinstance(scheme, DCQPSK):
        return torch.full(batch, (t * k_local) % 2, dtype=torch.int32,
                          device=dev)
    if isinstance(scheme, (MSK, OQPSK)):
        return (prev_sym & 1).to(torch.int32)
    return scheme.init_state(batch, dev)  # stateless or closed-form schemes


def _apply_phase_offset(scheme, prog, new_state, group):
    """Add the exclusive prefix of the additive phase accumulators."""
    if isinstance(scheme, (BFSK, MFSK)):
        off = exclusive_prefix(new_state["pnum"], group) % scheme.den
        return PhaseProgram(
            gi=prog.gi, gq=prog.gq, fnum=prog.fnum,
            pnum=(prog.pnum + off[..., None]) % scheme.den,
            den=prog.den, qshift=prog.qshift,
            slots_per_symbol=prog.slots_per_symbol)
    if isinstance(scheme, DMPSK):
        off = exclusive_prefix(new_state, group) % 1.0
        theta = (off * f32(TWO_PI))[..., None]
        c, s = torch.cos(theta), torch.sin(theta)
        return IQProgram(i=prog.i * c - prog.q * s, q=prog.i * s + prog.q * c,
                         slots_per_symbol=prog.slots_per_symbol)
    return prog


def time_sharded_baseband(mod: Modulator, bits: torch.Tensor,
                          mesh: DeviceMesh, time_axis: str = "time",
                          ch_axis: str | None = "ch"):
    """This rank's block of bits ``[C_l, K_l*bps]`` (or ``[K_l*bps]``) of a
    stream sharded over ``time_axis`` (its channels over ``ch_axis``, which
    needs no collective) -> this rank's block of the baseband ``(i, q)``,
    equal to :meth:`Modulator.baseband` of the whole stream from a fresh
    state. Integer-phase schemes are bit-exact; DMPSK matches to f32
    rotation accuracy."""
    scheme, rates = mod.scheme, mod.rates
    sps = rates.samples_per_symbol
    group = mesh.get_group(time_axis)
    symbols = pack_bits(bits, scheme.bits_per_symbol)
    n_local = symbols.shape[-1] * sps
    t0_mod = (axis_index(group) * (n_local % mod.den)) % mod.den
    state = _boundary_state(scheme, symbols, group)
    prog, new_state = scheme.program(symbols, state, rates, t0_mod)
    prog = _apply_phase_offset(scheme, prog, new_state, group)
    return synthesize(prog, sps, t0_mod, REF_TIME_OFFSET)
