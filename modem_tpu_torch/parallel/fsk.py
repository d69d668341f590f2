"""Time-sharded fused FSK loopback: the fused discriminator kernel on every
rank with the phase continuous across ranks (counterpart of
:mod:`modem_tpu.parallel.fsk`).

* the continuity accumulators cross the rank boundaries as in
  :func:`~.modulator.time_sharded_baseband` (a boundary halo and an
  exclusive prefix of the ranks' phase totals);
* each rank evaluates its waveform in *local* time by folding its global
  sample offset ``S0 = t * n_local`` into the phase numerator,
  ``fnum*(t_local + S0) + pnum == fnum*t_local + (pnum + fnum*S0)`` mod
  den, so the kernel (K6 on the card) needs no global position;
* the discriminator's ``guard >= 1`` discards every increment across a
  symbol boundary, so no waveform halo is exchanged at all.

Noiseless decisions equal the single-device fused loopback exactly.
"""

from __future__ import annotations

from torch.distributed.device_mesh import DeviceMesh

from ..config import Rates
from ..ops.fsk_kernel import (DEFAULT_CHUNK_SYM, fsk_coef_table,
                              fsk_decide_from_program, fsk_noise_sigma)
from ..utils.bits import pack_bits, unpack_symbols
from .chain import device_seed
from .collectives import axis_index
from .modulator import _apply_phase_offset, _boundary_state


def time_sharded_fsk_roundtrip_fn(
    scheme, rates: Rates, mesh: DeviceMesh, guard: int = 1,
    snr_db: float | None = None, time_axis: str = "time",
    ch_axis: str | None = "ch", chunk_sym: int | None = None,
):
    """Returns ``f(bits_l, seed=0) -> decided bits_l``: this rank's block
    ``[C_l, K_l*bps]`` (or ``[K_l*bps]``) of the stream through the fused
    FSK loopback. ``snr_db`` as in ``fused_fsk_chain``, the noise keyed by
    ``seed`` and the rank's coordinates; ``chunk_sym`` is the kernel's tile
    of symbols (a smaller one where the blocks are short)."""
    coefs = fsk_coef_table(scheme)
    amp = float(scheme.amplitude)
    den = scheme.den if scheme.den else rates.sample_rate
    sps = rates.samples_per_symbol
    sigma = None if snr_db is None else fsk_noise_sigma(amp, snr_db)
    if chunk_sym is None:
        chunk_sym = DEFAULT_CHUNK_SYM
    group = mesh.get_group(time_axis)
    ch_group = mesh.get_group(ch_axis) if ch_axis else None

    def local(bits_l, seed=0):
        symbols = pack_bits(bits_l, scheme.bits_per_symbol)
        t = axis_index(group)
        n_local = symbols.shape[-1] * sps
        s0 = (t * (n_local % den)) % den
        state = _boundary_state(scheme, symbols, group)
        prog, new_state = scheme.program(symbols, state, rates, s0)
        prog = _apply_phase_offset(scheme, prog, new_state, group)
        # the rank's global sample offset folded into the phase numerator;
        # fnum*s0 stays in int32 (max|fnum|*den < 2^31, s0 < den)
        pnum = (prog.pnum + prog.fnum * s0) % den
        c = axis_index(ch_group) if bits_l.ndim > 1 and ch_group else 0
        dec = fsk_decide_from_program(
            prog.fnum, pnum, coefs, den, sps, amp, float(prog.qshift),
            guard, chunk_sym, sigma, device_seed(seed, t, c))
        return unpack_symbols(dec, scheme.bits_per_symbol)

    return local
