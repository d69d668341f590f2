"""Time-sharded reference-parity receiver (counterpart of
:mod:`modem_tpu.parallel.rx`).

Distributes :class:`~modem_tpu_torch.rx.Demodulator`'s coherent product
detector over a ``("ch", "time")`` mesh with the reference's semantics
(`demodulator.rs:32-56`):

* the 64-sample PLL acquisition runs where the stream starts, on
  coordinate 0, and its offset reaches the other ranks by one ``psum``;
* the carrier phase of a rank is closed-form in its coordinate;
* the steady-state lowpass filters start *fresh* at sample 64 (the
  reference builds them after lock): coordinate 0 zeroes its first 64
  mixer products, which makes its filter state at sample 64 a fresh
  filter's;
* the lowpass FIRs stitch across ranks by a left halo
  (:func:`~.fir.fir_with_halo`, with the demodulator's ``fir_backend``;
  ``"direct"`` is kernel K4 on the card), so the outputs of samples >= 64
  are the single-device demodulator's.

Outputs of samples < 64 (the lock preamble) are zeros; the CLI drops them.
"""

from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..ops.fir import fir_filter
from ..ops.nco import carrier_phase, mix_down
from ..ops.pll import LOCK_SAMPLES, pll_lock
from ..rx import Demodulator
from .collectives import axis_index, psum
from .fir import fir_with_halo


def sharded_demodulate(demod: Demodulator, x: torch.Tensor,
                       mesh: DeviceMesh, time_axis: str = "time",
                       ch_axis: str | None = "ch"):
    """This rank's block ``[C_l, N_l]`` (or ``[N_l]``) of a real passband
    stream sharded over ``time_axis`` -> its block of ``(i, q)``. Each
    block must hold at least ``LOCK_SAMPLES`` samples."""
    sr, hz = demod.sample_rate, demod.carrier_hz
    group = mesh.get_group(time_axis)
    n = x.shape[-1]
    if n < LOCK_SAMPLES:
        raise ValueError(f"a time block holds {n} samples, fewer than the "
                         f"{LOCK_SAMPLES} of the lock")
    t = axis_index(group)
    x = x.to(torch.float32)
    # acquisition on the stream's head (coordinate 0), the offset summed
    phi = torch.zeros(x.shape[:-1], dtype=torch.float32, device=x.device)
    if t == 0:
        head = x[..., :LOCK_SAMPLES]
        h, _ = fir_filter(head, demod.hilbert)
        theta0 = carrier_phase(hz, sr, LOCK_SAMPLES, 0, device=x.device)
        phi = pll_lock(head, h, theta0)
    phi = psum(phi, group)
    # steady state: the carrier closed-form per rank plus the offset
    s0 = (t * (n % sr)) % sr
    theta = carrier_phase(hz, sr, n, s0, device=x.device) + phi[..., None]
    mi, mq = mix_down(x, theta)
    if t == 0:  # fresh filters at sample 64: the pre-lock products are zero
        mi[..., :LOCK_SAMPLES] = 0.0
        mq[..., :LOCK_SAMPLES] = 0.0
    yi = fir_with_halo(mi, demod.lowpass, group, demod.fir_backend)
    yq = fir_with_halo(mq, demod.lowpass, group, demod.fir_backend)
    return 2.0 * yi, 2.0 * yq
