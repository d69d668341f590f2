"""The reference receiver's product detector as one kernel (counterpart of
:mod:`modem_tpu.ops.pallas_demod`): kernel K5, in
``modem_tpu_torch/csrc/demod.cu``.

Per passband sample (`demodulator.rs:44-56`): the exact integer-NCO carrier
phase plus the per-channel acquired offset ``phi``, the mix
``(x*cos, -x*sin)``, and both lowpass rails with gain 2:

    i = 2 * LPF(x * cos(theta + phi)),  q = 2 * LPF(-x * sin(theta + phi))

:func:`fused_product_detect` takes a CPU tensor to :func:`demod_plain` and a
CUDA tensor to :func:`demod_kernel`, never to the plain version. Outputs
match :meth:`modem_tpu_torch.rx.Demodulator.demodulate` to f32 rounding.
The kernel walks the carrier phase in 32-bit integers (:func:`carrier_walk`)
and takes cos and sin from a per-channel table where the carrier has at
most :data:`NCO_TABLE` phases.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..config import TWO_PI
from ..cuda import Kernel, check_cuda, host_taps
from .fir import as_taps, fir_plain
from .nco import carrier_phase, mix_down

DEMOD_KERNEL = Kernel("modem_demod")

#: the lowpass lookback the kernel takes (taps - 1 <= 64), as the JAX one
MAX_DEMOD_TAPS = 65
#: the most carrier phases the kernel holds in a table
#: (``csrc/common.cuh``'s ``kNcoTable``)
NCO_TABLE = 2048


def carrier_walk(hz: int, sr: int) -> tuple[int, int, int, bool]:
    """How K5 walks the carrier phase ``u = (s * hz) mod sr`` of sample
    ``s``: ``(period, step, unit, table)``. ``u`` is always a multiple of
    ``g = gcd(hz, sr)``; the kernel counts it as ``k = u // unit`` and
    advances ``k`` by ``step`` a sample modulo ``period``. Where the
    carrier's ``sr // g`` phases fit :data:`NCO_TABLE`, ``unit`` is ``g``,
    ``period`` is ``sr // g`` and ``table`` is True (cos and sin from a
    table of ``period`` entries); else ``unit`` is 1 and ``period`` is
    ``sr``."""
    g = math.gcd(hz, sr)
    table = sr // g <= NCO_TABLE
    unit = g if table else 1
    return sr // unit, (hz % sr) // unit, unit, table


def fused_product_detect(x: torch.Tensor, carrier_hz: int, sample_rate: int,
                         lowpass, phase_offset=None, s_mod_sr=0,
                         history: torch.Tensor | None = None):
    """Passband ``x [..., N]`` -> soft baseband ``(i, q) [..., N]``.

    ``phase_offset`` is the acquired PLL phase (a scalar or ``[...]``);
    ``s_mod_sr`` the carrier counter of ``x[..., 0]``, an int or an int32
    tensor on ``x``'s device. ``history [..., H]`` holds the passband samples
    just before ``x`` (``None``: zero FIR history, a stream's start); it is
    read in place, and only ``x``'s ``N`` outputs are written.
    """
    taps = as_taps(lowpass, x.device)
    if taps.shape[0] > MAX_DEMOD_TAPS:
        raise ValueError(f"lowpass must have <= {MAX_DEMOD_TAPS} taps")
    if carrier_hz * sample_rate >= 1 << 31:
        raise ValueError("needs hz*sr < 2^31 for exact int32 NCO")
    batch_shape = x.shape[:-1]
    x = x.to(torch.float32)
    if history is None:
        history = x.new_zeros(batch_shape + (0,))
    if phase_offset is None:
        phase_offset = 0.0
    phi = torch.as_tensor(phase_offset, dtype=torch.float32, device=x.device)
    phi = phi.broadcast_to(batch_shape)
    # the carrier counter of the stream's first sample, history[..., 0]
    off = (torch.as_tensor(s_mod_sr, dtype=torch.int32, device=x.device)
           - history.shape[-1]) % sample_rate
    run = demod_kernel if x.is_cuda else demod_plain
    return run(x, history.to(torch.float32), taps, int(carrier_hz),
               int(sample_rate), off, phi)


def demod_plain(x, history, taps, hz: int, sr: int, off, phi):
    """Plain version of K5: NCO, mix and both lowpass rails over
    ``history ++ x`` from a zero FIR state, ``x``'s outputs kept."""
    e = torch.cat([history, x], dim=-1)
    theta = carrier_phase(hz, sr, e.shape[-1], off)
    mi, mq = mix_down(e, theta + phi[..., None])
    h = history.shape[-1]
    zero = torch.zeros(e.shape[:-1] + (taps.shape[0] - 1,),
                       dtype=torch.float32, device=e.device)
    yi = fir_plain(mi, taps, zero)[..., h:]
    yq = fir_plain(mq, taps, zero)[..., h:]
    return 2.0 * yi, 2.0 * yq


def demod_kernel(x, history, taps, hz: int, sr: int, off, phi):
    """Launch K5 (``modem_demod``) on CUDA tensors."""
    dev = x.device
    if history.shape[:-1] != x.shape[:-1] or phi.shape != x.shape[:-1]:
        raise ValueError("history, phase_offset and x differ in batch shape")
    c = math.prod(x.shape[:-1])
    n, h = x.shape[-1], history.shape[-1]
    fx = x.reshape(c, n).contiguous()
    fh = history.reshape(c, h).contiguous()
    fphi = phi.reshape(c).contiguous()
    off = off.reshape(1).contiguous()
    for name, t, dt in (("x", fx, torch.float32), ("history", fh, torch.float32),
                        ("taps", taps, torch.float32),
                        ("phase_offset", fphi, torch.float32),
                        ("s_mod_sr", off, torch.int32)):
        check_cuda(name, t, dt, dev)
    oi = torch.empty_like(fx)
    oq = torch.empty_like(fx)
    if oi.numel():
        w = float(np.float32(TWO_PI / sr))
        period, step, unit, table = carrier_walk(hz, sr)
        DEMOD_KERNEL.launch(dev, fh.data_ptr(), h, fx.data_ptr(), fx.shape[0],
                            n, host_taps(taps), taps.shape[0], hz, sr, w,
                            period, step, unit, int(table), off.data_ptr(),
                            fphi.data_ptr(), oi.data_ptr(), oq.data_ptr())
    return oi.reshape(x.shape), oq.reshape(x.shape)
