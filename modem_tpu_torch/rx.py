"""Block demodulator: the reference's coherent receiver (counterpart of
:mod:`modem_tpu.rx`).

Mirrors `demodulator.rs:7-57` and the `demodulate` binary
(`demodulate.rs:15-43`):

    passband -> Hilbert FIR -> analytic signal        (lock only)
    -> 64-sample PLL acquisition (phase frozen afterwards)
    -> product detector: i = 2*LPF(x*cos(theta+phi)), q = 2*LPF(-x*sin(theta+phi))

as block transforms with an explicit :class:`RxState` (carrier counter,
acquired phase, FIR tails). Every FIR goes through
:func:`modem_tpu_torch.ops.fir.fir_filter` with the demodulator's
``fir_backend`` (``"direct"``: kernel K4 on the card), and :meth:`Demodulator
.demodulate_fused` runs the whole detector as kernel K5
(:func:`modem_tpu_torch.ops.demod_kernel.fused_product_detect`) whatever
the backend.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .cuda import resolve_device
from .ops import filters
from .ops.demod_kernel import fused_product_detect
from .ops.fir import check_backend, fir_filter, fir_init_state
from .ops.nco import carrier_phase, mix_down
from .ops.pll import LOCK_SAMPLES, pll_lock
from .tx import tree_to_torch


@dataclasses.dataclass
class RxState:
    s_mod_sr: torch.Tensor  # carrier sample counter mod sr, 0-d int32
    phase_offset: torch.Tensor  # acquired PLL offset, f32 [...]
    hilbert: torch.Tensor  # Hilbert FIR tail
    lpi: torch.Tensor  # I lowpass tail (mixed samples)
    lpq: torch.Tensor  # Q lowpass tail

    @classmethod
    def from_numpy(cls, state, device=None) -> "RxState":
        """From the numpy form of a :class:`modem_tpu.rx.RxState` (every
        leaf through ``np.asarray``), so a stream started there goes on
        here."""
        device = resolve_device(device)
        return cls(*(tree_to_torch(getattr(state, f.name), device)
                     for f in dataclasses.fields(cls)))


class Demodulator(torch.nn.Module):
    """Coherent product-detector demodulator for one carrier configuration.

    Defaults reproduce the reference binary: a 23-tap Hilbert transformer
    and a 64-tap lowpass (passband 0-1 kHz, stopband 1.5-5 kHz at 10 kHz),
    designed to spec (`demodulate.rs:10,36,46-150`). ``lowpass`` and
    ``hilbert`` (e.g. the JAX object's arrays) replace the designs; both are
    buffers on ``device``, the card unless the caller asks for the CPU.
    ``fir_backend`` (one of :data:`~modem_tpu_torch.ops.fir.BACKENDS`)
    filters the Hilbert arm and the staged lowpass.
    """

    def __init__(self, carrier_hz: int, sample_rate: int, lowpass=None,
                 hilbert=None, fir_backend: str = "direct",
                 device: torch.device | str | None = None):
        super().__init__()
        check_backend(fir_backend)
        device = resolve_device(device)
        self.carrier_hz = carrier_hz
        self.sample_rate = sample_rate
        self.fir_backend = fir_backend
        if lowpass is None:
            lowpass = filters.lowpass_taps(sample_rate=sample_rate)
        if hilbert is None:
            hilbert = filters.hilbert_taps()
        self.register_buffer("lowpass", torch.tensor(
            np.asarray(lowpass, np.float32), device=device))
        self.register_buffer("hilbert", torch.tensor(
            np.asarray(hilbert, np.float32), device=device))

    @property
    def device(self) -> torch.device:
        return self.lowpass.device

    def init_state(self, batch_shape: tuple[int, ...] = ()) -> RxState:
        dev = self.device
        return RxState(
            s_mod_sr=torch.zeros((), dtype=torch.int32, device=dev),
            phase_offset=torch.zeros(batch_shape, dtype=torch.float32,
                                     device=dev),
            hilbert=fir_init_state(self.hilbert, batch_shape, dev),
            lpi=fir_init_state(self.lowpass, batch_shape, dev),
            lpq=fir_init_state(self.lowpass, batch_shape, dev),
        )

    def analytic(self, x: torch.Tensor, state: RxState):
        """Analytic-signal planes ``(x, H(x))`` (`demodulate.rs:31-34`) as two
        real tensors; no group-delay compensation on the Hilbert arm, as in
        the reference."""
        h, tail = fir_filter(x, self.hilbert, state.hilbert, self.fir_backend)
        return (x, h), tail

    def lock_phase(self, x: torch.Tensor, state: RxState) -> RxState:
        """Consume ``LOCK_SAMPLES`` passband samples ``[..., 64]`` and
        acquire the carrier phase offset (`demodulator.rs:32-36`)."""
        if x.shape[-1] != LOCK_SAMPLES:
            raise ValueError(f"lock_phase needs exactly {LOCK_SAMPLES} samples")
        (si, sq), htail = self.analytic(x, state)
        theta = carrier_phase(self.carrier_hz, self.sample_rate, LOCK_SAMPLES,
                              state.s_mod_sr)
        phi = state.phase_offset + pll_lock(si, sq, theta)
        return RxState(
            s_mod_sr=(state.s_mod_sr + LOCK_SAMPLES) % self.sample_rate,
            phase_offset=phi, hilbert=htail, lpi=state.lpi, lpq=state.lpq)

    def demodulate(self, x: torch.Tensor, state: RxState
                   ) -> tuple[tuple[torch.Tensor, torch.Tensor], RxState]:
        """Steady-state product detection (`demodulator.rs:44-56`), staged:
        carrier phase, mix, then the two lowpass FIRs (``fir_backend``;
        ``"direct"`` is kernel K4 on CUDA)."""
        n, sr = x.shape[-1], self.sample_rate
        theta = carrier_phase(self.carrier_hz, sr, n, state.s_mod_sr)
        mi, mq = mix_down(x, theta + state.phase_offset[..., None])
        yi, lpi = fir_filter(mi, self.lowpass, state.lpi, self.fir_backend)
        yq, lpq = fir_filter(mq, self.lowpass, state.lpq, self.fir_backend)
        new_state = RxState(
            s_mod_sr=(state.s_mod_sr + n % sr) % sr,
            phase_offset=state.phase_offset, hilbert=state.hilbert,
            lpi=lpi, lpq=lpq)
        return (2.0 * yi, 2.0 * yq), new_state

    def demodulate_fused(self, x: torch.Tensor, state: RxState,
                         x_tail: torch.Tensor | None = None):
        """Steady-state product detection as one kernel (K5 on CUDA).

        ``x_tail`` is the previous block's last ``len(lowpass)-1`` passband
        samples (``None``: zero FIR history, the stream's start). Returns
        ``((i, q), new_state, new_x_tail)``; outputs equal :meth:`demodulate`
        to f32 rounding, and ``new_state`` keeps the staged path's FIR tails
        (the last mixed samples) up to date, so the two can alternate
        mid-stream.
        """
        lb = self.lowpass.shape[0] - 1
        n, sr = x.shape[-1], self.sample_rate
        x = x.to(torch.float32)
        if x_tail is None:
            x_tail = x.new_zeros(x.shape[:-1] + (lb,))
        yi, yq = fused_product_detect(
            x, self.carrier_hz, sr, self.lowpass,
            phase_offset=state.phase_offset, s_mod_sr=state.s_mod_sr,
            history=x_tail)
        # the last lb samples of x_tail ++ x, and their mixed values for the
        # staged path's FIR tails
        tail = (x[..., n - lb:] if n >= lb
                else torch.cat([x_tail[..., n:], x], dim=-1)).contiguous()
        theta = carrier_phase(self.carrier_hz, sr, lb,
                              (state.s_mod_sr + (n - lb)) % sr)
        mi, mq = mix_down(tail, theta + state.phase_offset[..., None])
        new_state = RxState(
            s_mod_sr=(state.s_mod_sr + n % sr) % sr,
            phase_offset=state.phase_offset, hilbert=state.hilbert,
            lpi=mi, lpq=mq)
        return (yi, yq), new_state, tail
