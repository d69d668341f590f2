"""Polyphase interpolation and decimation (counterpart of
:mod:`modem_tpu.ops.polyphase`).

* interp: ``y[m*sps + p] = sum_k taps[k*sps + p] * x[m - k]``, the pulse
  shaper at symbol rate, equal up to f32 summation order to filtering the
  zero-stuffed stream;
* decim: ``z[m] = y[d + m*sps]`` of the causal FIR ``y`` of ``x``, the
  matched filter evaluated only at the decision instants.

These are the plain versions of the arithmetic inside the fused kernels
(:mod:`modem_tpu_torch.ops.txrx`, :mod:`modem_tpu_torch.ops.chain_kernel`).
"""

from __future__ import annotations

import torch

from .fir import as_taps


def _phase_bank(taps, sps: int) -> torch.Tensor:
    """``[sps, ceil(L/sps)]`` float32 with ``T[p, k] = taps[k*sps + p]``
    (zero-padded), on the taps' device."""
    taps = as_taps(taps, getattr(taps, "device", None))
    length = taps.shape[0]
    k_per_phase = -(-length // sps)
    padded = torch.nn.functional.pad(taps, (0, k_per_phase * sps - length))
    return padded.reshape(k_per_phase, sps).t().contiguous()


def polyphase_interp(x: torch.Tensor, taps, sps: int,
                     state: torch.Tensor | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Pulse-shape symbol-rate values ``[..., M]`` to ``[..., M*sps]``
    without zero-stuffing. Returns ``(y, new_state)``; ``state`` is the
    previous block's last ``ceil(L/sps)-1`` symbols (zeros if None)."""
    bank = _phase_bank(as_taps(taps, x.device), sps)
    kp = bank.shape[1]
    if state is None:
        state = torch.zeros(x.shape[:-1] + (kp - 1,), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([state, x], dim=-1) if kp > 1 else x
    m = x.shape[-1]
    phases = []
    for p in range(sps):
        acc = torch.zeros(x.shape[:-1] + (m,), dtype=x.dtype, device=x.device)
        for k in range(kp):
            acc = acc + bank[p, k] * xp[..., kp - 1 - k: kp - 1 - k + m]
        phases.append(acc)
    y = torch.stack(phases, dim=-1).reshape(x.shape[:-1] + (m * sps,))
    new_state = xp[..., xp.shape[-1] - (kp - 1):] if kp > 1 else state
    return y, new_state


def polyphase_decim(x: torch.Tensor, taps, sps: int, delay: int, n_out: int,
                    state: torch.Tensor | None = None) -> torch.Tensor:
    """Matched filter + symbol-instant decimation in one symbol-rate pass:
    ``z[m] = sum_j taps[j] * xh[delay + m*sps - j]`` for ``m < n_out``, where
    ``xh`` is ``x`` preceded by ``state`` (the previous block's last ``L-1``
    samples; zeros if None). ``x`` must cover the last decision instant."""
    taps = as_taps(taps, x.device)
    length = taps.shape[0]
    if state is None:
        state = torch.zeros(x.shape[:-1] + (length - 1,), dtype=x.dtype,
                            device=x.device)
    xh = torch.cat([state, x], dim=-1) if length > 1 else x
    span_needed = delay + (n_out - 1) * sps + 1
    if span_needed > x.shape[-1]:
        raise ValueError(
            f"decimation needs {span_needed} input samples, got {x.shape[-1]}"
        )
    z = torch.zeros(x.shape[:-1] + (n_out,), dtype=x.dtype, device=x.device)
    for j in range(length):
        start = length - 1 + delay - j
        z = z + taps[j] * xh[..., start: start + (n_out - 1) * sps + 1: sps]
    return z
