"""AWGN channels (counterparts of :func:`modem_tpu.ops.channel.awgn` and
``awgn_real``), drawing from an explicit ``torch.Generator`` in place of a
JAX key."""

from __future__ import annotations

import torch


def awgn(generator: torch.Generator, i: torch.Tensor, q: torch.Tensor,
         snr_db: float, signal_power: float | None = None
         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Add complex white Gaussian noise at the given SNR (per complex sample).

    ``signal_power``: average |s|^2; measured from the block if None.
    Noise variance N0 = P / 10^(SNR/10), split evenly across I and Q. The
    generator must live on the device of ``i`` and ``q``.
    """
    p = torch.mean(i * i + q * q) if signal_power is None else signal_power
    sigma = (p / (10.0 ** (snr_db / 10.0)) / 2.0) ** 0.5
    ni = torch.randn(i.shape, generator=generator, dtype=i.dtype, device=i.device)
    nq = torch.randn(q.shape, generator=generator, dtype=q.dtype, device=q.device)
    return i + sigma * ni, q + sigma * nq


def awgn_real(generator: torch.Generator, x: torch.Tensor, snr_db: float,
              signal_power: float | None = None) -> torch.Tensor:
    """Add white Gaussian noise to a real passband waveform at ``snr_db``:
    variance ``P / 10^(SNR/10)``, ``P`` = mean ``x^2`` (``signal_power``
    if given). The generator must live on the device of ``x``."""
    p = torch.mean(x * x) if signal_power is None else signal_power
    sigma = (p / (10.0 ** (snr_db / 10.0))) ** 0.5
    return x + sigma * torch.randn(x.shape, generator=generator,
                                   dtype=x.dtype, device=x.device)
