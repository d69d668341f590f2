"""Puncturing: higher code rates from the rate-1/2 mother code (counterpart
of :mod:`modem_tpu.fec.puncture`).

A pattern ``P`` is an ``[n, p]`` 0/1 mask over the mother code's ``n``
output streams and a period of ``p`` trellis steps; transmitted bits are
the 1-positions in time-major order (``c_0[k], c_1[k], c_0[k+1], ...``, as
:meth:`~modem_tpu_torch.fec.conv.ConvCode.encode` emits them). Deleted
positions come back at the receiver as zero-LLR erasures. Both directions
are index maps built on the host: ``puncture`` an indexed read,
``depuncture`` an indexed write into a zero block.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.cache import on_device


class Puncturer:
    """Static puncture/depuncture maps for a pattern ``[n, period]`` of 0/1:
    column ``j`` says which of the ``n`` code bits of trellis step
    ``t ≡ j (mod period)`` are sent. :func:`rate23_pattern` and
    :func:`rate34_pattern` are the standard ones for the K=7 mother code.
    """

    def __init__(self, pattern: np.ndarray):
        pat = np.asarray(pattern, np.int64)
        if pat.ndim != 2 or not np.isin(pat, (0, 1)).all():
            raise ValueError("pattern must be a 2D 0/1 array [n, period]")
        if pat.sum() == 0:
            raise ValueError("pattern deletes everything")
        self.n, self.period = map(int, pat.shape)
        self.pattern = pat
        # time-major flat order within one period: [p, n] -> kept positions
        self._keep = np.flatnonzero(pat.T.reshape(-1))
        self.kept_per_period = int(self._keep.size)

    def _flat_indices(self, steps: int) -> np.ndarray:
        if steps % self.period:
            raise ValueError(
                f"trellis length {steps} must divide by period {self.period}")
        reps = steps // self.period
        base = np.arange(reps) * (self.n * self.period)
        return (base[:, None] + self._keep[None, :]).reshape(-1)

    def _indices(self, steps: int, device) -> torch.Tensor:
        return on_device(self, steps, lambda: self._flat_indices(steps),
                         torch.long, device)

    def out_bits(self, steps: int) -> int:
        """Punctured length for ``steps`` trellis steps."""
        return (steps // self.period) * self.kept_per_period

    def puncture(self, code_bits: torch.Tensor) -> torch.Tensor:
        """``[..., n*T]`` mother-code bits -> ``[..., kept]`` wire bits."""
        steps = code_bits.shape[-1] // self.n
        return code_bits[..., self._indices(steps, code_bits.device)]

    def depuncture(self, llrs: torch.Tensor, steps: int) -> torch.Tensor:
        """``[..., kept]`` wire LLRs -> ``[..., n*T]`` with zero erasures."""
        idx = self._indices(steps, llrs.device)
        if llrs.shape[-1] != idx.numel():
            raise ValueError(
                f"{llrs.shape[-1]} LLRs for {idx.numel()} kept positions")
        out = torch.zeros(llrs.shape[:-1] + (self.n * steps,),
                          dtype=llrs.dtype, device=llrs.device)
        out[..., idx] = llrs
        return out

    def rate(self, mother_rate: float) -> float:
        return mother_rate * (self.n * self.period) / self.kept_per_period


def rate23_pattern() -> np.ndarray:
    """Rate 2/3 from rate 1/2 (the standard DVB/802.11 pattern)."""
    return np.array([[1, 1], [1, 0]])


def rate34_pattern() -> np.ndarray:
    """Rate 3/4 from rate 1/2 (the standard DVB/802.11 pattern)."""
    return np.array([[1, 1, 0], [1, 0, 1]])
