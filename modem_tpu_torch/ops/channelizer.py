"""Polyphase filter-bank channelizer: one wideband stream <-> M channels
(counterpart of :mod:`modem_tpu.ops.channelizer`).

The **synthesis** bank combines M channel-rate baseband streams into one
wideband stream at M x the rate (channel ``m`` translated to center ``m/M``
of the wideband rate); the **analysis** bank splits it back. Together they
put a bank of per-channel chains behind one wideband antenna.

* the commutator is a reshape: wideband <-> ``[..., K, M]`` phase matrix,
  its phase order reversed by ``torch.flip``;
* the per-phase filter is a ``taps_per_phase``-step multiply-add over the
  time axis of that matrix, in the JAX package's order (tap 0 first), in
  PyTorch ops: its taps differ per phase, so kernel K4 (one tap set shared
  by every row) does not fit;
* the M-point DFT across phases is one real ``[rows, M] @ [M, 2M]`` float32
  matmul against ``[cos | sin]`` (``torch.mm``; PyTorch's default keeps TF32
  off). Its rows go in tiles of a fixed count, :func:`dft_rows`, the last
  padded with zeros: every GEMM a bank issues has one shape whatever the
  block length, so the BLAS picks one kernel, with one order of summation,
  and a row's result does not depend on how the stream was cut;
* ``dft_dtype=torch.bfloat16`` rounds both operands to bfloat16 and
  multiplies them in float32, which is what the JAX package's bf16 dot with
  float32 accumulation computes (a product of two bfloat16 values is exact
  in float32);
* I/Q stay split real planes end to end.

Streaming: both banks carry explicit state (``analyze_stream``/
``synthesize_stream``: the commutator's last ``M-1`` wideband samples and
the filter's last ``J-1`` phase-matrix rows), so chunked streams equal one
shot bit for bit.

Design: the prototype lowpass is a Kaiser-windowed sinc at cutoff ``1/(2M)``
of the wideband rate (:func:`~modem_tpu_torch.ops.resample.design_lowpass`),
scaled to unit DC gain per phase. A bank's tables live on its ``device``,
the card unless the caller asks for the CPU.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..cuda import resolve_device
from .resample import design_lowpass

#: wideband samples a DFT tile holds: each GEMM takes ``dft_rows(m)`` rows
DFT_TILE = 1 << 20


def dft_rows(m: int) -> int:
    """Rows of every DFT GEMM of an ``m``-channel bank (a function of ``m``
    alone, so chunked and one-shot blocks make the same calls)."""
    return -(-DFT_TILE // m)


@lru_cache(maxsize=8)
def _bank(m: int, taps_per_phase: int, beta: float):
    """(h_poly [m, J] phases, cos/sin DFT matrices [m, m]) on the host."""
    l = m * taps_per_phase
    proto = design_lowpass(l, cutoff=1.0 / m, beta=beta).astype(np.float32)
    # each bank's prototype at unit DC gain per phase
    proto = proto * m / np.sum(proto)
    hp = proto.reshape(taps_per_phase, m).T.copy()     # h[j*m + p] -> [p, j]
    ang = 2.0 * np.pi * np.outer(np.arange(m), np.arange(m)) / m
    return (hp, np.cos(ang).astype(np.float32),
            np.sin(ang).astype(np.float32))


def _phase_filter(u: torch.Tensor, hp: torch.Tensor,
                  hist: torch.Tensor | None = None) -> torch.Tensor:
    """``u [..., K, M]`` phase matrix -> causally filtered with per-phase
    taps ``hp [M, J]`` along K. ``hist`` is the previous block's last
    ``J - 1`` phase-matrix rows (zeros if None)."""
    j = hp.shape[1]
    if hist is None:
        hist = u.new_zeros(u.shape[:-2] + (j - 1,) + u.shape[-1:])
    up = torch.cat([hist, u], dim=-2)
    k = u.shape[-2]
    acc = up[..., j - 1:j - 1 + k, :] * hp[:, 0]
    for t in range(1, j):
        acc = acc + up[..., j - 1 - t:j - 1 - t + k, :] * hp[:, t]
    return acc


def _carry_rows(hist: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Next filter history: the last ``hist.shape[-2]`` rows of hist+rows
    (robust to chunks shorter than the history and to zero history)."""
    h = hist.shape[-2]
    cat = torch.cat([hist, rows], dim=-2)
    return cat[..., cat.shape[-2] - h:, :]


class Channelizer:
    """Maximally-decimated M-channel PFB (analysis + synthesis).

    Channel ``m`` is centered at normalized wideband frequency ``m/M``
    (``m > M/2`` are negative frequencies). Streams are split-plane I/Q.
    ``dft_dtype=torch.bfloat16`` rounds the DFT's operands to bfloat16
    (about a 40 dB floor, ample for hard decisions); the outputs stay
    float32. The tables live on ``device``, the card unless the caller asks
    for the CPU; every tensor passed in must be there too.
    """

    def __init__(self, m: int, taps_per_phase: int = 12, beta: float = 9.0,
                 dft_dtype: torch.dtype = torch.float32,
                 device: torch.device | str | None = None):
        if m < 2:
            raise ValueError("need at least 2 channels")
        if dft_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError("dft_dtype must be torch.float32 or "
                             "torch.bfloat16")
        self.m = int(m)
        self.taps_per_phase = int(taps_per_phase)
        self.beta = float(beta)
        self.dft_dtype = dft_dtype
        self.device = resolve_device(device)
        hp, cmat, smat = _bank(self.m, self.taps_per_phase, self.beta)
        self.hp = torch.as_tensor(hp, device=self.device)
        w = torch.as_tensor(np.concatenate([cmat, smat], axis=1),
                            device=self.device)
        #: ``[cos | sin]`` [M, 2M], its values rounded to ``dft_dtype``
        self.dft_w = w.to(dft_dtype).to(torch.float32)

    def _dft(self, a: torch.Tensor, b: torch.Tensor):
        """(a @ cos, a @ sin, b @ cos, b @ sin) for ``[..., K, M]`` planes,
        the operands rounded to ``dft_dtype``, float32 products and sums,
        every GEMM ``dft_rows(M)`` rows (the DFT matrices are symmetric)."""
        m = self.m
        lead = a.shape[:-1]
        x = torch.cat([a.reshape(-1, m), b.reshape(-1, m)])
        if self.dft_dtype != torch.float32:
            x = x.to(self.dft_dtype).to(torch.float32)
        n = x.shape[0]
        r = dft_rows(m)
        tiles = max(-(-n // r), 1)
        if tiles * r != n:
            x = torch.cat([x, x.new_zeros((tiles * r - n, m))])
        out = x.new_empty((tiles * r, 2 * m))
        for t in range(tiles):
            torch.mm(x[t * r:(t + 1) * r], self.dft_w,
                     out=out[t * r:(t + 1) * r])
        h = n // 2
        ac, as_ = out[:h, :m], out[:h, m:]
        bc, bs = out[h:n, :m], out[h:n, m:]
        shape = lead + (m,)
        return (ac.reshape(shape), as_.reshape(shape), bc.reshape(shape),
                bs.reshape(shape))

    # ---- analysis: wideband [..., N] -> channels [..., M, N/M] ----

    def analyze(self, i: torch.Tensor, q: torch.Tensor):
        """One-shot analysis with zero history."""
        yi, yq, _ = self.analyze_stream(
            i, q, self.init_analyze_state(i.shape[:-1], i.dtype, i.device))
        return yi, yq

    def init_analyze_state(self, batch_shape: tuple = (),
                           dtype: torch.dtype = torch.float32,
                           device: torch.device | str | None = None) -> dict:
        """Zero streaming state: the last ``M-1`` wideband samples (the
        commutator lookback) and the last ``J-1`` phase-matrix rows (the
        per-phase filter history), per I/Q plane, on ``device`` (the
        bank's when None)."""
        m, j = self.m, self.taps_per_phase
        dev = self.device if device is None else device
        w = torch.zeros(tuple(batch_shape) + (m - 1,), dtype=dtype,
                        device=dev)
        u = torch.zeros(tuple(batch_shape) + (j - 1, m), dtype=dtype,
                        device=dev)
        return {"wi": w, "wq": w, "ui": u, "uq": u}

    def analyze_stream(self, i: torch.Tensor, q: torch.Tensor, state: dict):
        """Streaming analysis: chunked == one-shot, bit for bit. Returns
        ``(yi, yq, new_state)``; the chunk length must divide by M."""
        m = self.m
        n = i.shape[-1]
        if n % m:
            raise ValueError(f"wideband length {n} must divide by M={m}")

        def phases(x, tail):
            # u[k, r] = x[kM + (M-1-r) - (M-1)]: prepend the carried M-1
            # samples, drop the same count at the end, reshape, flip
            xp = torch.cat([tail, x[..., : n - (m - 1)]], dim=-1)
            return torch.flip(xp.reshape(x.shape[:-1] + (n // m, m)), (-1,))

        ui = phases(i, state["wi"])
        uq = phases(q, state["wq"])
        vi = _phase_filter(ui, self.hp, state["ui"])   # [..., K, M]
        vq = _phase_filter(uq, self.hp, state["uq"])
        # y_m = sum_p e^{+j 2pi m p / M} v_p
        ic, is_, qc, qs = self._dft(vi, vq)
        yi = ic - qs
        yq = is_ + qc
        new_state = {
            "wi": i[..., n - (m - 1):], "wq": q[..., n - (m - 1):],
            "ui": _carry_rows(state["ui"], ui),
            "uq": _carry_rows(state["uq"], uq),
        }
        return (torch.movedim(yi, -1, -2), torch.movedim(yq, -1, -2),
                new_state)

    # ---- synthesis: channels [..., M, K] -> wideband [..., M*K] ----

    def synthesize(self, ci: torch.Tensor, cq: torch.Tensor):
        """One-shot synthesis with zero history."""
        wi, wq, _ = self.synthesize_stream(
            ci, cq,
            self.init_synthesize_state(ci.shape[:-2], ci.dtype, ci.device))
        return wi, wq

    def init_synthesize_state(self, batch_shape: tuple = (),
                              dtype: torch.dtype = torch.float32,
                              device: torch.device | str | None = None
                              ) -> dict:
        """Zero streaming state: the last ``J-1`` modulated phase rows, on
        ``device`` (the bank's when None)."""
        dev = self.device if device is None else device
        z = torch.zeros(tuple(batch_shape) + (self.taps_per_phase - 1,
                                              self.m), dtype=dtype,
                        device=dev)
        return {"zi": z, "zq": z}

    def synthesize_stream(self, ci: torch.Tensor, cq: torch.Tensor,
                          state: dict):
        """Streaming synthesis: chunked == one-shot, bit for bit. Returns
        ``(wi, wq, new_state)``."""
        m = self.m
        if ci.shape[-2] != m:
            raise ValueError(f"expected {m} channels, got {ci.shape[-2]}")
        yi = torch.movedim(ci, -2, -1)  # [..., K, M]
        yq = torch.movedim(cq, -2, -1)
        # z_p = sum_m e^{+j 2pi m p / M} y_m  (modulate each channel up)
        ic, is_, qc, qs = self._dft(yi, yq)
        zi = ic - qs
        zq = is_ + qc
        wi = _phase_filter(zi, self.hp, state["zi"]) / m  # x[kM+p]
        wq = _phase_filter(zq, self.hp, state["zq"]) / m
        new_state = {"zi": _carry_rows(state["zi"], zi),
                     "zq": _carry_rows(state["zq"], zq)}
        return (wi.reshape(wi.shape[:-2] + (-1,)),
                wq.reshape(wq.shape[:-2] + (-1,)), new_state)
