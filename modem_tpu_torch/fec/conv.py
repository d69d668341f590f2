"""Convolutional coding: block encoder and Viterbi decoders (counterpart of
:mod:`modem_tpu.fec.conv`).

* **Encoder**: the shift-register recursion as a sum mod 2 of delayed bit
  planes per generator, parallel over time and channels.
* **Viterbi**: add-compare-select over all ``S = 2^(K-1)`` states, one
  butterfly per trellis step batched over channels, path metrics
  renormalised (minus their minimum) after every 8th step, decisions kept
  for a traceback. :meth:`ConvCode._acs` is that recursion in plain
  PyTorch, step by step as the JAX package's ``_acs`` computes it, so the
  decisions are bit-identical to it.

The full-block decoders (:meth:`~ConvCode.decode_soft`,
:meth:`~ConvCode.decode_hard`) run ``_acs`` on every device: the JAX
package has no kernel for them either, and on the card they are a Python
loop over the trellis steps. The windowed decoders
(:meth:`~ConvCode.decode_soft_windowed`, :class:`StreamingViterbi`) run
kernel K13 (:mod:`modem_tpu_torch.ops.viterbi_kernel`) on a CUDA tensor and
``_acs`` on a CPU one.

The trellis is terminated: ``encode`` appends ``K-1`` zero flush bits and
the decoders track back from state 0 (soft: minimum correlation cost
``sum llr_j * c_j``, positive LLR = bit 0).
"""

from __future__ import annotations

import numpy as np
import torch

from ..cuda import resolve_device
from ..ops.viterbi_kernel import (BIG, RENORM, viterbi_decode_stream,
                                  viterbi_decode_windows)
from ..utils.cache import on_device

#: Guard branch cost for padding *before* the stream start: a transition
#: that emits a 1-bit there is effectively forbidden, so the path metric
#: stays pinned to the all-zero state. It turns a free-running window start
#: into the exact terminated-trellis start without special-casing window 0.
_GUARD = np.float32(1e6)


class ConvCode:
    """Rate ``1/n`` convolutional code, constraint length ``K``.

    ``polys``: generator polynomials as integers whose bit ``K-1-t`` taps
    input delay ``t`` (the octal convention: the K=7 CCSDS/Voyager code is
    ``ConvCode(7, (0o171, 0o133))``).
    """

    def __init__(self, constraint: int, polys: tuple[int, ...]):
        if constraint < 2:
            raise ValueError("constraint length must be >= 2")
        for g in polys:
            if g >= 1 << constraint:
                raise ValueError(f"polynomial {g:o} exceeds {constraint} bits")
        self.k = int(constraint)
        self.polys = tuple(int(g) for g in polys)
        self.n = len(self.polys)
        self.n_states = 1 << (self.k - 1)

        # Butterfly tables: for each target state s', its two predecessors
        # (differing in the dropped oldest bit) and the code bits emitted on
        # those transitions. The input bit that led to s' is its top bit.
        s = np.arange(self.n_states)
        self._in_bit = (s >> (self.k - 2)).astype(np.int32)
        ps0 = (s << 1) & (self.n_states - 1)
        self._pred = np.stack([ps0, ps0 | 1], axis=0).astype(np.int32)
        # register r = (b << (K-1)) | pred_state; outputs per generator
        outs = np.zeros((2, self.n_states, self.n), np.float32)
        for d in (0, 1):
            r = (self._in_bit << (self.k - 1)) | self._pred[d]
            for j, g in enumerate(self.polys):
                v = r & g
                par = np.zeros_like(v)
                for t in range(self.k):
                    par ^= (v >> t) & 1
                outs[d, :, j] = par
        self._outs = outs  # [2, S, n] code bits on (pred d) -> s'

    # ---- encoder ----

    def encode(self, bits: torch.Tensor) -> torch.Tensor:
        """``[..., L]`` data bits -> ``[..., n*(L+K-1)]`` code bits
        (terminated; time-major ``c_0[0], c_1[0], ..., c_0[1]``)."""
        km1 = self.k - 1
        zeros = torch.zeros(bits.shape[:-1] + (km1,), dtype=bits.dtype,
                            device=bits.device)
        b = torch.cat([bits, zeros], dim=-1)
        t = b.shape[-1]
        bp = torch.cat([zeros, b], dim=-1)  # bp[..., i] = b[i - (K-1)]
        outs = []
        for g in self.polys:
            acc = torch.zeros_like(b)
            for tap in range(self.k):
                if (g >> (self.k - 1 - tap)) & 1:
                    acc = acc + bp[..., km1 - tap:km1 - tap + t]
            outs.append(acc % 2)
        c = torch.stack(outs, dim=-1)  # [..., T, n]
        return c.reshape(c.shape[:-2] + (t * self.n,))

    # ---- Viterbi ----

    def _branch_costs(self, costs: torch.Tensor) -> tuple[torch.Tensor, ...]:
        """Per-step branch metrics ``(bm0, bm1)``, each ``[..., T, S]``:
        ``sum_j out[d, s, j] * costs[..., t, j]`` summed in the order
        ``j = 0..n-1``."""
        outs = on_device(self, "outs", lambda: self._outs, torch.float32,
                         costs.device)
        bms = []
        for d in (0, 1):
            bm = outs[d, :, 0] * costs[..., 0:1]
            for j in range(1, self.n):
                bm = bm + outs[d, :, j] * costs[..., j:j + 1]
            bms.append(bm)
        return tuple(bms)

    def _acs(self, costs: torch.Tensor, pm0: torch.Tensor | None = None,
             end_state=None, trim: bool = True,
             end_bias: torch.Tensor | None = None):
        """``costs [..., T, n]`` per-step per-branch-bit costs (a
        transition costs the sum of ``costs[..., k, j]`` over its 1-bits)
        -> terminated-ML data bits ``[..., T - (K-1)]`` int32.

        ``pm0``: ``[..., S]`` initial path metrics (default: state 0 only,
        the terminated start). ``end_state``: traceback start; default 0,
        ``"argmin"`` for the first best final state, or a ``[...]`` tensor
        of states. ``end_bias``: ``[..., S]`` added to the final metrics
        before the argmin (pins selected rows to a known end state).

        As in the JAX package the front is padded to a multiple of 8 steps,
        with guard steps (terminated start: held at state 0) or zero steps
        (free start: metrics unchanged), and the metrics are renormalised
        after every 8th padded step; the subtraction rounds, so that cadence
        is part of the result.
        """
        s = self.n_states
        t_in = costs.shape[-2]
        pad = (-t_in) % RENORM
        costs = costs.to(torch.float32)
        dev = costs.device
        if pad:
            fill = float(_GUARD) if pm0 is None else 0.0
            g = torch.full(costs.shape[:-2] + (pad, self.n), fill,
                           dtype=costs.dtype, device=dev)
            costs = torch.cat([g, costs], dim=-2)
        tp = t_in + pad
        batch = costs.shape[:-2]
        bm0, bm1 = self._branch_costs(costs)

        if pm0 is None:
            pm = torch.full(batch + (s,), float(BIG), device=dev)
            pm[..., 0] = 0.0
        else:
            pm = pm0.to(torch.float32).expand(batch + (s,))
        dec = torch.empty((tp,) + batch + (s,), dtype=torch.bool, device=dev)
        for k in range(tp):
            e, o = pm[..., 0::2], pm[..., 1::2]
            c0 = torch.cat([e, e], dim=-1) + bm0[..., k, :]
            c1 = torch.cat([o, o], dim=-1) + bm1[..., k, :]
            d = c1 < c0
            pm = torch.where(d, c1, c0)
            dec[k] = d
            if k % RENORM == RENORM - 1:
                pm = pm - torch.amin(pm, dim=-1, keepdim=True)

        if end_state is None:
            state = torch.zeros(batch, dtype=torch.long, device=dev)
        elif isinstance(end_state, str) and end_state == "argmin":
            if end_bias is not None:
                pm = pm + end_bias
            state = torch.argmin(pm, dim=-1)
        else:
            state = torch.as_tensor(end_state, device=dev).long().expand(batch)
        bits = torch.empty((tp,) + batch, dtype=torch.int32, device=dev)
        for k in range(tp - 1, -1, -1):
            bits[k] = state >> (self.k - 2)  # the input bit that led here
            d = torch.gather(dec[k], -1, state[..., None])[..., 0]
            state = ((state << 1) & (s - 1)) | d.long()
        bits = torch.movedim(bits, 0, -1)[..., pad:]
        if not trim:
            return bits
        return bits[..., : bits.shape[-1] - (self.k - 1)]

    def decode_soft(self, llrs: torch.Tensor) -> torch.Tensor:
        """``[..., n*T]`` per-code-bit LLRs (positive = bit 0) -> ML data
        bits ``[..., T-(K-1)]`` (the full-block recursion on any device)."""
        t = llrs.shape[-1] // self.n
        return self._acs(llrs.reshape(llrs.shape[:-1] + (t, self.n)))

    def decode_hard(self, code_bits: torch.Tensor) -> torch.Tensor:
        """``[..., n*T]`` hard code bits -> minimum-Hamming-distance data
        bits (soft decode with ``llr = 1 - 2*bit``)."""
        lam = 1.0 - 2.0 * code_bits.to(torch.float32)
        t = lam.shape[-1] // self.n
        return self._acs(lam.reshape(lam.shape[:-1] + (t, self.n)))

    def rate(self) -> float:
        return 1.0 / self.n

    # ---- windowed (truncated-traceback) decoding ----

    def decode_soft_windowed(self, llrs: torch.Tensor, block_steps: int,
                             halo_steps: int | None = None) -> torch.Tensor:
        """Overlapped-window decode: windows of ``block_steps`` with
        ``halo_steps`` of context on each side (free start, argmin end,
        default halo ``10·K``), each an independent row, only the interiors
        kept. Guard costs on both flanks pin window 0 to the terminated
        start and the last window to the state-0 end. Kernel K13 on a CUDA
        tensor, :meth:`_acs` on a CPU one; the two decide bit for bit
        alike, and as the JAX package's ``backend="xla"`` and ``"pallas"``
        forms do."""
        t = llrs.shape[-1] // self.n
        lam = llrs.reshape(llrs.shape[:-1] + (t, self.n))
        h = 10 * self.k if halo_steps is None else int(halo_steps)
        return viterbi_decode_stream(self, lam, int(block_steps), h, _GUARD)


class StreamingViterbi:
    """Constant-memory streaming Viterbi over an unbounded LLR stream.

    Push fixed blocks of ``block_steps`` trellis steps (``n·block_steps``
    LLRs); each push returns the decisions of the *previous* block (one
    block of latency buys the right-side traceback context). ``flush``
    returns the final block without the ``K-1`` flush bits. Each window
    decode is kernel K13 on a CUDA stream and :meth:`ConvCode._acs` on a
    CPU one. The carry (previous block and the ``h`` steps before it) has
    the JAX class's form: :meth:`set_state` takes its ``_prev`` and
    ``_pretail`` as numpy arrays, so a stream started there goes on here.
    """

    def __init__(self, code: ConvCode, block_steps: int,
                 halo_steps: int | None = None):
        self.code = code
        self.b = int(block_steps)
        self.h = 10 * code.k if halo_steps is None else int(halo_steps)
        if self.h < code.k:
            raise ValueError("halo must cover at least one constraint length")
        if self.b < self.h:
            raise ValueError(
                "block_steps must be >= halo (the right context of a block "
                "is the head of the next push)")
        self._prev = None      # [..., B, n] undecoded previous block
        self._pretail = None   # [..., h, n] steps before prev

    def _window_decode(self, pretail, prev, right, final: bool = False):
        win = torch.cat([pretail, prev, right], dim=-2)
        pin = torch.full(win.shape[:-2], 1.0 if final else 0.0,
                         device=win.device)
        bits = viterbi_decode_windows(self.code, win, pin)
        return bits[..., self.h:self.h + self.b]

    def push(self, llrs: torch.Tensor) -> torch.Tensor | None:
        """One block in; the previous block's decisions out (None first)."""
        t = llrs.shape[-1] // self.code.n
        if t != self.b:
            raise ValueError(f"push exactly {self.b} steps, got {t}")
        lam = llrs.reshape(llrs.shape[:-1] + (t, self.code.n)).to(
            torch.float32)
        if self._prev is None:
            self._prev = lam
            # pre-stream guard: pins the first window to the exact
            # terminated-trellis start
            self._pretail = torch.full(
                lam.shape[:-2] + (self.h, self.code.n), float(_GUARD),
                device=lam.device)
            return None
        out = self._window_decode(self._pretail, self._prev,
                                  lam[..., :self.h, :])
        self._pretail = torch.cat(
            [self._pretail, self._prev], dim=-2)[..., -self.h:, :]
        self._prev = lam
        return out

    def flush(self) -> torch.Tensor:
        """Decode the final buffered block; drops the K-1 flush bits."""
        if self._prev is None:
            raise ValueError("nothing buffered")
        right = torch.full(self._prev.shape[:-2] + (self.h, self.code.n),
                           float(_GUARD), device=self._prev.device)
        out = self._window_decode(self._pretail, self._prev, right,
                                  final=True)
        self._prev = None
        return out[..., : self.b - (self.code.k - 1)]

    def get_state(self) -> dict:
        """The carry: ``{"prev": [..., B, n], "pretail": [..., h, n]}``
        float32 (both None before the first push)."""
        return {"prev": self._prev, "pretail": self._pretail}

    def set_state(self, state, device: torch.device | str | None = None
                  ) -> None:
        """Restore a carry of :meth:`get_state`, or the numpy form of the
        JAX class's ``{"prev": _prev, "pretail": _pretail}``, on ``device``
        (the card unless the caller asks for the CPU)."""
        dev = resolve_device(device)

        def restore(x):
            if x is None:
                return None
            if not torch.is_tensor(x):
                x = np.array(x, np.float32)
            return torch.as_tensor(x, dtype=torch.float32, device=dev).clone()

        self._prev = restore(state["prev"])
        self._pretail = restore(state["pretail"])


def ccsds_code() -> ConvCode:
    """The standard K=7, rate-1/2 code (CCSDS/Voyager, g = 171/133 octal)."""
    return ConvCode(7, (0o171, 0o133))
