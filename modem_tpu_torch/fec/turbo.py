"""Turbo codes (LTE-shaped PCCC): RSC pair + QPP interleaver + max-log BCJR
(counterpart of :mod:`modem_tpu.fec.turbo`).

Two identical 8-state recursive systematic convolutional encoders,
feedback ``1 + D^2 + D^3`` and output ``1 + D + D^3``, the second fed
through the quadratic permutation polynomial interleaver ``pi(i) = (f1 i +
f2 i^2) mod K``; both trellises terminated with 3 tail bits, so the rate
is ``K/(3K + 12)``. Wire layout of a codeword: ``[sys K | par1 K | par2 K
| tail1 (3 sys, 3 par) | tail2 (3 sys, 3 par)]``. LLRs are positive for
bit 0.

* **Interleaving** is an index gather with ``pi`` (and its inverse).
* **The RSC encoder** is parallel over time: ``1/(1 + D^2 + D^3)`` is
  primitive, so its impulse response ``h`` has period 7 and the feedback
  bit is ``a_t = XOR_r h[(t - r) mod 7] P_r(t)``, where ``P_r(t)`` is the
  prefix XOR of the info bits ``u_j``, ``j <= t``, ``j = r mod 7``.
* **Decoding**: each half-iteration is one max-log BCJR pass. A CPU
  tensor takes the JAX package's own off-TPU route: the full-block
  :meth:`TurboCode._bcjr` for ``window=None``, the sliding-window
  ``bcjr_windowed`` (the JAX ``TurboCode._bcjr_windowed``, over K14's
  rows) for an explicit window. A CUDA tensor
  takes kernel K14 (:mod:`modem_tpu_torch.ops.bcjr_kernel`) at the JAX
  chip route's geometry: ``pick_geometry`` for ``window=None`` (one window
  over the whole trellis, the exact full-block BCJR for every built-in K
  up to 2048), ``pick_guard`` for an explicit window.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.bcjr_kernel import (NEG, bcjr_windowed, gammas, pick_guard,
                               scans)
from ..utils.cache import on_device

# LTE QPP parameters for a few standard block sizes (3GPP 36.212 table
# 5.1.3-3 entries); any (k, f1, f2) whose polynomial is a bijection works.
_QPP = {40: (3, 10), 64: (7, 16), 128: (15, 32), 256: (15, 32),
        512: (31, 64), 1024: (31, 64), 2048: (21, 120), 6144: (263, 480)}


def _impulse() -> np.ndarray:
    """One period of the impulse response of ``1/(1 + D^2 + D^3)``."""
    h = np.zeros(7, np.int64)
    for j in range(7):
        h[j] = (j == 0) ^ (h[j - 2] if j >= 2 else 0) ^ (
            h[j - 3] if j >= 3 else 0)
    return h


#: ``_H7[q, r] = h[(q - r) mod 7]``
_H7 = _impulse()[(np.arange(7)[:, None] - np.arange(7)[None, :]) % 7]


class TurboCode:
    """Rate ``K/(3K+12)`` LTE-shaped turbo code with max-log decoding."""

    def __init__(self, k: int = 1024, f1: int | None = None,
                 f2: int | None = None, iters: int = 6):
        self.k = int(k)
        if f1 is None or f2 is None:
            if k not in _QPP:
                raise ValueError(
                    f"no built-in QPP for K={k}; pass f1/f2 explicitly "
                    f"(built-ins: {sorted(_QPP)})")
            f1, f2 = _QPP[k]
        self.f1, self.f2 = int(f1), int(f2)
        i = np.arange(k, dtype=np.int64)
        pi = (self.f1 * i + self.f2 * i * i) % k
        if len(np.unique(pi)) != k:
            raise ValueError(f"QPP (f1={f1}, f2={f2}) is not a "
                             f"permutation mod {k}")
        self._pi = pi
        self._pinv = np.argsort(pi)
        self.iters = int(iters)
        self.n = 3 * self.k + 12

    # ---- RSC constituent encoder ----

    @staticmethod
    def _rsc(bits: torch.Tensor):
        """``[..., T]`` info bits -> (parity ``[..., T]``, tail_sys ``[...,
        3]``, tail_par ``[..., 3]``), int32. Feedback-terminated."""
        u = bits.to(torch.int32)
        t = u.shape[-1]
        m = -(-t // 7)
        dev = u.device
        up = torch.nn.functional.pad(u, (0, 7 * m - t))
        cum = torch.cumsum(up.reshape(up.shape[:-1] + (m, 7)), -2) & 1
        prev = torch.nn.functional.pad(cum, (0, 0, 1, 0))[..., :-1, :]
        q = torch.arange(7, device=dev)
        # P_r(7m + q) = cum[m, r] for r <= q, cum[m - 1, r] for r > q
        pr = torch.where(q[None, :] <= q[:, None], cum[..., None, :],
                         prev[..., None, :])                # [..., m, 7, 7]
        h = torch.as_tensor(_H7, dtype=torch.int32, device=dev)
        a = ((pr * h).sum(-1) & 1).reshape(up.shape)[..., :t].to(torch.int32)
        a3 = torch.nn.functional.pad(a, (3, 0))             # a_{t-3} at t
        par = a ^ a3[..., 2:t + 2] ^ a3[..., :t]  # a_t ^ a_{t-1} ^ a_{t-3}
        s = [a3[..., t + 2], a3[..., t + 1], a3[..., t]]    # a_{T-1..T-3}
        ts, tp = [], []
        for _ in range(3):
            ts.append(s[1] ^ s[2])
            tp.append(s[0] ^ s[2])
            s = [torch.zeros_like(s[0]), s[0], s[1]]
        return par, torch.stack(ts, -1), torch.stack(tp, -1)

    def encode(self, bits: torch.Tensor) -> torch.Tensor:
        """``[..., K]`` info bits -> ``[..., 3K+12]`` int32 codeword."""
        if bits.shape[-1] != self.k:
            raise ValueError(f"expected {self.k} bits, got {bits.shape[-1]}")
        b = bits.to(torch.int32)
        par1, t1s, t1p = self._rsc(b)
        par2, t2s, t2p = self._rsc(self._il(b))
        return torch.cat([b, par1, par2, t1s, t1p, t2s, t2p], -1)

    # ---- max-log BCJR for one constituent (the CPU routes) ----

    def _bcjr(self, lsys, lpar, la, t_sys, t_par):
        """One full-block max-log BCJR pass: info-section LLRs ``[..., T]``
        and this constituent's tail LLRs ``[..., 3]`` -> extrinsics ``[...,
        T]``."""
        t = lsys.shape[-1]
        lu = torch.cat([lsys + la, t_sys], -1)
        lp = torch.cat([lpar, t_par], -1)
        gam = torch.movedim(gammas(lu, lp), -3, 0)           # [T+3, ..., 8, 2]
        a0 = torch.full(lsys.shape[:-1] + (8,), float(NEG),
                        device=lsys.device)
        a0[..., 0] = 0.0
        app = torch.movedim(scans(gam, a0, a0.clone(), t), 0, -1)
        return app - (lsys + la)

    # ---- interleaving ----

    def _il(self, x: torch.Tensor) -> torch.Tensor:
        """Interleave ``y[i] = x[pi[i]]``."""
        return x[..., on_device(self, "pi", lambda: self._pi, torch.long,
                                x.device)]

    def _dil(self, x: torch.Tensor) -> torch.Tensor:
        """Deinterleave ``y[pi[i]] = x[i]``."""
        return x[..., on_device(self, "pinv", lambda: self._pinv, torch.long,
                                x.device)]

    def _half(self, window: int | None, guard: int, cuda: bool):
        """The half-iteration of :meth:`decode`'s route: on the card K14 at
        the JAX chip route's geometry, on the CPU its off-TPU forms."""
        if window is None:
            if cuda:
                return lambda *a: bcjr_windowed(*a, None, int(guard))
            return self._bcjr
        g = pick_guard(int(window), int(guard)) if cuda else int(guard)
        return lambda *a: bcjr_windowed(*a, int(window), g)

    def decode(self, llrs: torch.Tensor, iters: int | None = None,
               window: int | None = None, guard: int = 32,
               early_exit: bool = False) -> torch.Tensor:
        """``[..., 3K+12]`` channel LLRs -> ``[..., K]`` int32 hard info bits
        after ``iters`` max-log turbo iterations (``self.iters`` by
        default).

        ``window``: the half-iterations' window (module docstring for the
        route each device takes). ``early_exit``: stop once no codeword's
        hard decisions changed in the last full iteration (``iters`` stays
        the cap), as the JAX package's ``lax.while_loop`` does; the flag is
        read on the host after each iteration.
        """
        if llrs.shape[-1] != self.n:
            raise ValueError(f"expected {self.n} LLRs, got {llrs.shape[-1]}")
        it = self.iters if iters is None else int(iters)
        bcjr = self._half(window, guard, llrs.is_cuda)
        k = self.k
        x = llrs.to(torch.float32)
        ls, lp1, lp2 = x[..., :k], x[..., k:2 * k], x[..., 2 * k:3 * k]
        t1s, t1p = x[..., 3 * k:3 * k + 3], x[..., 3 * k + 3:3 * k + 6]
        t2s, t2p = x[..., 3 * k + 6:3 * k + 9], x[..., 3 * k + 9:]
        ls2 = self._il(ls)
        la1 = torch.zeros_like(ls)
        le1 = torch.zeros_like(ls)

        def one_iter(la1):
            le1 = bcjr(ls, lp1, la1, t1s, t1p)
            le2 = bcjr(ls2, lp2, self._il(le1), t2s, t2p)
            return self._dil(le2), le1

        if early_exit:
            prev = torch.full(ls.shape, -1, dtype=torch.int8, device=x.device)
            i, changed = 0, True
            while i < it and changed:
                la1, le1 = one_iter(la1)
                hard = ((ls + la1 + le1) < 0).to(torch.int8)
                changed = bool(torch.any(hard != prev))
                prev, i = hard, i + 1
        else:
            for _ in range(it):
                la1, le1 = one_iter(la1)
        return ((ls + la1 + le1) < 0).to(torch.int32)
