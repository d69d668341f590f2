"""Polar codes: Arikan butterfly encoder, SC and CRC-aided SCL decoders, and
rate matching (counterpart of :mod:`modem_tpu.fec.polar`).

* **Construction** is the JAX package's, in float64 numpy: the
  Bhattacharyya/BEC recursion ``z -> [2z - z^2, z^2]`` for a uniform
  channel, the u-domain recursion for per-bit erasure probabilities (rate
  matching), so ``frozen`` and ``data_idx`` are the same.
* **Encoding** is the ``F^{(x)n}`` butterfly, ``log2 n`` stages of XOR;
  placing the data bits and taking them back out are index gathers.
* **SC decoding** (:meth:`PolarCode.decode`) runs kernel K15
  (:mod:`modem_tpu_torch.ops.sc_kernel`) on a CUDA tensor for ``2 <= n <=
  1024``, the plain recursion :meth:`PolarCode._sc` (min-sum ``f``,
  ``g``, leaves ``llr < 0``) on a CPU tensor and for longer codes.
* **SCL decoding** (:meth:`PolarCode.decode_list`) runs kernel K16
  (:mod:`modem_tpu_torch.ops.scl_kernel`) on a CUDA tensor at
  ``list_size == 8`` and ``2 <= n <= 1024``, the plain recursion
  :meth:`PolarCode._scl` otherwise. Survivors are the ``L`` smallest of
  ``2L`` candidate metrics in ``(metric, index)`` order (``lax.top_k``'s);
  a path reorder is a parent-index gather, composed down the tree as the
  JAX form composes its one-hot permutations. With a CRC, the winner is
  the lowest-metric path that passes it, else the lowest-metric path.

LLRs are positive for bit 0.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.sc_kernel import sc_decode
from ..ops.scl_kernel import scl_decode
from ..utils.cache import on_device


def _bhattacharyya_order(n_bits: int) -> np.ndarray:
    """Channel indices sorted most-reliable-first for N = 2^n_bits.

    BEC(0.5) z-parameter recursion in natural order: channel i of the N/2
    code splits into channel 2i (``z' = 2z - z^2``) and 2i+1 (``z' =
    z^2``) of the N code, tracked in the log domain."""
    logz = np.array([np.log(0.5)], np.float64)
    for _ in range(n_bits):
        z = np.exp(np.minimum(logz, 0.0))
        new = np.empty(2 * logz.size, np.float64)
        new[0::2] = logz + np.log(np.maximum(2.0 - z, 1e-300))
        new[1::2] = 2.0 * logz
        logz = new
    return np.argsort(logz)  # smallest z (most reliable) first


def _z_udomain(z: np.ndarray) -> np.ndarray:
    """Per-coded-bit BEC erasure probabilities ``z [N]`` -> u-domain ones
    in SC decode order: the top split pairs ``a = z[:N/2]`` with ``b =
    z[N/2:]``, ``a + b - ab`` feeding u[:N/2] and ``ab`` u[N/2:]."""
    if z.size == 1:
        return z
    half = z.size // 2
    a, b = z[:half], z[half:]
    return np.concatenate([_z_udomain(a + b - a * b), _z_udomain(a * b)])


def _cat(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Concatenate along the last axis, broadcasting a narrow (path
    independent) list axis."""
    if a.shape[-2] != b.shape[-2]:
        l_sz = max(a.shape[-2], b.shape[-2])
        a = a.expand(a.shape[:-2] + (l_sz, a.shape[-1]))
        b = b.expand(b.shape[:-2] + (l_sz, b.shape[-1]))
    return torch.cat([a, b], -1)


def _apply(parent, arr: torch.Tensor) -> torch.Tensor:
    """Reorder the list axis, ``out[:, l] = arr[:, parent[l]]``; None, or a
    path-independent ``arr`` (list axis 1), is the identity."""
    if parent is None or arr.shape[-2] == 1:
        return arr
    return arr.gather(1, parent[..., None].expand(-1, -1, arr.shape[-1]))


def _compose(p2, p1):
    """The parent index of ``p1`` followed by ``p2``: ``p1[p2[l]]``."""
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    return p1.gather(1, p2)


class PolarCode:
    """(N, K) polar code.

    ``n`` must be a power of two; the ``K`` most reliable synthetic
    channels carry data, the rest are frozen to zero. ``force_frozen``:
    u-positions frozen regardless of reliability; ``channel_z``: per
    coded bit erasure probabilities (default uniform 0.5).
    """

    _BIG = np.float32(1e30)  # metric of a not-yet-alive list path

    def __init__(self, n: int = 256, k: int = 128,
                 force_frozen=None, channel_z=None):
        if n & (n - 1) or n < 2:
            raise ValueError("n must be a power of two >= 2")
        if not 0 < k <= n:
            raise ValueError("need 0 < k <= n")
        self.n = int(n)
        self.k = int(k)
        self.n_bits = int(np.log2(n))
        if channel_z is None:
            order = _bhattacharyya_order(self.n_bits)
        else:
            z = np.asarray(channel_z, np.float64)
            if z.shape != (n,):
                raise ValueError(f"channel_z must have shape ({n},)")
            zu = _z_udomain(z)
            order = np.argsort(zu, kind="stable")
            self._z_u = zu
        if force_frozen is not None:
            banned = np.zeros(n, bool)
            banned[np.asarray(force_frozen, np.int64)] = True
            order = order[~banned[order]]
            if order.size < k:
                raise ValueError(
                    f"only {order.size} usable channels after "
                    f"force-freezing, need k={k}")
        if channel_z is not None and float(self._z_u[order[k - 1]]) >= 1.0:
            # only exact z == 1 channels are structurally undecodable
            raise ValueError(
                "k exceeds the number of usable synthetic channels for "
                "this puncturing pattern (selected a z=1 channel)")
        self.data_idx = np.sort(order[:k])          # ascending positions
        frozen = np.ones(n, bool)
        frozen[self.data_idx] = False
        self.frozen = frozen
        # placement gather: u = [bits, 0][..., place]
        place = np.full(n, k, np.int64)
        place[self.data_idx] = np.arange(k)
        self._place = place

    def _idx(self, name: str, device) -> torch.Tensor:
        src = self.data_idx if name == "data_idx" else self._place
        return on_device(self, name, lambda: src, torch.long, device)

    # ---- encoding ----

    def encode(self, bits: torch.Tensor) -> torch.Tensor:
        """``[..., K]`` data bits -> ``[..., N]`` int32 codeword (natural
        order, ``x = u F^{(x)n}``)."""
        if bits.shape[-1] != self.k:
            raise ValueError(f"expected {self.k} bits, got {bits.shape[-1]}")
        b = bits.to(torch.int32) & 1
        pad = torch.zeros(b.shape[:-1] + (1,), dtype=torch.int32,
                          device=b.device)
        x = torch.cat([b, pad], -1)[..., self._idx("place", b.device)]
        half = 1
        while half < self.n:
            blk = x.reshape(x.shape[:-1] + (self.n // (2 * half), 2, half))
            a = blk[..., 0, :] ^ blk[..., 1, :]
            x = torch.stack([a, blk[..., 1, :]], -2).reshape(x.shape)
            half *= 2
        return x

    # ---- SC ----

    @staticmethod
    def _f(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Check-node combine (min-sum): sign(a) sign(b) min(|a|, |b|)."""
        return torch.sign(a) * torch.sign(b) * torch.minimum(a.abs(), b.abs())

    @staticmethod
    def _g(a: torch.Tensor, b: torch.Tensor, x1: torch.Tensor) -> torch.Tensor:
        """Variable-node combine: b + (1 - 2 x1) a."""
        return b + (1.0 - 2.0 * x1.to(torch.float32)) * a

    def _sc(self, llr: torch.Tensor, lo: int, hi: int):
        """SC over u-positions ``[lo, hi)``: ``(u_hat, x_hat)``, both int32
        ``[..., hi-lo]``."""
        if hi - lo == 1:
            if self.frozen[lo]:
                u = torch.zeros(llr.shape, dtype=torch.int32,
                                device=llr.device)
            else:
                u = (llr < 0).to(torch.int32)
            return u, u
        half = (hi - lo) // 2
        la, lb = llr[..., :half], llr[..., half:]
        u1, x1 = self._sc(self._f(la, lb), lo, lo + half)
        u2, x2 = self._sc(self._g(la, lb, x1), lo + half, hi)
        return torch.cat([u1, u2], -1), torch.cat([x1 ^ x2, x2], -1)

    def decode(self, llrs: torch.Tensor) -> torch.Tensor:
        """``[..., N]`` channel LLRs -> ``[..., K]`` int32 hard data bits
        (successive cancellation)."""
        if llrs.shape[-1] != self.n:
            raise ValueError(f"expected {self.n} LLRs, got {llrs.shape[-1]}")
        batch = llrs.shape[:-1]
        u, _ = sc_decode(self, llrs.to(torch.float32).reshape(-1, self.n))
        data = u[:, self._idx("data_idx", u.device)].to(torch.int32)
        return data.reshape(batch + (self.k,))

    def decode_full(self, llrs: torch.Tensor) -> torch.Tensor:
        """Like :meth:`decode` but returns the re-encoded codeword estimate
        ``[..., N]`` int32."""
        if llrs.shape[-1] != self.n:
            raise ValueError(f"expected {self.n} LLRs, got {llrs.shape[-1]}")
        batch = llrs.shape[:-1]
        _, x = sc_decode(self, llrs.to(torch.float32).reshape(-1, self.n))
        return x.to(torch.int32).reshape(batch + (self.n,))

    # ---- SCL ----

    def initial_metrics(self, b: int, list_size: int, device) -> torch.Tensor:
        """``[b, L]``: path 0 alive at 0, the clones at ``2 * _BIG`` (never
        tying with a real path that fails the CRC, ``pm + _BIG``)."""
        pm0 = torch.full((list_size,), 2.0 * float(self._BIG),
                         dtype=torch.float32, device=device)
        pm0[0] = 0.0
        return pm0.expand(b, list_size)

    def _scl(self, llr, lo: int, hi: int, pm, list_size: int):
        """SCL over u-positions ``[lo, hi)``: ``llr [B, L|1, hi-lo]``
        path-conditional LLRs, ``pm [B, L]`` -> ``(u, x, pm, parent)``, u
        and x f32 {0,1} ``[B, L|1, hi-lo]`` in the post-selection order,
        ``parent [B, L]`` the composed reorder (None: identity)."""
        if hi - lo == 1:
            lam = llr[..., 0]                              # [B, L|1]
            if self.frozen[lo]:
                u = torch.zeros_like(lam)[..., None]
                return u, u, pm + torch.clamp_min(-lam, 0.0), None
            pm2 = torch.cat([pm + torch.clamp_min(-lam, 0.0),   # u = 0
                             pm + torch.clamp_min(lam, 0.0)],   # u = 1
                            -1)                                 # [B, 2L]
            vals, idx = torch.sort(pm2, dim=-1, stable=True)
            idx = idx[:, :list_size]
            u = (idx >= list_size).to(torch.float32)[..., None]
            return u, u, vals[:, :list_size], idx % list_size
        half = (hi - lo) // 2
        la, lb = llr[..., :half], llr[..., half:]
        u1, x1, pm, p1 = self._scl(self._f(la, lb), lo, lo + half, pm,
                                   list_size)
        if p1 is not None:
            ab = _apply(p1, llr)
            la, lb = ab[..., :half], ab[..., half:]
        g = lb + (1.0 - 2.0 * x1) * la
        u2, x2, pm, p2 = self._scl(g, lo + half, hi, pm, list_size)
        if p2 is not None:
            ux = _apply(p2, torch.cat([u1, x1], -1))
            u1, x1 = ux[..., :half], ux[..., half:]
        xor = x1 + x2 - 2.0 * x1 * x2
        return _cat(u1, u2), _cat(xor, x2), pm, _compose(p2, p1)

    def decode_list(self, llrs: torch.Tensor, list_size: int = 8,
                    crc=None) -> torch.Tensor:
        """``[..., N]`` channel LLRs -> ``[..., K]`` int32 hard data bits by
        SC list decoding with ``list_size`` paths (1 is SC). ``crc``: a
        :class:`~modem_tpu_torch.fec.Crc` over the tail of the K data bits;
        the winner is the lowest-metric path that passes it, else the
        lowest-metric path."""
        if llrs.shape[-1] != self.n:
            raise ValueError(f"expected {self.n} LLRs, got {llrs.shape[-1]}")
        if list_size < 1:
            raise ValueError("list_size must be >= 1")
        batch = llrs.shape[:-1]
        lam = llrs.to(torch.float32).reshape(-1, self.n)
        b = lam.shape[0]
        u, pm = scl_decode(self, lam, list_size)  # K16 on the card at 8
        data = (u[..., self._idx("data_idx", u.device)] > 0.5).to(
            torch.int32)                                   # [B, L, K]
        if crc is not None:
            ok = crc.check(data)
            pm = pm + torch.where(ok, 0.0, float(self._BIG))
        best = torch.argmin(pm, dim=-1)
        out = data[torch.arange(b, device=data.device), best]
        return out.reshape(batch + (self.k,))


class RateMatchedPolar:
    """Polar rate matching: E transmitted bits from an N = 2^n mother code
    (the 5G arrangement, NR 38.212-shaped). ``mode`` ``"auto"`` applies
    5G's rule:

    * **shortening** (E < N, rate > 7/16): drop the last N-E coded bits,
      whose u-tail is structurally frozen; the receiver knows them (LLR
      ``2^30``);
    * **puncturing** (E < N, rate <= 7/16): drop the first N-E coded bits
      (LLR 0), erased with certainty in the construction;
    * **repetition** (E > N): resend the first E-N coded bits, summing
      their LLRs at the receiver.
    """

    #: LLR of a shortened (known-zero) position: 2^30
    KNOWN_LLR = np.float32(2.0 ** 30)

    def __init__(self, k: int, e: int, n: int | None = None,
                 mode: str = "auto"):
        if e < 1:
            raise ValueError("need e >= 1")
        if n is None:
            n = 1 << max(2, int(np.ceil(np.log2(e))))
        if n & (n - 1) or n < 2:
            raise ValueError("n must be a power of two >= 2")
        if mode == "auto":
            if e > n:
                mode = "repeat"
            elif e == n:
                mode = "none"
            else:
                mode = "shorten" if k / e > 7.0 / 16.0 else "puncture"
        if mode not in ("none", "shorten", "puncture", "repeat"):
            raise ValueError(f"unknown mode {mode!r}")
        if mode in ("none", "shorten", "puncture") and e > n:
            raise ValueError(f"mode {mode!r} needs e <= n, got {e} > {n}")
        if mode == "repeat" and not n < e <= 2 * n:
            raise ValueError(f"repetition needs n < e <= 2n, got e={e}")
        if mode == "none" and e != n:
            raise ValueError("mode 'none' needs e == n")
        if k > min(e, n):
            raise ValueError(f"need k <= min(e, n) = {min(e, n)}")
        self.k, self.e, self.n, self.mode = int(k), int(e), int(n), mode
        m = abs(n - e)
        if mode == "shorten":
            z = np.full(n, 0.5)
            z[n - m:] = 0.0
            self.code = PolarCode(n, k, force_frozen=np.arange(n - m, n),
                                  channel_z=z)
        elif mode == "puncture":
            z = np.full(n, 0.5)
            z[:m] = 1.0
            self.code = PolarCode(n, k, channel_z=z)
        else:
            self.code = PolarCode(n, k)

    def encode(self, bits: torch.Tensor) -> torch.Tensor:
        """``[..., K]`` data bits -> ``[..., E]`` transmitted bits."""
        x = self.code.encode(bits)
        if self.mode == "shorten":
            return x[..., : self.e]
        if self.mode == "puncture":
            return x[..., self.n - self.e:]
        if self.mode == "repeat":
            return torch.cat([x, x[..., : self.e - self.n]], -1)
        return x

    def dematch(self, llrs: torch.Tensor) -> torch.Tensor:
        """``[..., E]`` received LLRs -> ``[..., N]`` mother-code LLRs."""
        if llrs.shape[-1] != self.e:
            raise ValueError(f"expected {self.e} LLRs, got {llrs.shape[-1]}")
        lam = llrs.to(torch.float32)
        pad = self.n - self.e
        if self.mode == "shorten":
            known = torch.full(lam.shape[:-1] + (pad,),
                               float(self.KNOWN_LLR), device=lam.device)
            return torch.cat([lam, known], -1)
        if self.mode == "puncture":
            return torch.cat([torch.zeros(lam.shape[:-1] + (pad,),
                                          device=lam.device), lam], -1)
        if self.mode == "repeat":
            r = self.e - self.n
            head = lam[..., :r] + lam[..., self.n:]
            return torch.cat([head, lam[..., r: self.n]], -1)
        return lam

    def decode(self, llrs: torch.Tensor) -> torch.Tensor:
        """``[..., E]`` LLRs -> ``[..., K]`` bits (SC on the mother code)."""
        return self.code.decode(self.dematch(llrs))

    def decode_list(self, llrs: torch.Tensor, list_size: int = 8,
                    crc=None) -> torch.Tensor:
        """``[..., E]`` LLRs -> ``[..., K]`` bits (CA-SCL on the mother
        code)."""
        return self.code.decode_list(self.dematch(llrs), list_size, crc=crc)
