"""Reed–Solomon codes over GF(256), errors-only (counterpart of
:mod:`modem_tpu.fec.rs`): the outer code of the classic concatenated
stack, RS ⊗ interleave ⊗ convolutional.

An RS code is GF(2)-linear, so the systematic encoder and the syndromes are
each one bit-matrix product mod 2, built on the host from the same
remainders as the JAX package and evaluated as a float32 product and a
remainder (exact: sums of at most 8·n ones). Berlekamp–Massey runs
inversionless over its fixed ``2t`` steps, batched over codewords; Chien
and Forney evaluate every position at once.

GF(256) arithmetic on the device takes the values from tables: a 64 K
product table and a 256-entry inverse, indexed by tensors. (The JAX
package multiplies bit-sliced and inverts as ``x^254`` because table
lookups are slow on the TPU; the values are the same, so ``msg`` and
``ok`` equal the JAX decoder's on every input.)
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..utils.cache import on_device


# ---------------------------------------------------------------------------
# GF(256) host tables
# ---------------------------------------------------------------------------

def _gf_tables(primitive: int):
    exp = np.zeros(512, np.int64)
    log = np.zeros(256, np.int64)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= primitive
    exp[255:510] = exp[:255]
    return exp, log


def _gmul_np(a, b, exp, log):
    if a == 0 or b == 0:
        return 0
    return int(exp[log[a] + log[b]])


def _bitmat_of_const(c: int, exp, log) -> np.ndarray:
    """8x8 GF(2) matrix M with bits(c ⊗ v) = M @ bits(v); bit 0 = LSB."""
    m = np.zeros((8, 8), np.uint8)
    for b in range(8):
        p = _gmul_np(c, 1 << b, exp, log)
        for r in range(8):
            m[r, b] = (p >> r) & 1
    return m


def _xor_fold(x: torch.Tensor) -> torch.Tensor:
    """XOR-reduce the last axis (GF addition), log-depth."""
    n = x.shape[-1]
    while n > 1:
        h = n // 2
        head = x[..., :h] ^ x[..., h:2 * h]
        x = head if n % 2 == 0 else torch.cat([head, x[..., 2 * h:]], dim=-1)
        n = x.shape[-1]
    return x[..., 0]


_MSB_WEIGHTS = (128, 64, 32, 16, 8, 4, 2, 1)


# ---------------------------------------------------------------------------
# The code
# ---------------------------------------------------------------------------

class ReedSolomon:
    """RS(n, k) over GF(256), errors-only decoding, ``t = (n-k)//2``.

    ``n < 255`` gives the shortened code (leading symbols implicitly zero).
    ``fcr``: first consecutive root exponent. Symbols are ints 0..255 on
    the last axis; the ``*_bits`` variants take 8 bits per symbol, MSB
    first.
    """

    def __init__(self, n: int = 255, k: int = 223,
                 primitive: int = 0x11D, fcr: int = 1):
        if not 0 < k < n <= 255:
            raise ValueError("need 0 < k < n <= 255")
        if (n - k) % 2:
            raise ValueError("n - k must be even (t whole)")
        self.n, self.k = int(n), int(k)
        self.p = self.n - self.k
        self.t = self.p // 2
        self.fcr = int(fcr)
        self.primitive = int(primitive)
        self._exp, self._log = _gf_tables(primitive)
        # generator polynomial, low degree first, g[p] = 1
        g = np.zeros(self.p + 1, np.int64)
        g[0] = 1
        deg = 0
        for i in range(self.p):
            root = int(self._exp[(self.fcr + i) % 255])
            ng = np.zeros_like(g)
            for d in range(deg + 1):
                ng[d + 1] ^= g[d]
                ng[d] ^= _gmul_np(int(g[d]), root, self._exp, self._log)
            g = ng
            deg += 1
        self._gen = g  # [p+1]

    # ---- host-built GF(2) matrices ----

    def _xd_mod_g(self, d: int) -> np.ndarray:
        """coeffs (low-first, length p) of x^d mod g(x)."""
        r = np.zeros(self.p, np.int64)
        if d < self.p:
            r[d] = 1
            return r
        r[self.p - 1] = 1  # x^(p-1)
        for _ in range(d - (self.p - 1)):
            top = int(r[self.p - 1])
            r[1:] = r[:-1]
            r[0] = 0
            if top:
                for j in range(self.p):
                    r[j] ^= _gmul_np(top, int(self._gen[j]),
                                     self._exp, self._log)
        return r

    @lru_cache(maxsize=4)
    def _encode_matrix(self) -> np.ndarray:
        """H [k*8, p*8]: parity bits = msg bits @ H (mod 2), MSB first."""
        h = np.zeros((self.k * 8, self.p * 8), np.uint8)
        # incremental: rem_d = x^(p + deg) mod g for msg index i with
        # deg = k-1-i; start at deg 0 and multiply by x each step.
        rem = self._xd_mod_g(self.p)  # deg 0
        rems = [rem.copy()]
        for _ in range(1, self.k):
            top = int(rem[self.p - 1])
            rem[1:] = rem[:-1]
            rem[0] = 0
            if top:
                for j in range(self.p):
                    rem[j] ^= _gmul_np(top, int(self._gen[j]),
                                       self._exp, self._log)
            rems.append(rem.copy())
        for i in range(self.k):
            r = rems[self.k - 1 - i]  # msg index i has degree k-1-i
            for c in range(self.p):
                m = _bitmat_of_const(int(r[c]), self._exp, self._log)
                # parity array index p-1-c holds degree c, MSB-first bits
                for ob in range(8):
                    for ib in range(8):
                        h[i * 8 + (7 - ib), (self.p - 1 - c) * 8 + (7 - ob)] \
                            = m[ob, ib]
        return h

    @lru_cache(maxsize=4)
    def _syndrome_matrix(self) -> np.ndarray:
        """Hs [n*8, 2t*8]: syndrome bits = recv bits @ Hs (mod 2)."""
        hs = np.zeros((self.n * 8, self.p * 8), np.uint8)
        for i in range(self.n):
            d = self.n - 1 - i  # degree of position i
            for j in range(self.p):
                c = int(self._exp[((self.fcr + j) * d) % 255])
                m = _bitmat_of_const(c, self._exp, self._log)
                for ob in range(8):
                    for ib in range(8):
                        hs[i * 8 + (7 - ib), j * 8 + (7 - ob)] = m[ob, ib]
        return hs

    def _mul_table(self) -> np.ndarray:
        """[256 * 256] GF products, ``a * 256 + b`` -> ``a ⊗ b``."""
        la = self._log[np.arange(256)]
        t = self._exp[la[:, None] + la[None, :]]
        t[0, :] = 0
        t[:, 0] = 0
        return t.reshape(-1)

    def _inv_table(self) -> np.ndarray:
        """[256] inverses, 0 -> 0 (the values of ``x^254``)."""
        inv = self._exp[(255 - self._log[np.arange(256)]) % 255].copy()
        inv[0] = 0
        return inv

    def _table(self, name: str, device) -> torch.Tensor:
        make = {"mul": self._mul_table, "inv": self._inv_table,
                "enc": self._encode_matrix, "syn": self._syndrome_matrix}
        dtype = torch.float32 if name in ("enc", "syn") else torch.int32
        return on_device(self, name, make[name], dtype, device)

    def _power_table(self, key: str, powers: np.ndarray, device
                     ) -> torch.Tensor:
        """``alpha^powers`` (a host table of exponents) as int32 on
        ``device``; a negative exponent marks an entry that is 0."""
        def make():
            out = self._exp[np.maximum(powers, 0)]
            return np.where(powers < 0, 0, out)
        return on_device(self, key, make, torch.int32, device)

    # ---- bit/symbol packing ----

    @staticmethod
    def _to_bits(sym: torch.Tensor) -> torch.Tensor:
        sh = torch.arange(7, -1, -1, device=sym.device, dtype=sym.dtype)
        b = (sym[..., None] >> sh) & 1  # MSB first
        return b.reshape(sym.shape[:-1] + (sym.shape[-1] * 8,))

    @staticmethod
    def _to_syms(bits: torch.Tensor) -> torch.Tensor:
        b = bits.reshape(bits.shape[:-1] + (bits.shape[-1] // 8, 8))
        w = torch.tensor(_MSB_WEIGHTS, dtype=b.dtype, device=b.device)
        return torch.sum(b * w, dim=-1, dtype=b.dtype)

    # ---- device GF helpers (table lookups) ----

    def _gmul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Elementwise GF(256) multiply, broadcasting."""
        mul = self._table("mul", a.device)
        return mul[a.long() * 256 + b.long()]

    def _ginv(self, x: torch.Tensor) -> torch.Tensor:
        """Inverse for x != 0; maps 0 -> 0."""
        return self._table("inv", x.device)[x.long()]

    def _gf2_product(self, name: str, bits: torch.Tensor) -> torch.Tensor:
        """``bits @ matrix (mod 2)`` for the host-built ``name`` matrix,
        int32."""
        m = self._table(name, bits.device)
        return torch.remainder(bits.to(torch.float32) @ m, 2.0).to(torch.int32)

    # ---- public API ----

    def encode(self, msg: torch.Tensor) -> torch.Tensor:
        """``[..., k]`` symbols -> ``[..., n]`` systematic codeword."""
        if msg.shape[-1] != self.k:
            raise ValueError(f"expected {self.k} symbols, got {msg.shape[-1]}")
        msg = msg.to(torch.int32)
        par = self._gf2_product("enc", self._to_bits(msg))
        return torch.cat([msg, self._to_syms(par)], dim=-1)

    def encode_bits(self, bits: torch.Tensor) -> torch.Tensor:
        """``[..., k*8]`` bits -> ``[..., n*8]`` codeword bits."""
        return self._to_bits(self.encode(self._to_syms(bits)))

    def syndromes(self, recv: torch.Tensor) -> torch.Tensor:
        """``[..., n]`` received symbols -> ``[..., 2t]`` syndromes."""
        return self._to_syms(self._gf2_product(
            "syn", self._to_bits(recv.to(torch.int32))))

    def _berlekamp(self, s: torch.Tensor):
        """Inversionless BM: syndromes ``[..., 2t]`` -> (Λ ``[..., t+1]``,
        L ``[...]``) with Λ low-degree-first (Λ[0] ∝ 1)."""
        lt = self.t + 1
        batch = s.shape[:-1]
        dev = s.device
        c = torch.zeros(batch + (lt,), dtype=torch.int32, device=dev)
        c[..., 0] = 1
        b = c.clone()
        l = torch.zeros(batch, dtype=torch.int32, device=dev)
        bb = torch.ones(batch, dtype=torch.int32, device=dev)

        # the windows S[r-j], j = 0..t, of every step r: one gather by a
        # host-built index, zero before S[0]
        idx = np.arange(self.p)[:, None] - np.arange(lt)[None, :]
        gather = on_device(self, "bm_idx", lambda: np.maximum(idx, 0),
                           torch.long, dev)
        valid = on_device(self, "bm_valid", lambda: idx >= 0, torch.bool,
                          dev)
        wins = torch.where(valid, s[..., gather], 0)  # [..., 2t, t+1]
        for r in range(self.p):
            d = _xor_fold(self._gmul(c, wins[..., r, :]))
            bs = torch.cat([torch.zeros_like(b[..., :1]), b[..., :-1]], dim=-1)
            c_new = self._gmul(bb[..., None], c) ^ self._gmul(d[..., None], bs)
            upd = (d != 0) & (2 * l <= r)
            b = torch.where(upd[..., None], c, bs)
            bb = torch.where(upd, d, bb)
            l = torch.where(upd, r + 1 - l, l)
            c = c_new
        return c, l

    def decode(self, recv: torch.Tensor):
        """``[..., n]`` received symbols -> ``(msg [..., k], ok [...])``.

        Corrects up to ``t`` symbol errors per codeword; ``ok`` is False
        when the error pattern is uncorrectable (root count mismatch or
        residual syndromes after correction).
        """
        if recv.shape[-1] != self.n:
            raise ValueError(f"expected {self.n} symbols, got {recv.shape[-1]}")
        recv = recv.to(torch.int32)
        dev = recv.device
        s = self.syndromes(recv)
        lam, l = self._berlekamp(s)

        lt = self.t + 1
        # Chien: Λ at α^{-d} for every position degree d = n-1-i
        degs = self.n - 1 - np.arange(self.n)                 # [n]
        kmat = self._power_table(
            "chien", np.mod(-degs[:, None] * np.arange(lt)[None, :], 255), dev)
        ev = _xor_fold(self._gmul(lam[..., None, :], kmat))
        err_here = ev == 0                                     # [..., n]
        n_roots = torch.sum(err_here, dim=-1, dtype=torch.int32)

        # Ω = S·Λ mod x^{2t}: the anti-diagonal sums of one outer product
        om_len = self.p
        outer = self._gmul(s[..., :, None], lam[..., None, :])
        om = outer[..., :, 0]
        for j in range(1, lt):
            shifted = torch.cat([torch.zeros_like(outer[..., :j, j]),
                                 outer[..., : om_len - j, j]], dim=-1)
            om = om ^ shifted

        # Forney at X = α^{d}: Y = X^{1-fcr} · Ω(X^{-1}) / Λ'(X^{-1})
        omat = self._power_table(
            "forney_om",
            np.mod(-degs[:, None] * np.arange(om_len)[None, :], 255), dev)
        om_x = _xor_fold(self._gmul(om[..., None, :], omat))
        # Λ'(x) = sum over odd j of Λ_j x^{j-1}: the even columns are 0
        dpow = np.mod(-degs[:, None] * (np.arange(lt) - 1)[None, :], 255)
        dpow[:, 0::2] = -1
        dmat = self._power_table("forney_dlam", dpow, dev)
        dlam_x = _xor_fold(self._gmul(lam[..., None, :], dmat))
        xfac = self._power_table(
            "forney_x", np.mod((1 - self.fcr) * degs, 255), dev)
        mag = self._gmul(self._gmul(om_x, self._ginv(dlam_x)), xfac)
        corr = recv ^ torch.where(err_here, mag, 0)

        ok = (n_roots == l) & torch.all(self.syndromes(corr) == 0, dim=-1)
        return corr[..., : self.k], ok

    def decode_bits(self, bits: torch.Tensor):
        """``[..., n*8]`` hard bits -> ``(msg bits [..., k*8], ok [...])``."""
        msg, ok = self.decode(self._to_syms(bits))
        return self._to_bits(msg), ok


def rs_255_223() -> ReedSolomon:
    """The classic t=16 deep-space outer code (255, 223)."""
    return ReedSolomon(255, 223)


def rs_dvb() -> ReedSolomon:
    """DVB RS(204, 188): the shortened (255, 239) t=8 code, fcr=0."""
    return ReedSolomon(204, 188, fcr=0)
