"""Binary BCH codes over GF(256) (counterpart of :mod:`modem_tpu.fec.bch`):
the outer code that corrects single bits, with finer rate steps than
Reed–Solomon.

* the systematic **encoder** (``parity = msg·x^p mod g``) is one ``[k, p]``
  bit-matrix product mod 2, built on the host by long division;
* the **syndromes** ``S_j = r(α^j)``, j = 1..2t, are one ``[n, 2t·8]``
  bit-matrix product mod 2, packed to GF(256) elements;
* **Berlekamp–Massey** runs inversionless over its fixed 2t steps, batched
  over codewords (the :mod:`~modem_tpu_torch.fec.rs` form);
* the **Chien search** evaluates Λ at all n positions at once; a binary
  code needs no Forney step: the bits at the roots flip.

The bit-matrix products are float32 ``torch.matmul`` then a remainder:
their inputs are 0 and 1 and their sums at most 255, exact even where TF32
rounds the inputs. GF(256) products come from a 64 K table indexed by
tensors (the JAX package multiplies bit by bit, the TPU's gather-free
form); the values are the same, so ``decode``'s messages and ``ok`` flags
equal the JAX decoder's on every input. The host tables are built by the
JAX package's code from this package's own GF(256) tables;
:meth:`Bch.check_tables` holds them against another code object's.
"""

from __future__ import annotations

from functools import cached_property

import numpy as np
import torch

from ..utils.cache import on_device
from .rs import _gf_tables, _xor_fold


def _poly_mul_gf2(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """GF(2)[x] product, low-degree-first coefficient arrays."""
    out = np.zeros(len(a) + len(b) - 1, np.int64)
    for i, c in enumerate(a):
        if c:
            out[i:i + len(b)] ^= b
    return out


class Bch:
    """Binary BCH(n=255, t) code: corrects up to ``t`` bit errors.

    ``k`` follows from the generator polynomial's degree (t=2 -> (255,
    239), t=8 -> (255, 191): the standard tables). Codewords are
    systematic: ``[k msg bits | n-k parity bits]``, msg bit 0 the
    highest-degree coefficient. Holds host tables only; runs on its
    inputs' device.
    """

    def __init__(self, t: int = 8, primitive: int = 0x11D):
        self.n = 255
        self.t = int(t)
        if not 1 <= self.t <= 31:
            raise ValueError("need 1 <= t <= 31")
        self.primitive = int(primitive)
        self._exp, self._log = _gf_tables(primitive)
        # generator = lcm of minimal polynomials of alpha^1 .. alpha^2t
        seen: set = set()
        g = np.array([1], np.int64)
        for i in range(1, 2 * self.t + 1):
            if i in seen:
                continue
            coset = []
            j = i
            while j not in coset:
                coset.append(j)
                seen.add(j)
                j = (2 * j) % 255
            # minimal poly: prod (x - alpha^j) over the coset, in GF(256);
            # its coefficients land in {0, 1}
            m = np.array([1], np.int64)
            for j in coset:
                root = int(self._exp[j])
                nm = np.zeros(len(m) + 1, np.int64)
                for d, c in enumerate(m):
                    nm[d + 1] ^= c
                    nm[d] ^= self._gmul_np(int(c), root)
                m = nm
            assert np.all((m == 0) | (m == 1)), "minimal poly not binary"
            g = _poly_mul_gf2(g, m) % 2
        self._gen = g.astype(np.int64)     # low-degree-first, g[p] = 1
        self.p = len(g) - 1
        self.k = self.n - self.p
        if self.k <= 0:
            raise ValueError(f"t={t} leaves no data bits at n=255")

    def _gmul_np(self, a: int, b: int) -> int:
        if a == 0 or b == 0:
            return 0
        return int(self._exp[(self._log[a] + self._log[b]) % 255])

    # ---- host-built GF(2) matrices ----

    @cached_property
    def _encode_matrix(self) -> np.ndarray:
        """[k, p]: parity bits = msg bits @ M (mod 2). Msg bit i is the
        coefficient of x^{n-1-i}; parity bit j of x^{p-1-j}."""
        m = np.zeros((self.k, self.p), np.uint8)
        for i in range(self.k):
            # x^(n-1-i) mod g by long division
            r = np.zeros(self.n, np.int64)
            r[self.n - 1 - i] = 1
            for d in range(self.n - 1, self.p - 1, -1):
                if r[d]:
                    r[d - self.p: d + 1] ^= self._gen
            m[i] = r[self.p - 1:: -1][: self.p]
        return m

    @cached_property
    def _syndrome_matrix(self) -> np.ndarray:
        """[n, 2t*8]: syndrome bits = recv bits @ M (mod 2), packed
        MSB-first per GF(256) syndrome S_j = r(alpha^j), j = 1..2t."""
        m = np.zeros((self.n, 2 * self.t * 8), np.uint8)
        for i in range(self.n):
            deg = self.n - 1 - i
            for j in range(1, 2 * self.t + 1):
                v = int(self._exp[(deg * j) % 255])
                for b in range(8):
                    m[i, (j - 1) * 8 + b] = (v >> (7 - b)) & 1
        return m

    def _mul_table(self) -> np.ndarray:
        """[256 * 256] GF products, ``a * 256 + b`` -> ``a ⊗ b``."""
        la = self._log[np.arange(256)]
        t = self._exp[la[:, None] + la[None, :]]
        t[0, :] = 0
        t[:, 0] = 0
        return t.reshape(-1)

    def _chien_powers(self) -> np.ndarray:
        """[n, t+1]: ``alpha^{-d*j}`` at each position's degree ``d``."""
        degs = self.n - 1 - np.arange(self.n)
        return self._exp[np.mod(-degs[:, None] * np.arange(self.t + 1), 255)]

    @staticmethod
    def tables_of(code) -> dict:
        """The host tables of ``code`` (this class or the JAX package's, by
        their attributes) as numpy arrays: the GF(256) ``exp`` and ``log``,
        the generator ``gen``, the ``encode`` and ``syndrome`` matrices."""
        return {"exp": np.asarray(code._exp), "log": np.asarray(code._log),
                "gen": np.asarray(code._gen),
                "encode": np.asarray(code._encode_matrix),
                "syndrome": np.asarray(code._syndrome_matrix)}

    def check_tables(self, tables: dict) -> None:
        """Raise ``ValueError`` unless ``tables`` (:meth:`tables_of` of
        another code object, the JAX package's for one) equal this code's."""
        for key, want in self.tables_of(self).items():
            got = np.asarray(tables[key])
            if got.shape != want.shape or not np.array_equal(got, want):
                raise ValueError(f"BCH table {key!r} differs")

    def _table(self, name: str, device) -> torch.Tensor:
        make = {"mul": self._mul_table, "chien": self._chien_powers,
                "enc": lambda: self._encode_matrix,
                "syn": lambda: self._syndrome_matrix}
        dtype = torch.float32 if name in ("enc", "syn") else torch.int32
        return on_device(self, name, make[name], dtype, device)

    # ---- device GF(256) ops (table lookups) ----

    def _gmul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Elementwise GF(256) multiply, broadcasting."""
        return self._table("mul", a.device)[a.long() * 256 + b.long()]

    def _gf2_product(self, name: str, bits: torch.Tensor) -> torch.Tensor:
        """``bits @ matrix (mod 2)`` for the host-built ``name`` matrix,
        int32."""
        m = self._table(name, bits.device)
        return torch.remainder(bits.to(torch.float32) @ m, 2.0).to(torch.int32)

    # ---- public API ----

    def encode(self, bits: torch.Tensor) -> torch.Tensor:
        """``[..., k]`` msg bits -> ``[..., n]`` systematic codeword."""
        if bits.shape[-1] != self.k:
            raise ValueError(f"expected {self.k} bits, got {bits.shape[-1]}")
        b = bits.to(torch.int32)
        return torch.cat([b, self._gf2_product("enc", b)], dim=-1)

    def syndromes(self, recv: torch.Tensor) -> torch.Tensor:
        """``[..., n]`` bits -> ``[..., 2t]`` GF(256) syndromes."""
        s = self._gf2_product("syn", recv)
        s = s.reshape(s.shape[:-1] + (2 * self.t, 8))
        w = 1 << torch.arange(7, -1, -1, dtype=torch.int32, device=s.device)
        return torch.sum(s * w, dim=-1, dtype=torch.int32)

    def _berlekamp(self, s: torch.Tensor):
        """Inversionless BM: syndromes ``[..., 2t]`` -> (Λ ``[..., t+1]``,
        L ``[...]``) with Λ low-degree-first (the rs.py form at this code's
        t)."""
        lt = self.t + 1
        two_t = 2 * self.t
        batch = s.shape[:-1]
        dev = s.device
        c = torch.zeros(batch + (lt,), dtype=torch.int32, device=dev)
        c[..., 0] = 1
        b = c.clone()
        l = torch.zeros(batch, dtype=torch.int32, device=dev)
        bb = torch.ones(batch, dtype=torch.int32, device=dev)
        # the windows S[r-j], j = 0..t, of every step r: one gather by a
        # host-built index, zero before S[0]
        idx = np.arange(two_t)[:, None] - np.arange(lt)[None, :]
        gather = on_device(self, "bm_idx", lambda: np.maximum(idx, 0),
                           torch.long, dev)
        valid = on_device(self, "bm_valid", lambda: idx >= 0, torch.bool,
                          dev)
        wins = torch.where(valid, s[..., gather], 0)  # [..., 2t, t+1]
        for r in range(two_t):
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
        """``[..., n]`` hard bits -> ``(msg [..., k], ok [...])``.

        Corrects up to ``t`` bit errors per codeword; ``ok`` is False when
        the pattern is uncorrectable (root-count mismatch or residual
        syndromes)."""
        if recv.shape[-1] != self.n:
            raise ValueError(f"expected {self.n} bits, got {recv.shape[-1]}")
        recv = recv.to(torch.int32)
        s = self.syndromes(recv)
        lam, l = self._berlekamp(s)
        kmat = self._table("chien", recv.device)          # [n, t+1]
        ev = _xor_fold(self._gmul(lam[..., None, :], kmat))
        err_here = ev == 0
        n_roots = torch.sum(err_here, dim=-1, dtype=torch.int32)
        corr = recv ^ err_here.to(torch.int32)            # binary: flip
        ok = (n_roots == l) & torch.all(self.syndromes(corr) == 0, dim=-1)
        return corr[..., :self.k], ok

    # FramedLink outer-code hooks (bit-domain, like rs.encode_bits)
    def encode_bits(self, bits: torch.Tensor) -> torch.Tensor:
        return self.encode(bits)

    def decode_bits(self, bits: torch.Tensor):
        return self.decode(bits)


def bch_255_191() -> Bch:
    """t=8 workhorse (DVB-S2-style outer-code strength at n=255)."""
    return Bch(t=8)


def bch_255_239() -> Bch:
    """t=2 light outer code (mops up a low inner-decoder error floor)."""
    return Bch(t=2)
