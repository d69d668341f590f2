"""QC-LDPC codes: IRA-structured encode and normalized min-sum decode
(counterpart of :mod:`modem_tpu.fec.ldpc`).

``H = [A | T]`` over GF(2): ``A`` a quasi-cyclic block matrix of Z x Z
circulants (weight-``col_weight`` block columns, shifts drawn by the JAX
package's seeded placement with 4-cycle rejection, copied here so the code
tables are the same for the same arguments), ``T`` the block-bidiagonal
accumulator chain. Encoding is a prefix XOR over the ``m_b`` block rows.

Decoding is normalized min-sum, layered (default) or flooding, in plain
PyTorch ops on the tensors' device (the JAX package runs it as XLA, with no
Pallas kernel). Codewords are ``[*batch, nb*z]``; each check row is one
vectorised step over its edges:

* one gather of the row's column blocks, each rotated by its circulant
  shift, through an index table built once per code and device;
* the minimum over the other edges as the first and second minimum with the
  position of the first (min is exact, so this equals the JAX prefix/suffix
  sweeps value for value);
* the sign over the other edges as the row's total XOR against the edge's
  own sign;
* one indexed add of the row's updates back to its columns: no two edges of
  a row share a column, so each posterior takes exactly one add a row, as
  the JAX ``t.at[c].add`` does.

The flooding schedule updates every row from one snapshot, so its step is
vectorised over all rows at once (rows padded to the largest degree with
edges that cannot win a minimum or flip a sign), and the column totals add
each column's messages in the JAX package's order. Decisions and posteriors
equal the JAX decoder's bit for bit. With float32 messages the layered
update ``a*sign*min - old`` is rounded once, computed in float64, as XLA's
CPU backend contracts it into one fused multiply-add (the float64 sum is
exact unless ``old`` exceeds the scaled minimum 32-fold, and then it
differs from the fused form only where a double rounding lands on a float32
tie). ``msg_dtype`` takes a torch dtype (``torch.bfloat16`` stores the
check-to-variable messages in bf16, rounded to nearest even as
``jnp.bfloat16`` rounds them; the posterior update uses the stored value).
``early_exit`` is a host test of the batched syndrome after each layered
iteration.

LLRs are positive for bit 0.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.cache import on_device


def _has_4cycle(entries: dict, z: int, row: int, col: int, s: int) -> bool:
    """Would adding shift ``s`` at (row, col) close a 4-cycle? (The JAX
    package's test: two data columns, or a data column against the
    accumulator through equal shifts in adjacent rows.)"""
    for (r2, c2), s22 in entries.items():
        if c2 == col:
            if abs(r2 - row) == 1 and (s - s22) % z == 0:
                return True
            continue
        if r2 == row:
            continue
        s12 = entries.get((row, c2))
        s21 = entries.get((r2, col))
        if s12 is None or s21 is None:
            continue
        if (s - s12 + s22 - s21) % z == 0:
            return True
    return False


class QcLdpc:
    """Rate ``k/n`` QC-LDPC code with IRA (accumulator) parity structure:
    ``n = nb * z``, ``k = (nb - mb) * z``. Defaults give the (648, 324)
    rate-1/2 geometry (nb=24, mb=12, Z=27)."""

    def __init__(self, z: int = 27, mb: int = 12, nb: int = 24,
                 col_weight: int = 3, seed: int = 11):
        if nb <= mb:
            raise ValueError("need nb > mb (positive code rate)")
        if col_weight > mb:
            raise ValueError("col_weight cannot exceed mb")
        self.z = int(z)
        self.mb = int(mb)
        self.nb = int(nb)
        self.kb = self.nb - self.mb
        self.n = self.nb * self.z
        self.k = self.kb * self.z
        self.col_weight = int(col_weight)
        self.seed = int(seed)
        # data-part circulants {(block_row, block_col): shift}
        self._a = self._shifts()
        # the edge list sorted by row, with the accumulator chain: row i
        # sees parity columns kb+i and kb+i-1, shift 0
        edges = sorted(
            [(r, c, s) for (r, c), s in self._a.items()]
            + [(r, self.kb + r, 0) for r in range(self.mb)]
            + [(r, self.kb + r - 1, 0) for r in range(1, self.mb)])
        self._edges = edges
        self._row_slices = []
        pos = 0
        for r in range(self.mb):
            deg = sum(1 for e in edges if e[0] == r)
            self._row_slices.append((pos, deg))
            pos += deg
        self._col_edges = [
            [e for e, (_, c, _) in enumerate(edges) if c == j]
            for j in range(self.nb)]

    def _shifts(self) -> dict:
        """The data part's circulant shifts, by the JAX package's seeded
        placement: each of the ``kb`` block columns gets ``col_weight``
        entries in distinct block rows (least-loaded rows first), each
        shift redrawn until it closes no 4-cycle."""
        rng = np.random.default_rng(self.seed)
        entries: dict = {}
        counts = np.zeros(self.mb, np.int64)
        for c in range(self.kb):
            used: set = set()
            for _ in range(self.col_weight):
                order = sorted(
                    (int(counts[r]), rng.random(), r)
                    for r in range(self.mb) if r not in used)
                placed = False
                for _, _, r in order:
                    for _try in range(64):
                        s = int(rng.integers(0, self.z))
                        if not _has_4cycle(entries, self.z, r, c, s):
                            entries[(r, c)] = s
                            used.add(r)
                            counts[r] += 1
                            placed = True
                            break
                    if placed:
                        break
                if not placed:
                    raise RuntimeError(
                        "4-cycle-free placement failed; lower col_weight, "
                        "raise z, or change seed")
        return entries

    # ---- the code tables ----

    @staticmethod
    def tables_of(code) -> dict:
        """The code tables of ``code`` (this class or the JAX package's, by
        their attributes) as numpy arrays: ``a`` the sorted (row, col,
        shift) circulants, ``edges`` [E, 3], ``row_slices`` [mb, 2],
        ``col_edges`` each column's edge indices in order, -1 after."""
        a = np.asarray(sorted((r, c, s) for (r, c), s in code._a.items()),
                       np.int64).reshape(-1, 3)
        width = max(len(x) for x in code._col_edges)
        cols = np.full((len(code._col_edges), width), -1, np.int64)
        for j, x in enumerate(code._col_edges):
            cols[j, :len(x)] = x
        return {"a": a, "edges": np.asarray(code._edges, np.int64),
                "row_slices": np.asarray(code._row_slices, np.int64),
                "col_edges": cols}

    def check_tables(self, tables: dict) -> None:
        """Raise ``ValueError`` unless ``tables`` (:meth:`tables_of` of
        another code object, the JAX package's for one) equal this code's."""
        mine = self.tables_of(self)
        for key, want in mine.items():
            got = np.asarray(tables[key])
            if got.shape != want.shape or not np.array_equal(got, want):
                raise ValueError(f"QC-LDPC table {key!r} differs")

    def _rows_padded(self, edges_of_row, pad: int) -> np.ndarray:
        """``[mb, dmax, z]`` flat positions of each row's edges in its
        check frame, padded with ``pad``: edge (c, sh) (``edges_of_row(r)``)
        at lane i reads column c at lane ``(i + sh) mod z`` (the JAX
        ``roll(x, -sh)``)."""
        rows = [list(edges_of_row(r)) for r in range(self.mb)]
        dmax = max(1, max(len(x) for x in rows))
        out = np.full((self.mb, dmax, self.z), pad, np.int64)
        lane = np.arange(self.z)
        for r, row in enumerate(rows):
            for d, (c, sh) in enumerate(row):
                out[r, d] = c * self.z + (lane + sh) % self.z
        return out

    def _row_edges(self, r: int):
        start, deg = self._row_slices[r]
        return [(c, sh) for _, c, sh in self._edges[start:start + deg]]

    def _table(self, key: str, device) -> torch.Tensor:
        """Index tables as int64 tensors on ``device``, built once each:
        ``"check"`` every row's edges, ``"data"`` the rows' data
        circulants, padded past ``n`` and ``k``."""
        if key == "check":
            def make():
                return self._rows_padded(self._row_edges, self.n)
        else:
            def make():
                return self._rows_padded(
                    lambda r: [(c, s) for (rr, c), s in self._a.items()
                               if rr == r], self.k)
        return on_device(self, key, make, torch.int64, device)

    # ---- encoder: prefix XOR over the accumulator chain ----

    def encode(self, bits: torch.Tensor) -> torch.Tensor:
        """``[..., k]`` data bits (int) -> ``[..., n]`` int32 systematic
        codeword: ``lambda_i = XOR_j roll(s_j, -shift_ij)``, ``p_i =
        p_{i-1} XOR lambda_i``."""
        if bits.shape[-1] != self.k:
            raise ValueError(f"expected {self.k} data bits, "
                             f"got {bits.shape[-1]}")
        s = bits.to(torch.int32).reshape(-1, self.k)
        ext = torch.cat([s, s.new_zeros((s.shape[0], 1))], dim=-1)
        idx = self._table("data", bits.device)
        lam = ext[:, idx.reshape(-1)].reshape(
            (s.shape[0],) + tuple(idx.shape)).sum(dim=2) & 1
        par = torch.cumsum(lam, dim=1, dtype=torch.int32) & 1
        out = torch.cat([s, par.reshape(s.shape[0], -1)], dim=-1)
        return out.reshape(bits.shape[:-1] + (self.n,))

    def _check_sums(self, v: torch.Tensor) -> torch.Tensor:
        """Hard bits ``[B, n]`` int32 -> each check's parity ``[B, mb, z]``."""
        ext = torch.cat([v, v.new_zeros((v.shape[0], 1))], dim=-1)
        idx = self._table("check", v.device)
        return ext[:, idx.reshape(-1)].reshape(
            (v.shape[0],) + tuple(idx.shape)).sum(dim=2) & 1

    def syndrome_ok(self, code_bits: torch.Tensor) -> torch.Tensor:
        """``[..., n]`` -> bool ``[...]``: every parity check satisfied."""
        v = code_bits.to(torch.int32).reshape(-1, self.n)
        bad = self._check_sums(v).reshape(v.shape[0], -1).amax(dim=-1)
        return (bad == 0).reshape(code_bits.shape[:-1])

    # ---- decoder: normalized min-sum ----

    def decode(self, llrs: torch.Tensor, iters: int = 25,
               alpha: float = 0.75, schedule: str = "layered",
               msg_dtype: torch.dtype | None = None,
               early_exit: bool = False) -> torch.Tensor:
        """``[..., n]`` channel LLRs (positive = bit 0) -> ``[..., k]`` hard
        data bits after at most ``iters`` min-sum iterations.
        ``schedule``: ``"layered"`` or ``"flooding"``; ``msg_dtype``: the
        messages' storage dtype (None: float32); ``early_exit``: stop once
        every codeword of the batch passes the syndrome check (layered
        only)."""
        out = self.decode_full(llrs, iters, alpha, schedule=schedule,
                               msg_dtype=msg_dtype, early_exit=early_exit)
        return out[..., :self.k]

    def decode_full(self, llrs: torch.Tensor, iters: int = 25,
                    alpha: float = 0.75, schedule: str = "layered",
                    msg_dtype: torch.dtype | None = None,
                    early_exit: bool = False) -> torch.Tensor:
        """Like :meth:`decode` but returns all ``n`` codeword bits."""
        t = self.posteriors(llrs, iters, alpha, schedule, msg_dtype,
                            early_exit)
        return (t < 0).to(torch.int32)

    def posteriors(self, llrs: torch.Tensor, iters: int = 25,
                   alpha: float = 0.75, schedule: str = "layered",
                   msg_dtype: torch.dtype | None = None,
                   early_exit: bool = False) -> torch.Tensor:
        """The decoder's posterior totals ``[..., n]`` float32, whose signs
        :meth:`decode_full` returns."""
        if schedule not in ("layered", "flooding"):
            raise ValueError(f"unknown schedule {schedule!r}")
        if schedule == "flooding" and early_exit:
            raise ValueError("early_exit requires schedule='layered'")
        if llrs.shape[-1] != self.n:
            raise ValueError(f"expected {self.n} LLRs, got {llrs.shape[-1]}")
        ch = llrs.to(torch.float32).reshape(-1, self.n)
        if schedule == "layered":
            t = self._layered(ch, int(iters), float(np.float32(alpha)),
                              torch.float32 if msg_dtype is None
                              else msg_dtype, early_exit)
        else:
            t = self._flooding(ch, int(iters), float(np.float32(alpha)))
        return t.reshape(llrs.shape)

    @staticmethod
    def _excluded(mag: torch.Tensor, neg: torch.Tensor, a: float, dim: int):
        """Per edge along ``dim``: the minimum of the other edges'
        magnitudes (inf where there is none), and ``a`` signed by the XOR of
        the other edges' signs (``neg``, bool)."""
        m1, arg = mag.min(dim=dim, keepdim=True)
        m2 = mag.scatter(dim, arg, float("inf")).amin(dim=dim, keepdim=True)
        pos = torch.arange(mag.shape[dim], device=mag.device).reshape(
            (-1,) + (1,) * (mag.ndim - dim - 1))
        em = torch.where(pos == arg, m2, m1)
        flip = (neg.sum(dim=dim, keepdim=True, dtype=torch.int32) & 1).bool()
        return em, torch.where(flip ^ neg, -a, a)

    def _syndrome_bad(self, t: torch.Tensor) -> bool:
        """True while any codeword of the batch fails any check (a host
        read)."""
        return bool(self._check_sums((t < 0).to(torch.int32)).any())

    def _layered(self, ch: torch.Tensor, iters: int, a: float,
                 mdt: torch.dtype, early_exit: bool) -> torch.Tensor:
        b, dev = ch.shape[0], ch.device
        t = ch.clone()
        l = torch.zeros((b, len(self._edges), self.z), dtype=mdt, device=dev)
        fused = mdt == torch.float32
        check = self._table("check", dev)
        rows = [(check[r, :deg].reshape(-1), start, deg)
                for r, (start, deg) in enumerate(self._row_slices)]

        def sweep():
            for idx, start, deg in rows:
                old = l[:, start:start + deg].to(torch.float32)
                cur = t[:, idx]
                u = cur.reshape(b, deg, self.z) - old
                em, asg = self._excluded(u.abs(), u < 0, a, 1)
                # quantize first, then update the posteriors with the
                # stored value: totals stay ch + sum(stored messages)
                wq = (asg * em).to(mdt)
                if fused:
                    # float32 messages: the scaled minimum less the old
                    # message, rounded once (XLA's CPU backend contracts
                    # the JAX expression into one fused multiply-add)
                    d = (asg.double() * em.double() - old.double()).float()
                else:
                    d = wq.to(torch.float32) - old
                t[:, idx] = cur + d.reshape(b, -1)
                l[:, start:start + deg] = wq

        if early_exit:
            it, bad = 0, True
            while it < iters and bad:
                sweep()
                it += 1
                bad = self._syndrome_bad(t)
        else:
            for _ in range(iters):
                sweep()
        return t

    def _flood_tables(self):
        """(edge-frame positions, column positions, padded rows, unpadding,
        column totals' order) for the flooding step, numpy."""
        e, z = len(self._edges), self.z
        lane = np.arange(z)
        frame = np.concatenate([k * z + (lane + sh) % z
                                for k, (_, _, sh) in enumerate(self._edges)])
        cols = np.concatenate([c * z + (lane + sh) % z
                               for _, c, sh in self._edges])
        dmax = max(d for _, d in self._row_slices)
        pad = np.full((self.mb, dmax), e, np.int64)
        unpad = np.zeros(e, np.int64)
        for r, (start, deg) in enumerate(self._row_slices):
            pad[r, :deg] = np.arange(start, start + deg)
            unpad[start:start + deg] = r * dmax + np.arange(deg)
        width = max(len(x) for x in self._col_edges)
        order = np.full((self.nb, width), e, np.int64)
        for j, x in enumerate(self._col_edges):
            order[j, :len(x)] = x
        return frame, cols, pad, unpad, order

    def _flooding(self, ch: torch.Tensor, iters: int, a: float
                  ) -> torch.Tensor:
        b, dev, z = ch.shape[0], ch.device, self.z
        e = len(self._edges)
        frame, cols, pad, unpad, order = (
            on_device(self, f"flood{i}", lambda i=i: self._flood_tables()[i],
                      torch.int64, dev) for i in range(5))
        ch3 = ch.reshape(b, self.nb, z)
        # a message of -0.0 pads each column's list: x + -0.0 == x exactly
        tail = torch.full((b, 1, z), -0.0, device=dev)
        inf = torch.full((b, 1, z), float("inf"), device=dev)

        def totals(c2v):
            ext = torch.cat([c2v, tail], dim=1)
            t = ch3
            for d in range(order.shape[1]):
                t = t + ext[:, order[:, d]]
            return t.reshape(b, -1)

        c2v = torch.zeros((b, e, z), device=dev)
        for _ in range(iters):
            tot = totals(c2v)
            # variable -> check, in the check's lane frame
            u = (tot[:, cols] - c2v.reshape(b, -1)[:, frame]).reshape(b, e, z)
            u = torch.cat([u, inf], dim=1)[:, pad]      # [b, mb, dmax, z]
            em, asg = self._excluded(u.abs(), u < 0, a, 2)
            w = (asg * em).reshape(b, -1, z)[:, unpad].reshape(b, -1)
            # back to the variable's lane frame
            new = torch.empty_like(w)
            new[:, frame] = w
            c2v = new.reshape(b, e, z)
        return totals(c2v)
