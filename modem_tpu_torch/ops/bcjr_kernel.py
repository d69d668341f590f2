"""Max-log BCJR of the 8-state LTE RSC (counterpart of
:mod:`modem_tpu.ops.pallas_bcjr`): kernel K14, in
``modem_tpu_torch/csrc/bcjr.cu``.

One turbo half-iteration over **rows**: each row is one (codeword, window)
of ``tw`` trellis steps, laid out ``x [3, R, tw]`` f32 (row 0 the
systematic plus a-priori LLR ``lu = lsys + la``, row 1 the parity LLR,
row 2 the pin mask, 1.0 on the padded steps outside the data). A row's
alpha and beta start neutral (all-zero metrics); a pinned step lets only
the branch (state 0, u = 0) through at cost 0, every other at ``-1e30``,
which carries the terminated trellis's end conditions through the pads.
The row's extrinsics ``app - lu`` at steps ``keep_lo .. keep_lo+keep_n``
come back as ``[R, keep_n]``.

:func:`bcjr_windowed` cuts a batch of codewords into such rows as the JAX
``TurboCode._bcjr_windowed`` does (guards on both sides, pins at the
stream's ends) and keeps each window's core; ``TurboCode.decode`` calls
it for every windowed half-iteration. The geometry of the JAX
package's chip route is copied here with the values it picks:
:func:`pick_geometry` (one window over the whole trellis where the TPU's
VMEM held its history, ``_TW_CAP``) and :func:`pick_guard` (the guard an
explicit window is widened to).

:func:`rows_plain` is the plain version (``_scans`` over the rows' gammas,
the arithmetic of the JAX ``_bcjr_windowed``), which a CPU tensor runs;
:func:`rows_kernel` launches K14 (counted by :data:`BCJR_KERNEL`) for a
CUDA tensor, never the plain version. The two are bit-identical.
"""

from __future__ import annotations

import numpy as np
import torch

from ..cuda import Kernel, check_cuda

BCJR_KERNEL = Kernel("modem_bcjr")

#: the metric of a branch that may not be taken (``fec/turbo._NEG``)
NEG = np.float32(-1e30)
#: the JAX chip route's alignment granule of ``window + 2 guard``
_CHUNK = 12
#: the JAX chip route's cap on one window's steps (its alpha history in
#: VMEM); the geometry, and so the result, depend on it
_TW_CAP = 2496
_S = 8


def _trellis_tables() -> tuple[np.ndarray, np.ndarray]:
    """``(nxt, par)``, each ``[8, 2]``: the next state and the parity bit
    from state ``s = s1*4 + s2*2 + s3`` on info bit ``u``."""
    nxt = np.zeros((_S, 2), np.int64)
    par = np.zeros((_S, 2), np.int64)
    for s in range(_S):
        s1, s2, s3 = (s >> 2) & 1, (s >> 1) & 1, s & 1
        for u in (0, 1):
            a = u ^ s2 ^ s3
            par[s, u] = a ^ s1 ^ s3
            nxt[s, u] = (a << 2) | (s1 << 1) | s2
    return nxt, par


def _pred_tables() -> tuple[np.ndarray, np.ndarray]:
    """``(ps, pu)``, each ``[8, 2]``: the two branches ``(s, u)`` that
    enter each state, in ``(s, u)`` order."""
    nxt, _ = _trellis_tables()
    ps = np.zeros((_S, 2), np.int64)
    pu = np.zeros((_S, 2), np.int64)
    for sp in range(_S):
        br = [(s, u) for s in range(_S) for u in (0, 1) if nxt[s, u] == sp]
        ps[sp], pu[sp] = [b[0] for b in br], [b[1] for b in br]
    return ps, pu


_NXT, _PAR = _trellis_tables()
_PS, _PU = _pred_tables()


def gammas(lu: torch.Tensor, lp: torch.Tensor) -> torch.Tensor:
    """Branch metrics ``[..., 8, 2]``: ``lu * 0.5(1-2u) + lp * 0.5(1-2p)``
    (``fec/turbo._gammas``; both products are exact)."""
    usig = torch.tensor([0.5, -0.5], dtype=torch.float32, device=lu.device)
    psig = torch.as_tensor(0.5 * (1.0 - 2.0 * _PAR), dtype=torch.float32,
                           device=lu.device)
    return lu[..., None, None] * usig + lp[..., None, None] * psig


def scans(gam: torch.Tensor, a0: torch.Tensor, bt: torch.Tensor,
          t_keep: int) -> torch.Tensor:
    """``TurboCode._scans``: alpha, beta and the APP over ``gam [T, ..., 8,
    2]`` from ``a0`` / ``bt [..., 8]``, every step renormalised (minus the
    max over the states); the APP LLRs of the first ``t_keep`` steps,
    ``[t_keep, ...]``. Selections are index gathers, each sum ``(alpha +
    gamma) + beta`` in the JAX order."""
    dev = gam.device
    ps, pu = torch.as_tensor(_PS, device=dev), torch.as_tensor(_PU, device=dev)
    nxt = torch.as_tensor(_NXT, device=dev)
    t = gam.shape[0]
    alphas = torch.empty((t_keep,) + gam.shape[1:-1], dtype=torch.float32,
                         device=dev)
    alpha = a0
    for i in range(t_keep):
        alphas[i] = alpha
        cand = alpha[..., None] + gam[i]                   # [..., 8, 2]
        new = cand[..., ps, pu].amax(-1)
        alpha = new - new.amax(-1, keepdim=True)
    betas = torch.empty_like(alphas)
    beta = bt
    for i in range(t - 1, -1, -1):
        if i < t_keep:
            betas[i] = beta
        new = (gam[i] + beta[..., nxt]).amax(-1)
        beta = new - new.amax(-1, keepdim=True)
    m = (alphas[..., None] + gam[:t_keep]) + betas[..., nxt]
    return m[..., 0].amax(-1) - m[..., 1].amax(-1)


# --------------------------------------------------------------------------
# geometry (the JAX chip route's, values unchanged)
# --------------------------------------------------------------------------

def pick_guard(window: int, guard: int) -> int:
    """Smallest ``g >= guard`` with ``(window + 2g) % 12 == 0``; an odd
    window has none and raises ``ValueError``."""
    for g in range(guard, guard + _CHUNK):
        if (window + 2 * g) % _CHUNK == 0:
            return g
    raise ValueError(
        f"no guard >= {guard} aligns window {window} to {_CHUNK} steps "
        "(odd window?) — use the XLA backend")


def pick_geometry(t_steps: int, guard: int = 32) -> tuple[int, int]:
    """``(window, guard)`` for a ``t_steps``-step terminated stream: one
    window over the whole trellis while ``t_steps + 2 guard <= _TW_CAP``
    (its length the least multiple of a chunk of 84..150 steps, chunk %
    3 == 0, that holds it), else windows of 2016 steps with
    :func:`pick_guard`'s guard."""
    need = t_steps + 2 * guard
    if need <= _TW_CAP:
        tw = min(-(-need // chunk) * chunk for chunk in range(84, 151, 3))
        return tw - 2 * guard, guard
    return 2016, pick_guard(2016, guard)


# --------------------------------------------------------------------------
# rows
# --------------------------------------------------------------------------

def bcjr_rows(x: torch.Tensor, keep_lo: int, keep_n: int) -> torch.Tensor:
    """One half-iteration over rows ``x [3, R, tw]``: extrinsics ``[R,
    keep_n]`` of steps ``keep_lo ..``; the kernel for a CUDA tensor."""
    run = rows_kernel if x.is_cuda else rows_plain
    return run(x, int(keep_lo), int(keep_n))


def rows_plain(x: torch.Tensor, keep_lo: int, keep_n: int) -> torch.Tensor:
    """Plain version of K14: the rows' gammas (pinned steps: only (0, 0)
    at cost 0), :func:`scans` from neutral metrics, ``app - lu``."""
    lu, lp, pin = x[0], x[1], x[2]
    gam = torch.movedim(gammas(lu, lp), 1, 0)                # [tw, R, 8, 2]
    pinned = torch.full((_S, 2), float(NEG), device=x.device)
    pinned[0, 0] = 0.0
    gam = torch.where(torch.movedim(pin, 1, 0)[..., None, None] > 0, pinned,
                      gam)
    zero = torch.zeros((x.shape[1], _S), dtype=torch.float32, device=x.device)
    app = scans(gam, zero, zero, keep_lo + keep_n)[keep_lo:]
    return torch.movedim(app, 0, 1) - lu[:, keep_lo:keep_lo + keep_n]


def rows_kernel(x: torch.Tensor, keep_lo: int, keep_n: int) -> torch.Tensor:
    """Launch K14 (``modem_bcjr``) on CUDA rows: one lane a row and
    direction, alpha and beta swept from both ends of the row at once, with
    a loader warp beside each; both sweeps' metrics go to a scratch ``[R,
    tw, 8]`` (laid out per block of 16 rows as ``[tw][2][rows]`` float4)."""
    dev = x.device
    check_cuda("rows", x, torch.float32, dev)
    _, r, tw = x.shape
    if not 0 <= keep_lo <= keep_lo + keep_n <= tw:
        raise ValueError(f"keep {keep_lo}+{keep_n} outside {tw} steps")
    out = torch.empty((r, keep_n), dtype=torch.float32, device=dev)
    if r == 0 or keep_n == 0:
        return out
    scratch = torch.empty((r, tw, _S), dtype=torch.float32, device=dev)
    BCJR_KERNEL.launch(dev, x.data_ptr(), r, tw, keep_lo, keep_n,
                       scratch.data_ptr(), out.data_ptr())
    return out


def make_rows(lsys, lpar, la, t_sys, t_par, window: int, guard: int):
    """``_bcjr_windowed``'s windows as rows ``[3, W*C, tw]`` (row ``w*C +
    c``), with ``W`` windows per codeword; returns ``(rows, W)``."""
    t = lsys.shape[-1]
    tp = t + 3
    c = lsys.reshape(-1, t).shape[0]
    n_win = -(-tp // window)
    pad = (guard, n_win * window - tp + guard)
    lu = torch.cat([lsys + la, t_sys], -1).reshape(c, tp)
    lp = torch.cat([lpar, t_par], -1).reshape(c, tp)
    pin = torch.ones((c, tp + pad[0] + pad[1]), dtype=torch.float32,
                     device=lsys.device)
    pin[:, guard:guard + tp] = 0.0
    stream = torch.stack([torch.nn.functional.pad(lu, pad),
                          torch.nn.functional.pad(lp, pad), pin])
    tw = window + 2 * guard
    wins = stream.unfold(-1, tw, window)                     # [3, C, W, tw]
    return wins.transpose(1, 2).reshape(3, n_win * c, tw).contiguous(), n_win


def bcjr_windowed(lsys, lpar, la, t_sys, t_par, window: int | None,
                  guard: int) -> torch.Tensor:
    """The rows form of ``TurboCode._bcjr_windowed``: extrinsics ``[...,
    T]`` at ``(window, guard)``; ``window=None`` takes
    :func:`pick_geometry`. K14 for CUDA tensors."""
    t = lsys.shape[-1]
    if window is None:
        window, guard = pick_geometry(t + 3, guard)
    rows, n_win = make_rows(lsys, lpar, la, t_sys, t_par, window, guard)
    core = bcjr_rows(rows, guard, window)                    # [W*C, window]
    c = rows.shape[1] // n_win
    flat = core.reshape(n_win, c, window).transpose(0, 1).reshape(c, -1)
    return flat[:, :t].reshape(lsys.shape)
