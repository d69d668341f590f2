"""Windowed soft Viterbi (counterpart of :mod:`modem_tpu.ops.pallas_viterbi`):
kernel K13, in ``modem_tpu_torch/csrc/viterbi.cu``.

* :func:`viterbi_decode_windows`: a batch of free-start trellis windows
  ``[..., T, n]`` (guard flanks already in place) and a per-window ``pin``
  (1.0: the traceback starts at state 0, the last window of a terminated
  stream; 0.0: at the first best state) -> every window's ``[..., T]``
  decision bits, int32, the caller keeping the interior;
* :func:`viterbi_decode_stream`: a terminated stream's per-step costs
  ``[..., T, n]``, windows of ``block_steps`` with ``halo_steps`` on each
  side -> data bits ``[..., T - (K-1)]``. The kernel reads the windows
  straight from the compact stream and makes the guard flanks itself; the
  plain version builds them as the JAX package's ``backend="xla"`` form
  does.

Each has a plain PyTorch version (:func:`windows_plain`,
:func:`stream_plain`: ``ConvCode._acs``'s free-start, argmin-end form),
which a CPU tensor runs, and a kernel wrapper (:func:`windows_kernel`,
:func:`stream_kernel`), which a CUDA tensor runs; a CUDA tensor never takes
the plain version. The two decide bit for bit alike, for every code shape
:class:`~modem_tpu_torch.fec.ConvCode` builds (K >= 2, any n) and any
window length. The kernel has two routes (:func:`warp_route`): a warp a
row with everything in shared memory (``S <= 256``, ``n <= 32``, a row
that fits), counted by :data:`VITERBI_KERNEL`; otherwise a block a row,
metrics and decisions in a global scratch where shared memory is too small
(:func:`block_plan`), counted by :data:`VITERBI_BLOCK_KERNEL`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..cuda import Kernel, check_cuda
from ..utils.cache import on_device

VITERBI_KERNEL = Kernel("modem_viterbi")
VITERBI_BLOCK_KERNEL = Kernel("modem_viterbi_block")

#: the end-state pin: ``pm + pin * BIG`` on every state but 0
BIG = np.float32(1e9)
#: renormalisation cadence, in padded steps (``ConvCode._acs``'s unroll)
RENORM = 8
#: the warp route's limits (``csrc/viterbi.cu`` trusts its caller)
WARP_MAX_STATES = 256
WARP_MAX_CODE_BITS = 32
#: dynamic shared memory one block may use on sm_90
MAX_SMEM_BYTES = 232448
#: threads of a block-route block, at most
MAX_BLOCK_THREADS = 1024
#: global scratch one block-route launch may take; more rows launch again
MAX_SCRATCH_BYTES = 1 << 30


def _pin_bias(code, pin: torch.Tensor) -> torch.Tensor:
    """``pin[..., None] * BIG`` on states ``s > 0``, 0 on state 0."""
    s = torch.arange(code.n_states, device=pin.device)
    return pin.to(torch.float32)[..., None] * float(BIG) * (s > 0).to(
        torch.float32)


# --------------------------------------------------------------------------
# windows
# --------------------------------------------------------------------------

def viterbi_decode_windows(code, win: torch.Tensor,
                           pin: torch.Tensor) -> torch.Tensor:
    """Decode independent free-start windows ``win [..., T, n]``; ``pin``
    broadcasts to ``[...]``. Returns the padded decisions ``[..., T]``."""
    pin = torch.as_tensor(pin, dtype=torch.float32, device=win.device)
    pin = pin.expand(win.shape[:-2])
    run = windows_kernel if win.is_cuda else windows_plain
    return run(code, win.to(torch.float32), pin)


def windows_plain(code, win, pin):
    """Plain version of K13 on windows: ``_acs`` from zero metrics, the
    traceback from the first minimum of the pinned final metrics."""
    pm0 = torch.zeros(code.n_states, device=win.device)
    return code._acs(win, pm0=pm0, end_state="argmin", trim=False,
                     end_bias=_pin_bias(code, pin))


def windows_kernel(code, win, pin):
    """Launch K13 (``modem_viterbi``) on CUDA windows, one row each."""
    t_w, n = win.shape[-2], win.shape[-1]
    rows = win.reshape(-1, t_w, n).contiguous()
    pins = pin.reshape(-1).contiguous()
    r = rows.shape[0]
    out = torch.empty((r, t_w), dtype=torch.int32, device=win.device)
    _launch(code, rows, pins, n_ch=r, t_stream=t_w, t_w=t_w, block=0,
            halo=0, n_win=1, guard=0.0, out_lo=0, out_hi=t_w, out=out)
    return out.reshape(win.shape[:-1])


# --------------------------------------------------------------------------
# the whole stream
# --------------------------------------------------------------------------

def viterbi_decode_stream(code, lam: torch.Tensor, block_steps: int,
                          halo_steps: int, guard: float) -> torch.Tensor:
    """Windowed decode of a terminated stream ``lam [..., T, n]``: data
    bits ``[..., T - (K-1)]`` int32."""
    run = stream_kernel if lam.is_cuda else stream_plain
    return run(code, lam.to(torch.float32), int(block_steps),
               int(halo_steps), guard)


def _windows_geometry(t: int, b: int, h: int) -> tuple[int, int]:
    """``(W, T_w)``: the windows covering ``t`` steps and their length."""
    if b < 1 or h < 0:
        raise ValueError("block_steps must be >= 1 and halo_steps >= 0")
    return -(-t // b), b + 2 * h


def stream_plain(code, lam, b: int, h: int, guard: float):
    """Plain version of K13 on a stream: guard flanks, the overlapping
    windows gathered as rows, :func:`windows_plain` with the last window
    pinned, the interiors kept."""
    t, n = lam.shape[-2], lam.shape[-1]
    w, tw = _windows_geometry(t, b, h)
    batch = lam.shape[:-2]
    g = torch.full(batch + (h, n), float(guard), device=lam.device)
    tail = torch.full(batch + (w * b - t + h, n), float(guard),
                      device=lam.device)
    lam_p = torch.cat([g, lam, tail], dim=-2)
    idx = (torch.arange(w, device=lam.device)[:, None] * b
           + torch.arange(tw, device=lam.device)[None, :])
    win = torch.movedim(lam_p[..., idx, :], -3, 0)   # [W, ..., T_w, n]
    pin = torch.zeros((w,) + batch, device=lam.device)
    pin[w - 1] = 1.0
    bits = windows_plain(code, win, pin)[..., h:h + b]  # [W, ..., B]
    bits = torch.movedim(bits, 0, -2)
    bits = bits.reshape(batch + (w * b,))
    return bits[..., : t - (code.k - 1)]


def stream_kernel(code, lam, b: int, h: int, guard: float):
    """Launch K13 on a CUDA stream: ``W`` windows per channel, rows
    ``wi * C + c``, each writing its interior straight into ``[C, W*B]``."""
    t, n = lam.shape[-2], lam.shape[-1]
    w, tw = _windows_geometry(t, b, h)
    flat = lam.reshape(-1, t, n).contiguous()
    c = flat.shape[0]
    out = torch.empty((c, w * b), dtype=torch.int32, device=lam.device)
    _launch(code, flat, None, n_ch=c, t_stream=t, t_w=tw, block=b, halo=h,
            n_win=w, guard=float(guard), out_lo=h, out_hi=h + b, out=out)
    return out[:, : t - (code.k - 1)].reshape(lam.shape[:-2]
                                              + (t - (code.k - 1),))


# --------------------------------------------------------------------------
# the launch
# --------------------------------------------------------------------------

def row_layout(n_states: int, n: int, t_w: int) -> tuple[int, int, int]:
    """The warp route's shared memory for one row (one warp), in floats, as
    ``(dec_off, pm_off, row_floats)``: the window's costs at 0, its
    decisions (one bit per state and step, ``max(1, S/32)`` 32-bit words a
    step) at ``dec_off``, two buffers of path metrics at ``pm_off``, the
    row's size rounded up to 4 floats so every row starts 16-byte
    aligned. The kernel takes this layout as given."""
    dec_off = t_w * n
    pm_off = dec_off + t_w * max(1, n_states // 32)
    return dec_off, pm_off, (pm_off + 2 * n_states + 3) // 4 * 4


def smem_bytes_per_row(n_states: int, n: int, t_w: int) -> int:
    """Bytes of shared memory the warp route gives one row."""
    return 4 * row_layout(n_states, n, t_w)[2]


def warp_route(code, t_w: int) -> bool:
    """Whether a row of ``t_w`` steps takes the warp route: up to 256
    states, 32 code bits and a row that fits one block's shared memory."""
    return (code.n_states <= WARP_MAX_STATES and code.n <= WARP_MAX_CODE_BITS
            and smem_bytes_per_row(code.n_states, code.n, t_w)
            <= MAX_SMEM_BYTES)


def block_plan(n_states: int, n: int, t_w: int) -> tuple[int, int, int, int]:
    """The block route's ``(threads, pm_smem, dec_smem, smem_bytes)`` for
    one row: ``min(S, 1024)`` threads (at least a warp); shared memory
    holds the ``n`` generators and 64 words of reduction slots, then the
    two metric buffers while they fit (``pm_smem``) and after them the
    window's decision words while those fit too (``dec_smem``). The rest
    goes to the global scratch."""
    threads = min(max(n_states, 32), MAX_BLOCK_THREADS)
    head = 4 * (n + 64)
    pm_bytes = 8 * n_states
    dec_bytes = 4 * t_w * max(1, n_states // 32)
    pm_smem = head + pm_bytes <= MAX_SMEM_BYTES
    dec_smem = pm_smem and head + pm_bytes + dec_bytes <= MAX_SMEM_BYTES
    smem = head + pm_bytes * pm_smem + dec_bytes * dec_smem
    return threads, int(pm_smem), int(dec_smem), smem


def _masks(code) -> np.ndarray:
    """``[2, S]`` int32: bit ``j`` of ``masks[d, s]`` is the code bit
    generator ``j`` emits on the transition from predecessor ``d``."""
    w = (1 << np.arange(code.n)).astype(np.int64)
    return (code._outs.astype(np.int64) * w).sum(-1).astype(np.int32)


def _launch(code, lam, pin, *, n_ch: int, t_stream: int, t_w: int,
            block: int, halo: int, n_win: int, guard: float, out_lo: int,
            out_hi: int, out: torch.Tensor) -> None:
    """Rows ``wi * n_ch + c`` read steps ``wi*block - halo + p`` of
    channel ``c`` (``guard`` outside ``[0, t_stream)``) and write their
    decisions at ``out_lo <= p < out_hi`` to ``out[c, wi*block + p -
    out_lo]``; ``pin`` None pins the last window of each channel."""
    dev = lam.device
    check_cuda("lam", lam, torch.float32, dev)
    if pin is not None:
        check_cuda("pin", pin, torch.float32, dev)
    if out.numel() == 0 or n_ch * n_win == 0:
        return
    pin_ptr = None if pin is None else pin.data_ptr()
    tail = (block, halo, n_win, guard, out_lo, out_hi, out.shape[-1],
            out.data_ptr())
    if warp_route(code, t_w):
        masks = on_device(code, "viterbi_masks", lambda: _masks(code),
                          torch.int32, dev)
        VITERBI_KERNEL.launch(
            dev, lam.data_ptr(), pin_ptr, masks.data_ptr(), n_ch, t_stream,
            code.n, code.n_states, code.k - 2, t_w,
            *row_layout(code.n_states, code.n, t_w), *tail)
        return
    s = code.n_states
    polys = on_device(code, "viterbi_polys",
                      lambda: np.asarray(code.polys, np.int64), torch.int32,
                      dev)
    threads, pm_smem, dec_smem, smem = block_plan(s, code.n, t_w)
    words = max(1, s // 32)
    rows = n_ch * n_win
    per_row = 8 * s * (1 - pm_smem) + 4 * t_w * words * (1 - dec_smem)
    batch = rows if per_row == 0 else max(1, min(rows, MAX_SCRATCH_BYTES
                                                 // per_row))
    pm_g = (None if pm_smem else
            torch.empty((batch, 2, s), dtype=torch.float32, device=dev))
    dec_g = (None if dec_smem else
             torch.empty((batch, t_w, words), dtype=torch.int32, device=dev))
    for row0 in range(0, rows, batch):
        VITERBI_BLOCK_KERNEL.launch(
            dev, lam.data_ptr(), pin_ptr, polys.data_ptr(), n_ch, t_stream,
            code.n, s, code.k - 2, t_w, threads, pm_smem, dec_smem, smem,
            row0, min(batch, rows - row0),
            None if pm_g is None else pm_g.data_ptr(),
            None if dec_g is None else dec_g.data_ptr(), *tail)
