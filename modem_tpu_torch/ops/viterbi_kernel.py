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
the plain version. The two decide bit for bit alike. The kernel takes
``8 <= S <= 256`` states (K 4..9), up to 8 code bits per step, and windows
whose costs and decisions fit a block's shared memory; the wrappers raise
``ValueError`` naming the limit for anything else.
"""

from __future__ import annotations

import numpy as np
import torch

from ..cuda import Kernel, check_cuda
from ..utils.cache import on_device

VITERBI_KERNEL = Kernel("modem_viterbi")

#: the end-state pin: ``pm + pin * BIG`` on every state but 0
BIG = np.float32(1e9)
#: renormalisation cadence, in padded steps (``ConvCode._acs``'s unroll)
RENORM = 8
#: the kernel's limits, checked here (``csrc/viterbi.cu`` trusts its caller)
MIN_STATES, MAX_STATES = 8, 256
MAX_CODE_BITS = 8
#: dynamic shared memory one block may use on sm_90
MAX_SMEM_BYTES = 232448


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
    """The kernel's shared memory for one row (one warp), in floats, as
    ``(dec_off, pm_off, row_floats)``: the window's costs at 0, its
    decisions (one bit per state and step, ``max(1, S/32)`` 32-bit words a
    step) at ``dec_off``, two buffers of path metrics at ``pm_off``, the
    row's size rounded up to 4 floats so every row starts 16-byte
    aligned. The kernel takes this layout as given."""
    dec_off = t_w * n
    pm_off = dec_off + t_w * max(1, n_states // 32)
    return dec_off, pm_off, (pm_off + 2 * n_states + 3) // 4 * 4


def smem_bytes_per_row(n_states: int, n: int, t_w: int) -> int:
    """Bytes of shared memory the kernel gives one row."""
    return 4 * row_layout(n_states, n, t_w)[2]


def check_limits(code, t_w: int) -> None:
    """Raise ``ValueError`` for a code or window the kernel does not take."""
    s, n = code.n_states, code.n
    if not MIN_STATES <= s <= MAX_STATES:
        raise ValueError(
            f"the Viterbi kernel takes {MIN_STATES} <= S <= {MAX_STATES} "
            f"states (K 4..9), got S = {s} (K = {code.k})")
    if not 1 <= n <= MAX_CODE_BITS:
        raise ValueError(f"the Viterbi kernel takes 1..{MAX_CODE_BITS} code "
                         f"bits per step, got {n}")
    need = smem_bytes_per_row(s, n, t_w)
    if need > MAX_SMEM_BYTES:
        raise ValueError(
            f"a window of {t_w} steps needs {need} bytes of shared memory "
            f"per row (costs and decisions), over the {MAX_SMEM_BYTES} a "
            "block may use: use shorter windows")


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
    check_limits(code, t_w)
    check_cuda("lam", lam, torch.float32, dev)
    if pin is not None:
        check_cuda("pin", pin, torch.float32, dev)
    masks = on_device(code, "viterbi_masks", lambda: _masks(code),
                      torch.int32, dev)
    if out.numel() == 0 or n_ch * n_win == 0:
        return
    VITERBI_KERNEL.launch(
        dev, lam.data_ptr(), None if pin is None else pin.data_ptr(),
        masks.data_ptr(), n_ch, t_stream, code.n, code.n_states, code.k - 2,
        t_w, *row_layout(code.n_states, code.n, t_w), block, halo, n_win,
        guard, out_lo, out_hi, out.shape[-1], out.data_ptr())
