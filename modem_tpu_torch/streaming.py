"""Unbounded streams through the fused kernels, in blocks, with exact state
carry (counterpart of :mod:`modem_tpu.streaming`).

Decisions and waveforms are identical to one shot of the fused call on the
whole stream, at baseband and at passband (each block passes its
``sym_offset``, the stream-global index of its first symbol, so the carrier
phase runs on across the seams). The carries have the JAX package's form,
so a stream started there can go on here: :meth:`set_state` takes the
numpy form of the JAX classes' ``get_state()`` (or
:func:`modem_tpu_torch.checkpoint.load_state` of a saved one).
"""

from __future__ import annotations

import numpy as np
import torch

from .chain import PulseShapedChain
from .ops.chain_kernel import fused_pulse_chain
from .ops.txrx import fused_rx, fused_tx
from .utils.bits import pack_bits, unpack_symbols


def _restore(x, dtype: torch.dtype, device) -> torch.Tensor:
    """A carry entry (tensor or numpy) as an owned ``dtype`` tensor."""
    if torch.is_tensor(x):
        return x.to(device=device, dtype=dtype).clone()
    return torch.tensor(np.asarray(x), dtype=dtype, device=device)


def _sentinels(batch_shape, n: int, device) -> torch.Tensor:
    """``n`` "no symbol here" positions (the kernels' ``-1`` sentinel)."""
    return torch.full(batch_shape + (n,), -1, dtype=torch.int32, device=device)


class StreamingFusedChain:
    """Block-streaming loopback over :func:`modem_tpu_torch.ops.chain_kernel
    .fused_pulse_chain` for one :class:`PulseShapedChain`.

    The kernel decides a symbol from ``span`` symbols of context on each
    side, so a block's last ``span`` decisions stay pending until the next
    block supplies their lookahead: the carry is the last ``2*span`` symbols
    (context + pending), ``-1`` before the stream. ``push(bits)`` takes
    ``[..., L*bps]`` and returns the newly final decided bits (lagging
    ``span`` symbols); ``flush()`` returns the rest. The batch shape is fixed
    at construction; the stream lives on the chain's device.
    """

    def __init__(self, chain: PulseShapedChain,
                 batch_shape: tuple[int, ...] = ()):
        self.chain = chain
        self.bps = chain.bits_per_symbol
        self.span = chain.span
        self.batch_shape = tuple(batch_shape)
        self.device = chain.lut.device
        self._tail = _sentinels(self.batch_shape, 2 * self.span, self.device)
        self._seen = 0  # real symbols consumed so far

    def _run(self, ext: torch.Tensor) -> torch.Tensor:
        ch = self.chain
        # ext[..., 0] is stream symbol _seen - 2*span
        return fused_pulse_chain(ext, ch.lut, ch.rrc, ch.sps, self.span,
                                 sym_offset=self._seen - 2 * self.span,
                                 **ch._carrier())

    def push(self, bits: torch.Tensor) -> torch.Tensor:
        if tuple(bits.shape[:-1]) != self.batch_shape:
            raise ValueError("batch shape is fixed at construction")
        syms = pack_bits(bits, self.bps)
        length = syms.shape[-1]
        d = self.span
        ext = torch.cat([self._tail, syms], dim=-1)
        dec = self._run(ext)
        # Positions [d, d+L) have full context; drop any that predate the
        # stream (first call: the pending window isn't populated yet).
        skip = max(0, d - self._seen)
        out = dec[..., d + skip: d + length]
        self._tail = ext[..., ext.shape[-1] - 2 * d:]
        self._seen += length
        return unpack_symbols(out, self.bps)

    def flush(self) -> torch.Tensor:
        """Finalize the pending ``span`` symbols against the stream-end
        flush; the stream is then finished."""
        d = self.span
        dec = self._run(self._tail)
        pending = min(d, self._seen)
        out = dec[..., 2 * d - pending: 2 * d]
        self._seen = 0
        self._tail = _sentinels(self.batch_shape, 2 * d, self.device)
        return unpack_symbols(out, self.bps)

    def get_state(self) -> dict:
        """The stream's whole carry: ``{"tail": [..., 2*span] int32,
        "seen": int}``."""
        return {"tail": self._tail, "seen": self._seen}

    def set_state(self, state) -> None:
        """Restore a carry of :meth:`get_state`, or the numpy form of the JAX
        class's."""
        self._tail = _restore(state["tail"], torch.int32, self.device)
        self._seen = int(state["seen"])


class StreamingFusedTx:
    """Unbounded bits -> waveform through the fused TX
    (:func:`modem_tpu_torch.ops.txrx.fused_tx`).

    The pulse shaper only looks back ``span`` symbols, so TX streaming has
    no lag: ``push(bits)`` with ``L`` symbols returns exactly ``L*sps`` final
    samples (``(i, q)`` at baseband, one real waveform at passband); the
    carry is the last ``span`` symbols. ``flush()`` emits the
    ``span*sps``-sample zero-flush tail. Pushes + flush equal the one-shot
    :meth:`PulseShapedChain.tx_fused` output exactly; ``out_scale`` stores
    int16 as it does.
    """

    def __init__(self, chain: PulseShapedChain,
                 batch_shape: tuple[int, ...] = (),
                 out_scale: float | None = None):
        self.chain = chain
        self.bps = chain.bits_per_symbol
        self.span = chain.span
        self.batch_shape = tuple(batch_shape)
        self.out_scale = out_scale
        self.device = chain.lut.device
        self._tail = _sentinels(self.batch_shape, self.span, self.device)
        self._seen = 0

    def _run(self, ext: torch.Tensor):
        ch = self.chain
        wave = fused_tx(ext, rrc_taps=ch.rrc, sps=ch.sps, span=self.span,
                        sym_offset=self._seen - self.span,
                        out_scale=self.out_scale, **ch._txrx_params(),
                        **ch._carrier())
        return (wave,) if ch.carrier_hz is not None else wave

    def _out(self, waves):
        return waves[0] if self.chain.carrier_hz is not None else waves

    def push(self, bits: torch.Tensor):
        """``[..., L*bps]`` bits -> ``[..., L*sps]`` final waveform
        samples."""
        if tuple(bits.shape[:-1]) != self.batch_shape:
            raise ValueError("batch shape is fixed at construction")
        syms = pack_bits(bits, self.bps)
        length = syms.shape[-1]
        d, sps = self.span, self.chain.sps
        ext = torch.cat([self._tail, syms], dim=-1)
        waves = self._run(ext)
        out = tuple(w[..., d * sps: (d + length) * sps] for w in waves)
        self._tail = ext[..., ext.shape[-1] - d:]
        self._seen += length
        return self._out(out)

    def flush(self):
        """Emit the ``span*sps`` flush-tail samples; the stream is then
        finished."""
        d, sps = self.span, self.chain.sps
        waves = self._run(self._tail)
        out = tuple(w[..., d * sps: 2 * d * sps] for w in waves)
        self._seen = 0
        self._tail = _sentinels(self.batch_shape, d, self.device)
        return self._out(out)

    def get_state(self) -> dict:
        """Carry: ``{"tail": [..., span] int32, "seen": int}``."""
        return {"tail": self._tail, "seen": self._seen}

    def set_state(self, state) -> None:
        self._tail = _restore(state["tail"], torch.int32, self.device)
        self._seen = int(state["seen"])


class StreamingFusedRx:
    """Unbounded waveform -> bits through the fused RX
    (:func:`modem_tpu_torch.ops.txrx.fused_rx`).

    The matched filter looks forward ``span`` symbols, so decisions lag the
    input by ``span*sps`` samples: the carry is the last ``span*sps``
    samples of each rail (one real rail at passband). Pushing a TX stream
    including its flush tail yields exactly all K decisions; :meth:`flush`
    finalizes against zeros for truncated streams. Push lengths must be
    multiples of ``sps``.
    """

    def __init__(self, chain: PulseShapedChain,
                 batch_shape: tuple[int, ...] = ()):
        self.chain = chain
        self.bps = chain.bits_per_symbol
        self.span = chain.span
        self.batch_shape = tuple(batch_shape)
        self.device = chain.lut.device
        self.n_rails = 1 if chain.carrier_hz is not None else 2
        self._tail = self._zeros(self.span * chain.sps)
        self._seen = 0  # stream samples consumed so far

    def _zeros(self, n: int) -> list[torch.Tensor]:
        return [torch.zeros(self.batch_shape + (n,), dtype=torch.float32,
                            device=self.device) for _ in range(self.n_rails)]

    def _run(self, ext, n_symbols: int) -> torch.Tensor:
        ch = self.chain
        # ext symbol 0 is stream symbol _seen/sps - span
        wave = ext[0] if self.n_rails == 1 else tuple(ext)
        return fused_rx(wave, n_symbols, rrc_taps=ch.rrc, sps=ch.sps,
                        span=self.span,
                        sym_offset=self._seen // ch.sps - self.span,
                        **ch._txrx_params(), **ch._carrier())

    def push(self, wave) -> torch.Tensor:
        """``[..., L]`` samples (``(i, q)`` at baseband, the real waveform
        at passband; ``L % sps == 0``) -> newly final decided bits (lagging
        ``span`` symbols)."""
        sps, d = self.chain.sps, self.span
        waves = [wave] if self.n_rails == 1 else list(wave)
        length = waves[0].shape[-1]
        if length % sps:
            raise ValueError("push length must be a multiple of sps")
        ext = [torch.cat([t, w.to(torch.float32)], dim=-1)
               for t, w in zip(self._tail, waves)]
        dec = self._run(ext, length // sps)
        # the first `skip` local decisions predate the stream on early calls
        skip = max(0, d - self._seen // sps)
        out = dec[..., skip:]
        self._tail = [e[..., e.shape[-1] - d * sps:] for e in ext]
        self._seen += length
        return unpack_symbols(out, self.bps)

    def flush(self) -> torch.Tensor:
        """Finalize pending decisions against a zero tail (for streams
        truncated before the TX flush); the stream is then finished."""
        sps, d = self.chain.sps, self.span
        pending = min(d, self._seen // sps)
        if pending == 0:
            empty = torch.zeros(self.batch_shape + (0,), dtype=torch.int32,
                                device=self.device)
            return unpack_symbols(empty, self.bps)
        ext = [torch.cat([t, z], dim=-1)
               for t, z in zip(self._tail, self._zeros(d * sps))]
        dec = self._run(ext, d)
        out = dec[..., d - pending: d]
        self._seen = 0
        self._tail = self._zeros(d * sps)
        return unpack_symbols(out, self.bps)

    def get_state(self) -> dict:
        """Carry: ``{"tails": one [..., span*sps] float32 per rail, "seen":
        int}``."""
        return {"tails": list(self._tail), "seen": self._seen}

    def set_state(self, state) -> None:
        self._tail = [_restore(t, torch.float32, self.device)
                      for t in state["tails"]]
        self._seen = int(state["seen"])
