"""BASELINE config #4: QAM with a polyphase rational resampler in the chain
(counterpart of :mod:`modem_tpu.resampled`).

    bits -> QAM map -> RRC pulse shaping (sps, symbol-rate polyphase)
         -> rational resample up/down   (modem rate -> channel rate)
         -> [channel: optional AWGN at the channel rate]
         -> rational resample down/up   (channel rate -> modem rate)
         -> matched filter + delay-compensated symbol sampling
         -> min-distance slice -> bits

Two forms, as in the JAX package: the staged one (``tx``, ``rx``,
``rx_soft``, ``roundtrip``, ``ber``), the readable cross-check, and the
fused one (``tx_fused``, ``rx_fused``, ``rx_soft_fused``,
``roundtrip_fused``), the production path, one hand-written CUDA kernel per
direction on a CUDA device (K11 and K12,
:mod:`~modem_tpu_torch.ops.resampled_kernel`) with the channel-rate
waveform as the only intermediate in device memory.

Group delay: each resampler is a causal linear-phase lowpass; the cascade's
delay at the modem rate is ``(L1 + L2 - 2) / (2 * up)`` samples. The
constructor picks the stage-2 ``taps_per_phase`` that makes it an exact
integer, so decision instants stay on the symbol grid.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .chain import _rrc_buffer, shape_iq
from .config import Rates
from .cuda import resolve_device
from .models.base import LutScheme, Scheme
from .ops.channel import awgn
from .ops.fir import fir_filter
from .ops.llr import lut_llr
from .ops.polyphase import _phase_bank, polyphase_decim, polyphase_interp
from .ops.resample import rational_resample, resample_taps
from .ops.resampled_kernel import fused_resampled_rx, fused_resampled_tx
from .ops.slicer import lut_map, lut_slice
from .utils.bits import pack_bits, unpack_symbols


def _solve_stage2_taps(up: int, down: int, t1: int) -> int:
    """Smallest ``t2 >= t1`` with ``(up*t1 + down*t2 - 2) % (2*up) == 0``:
    the resampler cascade's group delay is an integer number of modem-rate
    samples. Solvable for any coprime (up, down) once ``t1`` is even."""
    for t2 in range(t1, t1 + 2 * up + 1):
        if (up * t1 + down * t2 - 2) % (2 * up) == 0:
            return t2
    raise ValueError(
        f"no integer-delay taps_per_phase for up={up}, down={down}, t1={t1}")


class ResampledChain(torch.nn.Module):
    """16/64-QAM (any constellation-LUT scheme) with a rational resampler
    pair in the loop (`BASELINE.json` configs[3]).

    ``up/down`` is the modem-rate -> channel-rate ratio (reduced
    internally); ``up=3, down=2`` models a DAC at 1.5x the modem clock. The
    table, the RRC taps and the two resampler prototypes ``taps1``/``taps2``
    are buffers on ``device``, the card unless the caller asks for the CPU;
    every tensor passed in must be there too. ``rrc``, ``taps1`` and
    ``taps2`` replace the designed filters (:meth:`from_numpy`).
    """

    def __init__(self, scheme: Scheme, rates: Rates, up: int, down: int,
                 span_symbols: int = 8, beta: float = 0.35,
                 taps_per_phase: int = 16,
                 device: torch.device | str | None = None,
                 rrc=None, taps1=None, taps2=None):
        super().__init__()
        if not hasattr(scheme, "lut"):
            raise TypeError("ResampledChain needs a constellation-LUT scheme")
        g = math.gcd(up, down)
        up, down = up // g, down // g
        if taps_per_phase % 2:
            taps_per_phase += 1  # even t1 guarantees an integer-delay t2
        self.scheme = scheme
        self.rates = rates
        self.up = up
        self.down = down
        self.span = span_symbols
        self.sps = rates.samples_per_symbol
        device = resolve_device(device)
        if taps1 is None:
            taps1 = resample_taps(up, down, taps_per_phase)
        if taps2 is None:
            taps2 = resample_taps(down, up,
                                  _solve_stage2_taps(up, down, taps_per_phase))
        #: host copies of the filters: the fused kernels' tables are built
        #: from them without reading the card back
        self._host = {
            "rrc": _rrc_buffer(rrc, self.sps, span_symbols, beta, "cpu").numpy(),
            "taps1": np.asarray(taps1, np.float32),
            "taps2": np.asarray(taps2, np.float32)}
        if (len(taps1) + len(taps2) - 2) % (2 * up):
            raise ValueError("taps1 and taps2 give no integer cascade delay")
        for name, value in self._host.items():
            self.register_buffer(name, torch.as_tensor(value, device=device))
        self.register_buffer("lut", torch.as_tensor(
            np.asarray(scheme.lut, np.float32), device=device))
        #: cascade group delay in modem-rate samples (exact integer)
        self.resample_delay = (len(taps1) + len(taps2) - 2) // (2 * up)
        #: symbol decision delay: RRC pair (span*sps) + resampler cascade
        self.delay = self.span * self.sps + self.resample_delay

    @classmethod
    def from_numpy(cls, params: dict, rates: Rates, up: int, down: int,
                   device: torch.device | str | None = None
                   ) -> "ResampledChain":
        """Build from another chain's arrays: ``{"lut", "rrc", "taps1",
        "taps2", "bits_per_symbol"}``, e.g. ``np.asarray`` of a
        :class:`modem_tpu.resampled.ResampledChain`'s attributes, so that
        both filter, resample and slice with the same numbers."""
        sps = rates.samples_per_symbol
        span, rem = divmod(len(params["rrc"]) - 1, sps)
        if rem:
            raise ValueError("rrc taps length must equal span*sps + 1")
        scheme = LutScheme(params["lut"], params["bits_per_symbol"])
        return cls(scheme, rates, up, down, span_symbols=span, device=device,
                   rrc=params["rrc"], taps1=params["taps1"],
                   taps2=params["taps2"])

    @property
    def bits_per_symbol(self) -> int:
        return self.scheme.bits_per_symbol

    # ---- rate/padding bookkeeping ----

    def _padded_len(self, n_symbols: int) -> int:
        """Baseband length after flush + drain + divisibility padding: long
        enough to cover the last delay-compensated decision instant, rounded
        up to a whole number of channel-rate samples."""
        n0 = (n_symbols + self.span) * self.sps
        need = self.delay + (n_symbols - 1) * self.sps + 1
        n_pad = max(n0, need)
        return n_pad + (-n_pad) % self._block_quantum()

    def _block_quantum(self) -> int:
        """Smallest modem-rate block with an integer number of channel-rate
        samples: gcd(up, down) == 1, so ``down`` itself."""
        return self.down

    # ---- TX ----

    def map_symbols(self, bits: torch.Tensor) -> torch.Tensor:
        return pack_bits(bits, self.bits_per_symbol)

    def tx(self, bits: torch.Tensor):
        """bits -> channel-rate baseband ``(i, q)`` (resampled by up/down)."""
        syms = self.map_symbols(bits)
        mi, mq = lut_map(syms, self.lut)
        si, sq = shape_iq(torch.stack([mi, mq], dim=-1), self.rrc, self.sps,
                          self.span, polyphase=True)
        pad = self._padded_len(syms.shape[-1]) - si.shape[-1]
        out = []
        for s in (si, sq):
            s = torch.nn.functional.pad(s, (0, pad))
            out.append(rational_resample(s, self.up, self.down, self.taps1)[0])
        return out[0], out[1]

    # ---- RX ----

    def decision_points(self, rx_wave, n_symbols: int):
        """channel-rate waveform -> matched-filter outputs at the
        delay-compensated symbol instants ``(di, dq) [..., K]``."""
        out = []
        for c in rx_wave:
            y, _ = rational_resample(c, self.down, self.up, self.taps2)
            out.append(polyphase_decim(y, self.rrc, self.sps, self.delay,
                                       n_symbols))
        return out[0], out[1]

    def rx(self, rx_wave, n_symbols: int) -> torch.Tensor:
        """channel-rate waveform -> decided bits ``[..., K*bps]``."""
        di, dq = self.decision_points(rx_wave, n_symbols)
        return unpack_symbols(lut_slice(di, dq, self.lut), self.bits_per_symbol)

    def rx_soft(self, rx_wave, n_symbols: int,
                noise_var: float = 1.0) -> torch.Tensor:
        """channel-rate waveform -> per-bit max-log LLRs ``[..., K*bps]``."""
        di, dq = self.decision_points(rx_wave, n_symbols)
        return lut_llr(di, dq, self.lut, self.bits_per_symbol, noise_var)

    def roundtrip(self, bits: torch.Tensor) -> torch.Tensor:
        """Noiseless bits -> bits (exact for sane configs)."""
        return self.rx(self.tx(bits), bits.shape[-1] // self.bits_per_symbol)

    def ber(self, bits: torch.Tensor, snr_db: float,
            generator: torch.Generator) -> torch.Tensor:
        """Bit error rate with AWGN applied at the *channel* rate, drawn from
        ``generator`` (on the device of ``bits``)."""
        bps = self.bits_per_symbol
        k = bits.shape[-1] // bps
        ci, cq = awgn(generator, *self.tx(bits), snr_db)
        dec = self.rx((ci, cq), k)
        return torch.mean((dec != bits[..., :k * bps]).to(torch.float32))

    # ---- fused: K11 and K12 ----

    def tx_fused(self, bits: torch.Tensor):
        """bits -> channel-rate ``(i, q)`` through K11 (pulse shaping and
        stage-1 resampler in shared memory): :meth:`tx` to f32
        reassociation."""
        syms = self.map_symbols(bits)
        return fused_resampled_tx(
            syms, self.lut, self._host["rrc"], self.sps, self.span, self.up,
            self.down, self._host["taps1"], self._padded_len(syms.shape[-1]))

    def _fused_rx(self, rx_wave, n_symbols: int, soft: bool):
        return fused_resampled_rx(
            rx_wave, n_symbols, self.lut, self._host["rrc"], self.sps,
            self.span, self.up, self.down, self._host["taps2"], self.delay,
            soft=soft)

    def rx_fused(self, rx_wave, n_symbols: int) -> torch.Tensor:
        """channel-rate ``(i, q)`` -> decided bits through K12 (stage-2
        resampler, matched filter and delay-compensated slicing in one
        table); decisions equal :meth:`rx`."""
        return unpack_symbols(self._fused_rx(rx_wave, n_symbols, False),
                              self.bits_per_symbol)

    def rx_soft_fused(self, rx_wave, n_symbols: int,
                      noise_var: float = 1.0) -> torch.Tensor:
        """channel-rate ``(i, q)`` -> per-bit LLRs: K12's decision-point I/Q
        (``soft=True``), then the symbol-rate LLR layer."""
        di, dq = self._fused_rx(rx_wave, n_symbols, True)
        return lut_llr(di, dq, self.lut, self.bits_per_symbol, noise_var)

    def roundtrip_fused(self, bits: torch.Tensor) -> torch.Tensor:
        """Noiseless bits -> bits through K11 and K12, the channel-rate
        waveform the only intermediate in device memory."""
        k = bits.shape[-1] // self.bits_per_symbol
        return self.rx_fused(self.tx_fused(bits), k)


class StreamingResampledChain:
    """Block streaming over :class:`ResampledChain`'s staged form: pushes of
    any size, decisions emitted as their delay clears, ``flush()`` drains the
    pipeline. Equal to the one-shot chain bit for bit (every stage's
    per-output sum is unchanged; only block seams move)."""

    def __init__(self, chain: ResampledChain,
                 batch_shape: tuple[int, ...] = ()):
        self.chain = chain
        self.batch = batch_shape
        self.bps = chain.bits_per_symbol
        c = chain
        dev = c.lut.device
        kp_i = _phase_bank(c.rrc, c.sps).shape[1]

        def z(n):
            return torch.zeros(batch_shape + (n,), dtype=torch.float32,
                               device=dev)

        # per-rail carried state of the pulse shaper, resample down,
        # resample up and the matched filter
        self._interp = [z(kp_i - 1), z(kp_i - 1)]
        t1 = len(c.taps1) // c.up
        t2 = len(c.taps2) // c.down
        self._rs1 = [z(t1 - 1), z(t1 - 1)]
        self._rs2 = [z(t2 - 1), z(t2 - 1)]
        self._mf = [z(len(c.rrc) - 1), z(len(c.rrc) - 1)]
        # modem-rate samples not yet pushed into the resampler (block quantum)
        self._resid = [z(0), z(0)]
        # matched-filter output awaiting its decision instant
        self._out = [z(0), z(0)]
        self._out_start = 0  # global sample index of self._out[r][..., 0]
        self._sym_emitted = 0
        self._sym_seen = 0
        self._finished = False

    def _advance(self, bi: torch.Tensor, bq: torch.Tensor) -> None:
        """Push modem-rate baseband through resample -> resample -> matched
        filter, in whole blocks of the down-divisibility quantum."""
        c = self.chain
        bi = torch.cat([self._resid[0], bi], dim=-1)
        bq = torch.cat([self._resid[1], bq], dim=-1)
        n = bi.shape[-1] - bi.shape[-1] % c._block_quantum()
        self._resid = [bi[..., n:], bq[..., n:]]
        if n == 0:
            return
        for r, x in enumerate((bi[..., :n], bq[..., :n])):
            y, self._rs1[r] = rational_resample(x, c.up, c.down, c.taps1,
                                                state=self._rs1[r])
            y, self._rs2[r] = rational_resample(y, c.down, c.up, c.taps2,
                                                state=self._rs2[r])
            y, self._mf[r] = fir_filter(y, c.rrc, state=self._mf[r])
            self._out[r] = torch.cat([self._out[r], y], dim=-1)

    def _emit(self) -> torch.Tensor:
        """Decide every symbol whose instant is inside the buffered output."""
        c = self.chain
        avail = self._out_start + self._out[0].shape[-1]
        # instants: delay + m*sps for m in [sym_emitted, sym_seen)
        hi = min(self._sym_seen,
                 (avail - c.delay - 1) // c.sps + 1 if avail > c.delay else 0)
        if hi <= self._sym_emitted:
            return torch.zeros(self.batch + (0,), dtype=torch.int32,
                               device=c.lut.device)
        idx = (c.delay - self._out_start
               + torch.arange(self._sym_emitted, hi, device=c.lut.device)
               * c.sps)
        syms = lut_slice(self._out[0][..., idx], self._out[1][..., idx], c.lut)
        self._sym_emitted = hi
        # keep the history from the next undecided instant on
        keep = c.delay + hi * c.sps - self._out_start
        keep = max(min(keep, self._out[0].shape[-1]), 0)
        self._out = [o[..., keep:] for o in self._out]
        self._out_start += keep
        return unpack_symbols(syms, self.bps)

    def push(self, bits: torch.Tensor) -> torch.Tensor:
        """``[..., L*bps]`` bits in -> newly final decided bits out."""
        if self._finished:
            raise RuntimeError("stream already flushed")
        if bits.shape[:-1] != self.batch:
            raise ValueError("batch shape is fixed at construction")
        c = self.chain
        syms = pack_bits(bits, self.bps)
        self._sym_seen += syms.shape[-1]
        outs = []
        for r, z in enumerate(lut_map(syms, c.lut)):
            y, self._interp[r] = polyphase_interp(z, c.rrc, c.sps,
                                                  state=self._interp[r])
            outs.append(y)
        self._advance(*outs)
        return self._emit()

    def flush(self) -> torch.Tensor:
        """Drain: ``span`` zero flush symbols through the pulse shaper, then
        zero samples until every pending decision instant has cleared."""
        c = self.chain
        zsym = torch.zeros(self.batch + (c.span,), dtype=torch.float32,
                           device=c.lut.device)
        outs = []
        for r in range(2):
            y, self._interp[r] = polyphase_interp(zsym, c.rrc, c.sps,
                                                  state=self._interp[r])
            outs.append(y)
        self._advance(*outs)
        # zero samples to push the last instant through the cascade + quantum
        need = c.delay + (self._sym_seen - 1) * c.sps + 1
        have = (self._out_start + self._out[0].shape[-1]
                + self._resid[0].shape[-1])
        pad = max(need - have, 0) + c._block_quantum()
        zeros = torch.zeros(self.batch + (pad,), dtype=torch.float32,
                            device=c.lut.device)
        self._advance(zeros, zeros)
        out = self._emit()
        self._finished = True
        return out
