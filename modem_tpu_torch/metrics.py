"""Link-quality metrics: BER / SER / EVM / SNR, stateless and streaming
(counterpart of :mod:`modem_tpu.metrics`).

* stateless block helpers (:func:`ber`, :func:`evm_rms`, ...): one block
  in, a scalar out;
* :class:`LinkStats`: an accumulating carry for a chunked run (``stats =
  stats.update_bits(tx, rx)`` per block), merged across runs with
  :meth:`LinkStats.merge`, read exactly at the end.

The counters are int64 tensors on the stats' device: the JAX package keeps
two int32 limbs because its TPU defaults to 32-bit integers, a workaround
the card does not need. The EVM/SNR power sums keep the JAX package's
Kahan-compensated float32 accumulation, so a long stream does not lose the
error-power sum to cancellation. :meth:`LinkStats.psum` sums the stats of
the ranks of a process group.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from .cuda import resolve_device


def bit_errors(tx_bits: torch.Tensor, rx_bits: torch.Tensor) -> torch.Tensor:
    return torch.sum(tx_bits.to(torch.int32) != rx_bits.to(torch.int32))


def ber(tx_bits: torch.Tensor, rx_bits: torch.Tensor) -> torch.Tensor:
    return bit_errors(tx_bits, rx_bits) / tx_bits.numel()


def ser(tx_syms: torch.Tensor, rx_syms: torch.Tensor) -> torch.Tensor:
    return torch.sum(tx_syms != rx_syms) / tx_syms.numel()


def evm_rms(rx_i: torch.Tensor, rx_q: torch.Tensor, ref_i: torch.Tensor,
            ref_q: torch.Tensor) -> torch.Tensor:
    """RMS error-vector magnitude, normalized to the RMS reference power."""
    err = (rx_i - ref_i) ** 2 + (rx_q - ref_q) ** 2
    ref = ref_i ** 2 + ref_q ** 2
    return torch.sqrt(torch.mean(err) / torch.mean(ref))


def snr_estimate_db(rx_i: torch.Tensor, rx_q: torch.Tensor,
                    ref_i: torch.Tensor, ref_q: torch.Tensor) -> torch.Tensor:
    err = (rx_i - ref_i) ** 2 + (rx_q - ref_q) ** 2
    ref = ref_i ** 2 + ref_q ** 2
    return 10.0 * torch.log10(torch.mean(ref) / torch.mean(err))


def _kahan(acc: torch.Tensor, x_sum: torch.Tensor) -> torch.Tensor:
    """One compensated step on ``acc = [sum, compensation]`` float32."""
    y = x_sum - acc[1]
    t = acc[0] + y
    return torch.stack([t, (t - acc[0]) - y])


_COUNTERS = ("bit_err", "bit_tot", "sym_err", "sym_tot", "frame_err",
             "frame_tot", "blocks")


@dataclasses.dataclass(frozen=True)
class LinkStats:
    """Accumulating link statistics as an immutable carry: every
    ``update_*`` returns a new :class:`LinkStats` and waits for nothing on
    the device; the properties read the totals."""

    bit_err: torch.Tensor
    bit_tot: torch.Tensor
    sym_err: torch.Tensor
    sym_tot: torch.Tensor
    frame_err: torch.Tensor
    frame_tot: torch.Tensor
    blocks: torch.Tensor
    evm_err: torch.Tensor  # [2] float32: Kahan (sum, compensation)
    evm_ref: torch.Tensor  # [2] float32

    @classmethod
    def zero(cls, device: torch.device | str | None = None) -> "LinkStats":
        """Empty stats on ``device`` (the card unless the caller asks for
        the CPU)."""
        dev = resolve_device(device)
        z = torch.zeros((), dtype=torch.int64, device=dev)
        f = torch.zeros((2,), dtype=torch.float32, device=dev)
        return cls(*([z] * len(_COUNTERS)), f, f)

    # -- updates (each counts one block) -------------------------------

    def update_bits(self, tx_bits: torch.Tensor,
                    rx_bits: torch.Tensor) -> "LinkStats":
        return dataclasses.replace(
            self, bit_err=self.bit_err + bit_errors(tx_bits, rx_bits),
            bit_tot=self.bit_tot + tx_bits.numel(), blocks=self.blocks + 1)

    def update_symbols(self, tx_syms: torch.Tensor,
                       rx_syms: torch.Tensor) -> "LinkStats":
        return dataclasses.replace(
            self, sym_err=self.sym_err + torch.sum(tx_syms != rx_syms),
            sym_tot=self.sym_tot + tx_syms.numel())

    def update_frames(self, crc_ok: torch.Tensor) -> "LinkStats":
        """``crc_ok``: one verdict per frame (e.g. :meth:`FramedLink.rx`)."""
        bad = torch.sum(~crc_ok.to(torch.bool))
        return dataclasses.replace(
            self, frame_err=self.frame_err + bad,
            frame_tot=self.frame_tot + crc_ok.numel())

    def update_evm(self, rx_i, rx_q, ref_i, ref_q) -> "LinkStats":
        err = torch.sum((rx_i - ref_i) ** 2 + (rx_q - ref_q) ** 2)
        ref = torch.sum(ref_i ** 2 + ref_q ** 2)
        return dataclasses.replace(self, evm_err=_kahan(self.evm_err, err),
                                   evm_ref=_kahan(self.evm_ref, ref))

    # -- combination ----------------------------------------------------

    def merge(self, other: "LinkStats") -> "LinkStats":
        counts = [getattr(self, f) + getattr(other, f) for f in _COUNTERS]
        return LinkStats(*counts, self.evm_err + other.evm_err,
                         self.evm_ref + other.evm_ref)

    def psum(self, group) -> "LinkStats":
        """The stats of every rank of ``group`` summed, on each of them
        (every rank must call it): one ``all_reduce`` a field. The counters
        are int64, so no limbs are needed; the EVM pairs are summed
        elementwise, as the JAX package's ``psum`` does."""
        from .parallel.collectives import psum

        return LinkStats(*(psum(getattr(self, f), group)
                           for f in _COUNTERS + ("evm_err", "evm_ref")))

    # -- readout ---------------------------------------------------------

    @property
    def n_bits(self) -> int:
        return int(self.bit_tot)

    @property
    def n_bit_errors(self) -> int:
        return int(self.bit_err)

    @property
    def n_blocks(self) -> int:
        return int(self.blocks)

    @property
    def ber(self) -> float:
        n = self.n_bits
        return int(self.bit_err) / n if n else 0.0

    @property
    def ser(self) -> float:
        n = int(self.sym_tot)
        return int(self.sym_err) / n if n else 0.0

    @property
    def fer(self) -> float:
        n = int(self.frame_tot)
        return int(self.frame_err) / n if n else 0.0

    @property
    def evm(self) -> float:
        ref = float(self.evm_ref[0])
        return math.sqrt(float(self.evm_err[0]) / ref) if ref > 0 else 0.0

    @property
    def snr_db(self) -> float:
        err = float(self.evm_err[0])
        ref = float(self.evm_ref[0])
        return (10.0 * math.log10(ref / err) if err > 0 and ref > 0
                else float("inf"))

    def summary(self) -> dict:
        return {
            "blocks": self.n_blocks,
            "bits": self.n_bits, "bit_errors": self.n_bit_errors,
            "ber": self.ber,
            "symbols": int(self.sym_tot),
            "symbol_errors": int(self.sym_err), "ser": self.ser,
            "frames": int(self.frame_tot),
            "frame_errors": int(self.frame_err), "fer": self.fer,
            "evm": self.evm, "snr_db": self.snr_db,
        }
