"""Block error counts (counterpart of the stateless helpers of
:mod:`modem_tpu.metrics`; its ``LinkStats`` carry is not ported yet)."""

from __future__ import annotations

import torch


def bit_errors(tx_bits: torch.Tensor, rx_bits: torch.Tensor) -> torch.Tensor:
    return torch.sum(tx_bits.to(torch.int32) != rx_bits.to(torch.int32))


def ber(tx_bits: torch.Tensor, rx_bits: torch.Tensor) -> torch.Tensor:
    return bit_errors(tx_bits, rx_bits) / tx_bits.numel()


def ser(tx_syms: torch.Tensor, rx_syms: torch.Tensor) -> torch.Tensor:
    return torch.sum(tx_syms != rx_syms) / tx_syms.numel()
