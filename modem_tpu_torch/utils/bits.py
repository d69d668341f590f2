"""Bit/symbol packing on tensors (counterpart of :mod:`modem_tpu.utils.bits`).

Symbols are packed MSB first, as the reference does one symbol at a time
(`digital/util.rs:5-11`). Layouts match the JAX package: bits ``[..., K*bps]``
and symbols ``[..., K]``, both int32.
"""

from __future__ import annotations

import torch


def max_symbol(bits_per_symbol: int) -> int:
    """2**bps - 1, mirroring `digital/util.rs:13-15`."""
    return (1 << bits_per_symbol) - 1


def bit_to_sign(bits: torch.Tensor) -> torch.Tensor:
    """0/1 -> -1.0/+1.0 float32, mirroring `digital/util.rs:1-3`."""
    return (2 * bits - 1).to(torch.float32)


def _msb_first_shifts(bits_per_symbol: int, device) -> torch.Tensor:
    return torch.arange(bits_per_symbol - 1, -1, -1, dtype=torch.int32,
                        device=device)


def pack_bits(bits: torch.Tensor, bits_per_symbol: int) -> torch.Tensor:
    """Pack ``[..., K*bps]`` {0,1} bits into ``[..., K]`` int32 symbols, MSB
    first. Trailing bits that do not fill a whole symbol must already be
    trimmed by the caller."""
    if bits.shape[-1] % bits_per_symbol != 0:
        raise ValueError(
            f"bit count {bits.shape[-1]} not a multiple of bps={bits_per_symbol}"
        )
    k = bits.shape[-1] // bits_per_symbol
    groups = bits.reshape(bits.shape[:-1] + (k, bits_per_symbol)).to(torch.int32)
    return torch.sum(groups << _msb_first_shifts(bits_per_symbol, bits.device),
                     dim=-1, dtype=torch.int32)


def unpack_symbols(symbols: torch.Tensor, bits_per_symbol: int) -> torch.Tensor:
    """Inverse of :func:`pack_bits`: ``[..., K]`` int32 -> ``[..., K*bps]`` bits."""
    shifts = _msb_first_shifts(bits_per_symbol, symbols.device)
    bits = (symbols.to(torch.int32)[..., None] >> shifts) & 1
    return bits.reshape(symbols.shape[:-1] + (symbols.shape[-1] * bits_per_symbol,))
