"""Cyclic redundancy checks as GF(2) linear algebra, batched over channels
(counterpart of :mod:`modem_tpu.fec.crc`).

A non-reflected CRC is an affine function of the message bits,
``crc(msg) = msg · H + r0 (mod 2)``: ``H`` (column ``i`` the remainder
``x^{L-1-i+w} mod g``) and ``r0`` (the ``init`` register's part) are built
on the host once per length, and the device evaluates one float32 product
(exact for 0/1 sums below 2^24; the card's matmul has no int32 form) and a
remainder.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..utils.cache import on_device


class Crc:
    """Bit-level CRC, MSB-first, non-reflected.

    ``poly``: generator without the leading ``x^w`` term (CCITT ``0x1021``
    for width 16); ``init``: register preload; ``xorout``: final XOR.
    """

    def __init__(self, width: int, poly: int, init: int = 0,
                 xorout: int = 0):
        if width < 2 or width > 64:
            raise ValueError("width must be in [2, 64]")
        self.w = int(width)
        self.poly = int(poly)
        self.init = int(init)
        self.xorout = int(xorout)

    # ---- host-side reference bit loop (also builds the matrices) ----

    def _crc_int(self, bits: np.ndarray, init: int) -> int:
        r = init
        mask = (1 << self.w) - 1
        for b in bits:
            fb = ((r >> (self.w - 1)) & 1) ^ int(b)
            r = ((r << 1) & mask)
            if fb:
                r ^= self.poly
        return r

    @lru_cache(maxsize=32)
    def _affine(self, l: int) -> tuple[np.ndarray, np.ndarray]:
        """(H [l, w], r0 [w]): crc_bits = msg @ H + r0 (mod 2), MSB first."""
        mask = (1 << self.w) - 1
        h = np.zeros((l, self.w), np.uint8)
        t = self.poly & mask  # x^w mod g
        for j in range(l):  # j = L-1-i
            i = l - 1 - j
            for k in range(self.w):
                h[i, k] = (t >> (self.w - 1 - k)) & 1  # MSB first
            fb = (t >> (self.w - 1)) & 1
            t = (t << 1) & mask
            if fb:
                t ^= self.poly
        r0 = self._crc_int(np.zeros(l, np.uint8), self.init) ^ self.xorout
        r0 = np.array([(r0 >> (self.w - 1 - k)) & 1 for k in range(self.w)],
                      np.uint8)
        return h, r0

    # ---- device ops ----

    def compute(self, bits: torch.Tensor) -> torch.Tensor:
        """``[..., L]`` message bits -> ``[..., w]`` int32 CRC bits (MSB
        first)."""
        l = bits.shape[-1]
        h = on_device(self, ("h", l), lambda: self._affine(l)[0],
                      torch.float32, bits.device)
        r0 = on_device(self, ("r0", l), lambda: self._affine(l)[1],
                       torch.float32, bits.device)
        c = bits.to(torch.float32) @ h
        return torch.remainder(c + r0, 2.0).to(torch.int32)

    def append(self, bits: torch.Tensor) -> torch.Tensor:
        """Message -> message ‖ CRC (``[..., L+w]``)."""
        return torch.cat([bits, self.compute(bits).to(bits.dtype)], dim=-1)

    def check(self, frame: torch.Tensor) -> torch.Tensor:
        """``[..., L+w]`` frame -> boolean ``[...]`` pass/fail."""
        msg = frame[..., : frame.shape[-1] - self.w]
        got = frame[..., frame.shape[-1] - self.w:]
        return torch.all(self.compute(msg) == got, dim=-1)


def crc16_ccitt() -> Crc:
    """CRC-16/CCITT-FALSE (CCSDS TM frames): 0x1021, init 0xFFFF."""
    return Crc(16, 0x1021, init=0xFFFF)


def crc32_mpeg2() -> Crc:
    """CRC-32/MPEG-2: 0x04C11DB7, init 0xFFFFFFFF, non-reflected."""
    return Crc(32, 0x04C11DB7, init=0xFFFFFFFF)
