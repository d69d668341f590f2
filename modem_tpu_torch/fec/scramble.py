"""Additive (synchronous) LFSR scrambler, block-parallel over GF(2)
(counterpart of :mod:`modem_tpu.fec.scramble`).

An LFSR is linear over GF(2), so a block of ``B`` keystream bits is a
linear function of the seed state: the host builds the ``[B, m]`` matrix
``C`` (rows ``c·M^j``) and the state advance ``M^B`` once per block length,
and the device evaluates each as one float32 product and a remainder
(exact: sums of at most ``m`` ones).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..cuda import resolve_device
from ..utils.cache import on_device


class Scrambler:
    """Additive scrambler with generator polynomial ``poly`` of degree ``m``.

    ``poly``: integer with bit ``i`` set for term ``x^i`` (bit ``m`` set).
    Fibonacci form: the feedback bit, the XOR of the state cells at the
    non-leading terms, is also the keystream bit. ``seed``: initial register
    contents, bit ``i`` = cell ``i``, cell ``m-1`` the oldest.
    """

    def __init__(self, poly: int, seed: int):
        m = poly.bit_length() - 1
        if m < 2:
            raise ValueError("polynomial degree must be >= 2")
        if seed <= 0 or seed >= 1 << m:
            raise ValueError(f"seed must be a nonzero {m}-bit value")
        self.m = m
        self.poly = int(poly)
        self.seed = int(seed)
        # companion matrix over GF(2): s'[0] = f, s'[i] = s[i-1]
        taps = [i for i in range(m) if (poly >> i) & 1]
        mat = np.zeros((m, m), np.uint8)
        for i in taps:
            mat[0, i] = 1
        for i in range(1, m):
            mat[i, i - 1] = 1
        self._mat = mat
        self._out = mat[0].copy()  # keystream bit = feedback bit = (M s)[0]

    @lru_cache(maxsize=32)
    def _block_mats(self, b: int) -> tuple[np.ndarray, np.ndarray]:
        """(C [b, m], A [m, m]): keystream = C·s0, next state = A·s0."""
        c = np.zeros((b, self.m), np.uint8)
        p = np.eye(self.m, dtype=np.uint8)  # M^j
        for j in range(b):
            c[j] = (self._out @ p) % 2
            p = (self._mat @ p) % 2
        return c, p

    def init_state(self, batch_shape: tuple[int, ...] = (),
                   device: torch.device | str | None = None) -> torch.Tensor:
        """Seed register as a ``[..., m]`` int32 bit vector on ``device``
        (the card unless the caller asks for the CPU)."""
        bits = [(self.seed >> i) & 1 for i in range(self.m)]
        s = torch.tensor(bits, dtype=torch.int32,
                         device=resolve_device(device))
        return s.expand(tuple(batch_shape) + (self.m,))

    def keystream(self, state: torch.Tensor, length: int):
        """``([..., m] state, B)`` -> (``[..., B]`` keystream, next state),
        both int32."""
        def mats():
            c, a = self._block_mats(length)
            return np.concatenate([c.T, a.T], axis=1)  # [m, B + m]

        both = on_device(self, ("mats", length), mats, torch.float32,
                         state.device)
        out = torch.remainder(state.to(torch.float32) @ both, 2.0)
        out = out.to(torch.int32)
        return out[..., :length], out[..., length:]

    def scramble(self, bits: torch.Tensor, state: torch.Tensor):
        """XOR a block of bits with the keystream; returns (out, state).
        Applying it again from the same state descrambles."""
        ks, nxt = self.keystream(state, bits.shape[-1])
        return (bits + ks) % 2, nxt

    descramble = scramble


def dvb_scrambler() -> Scrambler:
    """The DVB framing scrambler: 1 + x^14 + x^15, seed 100101010000000."""
    return Scrambler((1 << 15) | (1 << 14) | 1, 0b100101010000000)


def ieee80211_scrambler(seed: int = 0b1011101) -> Scrambler:
    """The 802.11 scrambler: x^7 + x^4 + 1."""
    return Scrambler((1 << 7) | (1 << 4) | 1, seed)
