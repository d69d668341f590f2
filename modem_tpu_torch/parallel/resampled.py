"""The distributed resampled chain, BASELINE config #4 at scale
(counterpart of :mod:`modem_tpu.parallel.resampled`).

Shards :class:`~modem_tpu_torch.resampled.ResampledChain` over
``("ch", "time")`` as the pulse chain: channels need no collective; the
time dimension splits the *symbol* stream, each rank running the fused
resampled kernels (K11 the TX, K12 the RX) on its block with halos of the
channel-rate waveform.

Alignment: the rational stages are periodically time-varying, so a rank's
block must start on a pattern boundary: ``Kl * sps % down == 0`` (whole
channel samples a rank) and ``Kl % P == 0`` with ``P = down / gcd(sps*up,
down)`` (the composite RX stage's output period). The halos are rounded to
whole symbols with the same property, so every rank's kernel arithmetic is
the global one shifted by whole pattern periods. Noiseless decisions equal
the single-device fused chain exactly.
"""

from __future__ import annotations

import math

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..ops.resampled_kernel import fused_resampled_rx, fused_resampled_tx
from ..resampled import ResampledChain
from ..utils.bits import pack_bits, unpack_symbols
from .collectives import axis_index, left_halo, right_halo
from .mesh import shard_block


def _roundup(x: int, m: int) -> int:
    return -(-x // m) * m


class ShardedResampledChain:
    """Distribute a :class:`ResampledChain` over mesh dimensions
    ``("ch", "time")``: each rank holds its block of the global bits
    ``[C, K*bps]``. The TX emits this rank's block of the channel-rate
    waveform and a local drain tail (the stream's true drain on the last
    rank, the convention of :class:`~.chain.ShardedPulseChain`); the RX
    takes that pair."""

    def __init__(self, chain: ResampledChain, mesh: DeviceMesh):
        self.chain = chain
        self.mesh = mesh
        self.t_dev = mesh.size(mesh.mesh_dim_names.index("time"))
        self._time = mesh.get_group("time")
        c = chain
        self.sps, self.up, self.down = c.sps, c.up, c.down
        g = math.gcd(self.sps * self.up, self.down)
        #: the composite RX stage's period in symbols: blocks align to it
        self.period = self.down // g
        #: the symbol-count quantum: whole channel samples and RX periods
        q1 = self.down // math.gcd(self.sps, self.down)
        self.quantum = q1 * self.period // math.gcd(q1, self.period)
        # the TX's symbol lookback: stage-1 taps + RRC span, rounded so the
        # halo covers whole channel samples
        kp1 = -(-len(c.taps1) // self.up)
        e_l = -(-(kp1 - 1) // self.sps) + c.span
        self.e_l = _roundup(max(e_l, 1), self.quantum)
        # the RX halos in symbols: left the composite lookback, right the
        # decision delay
        kp2 = -(-len(c.taps2) // self.down)
        e_sl = -(-((kp2 - 1) * self.down) // (self.sps * self.up)) + 1
        self.e_sl = _roundup(max(e_sl, 1), self.quantum)
        e_sr = -(-(c.delay + 1) // self.sps) + 1
        self.e_sr = _roundup(e_sr, self.quantum)

    def _ch_rows(self, n_sym: int) -> int:
        return n_sym * self.sps * self.up // self.down

    def _check(self, k_local: int):
        if (k_local * self.sps) % self.down or k_local % self.period:
            raise ValueError(
                f"symbols per time block ({k_local}) must be a multiple of "
                f"{self.quantum} for up/down {self.up}/{self.down}")
        need = max(self.e_l, self.e_sl, self.e_sr)
        if k_local < need:
            raise ValueError(
                f"symbols per time block ({k_local}) fewer than the largest "
                f"halo ({need}): a halo rides one hop, so each block must "
                "hold at least one halo of symbols")

    # ---- the step of a rank ----

    def _local_tx(self, bits_l: torch.Tensor):
        """bits ``[Cl, Kl*bps]`` -> (wave rails ``[Cl, Kl*sps*up/down]``,
        drain rails): K11 on ``[left symbol halo | symbols]``."""
        c = self.chain
        syms = pack_bits(bits_l, c.bits_per_symbol)
        kl = syms.shape[-1]
        self._check(kl)
        halo = left_halo(syms, self.e_l, self._time)
        if axis_index(self._time) == 0:
            halo = torch.full_like(halo, -1)
        ext = torch.cat([halo, syms], dim=-1)
        # the local drain: the length the global one shot appends after its
        # last symbol (flush and delay margin, rounded to `down`)
        k_glob = kl * self.t_dev
        drain = c._padded_len(k_glob) - k_glob * self.sps
        n_modem = (self.e_l + kl) * self.sps + drain
        wi, wq = fused_resampled_tx(
            ext, c.lut, c._host["rrc"], self.sps, c.span, self.up,
            self.down, c._host["taps1"], n_modem)
        lo = self._ch_rows(self.e_l)
        hi = lo + self._ch_rows(kl)
        return ((wi[..., lo:hi], wq[..., lo:hi]),
                (wi[..., hi:], wq[..., hi:]))

    def _local_rx(self, waves, drains, n_sym_l: int):
        """This rank's channel-rate block and its halos -> its decisions
        (K12)."""
        c = self.chain
        self._check(n_sym_l)
        t = axis_index(self._time)
        h_l = self._ch_rows(self.e_sl)
        h_r = self._ch_rows(self.e_sr)
        window = []
        for w, d in zip(waves, drains):
            lh = left_halo(w, h_l, self._time)
            rh = right_halo(w, h_r, self._time)
            if t == self.t_dev - 1:
                rh = torch.nn.functional.pad(
                    d, (0, max(h_r - d.shape[-1], 0)))[..., :h_r]
            window.append(torch.cat([lh, w, rh], dim=-1))
        dec = fused_resampled_rx(
            tuple(window), self.e_sl + n_sym_l, c.lut, c._host["rrc"],
            self.sps, c.span, self.up, self.down, c._host["taps2"], c.delay)
        return unpack_symbols(dec[..., self.e_sl:], c.bits_per_symbol)

    # ---- public entry points ----

    def fused_tx_fn(self):
        """``f(bits_l) -> (wave, drain)`` rail tuples: K11 on every rank
        with a symbol halo."""
        return self._local_tx

    def fused_rx_fn(self):
        """``f(wave, drain) -> decided bits_l`` (K12); composes with
        :meth:`fused_tx_fn` to the single-device fused decisions."""
        def step(waves, drains):
            n_sym_l = waves[0].shape[-1] * self.down // (self.sps * self.up)
            return self._local_rx(waves, drains, n_sym_l)
        return step

    def fused_roundtrip_fn(self):
        """``f(bits_l) -> decided bits_l``: the TX and RX steps of a rank in
        one call (the waveform halos still cross ranks)."""
        def step(bits_l):
            waves, drains = self._local_tx(bits_l)
            n_sym_l = bits_l.shape[-1] // self.chain.bits_per_symbol
            return self._local_rx(waves, drains, n_sym_l)
        return step

    def shard_bits(self, bits: torch.Tensor) -> torch.Tensor:
        return shard_block(bits, self.mesh, ("ch", "time"))
