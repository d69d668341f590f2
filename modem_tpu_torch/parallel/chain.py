"""The 2-D sharded flagship chain: channels x time over a ``("ch", "time")``
mesh (counterpart of :mod:`modem_tpu.parallel.chain`).

BASELINE.md's scaling configuration (a bank of independent channels, each
channel's stream split along the time dimension) as one step a rank, whose
bits -> bits decisions are **exactly** those of the single-device
:class:`~modem_tpu_torch.chain.PulseShapedChain`:

* TX pulse shaping and the RX matched filter are globally causal FIRs
  stitched with left halos (overlap-save across ranks);
* symbol decisions at global index ``span*sps + m*sps`` may fall in the
  right neighbour's block, so each rank receives a ``span*sps``-sample
  *right* halo of the neighbour's filtered output;
* the last rank has no right neighbour: it filters a local
  ``span*sps``-zero extension, which is the single-device chain's flush
  tail.

The fused forms run one kernel a rank (K1 the loopback, K2 the TX, K3 the
RX) on the rank's symbols with symbol halos, the ``-1`` sentinel (zero
I/Q) past the stream's ends and the stream-global ``sym_offset``. Every
rank calls every collective, the edge ranks included, and chooses
afterwards. The staged noisy paths draw from a ``torch.Generator`` seeded
per rank (the JAX package folds the rank into a ``jax.random`` key); the
fused noisy paths draw K1's counter-based stream keyed per rank, as the
JAX kernels do.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from ..chain import DifferentialChain, PulseShapedChain, upsample_zero_stuff
from ..ops.chain_kernel import fused_pulse_chain
from ..ops.fir import fir_filter
from ..ops.nco import carrier_phase
from ..ops.slicer import lut_map, lut_slice
from ..ops.txrx import fused_rx, fused_tx
from ..utils.bits import pack_bits, unpack_symbols
from ..utils.scan import cummod
from .collectives import (axis_index, exclusive_prefix, left_halo, psum,
                          right_halo)
from .mesh import shard_block

#: the per-rank seed's multipliers of the time and channel coordinates
SEED_T, SEED_CH = 104729, 15485863


def device_seed(seed: int, t: int, c: int = 0) -> int:
    """``seed + t*104729 + c*15485863`` wrapped to int32, as the JAX
    package computes the per-device seed in int32 arithmetic."""
    v = (int(seed) + t * SEED_T + c * SEED_CH) & 0xFFFFFFFF
    return v - (1 << 32) if v >= 1 << 31 else v


def _count(out: torch.Tensor, bits: torch.Tensor, time_group, ch_group):
    """Global ``(errors, total)`` int64, summed over time then channels."""
    err = torch.sum(out != bits).to(torch.int64)
    tot = torch.tensor(bits.numel(), dtype=torch.int64, device=bits.device)
    err = psum(psum(err, time_group), ch_group)
    tot = psum(psum(tot, time_group), ch_group)
    return err, tot


class ShardedPulseChain:
    """Distribute a :class:`PulseShapedChain` over ``mesh`` dimensions
    ``("ch", "time")``: each rank holds its block ``[C/ch, K*bps/time]`` of
    the global bits ``[C, K*bps]`` (:meth:`shard_bits`). Baseband and
    passband (``carrier_hz``), staged and fused; the carrier's phase on a
    rank is closed-form in its coordinate (no collective)."""

    def __init__(self, chain: PulseShapedChain, mesh: DeviceMesh):
        self.chain = chain
        self.mesh = mesh
        self.t_dev = mesh.size(mesh.mesh_dim_names.index("time"))
        self._time = mesh.get_group("time")
        self._ch = mesh.get_group("ch")

    def _t(self) -> int:
        return axis_index(self._time)

    def _is_last(self) -> bool:
        return self._t() == self.t_dev - 1

    def _seed(self, seed) -> int:
        return device_seed(0 if seed is None else seed, self._t(),
                           axis_index(self._ch))

    def _shard_thetas(self, n: int, ext_len: int, device):
        """Carrier phases of this rank's samples and of its extension:
        rank t starts at global sample t*n."""
        sr, hz = self.chain.rates.sample_rate, self.chain.carrier_hz
        s0 = (self._t() * (n % sr)) % sr
        th = carrier_phase(hz, sr, n, s0, device=device)
        th_e = carrier_phase(hz, sr, ext_len, (s0 + n % sr) % sr,
                             device=device)
        return th, th_e

    # ---- the staged step of a rank ----

    def _local_tx(self, bits_l: torch.Tensor):
        """bits ``[Cl, Kl*bps]`` -> ``(wave, ext)`` rails ``[Cl, n]`` and
        ``[Cl, d]``: ``ext`` the locally filtered zero extension (the flush
        tail on the last rank)."""
        ch = self.chain
        sps, d = ch.sps, ch.span * ch.sps
        mi, mq = lut_map(pack_bits(bits_l, ch.bits_per_symbol), ch.lut)
        ui = upsample_zero_stuff(mi, sps)
        uq = upsample_zero_stuff(mq, sps)
        n = ui.shape[-1]
        k = ch.rrc.shape[0]
        # the halo over the zero-stuffed stream: its last k-1 samples
        hi = left_halo(ui, k - 1, self._time)
        hq = left_halo(uq, k - 1, self._time)
        z = ui.new_zeros(ui.shape[:-1] + (d,))
        si, _ = fir_filter(torch.cat([ui, z], dim=-1), ch.rrc, hi,
                           ch.fir_backend)
        sq, _ = fir_filter(torch.cat([uq, z], dim=-1), ch.rrc, hq,
                           ch.fir_backend)
        return (si[..., :n], sq[..., :n]), (si[..., n:], sq[..., n:])

    def _local_rx(self, wave, ext, n_sym_local: int):
        """Matched filter, decimation and slice, the right halo stitched
        from the neighbour's filtered output (the last rank: its local flush
        extension)."""
        ch = self.chain
        d = ch.span * ch.sps
        (xi, xq), (ei, eq) = wave, ext
        k = ch.rrc.shape[0]
        hi = left_halo(xi, k - 1, self._time)
        hq = left_halo(xq, k - 1, self._time)
        yi, _ = fir_filter(torch.cat([xi, ei], dim=-1), ch.rrc, hi,
                           ch.fir_backend)
        yq, _ = fir_filter(torch.cat([xq, eq], dim=-1), ch.rrc, hq,
                           ch.fir_backend)
        n = xi.shape[-1]
        ri = right_halo(yi[..., :n], d, self._time)
        rq = right_halo(yq[..., :n], d, self._time)
        if self._is_last():
            ri, rq = yi[..., n:], yq[..., n:]
        zi = torch.cat([yi[..., :n], ri], dim=-1)
        zq = torch.cat([yq[..., :n], rq], dim=-1)
        idx = d + torch.arange(n_sym_local, device=zi.device) * ch.sps
        syms = lut_slice(zi[..., idx], zq[..., idx], ch.lut)
        return unpack_symbols(syms, ch.bits_per_symbol)

    def _es(self) -> float:
        lut = self.chain.lut.detach().cpu().numpy()
        return float(np.mean(np.sum(lut ** 2, -1)))

    def _local_roundtrip(self, bits_l, seed, snr_db):
        ch = self.chain
        wave, ext = self._local_tx(bits_l)
        n_sym_l = bits_l.shape[-1] // ch.bits_per_symbol
        gen = None
        if snr_db is not None:
            gen = torch.Generator(device=bits_l.device)
            gen.manual_seed(self._seed(seed) & 0xFFFFFFFF)
        if ch.carrier_hz is not None:
            # passband leg: up-mix to a real waveform (`modulate.rs:128-133`),
            # optional real AWGN, coherent product detection with 2x gain
            # (`demodulator.rs:52-55`), the carrier closed-form per rank
            n, d = wave[0].shape[-1], ext[0].shape[-1]
            th, th_e = self._shard_thetas(n, d, bits_l.device)
            x = wave[0] * torch.cos(th) - wave[1] * torch.sin(th)
            xe = ext[0] * torch.cos(th_e) - ext[1] * torch.sin(th_e)
            if gen is not None:
                # the rail noise after the 2x detector is 2*sigma_pass^2
                sig = float(np.float32(np.sqrt(
                    self._es() / (10.0 ** (snr_db / 10.0)) / 4.0)))
                x = x + sig * torch.randn(x.shape, generator=gen,
                                          device=x.device)
                xe = xe + sig * torch.randn(xe.shape, generator=gen,
                                            device=xe.device)
            wave = (2.0 * x * torch.cos(th), -2.0 * x * torch.sin(th))
            ext = (2.0 * xe * torch.cos(th_e), -2.0 * xe * torch.sin(th_e))
            return self._local_rx(wave, ext, n_sym_l)
        if gen is not None:
            # snr_db is Es/N0 at the decision point; the RRC is unit-energy,
            # so the per-rail waveform noise is N0/2
            sig = float(np.float32(np.sqrt(
                self._es() / (10.0 ** (snr_db / 10.0)) / 2.0)))
            wave, ext = (tuple(w + sig * torch.randn(w.shape, generator=gen,
                                                     device=w.device)
                               for w in rails) for rails in (wave, ext))
        return self._local_rx(wave, ext, n_sym_l)

    # ---- public entry points ----

    def roundtrip_fn(self, snr_db: float | None = None):
        """``f(bits_l, seed=0) -> decided bits_l`` through the staged chain
        (the chain's ``fir_backend``; ``"direct"`` is kernel K4 on the
        card). Noiseless decisions are exactly the
        single-device chain's; with ``snr_db`` each rank draws its noise
        from a generator seeded by ``seed`` and its coordinates."""
        def step(bits, seed=0):
            return self._local_roundtrip(bits, seed, snr_db)
        return step

    def ber_fn(self, snr_db: float | None = None):
        """``f(bits_l, seed=0) -> (errors, total)``: the staged TX ->
        channel -> RX -> count step, summed over the whole mesh (int64, on
        every rank)."""
        def step(bits, seed=0):
            out = self._local_roundtrip(bits, seed, snr_db)
            return _count(out, bits, self._time, self._ch)
        return step

    def shard_bits(self, bits: torch.Tensor) -> torch.Tensor:
        """This rank's block of the global bits ``[C, K*bps]``."""
        return shard_block(bits, self.mesh, ("ch", "time"))

    # ---- the fused path: one kernel a rank ----

    def _local_fused(self, bits_l, seed, snr_db):
        """K1 on ``[left halo | symbols | right halo]``: ``span`` symbols of
        left context and ``span+1`` of right, ``-1`` past the stream; the
        halo decisions are recomputed locally and trimmed."""
        ch = self.chain
        span, bps = ch.span, ch.bits_per_symbol
        syms = pack_bits(bits_l, bps)
        t = self._t()
        left = left_halo(syms, span, self._time)
        right = right_halo(syms, span + 1, self._time)
        if t == 0:
            left = torch.full_like(left, -1)
        if t == self.t_dev - 1:
            right = torch.full_like(right, -1)
        ext = torch.cat([left, syms, right], dim=-1)
        seed_l = None if snr_db is None else self._seed(seed)
        dec = fused_pulse_chain(ext, ch.lut, ch.rrc, ch.sps, span,
                                snr_db=snr_db, seed=seed_l, **ch._carrier(),
                                sym_offset=t * syms.shape[-1] - span)
        return unpack_symbols(dec[..., span: span + syms.shape[-1]], bps)

    def fused_roundtrip_fn(self, snr_db: float | None = None):
        """``f(bits_l, seed=0) -> decided bits_l``: kernel K1 on every rank,
        stitched with symbol halos."""
        def step(bits, seed=0):
            return self._local_fused(bits, seed, snr_db)
        return step

    def _local_tx_fused(self, bits_l):
        """K2 on ``[left halo | symbols]``. Returns ``(wave, ext)`` tuples
        of rails (one rail at passband): ``wave`` this rank's ``Kl*sps``
        samples, ``ext`` its local zero-flush tail (the stream's flush on
        the last rank)."""
        ch = self.chain
        span, sps = ch.span, ch.sps
        syms = pack_bits(bits_l, ch.bits_per_symbol)
        kl = syms.shape[-1]
        t = self._t()
        left = left_halo(syms, span, self._time)
        if t == 0:
            left = torch.full_like(left, -1)
        wave = fused_tx(torch.cat([left, syms], dim=-1), rrc_taps=ch.rrc,
                        sps=sps, span=span, sym_offset=t * kl - span,
                        **ch._txrx_params(), **ch._carrier())
        waves = (wave,) if ch.carrier_hz is not None else wave
        d, n = span * sps, kl * sps
        return (tuple(w[..., d: d + n] for w in waves),
                tuple(w[..., d + n:] for w in waves))

    def _local_rx_fused(self, waves, exts, n_sym_l: int):
        """K3 on this rank's samples and a right halo (the last rank: its
        flush ``ext``)."""
        ch = self.chain
        d = ch.span * ch.sps
        t = self._t()
        z = []
        for w, e in zip(waves, exts):
            r = right_halo(w, d, self._time)
            z.append(torch.cat([w, e if self._is_last() else r], dim=-1))
        wave = z[0] if ch.carrier_hz is not None else tuple(z)
        dec = fused_rx(wave, n_sym_l, rrc_taps=ch.rrc, sps=ch.sps,
                       span=ch.span, sym_offset=t * n_sym_l,
                       **ch._txrx_params(), **ch._carrier())
        return unpack_symbols(dec, ch.bits_per_symbol)

    def fused_tx_fn(self):
        """``f(bits_l) -> (wave, ext)``: kernel K2 on every rank; ``wave``
        this rank's block of the stream waveform, ``ext`` its flush tail
        (see :meth:`_local_tx_fused`)."""
        return self._local_tx_fused

    def fused_rx_fn(self):
        """``f(wave, ext) -> decided bits_l`` through kernel K3; composes
        with :meth:`fused_tx_fn` to the single-device decisions."""
        def step(waves, exts):
            return self._local_rx_fused(waves, exts,
                                        waves[0].shape[-1] // self.chain.sps)
        return step

    def fused_ber_fn(self, snr_db: float):
        """``f(bits_l, seed) -> (errors, total)`` through K1 with in-kernel
        AWGN, summed over the whole mesh."""
        def step(bits, seed=0):
            out = self._local_fused(bits, seed, snr_db)
            return _count(out, bits, self._time, self._ch)
        return step


class ShardedDifferentialChain:
    """Time- and channel-sharded fused DMPSK (`dmpsk.rs` as a distributed
    program): the phase accumulator's modular prefix is a local
    :func:`cummod` plus one :func:`exclusive_prefix` of the ranks' totals;
    each rank runs kernel K1 on its accumulated symbols with symbol halos,
    and the differential decode stitches across the seam with one more
    halo of the last decision. Noiseless decisions equal
    :meth:`DifferentialChain.roundtrip_fused`."""

    def __init__(self, chain, mesh: DeviceMesh):
        if not isinstance(chain, DifferentialChain):
            raise TypeError("needs a DifferentialChain")
        self.chain = chain
        self.mesh = mesh
        self.t_dev = mesh.size(mesh.mesh_dim_names.index("time"))
        self._time = mesh.get_group("time")
        self.m_ph, self.lut = chain._acc_constellation()

    def _local(self, bits_l: torch.Tensor) -> torch.Tensor:
        ch = self.chain
        bps, span = ch.scheme.bits_per_symbol, ch.span
        syms = pack_bits(bits_l, bps)
        acc_l = cummod(syms.to(torch.int32), self.m_ph)
        off = exclusive_prefix(acc_l[..., -1], self._time) % self.m_ph
        acc = (acc_l + off[..., None]) % self.m_ph
        t = axis_index(self._time)
        left = left_halo(acc, span, self._time)
        right = right_halo(acc, span + 1, self._time)
        if t == 0:
            left = torch.full_like(left, -1)
        if t == self.t_dev - 1:
            right = torch.full_like(right, -1)
        ext = torch.cat([left, acc, right], dim=-1)
        dec_abs = fused_pulse_chain(ext, self.lut, ch.rrc, ch.sps, span)
        dec_abs = dec_abs[..., span: span + acc.shape[-1]]
        # the previous absolute decision of this rank's first symbol is the
        # left neighbour's last (coordinate 0: 0, the TX initial phase)
        prev_last = left_halo(dec_abs, 1, self._time)
        prev = torch.cat([prev_last, dec_abs[..., :-1]], dim=-1)
        return unpack_symbols((dec_abs - prev) % self.m_ph, bps)

    def fused_roundtrip_fn(self):
        """``f(bits_l) -> decided bits_l``, sharded over the mesh."""
        return self._local

    def shard_bits(self, bits: torch.Tensor) -> torch.Tensor:
        return shard_block(bits, self.mesh, ("ch", "time"))

