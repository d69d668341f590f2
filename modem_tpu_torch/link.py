"""The framed production link: payload bits to waveform and back
(counterpart of :mod:`modem_tpu.link`).

    payload → CRC append → scramble → [RS outer encode] → inner encode
            (conv [+ puncture], turbo or polar) → block interleave
            → chain TX

and the exact inverse from soft LLRs, ending in a per-frame CRC verdict.
Every size coupling (CRC width, RS block, conv flush bits, puncture period,
turbo or polar data size, interleaver rows, bits per symbol) is solved and
checked at construction.

The fused route (:meth:`FramedLink.tx_fused`, :meth:`FramedLink.rx_fused`)
runs the chain's fused kernels (K2, K3 soft) for CUDA tensors and the
staged ``tx`` / ``rx_soft`` for CPU ones, as the JAX package does off the
TPU, and for a chain without the fused forms (the OFDM adapter) on either
device. The inner code is the convolutional code (its windowed decode on
kernel K13 on the card), a QC-LDPC code (layered min-sum in PyTorch ops), a
turbo code (each BCJR half-iteration on K14) or a polar code, plain or
rate-matched (SC on K15, CA-SCL-8 on K16).
"""

from __future__ import annotations

import torch

from .fec import (ConvCode, Crc, PolarCode, Puncturer, QcLdpc, ReedSolomon,
                  Scrambler, TurboCode, block_deinterleave, block_interleave,
                  ccsds_code, crc16_ccitt, dvb_scrambler)


class FramedLink:
    """A coded, scrambled, integrity-checked link over a bits→bits chain
    (a ``PulseShapedChain``-family object with ``tx`` / ``rx_soft`` and
    their fused forms).

    ``payload_bits`` is required without an RS outer code; with one it is
    implied (``rs.k*8 - crc.w``). ``interleave_rows=0`` disables
    interleaving; ``rs=None`` / ``puncturer=None`` drop those stages.
    ``ldpc`` selects a QC-LDPC inner code (:class:`QcLdpc`, ``coded_in %
    ldpc.k == 0``), decoded layered with ``ldpc_iters`` iterations,
    ``ldpc_early_exit`` and the messages stored as ``ldpc_msg_dtype`` (a
    torch dtype, float32 if None). ``polar`` selects a polar inner code
    (:class:`PolarCode`, or a
    :class:`~modem_tpu_torch.fec.RateMatchedPolar` whose E bits go on the
    wire; ``coded_in % polar.k == 0``), decoded by SC, or by metric-best
    SCL with ``polar_list`` paths (the frame CRC stays the outer verdict);
    ``turbo`` an LTE-shaped turbo inner code (``coded_in % turbo.k ==
    0``), decoded with ``turbo_iters`` iterations (the code's own by
    default) and ``turbo_early_exit``. ``conv_window="auto"`` decodes the
    conv code in windows of 512 steps once the trellis has 1024 steps or
    more, else the full block; an int forces windows of that many steps,
    None the full block.
    """

    def __init__(self, chain, payload_bits: int | None = None,
                 conv: ConvCode | None = None,
                 rs: ReedSolomon | None = None,
                 puncturer: Puncturer | None = None,
                 interleave_rows: int = 8,
                 scrambler: Scrambler | None = None,
                 crc: Crc | None = None,
                 ldpc: QcLdpc | None = None,
                 ldpc_iters: int = 30,
                 ldpc_early_exit: bool = True,
                 ldpc_msg_dtype=None,
                 polar: PolarCode | None = None,
                 polar_list: int | None = None,
                 turbo: TurboCode | None = None,
                 turbo_iters: int | None = None,
                 turbo_early_exit: bool = True,
                 conv_window: int | None | str = "auto"):
        n_inner = sum(x is not None for x in (conv, ldpc, polar, turbo))
        if n_inner > 1:
            raise ValueError(
                "choose one inner code: conv, ldpc, polar, or turbo")
        if puncturer is not None and (ldpc is not None
                                      or polar is not None
                                      or turbo is not None):
            raise ValueError("puncturing applies to the conv inner code")
        self.chain = chain
        self.ldpc = ldpc
        self.ldpc_iters = int(ldpc_iters)
        self.ldpc_early_exit = bool(ldpc_early_exit)
        self.ldpc_msg_dtype = ldpc_msg_dtype
        self.polar = polar
        self.polar_list = None if polar_list is None else int(polar_list)
        if self.polar_list is not None and polar is None:
            raise ValueError("polar_list needs a polar inner code")
        self.turbo = turbo
        self.turbo_iters = turbo_iters
        self.turbo_early_exit = bool(turbo_early_exit)
        self.conv = (None if (ldpc is not None or polar is not None
                              or turbo is not None)
                     else (ccsds_code() if conv is None else conv))
        self.rs = rs
        self.puncturer = puncturer
        self.rows = int(interleave_rows)
        self.scrambler = dvb_scrambler() if scrambler is None else scrambler
        self.crc = crc16_ccitt() if crc is None else crc

        if rs is not None:
            implied = rs.k * 8 - self.crc.w
            if payload_bits is not None and payload_bits != implied:
                raise ValueError(
                    f"payload_bits={payload_bits} conflicts with the RS "
                    f"block: rs.k*8 - crc.w = {implied}")
            payload_bits = implied
        if payload_bits is None:
            raise ValueError("payload_bits is required without an RS code")
        self.payload_bits = int(payload_bits)

        framed = self.payload_bits + self.crc.w
        coded_in = rs.n * 8 if rs is not None else framed
        if ldpc is not None:
            if coded_in % ldpc.k:
                raise ValueError(
                    f"framed block of {coded_in} bits must divide by the "
                    f"LDPC data size {ldpc.k}; adjust payload_bits")
            self._steps = coded_in // ldpc.k  # LDPC codewords per frame
            wire = self._steps * ldpc.n
        elif polar is not None:
            if coded_in % polar.k:
                raise ValueError(
                    f"framed block of {coded_in} bits must divide by the "
                    f"polar data size {polar.k}; adjust payload_bits")
            self._steps = coded_in // polar.k  # polar codewords per frame
            # a RateMatchedPolar puts E (not N) bits on the wire
            self._polar_wire = getattr(polar, "e", polar.n)
            wire = self._steps * self._polar_wire
        elif turbo is not None:
            if coded_in % turbo.k:
                raise ValueError(
                    f"framed block of {coded_in} bits must divide by the "
                    f"turbo data size {turbo.k}; adjust payload_bits")
            self._steps = coded_in // turbo.k  # turbo codewords per frame
            wire = self._steps * turbo.n
        else:
            steps = coded_in + (self.conv.k - 1)
            if puncturer is not None and steps % puncturer.period:
                raise ValueError(
                    f"conv trellis length {steps} (= frame {coded_in} + "
                    f"{self.conv.k - 1} flush) must divide by the puncture "
                    f"period {puncturer.period}; adjust payload or pattern")
            self._steps = steps
            wire = (puncturer.out_bits(steps) if puncturer is not None
                    else steps * self.conv.n)
        if self.rows and wire % self.rows:
            raise ValueError(
                f"wire length {wire} must divide by interleave_rows="
                f"{self.rows}")
        bps = chain.scheme.bits_per_symbol
        if wire % bps:
            raise ValueError(
                f"wire length {wire} must divide by bits/symbol {bps}")
        self.wire_bits = wire
        self.n_symbols = wire // bps
        if conv_window == "auto":
            # windowed truncated-traceback decode once the trellis is long
            # enough for the window to pay, as the JAX package does
            self.conv_window = (512 if self.conv is not None
                                and self._steps >= 1024 else None)
        else:
            self.conv_window = (None if conv_window is None
                                else int(conv_window))

    # ---- TX ----

    def frame(self, payload: torch.Tensor) -> torch.Tensor:
        """``[..., payload_bits]`` -> wire bits ``[..., wire_bits]``."""
        if payload.shape[-1] != self.payload_bits:
            raise ValueError(
                f"expected {self.payload_bits} payload bits, got "
                f"{payload.shape[-1]}")
        x = self.crc.append(payload)
        x, _ = self.scrambler.scramble(
            x, self.scrambler.init_state(x.shape[:-1], x.device))
        if self.rs is not None:
            x = self.rs.encode_bits(x)
        if (self.ldpc is not None or self.polar is not None
                or self.turbo is not None):
            code = (self.ldpc if self.ldpc is not None else
                    self.polar if self.polar is not None else self.turbo)
            wire = (self._polar_wire if self.polar is not None else code.n)
            x = code.encode(x.reshape(x.shape[:-1] + (self._steps, code.k)))
            x = x.reshape(x.shape[:-2] + (self._steps * wire,))
        else:
            x = self.conv.encode(x)
            if self.puncturer is not None:
                x = self.puncturer.puncture(x)
        if self.rows:
            x = block_interleave(x, self.rows)
        return x

    def tx(self, payload: torch.Tensor):
        """Payload bits -> baseband waveform through the staged chain."""
        return self.chain.tx(self.frame(payload))

    def _fused_ok(self, wave: torch.Tensor) -> bool:
        """The fused forms for a tensor on the card, when the chain has
        both of them (``tx_fused`` and ``rx_soft_fused``); the staged forms
        otherwise."""
        return (wave.is_cuda and hasattr(self.chain, "tx_fused")
                and hasattr(self.chain, "rx_soft_fused"))

    def tx_fused(self, payload: torch.Tensor):
        """Like :meth:`tx`, through the chain's fused TX (K2) for a CUDA
        payload; a CPU payload, or a chain without fused forms, takes
        :meth:`tx`."""
        if self._fused_ok(payload):
            return self.chain.tx_fused(self.frame(payload))
        return self.tx(payload)

    # ---- RX ----

    def decode(self, llrs: torch.Tensor):
        """Wire LLRs ``[..., wire_bits]`` (positive = bit 0) ->
        ``(payload [..., payload_bits], ok [...])``."""
        x = llrs
        if self.rows:
            x = block_deinterleave(x, self.rows)
        m = self._steps
        if self.ldpc is not None:
            x = x.reshape(x.shape[:-1] + (m, self.ldpc.n))
            x = self.ldpc.decode(x, iters=self.ldpc_iters,
                                 early_exit=self.ldpc_early_exit,
                                 msg_dtype=self.ldpc_msg_dtype)
            x = x.reshape(x.shape[:-2] + (m * self.ldpc.k,))
        elif self.polar is not None:
            x = x.reshape(x.shape[:-1] + (m, self._polar_wire))
            x = (self.polar.decode(x) if self.polar_list is None
                 else self.polar.decode_list(x, self.polar_list))
            x = x.reshape(x.shape[:-2] + (m * self.polar.k,))
        elif self.turbo is not None:
            x = x.reshape(x.shape[:-1] + (m, self.turbo.n))
            x = self.turbo.decode(x, iters=self.turbo_iters,
                                  early_exit=self.turbo_early_exit)
            x = x.reshape(x.shape[:-2] + (m * self.turbo.k,))
        else:
            if self.puncturer is not None:
                x = self.puncturer.depuncture(x, self._steps)
            if self.conv_window:
                x = self.conv.decode_soft_windowed(x, self.conv_window)
            else:
                x = self.conv.decode_soft(x)
        ok = None
        if self.rs is not None:
            x, ok = self.rs.decode_bits(x)
        x, _ = self.scrambler.descramble(
            x, self.scrambler.init_state(x.shape[:-1], x.device))
        payload = x[..., : self.payload_bits]
        crc_ok = self.crc.check(x)
        if ok is not None:
            crc_ok = crc_ok & ok
        return payload, crc_ok

    def rx(self, iq, noise_var: float):
        """Received waveform -> ``(payload, ok)`` via the chain's soft RX."""
        llrs = self.chain.rx_soft(iq, self.n_symbols, noise_var=noise_var)
        return self.decode(llrs)

    def rx_fused(self, iq, noise_var: float):
        """Like :meth:`rx`, through the chain's fused matched filter (K3
        soft) for a waveform on the card (``(i, q)`` at baseband, one real
        tensor at passband); a CPU waveform, or a chain without fused forms,
        takes :meth:`rx`."""
        first = iq if torch.is_tensor(iq) else iq[0]
        if self._fused_ok(first):
            llrs = self.chain.rx_soft_fused(iq, self.n_symbols,
                                            noise_var=noise_var)
            return self.decode(llrs)
        return self.rx(iq, noise_var)
