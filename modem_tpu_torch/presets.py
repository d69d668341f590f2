"""Production presets: one-call constructors for standard-shaped link
configurations (counterpart of :mod:`modem_tpu.presets`).

A preset fixes the composition and the size coupling a deployment would
otherwise re-derive. They are standard-shaped, not standard-conformant:
DVB-style RS + interleaver + scrambler, CCSDS-style concatenated coding,
GSM's GMSK at BT 0.3, Gray 16-QAM, an LTE-shaped turbo data link and an
NR-shaped polar control link. Each takes ``device``, the card unless the
caller asks for the CPU. Not ported yet: the OFDM and MIMO presets
(ROADMAP.md lists each with the slice it waits for).
"""

from __future__ import annotations

import torch

from .chain import PulseShapedChain, qpsk_reference_chain
from .config import Rates
from .fec import (Puncturer, RateMatchedPolar, TurboCode, ccsds_code,
                  rate34_pattern, rs_255_223, rs_dvb)
from .gmsk import GmskChain
from .link import FramedLink
from .models.qam import QAM

#: The reference binaries' operating point (`modulate.rs` / `demodulate.rs`
#: defaults): 10 kHz sample rate, 1250 baud.
REFERENCE_RATES = Rates(baud_rate=1250, sample_rate=10000)

Device = torch.device | str | None


def reference_link(payload_bits: int = 1002,
                   device: Device = None) -> FramedLink:
    """The flagship chain (QPSK + RRC matched filter) in the production
    framing stack (CRC-16 + scrambler + conv K=7 + interleaver): 1024 QPSK
    symbols a frame, error-free from about -4 dB SNR per complex sample."""
    return FramedLink(qpsk_reference_chain(REFERENCE_RATES, device=device),
                      payload_bits=payload_bits)


def dvb_like_link(rate34: bool = True, device: Device = None) -> FramedLink:
    """DVB-shaped concatenated link over the QPSK chain: RS(204,188)
    shortened outer code, conv K=7 inner code (punctured to 3/4 by
    default), DVB scrambler, block interleaver. Payload 1504 bits (188
    bytes) minus the CRC."""
    return FramedLink(
        qpsk_reference_chain(REFERENCE_RATES, device=device),
        rs=rs_dvb(),
        puncturer=Puncturer(rate34_pattern()) if rate34 else None,
        interleave_rows=12,
    )


def ccsds_deep_space_link(device: Device = None) -> FramedLink:
    """CCSDS-shaped deep-space concatenated coding: RS(255,223) outer, conv
    K=7 rate-1/2 inner, interleaved. Error-free from about 0 dB SNR per
    complex sample over the QPSK chain."""
    return FramedLink(
        qpsk_reference_chain(REFERENCE_RATES, device=device),
        rs=rs_255_223(),
        conv=ccsds_code(),
        interleave_rows=12,  # wire = (255*8 + 6 flush) * 2 = 4092 bits
    )


def lte_like_turbo_link(turbo_iters: int = 6,
                        device: Device = None) -> FramedLink:
    """LTE-shaped data link over the QPSK chain: K=1024 turbo inner code
    (RSC pair + QPP interleaver, max-log BCJR), CRC-16 verdicts, block
    interleaver. Payload 1008 bits per frame; wire = 3084 coded bits =
    1542 QPSK symbols. Error-free from about -6 dB SNR per complex
    sample."""
    code = TurboCode(1024)
    return FramedLink(qpsk_reference_chain(REFERENCE_RATES, device=device),
                      payload_bits=code.k - 16, turbo=code,
                      turbo_iters=turbo_iters,
                      interleave_rows=12)  # 3084 = 12 * 257


def nr_like_control_link(list_size: int = 8,
                         device: Device = None) -> FramedLink:
    """NR-control-shaped link over the QPSK chain: rate-matched polar inner
    code (N=256 mother shortened to E=180, rate 0.56) with per-codeword
    metric-best SCL, frame CRC-16 verdicts. Payload 384 bits per frame;
    wire = 720 coded bits = 360 QPSK symbols. Error-free from about 1 dB
    SNR per complex sample."""
    code = RateMatchedPolar(100, 180, n=256)
    return FramedLink(qpsk_reference_chain(REFERENCE_RATES, device=device),
                      payload_bits=4 * code.k - 16, polar=code,
                      polar_list=list_size)


def gsm_like_gmsk(rates: Rates | None = None,
                  device: Device = None) -> GmskChain:
    """GSM's modulation: GMSK at BT = 0.3."""
    return GmskChain(rates or REFERENCE_RATES, bt=0.3, device=device)


def qam16_gray_chain(rates: Rates | None = None,
                     device: Device = None) -> PulseShapedChain:
    """Gray-mapped 16-QAM over the RRC matched-filter chain: the
    bandwidth-efficient single-carrier point (4 bits a symbol; Gray takes
    the table path of K1-K3, the algebraic map being natural binary)."""
    return PulseShapedChain(QAM(4, 0.0, 6.0, gray=True),
                            rates or REFERENCE_RATES, device=device)
