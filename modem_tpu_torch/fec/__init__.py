"""Forward error correction: the layer downstream of the soft-output RX
(counterpart of :mod:`modem_tpu.fec`).

Ported so far: the framing stack (CRC, scrambler, block interleaver,
puncturer), Reed–Solomon over GF(256), and the convolutional code with its
Viterbi decoders (the windowed one on kernel K13). ``Bch``, ``QcLdpc``,
``PolarCode``, ``RateMatchedPolar`` and ``TurboCode`` wait for their slices
(ROADMAP.md queue 1, S5).
"""

from .conv import ConvCode, StreamingViterbi, ccsds_code
from .crc import Crc, crc16_ccitt, crc32_mpeg2
from .interleave import block_deinterleave, block_interleave
from .puncture import Puncturer, rate23_pattern, rate34_pattern
from .rs import ReedSolomon, rs_255_223, rs_dvb
from .scramble import Scrambler, dvb_scrambler, ieee80211_scrambler

__all__ = [
    "ConvCode", "Crc", "Puncturer", "ReedSolomon", "Scrambler",
    "StreamingViterbi", "block_deinterleave", "block_interleave",
    "ccsds_code", "crc16_ccitt", "crc32_mpeg2", "dvb_scrambler",
    "ieee80211_scrambler", "rate23_pattern", "rate34_pattern", "rs_255_223",
    "rs_dvb",
]
