"""Forward error correction: the layer downstream of the soft-output RX
(counterpart of :mod:`modem_tpu.fec`).

Ported so far: the framing stack (CRC, scrambler, block interleaver,
puncturer), Reed–Solomon over GF(256), the convolutional code with its
Viterbi decoders (the windowed one on kernel K13), the QC-LDPC code
(layered and flooding min-sum in PyTorch ops), the LTE-shaped turbo code
(its max-log BCJR on kernel K14), the polar codes with rate matching (SC
on kernel K15, CA-SCL-8 on K16) and the binary BCH codes (PyTorch ops,
GF(256) by table).
"""

from .bch import Bch, bch_255_191, bch_255_239
from .conv import ConvCode, StreamingViterbi, ccsds_code
from .crc import Crc, crc16_ccitt, crc32_mpeg2
from .interleave import block_deinterleave, block_interleave
from .ldpc import QcLdpc
from .polar import PolarCode, RateMatchedPolar
from .puncture import Puncturer, rate23_pattern, rate34_pattern
from .rs import ReedSolomon, rs_255_223, rs_dvb
from .scramble import Scrambler, dvb_scrambler, ieee80211_scrambler
from .turbo import TurboCode

__all__ = [
    "Bch", "ConvCode", "Crc", "PolarCode", "Puncturer", "QcLdpc",
    "RateMatchedPolar",
    "ReedSolomon", "Scrambler", "StreamingViterbi", "TurboCode",
    "bch_255_191", "bch_255_239", "block_deinterleave", "block_interleave",
    "ccsds_code", "crc16_ccitt", "crc32_mpeg2", "dvb_scrambler",
    "ieee80211_scrambler", "rate23_pattern", "rate34_pattern", "rs_255_223",
    "rs_dvb",
]
