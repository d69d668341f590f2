"""modem_tpu_torch: the modem signal chain in PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper (``sm_90a``).

A port of the JAX package ``modem_tpu``, which stays the reference: each
module here has the same path as its counterpart there, keeps its layouts
and dtypes, and is tested against it on shared inputs. This package never
imports ``jax`` or ``modem_tpu``. Ported so far:

* the flagship QPSK chain (:class:`~modem_tpu_torch.chain.PulseShapedChain`)
  staged and fused, with its streaming classes (kernels K1-K3), in every
  mode of the JAX kernels: baseband and passband (``carrier_hz``), in-kernel
  AWGN, table and algebraic square QAM (256-QAM and up), f32, bf16 and
  int16 waveforms;
* the BER harness (:mod:`~modem_tpu_torch.harness`: closed forms,
  ``fused_ber_point`` on K1's noise, ``release_gates``), the link metrics
  (:class:`LinkStats`) and checkpoints of a stream's carry
  (:mod:`~modem_tpu_torch.checkpoint`);
* the reference's own path: all 15 schemes of the CLI table
  (:func:`make_scheme`), the :class:`Modulator` and the :class:`Demodulator`
  (FIRs on kernel K4, the fused product detector on kernel K5), and the
  ``modulate``/``demodulate`` CLIs (:mod:`modem_tpu_torch.cli`);
* the other scheme families' chains: :class:`FskChain` (BFSK, MFSK, CPFSK;
  the loopback on kernel K6, the one-way halves on K8 and K9) and
  :class:`MskChain` (K10 and K9, the loopback on K7) of config #3,
  :class:`GmskChain` (its transient FIR on K4), :class:`DifferentialChain`
  (DBPSK/DQPSK on K1-K3), :class:`OqpskChain` and :class:`DcqpskChain`;
* config #4, QAM with a rational resampler in the chain:
  :class:`ResampledChain` (the fused TX on kernel K11, the fused RX on K12)
  and :class:`StreamingResampledChain`;
* the coded link: :class:`FramedLink` (CRC, scrambler, Reed–Solomon,
  convolutional K=7 with its windowed Viterbi on kernel K13, puncturer,
  interleaver; :mod:`~modem_tpu_torch.fec`) over the flagship chain, the
  ``reference``, ``dvb_like`` and ``ccsds_deep_space`` presets
  (:mod:`~modem_tpu_torch.presets`) and the ``link`` CLI;
* the turbo and polar inner codes: :class:`~modem_tpu_torch.fec.TurboCode`
  (its max-log BCJR on kernel K14), :class:`~modem_tpu_torch.fec.PolarCode`
  and :class:`~modem_tpu_torch.fec.RateMatchedPolar` (SC on kernel K15,
  CA-SCL-8 on K16), in ``FramedLink`` and the ``lte_like_turbo`` and
  ``nr_like_control`` presets;
* the LDPC-coded OFDM link: :class:`QcLdpc` (min-sum in PyTorch ops),
  :class:`OfdmModem` (reduced-DFT matmuls, blind acquisition with its
  preamble correlation on kernel K4), :class:`OfdmChain`,
  :class:`OfdmStreamReceiver`, the ``wifi_like_ofdm`` preset and
  ``burst_ofdm_receiver``, and release gates 3 and 5;
* blind single-carrier burst acquisition: :class:`AcquiringReceiver`
  (:mod:`~modem_tpu_torch.sync`: timing, frame, CFO, phase and gain of a
  burst, with the optional LMMSE equalizer and decision-directed trackers;
  its matched filter on kernel K4), the channel impairments
  (:mod:`~modem_tpu_torch.ops.impairments`, their FIRs on K4), the AGC
  (:mod:`~modem_tpu_torch.ops.agc`) and the binary BCH codes
  (:class:`~modem_tpu_torch.fec.Bch`);
* the other block PHYs on the OFDM machinery: SC-FDE (:class:`ScFdeModem`,
  :class:`ScFdeChain`; its blind acquisition's preamble correlation on
  kernel K4), Alamouti STBC (:class:`AlamoutiOfdm`), 2x2 and N x N MIMO
  (:class:`MimoOfdm`, :class:`MimoOfdmN`, the ``mimo_ofdm_link`` preset)
  and adaptive bit loading (:func:`bit_loading`, :class:`AdaptiveOfdm`);
* the wideband front end: the polyphase :class:`Channelizer` (M channels
  <-> one wideband stream; its DFT ``torch.mm`` in fixed row tiles),
  direct-sequence spread spectrum (:class:`DsssChain`, its chip shaping and
  matched filter on kernel K4), frequency hopping behind the channelizer
  (:class:`FhssModem`), the single-device :class:`WidebandModem` (M burst
  modems behind one bank, on :class:`AcquiringReceiver`) and the timing
  helpers of :mod:`~modem_tpu_torch.profiling`.

Every entry point builds on the card unless the caller asks for the CPU
(``device="cpu"``); kernels are built at first use (:mod:`.cuda`).
"""

from . import presets
from .bitloading import AdaptiveOfdm, bit_loading
from .config import Freq, Rates
from .dsss import DsssChain
from .fec import QcLdpc
from .fhss import FhssModem
from .chain import (DcqpskChain, DifferentialChain, FskChain, MskChain,
                    OqpskChain, PulseShapedChain, qpsk_reference_chain)
from .gmsk import GmskChain
from .link import FramedLink
from .metrics import LinkStats
from .mimo import MimoOfdm, MimoOfdmN
from .models import SCHEME_NAMES, make_scheme
from .ofdm import OfdmChain, OfdmModem, OfdmStreamReceiver
from .ops.channelizer import Channelizer
from .resampled import ResampledChain, StreamingResampledChain
from .rx import Demodulator, RxState
from .scfde import ScFdeChain, ScFdeModem
from .stbc import AlamoutiOfdm
from .sync import AcquiringReceiver
from .streaming import StreamingFusedChain, StreamingFusedRx, StreamingFusedTx
from .tx import Modulator, TxState
from .wideband import WidebandModem

__all__ = [
    "AcquiringReceiver", "AdaptiveOfdm", "AlamoutiOfdm", "Channelizer",
    "DcqpskChain", "Demodulator", "DifferentialChain", "DsssChain",
    "FhssModem", "FramedLink",
    "Freq", "FskChain", "GmskChain", "LinkStats", "MimoOfdm", "MimoOfdmN",
    "Modulator", "MskChain",
    "OfdmChain", "OfdmModem", "OfdmStreamReceiver", "OqpskChain",
    "PulseShapedChain", "QcLdpc",
    "Rates", "presets", "ResampledChain", "RxState", "SCHEME_NAMES",
    "ScFdeChain", "ScFdeModem",
    "StreamingFusedChain", "StreamingFusedRx", "StreamingFusedTx",
    "StreamingResampledChain", "TxState", "WidebandModem", "make_scheme",
    "bit_loading", "qpsk_reference_chain",
]
