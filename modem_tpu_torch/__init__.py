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
  ``nr_like_control`` presets.

Every entry point builds on the card unless the caller asks for the CPU
(``device="cpu"``); kernels are built at first use (:mod:`.cuda`).
"""

from . import presets
from .config import Freq, Rates
from .chain import (DcqpskChain, DifferentialChain, FskChain, MskChain,
                    OqpskChain, PulseShapedChain, qpsk_reference_chain)
from .gmsk import GmskChain
from .link import FramedLink
from .metrics import LinkStats
from .models import SCHEME_NAMES, make_scheme
from .resampled import ResampledChain, StreamingResampledChain
from .rx import Demodulator, RxState
from .streaming import StreamingFusedChain, StreamingFusedRx, StreamingFusedTx
from .tx import Modulator, TxState

__all__ = [
    "DcqpskChain", "Demodulator", "DifferentialChain", "FramedLink",
    "Freq", "FskChain", "GmskChain", "LinkStats", "Modulator", "MskChain",
    "OqpskChain", "PulseShapedChain",
    "Rates", "presets", "ResampledChain", "RxState", "SCHEME_NAMES",
    "StreamingFusedChain", "StreamingFusedRx", "StreamingFusedTx",
    "StreamingResampledChain", "TxState", "make_scheme",
    "qpsk_reference_chain",
]
