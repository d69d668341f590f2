"""Multi-device sharding on ``torch.distributed`` (counterpart of
:mod:`modem_tpu.parallel`).

One process drives one device; a mesh is a ``DeviceMesh`` with the
dimensions ``("ch", "time")`` (:func:`make_modem_mesh`,
:func:`~.multihost.initialize_multihost`), and every sharded function
takes and returns this rank's local block:

* **channel sharding** (data parallel): independent channels over ``ch``,
  no collective (:func:`channel_sharded`, :func:`sharded_acquire_fn`, the
  OFDM functions);
* **time sharding** (sequence parallel): one stream split across ranks,
  the FIR and matched-filter boundaries stitched with halo exchanges
  (:mod:`.collectives`, :func:`sharded_fir`) and the phase accumulators
  carried by an exclusive prefix scan (:func:`exclusive_prefix`);
* **the 2-D sharded flagship chain** (:class:`ShardedPulseChain`):
  channels x time, the single-device chain's decisions exactly.

Inside each rank the single-device functions run unchanged: the kernels on
the card, their plain versions on the CPU. The collectives use the group's
backend (NCCL on ``cuda``, gloo on ``cpu``); a gloo group's CUDA tensors
are staged through the host.
"""

from .acquire import sharded_acquire_fn
from .channelizer import (sharded_analyze_fn, sharded_synthesize_fn,
                          wideband_rx_fn, wideband_tx_fn)
from .generic import channel_sharded
from .mesh import make_modem_mesh
from .ofdm import sharded_ofdm_rx_fn, sharded_ofdm_tx_fn
from .collectives import left_halo, right_halo, exclusive_prefix
from .fir import fir_with_halo, sharded_fir
from .chain import ShardedDifferentialChain, ShardedPulseChain
from .modulator import time_sharded_baseband
from .resampled import ShardedResampledChain
from .rx import sharded_demodulate
from .fsk import time_sharded_fsk_roundtrip_fn
from .viterbi import sharded_viterbi_fn, viterbi_with_halo

__all__ = [
    "channel_sharded", "make_modem_mesh", "left_halo", "right_halo",
    "exclusive_prefix", "fir_with_halo", "sharded_fir",
    "ShardedDifferentialChain", "ShardedPulseChain", "ShardedResampledChain",
    "sharded_acquire_fn", "sharded_analyze_fn", "sharded_synthesize_fn",
    "sharded_ofdm_rx_fn", "sharded_ofdm_tx_fn",
    "sharded_viterbi_fn", "time_sharded_baseband",
    "sharded_demodulate", "time_sharded_fsk_roundtrip_fn",
    "viterbi_with_halo", "wideband_rx_fn", "wideband_tx_fn",
]
