"""modem_tpu_torch: the modem signal chain in PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper (``sm_90a``).

A port of the JAX package ``modem_tpu``, which stays the reference: each
module here has the same path as its counterpart there, keeps its layouts
and dtypes, and is tested against it on shared inputs. This package never
imports ``jax`` or ``modem_tpu``. Ported so far: the flagship QPSK chain
(:class:`~modem_tpu_torch.chain.PulseShapedChain`) staged and fused, with
its streaming classes; kernels are built at first use (:mod:`.cuda`).
"""

from .config import Rates
from .chain import PulseShapedChain, qpsk_reference_chain
from .streaming import StreamingFusedChain, StreamingFusedRx, StreamingFusedTx

__all__ = [
    "PulseShapedChain", "Rates", "StreamingFusedChain", "StreamingFusedRx",
    "StreamingFusedTx", "qpsk_reference_chain",
]
