"""Signal-processing ops of the port: plain PyTorch versions and the CUDA kernels' wrappers."""

from . import nco

__all__ = ["nco"]
