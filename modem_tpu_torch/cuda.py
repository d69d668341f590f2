"""Build, load and launch the port's CUDA kernels.

The kernels are CUDA C++ under ``modem_tpu_torch/csrc/``, each behind a plain
C entry point that launches it on the stream it is given and returns
``cudaGetLastError()``. At first use, :func:`library` compiles all of them
with ``nvcc`` for ``sm_90a`` into one shared library under
``modem_tpu_torch/_build/`` (named by a hash of the sources and flags, so an
edited source rebuilds) and loads it with ``ctypes``. Nothing is built or
loaded when the package is imported.

A :class:`Kernel` is one entry point with its launch count: it counts a
launch only where the C function ran and reported success.
:func:`host_taps` keeps the host copy of a taps tensor that K1, K3, K4 and
K5 take by value, in a kernel parameter.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import weakref
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_U = ctypes.c_uint
#: the pulse-shaped kernels' map (lut, n_points, cshift, ms, a, cos, sin)
#: and carrier (hz, sr, sym_offset, 2*pi/sr) arguments
_MAP = [_P, _I, _I, _F, _F, _F, _F]
_NCO = [_I, _I, _L, _F]
#: argument types of each C entry point (pointers and the stream as
#: c_void_p; the taps of ``modem_chain``, ``modem_rx_hard``,
#: ``modem_rx_soft`` and ``modem_fir`` a host pointer (:func:`host_taps`) or
#: null, then a device pointer; ``modem_demod``'s a host pointer)
SIGNATURES = {
    "modem_fsk_tx": [_P, _P, _L, _L, _I, _I, _F, _F, _F, _P, _P, _P],
    "modem_msk_tx": [_P, _P, _L, _L, _I, _F, _F, _P, _P, _P],
    "modem_disc_means": [_P, _P, _L, _I, _I, _F, _P, _P],
    "modem_fsk_chain": [_P, _P, _L, _L, _P, _I, _I, _I, _F, _F, _F, _I, _F,
                        _I, _I, _F, _U, _P, _P],
    "modem_msk_chain": [_P, _P, _L, _L, _I, _F, _F, _I, _I, _I, _F, _U, _P,
                        _P],
    "modem_resampled_tx": [_P, _L, _L, _P, _I, _P, _I, _I, _P, _I, _I, _I,
                           _I, _L, _P, _P, _P],
    "modem_resampled_rx": [_P, _P, _L, _L, _L, _P, _I, _I, _I, _I, _P, _I,
                           _I, _P, _P, _P, _P],
    "modem_tx": [_P, _L, _L, *_MAP, _P, _I, _I, _I, *_NCO, _I, _F, _P, _P,
                 _P],
    "modem_rx_hard": [_P, _P, _I, _L, _L, _L, _P, _P, _I, _I, _I, *_MAP,
                      *_NCO, _P, _P],
    "modem_rx_soft": [_P, _P, _I, _L, _L, _L, _P, _P, _I, _I, _I, *_NCO, _P,
                      _P, _P],
    "modem_chain": [_P, _L, _L, _I, *_MAP, _P, _P, _I, _I, _I, *_NCO, _I, _F,
                    _U, _P, _P],
    "modem_fir": [_P, _P, _L, _L, _P, _P, _I, _P, _P],
    "modem_demod": [_P, _I, _P, _L, _L, _P, _I, _I, _I, _F, _I, _I, _I, _I,
                    _P, _P, _P, _P, _P],
    "modem_viterbi": [_P, _P, _P, _L, _L, _I, _I, _I, _I, _I, _I, _I, _L, _I,
                      _L, _F, _I, _I, _L, _P, _P],
    "modem_viterbi_block": [_P, _P, _P, _L, _L, _I, _I, _I, _I, _I, _I, _I,
                            _I, _L, _L, _P, _P, _L, _I, _L, _F, _I, _I, _L,
                            _P, _P],
    "modem_bcjr": [_P, _L, _I, _I, _I, _P, _P, _P],
    "modem_polar_sc": [_P, _L, _I, _I, _P, _P, _P, _P],
    "modem_polar_scl": [_P, _L, _I, _I, _P, _P, _P, _P],
}

#: floats of ``csrc/common.cuh``'s ``Taps``: the most taps a kernel takes
#: by value, in a kernel parameter
TAPS_PARAM = 256


class _Taps(ctypes.Structure):
    """``csrc/common.cuh``'s ``Taps``: the taps as the kernel parameter."""
    _fields_ = [("v", ctypes.c_float * TAPS_PARAM)]


#: id(taps) -> (weak reference, version, _Taps): one copy to the host per
#: taps tensor (a chain's ``rrc``, a demodulator's ``lowpass``), not one per
#: launch
_HOST_TAPS: dict[int, tuple] = {}

_library: ctypes.CDLL | None = None
#: the compilers' output of each library that failed to build in this
#: process, so that later calls raise it again without re-running ``nvcc``
_failed_builds: dict[Path, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def build_library() -> Path:
    """Compile ``csrc/*.cu`` into ``_build/libmodem_kernels_<hash>.so``
    unless that file exists: one ``nvcc -c`` per source, all started
    together, then one link. A failed build is raised again, without a new
    compile, for the rest of the process. The compilers' output (``ptxas`` register and
    shared-memory counts) goes to the ``.log`` beside the library."""
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources + sorted(CSRC.glob("*.cuh")):
        digest.update(path.name.encode() + path.read_bytes())
    so = BUILD_DIR / f"libmodem_kernels_{digest.hexdigest()[:16]}.so"
    if so in _failed_builds:  # the same sources failed: fail fast again
        raise RuntimeError(_failed_builds[so])
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{so.stem}.{os.getpid()}"
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources]
    procs = [subprocess.Popen([_nvcc(), *compile_flags, "-c", "-o", str(obj),
                               str(src)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources, objs)]
    logs = [p.communicate()[0] for p in procs]
    tmp = so.with_name(f"{tag}.so.tmp")
    link = None
    if all(p.returncode == 0 for p in procs):
        link = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                               *map(str, objs)], capture_output=True, text=True)
        logs.append(link.stdout + link.stderr)
    so.with_suffix(".log").write_text("".join(logs))
    for obj in objs:
        obj.unlink(missing_ok=True)
    if link is None or link.returncode != 0:
        _failed_builds[so] = "nvcc failed:\n" + "".join(logs)
        raise RuntimeError(_failed_builds[so])
    os.replace(tmp, so)  # atomic: a concurrent build sees all or nothing
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _library
    if _library is None:
        lib = ctypes.CDLL(str(build_library()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.modem_error_string.argtypes = [ctypes.c_int]
        lib.modem_error_string.restype = ctypes.c_char_p
        _library = lib
    return _library


def resolve_device(device: torch.device | str | None = None) -> torch.device:
    """The device an entry point builds on: ``None`` means the card. Raises
    ``RuntimeError`` for a CUDA device where there is none, so nothing is
    ever built on the CPU unless the caller asks for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: modem_tpu_torch runs on the card unless the "
            "caller asks for the CPU (device='cpu')")
    return dev


def host_taps(taps: torch.Tensor) -> int:
    """The address of a host copy of ``taps`` (at most :data:`TAPS_PARAM`)
    as the kernels take them by value, in a ``Taps`` kernel parameter. The
    copy is kept while ``taps`` lives and is not modified in place (its
    version counter), so a filter's taps cross to the host once, not at
    every launch; an inference tensor, which has no version counter, is
    copied at every call."""
    if taps.shape[0] > TAPS_PARAM:
        raise ValueError(f"a Taps parameter holds at most {TAPS_PARAM} taps, "
                         f"got {taps.shape[0]}")
    version = None if taps.is_inference() else taps._version
    hit = _HOST_TAPS.get(id(taps))
    if (version is not None and hit is not None and hit[0]() is taps
            and hit[1] == version):
        return ctypes.addressof(hit[2])
    if len(_HOST_TAPS) >= 64:
        for key in [k for k, v in _HOST_TAPS.items() if v[0]() is None]:
            del _HOST_TAPS[key]
    param = _Taps()
    values = taps.detach().cpu().numpy()
    param.v[:values.shape[0]] = values.tolist()
    _HOST_TAPS[id(taps)] = (weakref.ref(taps), version, param)
    return ctypes.addressof(param)


def check_cuda(name: str, t: torch.Tensor, dtype: torch.dtype,
               device: torch.device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor on the CUDA
    ``device``."""
    if (device.type != "cuda" or t.device != device or t.dtype != dtype
            or not t.is_contiguous()):
        raise ValueError(
            f"{name}: the kernel takes a contiguous {dtype} CUDA tensor on "
            f"{device}, got {t.dtype} on {t.device} "
            f"(contiguous={t.is_contiguous()})")


class Kernel:
    """One C entry point of the kernel library and its launch count."""

    def __init__(self, symbol: str):
        self.symbol = symbol
        self.launches = 0

    def launch(self, device: torch.device, *args) -> None:
        """Launch on ``device``'s current stream; the last argument the C
        function takes, the stream, is added here."""
        fn = getattr(library(), self.symbol)
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = fn(*args, stream)
        if rc != 0:
            msg = library().modem_error_string(rc).decode()
            raise RuntimeError(f"{self.symbol}: CUDA error {rc} ({msg})")
        self.launches += 1
