"""Byte-format IO: the reference CLI's wire formats (counterpart of
:mod:`modem_tpu.io`).

* ``modulate`` input: ASCII '0'/'1', whitespace ignored (`data.rs:142-159`);
* ``modulate`` output: little-endian f32, interleaved (i, q) pairs (``--iq``,
  `modulate.rs:109-116`) or real passband (`modulate.rs:128-133`);
* ``demodulate`` input: little-endian i16 words (`bin/util.rs:13-24`);
* ``demodulate`` output: text records ``i:<v>\\tq:<v>`` per sample
  (`demodulate.rs:41-43`).

Each transform prefers the native C++ library, the repository's
``native/modemio.cpp``, which :func:`build_native` compiles with ``g++`` into
``modem_tpu_torch/_build/`` at first use, and falls back to NumPy where no
toolchain is found. Both paths are tested against each other.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent
NATIVE_SRC = _PKG.parent / "native" / "modemio.cpp"
NATIVE_LIB = _PKG / "_build" / "libmodemio.so"

_LIB = None
_LIB_TRIED = False


def build_native(force: bool = False) -> Path:
    """Compile ``native/modemio.cpp`` into ``_build/libmodemio.so`` unless
    an up-to-date one is there."""
    if (not force and NATIVE_LIB.exists()
            and NATIVE_LIB.stat().st_mtime >= NATIVE_SRC.stat().st_mtime):
        return NATIVE_LIB
    NATIVE_LIB.parent.mkdir(parents=True, exist_ok=True)
    tmp = NATIVE_LIB.with_name(f"{NATIVE_LIB.name}.{os.getpid()}.tmp")
    subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-o",
                    str(tmp), str(NATIVE_SRC)], check=True,
                   capture_output=True)
    os.replace(tmp, NATIVE_LIB)  # atomic: a concurrent build sees all or nothing
    return NATIVE_LIB


def _native():
    """The native library, built at first use; None if unavailable."""
    global _LIB, _LIB_TRIED
    if _LIB_TRIED:
        return _LIB
    _LIB_TRIED = True
    try:
        lib = ctypes.CDLL(str(build_native()))
        lib.modemio_parse_ascii_bits.restype = ctypes.c_long
        lib.modemio_format_iq_text.restype = ctypes.c_long
        _LIB = lib
    except (OSError, subprocess.CalledProcessError):
        _LIB = None
    return _LIB


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def parse_ascii_bits(data: bytes) -> np.ndarray:
    """ASCII '0'/'1' (whitespace skipped) -> uint8 bit array. Raises on any
    other byte, mirroring the reference's assert (`data.rs:152-158`)."""
    lib = _native()
    if lib is not None:
        raw = np.frombuffer(data, np.uint8)
        out = np.empty(len(data), np.uint8)
        n = lib.modemio_parse_ascii_bits(_ptr(raw), ctypes.c_long(len(data)),
                                         _ptr(out))
        if n < 0:
            pos = -int(n) - 1
            raise ValueError(f"invalid bit character {data[pos:pos+1]!r} "
                             f"at offset {pos}")
        return out[:n].copy()
    arr = np.frombuffer(data, np.uint8)
    # Whitespace per the reference's `(byte as char).is_whitespace()`
    # (`data.rs:151`): ASCII whitespace plus Latin-1 NEL (0x85), NBSP (0xA0).
    arr = arr[~np.isin(arr, np.frombuffer(b" \t\n\r\v\f\x85\xa0", np.uint8))]
    bad = (arr != ord("0")) & (arr != ord("1"))
    if bad.any():
        pos = int(np.argmax(bad))
        raise ValueError(f"invalid bit character {chr(arr[pos])!r}")
    return (arr - ord("0")).astype(np.uint8)


def format_ascii_bits(bits: np.ndarray) -> bytes:
    """Bit array -> ASCII '0'/'1' bytes (no separators)."""
    bits = np.ascontiguousarray(np.asarray(bits, np.uint8))
    lib = _native()
    if lib is not None:
        out = np.empty(bits.size, np.uint8)
        lib.modemio_format_ascii_bits(_ptr(bits), ctypes.c_long(bits.size),
                                      _ptr(out))
        return out.tobytes()
    return (bits + ord("0")).astype(np.uint8).tobytes()


def i16le_to_f32(data: bytes) -> np.ndarray:
    """LE i16 words -> f32 samples (the demodulate input adapter)."""
    if len(data) % 2:
        data = data[:-1]  # the reference drops a trailing odd byte
    lib = _native()
    if lib is not None:
        raw = np.frombuffer(data, np.uint8)
        out = np.empty(len(data) // 2, np.float32)
        lib.modemio_i16le_to_f32(_ptr(raw), ctypes.c_long(out.size), _ptr(out))
        return out
    return np.frombuffer(data, "<i2").astype(np.float32)


def f32_to_f32le(x: np.ndarray) -> bytes:
    """f32 samples -> LE bytes (the modulate output format)."""
    x = np.ascontiguousarray(np.asarray(x, np.float32))
    lib = _native()
    if lib is not None:
        out = np.empty(x.size * 4, np.uint8)
        lib.modemio_f32_to_f32le(_ptr(x), ctypes.c_long(x.size), _ptr(out))
        return out.tobytes()
    return x.astype("<f4").tobytes()


def f32le_to_f32(data: bytes) -> np.ndarray:
    """LE f32 bytes -> samples."""
    lib = _native()
    if lib is not None:
        raw = np.frombuffer(data[: len(data) // 4 * 4], np.uint8)
        out = np.empty(len(raw) // 4, np.float32)
        lib.modemio_f32le_to_f32(_ptr(raw), ctypes.c_long(out.size), _ptr(out))
        return out
    return np.frombuffer(data[: len(data) // 4 * 4], "<f4").astype(np.float32)


def interleave_iq(i: np.ndarray, q: np.ndarray) -> np.ndarray:
    """I/Q planes -> interleaved (i, q, i, q, ...) f32 array."""
    i = np.ascontiguousarray(np.asarray(i, np.float32))
    q = np.ascontiguousarray(np.asarray(q, np.float32))
    lib = _native()
    if lib is not None:
        out = np.empty(2 * i.size, np.float32)
        lib.modemio_interleave_iq(_ptr(i), _ptr(q), ctypes.c_long(i.size),
                                  _ptr(out))
        return out
    return np.stack([i, q], axis=-1).reshape(-1)


def format_iq_text(i: np.ndarray, q: np.ndarray) -> bytes:
    """Per-sample ``i:<v>\\tq:<v>`` lines (the demodulate output)."""
    i = np.ascontiguousarray(np.asarray(i, np.float32))
    q = np.ascontiguousarray(np.asarray(q, np.float32))
    lib = _native()
    if lib is not None:
        cap = 64 * i.size + 64
        out = ctypes.create_string_buffer(cap)
        n = lib.modemio_format_iq_text(_ptr(i), _ptr(q),
                                       ctypes.c_long(i.size), out,
                                       ctypes.c_long(cap))
        if n >= 0:
            return out.raw[:n]
    return b"".join(b"i:%g\tq:%g\n" % (vi, vq)
                    for vi, vq in zip(i.astype(float), q.astype(float)))
