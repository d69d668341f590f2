"""Filter tap designers: Hilbert, lowpass, root-raised-cosine.

NumPy only: a copy of :mod:`modem_tpu.ops.filters`, so that both packages
design the same taps without this one importing the JAX package.

The reference ships two fixed "generated with matlab" coefficient arrays
(`src/bin/demodulate.rs:46-75`: a 23-tap Hilbert transformer;
`:77-150`: a 64-tap lowpass, passband 0-1 kHz / stopband 1.5-5 kHz at 10 kHz).
We do not copy those arrays; we *design* filters to the same specifications at
construction time (host-side NumPy/SciPy; the chains move the taps to their
device once, as buffers). RRC pulse shaping is a chain-completing capability
the reference lacks (SURVEY.md "What the reference is NOT").
"""

from __future__ import annotations

import numpy as np


def hilbert_taps(n_taps: int = 23) -> np.ndarray:
    """Odd-length type-III Hilbert transformer (same length/role as the
    reference's 23-tap design): ideal h[k] = 2/(pi*k) for odd k, 0 otherwise,
    Blackman-windowed."""
    if n_taps % 2 == 0:
        raise ValueError("Hilbert transformer needs odd length")
    mid = n_taps // 2
    k = np.arange(n_taps) - mid
    h = np.zeros(n_taps)
    odd = k % 2 != 0
    h[odd] = 2.0 / (np.pi * k[odd])
    h *= np.blackman(n_taps)
    return h.astype(np.float32)


def lowpass_taps(
    n_taps: int = 64,
    passband_hz: float = 1000.0,
    stopband_hz: float = 1500.0,
    sample_rate: float = 10000.0,
) -> np.ndarray:
    """Equiripple lowpass to the reference's published spec (defaults:
    passband 0-1 kHz, stopband 1.5-5 kHz at 10 kHz, 64 taps).

    SciPy is imported lazily and only here: without it the design falls back
    to a Kaiser-windowed sinc at the band-edge midpoint, which meets the same
    role (anti-image lowpass) with slightly less stopband ripple control —
    the rest of the package must import cleanly with torch+numpy alone.
    """
    try:
        from scipy import signal as _sig
    except ImportError:
        cutoff = (passband_hz + stopband_hz) / 2.0 / (sample_rate / 2.0)
        n = np.arange(n_taps) - (n_taps - 1) / 2.0
        taps = np.sinc(cutoff * n) * cutoff * np.kaiser(n_taps, 6.0)
        return (taps / taps.sum()).astype(np.float32)
    taps = _sig.remez(
        n_taps,
        [0, passband_hz, stopband_hz, sample_rate / 2],
        [1, 0],
        fs=sample_rate,
    )
    return taps.astype(np.float32)


def rrc_taps(
    sps: int, span_symbols: int = 8, beta: float = 0.35, norm: str = "unit_energy"
) -> np.ndarray:
    """Root-raised-cosine pulse, ``span_symbols*sps + 1`` taps.

    Closed form with the usual limit handling at t = 0 and t = +-Ts/(4*beta).
    ``norm``: 'unit_energy' (matched-filter pairs give unit raised-cosine peak
    after TX+RX) or 'unit_peak'.
    """
    n = span_symbols * sps + 1
    t = (np.arange(n) - (n - 1) / 2) / sps  # in symbol periods
    taps = np.zeros(n)
    for idx, ti in enumerate(t):
        if abs(ti) < 1e-12:
            taps[idx] = 1.0 - beta + 4.0 * beta / np.pi
        elif beta > 0 and abs(abs(ti) - 1.0 / (4.0 * beta)) < 1e-9:
            taps[idx] = (beta / np.sqrt(2.0)) * (
                (1.0 + 2.0 / np.pi) * np.sin(np.pi / (4.0 * beta))
                + (1.0 - 2.0 / np.pi) * np.cos(np.pi / (4.0 * beta))
            )
        else:
            num = (
                np.sin(np.pi * ti * (1.0 - beta))
                + 4.0 * beta * ti * np.cos(np.pi * ti * (1.0 + beta))
            )
            den = np.pi * ti * (1.0 - (4.0 * beta * ti) ** 2)
            taps[idx] = num / den
    if norm == "unit_energy":
        taps /= np.sqrt(np.sum(taps**2))
    elif norm == "unit_peak":
        taps /= taps.max()
    else:
        raise ValueError(f"unknown norm {norm!r}")
    return taps.astype(np.float32)
