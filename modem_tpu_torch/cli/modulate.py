"""``modulate``: ASCII bits on stdin -> LE f32 waveform on stdout
(counterpart of :mod:`modem_tpu.cli.modulate`).

Mirrors the reference's `modulate.rs`: flags ``-m`` scheme (required), ``-r``
sample rate (default 10000), ``-b`` baud (default 220), ``-c`` carrier Hz
(default 1000), ``-p`` preamble cycles, ``--iq`` raw-baseband mode
(`modulate.rs:24-30`), with the Nyquist and preamble-divisibility checks of
`modulate.rs:62,68`. ``--iq`` writes interleaved (i, q) f32 pairs
(`modulate.rs:109-116`); otherwise the real passband, preceded by
``sr/cf*pc - 1`` samples of carrier tone when ``-p`` is given
(`modulate.rs:118-133`). ``--device`` picks where the modulator runs (the
card by default).

stdin is read in bounded chunks, bits are consumed in symbol blocks and the
modulator state is carried across blocks: any stream length runs in
constant memory with bit-stable phase continuity.
"""

from __future__ import annotations

import argparse
import io as _io
import sys

import numpy as np
import torch

from .. import io as mio
from ..config import Rates
from ..models import SCHEME_NAMES, make_scheme
from ..tx import Modulator

BLOCK_SYMBOLS = 1 << 16
CHUNK_BYTES = 1 << 20


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="modulate",
        description="modulate bits from stdin (see modulate.rs:24-30)",
    )
    p.add_argument("-m", "--scheme", required=True, choices=SCHEME_NAMES)
    p.add_argument("-r", "--sample-rate", type=int, default=10000)
    p.add_argument("-b", "--baud-rate", type=int, default=220)
    p.add_argument("-c", "--carrier", type=int, default=1000)
    p.add_argument("-p", "--preamble", type=int, default=0,
                   help="preamble length in carrier cycles")
    p.add_argument("--iq", action="store_true",
                   help="write raw baseband (i, q) pairs, no carrier")
    p.add_argument("--block-symbols", type=int, default=BLOCK_SYMBOLS)
    p.add_argument("--device", default="cuda",
                   help="torch device to modulate on (default: cuda)")
    return p


def run(args, stdin, stdout) -> None:
    """``stdin``: a binary stream (or bytes, wrapped for convenience), read
    in ``CHUNK_BYTES`` chunks."""
    if isinstance(stdin, (bytes, bytearray)):
        stdin = _io.BytesIO(stdin)
    rates = Rates(args.baud_rate, args.sample_rate)
    if not args.carrier < args.sample_rate / 2:  # `modulate.rs:68`
        raise SystemExit("carrier must satisfy Nyquist (cf < sr/2)")
    scheme = make_scheme(args.scheme, rates)
    mod = Modulator(scheme, rates, carrier_hz=None if args.iq else args.carrier,
                    device=args.device)
    state = mod.init_state()

    if args.preamble and not args.iq:
        if args.sample_rate % args.carrier != 0:  # `modulate.rs:62`
            raise SystemExit("preamble requires sr % carrier == 0")
        tone, state = mod.preamble(args.preamble, state)
        stdout.write(mio.f32_to_f32le(tone.cpu().numpy()))

    bps = scheme.bits_per_symbol
    blk = args.block_symbols * bps

    def emit(chunk_bits: np.ndarray) -> None:
        nonlocal state
        chunk = torch.as_tensor(chunk_bits.astype(np.int32), device=mod.device)
        if args.iq:
            (i, q), state = mod.baseband(chunk, state)
            stdout.write(mio.f32_to_f32le(
                mio.interleave_iq(i.cpu().numpy(), q.cpu().numpy())))
        else:
            wave, state = mod.passband(chunk, state)
            stdout.write(mio.f32_to_f32le(wave.cpu().numpy()))

    pending = np.empty(0, np.uint8)  # parsed bits awaiting a full block
    while True:
        raw = stdin.read(CHUNK_BYTES)
        if not raw:
            break
        bits = mio.parse_ascii_bits(raw)
        pending = np.concatenate([pending, bits]) if pending.size else bits
        full = pending.size - pending.size % blk
        for start in range(0, full, blk):
            emit(pending[start: start + blk])
        pending = pending[full:]
    # Final partial block: whole symbols only; the trailing partial symbol
    # is dropped (`data.rs:54-63`).
    n_sym = pending.size // bps
    if n_sym:
        emit(pending[: n_sym * bps])


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    run(args, sys.stdin.buffer, sys.stdout.buffer)


if __name__ == "__main__":
    main()
