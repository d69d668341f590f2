"""``demodulate``: LE i16 passband on stdin -> per-sample i/q text on stdout
(counterpart of :mod:`modem_tpu.cli.demodulate`).

Mirrors the reference's `demodulate.rs`: sample rate 10000 and carrier 900 Hz
(`demodulate.rs:10,36`; overridable here), the 23-tap Hilbert analytic front
end, 64-sample PLL acquisition, then the coherent product detector printing
``i:<v>\\tq:<v>`` per sample (`demodulate.rs:41-43`). ``--fused`` runs the
detector as one kernel (K5); ``--device`` picks where the demodulator runs
(the card by default).

stdin is read in bounded chunks and the receiver state is carried across
blocks, so any stream length runs in constant memory.
"""

from __future__ import annotations

import argparse
import io as _io
import sys

import numpy as np
import torch

from .. import io as mio
from ..ops.pll import LOCK_SAMPLES
from ..rx import Demodulator

BLOCK_SAMPLES = 1 << 20
CHUNK_BYTES = 1 << 21


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="demodulate",
        description="demodulate i16 LE samples from stdin (demodulate.rs:15-43)",
    )
    p.add_argument("-r", "--sample-rate", type=int, default=10000)
    p.add_argument("-c", "--carrier", type=int, default=900)
    p.add_argument("--block-samples", type=int, default=BLOCK_SAMPLES)
    p.add_argument(
        "--fused", action="store_true",
        help="run the product detector as one kernel "
             "(modem_tpu_torch.ops.demod_kernel); outputs match the staged "
             "detector to f32 rounding")
    p.add_argument("--device", default="cuda",
                   help="torch device to demodulate on (default: cuda)")
    return p


def run(args, stdin, stdout) -> None:
    """``stdin``: a binary stream (or bytes, wrapped for convenience), read
    in ``CHUNK_BYTES`` chunks. An odd byte at a chunk seam is carried to the
    next chunk; an odd byte at the stream's end is dropped
    (`bin/util.rs:29-33`)."""
    if isinstance(stdin, (bytes, bytearray)):
        stdin = _io.BytesIO(stdin)
    demod = Demodulator(args.carrier, args.sample_rate, device=args.device)
    dev = demod.device
    state = demod.init_state()
    carry = b""
    lock_buf = np.empty(0, np.float32)
    locked = False
    x_tail = None  # the fused path's carried passband tail
    while True:
        raw = stdin.read(CHUNK_BYTES)
        if not raw:
            break
        data = carry + raw if carry else raw
        if len(data) % 2:
            carry, data = data[-1:], data[:-1]
        else:
            carry = b""
        x = mio.i16le_to_f32(data)
        if not locked:
            lock_buf = np.concatenate([lock_buf, x])
            if lock_buf.size < LOCK_SAMPLES:
                continue
            state = demod.lock_phase(
                torch.as_tensor(lock_buf[:LOCK_SAMPLES], device=dev), state)
            locked = True
            x = lock_buf[LOCK_SAMPLES:]
            lock_buf = np.empty(0, np.float32)
        for start in range(0, x.size, args.block_samples):
            chunk = torch.as_tensor(x[start: start + args.block_samples],
                                    device=dev)
            if args.fused:
                (i, q), state, x_tail = demod.demodulate_fused(
                    chunk, state, x_tail)
            else:
                (i, q), state = demod.demodulate(chunk, state)
            stdout.write(mio.format_iq_text(i.cpu().numpy(), q.cpu().numpy()))
    if not locked:
        raise SystemExit(f"need at least {LOCK_SAMPLES} samples to lock")


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    run(args, sys.stdin.buffer, sys.stdout.buffer)


if __name__ == "__main__":
    main()
