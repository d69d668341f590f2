"""``link``: the coded production link as a CLI, payload bits to waveform
and back with per-frame CRC verdicts (counterpart of
:mod:`modem_tpu.cli.link`).

The same flags, IO conventions and exit codes as the JAX command: ASCII
``0``/``1`` payload bits in, little-endian f32 interleaved (i, q) frames
out, and back; frames processed in batches of ``--batch-frames``.
``--device`` picks where the link runs (the card by default), where the
fused route (K2 TX, K3 soft RX, and the inner decode: K13 Viterbi, K14
turbo, K15 or K16 polar) is the production path; the ``wifi_like_ofdm``
preset runs its OFDM chain staged (it has no fused forms) with the LDPC
decode.

    python -m modem_tpu_torch.cli.link tx --preset reference < payload.bits > frames.f32
    python -m modem_tpu_torch.cli.link rx --preset reference --noise-var 0.05 < frames.f32 > out.bits

``rx`` prints one ``frame: OK``/``BAD`` verdict per frame on stderr and
exits 1 if any frame failed.
"""

from __future__ import annotations

import argparse
import io as _io
import sys

import numpy as np
import torch

from .. import io as mio
from .. import presets
from ..ofdm import OfdmChain

#: preset name -> FramedLink constructor (takes ``device``)
PRESETS = {
    "reference": presets.reference_link,
    "dvb_like": presets.dvb_like_link,
    "ccsds_deep_space": presets.ccsds_deep_space_link,
    "lte_like_turbo": presets.lte_like_turbo_link,
    "nr_like_control": presets.nr_like_control_link,
    "wifi_like_ofdm": presets.wifi_like_ofdm_link,
}

BATCH_FRAMES = 16


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="link",
        description="coded framed link (CRC + FEC + chain) over stdio")
    p.add_argument("mode", choices=("tx", "rx"))
    p.add_argument("--preset", required=True, choices=sorted(PRESETS))
    p.add_argument("--noise-var", type=float, default=1.0,
                   help="rx: decision-point noise variance for LLR "
                        "scaling (soft-FEC beliefs)")
    p.add_argument("--batch-frames", type=int, default=BATCH_FRAMES,
                   help="frames processed per batch")
    p.add_argument("--device", default="cuda",
                   help="torch device the link runs on (default: cuda)")
    return p


def _frame_samples(link) -> int:
    """Waveform samples per frame and rail: an OFDM frame's length, or the
    symbols and the chain's ``span`` flush symbols, ``sps`` samples each."""
    chain = link.chain
    if isinstance(chain, OfdmChain):
        return chain.modem.frame_len(link.n_symbols)
    return (link.n_symbols + chain.span) * chain.sps


def run(args, stdin, stdout, stderr=None) -> int:
    if isinstance(stdin, (bytes, bytearray)):
        stdin = _io.BytesIO(stdin)
    stderr = stderr if stderr is not None else sys.stderr
    link = PRESETS[args.preset](device=args.device)
    dev = torch.device(args.device)
    pb = link.payload_bits
    batch = max(1, int(args.batch_frames))
    bad_total = 0

    if args.mode == "tx":
        pending = np.empty(0, np.uint8)

        def emit(frames_bits: np.ndarray) -> None:
            payload = torch.as_tensor(frames_bits.astype(np.int32),
                                      device=dev)
            i, q = link.tx_fused(payload)
            iv = i.reshape(-1).cpu().numpy()
            qv = q.reshape(-1).cpu().numpy()
            stdout.write(mio.f32_to_f32le(mio.interleave_iq(iv, qv)))

        while True:
            raw = stdin.read(1 << 20)
            if not raw:
                break
            bits = mio.parse_ascii_bits(raw)
            pending = (np.concatenate([pending, bits]) if pending.size
                       else bits)
            full = (pending.size // (pb * batch)) * (pb * batch)
            for s in range(0, full, pb * batch):
                emit(pending[s: s + pb * batch].reshape(batch, pb))
            pending = pending[full:]
        n = pending.size // pb
        if n:
            emit(pending[: n * pb].reshape(n, pb))
        if pending.size % pb:
            print(f"link tx: dropped {pending.size % pb} trailing bits "
                  f"(< one {pb}-bit payload)", file=stderr)
        return 0

    # rx: fixed-length frames of interleaved f32 (i, q)
    flen = _frame_samples(link)
    frame_bytes = flen * 2 * 4
    pending = b""
    while True:
        raw = stdin.read(1 << 20)
        chunk_done = not raw
        pending += raw or b""
        n = len(pending) // frame_bytes
        n = n if chunk_done else (n // batch) * batch
        if n:
            x = mio.f32le_to_f32(pending[: n * frame_bytes])
            pending = pending[n * frame_bytes:]
            iq = x.reshape(n, flen, 2)
            wave = tuple(torch.as_tensor(np.ascontiguousarray(iq[..., r]),
                                         device=dev) for r in range(2))
            payload, ok = link.rx_fused(wave, noise_var=args.noise_var)
            payload = payload.cpu().numpy()
            ok = ok.cpu().numpy()
            for f in range(n):
                stdout.write(mio.format_ascii_bits(payload[f]))
                stdout.write(b"\n")
                print(f"frame: {'OK' if bool(ok[f]) else 'BAD'}",
                      file=stderr)
            bad_total += int((~ok).sum())
        if chunk_done:
            if len(pending):
                print(f"link rx: dropped {len(pending)} trailing bytes "
                      f"(< one {frame_bytes}-byte frame)", file=stderr)
            break
    return 1 if bad_total else 0


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    raise SystemExit(run(args, sys.stdin.buffer, sys.stdout.buffer))


if __name__ == "__main__":
    main()
