"""Where K1's and K3's long core spend their time, by timing probes.

The long core (``csrc/common.cuh``'s ``matched_long``, ``chain.cu``'s
``pulse_chain_long_core``, ``txrx.cu``'s ``pulse_rx_long_core``) is built
four times, with ``MODEM_LONG_PROBE`` 0 (the library itself), 1 (one
16-byte broadcast of four taps a group for all the decisions of a walk,
in place of one a decision), 2 (K1 without its filter) and 3 (K1 without
its synthesis). The probes' outputs are wrong; only their times are read.
At each of phase 34's long shapes (sps 8 span 32, sps 20 span 16, sps 96
span 1, sps 45 span 8) at 256 x 4096 symbols, K1 and K3 hard on QPSK run
on each build in turn, in the order 0 1 2 3 3 2 1 0 over ``--rounds``
rounds, each timed by the profiler's device time of the core's kernel
(``chip_smoke.kernel_device_ms``, 20 launches); the printed time is the
median over the rounds and the two passes. The builds run in parallel,
one process each, before any time is taken.

    python3 probe_long_core.py [--rounds 2]

Needs a CUDA card; imports nothing of JAX. The last line is one JSON
object: ``{"card": ..., "ms": {"<kernel> sps<S> span<N>": {"<probe>":
ms}}}``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

#: (sps, span) of each shape, phase 34's LONG_ROUTE's
SHAPES = ((8, 32), (20, 16), (96, 1), (45, 8))
CHANNELS, SYMBOLS = 256, 4096
PROBES = {0: "core", 1: "one tap broadcast a group", 2: "K1 without filter",
          3: "K1 without synthesis"}


def probe_flags(probe: int) -> tuple:
    from modem_tpu_torch import cuda

    base = tuple(f for f in cuda.NVCC_FLAGS
                 if not f.startswith("-DMODEM_LONG_PROBE="))
    return base + ((f"-DMODEM_LONG_PROBE={probe}",) if probe else ())


def use_probe(probe: int) -> None:
    """Load the library built with ``probe`` (built first if need be)."""
    from modem_tpu_torch import cuda

    cuda.NVCC_FLAGS = probe_flags(probe)
    cuda._library = None
    cuda.library()


def build(probe: int) -> None:
    from modem_tpu_torch import cuda

    cuda.NVCC_FLAGS = probe_flags(probe)
    cuda.build_library()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--build", type=int, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.build is not None:
        build(args.build)
        return 0

    import torch

    if not torch.cuda.is_available():
        print("probe_long_core: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as sm
    from modem_tpu_torch.ops import chain_kernel as ck, txrx
    from modem_tpu_torch.ops.filters import rrc_taps

    t0 = time.time()
    procs = [subprocess.Popen([sys.executable, __file__, "--build", str(p)])
             for p in PROBES]
    if any(p.wait() for p in procs):
        print("probe_long_core: a build failed", file=sys.stderr)
        return 1
    print(f"[probe] {len(PROBES)} builds in {time.time() - t0:.1f} s",
          flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    device = torch.device("cuda")
    lut = torch.tensor([[1, 1], [-1, 1], [1, -1], [-1, -1]],
                       dtype=torch.float32, device=device) / 2 ** 0.5
    cases = []
    for sps, span in SHAPES:
        taps = torch.as_tensor(rrc_taps(sps, span, 0.35),
                               dtype=torch.float32, device=device)
        assert txrx.pulse_long_route(sps, span) == "core"
        syms = sm.random_symbols((CHANNELS, SYMBOLS), device, False)
        wi, wq = txrx.tx_plain(syms, lut, taps, sps, span)
        cases += [(f"K1 sps{sps} span{span}", ck.chain_kernel,
                   (syms, lut, taps, sps, span), "pulse_chain_long_core"),
                  (f"K3 hard sps{sps} span{span}", txrx.rx_kernel,
                   (wi, wq, SYMBOLS, lut, taps, sps, span, False),
                   "pulse_rx_long_core<false,")]
    order = list(PROBES) + list(PROBES)[::-1]
    got = {name: {p: [] for p in PROBES} for name, *_ in cases}
    for _ in range(args.rounds):
        for p in order:
            use_probe(p)
            for name, fn, fargs, symbol in cases:
                if p in (2, 3) and not name.startswith("K1"):
                    continue  # K3's kernel is the core's in those builds
                ms = sm.kernel_device_ms(fn, fargs, device, symbol)
                if ms is None:
                    print(f"probe_long_core: no profile of {name}",
                          file=sys.stderr)
                    return 1
                got[name][p].append(ms)
    table = {name: {PROBES[p]: statistics.median(v) for p, v in d.items()
                    if v} for name, d in got.items()}
    for name, row in table.items():
        base = row[PROBES[0]]
        print(f"[probe] {name:22s} " + ", ".join(
            f"{k} {v:.4f} ms ({v / base:.2f}x)" for k, v in row.items())
            + f"; {CHANNELS} x {SYMBOLS} on {card}", flush=True)
    print(json.dumps({"card": card, "ms": table}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
