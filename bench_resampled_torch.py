"""Times the PyTorch port's K11 (resampled TX), K12 (resampled RX, hard and
soft) and config #4's fused entry points on one CUDA card, alternating
between source trees in one run, and checks that every tree gives the same
bits.

    python3 bench_resampled_torch.py [--trees DIR ...] [--rounds N] [--reps N]

Each tree is a checkout of the repo (``git archive`` of another commit,
unpacked into a git-ignored directory); the default is this one. A round
runs every tree in a fresh process, in order and then in reverse (two trees:
A B B A), so that the card's drift falls on each alike. Each process builds
its tree's kernels (``build_s``), then at ``bench_rows.py:65``'s row
(``ResampledChain(QAM(4, 0.0, 1.0), Rates(1250, 10000), 3, 2)``, 256
channels x 4096 symbols, 49,257 channel samples a row) measures the
profiler's device time per launch of K11 (the kernel named
``resampled_tx...`` on any route) and K12 hard and soft (``resampled_rx...``)
on ``chip_smoke.py``'s inputs (``rs_cases``: random symbols, their waveform
with a little noise), at 3/2, at 2/3, with 64-QAM at 3/2 and at 5/4, 2/1
and 1/2 (ratios no compiled instantiation takes: the long route); and
``ResampledChain.roundtrip_fused``, ``tx_fused`` and ``rx_fused`` at 3/2:
CUDA-event time per call (10 calls a rep) and, from one profile of 3 calls,
the device's busy time per call split into K11's and K12's and every other
kernel's and copy's (the idle share is 1 - busy / time).

Each case also hashes its outputs (``*_sha``), and so do K11 and K12 at the
tile edges (rows of 1, 257 and 500 symbols, three rows, so that two start
off a 16-byte boundary) on every route: the compiled 3/2 and 2/3, and the
long route at 5/4, 2/1, 1/2 and at span 32 (257 RRC taps). The run
fails unless every process of every tree gives the same hashes, so a change
that claims the parent's bits is held to them.

Each process prints one JSON line of its reps; the run ends with each
metric's summary over the processes of each tree, then the card's name and
power limit (``bench_turbo_torch.py``'s ``alternate``, whose timers it
shares). Needs a CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import pathlib
import sys
import time

from bench_demod_torch import sha
from bench_turbo_torch import alternate, busy_ms, event_ms, smoke

CHANNELS, SYMBOLS = 256, 4096
#: (tag, bits per symbol, up, down) at full width
FULL = (("3_2", 4, 3, 2), ("2_3", 4, 2, 3), ("3_2_qam64", 6, 3, 2),
        ("5_4", 4, 5, 4), ("2_1", 4, 2, 1), ("1_2", 4, 1, 2))
#: (tag, up, down, RRC span) at the tile edges: every route
EDGES = (("3_2", 3, 2, 8), ("2_3", 2, 3, 8), ("5_4", 5, 4, 8),
         ("2_1", 2, 1, 8), ("1_2", 1, 2, 8), ("3_2_span32", 3, 2, 32))
EDGE_SHAPES = ((3, 1), (3, 257), (3, 500))
SEED = 69


def run_one(tree: pathlib.Path, reps: int) -> dict:
    """Every measurement on ``tree``'s package; the JSON line's dict."""
    sys.path.insert(0, str(tree))
    import torch

    import modem_tpu_torch
    from modem_tpu_torch import Rates, ResampledChain, cuda
    from modem_tpu_torch.models.qam import QAM

    pkg = pathlib.Path(modem_tpu_torch.__file__).resolve().parent
    assert pkg.parent == tree.resolve(), f"{pkg} is not {tree}'s package"
    sm = smoke()
    device = torch.device("cuda", 0)
    t0 = time.perf_counter()
    cuda.build_library()
    res = {"tree": str(tree), "build_s": time.perf_counter() - t0}
    cuda.library()
    symbols = {"fused_resampled_tx": "resampled_tx",
               "fused_resampled_rx": "resampled_rx",
               "fused_resampled_rx_soft": "resampled_rx"}

    for tag, bps, up, down in FULL:
        chain = sm.resampled_chain(device, bps=bps, up=up, down=down)
        for name, kern, _, args, _ in sm.rs_cases(
                chain, (CHANNELS, SYMBOLS), device, SEED):
            key = f"{name[6:]}_{tag}"
            res[f"{key}_sha"] = sha(kern(*args))
            res[f"{key}_device_ms"] = [
                sm.kernel_device_ms(kern, args, device, symbols[name])
                for _ in range(reps)]

    for tag, up, down, span in EDGES:
        chain = ResampledChain(QAM(4, 0.0, 1.0), Rates(1250, 10000), up, down,
                               span_symbols=span, device=device)
        for shape in EDGE_SHAPES:
            for name, kern, _, args, _ in sm.rs_cases(chain, shape, device,
                                                      SEED + 1):
                res[f"{name[6:]}_{tag}_{shape[1]}_sha"] = sha(kern(*args))

    chain = sm.resampled_chain(device)
    g = torch.Generator(device=device).manual_seed(SEED + 2)
    bits = torch.randint(0, 2, (CHANNELS, 4 * SYMBOLS), generator=g,
                         device=device, dtype=torch.int32)
    wave = chain.tx_fused(bits)
    for tag, fn, args in (("roundtrip_fused", chain.roundtrip_fused, (bits,)),
                          ("tx_fused", chain.tx_fused, (bits,)),
                          ("rx_fused", chain.rx_fused, (wave, SYMBOLS))):
        res[f"{tag}_sha"] = sha(fn(*args))
        res[f"{tag}_ms"] = event_ms(fn, args, 10, reps)
        res[f"{tag}_kernel_ms"], res[f"{tag}_other_ms"] = busy_ms(
            fn, args, "resampled_")
    return res


if __name__ == "__main__":
    sys.exit(alternate(pathlib.Path(__file__).resolve(), __doc__, run_one,
                       rounds=1, reps=5))
