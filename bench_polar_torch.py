"""Times the PyTorch port's K16 (CA-SCL-8), the polar control link and the
flagship's K1 and K3 on one CUDA card, alternating between source trees in
one run.

    python3 bench_polar_torch.py [--trees DIR ...] [--rounds N] [--reps N]

Each tree is a checkout of the repo (``git archive`` of another commit,
unpacked into a git-ignored directory); the default is this one. A round
runs every tree in a fresh process, in order and then in reverse (two trees:
A B B A), so that the card's drift falls on each alike. Each process builds
its tree's kernels, then measures the profiler's device time per launch of:

- K16 (``scl_kernel``) at ``PolarCode(256, 128)`` (CRC-16 inside K, BPSK
  LLRs at noise sigma 0.8) over 4096 codewords (``bench_fec.py``'s width)
  and over 1024 (``nr_like_control_link().rx_fused``'s at 256 frames), and
  checks both bit for bit against ``scl_plain``; K15 at 4096;
- K1 (``chain_kernel``), K3 hard and soft (``rx_kernel``) on the flagship
  chain (``qpsk_reference_chain(Rates(1250, 10000))``, 256 x 4096 symbols),
  the short route (taps as a kernel parameter), to show it unchanged;

and ``nr_like_control_link().rx_fused`` at 256 frames and 3 dB: CUDA-event
time per call (3 calls a rep) and, from one profile of 3 calls, the device's
busy time per call split into K16's and every other kernel's and copy's.

Each process prints one JSON line of its reps; the run ends with each
metric's summary over the processes of each tree, then the card's name and
power limit (``bench_turbo_torch.py``'s ``alternate``, whose timers it
shares). Needs a CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import pathlib
import sys

from bench_turbo_torch import alternate, busy_ms, event_ms, smoke

POLAR_N, POLAR_K, SIGMA = 256, 128, 0.8
CODEWORDS = (4096, 1024)
CHANNELS, SYMBOLS = 256, 4096
LINK_FRAMES, LINK_SNR_DB = 256, 3.0
SEED = 67


def run_one(tree: pathlib.Path, reps: int) -> dict:
    """Every measurement on ``tree``'s package; the JSON line's dict."""
    sys.path.insert(0, str(tree))
    import torch

    import modem_tpu_torch
    from modem_tpu_torch import Rates, cuda, presets, qpsk_reference_chain
    from modem_tpu_torch.fec import PolarCode, crc16_ccitt
    from modem_tpu_torch.ops import (chain_kernel as ck, sc_kernel as sk,
                                     scl_kernel as lk, txrx)

    pkg = pathlib.Path(modem_tpu_torch.__file__).resolve().parent
    assert pkg.parent == tree.resolve(), f"{pkg} is not {tree}'s package"
    sm = smoke()
    device = torch.device("cuda", 0)
    cuda.library()
    res = {"tree": str(tree)}

    def dev_ms(fn, args, symbol):
        return [sm.kernel_device_ms(fn, args, device, symbol)
                for _ in range(reps)]

    code, crc = PolarCode(POLAR_N, POLAR_K), crc16_ccitt()
    for cws in CODEWORDS:
        _, lam = sm.polar_llrs(code, crc, cws, SIGMA, SEED, device)
        u, pm = lk.scl_kernel(code, lam)
        pu, ppm = lk.scl_plain(code, lam)
        res[f"k16_x{cws}_exact"] = bool(torch.equal(u, pu)
                                        and torch.equal(pm, ppm))
        res[f"k16_x{cws}_device_ms"] = dev_ms(lk.scl_kernel, (code, lam),
                                              "scl_kernel")
        if cws == CODEWORDS[0]:
            res[f"k15_x{cws}_device_ms"] = dev_ms(sk.sc_kernel, (code, lam),
                                                  "sc_kernel")

    chain = qpsk_reference_chain(Rates(1250, 10000), device=device)
    syms = sm.random_symbols((CHANNELS, SYMBOLS), device, False)
    lut, taps = chain.lut, chain.rrc
    res["k1_device_ms"] = dev_ms(ck.chain_kernel, (syms, lut, taps, 8, 8),
                                 "pulse_chain_kernel")
    wi, wq = txrx.tx_plain(syms, lut, taps, 8, 8)
    for tag, soft in (("k3_hard", False), ("k3_soft", True)):
        res[f"{tag}_device_ms"] = dev_ms(
            txrx.rx_kernel, (wi, wq, SYMBOLS, lut, taps, 8, 8, soft),
            sm.DEVICE_NAMES["fused_rx_soft" if soft else "fused_rx"])

    link = presets.nr_like_control_link(device=device)
    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    pay = torch.randint(0, 2, (LINK_FRAMES, link.payload_bits), generator=gen,
                        device=device, dtype=torch.int32)
    wave, nv = sm.link_noise(gen, link.tx_fused(pay), LINK_SNR_DB)
    res["link_rx_fused_ms"] = event_ms(link.rx_fused, (wave, nv), 3, reps)
    res["link_rx_fused_k16_ms"], res["link_rx_fused_other_ms"] = busy_ms(
        link.rx_fused, (wave, nv), "scl_kernel")
    got, ok = link.rx_fused(wave, nv)[:2]
    res["link_crc_ok"] = int(ok.sum())
    res["link_payload_exact"] = bool(torch.equal(got.to(torch.int32), pay))
    return res


if __name__ == "__main__":
    sys.exit(alternate(pathlib.Path(__file__).resolve(), __doc__, run_one,
                       rounds=1, reps=5))
