#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``modem_tpu_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

It drives the flagship QPSK chain through the port's public entry points at
``bench.py``'s geometry (``Rates(1250, 10000)``: sps 8, span 8, beta 0.35;
256 channels x 4096 symbols per block), one phase per line:

1. device: name, ``nvidia-smi`` name and power limit, TF32 off;
2. build: ``nvcc`` compiles ``modem_tpu_torch/csrc`` (seconds, ptxas counts);
3. kernel vs plain: each kernel (K1 loopback, K2 TX, K3 RX hard and soft)
   against its plain PyTorch version on the card, at a small shape with
   stream sentinels and at the flagship shape: decisions equal, waveforms
   and soft points within 1e-5 (``nvcc`` contracts to FMA, the plain
   version does not);
4. main path: ``roundtrip_fused``, ``tx_fused`` -> ``rx_fused``,
   ``rx_soft_fused`` and the three streaming classes over 4 pushes give the
   bits back exactly, with every kernel's launch count advanced;
5. noise: staged TX + seeded Gaussian noise at Es/N0 = 7 dB + ``rx_fused``
   over >= 4 M bits, BER within 10% of the QPSK closed form;
6. times: each kernel and its plain version per call, CUDA events, median
   of 5 runs of 20 calls after warm-up, in complex samples/s; and the
   kernel's own device time from ``torch.profiler``; and per call of the
   chain's ``roundtrip_fused``, ``tx_fused`` and ``rx_fused``, bits included.

Then a JSON line of the kernels, the card's name and power limit, and last
``{"ok": true, "device": {...}}``. Any failure exits non-zero before that
line; without a CUDA device it exits non-zero at once.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import torch

CHANNELS, N_SYMBOLS = 256, 4096  # bench.py's flagship block
SMALL = (3, 500)                 # the CPU tests' shape
N_PUSH = 4
ES_N0_DB = 7.0
NOISE_BLOCKS = 2                 # 2 x 256 x 4096 x 2 = 4.19 M bits
BER_RTOL = 0.10
ATOL = 1e-5
SEED = 0


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def max_err(a, b) -> float:
    if isinstance(a, tuple):
        return max(max_err(x, y) for x, y in zip(a, b))
    if a.shape != b.shape:
        fail(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if not torch.isfinite(a.float()).all():
        fail("non-finite kernel output")
    return float((a.double() - b.double()).abs().max())


def kernel_cases(chain):
    """(name, launch counter, kernel fn, plain fn, make_args, exact,
    source, replaced TPU kernel) for each kernel; make_args takes
    symbols [C, K] int32 to the functions' positional args."""
    from modem_tpu_torch.ops import chain_kernel as ck, txrx

    lut, taps, sps, span = chain.lut, chain.rrc, chain.sps, chain.span

    def tx_args(syms):
        return (syms, lut, taps, sps, span)

    def rx_args(syms, soft):
        wi, wq = txrx.tx_plain(syms, lut, taps, sps, span)
        if soft:  # off-grid points exercise the soft values
            g = torch.Generator(device=syms.device).manual_seed(SEED + 1)
            wi = wi + 0.3 * torch.randn(wi.shape, generator=g, device=wi.device)
            wq = wq + 0.3 * torch.randn(wq.shape, generator=g, device=wq.device)
        return (wi, wq, syms.shape[-1], lut, taps, sps, span, soft)

    return [
        ("fused_pulse_chain", ck.CHAIN_KERNEL, ck.chain_kernel, ck.chain_plain,
         tx_args, True, "modem_tpu_torch/csrc/chain.cu",
         "modem_tpu/ops/pallas_chain.py:195"),
        ("fused_tx", txrx.TX_KERNEL, txrx.tx_kernel, txrx.tx_plain,
         tx_args, False, "modem_tpu_torch/csrc/txrx.cu",
         "modem_tpu/ops/pallas_txrx.py:61"),
        ("fused_rx", txrx.RX_HARD_KERNEL, txrx.rx_kernel, txrx.rx_plain,
         lambda s: rx_args(s, False), True, "modem_tpu_torch/csrc/txrx.cu",
         "modem_tpu/ops/pallas_txrx.py:277"),
        ("fused_rx_soft", txrx.RX_SOFT_KERNEL, txrx.rx_kernel, txrx.rx_plain,
         lambda s: rx_args(s, True), False, "modem_tpu_torch/csrc/txrx.cu",
         "modem_tpu/ops/pallas_txrx.py:277"),
    ]


def random_symbols(shape, device, sentinels: bool):
    g = torch.Generator(device=device).manual_seed(SEED)
    syms = torch.randint(0, 4, shape, generator=g, device=device,
                         dtype=torch.int32)
    if sentinels:  # as the streaming loopback builds its first block
        syms[0, :16] = -1
        syms[-1, -5:] = -1
    return syms


def phase_kernels(chain, device) -> dict:
    """Phase 3: each kernel vs its plain version; returns the flagship
    max |error| per kernel."""
    errs = {}
    for shape, sentinels in ((SMALL, True), ((CHANNELS, N_SYMBOLS), False)):
        syms = random_symbols(shape, device, sentinels)
        for name, _, kern, plain, make_args, exact, _, _ in kernel_cases(chain):
            args = make_args(syms)
            got, want = kern(*args), plain(*args)
            torch.cuda.synchronize(device)
            if exact:  # decisions: a position without a symbol decides nothing
                real = syms >= 0
                got, want = got[real], want[real]
            err = max_err(got, want)
            if (exact and err != 0) or err > ATOL:
                fail(f"{name} at {shape}: kernel vs plain max |err| {err}")
            errs[name] = err
            print(f"[kernels] {name:18s} {shape[0]:4d} ch x {shape[1]:5d} sym: "
                  f"max |kernel - plain| = {err:.3e} "
                  f"({'exact' if exact else f'tol {ATOL}'})", flush=True)
    return errs


def phase_main_path(chain, device) -> dict:
    """Phase 4: the port's fused surfaces at the flagship size; returns the
    launch count of each kernel in this phase."""
    from modem_tpu_torch import (StreamingFusedChain, StreamingFusedRx,
                                 StreamingFusedTx)
    from modem_tpu_torch.ops.llr import llr_hard_bits

    g = torch.Generator(device=device).manual_seed(SEED + 2)
    bps = chain.bits_per_symbol
    bits = torch.randint(0, 2, (CHANNELS, N_SYMBOLS * bps), generator=g,
                         device=device, dtype=torch.int32)
    kernels = {c[0]: c[1] for c in kernel_cases(chain)}
    for k in kernels.values():
        k.launches = 0

    def same(name, got, want):
        if got.shape != want.shape or not torch.equal(got, want):
            fail(f"main path: {name} differs")
        print(f"[main] {name}: equal, shape {tuple(got.shape)}", flush=True)

    same("roundtrip_fused(bits) == bits", chain.roundtrip_fused(bits), bits)
    wave = chain.tx_fused(bits)
    same("rx_fused(tx_fused(bits)) == bits", chain.rx_fused(wave, N_SYMBOLS),
         bits)
    llr = chain.rx_soft_fused(wave, N_SYMBOLS, noise_var=0.5)
    if not torch.isfinite(llr).all():
        fail("non-finite LLRs")
    same("hard bits of rx_soft_fused == bits", llr_hard_bits(llr), bits)

    step = N_SYMBOLS // N_PUSH
    sc = StreamingFusedChain(chain, (CHANNELS,))
    out = [sc.push(bits[:, i * step * bps:(i + 1) * step * bps])
           for i in range(N_PUSH)] + [sc.flush()]
    same("StreamingFusedChain x4 == bits", torch.cat(out, dim=-1), bits)
    st = StreamingFusedTx(chain, (CHANNELS,))
    parts = [st.push(bits[:, i * step * bps:(i + 1) * step * bps])
             for i in range(N_PUSH)] + [st.flush()]
    for r, name in enumerate("iq"):
        same(f"StreamingFusedTx x4 == tx_fused ({name})",
             torch.cat([p[r] for p in parts], dim=-1), wave[r])
    sr = StreamingFusedRx(chain, (CHANNELS,))
    n_step = step * chain.sps
    cuts = [i * n_step for i in range(N_PUSH)] + [N_PUSH * n_step,
                                                  wave[0].shape[-1]]
    out = [sr.push((wave[0][:, a:b], wave[1][:, a:b]))
           for a, b in zip(cuts[:-1], cuts[1:])]
    same("StreamingFusedRx x4 == bits", torch.cat(out, dim=-1), bits)
    torch.cuda.synchronize(device)

    launches = {name: k.launches for name, k in kernels.items()}
    print(f"[main] launches: {json.dumps(launches)}", flush=True)
    for name, n in launches.items():
        if n == 0:
            fail(f"main path never launched the {name} kernel")
    return launches


def phase_noise(chain, device) -> None:
    """Phase 5: BER through rx_fused against the closed form."""
    g = torch.Generator(device=device).manual_seed(SEED + 3)
    bps = chain.bits_per_symbol
    es = float(torch.mean(torch.sum(chain.lut * chain.lut, dim=-1)))
    sigma = math.sqrt(es / (2.0 * 10.0 ** (ES_N0_DB / 10.0)))
    errors = total = 0
    for _ in range(NOISE_BLOCKS):
        bits = torch.randint(0, 2, (CHANNELS, N_SYMBOLS * bps), generator=g,
                             device=device, dtype=torch.int32)
        wi, wq = chain.tx(bits)
        wi = wi + sigma * torch.randn(wi.shape, generator=g, device=device)
        wq = wq + sigma * torch.randn(wq.shape, generator=g, device=device)
        out = chain.rx_fused((wi, wq), N_SYMBOLS)
        errors += int(torch.sum(out != bits))
        total += bits.numel()
    ber = errors / total
    # QPSK: Q(sqrt(2 Eb/N0)) with Eb = Es/2, i.e. Q(sqrt(Es/N0))
    theory = 0.5 * math.erfc(math.sqrt(10.0 ** (ES_N0_DB / 10.0)) / math.sqrt(2.0))
    print(f"[noise] Es/N0 {ES_N0_DB} dB (Eb/N0 {ES_N0_DB - 10 * math.log10(2):.3f}"
          f" dB): BER {ber:.6e} over {total} bits ({errors} errors), "
          f"closed form {theory:.6e}, ratio {ber / theory:.4f}", flush=True)
    if abs(ber / theory - 1.0) > BER_RTOL:
        fail(f"BER {ber} vs closed form {theory} beyond {BER_RTOL:.0%}")


def time_calls(fn, args, device, calls=20, reps=5) -> float:
    """Median over ``reps`` of CUDA-event time per call of ``calls``
    back-to-back calls, in ms, after two warm-up calls."""
    for _ in range(2):
        fn(*args)
    torch.cuda.synchronize(device)
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn(*args)
        end.record()
        torch.cuda.synchronize(device)
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def kernel_device_ms(fn, args, device, symbol: str, calls=20):
    """Device time per launch of the CUDA kernel whose name contains
    ``symbol``, from ``torch.profiler``; None if the trace has none."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn(*args)
        torch.cuda.synchronize(device)
    for evt in prof.key_averages():
        if symbol in evt.key and evt.count:
            total = getattr(evt, "device_time_total", None)
            if total is None:
                total = evt.cuda_time_total
            return total / evt.count / 1e3
    return None


#: substring of each kernel's name in a profiler trace
DEVICE_NAMES = {"fused_pulse_chain": "chain_lut_kernel",
                "fused_tx": "tx_lut_kernel",
                "fused_rx": "rx_lut_kernel<false>",
                "fused_rx_soft": "rx_lut_kernel<true>"}


def phase_times(chain, device, card: str) -> dict:
    """Phase 6: kernel and plain time per call at the flagship shape."""
    syms = random_symbols((CHANNELS, N_SYMBOLS), device, False)
    samples = CHANNELS * N_SYMBOLS * chain.sps
    times = {}
    for name, _, kern, plain, make_args, _, _, _ in kernel_cases(chain):
        args = make_args(syms)
        # plain, kernel, kernel, plain: each number is the mean of its pair
        p1 = time_calls(plain, args, device)
        k1 = time_calls(kern, args, device)
        k2 = time_calls(kern, args, device)
        p2 = time_calls(plain, args, device)
        ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
        dev_ms = kernel_device_ms(kern, args, device, DEVICE_NAMES[name])
        times[name] = (ms, plain_ms)
        dev_txt = ("not measured" if dev_ms is None else
                   f"{dev_ms:.4f} ms ({samples / dev_ms * 1e3:.4e} samples/s)")
        print(f"[times] {name:18s} per call: kernel {ms:.4f} ms "
              f"({samples / ms * 1e3:.4e} samples/s), plain {plain_ms:.4f} ms "
              f"({samples / plain_ms * 1e3:.4e} samples/s); kernel alone in "
              f"the profiler {dev_txt}; {CHANNELS} ch x {N_SYMBOLS} sym x "
              f"sps {chain.sps} on {card}", flush=True)
    # the fused surfaces bits -> bits / bits -> waveform -> bits, glue
    # (bit packing, unpacking) included
    g = torch.Generator(device=device).manual_seed(SEED + 4)
    bits = torch.randint(0, 2, (CHANNELS, N_SYMBOLS * chain.bits_per_symbol),
                         generator=g, device=device, dtype=torch.int32)
    wave = chain.tx_fused(bits)
    for name, fn, args in (
            ("roundtrip_fused", chain.roundtrip_fused, (bits,)),
            ("tx_fused", chain.tx_fused, (bits,)),
            ("rx_fused", chain.rx_fused, (wave, N_SYMBOLS))):
        ms = time_calls(fn, args, device)
        print(f"[times] chain.{name:16s} per call {ms:.4f} ms "
              f"({samples / ms * 1e3:.4e} samples/s) on {card}", flush=True)
    return times


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(device)
    card = card_line()
    print(f"[device] {name}; nvidia-smi: {card}; TF32 off", flush=True)

    from modem_tpu_torch import Rates, cuda, qpsk_reference_chain

    t0 = time.perf_counter()
    so = cuda.build_library()
    cuda.library()
    print(f"[build] {so.name} in {time.perf_counter() - t0:.2f} s", flush=True)
    for line in so.with_suffix(".log").read_text().splitlines():
        if "Compiling entry" in line or "registers" in line:
            print(f"[build] {line.strip()}", flush=True)

    chain = qpsk_reference_chain(Rates(1250, 10000), device=device)
    errs = phase_kernels(chain, device)
    launches = phase_main_path(chain, device)
    phase_noise(chain, device)
    times = phase_times(chain, device, card)

    report = {"kernels": [
        {"name": n, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[n], "max_abs_err": errs[n],
         "ms": times[n][0], "plain_ms": times[n][1]}
        for n, _, _, _, _, _, src, rep in kernel_cases(chain)]}
    print(json.dumps(report))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
