"""Times the PyTorch port's K4 (causal FIR), K5 (product detector) and the
reference demodulator's entry points on one CUDA card, alternating between
source trees in one run, and checks that every tree gives the same bits.

    python3 bench_demod_torch.py [--trees DIR ...] [--rounds N] [--reps N]

Each tree is a checkout of the repo (``git archive`` of another commit,
unpacked into a git-ignored directory); the default is this one. A round
runs every tree in a fresh process, in order and then in reverse (two trees:
A B B A), so that the card's drift falls on each alike. Each process builds
its tree's kernels (``build_s``: the seconds it took, near 0 where an
earlier process of the tree built them), then at ``bench_demod.py``'s demod
bank (256 channels x 32768 samples, carrier 2000 Hz at 10000) measures the
profiler's device time per launch of:

- K4 (``fir_kernel``) at 23 taps (the Hilbert filter), 32, 64 (the
  demodulator's lowpass), 65 (the flagship's RRC), 7 and 256 (the generic
  instantiation) and 257, 1000 and 4096 (the long route), with a carried
  state; on the long route also its first version (``first_*``: in a tree
  whose ``fir_kernel`` takes ``first=``, forced by it; in one without, the
  long route itself, which is then the first version); the long route at
  256 taps (``k4_256_long``: the taps from the device, as the long route
  takes them) beside the short route's generic form; and at 1000 taps on
  198 channels (``k4_1000_198ch``: 1584 tiles of 4096 outputs, three for
  each of the 528 blocks the long core runs four to an SM, where 256
  channels give 2048, 3.88 a block);
- K5 (``demod_kernel``) with the 64-tap lowpass at 2000 Hz (a table of 5
  carrier phases) and at 2001 Hz of 10007 (10007 phases: no table);

and ``Demodulator.demodulate`` (K4 twice) with its 64-tap lowpass and with
257- and 1000-tap ones (``chip_smoke.windowed_lowpass``; the long route),
and ``demodulate_fused`` (K5), on a locked QPSK passband block
(``chip_smoke.py``'s reference path: 32783 samples a row after the 64 of the
lock, so most rows start off a 16-byte boundary): CUDA-event
time per call (10 calls a rep) and, from one profile of 3 calls, the device's
busy time per call split into K4's or K5's and every other kernel's and
copy's. Each case also hashes its output bytes (``*_sha``), and so do K4 on
short and misaligned rows (1, 5, 5001 and 40001 samples) and K5 with 65 and
23 taps: the run fails unless every process of every tree gives the same
hashes, so a change that claims the parent's bits is held to them.

Each process also counts, from ``cuobjdump -sass`` of its build, the
instructions of K4's long-route kernels (``sass_<kernel>``: all of them,
the local-memory loads and stores, and in the innermost loop that issues
the most FFMAs each opcode's count). Each process prints one JSON line of
its reps; the run ends with each
metric's summary over the processes of each tree, then the card's name and
power limit (``bench_turbo_torch.py``'s ``alternate``, whose timers it
shares). Needs a CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import hashlib
import inspect
import math
import os
import pathlib
import re
import shutil
import subprocess
import sys
import time

from bench_turbo_torch import alternate, busy_ms, event_ms, smoke

CHANNELS, SAMPLES, HIST = 256, 32768, 63
FIR_TAPS = (23, 32, 64, 65, 7, 256, 257, 1000, 4096)
LONG_LOWPASS = (257, 1000)       # demodulate's long-route lowpasses
#: K4's long-route kernels whose SASS is counted
SASS_KERNELS = ("fir_long_core", "fir_long_kernel")
FIR_ROWS = ((3, 1), (2, 5), (3, 5001), (64, 40001))
CARRIERS = ((2000, 10000), (2001, 10007))
SEED = 68


def sha(out) -> str:
    """The first 16 hex digits of the SHA-256 of the output's bytes."""
    import torch

    if isinstance(out, tuple):
        out = torch.stack([o.reshape(-1) for o in out])
    raw = out.detach().cpu().numpy().tobytes()
    return hashlib.sha256(raw).hexdigest()[:16]


def loop_counts(so: pathlib.Path) -> dict:
    """From ``cuobjdump -sass`` of ``so``, for each of SASS_KERNELS present:
    its instruction count, its local-memory loads and stores (``LDL``,
    ``STL``), and each opcode's count in its innermost loop (a backward
    branch with no other inside its range) that holds the most FFMAs."""
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    tool = shutil.which("cuobjdump") or str(pathlib.Path(home) / "bin" /
                                            "cuobjdump")
    text = subprocess.run([tool, "-sass", str(so)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    code, name = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            name = next((k for k in SASS_KERNELS if k in line), None)
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if name and m:
            code.setdefault(name, []).append((int(m.group(1), 16),
                                              m.group(2)))
    out = {}
    for name, ins in code.items():
        def op(text):
            return re.sub(r"^@!?U?P\w+\s+", "", text).split(" ")[0]

        loops = []
        for addr, text in ins:
            b = re.search(r"\bBRA\S*\s+.*?(0x[0-9a-f]+)", text)
            if b and int(b.group(1), 16) < addr:
                loops.append((int(b.group(1), 16), addr))
        inner = [(a, b) for a, b in loops
                 if not any(a <= c < b and (c, d) != (a, b)
                            for c, d in loops if a <= d < b)]
        best = {}
        for a, b in inner:
            ops = {}
            for addr, text in ins:
                if a <= addr <= b:
                    o = op(text)
                    ops[o] = ops.get(o, 0) + 1
            if ops.get("FFMA", 0) > best.get("FFMA", 0):
                best = ops
        n = sum(best.values())
        out[name] = {
            "n": len(ins),
            "LDL": sum(op(t).startswith("LDL") for _, t in ins),
            "STL": sum(op(t).startswith("STL") for _, t in ins),
            "loop": dict(sorted(best.items(), key=lambda kv: -kv[1])),
            "loop_ffma_share": best.get("FFMA", 0) / n if n else None}
    return out


def run_one(tree: pathlib.Path, reps: int) -> dict:
    """Every measurement on ``tree``'s package; the JSON line's dict."""
    sys.path.insert(0, str(tree))
    import numpy as np
    import torch

    import modem_tpu_torch
    from modem_tpu_torch import Demodulator, cuda
    from modem_tpu_torch.ops import demod_kernel as dk, filters, fir

    pkg = pathlib.Path(modem_tpu_torch.__file__).resolve().parent
    assert pkg.parent == tree.resolve(), f"{pkg} is not {tree}'s package"
    sm = smoke()
    device = torch.device("cuda", 0)
    t0 = time.perf_counter()
    so = cuda.build_library()
    res = {"tree": str(tree), "build_s": time.perf_counter() - t0}
    cuda.library()
    res["sass"] = loop_counts(so)
    forced = "first" in inspect.signature(fir.fir_kernel).parameters

    def first(*args):  # the long route's first version
        return fir.fir_kernel(*args, first=True) if forced else \
            fir.fir_kernel(*args)

    def long_route(x, taps, state):  # the taps from the device at any count
        y = torch.empty_like(x)
        fir.FIR_KERNEL.launch(device, x.data_ptr(), state.data_ptr(),
                              x.shape[0], x.shape[1], None, taps.data_ptr(),
                              taps.shape[0], y.data_ptr())
        return y

    rng = np.random.default_rng(SEED)

    def unit(*shape):
        return torch.as_tensor(rng.uniform(-1, 1, shape).astype(np.float32),
                               device=device)

    def dev_ms(fn, args, symbol):
        return [sm.kernel_device_ms(fn, args, device, symbol)
                for _ in range(reps)]

    path_taps = {23: filters.hilbert_taps(),
                 64: filters.lowpass_taps(sample_rate=10000),
                 65: filters.rrc_taps(8, 8, 0.35)}
    x = unit(CHANNELS, SAMPLES)
    for k in FIR_TAPS:
        taps = (torch.as_tensor(path_taps[k], device=device) if k in path_taps
                else unit(k) / math.sqrt(k))
        args = (x, taps, unit(CHANNELS, k - 1))
        res[f"k4_{k}_sha"] = sha(fir.fir_kernel(*args))
        res[f"k4_{k}_device_ms"] = dev_ms(fir.fir_kernel, args, "fir_")
        if k > 256:
            res[f"k4_{k}_first_sha"] = sha(first(*args))
            res[f"k4_{k}_first_device_ms"] = dev_ms(first, args,
                                                    "fir_long_kernel")
        for c, n in FIR_ROWS:
            res[f"k4_{k}_{c}x{n}_sha"] = sha(fir.fir_kernel(
                unit(c, n), taps, unit(c, k - 1)))
        if k == 256:
            res["k4_256_long_sha"] = sha(long_route(*args))
            res["k4_256_long_device_ms"] = dev_ms(long_route, args,
                                                  "fir_long")
        if k == 1000:
            part = (x[:198], taps, args[2][:198].contiguous())
            res["k4_1000_198ch_sha"] = sha(fir.fir_kernel(*part))
            res["k4_1000_198ch_device_ms"] = dev_ms(fir.fir_kernel, part,
                                                    "fir_")

    lowpass = torch.as_tensor(path_taps[64], device=device)
    phi = unit(CHANNELS) * math.pi
    off = torch.tensor(9971, dtype=torch.int32, device=device)
    hist = unit(CHANNELS, HIST)
    for hz, sr in CARRIERS:
        args = (x, hist, lowpass, hz, sr, off, phi)
        res[f"k5_{hz}_{sr}_sha"] = sha(dk.demod_kernel(*args))
        res[f"k5_{hz}_{sr}_device_ms"] = dev_ms(dk.demod_kernel, args,
                                                "demod_kernel")
        for k in (65, 23):
            taps = unit(k) / math.sqrt(k)
            res[f"k5_{hz}_{sr}_{k}taps_sha"] = sha(dk.demod_kernel(
                x[:8], unit(8, k - 1), taps, hz, sr, off, phi[:8]))

    g = torch.Generator(device=device).manual_seed(SEED)
    _, dem, wave, locked, _, _ = sm.reference_path(device,
                                                   sm.ref_bits(g, device))
    rest = wave[:, 64:].contiguous()
    cases = [("demodulate", dem.demodulate, locked, "fir_"),
             ("demodulate_fused", dem.demodulate_fused, locked,
              "demod_kernel")]
    for k in LONG_LOWPASS:
        d = Demodulator(2000, 10000, lowpass=sm.windowed_lowpass(k),
                        device=device)
        st = d.lock_phase(wave[:, :64], d.init_state((CHANNELS,)))
        cases.append((f"demodulate_{k}", d.demodulate, st, "fir_"))
    for tag, fn, locked, symbol in cases:
        res[f"{tag}_sha"] = sha(fn(rest, locked)[0])
        res[f"{tag}_ms"] = event_ms(fn, (rest, locked), 10, reps)
        res[f"{tag}_kernel_ms"], res[f"{tag}_other_ms"] = busy_ms(
            fn, (rest, locked), symbol)
    return res


if __name__ == "__main__":
    sys.exit(alternate(pathlib.Path(__file__).resolve(), __doc__, run_one,
                       rounds=1, reps=5))
