"""Times the PyTorch port's FSK/MSK kernels (K6 and K7, the loopbacks; K8
and K10, the TX; K9) and the loopbacks' and TX's entry points on one CUDA
card, alternating between source trees in one run, and checks that every
tree gives the same decisions and waveforms.

    python3 bench_fsk_torch.py [--trees DIR ...] [--rounds N] [--reps N]

Each tree is a checkout of the repo (``git archive`` of another commit,
unpacked into a git-ignored directory); the default is this one. A round
runs every tree in a fresh process, in order and then in reverse (two trees:
A B B A), so that the card's drift falls on each alike. Each process builds
its tree's kernels (``build_s``), counts the SASS instructions of every
kernel of ``csrc/fsk.cu`` (``cuobjdump -sass``: ``sass``, each
instantiation's count and its counts of the opcodes OPCODES, by its mangled
name from the kernel's name on; ``ptxas``, their registers and spills),
then at config #3's block (``bench_oneway.py``: 256 channels x 4096
symbols, ``Rates(1250, 10000)``, sps 8; MSK 8192 slots of spb 4) measures
the profiler's device time per launch, on ``chip_smoke.py``'s inputs
(``fsk_kernel_cases``, ``msk_cases``), of:

- K6 (the kernel named ``fsk_chain_...``, either route) without and with
  noise (16-MFSK at 21 dB, tiles of 256 symbols), and at a den past the
  core's cap (``fused_fsk_chain_long``: ``chip_smoke.far_chains``' 16-MFSK
  at ``Rates(2500, 20000)``, the long route); K7 (``msk_chain_...``)
  without and with noise (7 dB), and past the core's cap
  (``fused_msk_slots_long``: MSK at spb 100, 256 x 2048 slots); in a tree
  whose ``ops.fsk_kernel`` has ``_fsk_launch``, the core's cases also on
  the long route at the same inputs (``*_long_route_device_ms``, whose
  decisions must equal the core's), and K6's tone table kernel once
  (``tone_table_device_ms``);
- K8 and K10 (either route: the kernels named ``fsk_tx_...`` and
  ``msk_tx_...``), and past their cores' caps (``fused_fsk_tx_long``: den
  20000; ``fused_msk_tx_long``: spb 100, 256 x 2048 slots); in a tree whose
  ``ops.fsk_kernel`` has ``_fsk_tx_launch``, the core's cases also on the
  long route (``*_long_route_device_ms``, whose waveforms must equal the
  core's); beside each, one ``fill_`` of its two output planes
  (``*_fill_device_ms``), the write stream's ceiling; K9 (groups 8 and 4);
- wall time (CUDA events, 10 calls a rep) and, from one profile of 10
  calls, the device's busy time per call split into K6's or K7's and every
  other kernel's and copy's, of ``FskChain.roundtrip_fused`` (16-MFSK,
  without noise and at 21 dB), ``MskChain.roundtrip_fused`` (without
  noise and at 7 dB), and ``FskChain.tx_fused`` and ``MskChain.tx_fused``
  (the busy time split into K8's or K10's and the rest's); in a tree with
  the tone table, its launches over 10 calls after the first
  (``tone_launches_per_10_calls``: 0, the table is made once).

Every decision and waveform is hashed (``*_sha``), also at
``chip_smoke.py``'s odd cases: ``fsk_odd_cases`` and ``msk_odd_cases``,
16-MFSK with the ``increase`` and ``default`` maps and BFSK at sps 2, 8 and
16 with guard 1, sps/2 and sps - 1, MSK at spb 2, 4 and 8 with guard 1 and
spb - 1, without noise and with noise in tiles of 32 and 256, at 130 x 600
(two 128-lane keys of the noise stream) and at 7 x 603 (rows not a whole
number of runs, most off a 16-byte boundary); ``tx_odd_cases``, K8 (16-MFSK
with both maps, BFSK, CPFSK) and K10 (spb 2, 3, 4 and 8) at rows of 1, 3
and 603, 7 and 130 of them, and 256 x 4096. The run fails unless every
process of every tree gives the same hashes, so a change that claims the
parent's bits is held to them.

Each process prints one JSON line of its reps; the run ends with each
metric's summary over the processes of each tree, then the card's name and
power limit (``bench_turbo_torch.py``'s ``alternate``, whose timers it
shares). Needs a CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import os
import pathlib
import re
import shutil
import subprocess
import sys
import time

from bench_demod_torch import sha
from bench_turbo_torch import alternate, busy_ms, event_ms, smoke

CHANNELS, SYMBOLS = 256, 4096
SR = 10000
#: csrc/fsk.cu's kernels, whose SASS is counted
SASS = ("fsk_chain_core", "msk_chain_core", "fsk_tone_kernel", "fsk_tx_core",
        "msk_tx_core", "fsk_chain_kernel", "msk_chain_kernel", "fsk_tx_kernel",
        "msk_tx_kernel", "disc_means_kernel")
#: the opcodes counted in each
OPCODES = ("FFMA", "FMUL", "FADD", "MUFU", "LDS", "LDG", "STG", "LDC", "IMAD",
           "IADD3", "ISETP", "FSETP", "SEL", "FSEL", "BRA", "CALL", "BAR",
           "LDGSTS", "I2F", "F2I")
SEED = 71


def sass_counts(so: pathlib.Path) -> dict:
    """From ``cuobjdump -sass`` of ``so``: each instantiation of SASS's
    kernels (by its mangled name from the kernel's name on) with its
    instruction count ``n`` and its counts of OPCODES."""
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    tool = shutil.which("cuobjdump") or str(pathlib.Path(home) / "bin" /
                                            "cuobjdump")
    text = subprocess.run([tool, "-sass", str(so)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    out, fn = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            name = next((k for k in SASS if k in line), None)
            fn = line[line.index(name):].strip() if name else None
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
        if not (fn and m):
            continue
        op = re.sub(r"^@!?U?P\w+\s+", "", m.group(1)).split(" ")[0]
        c = out.setdefault(fn, {"n": 0})
        c["n"] += 1
        base = op.split(".")[0]
        if base in OPCODES:
            c[base] = c.get(base, 0) + 1
    return out


def ptxas_lines(so: pathlib.Path) -> list[str]:
    """ptxas's registers, spills and shared memory of SASS's kernels."""
    lines, keep = [], False
    for line in so.with_suffix(".log").read_text().splitlines():
        if "Compiling entry" in line:
            keep = any(k in line for k in SASS)
        if keep and ("registers" in line or "spill" in line
                     or "Compiling entry" in line):
            lines.append(line.strip())
    return lines


def run_one(tree: pathlib.Path, reps: int) -> dict:
    """Every measurement on ``tree``'s package; the JSON line's dict."""
    sys.path.insert(0, str(tree))
    import torch

    import modem_tpu_torch
    from modem_tpu_torch import cuda
    from modem_tpu_torch.models.base import f32
    from modem_tpu_torch.ops import fsk_kernel as fk

    pkg = pathlib.Path(modem_tpu_torch.__file__).resolve().parent
    assert pkg.parent == tree.resolve(), f"{pkg} is not {tree}'s package"
    sm = smoke()
    device = torch.device("cuda", 0)
    t0 = time.perf_counter()
    so = cuda.build_library()
    res = {"tree": str(tree), "build_s": time.perf_counter() - t0}
    cuda.library()
    res["sass"] = sass_counts(so)
    res["ptxas"] = ptxas_lines(so)
    has_core = hasattr(fk, "_fsk_launch")

    def dev_ms(fn, args, symbol):
        return [sm.kernel_device_ms(fn, args, device, symbol)
                for _ in range(reps)]

    # each kernel's long route, where the tree has a core beside it
    long_routes = {}
    if has_core:
        long_routes["fused_fsk_chain"] = lambda *a: fk._fsk_launch(*a,
                                                                   tone=None)
        long_routes["fused_msk_slots"] = lambda *a: fk._msk_launch(*a,
                                                                   core=False)
    if hasattr(fk, "_fsk_tx_launch"):
        long_routes["fused_fsk_tx"] = lambda *a: fk._fsk_tx_launch(*a,
                                                                   tone=None)
        long_routes["fused_msk_tx"] = lambda *a: fk._msk_tx_launch(*a,
                                                                   core=False)

    mfsk, _, msk, _ = sm.fsk_chains(device)
    _, cases = sm.fsk_kernel_cases(mfsk, msk, device)
    cases = [(n, k, a) for n, k, _, a, _ in cases] + [
        (n, fk.msk_chain_kernel, a) for n, a in sm.msk_cases(
            msk, (CHANNELS, 2 * SYMBOLS), 256, device, SEED)]
    symbols = {"fused_fsk_chain": "fsk_chain_",
               "fused_msk_slots": "msk_chain_",
               "fused_fsk_tx": "fsk_tx_",
               "fused_discriminator_means": "disc_means_kernel",
               "fused_msk_tx": "msk_tx_"}
    for name, kern, args in cases:
        symbol = next(v for k, v in symbols.items() if name.startswith(k))
        res[f"{name}_sha"] = sha(kern(*args))
        res[f"{name}_device_ms"] = dev_ms(kern, args, symbol)
        if name in ("fused_fsk_tx", "fused_msk_tx"):
            planes = torch.empty((2, sm.tx_samples(args)), device=device)
            res[f"{name}_fill_device_ms"] = dev_ms(
                lambda: planes.fill_(1.0), (), "FillFunctor")
        long = next((v for k, v in long_routes.items()
                     if name.startswith(k)), None)
        if long is not None and not name.endswith("_long"):
            if sha(long(*args)) != res[f"{name}_sha"]:
                raise SystemExit(f"bench_fsk_torch: {name}: the routes "
                                 "differ")
            res[f"{name}_long_route_device_ms"] = dev_ms(long, args, symbol)
    if has_core:
        qshift = f32(cases[0][2][6])
        fk.tone_table_kernel(SR, 1.0, qshift, device)  # built and loaded
        res["tone_table_device_ms"] = dev_ms(
            fk.tone_table_kernel, (SR, 1.0, qshift, device), "fsk_tone_kernel")

    for label, args in sm.fsk_odd_cases(device, SEED):
        res[f"odd {label}_sha"] = sha(fk.fsk_chain_kernel(*args))
    for label, args in sm.msk_odd_cases(device, SEED):
        res[f"odd {label}_sha"] = sha(fk.msk_chain_kernel(*args))
    tx = {"K8": fk.fused_fsk_tx, "K10": fk.fused_msk_tx}
    for kind, label, args in sm.tx_odd_cases(device, SEED):
        res[f"odd {label}_sha"] = sha(tx[kind](*args))

    g = torch.Generator(device=device).manual_seed(SEED + 2)
    bits = torch.randint(0, 2, (CHANNELS, SYMBOLS * 4), generator=g,
                         device=device, dtype=torch.int32)
    mbits = torch.randint(0, 2, (CHANNELS, SYMBOLS * 2), generator=g,
                          device=device, dtype=torch.int32)
    for tag, fn, args, symbol in (
            ("fsk_roundtrip", mfsk.roundtrip_fused, (bits,), "fsk_chain_"),
            ("fsk_roundtrip_21db",
             lambda b: mfsk.roundtrip_fused(b, snr_db=21.0, seed=SEED),
             (bits,), "fsk_chain_"),
            ("msk_roundtrip", msk.roundtrip_fused, (mbits,), "msk_chain_"),
            ("msk_roundtrip_7db",
             lambda b: msk.roundtrip_fused(b, snr_db=7.0, seed=SEED),
             (mbits,), "msk_chain_"),
            ("fsk_tx_fused", mfsk.tx_fused, (bits,), "fsk_tx_"),
            ("msk_tx_fused", msk.tx_fused, (mbits,), "msk_tx_")):
        res[f"{tag}_sha"] = sha(fn(*args))
        res[f"{tag}_ms"] = event_ms(fn, args, 10, reps)
        res[f"{tag}_kernel_ms"], res[f"{tag}_other_ms"] = busy_ms(
            fn, args, symbol, calls=10)
    if has_core:
        before = fk.FSK_TONE_KERNEL.launches
        for _ in range(10):
            mfsk.roundtrip_fused(bits)
        res["tone_launches_per_10_calls"] = (fk.FSK_TONE_KERNEL.launches
                                             - before)
    return res


if __name__ == "__main__":
    sys.exit(alternate(pathlib.Path(__file__).resolve(), __doc__, run_one,
                       rounds=1, reps=5))
