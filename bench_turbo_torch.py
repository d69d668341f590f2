"""Times the PyTorch port's turbo decode, K14 and the turbo link on one
CUDA card, alternating between source trees in one run.

    python3 bench_turbo_torch.py [--trees DIR ...] [--rounds N] [--reps N]

Each tree is a checkout of the repo (``git archive`` of another commit,
unpacked into a git-ignored directory); the default is this one. A round
runs every tree in a fresh process, in order and then in reverse (two trees:
A B B A), so that the card's drift falls on each alike. Each process builds
its tree's kernels, then measures at ``bench_fec.py``'s turbo width
(``TurboCode(1024)``, 512 codewords, BPSK LLRs at 1 dB):

- K14 (``rows_kernel``) at ``pick_geometry`` (512 rows x 1092 steps) and at
  window 256 (2560 rows x 324 steps): the profiler's device time per launch,
  CUDA-event time per call, and the host's time per call (the wrapper and
  the launch, without waiting for the card: 50 calls back to back);
- ``decode`` with 6 fixed iterations and with early exit, and
  ``lte_like_turbo_link().rx_fused`` at 256 frames and 1 dB: CUDA-event time
  per call (3 calls a rep), and from one profile of 3 calls the device's busy
  time per call split into K14's and every other kernel's and copy's.

Each process prints one JSON line of its reps; the run ends with each
metric's median, minimum, maximum and interquartile range over the
processes of each tree (a process's value is the median of its reps), the
least of all its reps, and for each later tree in how many pairs with the
first it was lower; then the card's name and power limit. Needs a CUDA
card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import pathlib
import statistics
import subprocess
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent
TURBO_K, TURBO_CW, ITERS, SNR_DB, WINDOW = 1024, 512, 6, 1.0, 256
LINK_FRAMES, LINK_SNR_DB = 256, 1.0
SEED = 66
HOST_CALLS = 50


def smoke():
    """chip_smoke.py beside this script, for its seeded inputs and timers."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def event_ms(fn, args, calls: int, reps: int) -> list[float]:
    """CUDA-event time per call of ``calls`` calls back to back, each rep,
    after two warm-up calls."""
    import torch

    for _ in range(2):
        fn(*args)
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn(*args)
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / calls)
    return out


def host_us(fn, args, reps: int) -> list[float]:
    """Host time per call of HOST_CALLS calls back to back, not waiting for
    the card (the launch queue holds them all), in microseconds."""
    import torch

    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(HOST_CALLS):
            fn(*args)
        out.append((time.perf_counter() - t0) / HOST_CALLS * 1e6)
        torch.cuda.synchronize()
    return out


def busy_ms(fn, args, symbol: str, calls: int = 3) -> tuple[float, float]:
    """(the device time of kernels named ``symbol``, every other kernel's
    and copy's) per call, from one profile of ``calls`` calls."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn(*args)
        torch.cuda.synchronize()
    mine = other = 0.0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        if symbol in e.key:
            mine += e.device_time_total
        else:
            other += e.device_time_total
    return mine / calls / 1e3, other / calls / 1e3


def ptxas_lines(so) -> list[str]:
    """ptxas's registers, spills and shared memory of bcjr_kernel."""
    lines, keep = [], False
    for line in so.with_suffix(".log").read_text().splitlines():
        if "Compiling entry" in line:
            keep = "bcjr_kernel" in line
        if keep:
            lines.append(line.strip())
    return lines


def run_one(tree: pathlib.Path, reps: int) -> dict:
    """Every measurement on ``tree``'s package; the JSON line's dict."""
    sys.path.insert(0, str(tree))
    import torch

    import modem_tpu_torch
    from modem_tpu_torch import cuda, presets
    from modem_tpu_torch.fec import TurboCode
    from modem_tpu_torch.ops import bcjr_kernel as bk

    pkg = pathlib.Path(modem_tpu_torch.__file__).resolve().parent
    assert pkg.parent == tree.resolve(), f"{pkg} is not {tree}'s package"
    sm = smoke()
    device = torch.device("cuda", 0)
    so = cuda.build_library()
    cuda.library()
    res = {"tree": str(tree), "ptxas": ptxas_lines(so)}

    code = TurboCode(TURBO_K)
    bits, llr = sm.turbo_llrs(code, TURBO_CW, SNR_DB, SEED, device)
    for tag, window in (("k14", None), (f"k14_w{WINDOW}", WINDOW)):
        rows, g, w = sm.turbo_rows(code, llr, window)[0]
        args = (rows, g, w)
        res[f"{tag}_rows_steps"] = list(rows.shape[1:])
        res[f"{tag}_device_ms"] = [sm.kernel_device_ms(bk.rows_kernel, args,
                                                       device, "bcjr_kernel")
                                   for _ in range(reps)]
        res[f"{tag}_event_ms"] = event_ms(bk.rows_kernel, args, 20, reps)
        res[f"{tag}_host_us"] = host_us(bk.rows_kernel, args, reps)

    link = presets.lte_like_turbo_link(device=device)
    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    pay = torch.randint(0, 2, (LINK_FRAMES, link.payload_bits), generator=gen,
                        device=device, dtype=torch.int32)
    wave, nv = sm.link_noise(gen, link.tx_fused(pay), LINK_SNR_DB)
    for tag, fn, args in (
            ("decode_fixed", lambda x: code.decode(x, iters=ITERS), (llr,)),
            ("decode_early",
             lambda x: code.decode(x, iters=ITERS, early_exit=True), (llr,)),
            ("link_rx_fused", link.rx_fused, (wave, nv))):
        res[f"{tag}_ms"] = event_ms(fn, args, 3, reps)
        res[f"{tag}_k14_ms"], res[f"{tag}_other_ms"] = busy_ms(
            fn, args, "bcjr_kernel")
    dec = code.decode(llr, iters=ITERS)
    res["decode_bit_errors"] = int((dec.to(torch.int32) != bits).sum())
    got, ok = link.rx_fused(wave, nv)[:2]
    res["link_crc_ok"] = int(ok.sum())
    res["link_payload_exact"] = bool(torch.equal(got.to(torch.int32), pay))
    res["info_bits"] = bits.numel()
    return res


def summary(runs: list[dict]) -> dict:
    """Per tree and metric: median, min, max and interquartile range of the
    processes' medians, those medians in run order, and the least of every
    rep (the host's time with the least interference); for each tree after
    the first, ``lower``: in how many of its pairs with the first tree (its
    k-th process against the first tree's k-th) its median was lower."""
    meds, floors = {}, {}
    for r in runs:
        for key, val in r.items():
            if not key.endswith(("_ms", "_us")):
                continue
            if isinstance(val, list):  # a profile may miss the kernel
                val = [v for v in val if v is not None]
            else:
                val = [val]
            meds.setdefault(r["tree"], {}).setdefault(key, []).append(
                statistics.median(val))
            floors.setdefault((r["tree"], key), []).extend(val)
    first = meds[runs[0]["tree"]]
    out = {}
    for tree, t in meds.items():
        out[tree] = {}
        for key, v in t.items():
            q = statistics.quantiles(v, n=4) if len(v) > 1 else [v[0]] * 3
            out[tree][key] = {"median": statistics.median(v), "min": min(v),
                              "max": max(v), "iqr": q[2] - q[0], "runs": v,
                              "rep_min": min(floors[tree, key])}
            if t is not first:
                pairs = list(zip(v, first[key]))
                out[tree][key]["lower"] = (
                    f"{sum(a < b for a, b in pairs)}/{len(pairs)}")
    return out


def alternate(script: pathlib.Path, doc: str, run_one, rounds: int,
              reps: int) -> int:
    """The command line of an A/B timing script: parse ``--trees``,
    ``--rounds`` and ``--reps``; run ``run_one(tree, reps)`` for every tree
    in a fresh process of ``script`` (``--one``), A B B A for each round;
    print each process's JSON line, then :func:`summary`, whether every
    process gave the same output hashes (its keys ending in ``_sha``) and
    the card's name and power limit. Exits non-zero without a CUDA device,
    when a process fails or when two processes' hashes differ."""
    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    ap.add_argument("--trees", nargs="+", type=pathlib.Path, default=[HERE])
    ap.add_argument("--rounds", type=int, default=rounds)
    ap.add_argument("--reps", type=int, default=reps)
    ap.add_argument("--one", type=pathlib.Path, help=argparse.SUPPRESS)
    a = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print(f"{script.stem}: no CUDA device", file=sys.stderr)
        return 1
    if a.one is not None:
        print(json.dumps(run_one(a.one, a.reps)), flush=True)
        return 0
    order = []
    for _ in range(a.rounds):
        order += a.trees + a.trees[::-1]
    runs = []
    for tree in order:
        proc = subprocess.run(
            [sys.executable, str(script), "--one", str(tree.resolve()),
             "--reps", str(a.reps)],
            capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return proc.returncode
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    print(json.dumps(summary(runs), indent=1))
    shas = sorted({k for r in runs for k in r if k.endswith("_sha")})
    differ = [k for k in shas if len({r.get(k) for r in runs}) > 1]
    if shas:
        print(f"output hashes ({len(shas)} cases): "
              + (f"DIFFER in {differ}" if differ else
                 "equal in every process of every tree"))
    print(f"card: {smoke().card_line()}")
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(alternate(pathlib.Path(__file__).resolve(), __doc__, run_one,
                       rounds=2, reps=7))
