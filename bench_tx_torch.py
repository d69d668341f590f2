"""Times the PyTorch port's K2 (the fused one-way TX) and the entry points
that launch it on one CUDA card, alternating between source trees in one
run, and checks that every tree gives the same bits.

    python3 bench_tx_torch.py [--trees DIR ...] [--rounds N] [--reps N]

Each tree is a checkout of the repo (``git archive`` of another commit,
unpacked into a git-ignored directory); the default is this one. A round
runs every tree in a fresh process, in order and then in reverse (two trees:
A B B A), so that the card's drift falls on each alike. Each process builds
its tree's kernels (``build_s``), counts the SASS instructions of every
pulse-shaped kernel in the build (``cuobjdump -sass``: ``sass_*_n``; K1's
and K3's code also hashed, ``sass_*_code``, which two builds of the same
source need not share), then at the flagship's block
(``bench.py``: 256 channels x 4096 symbols, sps 8, span 8) measures:

- K2's profiler device time per launch (the kernel named ``pulse_tx_...``
  on either route) on ``chip_smoke.py``'s inputs in every mode: baseband
  f32, passband 2000 Hz and 1700 Hz of 10000, algebraic 256-QAM, bf16 and
  int16, each at ``sym_offset`` 4096, and 1999 Hz (more phases than the
  carrier table holds: cosf and sinf a sample) at ``sym_offset``
  987654321; and on the long route's shapes, 257 taps (sps 8, span 32)
  and 65 samples a symbol (span 2); in a tree whose ``ops.txrx`` has
  ``_tx_launch``, also the long route at sps 8, span 8 (``f32_long``, the
  first version's body, whose output must equal the short route's);
- ``conv_transpose1d`` (cuDNN, TF32 off) on the mapped points, the shaping
  alone, as a yardstick (``chip_smoke.tx_conv_yardstick``);
- wall time (CUDA events, 10 calls a rep) and, from one profile of 3 calls,
  the device's busy time per call split into K2's and every other kernel's
  and copy's, of the flagship's ``tx_fused`` (baseband and 2000 Hz), of
  ``StreamingFusedTx`` over one block in 5 pushes and its flush, and of
  ``reference_link().tx_fused`` at 384 frames.

K1's and K3's long route (``LONG_K13``: sps 8 span 32, sps 20 span 16,
sps 96 span 1 and the reference CLI's sps 45 span 8, on the long core
where the tree has it) at 256 x 1024 and 256 x 4096 symbols: K1, K3 hard
and K3 soft (on ``chip_smoke.py``'s symbols, K3 on their waveform with
noise; at 4096 symbols also K3 at passband, on bf16 rails and both,
``LONG_K13_MODES``), the profiler's device time of the kernel named ``pulse_chain_``
or ``pulse_rx_`` (either route), and in a tree whose wrappers take
``first``, the first version forced (``*_first_device_ms``; its outputs
must equal the core's); ``roundtrip_fused`` and ``rx_fused`` of those
chains, CUDA-event time (10 calls a rep) and busy time split into the
kernel's and the rest's.

Every output is hashed (``*_sha``), also at odd shapes (sps 2, 4 and 16; K
= 1, 31 and 257; rows off a 16-byte boundary; at 1/5 of the rate and at
1999 Hz with a far ``sym_offset``): the run fails unless every
process of every tree gives the same hashes, so a change that claims the
parent's bits is held to them.

Each process prints one JSON line of its reps; the run ends with each
metric's summary over the processes of each tree, then the card's name and
power limit (``bench_turbo_torch.py``'s ``alternate``, whose timers it
shares). Needs a CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import functools
import hashlib
import inspect
import os
import pathlib
import re
import shutil
import subprocess
import sys
import time

from bench_turbo_torch import alternate, busy_ms, event_ms, smoke

CHANNELS, SYMBOLS = 256, 4096
#: the long route's shapes: (sps, span)
LONG = ((8, 32), (65, 2))
#: K1's and K3's long route: (sps, span), and the sizes (symbols a row)
LONG_K13 = ((8, 32), (20, 16), (96, 1), (45, 8))
LONG_K13_SIZES = (1024, 4096)
#: K3's modes beside baseband f32 on the long route, at 256 x 4096
LONG_K13_MODES = ("passband", "bf16", "passband_bf16")
#: odd shapes: (sps, span, channels, symbols)
ODD = ((2, 10, 3, 31), (4, 6, 3, 257), (16, 4, 3, 1), (2, 7, 5, 4),
       (8, 8, 3, 31), (8, 8, 2, 257))
PUSHES = 5
LINK_FRAMES = 384
#: the kernels whose SASS is counted, and those held to the same code
SASS = ("pulse_tx_core", "pulse_tx_kernel", "pulse_rx_kernel",
        "pulse_chain_kernel", "pulse_rx_long_core", "pulse_chain_long_core")
SASS_SAME = ("pulse_rx_kernel", "pulse_chain_kernel")
#: the opcodes counted in each K2 instantiation
OPCODES = ("FFMA", "FMUL", "FADD", "STG", "STS", "LDS", "LDG", "LDC", "BAR",
           "BRA", "F2FP", "F2I", "I2F")
SEED = 70
#: a carrier of more phases than the table holds, far into a stream
FAR = {"carrier": (1999, 10000), "sym_offset": 987654321}


def sha(out) -> str:
    """The first 16 hex digits of the SHA-256 of the output's bytes (bf16
    by its bits)."""
    import torch

    outs = out if isinstance(out, tuple) else (out,)
    raw = b"".join((o.view(torch.int16) if o.dtype == torch.bfloat16 else o)
                   .detach().cpu().numpy().tobytes() for o in outs)
    return hashlib.sha256(raw).hexdigest()[:16]


def sass_counts(so: pathlib.Path) -> dict:
    """From ``cuobjdump -sass`` of ``so``: the instructions of each kernel
    of SASS (summed over its instantiations, ``sass_<kernel>_n``); for K2's
    (``sass_tx``) each instantiation's count and its counts of the opcodes
    OPCODES, by its mangled name from the kernel's name on; and for
    SASS_SAME a hash of their code without the functions' names."""
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    tool = shutil.which("cuobjdump") or str(pathlib.Path(home) / "bin" /
                                            "cuobjdump")
    text = subprocess.run([tool, "-sass", str(so)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    out, body, tx = {}, {}, {}
    name = fn = None
    for line in text.splitlines():
        if "Function :" in line:
            name = next((k for k in SASS if k in line), None)
            fn = line[line.index(name):].strip() if name else None
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
        if not (name and m):
            continue
        out[f"sass_{name}_n"] = out.get(f"sass_{name}_n", 0) + 1
        body.setdefault(name, []).append(m.group(1))
        if name.startswith("pulse_tx"):
            op = re.sub(r"^@!?U?P\w+\s+", "", m.group(1)).split(" ")[0]
            c = tx.setdefault(fn, {"n": 0})
            c["n"] += 1
            base = op.split(".")[0]
            if base in OPCODES:
                c[base] = c.get(base, 0) + 1
    for name in SASS_SAME:
        out[f"sass_{name}_code"] = hashlib.sha256(
            "\n".join(body.get(name, [])).encode()).hexdigest()[:16]
    out["sass_tx"] = tx
    return out


def k3_mode_cases(torch, txrx, chain, syms, g) -> list:
    """K3 hard and soft cases (tag, fn, args, profiler family) in
    LONG_K13_MODES on ``chain``'s noisy waveform of ``syms``: passband at a
    fifth of a sample rate of 1000 Hz a sample a symbol, bf16 rails, or
    both."""
    sps, span, k = chain.sps, chain.span, syms.shape[-1]
    sr = 1000 * sps
    out = []
    for mode in LONG_K13_MODES:
        carrier = (sr // 5, sr) if mode.startswith("passband") else None
        wave = txrx.tx_plain(syms, chain.lut, chain.rrc, sps, span, None,
                             carrier)
        dtype = torch.bfloat16 if mode.endswith("bf16") else torch.float32
        rails = tuple((w + 0.3 * torch.randn(w.shape, generator=g,
                                             device=w.device)).to(dtype)
                      for w in ((wave,) if carrier else wave))
        for soft in (False, True):
            out.append((f"k3{'soft' if soft else ''}_{mode}", txrx.rx_kernel,
                        (rails[0], None if carrier else rails[1], k,
                         chain.lut, chain.rrc, sps, span, soft, None,
                         carrier), "pulse_rx_"))
    return out


def run_one(tree: pathlib.Path, reps: int) -> dict:
    """Every measurement on ``tree``'s package; the JSON line's dict."""
    sys.path.insert(0, str(tree))
    import torch

    import modem_tpu_torch
    from modem_tpu_torch import (Rates, StreamingFusedTx, cuda, presets,
                                 qpsk_reference_chain)
    from modem_tpu_torch.chain import PulseShapedChain
    from modem_tpu_torch.models.psk import QPSK
    from modem_tpu_torch.ops import txrx

    pkg = pathlib.Path(modem_tpu_torch.__file__).resolve().parent
    assert pkg.parent == tree.resolve(), f"{pkg} is not {tree}'s package"
    sm = smoke()
    device = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    so = cuda.build_library()
    res = {"tree": str(tree), "build_s": time.perf_counter() - t0}
    cuda.library()
    res.update(sass_counts(so))
    has_long = hasattr(txrx, "_tx_launch")

    def dev_ms(fn, args):
        return [sm.kernel_device_ms(fn, args, device, "pulse_tx_")
                for _ in range(reps)]

    chain = qpsk_reference_chain(Rates(1250, 10000), device=device)
    modes = [("f32", {})] + [(name[len("fused_tx_"):], spec)
                             for name, kind, spec, _, _ in sm.mode_cases()
                             if kind == "tx"] + [("passband_1999", FAR)]
    for key, spec in modes:
        bps = sm.MODE_QAM_BPS if "qam" in spec else 2
        syms = sm.mode_symbols((CHANNELS, SYMBOLS), bps, device, SEED)
        args = sm.mode_args("tx", spec, syms,
                            spec.get("sym_offset", SYMBOLS), 256, chain)
        res[f"{key}_sha"] = sha(txrx.tx_kernel(*args))
        res[f"{key}_device_ms"] = dev_ms(txrx.tx_kernel, args)
        if key != "f32":
            continue
        fn, fargs, err = sm.tx_conv_yardstick(args)
        res["conv_transpose1d_max_err"] = err
        res["conv_transpose1d_ms"] = event_ms(fn, fargs, 10, reps)
        res["conv_transpose1d_busy_ms"] = sm.device_busy_ms(fn, fargs,
                                                            device)
        if has_long:
            def long_tx(*a):
                return txrx._tx_launch(*a, host=None)

            if sha(long_tx(*args)) != res["f32_sha"]:
                raise SystemExit("bench_tx_torch: the routes differ")
            res["f32_long_device_ms"] = dev_ms(long_tx, args)

    for sps, span in LONG:
        lc = PulseShapedChain(QPSK(0.0, 1.0), Rates(1, sps),
                              span_symbols=span, device=device)
        syms = sm.random_symbols((CHANNELS, SYMBOLS), device, False)
        args = (syms, lc.lut, lc.rrc, sps, span)
        key = f"long_sps{sps}_span{span}"
        res[f"{key}_sha"] = sha(txrx.tx_kernel(*args))
        res[f"{key}_device_ms"] = dev_ms(txrx.tx_kernel, args)

    from modem_tpu_torch.ops import chain_kernel as ck

    has_first = "first" in inspect.signature(ck.chain_kernel).parameters
    for sps, span in LONG_K13:
        lc = PulseShapedChain(QPSK(0.0, 1.0), Rates(1, sps),
                              span_symbols=span, device=device)
        for k in LONG_K13_SIZES:
            key = f"k13_sps{sps}_span{span}_{k}"
            syms = sm.random_symbols((CHANNELS, k), device, True)
            wi, wq = txrx.tx_plain(syms.clamp(0), lc.lut, lc.rrc, sps, span)
            g = torch.Generator(device=device).manual_seed(SEED + sps + k)
            wi = wi + 0.3 * torch.randn(wi.shape, generator=g, device=device)
            wq = wq + 0.3 * torch.randn(wq.shape, generator=g, device=device)
            cases = [("k1", ck.chain_kernel, (syms, lc.lut, lc.rrc, sps, span),
                      "pulse_chain_"),
                     ("k3", txrx.rx_kernel, (wi, wq, k, lc.lut, lc.rrc, sps,
                                             span, False), "pulse_rx_"),
                     ("k3soft", txrx.rx_kernel, (wi, wq, k, lc.lut, lc.rrc,
                                                 sps, span, True), "pulse_rx_")]
            if k == LONG_K13_SIZES[-1]:
                cases += k3_mode_cases(torch, txrx, lc, syms.clamp(0), g)
            for tag, fn, args, family in cases:
                out = sha(fn(*args))
                res[f"{key}_{tag}_sha"] = out
                res[f"{key}_{tag}_device_ms"] = [
                    sm.kernel_device_ms(fn, args, device, family)
                    for _ in range(reps)]
                if not has_first:
                    continue
                first = functools.partial(fn, first=True)
                if sha(first(*args)) != out:
                    raise SystemExit(f"bench_tx_torch: {key} {tag}: the core "
                                     "and the first version differ")
                res[f"{key}_{tag}_first_device_ms"] = [
                    sm.kernel_device_ms(first, args, device, family)
                    for _ in range(reps)]
            bits = torch.randint(0, 2, (CHANNELS, 2 * k), generator=g,
                                 device=device, dtype=torch.int32)
            wave = lc.tx_fused(bits)
            for tag, fn, fargs, family in (
                    ("roundtrip_fused", lc.roundtrip_fused, (bits,),
                     "pulse_chain_"),
                    ("rx_fused", lc.rx_fused, (wave, k), "pulse_rx_")):
                out = fn(*fargs)
                if not torch.equal(out, bits):
                    raise SystemExit(f"bench_tx_torch: {key} {tag}: bits "
                                     "differ")
                res[f"{key}_{tag}_sha"] = sha(out)
                res[f"{key}_{tag}_ms"] = event_ms(fn, fargs, 10, reps)
                res[f"{key}_{tag}_kernel_ms"], res[f"{key}_{tag}_other_ms"] = \
                    busy_ms(fn, fargs, family)

    for sps, span, c, k in ODD:
        lc = PulseShapedChain(QPSK(0.0, 1.0), Rates(1, sps),
                              span_symbols=span, device=device)
        syms = sm.random_symbols((c, k), device, k > 20)
        for tag, kw in (("f32", {}), ("bf16", {"out_dtype": torch.bfloat16}),
                        ("pb", {"carrier": (1, 5), "sym_offset": -3}),
                        ("pb1999", FAR)):
            out = txrx.tx_kernel(syms, lc.lut, lc.rrc, sps, span, **kw)
            res[f"odd_sps{sps}_span{span}_{c}x{k}_{tag}_sha"] = sha(out)

    g = torch.Generator(device=device).manual_seed(SEED + 1)
    bits = torch.randint(0, 2, (CHANNELS, 2 * SYMBOLS), generator=g,
                         device=device, dtype=torch.int32)
    pbc = PulseShapedChain(QPSK(0.0, 1.0), Rates(1250, 10000),
                           carrier_hz=2000, device=device)
    cuts = [round(i * SYMBOLS / PUSHES) for i in range(PUSHES + 1)]

    def stream(b):
        st = StreamingFusedTx(chain, (CHANNELS,))
        parts = [st.push(b[:, 2 * x:2 * y]) for x, y in zip(cuts, cuts[1:])]
        parts.append(st.flush())
        return tuple(torch.cat([p[r] for p in parts], -1) for r in range(2))

    link = presets.reference_link(device=device)
    pay = torch.randint(0, 2, (LINK_FRAMES, link.payload_bits), generator=g,
                        device=device, dtype=torch.int32)
    for tag, fn, args in (("tx_fused", chain.tx_fused, (bits,)),
                          ("tx_fused_pb2000", pbc.tx_fused, (bits,)),
                          ("stream_5_pushes", stream, (bits,)),
                          ("link_tx_fused", link.tx_fused, (pay,))):
        res[f"{tag}_sha"] = sha(fn(*args))
        res[f"{tag}_ms"] = event_ms(fn, args, 10, reps)
        res[f"{tag}_kernel_ms"], res[f"{tag}_other_ms"] = busy_ms(
            fn, args, "pulse_tx_")
    if res["stream_5_pushes_sha"] != res["tx_fused_sha"]:
        raise SystemExit("bench_tx_torch: the stream's pushes differ from "
                         "one shot")
    return res


if __name__ == "__main__":
    sys.exit(alternate(pathlib.Path(__file__).resolve(), __doc__, run_one,
                       rounds=1, reps=5))
