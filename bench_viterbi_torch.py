"""Times the PyTorch port's windowed Viterbi (K13's warp route), a
``StreamingViterbi`` push and the reference link's receive on one CUDA card,
alternating between source trees in one run, and checks that every tree
gives the same bits.

    python3 bench_viterbi_torch.py [--trees DIR ...] [--rounds N] [--reps N]

Each tree is a checkout of the repo (``git archive`` of another commit,
unpacked into a git-ignored directory); the default is this one. A round
runs every tree in a fresh process, in order and then in reverse (two trees:
A B B A), so that the card's drift falls on each alike. Each process builds
its tree's kernels (``build_s``), then measures the profiler's device time
per launch of K13 (``viterbi_kernel``) through ``stream_kernel`` on noisy
LLRs (``chip_smoke.py``'s seeded ``vit_case``, sigma 0.8):

- ``fec``: ``bench_fec.py``'s width, the CCSDS K=7 rate-1/2 code at 256
  channels x 4096 bits, windows of 512 with a halo of 70 (2304 rows of 652
  steps);
- ``link``: ``reference_link()``'s trellis, 384 frames of 1024 steps in
  windows of 512 (768 rows of 652 steps);
- ``k3``: K=3 (S = 4) at 16 channels x 1024 bits, windows of 256 (80 rows
  of 316 steps);
- ``k7_r13``, ``k4``, ``k6``, ``k9``: the (64, 3), S = 8, 32 and 256 code
  shapes of ``tests/test_torch_kernels_cuda.py``'s ``CODES`` at 256 x 4096,
  windows of 512 with the default halo;

then one ``StreamingViterbi.push`` of 512 steps at 256 channels (device
time of its launch and CUDA-event time per push), and
``reference_link().rx_fused`` at 384 frames and 2 dB: CUDA-event time per
call (3 calls a rep) and, from one profile of 3 calls, the device's busy
time per call split into K13's and every other kernel's and copy's, and its
idle share. Every case hashes its output bits (``*_sha``): the run fails
unless every process of every tree gives the same hashes.

Each process prints one JSON line of its reps; the run ends with each
metric's summary over the processes of each tree, then the card's name and
power limit (``bench_turbo_torch.py``'s ``alternate``, whose timers it
shares). Needs a CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import pathlib
import statistics
import sys
import time

from bench_demod_torch import sha
from bench_turbo_torch import alternate, busy_ms, event_ms, smoke

CCSDS = (7, (0o171, 0o133))
#: name -> (K, polynomials, channels, data bits, block steps, halo or None)
CASES = {
    "fec": (*CCSDS, 256, 4096, 512, 70),
    "link": (*CCSDS, 384, 1024 - 6, 512, 70),
    "k3": (3, (0o7, 0o5), 16, 1024, 256, None),
    "k7_r13": (7, (0o171, 0o133, 0o165), 256, 4096, 512, None),
    "k4": (4, (0o15, 0o17), 256, 4096, 512, None),
    "k6": (6, (0o53, 0o75), 256, 4096, 512, None),
    "k9": (9, (0o561, 0o753), 256, 4096, 512, None),
}
PUSH_CHANNELS, PUSH_STEPS, PUSHES = 256, 512, 4
LINK_FRAMES, LINK_SNR_DB = 384, 2.0
SEED = 70


def run_one(tree: pathlib.Path, reps: int) -> dict:
    """Every measurement on ``tree``'s package; the JSON line's dict."""
    sys.path.insert(0, str(tree))
    import torch

    import modem_tpu_torch
    from modem_tpu_torch import cuda, presets
    from modem_tpu_torch.fec import StreamingViterbi
    from modem_tpu_torch.ops import viterbi_kernel as vk

    pkg = pathlib.Path(modem_tpu_torch.__file__).resolve().parent
    assert pkg.parent == tree.resolve(), f"{pkg} is not {tree}'s package"
    sm = smoke()
    device = torch.device("cuda", 0)
    t0 = time.perf_counter()
    cuda.build_library()
    res = {"tree": str(tree), "build_s": time.perf_counter() - t0}
    cuda.library()

    for i, (tag, (k, polys, ch, bits, b, h)) in enumerate(CASES.items()):
        code, _, lam = sm.vit_case(k, polys, (ch, bits), 0.8, SEED + i,
                                   device)
        args = (code, lam, b, 10 * k if h is None else h, 1e6)
        res[f"{tag}_sha"] = sha(vk.stream_kernel(*args))
        res[f"{tag}_device_ms"] = [
            sm.kernel_device_ms(vk.stream_kernel, args, device,
                                "viterbi_kernel") for _ in range(reps)]

    code, _, lam = sm.vit_case(*CCSDS, (PUSH_CHANNELS, PUSHES * PUSH_STEPS - 6),
                               0.8, SEED + 10, device)
    llr = lam.reshape(PUSH_CHANNELS, -1)
    step = code.n * PUSH_STEPS
    blocks = [llr[:, a:a + step] for a in range(0, llr.shape[-1], step)]
    sv = StreamingViterbi(code, PUSH_STEPS)
    outs = [sv.push(x) for x in blocks]
    res["push_sha"] = sha(torch.cat([o for o in outs if o is not None]
                                    + [sv.flush()], -1))
    sv.push(blocks[0])  # a carried block: every later push decodes one
    res["push_device_ms"] = [
        sm.kernel_device_ms(sv.push, (blocks[1],), device, "viterbi_kernel")
        for _ in range(reps)]
    res["push_ms"] = event_ms(sv.push, (blocks[1],), 10, reps)

    link = presets.reference_link(device=device)
    gen = torch.Generator(device=device).manual_seed(SEED + 11)
    pay = torch.randint(0, 2, (LINK_FRAMES, link.payload_bits),
                        generator=gen, device=device, dtype=torch.int32)
    wave, nv = sm.link_noise(gen, link.tx_fused(pay), LINK_SNR_DB)
    got, ok = link.rx_fused(wave, nv)
    res["link_rx_sha"] = sha(got)
    res["link_rx_exact"] = bool(torch.equal(got, pay)) and bool(ok.all())
    res["link_rx_ms"] = event_ms(link.rx_fused, (wave, nv), 3, reps)
    res["link_rx_k13_ms"], res["link_rx_other_ms"] = busy_ms(
        link.rx_fused, (wave, nv), "viterbi_kernel")
    res["link_rx_idle_share"] = 1 - (
        res["link_rx_k13_ms"] + res["link_rx_other_ms"]) / statistics.median(
        res["link_rx_ms"])
    return res


if __name__ == "__main__":
    sys.exit(alternate(pathlib.Path(__file__).resolve(), __doc__, run_one,
                       rounds=1, reps=5))
