"""Times the PyTorch port's ``fir_filter`` host call (kernel K4's wrapper) and
the acquisition entry points around it on one CUDA card, alternating between
source trees in one run, and checks that every tree gives the same bits.

    python3 bench_fir_torch.py [--trees DIR ...] [--rounds N] [--reps N]

Each tree is a checkout of the repo (``git archive`` of another commit,
unpacked into a git-ignored directory); the default is this one. A round
runs every tree in a fresh process, in order and then in reverse (two trees:
A B B A), so that the card's drift falls on each alike. At
``chip_smoke.py``'s phase 41 and 45 shapes (64 channels x 4416 samples, the
acquisition's capture, at the mild multipath channel's 4 taps, the 3-ray
channel's 13 and ``apply_static_delay``'s 63; the matched filter's 65 at 64
x 4505) and phase 40's (240 taps at 256 x 335, the OFDM fine timing), each
``fir_filter`` call (taps as a device tensor and as numpy, from no state
and from a carried one) gets:

- ``*_host_us``: host time per call of 50 calls back to back, not waiting
  for the card;
- ``*_ms``: CUDA-event time per call (20 calls a rep);
- ``*_launches``: the CUDA kernels and copies one call runs, by the
  profiler (the most of three profiles);

and so do ``fir_filter(x, taps, backend="conv")`` at each shape
(``conv_*``: one ``conv1d`` by cuDNN, device taps, no state; the library's
yardstick, in the same process), ``apply_static_delay`` (numpy taps),
``multipath_fir`` (device taps) and ``AcquiringReceiver.rx`` at 64 x 512
payload symbols. Each case also hashes its output bytes (``*_sha``): the run fails unless every
process of every tree gives the same hashes, so the wrapper is held to the
parent's bits.

Each process prints one JSON line of its reps; the run ends with each
metric's summary over the processes of each tree, then the card's name and
power limit (``bench_turbo_torch.py``'s ``alternate``). Needs a CUDA card;
imports nothing of JAX.
"""

from __future__ import annotations

import pathlib
import sys
import time

from bench_demod_torch import sha
from bench_turbo_torch import alternate, event_ms, host_us, smoke

SEED = 124


def launches(fn, args) -> int:
    """CUDA kernels and copies one call runs (the most of three
    profiles)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    most = 0
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn(*args)
            torch.cuda.synchronize()
        most = max(most, sum(e.count for e in prof.key_averages()
                             if e.device_type == DeviceType.CUDA))
    return most


def run_one(tree: pathlib.Path, reps: int) -> dict:
    """Every measurement on ``tree``'s package; the JSON line's dict."""
    sys.path.insert(0, str(tree))
    import numpy as np
    import torch

    import modem_tpu_torch
    from modem_tpu_torch import cuda
    from modem_tpu_torch.ops import fir, impairments as imp

    pkg = pathlib.Path(modem_tpu_torch.__file__).resolve().parent
    assert pkg.parent == tree.resolve(), f"{pkg} is not {tree}'s package"
    sm = smoke()
    device = torch.device("cuda", 0)
    t0 = time.perf_counter()
    cuda.build_library()
    res = {"tree": str(tree), "build_s": time.perf_counter() - t0}
    cuda.library()
    rng = np.random.default_rng(SEED)

    def unit(*shape):
        return torch.as_tensor(rng.uniform(-1, 1, shape).astype(np.float32),
                               device=device)

    def measure(tag, fn, args):
        out = fn(*args)  # fir_filter's (y, new_state): y is hashed
        res[f"{tag}_sha"] = sha(out[0] if tag.startswith(("k4", "conv"))
                                else out)
        res[f"{tag}_host_us"] = host_us(fn, args, reps)
        res[f"{tag}_ms"] = event_ms(fn, args, 20, reps)
        res[f"{tag}_launches"] = launches(fn, args)

    rxr = sm.acq_receiver(device)
    taps = dict(sm.acq_taps(device))
    taps[65] = rxr.chain.rrc
    taps[240] = unit(240) / 240 ** 0.5
    shapes = {4: (64, 4416), 13: (64, 4416), 63: (64, 4416), 65: (64, 4505),
              240: (256, 335)}
    for k, t in taps.items():
        x = unit(*shapes[k])
        host = t.cpu().numpy()
        state = unit(shapes[k][0], k - 1)
        for form, args in (("tensor", (x, t)), ("numpy", (x, host)),
                           ("state", (x, t, state))):
            measure(f"k4_{k}_{form}", fir.fir_filter, args)
        measure(f"conv_{k}_tensor", fir.fir_filter, (x, t, None, "conv"))

    _, i, q = sm.acq_capture(rxr, sm.ACQ_CHANNELS, sm.ACQ_PAYLOAD, device,
                             SEED + 1)
    mild = [torch.tensor(r, device=device) for r in sm.ACQ_MILD]
    for tag, fn, args in (
            ("apply_static_delay", imp.apply_static_delay, (i, q, sm.ACQ_MU)),
            ("multipath_fir", imp.multipath_fir, (i, q, *mild)),
            ("acquiring_rx", rxr.rx, (i, q, sm.ACQ_PAYLOAD))):
        measure(tag, fn, args)
    return res


if __name__ == "__main__":
    sys.exit(alternate(pathlib.Path(__file__).resolve(), __doc__, run_one,
                       rounds=2, reps=5))
