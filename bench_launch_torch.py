"""Times the launch path every kernel of the PyTorch port shares (its
wrapper's checks, ``cuda.Kernel.launch`` and the C entry's host work) on one
CUDA card, alternating between source trees in one run, and checks that
every tree gives the same bits.

    python3 bench_launch_torch.py [--trees DIR ...] [--rounds N] [--reps N]

Each tree is a checkout of the repo (``git archive`` of another commit,
unpacked into a git-ignored directory); the default is this one. A round
runs every tree in a fresh process, in order and then in reverse (two trees:
A B B A), so that the card's drift falls on each alike. Every C entry of the
kernel library is called through its wrapper (``chip_smoke.launch_cases``)
at a small shape where the launch's host work outweighs the kernel
(``chip_smoke.LAUNCH_SMALL``, 4 x 64 symbols) and at its PERF.md §6 shape
(256 x 4096 symbols), and so are these entry points: the flagship's
``roundtrip_fused``, ``tx_fused`` and ``rx_fused`` (256 x 4096 symbols),
``Demodulator.demodulate_fused`` and ``demodulate`` (256 x 32768 samples),
``AcquiringReceiver.rx`` (64 x 512 payload symbols) and
``reference_link().rx_fused`` (384 frames at 2 dB); and K4's host time a
call is split by layer (``k4_split``). Each case gets:

- ``*_host_us``: host time per call of 50 calls back to back, not waiting
  for the card;
- ``*_ms``: CUDA-event time per call (20 calls a rep);
- ``*_sha``: a hash of its output bytes. The run fails unless every process
  of every tree gives the same hashes, so each tree is held to the others'
  bits.

Each process prints one JSON line of its reps (with the kernel library's
runtime queries at its end, where the tree counts them); the run ends with
each metric's summary over the processes of each tree, then the card's name
and power limit (``bench_turbo_torch.py``'s ``alternate``). Needs a CUDA
card; imports nothing of JAX.
"""

from __future__ import annotations

import hashlib
import pathlib
import sys
import time

from bench_turbo_torch import alternate, event_ms, host_us, smoke

SEED = 125


def digest(out) -> str:
    """The first 16 hex digits of the SHA-256 of the output's bytes, a
    tuple's parts one after another."""
    h = hashlib.sha256()
    for part in (out if isinstance(out, tuple) else (out,)):
        h.update(part.detach().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def k4_split(res: dict, sm, device, reps: int) -> None:
    """Where K4's host time a call goes, at 13 taps and 64 x 4416 (the
    acquisition's 3-ray channel): ``fir_filter`` (``split_filter``), its
    wrapper ``fir_kernel`` (``split_kernel``), ``FIR_KERNEL.launch`` with
    the arguments made once (``split_launch``) and the C entry called by
    ``ctypes`` on the current stream's handle (``split_c``); each step's
    time less the next is that layer's."""
    import torch

    from modem_tpu_torch import cuda
    from modem_tpu_torch.ops import fir

    taps = sm.acq_taps(device)[13]
    x = torch.rand((64, 4416), device=device,
                   generator=torch.Generator(device=device).manual_seed(SEED))
    y = torch.empty_like(x)
    args = (x.data_ptr(), None, 64, 4416, cuda.host_taps(taps),
            taps.data_ptr(), 13, y.data_ptr())
    c_fn = getattr(cuda.library(), "modem_fir")
    stream = torch.cuda.current_stream(device).cuda_stream
    for tag, fn, fargs in (
            ("split_filter", fir.fir_filter, (x, taps)),
            ("split_kernel", fir.fir_kernel, (x, taps)),
            ("split_launch", fir.FIR_KERNEL.launch, (device, *args)),
            ("split_c", c_fn, (*args, stream))):
        res[f"{tag}_host_us"] = host_us(fn, fargs, reps)


def run_one(tree: pathlib.Path, reps: int) -> dict:
    """Every measurement on ``tree``'s package; the JSON line's dict."""
    sys.path.insert(0, str(tree))
    import torch

    import modem_tpu_torch
    from modem_tpu_torch import Rates, cuda, presets, qpsk_reference_chain

    pkg = pathlib.Path(modem_tpu_torch.__file__).resolve().parent
    assert pkg.parent == tree.resolve(), f"{pkg} is not {tree}'s package"
    sm = smoke()
    device = torch.device("cuda", 0)
    t0 = time.perf_counter()
    cuda.build_library()
    res = {"tree": str(tree), "build_s": time.perf_counter() - t0}
    cuda.library()

    def measure(tag, fn, args):
        res[f"{tag}_sha"] = digest(fn(*args))
        res[f"{tag}_host_us"] = host_us(fn, args, reps)
        res[f"{tag}_ms"] = event_ms(fn, args, 20, reps)

    chain = qpsk_reference_chain(Rates(1250, 10000), device=device)
    for size, shape in (("small", sm.LAUNCH_SMALL),
                        ("full", (sm.CHANNELS, sm.N_SYMBOLS))):
        for sym, (_, fn, args) in sm.launch_cases(chain, device,
                                                  shape).items():
            measure(f"{sym}_{size}", fn, args)

    g = torch.Generator(device=device).manual_seed(SEED)
    bits = torch.randint(0, 2, (sm.CHANNELS, 2 * sm.N_SYMBOLS), generator=g,
                         device=device, dtype=torch.int32)
    wave = chain.tx_fused(bits)
    _, dem, x, locked, _, _ = sm.reference_path(device, sm.ref_bits(g, device))
    rxr = sm.acq_receiver(device)
    _, i, q = sm.acq_capture(rxr, sm.ACQ_CHANNELS, sm.ACQ_PAYLOAD, device,
                             SEED + 1)
    link = presets.reference_link(device=device)
    pay = torch.randint(0, 2, (sm.LINK_FRAMES, link.payload_bits),
                        generator=g, device=device, dtype=torch.int32)
    lwave, nv = sm.link_noise(g, link.tx_fused(pay), sm.LINK_SNR_DB)
    for tag, fn, args in (
            ("roundtrip_fused", chain.roundtrip_fused, (bits,)),
            ("tx_fused", chain.tx_fused, (bits,)),
            ("rx_fused", chain.rx_fused, (wave, sm.N_SYMBOLS)),
            ("demodulate_fused", lambda v: dem.demodulate_fused(v, locked)[0],
             (x[:, 64:],)),
            ("demodulate", lambda v: dem.demodulate(v, locked)[0],
             (x[:, 64:],)),
            ("acquiring_rx", rxr.rx, (i, q, sm.ACQ_PAYLOAD)),
            ("reference_link_rx_fused", link.rx_fused, (lwave, nv))):
        measure(tag, fn, args)
    k4_split(res, sm, device, reps)
    if hasattr(cuda, "host_queries"):
        res["host_queries"] = cuda.host_queries()
    return res


if __name__ == "__main__":
    sys.exit(alternate(pathlib.Path(__file__).resolve(), __doc__, run_one,
                       rounds=2, reps=5))
