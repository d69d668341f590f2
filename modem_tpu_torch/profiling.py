"""Tracing and throughput accounting (counterpart of
:mod:`modem_tpu.profiling`).

* :func:`trace` records a ``torch.profiler`` trace of the block (host and,
  where there is a card, CUDA activity) and writes it as a Chrome trace;
* :func:`measure` times ``fn`` over a loop of repetitions on distinct
  inputs, accumulating an on-device checksum of the outputs that is read
  once a pass, after a synchronize: on a CUDA device the pass is timed by
  CUDA events on the current stream, on the CPU by ``time.perf_counter``.
  The first pass is absorbed (kernel builds, allocator warm-up);
* :func:`measure_marginal` takes the rate from the slope between two
  repetition counts, which cancels any fixed cost a pass pays.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` trace of the block, written to
    ``log_dir/trace.json`` (open it in Perfetto or ``chrome://tracing``)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    with prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@dataclasses.dataclass(frozen=True)
class Measurement:
    seconds_per_call: float            # best (min) over the timing passes
    samples_per_s: float
    flops_per_s: float | None
    bytes_per_s: float | None
    #: per-pass seconds_per_call for every timing pass (len == passes)
    all_seconds: tuple = ()

    @property
    def spread(self) -> float:
        """(max - min) / min over the timing passes: the run-to-run
        variability."""
        if len(self.all_seconds) < 2:
            return 0.0
        return (max(self.all_seconds) - min(self.all_seconds)) / min(
            self.all_seconds
        )

    @property
    def median_seconds_per_call(self) -> float:
        s = sorted(self.all_seconds) or [self.seconds_per_call]
        return s[len(s) // 2]

    def summary(self) -> str:
        parts = [f"{self.seconds_per_call * 1e3:.3f} ms/call",
                 f"{self.samples_per_s / 1e9:.3f} Gsamp/s"]
        if self.flops_per_s is not None:
            parts.append(f"{self.flops_per_s / 1e12:.3f} TFLOP/s")
        if self.bytes_per_s is not None:
            parts.append(f"{self.bytes_per_s / 1e9:.1f} GB/s")
        if len(self.all_seconds) >= 2:
            parts.append(f"spread {self.spread * 100:.0f}%")
        return "  ".join(parts)


@dataclasses.dataclass(frozen=True)
class MarginalMeasurement:
    """Floor-free throughput: the rate from the SLOPE between two work
    scales. ``marginal_samples_per_s`` cancels a fixed per-pass cost (the
    launch and the checksum read) by construction; ``floor_seconds`` is the
    extrapolated zero-work intercept.
    """

    marginal_samples_per_s: float
    floor_seconds: float
    small: Measurement
    large: Measurement

    def summary(self) -> str:
        return (f"{self.marginal_samples_per_s / 1e9:.3f} Gsamp/s marginal"
                f"  (floor {self.floor_seconds * 1e3:.1f} ms; small/large "
                f"spreads {self.small.spread * 100:.0f}%/"
                f"{self.large.spread * 100:.0f}%)")


def measure_marginal(
    fn,
    args_small: tuple,
    args_large: tuple,
    samples_per_call: int,
    passes: int = 5,
) -> MarginalMeasurement:
    """Floor-free :func:`measure`: time ``fn`` at two repetition scales
    (``args_small``/``args_large``: same per-rep shapes, different leading
    rep counts) and report the marginal rate between them.
    """
    r1 = args_small[0].shape[0]
    r2 = args_large[0].shape[0]
    if r2 <= r1:
        raise ValueError("args_large must have more reps than args_small")
    m1 = measure(fn, args_small, samples_per_call, passes=passes)
    m2 = measure(fn, args_large, samples_per_call, passes=passes)
    t1 = m1.seconds_per_call * r1  # best total wall per pass
    t2 = m2.seconds_per_call * r2
    slope = (r2 - r1) * samples_per_call / max(t2 - t1, 1e-12)
    floor = max(t1 - r1 * samples_per_call / slope, 0.0)
    return MarginalMeasurement(
        marginal_samples_per_s=slope, floor_seconds=floor,
        small=m1, large=m2,
    )


def _pass(fn, args_per_rep: tuple, reps: int) -> tuple[float, float]:
    """One timing pass: ``(seconds, checksum)``, the checksum of every
    output accumulated on the device and read once, after the pass."""
    dev = args_per_rep[0].device
    acc = torch.zeros((), dtype=torch.float32, device=dev)
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for r in range(reps):
            acc += fn(*(a[r] for a in args_per_rep)).sum().float()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3, float(acc)
    t0 = time.perf_counter()
    for r in range(reps):
        acc += fn(*(a[r] for a in args_per_rep)).sum().float()
    check = float(acc)
    return time.perf_counter() - t0, check


def measure(
    fn,
    args_per_rep: tuple,
    samples_per_call: int,
    flops_per_call: int | None = None,
    bytes_per_call: int | None = None,
    passes: int = 5,
) -> Measurement:
    """Time ``fn`` over a repetition loop.

    ``args_per_rep``: a tuple of tensors, each with a leading repetition
    axis; rep ``r`` calls ``fn(*(a[r] for a in args_per_rep))``, so every
    call sees distinct inputs. ``fn`` must return a tensor (its sum goes
    into the checksum).

    ``passes`` timing passes are taken (at least 2) after the absorbed
    first one; the headline number is the best pass and every pass is
    recorded in ``all_seconds`` so callers can report the spread.
    """
    reps = args_per_rep[0].shape[0]
    _pass(fn, args_per_rep, reps)  # absorb builds and the first sync
    times = []
    for _ in range(max(passes, 2)):
        seconds, _ = _pass(fn, args_per_rep, reps)
        times.append(seconds / reps)
    best = min(times)
    return Measurement(
        seconds_per_call=best,
        samples_per_s=samples_per_call / best,
        flops_per_s=None if flops_per_call is None else flops_per_call / best,
        bytes_per_s=None if bytes_per_call is None else bytes_per_call / best,
        all_seconds=tuple(times),
    )
