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
   kernel's own device time from ``torch.profiler``; K3 soft's ``conv1d``
   yardstick (each rail one strided cross-correlation, TF32 off); and per
   call of the chain's ``roundtrip_fused``, ``tx_fused`` and ``rx_fused``,
   bits included.

The reference modulate -> demodulate path (``Modulator``, ``Demodulator``,
the two CLIs) runs at the JAX package's demod-bank size (``bench_demod.py``:
256 channels x 32768 samples, ``sample_rate`` 10000, carrier 2000 Hz):

7. FIR and product-detector kernels: K4 on every route (23, 32, 64 and 65
   taps compiled; 7 and 256 generic; 257 and 1000 the long route) and K5
   with its carrier table (2000 Hz at 10000) and without (2001 Hz at 10007)
   against their plain versions, at a small shape with carried state, at
   256 x 32768 and on rows of 1, 5 and 5001 samples, unit-scale inputs, max
   |error| <= 1e-5; each in ragged pushes equal to one shot exactly;
8. reference path: a 16-cycle preamble and 256 x 4096 QPSK symbols of
   passband from ``Modulator``, then ``Demodulator.lock_phase`` on 64
   samples (K4, 23 taps) and ``demodulate`` (K4) and ``demodulate_fused``
   (K5) over the rest, one shot and in 4 pushes: fused within 1e-5 of
   staged (relative to max |x|), pushes equal to one shot exactly, the card
   equal to the CPU on two channels; then the flagship chain's staged
   ``chain.roundtrip`` at 256 x 4096, which now runs K4, gives the bits back
   exactly. Each path is driven with every launch count set to 0 just
   before and read just after;
9. CLI: ``modulate`` -> i16 -> ``demodulate --fused`` on the card for one
   channel of 20,000 bits, its text equal to ``Demodulator`` called as a
   library (rtol 1e-4);
10. times: K4 on each route of phase 7 (the staged chain's 65 taps at its
   waveform's length) and K5 with and without its table per call beside
   their plain versions, the profiler's device time (which also shows that
   each count took the route ``ops.fir.fir_route`` names) and the bound,
   K4's ``conv1d`` yardstick, and ``Modulator.passband``,
   ``Demodulator.demodulate`` and ``demodulate_fused`` per call in
   samples/s, with the device's busy time per call from ``torch.profiler``
   and its idle share.

Config #3, the FSK/MSK discriminator family, at ``bench_oneway.py``'s
block (256 channels x 4096 symbols, ``Rates(1250, 10000)``: 16-MFSK at
50 Hz with the ``increase`` map, BFSK at 200 Hz, MSK, GMSK at BT 0.3):

11. FSK kernels: K6 (the loopback, noiseless and with its in-kernel noise;
    at 130 x 600 in tiles of 32 symbols, which crosses the noise stream's
    lane and tile keys, and at 256 x 4096), K8 (FSK waveform), K9 (the
    discriminator means, groups of 8 and 4) and K10 (MSK waveform) against
    their plain versions: decisions equal (with noise, on >= 99.99%),
    waveforms and means within 1e-5;
12. main path: 16-MFSK and BFSK ``FskChain`` (``roundtrip_fused``,
    ``rx_fused(tx_fused)``, the hard bits of ``rx_soft_fused``), MSK
    ``rx_fused(tx_fused)``, GMSK ``roundtrip`` and the DQPSK
    ``DifferentialChain`` (``rx_fused(tx_fused)``, ``roundtrip_fused``)
    give the bits back exactly, each path with every launch count set to 0
    just before and read just after;
13. noise: 16-MFSK ``roundtrip_fused(snr_db=21, seed)`` over 1,048,576
    symbols, SER within 10% of the staged path's (``tx``, seeded Gaussian
    noise of the same sigma, ``rx``);
14. times: K6 (without and with noise), K8, K9 and K10 per call beside
    their plain versions, the profiler's device time and the bound, and
    ``FskChain.roundtrip_fused``/``tx_fused``/``rx_fused`` and
    ``MskChain.tx_fused``/``rx_fused`` per call with the device's busy time
    and idle share.

Config #4, QAM with a rational resampler in the chain, at
``bench_rows.py:65``'s row (``ResampledChain(QAM(4, 0.0, 1.0),
Rates(1250, 10000), 3, 2)``: sps 8, 65 RRC taps, 48 + 32 resampler taps,
delay 77; 256 channels x 4096 symbols, 49,257 channel samples per
channel), and the MSK loopback at config #3's block:

15. kernel vs plain: K7 (noiseless and with noise; at 130 x 600 slots in
    tiles of 32, which crosses the noise stream's lane and tile keys, and
    at 256 x 8192 slots), K11 and K12 hard and soft (3 x 500 symbols and
    256 x 4096, at 3/2 and 2/3): decisions equal (K7 with noise on
    >= 99.99%), waveforms and soft points within 1e-5;
16. main path: config #4's ``roundtrip_fused``, ``rx_fused(tx_fused)`` and
    the hard bits of ``rx_soft_fused`` give the bits back exactly;
    ``tx_fused`` within 1e-5 of the staged ``tx``, ``rx_fused`` equal to
    ``rx``; 64-QAM and 2/3 at 64 x 1024; ``StreamingResampledChain`` in
    ragged pushes equal to one shot on 4 channels; ``MskChain
    .roundtrip_fused`` gives the bits back exactly; each path with every
    launch count set to 0 just before and read just after;
17. noise: MSK ``roundtrip_fused(snr_db=7, seed)`` against the staged path
    (``tx``, seeded noise of the same sigma, ``rx``): slot error rates
    (about 1e-2) within 10%; config #4 with seeded channel-rate noise:
    ``rx_fused`` equal to ``rx`` on >= 99.99% of the bits;
18. times: K7 (without and with noise), K11, K12 hard and soft per call
    beside their plain versions, the profiler's device time, the bound and
    K12 soft's ``conv1d`` yardstick; ``ResampledChain.tx_fused``,
    ``rx_fused``, ``roundtrip_fused`` and ``MskChain.roundtrip_fused`` per
    call with the device's busy time and idle share.

The coded link (``FramedLink`` over the flagship chain) and its windowed
Viterbi K13, at ``bench_fec.py``'s width (the CCSDS K=7 rate-1/2 code, 256
channels x 4096 data bits, windows of 512 steps with a halo of 70: 2304
trellis rows of 652 steps) and ``bench_link.py``'s (``reference_link()``,
384 frames of 1002 payload bits, 1024 QPSK symbols each):

19. K13 against its plain version, bit for bit: CCSDS at 256 x 4096 with
    windows of 512 (also 256 and 1024), noisy and noiseless; K=5 and K=7
    rate 1/3 at 64 x 1024, noisy and noiseless; ready windows with free and
    pinned ends; the warp route's packed rows (K = 2..6: 64/S rows a warp)
    with a partly empty last warp, windows of 203 steps (no multiple of
    8), free and pinned ends mixed, on zero and signed-zero LLRs (every
    compare ties), on -1/0/+1 LLRs and on LLRs of magnitude 1e4;
20. main path: ``reference_link()`` at 384 frames, ``tx_fused`` -> seeded
    AWGN at 2 dB -> ``rx_fused``, every payload back and every CRC true,
    with K2, K3 soft and K13 launched; then K2 and K3 soft against their
    plain versions on that run's symbols and waveform, and K13 bit for bit
    on its deinterleaved LLRs (768 rows of 652 steps);
    ``ccsds_deep_space_link()`` at 0 dB
    and ``dvb_like_link()`` at 3 dB at 64 frames, exact; CRC, scrambler and
    RS on CUDA tensors equal to the CPU; ``StreamingViterbi`` pushes equal
    to one shot;
21. CLI: ``link tx`` -> ``link rx`` on the card for 40 frames, every
    payload back with 40 ``frame: OK`` lines, K13 launched;
22. times: K13 and its plain version per call, the profiler's device time,
    the bound, the time per trellis step, the share of the bound and the
    serial floor, at bench_fec's width and at ``reference_link()``'s 768
    rows; ``decode_soft_windowed``'s info rate; ``FramedLink.tx_fused`` and ``rx_fused`` per call at 384
    frames (and the RS presets' ``rx_fused`` at 64) with the device's busy
    time and idle share.

The modes of K1-K3 (the passband NCO at 2000 Hz, a table of 5 phases, and
at 1700 Hz, a table of 100, both at 10000; algebraic 256-QAM; bf16
and int16 waveforms; K1's in-kernel noise at baseband and passband), the
BER harness on them, and K13 on the code shapes its repair widened:

23. (a) each mode against its plain version at 130 x 600 symbols with
    ``sym_offset`` -16 (K1 in tiles of 32, which crosses the noise
    stream's lane and tile keys) and at 256 x 4096: decisions equal (K1
    with noise on >= 99.99%), waveforms and soft points within 1e-5, bf16
    within one bf16 ulp, int16 within one step;
24. (b) the passband main path, ``PulseShapedChain(QPSK(0.0, 1.0),
    Rates(1250, 10000), carrier_hz=2000)`` (and 1700 Hz) at 256 x 4096:
    ``roundtrip_fused``, ``rx_fused(tx_fused)`` and the hard bits of
    ``rx_soft_fused`` give the bits back exactly, the three streaming
    classes in 4 pushes equal one shot, ``tx_fused(out_scale=...)`` (int16)
    then ``rx_fused``; natural 256-QAM ``roundtrip_fused`` and
    ``rx_fused(tx_fused)``; the flagship's bf16 ``tx_fused`` then
    ``rx_fused``; each path with every launch count set to 0 just before
    and read just after;
25. (c) the harness: ``fused_ber_point`` for QPSK at 7 dB (and K1's noise
    at passband) within 10% of ``qpsk_ber_theory``, natural 16-QAM at 14 dB
    within 10% of ``mqam_ber_theory``, a monotone ``ber_waterfall``,
    ``release_gates(scale=4)`` with gates 1, 2 and 4 passed and 3 and 5 not
    run; ``fused_ber_point`` per call in bits/s;
26. (d) K13 at K = 3 (S = 4, the warp route) and K = 15 (the block route)
    through ``decode_soft_windowed``, bit for bit against the plain
    version;
27. (e) times: each mode's kernel and plain version per call, the
    profiler's device time and the bound; widened K13 per call, per
    trellis step, its share of the bound and its serial floor.

The turbo and polar inner codes, at ``bench_fec.py``'s widths
(``TurboCode(1024)`` at 512 codewords, 6 iterations; ``PolarCode(256,
128)`` at 4096 codewords, CRC-16 inside K) and ``bench_link.py``'s frame
count (256):

28. K14 against its plain version, bit for bit: both half-iterations of a
    first iteration at ``pick_geometry`` (one window of 1092 steps a row,
    512 rows) on BPSK LLRs at 1 dB; K = 40 with an explicit window of 16
    (``pick_guard``: guard 34), and ``decode(window=16)`` against the CPU
    route at that guard; an odd window refused;
29. ``TurboCode(1024).decode`` at 512 codewords, fixed and with early
    exit, launch counts set to 0 just before and read just after:
    decisions equal to the plain route's (the CPU full-block BCJR, which
    ``pick_geometry``'s one window equals) and to the sent bits;
30. K15 and K16 against their plain versions at 4096 x (256, 128), noise
    sigma 0.3 and 0.8: SC u and x, CA-SCL-8 u and path metrics bit for
    bit; ``decode`` and ``decode_list(8, crc)`` equal to the CPU route;
    K16 also at the link's 1024 codewords;
31. main paths: ``lte_like_turbo_link()`` at 256 frames and 1 dB per
    complex sample (K14), ``nr_like_control_link()`` at 3 dB (K16) and
    ``nr_like_control_link(list_size=None)`` at 5 dB (K15), each
    ``tx_fused`` -> seeded AWGN -> ``rx_fused`` with every launch count
    set to 0 just before: every payload back, every CRC true, K2, K3 soft
    and the inner kernel launched; then the inner kernel bit for bit
    against its plain version on that run's own inputs;
32. CLI: ``link tx`` -> ``link rx`` on the card for ``lte_like_turbo``
    and ``nr_like_control``, 16 frames each, every verdict OK;
33. times: K14, K15, K16 and their plain versions per call, the
    profiler's device time and the bound; K16 also at 1024 codewords, and
    its serial floor (one codeword's chain of dependent operations); the
    turbo and polar encoders and decoders in Mbit/s; the two presets'
    ``frame``, ``tx_fused`` and ``rx_fused`` per call at 256 frames with
    the device's busy time and idle share.

K1's and K3's long route, for chains past the short route's 256 taps or 64
samples a symbol:

34. ``PulseShapedChain(QPSK)`` at sps 8 and span 32 (257 taps), sps 20
    and span 16 (321 taps), sps 96 and span 1, 256 x 1024 symbols:
    ``roundtrip_fused``, ``rx_fused(tx_fused)`` and ``rx_soft_fused`` give
    the bits back with K1, K3 hard and K3 soft launched (counts set to 0
    just before, read just after); each kernel against its plain version
    (decisions bit for bit, soft points within 1e-5) and its times.

K4's generic and long routes and K5 without its carrier table, through the
demodulator a user builds with other filters or another carrier:

35. ``Demodulator(2000, 10000, hilbert=<7 taps>, lowpass=<256 taps>)``:
    ``lock_phase`` (K4 generic, 7 taps) and ``demodulate`` (K4 generic, 256
    taps); ``lowpass`` of 257 and 1000 taps: ``demodulate`` (the long
    route); ``Demodulator(2001, 10007)``: ``lock_phase`` and
    ``demodulate_fused`` (K5 without a table) against ``demodulate``; each at
    256 x 32768 with the launch counts set to 0 just before and read just
    after, and the card against the CPU on two channels.

Then a JSON line of the kernels (K1, K2, K3 hard and soft, K4 with the
demodulator's 64-tap lowpass, the chain's 65-tap RRC and each other count of
phase 7, K5 with and without its carrier table; K6
without and with noise, with ``agreement``, the share of its decisions
equal to the plain version's; K8; K9 on the FSK symbol and the MSK slot;
K10; K7 without and with noise, with ``agreement``; K11; K12 hard and
soft; K13; each mode of K1-K3, K1 with noise with ``agreement``; K13 at
K = 3 and 15; K14, K15, K16; K1, K3 hard and K3 soft on each long-route
chain), each
with its launches on its path, error, per-call times (``ms`` from CUDA
events, ``device_ms`` from the profiler), the least time the card could
take (``bound_ms``: the larger of the bytes it must move at 3.35 TB/s and
its f32 operations at 67 TFLOP/s, the H100 SXM's published peaks at 700 W;
``bound_by`` says which) and the time of one PyTorch call computing the
same function where there is one (``library_ms``, else null); then the
card's name and power limit, and last ``{"ok": true, "device": {...}}``.
Any failure exits non-zero before that line; without a CUDA device it
exits non-zero at once.
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
# the reference path at bench_demod.py's demod bank
REF_SR, REF_CF, REF_BAUD = 10000, 2000, 1250
#: K4's routes: the tap counts of the paths (23 the Hilbert filter, 32 the
#: GMSK transient, 64 the lowpass, 65 the RRC: compiled), 7 and 256 (the
#: generic instantiation), 257 and 1000 (the long route)
FIR_ROUTE_TAPS = (23, 32, 64, 65, 7, 256, 257, 1000)
FIR_ROWS = ((3, 1), (3, 5), (3, 5001))  # one sample, under K-1, odd
FIR_PUSHES = (0, 5, 6, 9, 2100, 2150, 2151, 9000)
#: K5's carriers and their report names: 2000 Hz at 10000 (a table of 5
#: phases), 2001 Hz at 10007 (10007 phases: no table, a sincosf a sample)
K5_UNTABLED = (2001, 10007)
DEMOD_NAMES = {(REF_CF, REF_SR): "fused_product_detect",
               K5_UNTABLED: "fused_product_detect_untabled"}
REF_SAMPLES = 32768              # per channel and block: 4096 QPSK symbols
PREAMBLE_CYCLES = 16
CLI_BITS = 20000
# config #3, the FSK/MSK family, at bench_oneway.py's rates (sps 8)
FSK_BAUD = 1250
FSK_SMALL = (130, 600)           # crosses the noise stream's lane and tile keys
FSK_SMALL_CHUNK = 32
FSK_SIDE_CHANNELS = 256          # BFSK and GMSK channels in phase 12
FSK_SNR_DB = 21.0                # per complex sample: 16-MFSK SER ~1e-2
FSK_AGREE = 0.9999               # noisy K6 decisions, kernel vs plain
FSK_SER_RTOL = 0.10
#: profiler name and replaced TPU kernel of each config #3 report entry
FSK_REPORT = {
    "fused_fsk_chain": ("63", "fsk_chain_kernel"),
    "fused_fsk_chain_noisy": ("63", "fsk_chain_kernel"),
    "fused_fsk_tx": ("460", "fsk_tx_kernel"),
    "fused_discriminator_means": ("545", "disc_means_kernel"),
    "fused_discriminator_means_msk": ("545", "disc_means_kernel"),
    "fused_msk_tx": ("621", "msk_tx_kernel"),
}
# config #4 at bench_rows.py:65's row, and the MSK loopback
RS_UP, RS_DOWN = 3, 2
RS_SIDE = (64, 1024)             # 64-QAM and 2/3 in phase 16
RS_STREAM_CHANNELS = 4
RS_STREAM_CUTS = (7, 1, 1000, 2000)  # ragged pushes, then the rest
RS_NOISE_SNR_DB = 5.0            # per channel sample: 16-QAM BER ~3e-3
RS_AGREE = 0.9999
MSK_SMALL = (130, 600)
MSK_SNR_DB = 7.0                 # per complex sample: slot SER ~9e-3
MSK_SER_RTOL = 0.10
#: profiler name, source and replaced TPU kernel of each config #4 and MSK
#: loopback report entry
RS_REPORT = {
    "fused_msk_slots": ("msk_chain_kernel", "modem_tpu_torch/csrc/fsk.cu",
                        "modem_tpu/ops/pallas_fsk.py:313"),
    "fused_msk_slots_noisy": ("msk_chain_kernel",
                              "modem_tpu_torch/csrc/fsk.cu",
                              "modem_tpu/ops/pallas_fsk.py:313"),
    "fused_resampled_tx": ("resampled_tx_kernel",
                           "modem_tpu_torch/csrc/resampled.cu",
                           "modem_tpu/ops/pallas_resampled.py:111"),
    "fused_resampled_rx": ("resampled_rx_kernel<false>",
                           "modem_tpu_torch/csrc/resampled.cu",
                           "modem_tpu/ops/pallas_resampled.py:235"),
    "fused_resampled_rx_soft": ("resampled_rx_kernel<true>",
                                "modem_tpu_torch/csrc/resampled.cu",
                                "modem_tpu/ops/pallas_resampled.py:235"),
}
# the coded link: bench_fec.py:48-50,121-125's Viterbi width and
# bench_link.py:101-104's reference_link() block
VIT_CHANNELS, VIT_BITS = 256, 4096
VIT_BLOCK, VIT_HALO = 512, 70
VIT_SIDE = (64, 1024)            # K=5 and rate 1/3 in phase 19
LINK_FRAMES = 384
LINK_SNR_DB = 2.0                # per complex sample
RS_LINK_FRAMES = 64
RS_LINK_SNR_DB = {"ccsds_deep_space_link": 0.0, "dvb_like_link": 3.0}
CLI_FRAMES = 40
#: the warp route's packed rows in phase 19: (K, polynomials) for S = 2..32
#: and the window length (no multiple of 8)
VIT_PACKED = ((2, (0o3, 0o1)), (3, (0o7, 0o5)), (4, (0o15, 0o17)),
              (5, (0o23, 0o35)), (6, (0o53, 0o75)))
VIT_PACKED_TW = 203
#: K13's serial floor: the dependent f32 operations of one ACS step (the
#: candidate's add, the compare, the select; each at K14_CHAIN_CYCLES), the
#: renormalisation's share (a min tree over the S states and a subtract,
#: every 8 steps), and the traceback's dependent operations a step (the
#: decision's shift and mask, the state's shift-or), counted apart
K13_ACS_OPS, K13_TRACE_OPS = 3, 3
VIT_REPORT = ("viterbi_decode_stream", "viterbi_kernel",
              "modem_tpu_torch/csrc/viterbi.cu",
              "modem_tpu/ops/pallas_viterbi.py:102")
# the K1-K3 modes (passband at 2000 Hz, a table of 5 phases, and 1700 Hz,
# a table of 100; 256-QAM; bf16 and int16 waveforms; K1's noise),
# the harness and widened K13
MODE_SMALL = (130, 600)          # crosses the noise stream's lane and tile keys
MODE_SMALL_CHUNK = 32
MODE_SNR_DB = 7.0                # Es/N0: QPSK BER ~1.3e-2
MODE_AGREE = 0.9999              # noisy K1 decisions, kernel vs plain
MODE_QAM_BPS = 8
NCO_TABLE = 2048                 # carrier phases K1-K3 take from a table
MODE_OUT_SCALE = 8000.0          # int16 wire format, peaks well inside
GATES_SCALE = 4
WIDE_VIT = {"viterbi_k3": (3, (0o7, 0o5)),
            "viterbi_k15": (15, (0o74653, 0o61535))}
WIDE_VIT_SHAPE = (16, 1024)      # channels x data bits
WIDE_VIT_BLOCK = 256
# the turbo and polar inner codes: bench_fec.py:405-408's turbo width,
# :282-284 and :318-356's polar width, bench_link.py:115-120's frame count
TURBO_K, TURBO_CW, TURBO_ITERS = 1024, 512, 6
TURBO_SNR_DB = 1.0               # per code bit (BPSK LLRs)
TURBO_SMALL = (40, 16)           # K, an explicit window through pick_guard
TURBO_WINDOW = 256               # K14's many-row shape: 2560 rows of 324 steps
#: K14's dependent f32 operations a trellis step (an add, the pair's max,
#: the three-level max tree, the renormalising subtract) and the cycles each
#: takes to feed the next (the arithmetic pipes' latency on this card)
K14_CHAIN_OPS, K14_CHAIN_CYCLES = 6, 4
POLAR_N, POLAR_K, POLAR_CW = 256, 128, 4096
POLAR_SIGMAS = (0.3, 0.8)        # bench_fec's noise, and a noisier one
POLAR_LINK_CW = 1024             # nr_like_control_link().rx_fused's, 256 frames
#: K16's serial chain a codeword, in dependent f32 operations: an f's
#: (the sign product, the product with the min, and the min or sign before
#: them: 3) on each of the n - 1 left turns of the walk, a g's (one add) on
#: each of the n - 1 right turns, a leaf's metric add, and an info leaf's
#: ranking (a compare, then the sum of two lanes' counts: 2); each takes
#: K14_CHAIN_CYCLES to feed the next
K16_F_OPS, K16_G_OPS, K16_LEAF_OPS, K16_RANK_OPS = 3, 1, 1, 2
#: K1's and K3's long route: (Rates, span) past 256 taps or 64 samples a
#: symbol (sps 8 span 32, sps 20 span 16, sps 96 span 1), 256 x 1024 symbols
LONG_ROUTE = ((1250, 10000, 32), (500, 10000, 16), (100, 9600, 1))
LONG_SYMBOLS = 1024
FEC_LINK_FRAMES = 256
FEC_LINK_SNR_DB = (1.0, 3.0, 5.0)  # turbo, polar SCL-8, polar SC
TURBO_NAME, SC_NAME, SCL_NAME = "bcjr_half_iteration", "polar_sc", "polar_scl8"
#: profiler name, source and replaced TPU kernel of each K14-K16 entry
FEC_REPORT = {
    TURBO_NAME: ("bcjr_kernel", "modem_tpu_torch/csrc/bcjr.cu",
                 "modem_tpu/ops/pallas_bcjr.py:145"),
    SC_NAME: ("sc_kernel", "modem_tpu_torch/csrc/polar.cu",
              "modem_tpu/ops/pallas_sc.py:54"),
    SCL_NAME: ("scl_kernel", "modem_tpu_torch/csrc/polar.cu",
               "modem_tpu/ops/pallas_scl.py:75"),
}
# the H100 SXM's published peaks at 700 W: HBM bytes/s, f32 FLOP/s (CUDA cores)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def sm_clock_mhz() -> float:
    """The card's highest SM clock, as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0])


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


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """The least time in ms the card could take: the larger of moving
    ``nbytes`` at the HBM peak and doing ``flops`` at the f32 peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def chain_work(chain, name: str, c: int, k: int) -> tuple[float, float]:
    """Bytes each of K1-K3 must move (each input read once, each output
    written once) and the f32 operations it must do for ``c`` channels of
    ``k`` symbols. L taps: the TX makes (k+span)*sps samples per rail, L
    MACs per symbol and rail in all; the matched filter needs L MACs per
    rail at each of the k decision instants; a min-distance slice over M
    points costs 5 operations per point (2 differences, 2 squares, a sum)."""
    m, taps = chain.lut.shape[0], chain.rrc.shape[0]
    n_wave = (k + chain.span) * chain.sps
    params = 4 * (2 * m + taps)
    tx_ops = 2 * 2 * (k + chain.span) * taps * c
    rx_ops = 2 * 2 * k * taps * c
    slice_ops = 5 * m * k * c
    if name == "fused_pulse_chain":
        return 4 * c * k * 2 + params, tx_ops + rx_ops + slice_ops
    if name == "fused_tx":
        return 4 * c * k + 2 * 4 * c * n_wave + params, tx_ops
    if name == "fused_rx":
        return 2 * 4 * c * n_wave + 4 * c * k + params, rx_ops + slice_ops
    return 2 * 4 * c * n_wave + 2 * 4 * c * k + params, rx_ops  # soft


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    from modem_tpu_torch.ops import (bcjr_kernel, chain_kernel, demod_kernel,
                                     fir, fsk_kernel as fk,
                                     resampled_kernel as rk, sc_kernel,
                                     scl_kernel, txrx, viterbi_kernel as vk)

    for k in (chain_kernel.CHAIN_KERNEL, txrx.TX_KERNEL, txrx.RX_HARD_KERNEL,
              txrx.RX_SOFT_KERNEL, fir.FIR_KERNEL, demod_kernel.DEMOD_KERNEL,
              fk.FSK_CHAIN_KERNEL, fk.FSK_TX_KERNEL, fk.DISC_MEANS_KERNEL,
              fk.MSK_TX_KERNEL, fk.MSK_CHAIN_KERNEL, rk.RESAMPLED_TX_KERNEL,
              rk.RESAMPLED_RX_KERNEL, vk.VITERBI_KERNEL,
              vk.VITERBI_BLOCK_KERNEL, bcjr_kernel.BCJR_KERNEL,
              sc_kernel.SC_KERNEL, scl_kernel.SCL_KERNEL):
        k.launches = 0


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
    reset_launches()

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
    """Device time per launch of the CUDA kernel whose name, spaces dropped,
    contains ``symbol``, from ``torch.profiler``; None if the trace has
    none."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn(*args)
        torch.cuda.synchronize(device)
    for evt in prof.key_averages():
        if symbol in evt.key.replace(" ", "") and evt.count:
            total = getattr(evt, "device_time_total", None)
            if total is None:
                total = evt.cuda_time_total
            return total / evt.count / 1e3
    return None


def device_busy_ms(fn, args, device, calls=20) -> float:
    """Device time per call summed over every kernel and copy the call
    runs, from ``torch.profiler`` (one stream: nothing overlaps)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn(*args)
        torch.cuda.synchronize(device)
    return sum(e.device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / calls / 1e3


#: substring of each kernel's name in a profiler trace
DEVICE_NAMES = {"fused_pulse_chain": "pulse_chain_kernel",
                "fused_tx": "pulse_tx_kernel",
                "fused_rx": "pulse_rx_kernel<false,",
                "fused_rx_soft": "pulse_rx_kernel<true,"}


def kernel_times(kern, plain, args, device, symbol: str, plain_calls=20):
    """(kernel ms, plain ms, kernel's profiler ms) per call, taken plain,
    kernel, kernel, plain: each number is the mean of its pair; the plain
    version over ``plain_calls`` calls a run."""
    p1 = time_calls(plain, args, device, calls=plain_calls)
    k1 = time_calls(kern, args, device)
    k2 = time_calls(kern, args, device)
    p2 = time_calls(plain, args, device, calls=plain_calls)
    return ((k1 + k2) / 2, (p1 + p2) / 2,
            kernel_device_ms(kern, args, device, symbol))


def rx_conv1d_yardstick(args):
    """K3 soft at baseband f32 as ``conv1d``: each rail is one strided
    cross-correlation with the flipped taps, ``stride=sps``; the matched
    filter's window of decision m starts at sample m*sps, so no padding
    (zero history) is needed. Returns ``(fn, fn args, max |error| against
    the kernel)``; the port never calls it."""
    import torch.nn.functional as F
    from modem_tpu_torch.ops import txrx

    wi, wq, k, _, taps, sps, _, _ = args
    w = taps.flip(0).reshape(1, 1, -1).contiguous()

    def both(xi, xq, w):
        return (F.conv1d(xi, w, stride=sps), F.conv1d(xq, w, stride=sps))

    xi, xq = wi.unsqueeze(1), wq.unsqueeze(1)
    got = tuple(o[:, 0, :k] for o in both(xi, xq, w))
    err = max_err(got, txrx.rx_kernel(*args))
    return both, (xi, xq, w), err


def phase_times(chain, device, card: str) -> dict:
    """Phase 6: kernel and plain time per call at the flagship shape, and
    K3 soft's ``conv1d`` yardstick."""
    syms = random_symbols((CHANNELS, N_SYMBOLS), device, False)
    samples = CHANNELS * N_SYMBOLS * chain.sps
    times = {}
    for name, _, kern, plain, make_args, _, _, _ in kernel_cases(chain):
        args = make_args(syms)
        ms, plain_ms, dev_ms = kernel_times(kern, plain, args, device,
                                            DEVICE_NAMES[name])
        lib_ms, lib_txt = None, "no library call"
        if name == "fused_rx_soft":
            fn, fargs, lib_err = rx_conv1d_yardstick(args)
            if lib_err > 1e-4:
                fail(f"conv1d yardstick disagrees with K3 soft ({lib_err})")
            lib_ms = time_calls(fn, fargs, device)
            lib_dev = device_busy_ms(fn, fargs, device)
            lib_txt = (f"conv1d {lib_ms:.4f} ms, device busy {lib_dev:.4f} ms"
                       f" (max |err| vs K3 {lib_err:.2e})")
        times[name] = (ms, plain_ms, dev_ms, lib_ms)
        dev_txt = ("not measured" if dev_ms is None else
                   f"{dev_ms:.4f} ms ({samples / dev_ms * 1e3:.4e} samples/s)")
        print(f"[times] {name:18s} per call: kernel {ms:.4f} ms "
              f"({samples / ms * 1e3:.4e} samples/s), plain {plain_ms:.4f} ms "
              f"({samples / plain_ms * 1e3:.4e} samples/s), {lib_txt}; "
              f"kernel alone in the profiler {dev_txt}; {CHANNELS} ch x "
              f"{N_SYMBOLS} sym x sps {chain.sps} on {card}", flush=True)
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


# ---- the reference modulate -> demodulate path ----

def unit(shape, gen, device) -> torch.Tensor:
    """Uniform float32 in [-1, 1) on ``device``."""
    return torch.rand(shape, generator=gen, device=device) * 2.0 - 1.0


def windowed_lowpass(n: int):
    """An ``n``-tap Kaiser-windowed sinc lowpass, cut-off at a quarter of
    the sample rate, unit DC gain (float32 numpy)."""
    import numpy as np

    m = np.arange(n) - (n - 1) / 2.0
    h = np.sinc(0.25 * m) * 0.25 * np.kaiser(n, 6.0)
    return (h / h.sum()).astype(np.float32)


def path_taps(chain, device) -> dict:
    """K4's filters by length (FIR_ROUTE_TAPS): the Hilbert FIR of
    ``lock_phase`` (23), the demodulator's lowpass (64), the staged chain's
    RRC (65), a 7-tap Hilbert FIR and windowed lowpasses for the other
    counts."""
    from modem_tpu_torch.ops import filters

    taps = {23: filters.hilbert_taps(), 7: filters.hilbert_taps(7),
            64: filters.lowpass_taps(sample_rate=REF_SR)}
    out = {k: torch.as_tensor(taps[k] if k in taps else windowed_lowpass(k),
                              device=device) for k in FIR_ROUTE_TAPS}
    out[65] = chain.rrc
    return out


def fir_name(k: int) -> str:
    """The report name of K4 at ``k`` taps."""
    return {64: "fir_filter", 65: "fir_filter_rrc"}.get(k, f"fir_filter_{k}")


def fir_symbol(k: int) -> str:
    """The profiler name of the K4 instantiation ``ops.fir.fir_route``
    sends ``k`` taps to."""
    from modem_tpu_torch.ops import fir

    return {"fixed": f"fir_core_kernel<{k}>", "generic": "fir_core_kernel<0>",
            "long": "fir_long_kernel"}[fir.fir_route(k)]


def demod_symbol(k: int, hz: int, sr: int) -> str:
    """The profiler name (spaces dropped) of the K5 instantiation for ``k``
    taps and the carrier ``hz`` at ``sr``."""
    from modem_tpu_torch.ops import demod_kernel as dk

    table = dk.carrier_walk(hz, sr)[3]
    return (f"demod_kernel<{k if k in (64, 65) else 0},"
            f"{'true' if table else 'false'}>")


def fir_case(taps, shape, gen, device):
    """K4's arguments ``(x, taps, state)``: unit-scale input and carried
    history."""
    k = taps.shape[0]
    return (unit(shape, gen, device), taps,
            unit(shape[:-1] + (k - 1,), gen, device))


def demod_case(taps, shape, gen, device, hz=REF_CF, sr=REF_SR):
    """K5's arguments ``(x, history, taps, hz, sr, off, phi)``: unit-scale
    passband, the lowpass's lookback of history, a phase per channel and a
    stream counter."""
    hist = unit(shape[:-1] + (taps.shape[0] - 1,), gen, device)
    phi = unit(shape[:-1], gen, device) * math.pi
    off = torch.tensor(9971, dtype=torch.int32, device=device)
    return (unit(shape, gen, device), hist, taps, hz, sr, off, phi)


def phase_ref_kernels(chain, device) -> dict:
    """Phase 7: K4 on every route and K5 with and without its carrier table
    against their plain versions, at a small shape, at 256 x 32768 and on
    short and odd rows, then in ragged pushes against one shot (exact);
    returns the max |error| of each report entry."""
    from modem_tpu_torch.ops import demod_kernel as dk, fir

    gen = torch.Generator(device=device).manual_seed(SEED + 5)
    taps = path_taps(chain, device)
    errs = {}

    def check(entry, what, shape, got, want):
        torch.cuda.synchronize(device)
        err = max_err(got, want)
        if err > ATOL:
            fail(f"{what} at {shape}: kernel vs plain max |err| {err}")
        errs[entry] = max(errs.get(entry, 0.0), err)
        print(f"[kernels] {what:34s} {shape[0]:4d} ch x {shape[1]:5d} "
              f"samples: max |kernel - plain| = {err:.3e} (tol {ATOL})",
              flush=True)

    def pushes_equal(what, one, parts):
        torch.cuda.synchronize(device)
        if not torch.equal(torch.cat(parts, -1), one):
            fail(f"{what} in {len(parts)} pushes differs from one shot")
        print(f"[kernels] {what} in {len(parts)} ragged pushes == one shot "
              "(exact)", flush=True)

    for k in FIR_ROUTE_TAPS:
        what = f"fir_filter {k} taps ({fir.fir_route(k)})"
        for shape in ((3, 5000), (CHANNELS, REF_SAMPLES), *FIR_ROWS):
            args = fir_case(taps[k], shape, gen, device)
            check(fir_name(k), what, shape, fir.fir_kernel(*args),
                  fir.fir_plain(*args))
        x = unit((4, FIR_PUSHES[-1]), gen, device)
        state, parts = None, []
        for a, b in zip(FIR_PUSHES[:-1], FIR_PUSHES[1:]):
            y, state = fir.fir_filter(x[:, a:b], taps[k], state)
            parts.append(y)
        pushes_equal(what, fir.fir_filter(x, taps[k])[0], parts)

    lowpass = taps[64]
    for (hz, sr), name in DEMOD_NAMES.items():
        what = f"{name} {hz} Hz at {sr}"
        for shape in ((3, 5000), (CHANNELS, REF_SAMPLES), (3, 1), (3, 5001)):
            args = demod_case(lowpass, shape, gen, device, hz, sr)
            check(name, what, shape, dk.demod_kernel(*args),
                  dk.demod_plain(*args))
        x = unit((4, FIR_PUSHES[-1]), gen, device)
        phi = unit((4,), gen, device) * math.pi
        s0, lb = -12345, lowpass.shape[0] - 1
        hist, parts = x.new_zeros((4, lb)), []
        for a, b in zip(FIR_PUSHES[:-1], FIR_PUSHES[1:]):
            parts.append(torch.stack(dk.fused_product_detect(
                x[:, a:b], hz, sr, lowpass, phi, s0 + a, hist)))
            hist = torch.cat([hist, x[:, a:b]], -1)[:, -lb:]
        pushes_equal(what, torch.stack(dk.fused_product_detect(
            x, hz, sr, lowpass, phi, s0)), parts)
    return errs


def ref_bits(gen, device) -> torch.Tensor:
    """Random bits for one block of the demod bank: 4096 QPSK symbols on
    each of ``CHANNELS`` channels."""
    n_bits = REF_SAMPLES // (REF_SR // REF_BAUD) * 2
    return torch.randint(0, 2, (CHANNELS, n_bits), generator=gen,
                         device=device, dtype=torch.int32)


def reference_path(device, bits, launches=None):
    """The reference's path as a user drives it: ``Modulator`` (preamble,
    then QPSK passband), ``Demodulator.lock_phase`` on the first 64 samples,
    then ``demodulate`` and ``demodulate_fused`` over the rest. Returns
    ``(modulator, demodulator, x, locked state, staged (i, q), fused
    (i, q))``. With ``launches``, every launch count is set to 0 just
    before ``lock_phase`` and again just after it, where its K4 launches
    (23 taps) go into ``launches["fir_filter_23"]``."""
    from modem_tpu_torch import Demodulator, Modulator, Rates, make_scheme
    from modem_tpu_torch.ops import fir

    rates = Rates(REF_BAUD, REF_SR)
    n_ch = bits.shape[0]
    mod = Modulator(make_scheme("qpsk", rates), rates, carrier_hz=REF_CF,
                    device=device)
    state = mod.init_state((n_ch,))
    tone, state = mod.preamble(PREAMBLE_CYCLES, state)
    wave, state = mod.passband(bits, state)
    x = torch.cat([tone.expand(n_ch, -1), wave], dim=-1)
    dem = Demodulator(REF_CF, REF_SR, device=device)
    if launches is not None:
        reset_launches()
    locked = dem.lock_phase(x[:, :64], dem.init_state((n_ch,)))
    if launches is not None:
        torch.cuda.synchronize(device)
        launches["fir_filter_23"] = fir.FIR_KERNEL.launches
        reset_launches()
    staged, _ = dem.demodulate(x[:, 64:], locked)
    fused, _, _ = dem.demodulate_fused(x[:, 64:], locked)
    return mod, dem, x, locked, staged, fused


def phase_ref_path(chain, device) -> dict:
    """Phase 8: the reference path at 256 x 32768 on the card, one shot and
    in 4 pushes, then the card against the CPU on two channels, then the
    flagship chain's staged form; returns the launch counts of each path's
    run."""
    from modem_tpu_torch.ops import demod_kernel as dk, fir

    g = torch.Generator(device=device).manual_seed(SEED + 6)
    bits = ref_bits(g, device)
    launches = {}
    _, dem, x, locked, staged, fused = reference_path(device, bits, launches)
    rest = x[:, 64:]
    n = rest.shape[-1]
    cuts = (0, 1000, 1031, n // 2, n)
    s_staged = s_fused = locked
    tail, parts_staged, parts_fused = None, [], []
    for a, b in zip(cuts[:-1], cuts[1:]):
        y, s_staged = dem.demodulate(rest[:, a:b], s_staged)
        parts_staged.append(y)
        y, s_fused, tail = dem.demodulate_fused(rest[:, a:b], s_fused, tail)
        parts_fused.append(y)
    torch.cuda.synchronize(device)
    launches.update({"fir_filter": fir.FIR_KERNEL.launches,
                     "fused_product_detect": dk.DEMOD_KERNEL.launches})
    print(f"[ref] {CHANNELS} ch x {x.shape[-1]} samples ({PREAMBLE_CYCLES}-"
          f"cycle preamble + {bits.shape[-1] // 2} QPSK symbols), launches: "
          f"{json.dumps(launches)}", flush=True)

    scale = float(x.abs().max())
    err = max_err(fused, staged)
    print(f"[ref] demodulate_fused vs demodulate: max |err| {err:.3e} "
          f"(tol {ATOL} x max |x| = {ATOL * scale:.3e})", flush=True)
    if err > ATOL * scale:
        fail("demodulate_fused differs from demodulate")
    for name, parts, one in (("demodulate", parts_staged, staged),
                             ("demodulate_fused", parts_fused, fused)):
        for r in range(2):
            if not torch.equal(torch.cat([p[r] for p in parts], dim=-1),
                               one[r]):
                fail(f"{name} in {len(parts)} pushes differs from one shot")
        print(f"[ref] {name} in {len(parts)} pushes == one shot (exact)",
              flush=True)

    _, _, xc, lc, sc, fc = reference_path(torch.device("cpu"), bits[:2].cpu())
    for name, got, want in (("passband", x[:2], xc),
                            ("phase_offset", locked.phase_offset[:2],
                             lc.phase_offset),
                            ("demodulate", tuple(v[:2] for v in staged), sc),
                            ("demodulate_fused", tuple(v[:2] for v in fused),
                             fc)):
        if isinstance(got, tuple):
            got = tuple(v.cpu() for v in got)
        else:
            got = got.cpu()
        err = max_err(got, want)
        print(f"[ref] card vs CPU, 2 channels, {name}: max |err| {err:.3e}",
              flush=True)
        if err > ATOL * scale:
            fail(f"{name} on the card differs from the CPU")

    bits = torch.randint(0, 2, (CHANNELS, N_SYMBOLS * chain.bits_per_symbol),
                         generator=g, device=device, dtype=torch.int32)
    reset_launches()
    out = chain.roundtrip(bits)
    torch.cuda.synchronize(device)
    launches["fir_filter_rrc"] = fir.FIR_KERNEL.launches
    if not torch.equal(out, bits):
        fail("staged chain.roundtrip(bits) != bits")
    print(f"[ref] staged chain.roundtrip(bits) == bits at {CHANNELS} ch x "
          f"{N_SYMBOLS} sym, K4 launches {launches['fir_filter_rrc']}",
          flush=True)
    for name, count in launches.items():
        if count == 0:
            fail(f"the path never launched the {name} kernel")
    return launches


def phase_cli(device) -> None:
    """Phase 9: ``modulate`` -> i16 -> ``demodulate --fused`` on the card,
    the text equal to ``Demodulator`` called as a library."""
    import io
    import numpy as np
    from modem_tpu_torch import Demodulator
    from modem_tpu_torch import io as mio
    from modem_tpu_torch.cli import demodulate as cli_demod
    from modem_tpu_torch.cli import modulate as cli_mod
    from modem_tpu_torch.ops import demod_kernel as dk

    bits = np.random.default_rng(SEED).integers(0, 2, CLI_BITS)
    common = ["-c", str(REF_CF), "-r", str(REF_SR), "--device", str(device)]
    out = io.BytesIO()
    cli_mod.run(cli_mod.build_parser().parse_args(
        ["-m", "qpsk", "-b", str(REF_BAUD), "-p", str(PREAMBLE_CYCLES),
         *common]), "".join("01"[b] for b in bits).encode(), out)
    wave = mio.f32le_to_f32(out.getvalue())
    i16 = np.round(wave * (0.9 * 32767 / np.abs(wave).max())).astype("<i2")
    reset_launches()
    text = io.BytesIO()
    cli_demod.run(cli_demod.build_parser().parse_args(["--fused", *common]),
                  i16.tobytes(), text)
    torch.cuda.synchronize(device)
    k5 = dk.DEMOD_KERNEL.launches
    got = np.array([float(v.split(b":")[1])
                    for line in text.getvalue().splitlines()
                    for v in line.split(b"\t")])

    x = torch.as_tensor(i16.astype(np.float32), device=device)
    dem = Demodulator(REF_CF, REF_SR, device=device)
    locked = dem.lock_phase(x[:64], dem.init_state())
    (i, q), _, _ = dem.demodulate_fused(x[64:], locked)
    want = torch.stack([i, q], dim=-1).reshape(-1).double().cpu().numpy()
    if got.shape != want.shape:
        fail(f"demodulate printed {got.size} values, the library "
             f"{want.size}")
    atol = 1e-6 * float(np.abs(want).max())
    err = np.abs(got - want)
    if k5 == 0 or (err > 1e-4 * np.abs(want) + atol).any():
        fail(f"demodulate --fused text vs library: max |err| {err.max()}, "
             f"K5 launches {k5}")
    print(f"[cli] modulate ({CLI_BITS} bits, {wave.size} samples) -> i16 -> "
          f"demodulate --fused ({got.size // 2} samples, K5 launches {k5}) "
          f"== Demodulator as a library (rtol 1e-4, atol {atol:.3e}; max "
          f"|err| {err.max():.3e})", flush=True)


def phase_ref_times(chain, device, card: str) -> dict:
    """Phase 10: K4 and K5 per call beside their plain versions, the
    profiler's device time and K4's ``conv1d`` yardstick; then the
    reference path's entry points per call."""
    import torch.nn.functional as F
    from modem_tpu_torch.ops import demod_kernel as dk, fir

    gen = torch.Generator(device=device).manual_seed(SEED + 7)
    taps = path_taps(chain, device)
    times = {}
    n_wave = (N_SYMBOLS + chain.span) * chain.sps
    for k in FIR_ROUTE_TAPS:
        name, n = fir_name(k), n_wave if k == 65 else REF_SAMPLES
        args = fir_case(taps[k], (CHANNELS, n), gen, device)
        x, t, state = args
        # conv1d computes the same causal FIR over state ++ x with the
        # flipped taps: a yardstick only, the port never calls it
        xp = torch.cat([state, x], dim=-1).unsqueeze(1)
        w = t.flip(0).reshape(1, 1, k)
        lib_err = max_err(F.conv1d(xp, w).squeeze(1), fir.fir_kernel(*args))
        if lib_err > 1e-3:
            fail(f"conv1d yardstick disagrees with K4 ({lib_err})")
        ms, plain_ms, dev_ms = kernel_times(
            fir.fir_kernel, fir.fir_plain, args, device, fir_symbol(k),
            plain_calls=20 if k <= 65 else 2)
        if dev_ms is None:
            fail(f"K4 at {k} taps: no {fir_symbol(k)} in the profile (the "
                 f"route fir_route names)")
        lib_ms = time_calls(F.conv1d, (xp, w), device)
        work = (4 * (2 * CHANNELS * n + CHANNELS * (k - 1) + k),
                2 * k * CHANNELS * n)
        times[name] = (ms, plain_ms, dev_ms, lib_ms, work)
        print_times(f"{name} ({k} taps, {fir.fir_route(k)})", CHANNELS * n,
                    times[name], card,
                    f"conv1d {lib_ms:.4f} ms (max |err| vs K4 {lib_err:.2e})")

    lowpass = taps[64]
    k, n = lowpass.shape[0], REF_SAMPLES
    for (hz, sr), name in DEMOD_NAMES.items():
        args = demod_case(lowpass, (CHANNELS, n), gen, device, hz, sr)
        symbol = demod_symbol(k, hz, sr)
        ms, plain_ms, dev_ms = kernel_times(dk.demod_kernel, dk.demod_plain,
                                            args, device, symbol)
        if dev_ms is None:
            fail(f"K5 at {hz} Hz of {sr}: no {symbol} in the profile")
        h = args[1].shape[-1]
        period, _, _, table = dk.carrier_walk(hz, sr)
        # x, history, phi, taps and the counter in; two rails out. Per
        # sample: 2 rails x k MACs, the x2 gain on each and the mix's two
        # products; the phase's multiply and add, one cos and one sin (as
        # one operation each) per sample, or with the table once per phase
        # and channel
        trig = CHANNELS * (period if table else n) * 4
        work = (4 * (CHANNELS * (n + h + 1) + k + 1) + 2 * 4 * CHANNELS * n,
                CHANNELS * n * (4 * k + 4) + trig)
        times[name] = (ms, plain_ms, dev_ms, None, work)
        print_times(f"{name} ({hz} Hz at {sr})", CHANNELS * n, times[name],
                    card, "no library call")

    # the entry points a user calls, per call of one 256 x 32768 block
    bits = ref_bits(gen, device)
    mod, dem, x, locked, _, _ = reference_path(device, bits)
    rest = x[:, 64:].contiguous()
    for name, fn, fargs, samples in (
            ("Modulator.passband", mod.passband,
             (bits, mod.init_state((CHANNELS,))),
             CHANNELS * REF_SAMPLES),
            ("Demodulator.demodulate", dem.demodulate, (rest, locked),
             rest.numel()),
            ("Demodulator.demodulate_fused", dem.demodulate_fused,
             (rest, locked), rest.numel())):
        ms = time_calls(fn, fargs, device)
        busy = device_busy_ms(fn, fargs, device)
        print(f"[times] {name:28s} per call {ms:.4f} ms "
              f"({samples / ms * 1e3:.4e} samples/s), device busy "
              f"{busy:.4f} ms (idle share {1 - busy / ms:.3f}), {CHANNELS} "
              f"ch x {samples // CHANNELS} samples on {card}", flush=True)
    return times


# ---- config #3: the FSK/MSK discriminator family ----

def fsk_chains(device):
    """The config #3 chains as ``bench_oneway.py:221-228`` builds them:
    16-MFSK (50 Hz, ``increase`` map, ``coefs = 2*arange(16)``), BFSK
    (200 Hz), MSK; and GMSK at BT 0.3. ``Rates(1250, 10000)``, sps 8."""
    import numpy as np
    from modem_tpu_torch import (FskChain, GmskChain, MskChain, Rates,
                                 make_scheme)

    r = Rates(FSK_BAUD, REF_SR)
    mfsk = FskChain(make_scheme("mfsk", r), r, 2 * np.arange(16),
                    2 * math.pi * 50 / REF_SR, device=device)
    bfsk = FskChain(make_scheme("bfsk", r), r, np.arange(2),
                    2 * math.pi * 200 / REF_SR, device=device)
    return mfsk, bfsk, MskChain(r, device=device), GmskChain(r, bt=0.3,
                                                             device=device)


def fsk_kernel_cases(mfsk, msk, device):
    """``(16-MFSK program, cases)``, a case ``(name, kernel fn, plain fn,
    args at the full shape, decisions?)`` for each of K6 (noiseless and
    noisy), K8, K9 (the FSK symbol and the MSK slot) and K10, with the
    inputs the main path gives them: 16-MFSK phase programs, their waveform
    with noise for K9 (means off the tones), MSK slot signs."""
    from modem_tpu_torch.models.base import f32
    from modem_tpu_torch.ops import fsk_kernel as fk

    g = torch.Generator(device=device).manual_seed(SEED + 8)
    bits = torch.randint(0, 2, (CHANNELS, N_SYMBOLS * 4), generator=g,
                         device=device, dtype=torch.int32)
    prog = mfsk._phase_program(bits)
    coefs = fk.fsk_coef_table(mfsk.scheme)
    sigma = fk.fsk_noise_sigma(1.0, FSK_SNR_DB)
    targets = fk._candidate_increments(coefs, prog.den, device)

    def chain_args(p, cs, noisy):
        return (p.fnum, p.pnum, targets, p.den, mfsk.sps, 1.0, f32(p.qshift),
                1, cs, f32(sigma) if noisy else None, SEED + 9)

    tx_args = (prog.fnum, prog.pnum, prog.den, mfsk.sps, 1.0, f32(prog.qshift))
    wi, wq = fk.fsk_tx_plain(*tx_args)
    wi = wi + sigma * torch.randn(wi.shape, generator=g, device=device)
    wq = wq + sigma * torch.randn(wq.shape, generator=g, device=device)
    mbits = torch.randint(0, 2, (CHANNELS, N_SYMBOLS * 2), generator=g,
                          device=device, dtype=torch.int32)
    s0, s1 = msk._slot_signs(mbits)
    mi, mq = fk.msk_tx_plain(s0, s1, msk.spb, 1.0)
    mi = mi + sigma * torch.randn(mi.shape, generator=g, device=device)
    mq = mq + sigma * torch.randn(mq.shape, generator=g, device=device)
    return prog, [
        ("fused_fsk_chain", fk.fsk_chain_kernel, fk.fsk_chain_plain,
         chain_args(prog, 256, False), True),
        ("fused_fsk_chain_noisy", fk.fsk_chain_kernel, fk.fsk_chain_plain,
         chain_args(prog, 256, True), True),
        ("fused_fsk_tx", fk.fsk_tx_kernel, fk.fsk_tx_plain, tx_args, False),
        ("fused_discriminator_means", fk.disc_means_kernel,
         fk.disc_means_plain, (wi, wq, mfsk.sps, 1), False),
        ("fused_discriminator_means_msk", fk.disc_means_kernel,
         fk.disc_means_plain, (mi, mq, msk.spb, 1), False),
        ("fused_msk_tx", fk.msk_tx_kernel, fk.msk_tx_plain,
         (s0, s1, msk.spb, 1.0), False),
    ]


def compare_decisions(name: str, got, want, shape, noisy: bool) -> tuple:
    """Decisions of a kernel and its plain version: equal, or with noise
    equal on >= FSK_AGREE of them. Returns (max |difference|, agreement)."""
    torch.cuda.synchronize()
    if got.shape != want.shape:
        fail(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    agree = float((got == want).double().mean())
    err = float((got - want).abs().max())
    need = FSK_AGREE if noisy else 1.0
    print(f"[fsk kernels] {name:30s} {shape[0]:4d} ch x {shape[1]:5d} sym: "
          f"decisions equal on {agree:.6f} (need >= {need}), max |kernel - "
          f"plain| {err:.0f}", flush=True)
    if agree < need:
        fail(f"{name} at {shape}: kernel and plain agree on {agree}")
    return err, agree


def phase_fsk_kernels(mfsk, msk, device) -> dict:
    """Phase 11: K6 (noiseless and noisy, at 130 x 600 in tiles of 32
    symbols, which crosses the 128-lane and tile keys of the noise stream,
    and at 256 x 4096), K8, K9 (groups 8 and 4) and K10 against their plain
    versions on the card. Returns each report entry's (max |error|,
    agreement)."""
    prog, cases = fsk_kernel_cases(mfsk, msk, device)
    errs = {}
    small = (slice(0, FSK_SMALL[0]), slice(0, FSK_SMALL[1]))
    for name, kern, plain, args, exact in cases:
        if exact:  # K6: the small tiled shape, then the full one
            noisy = args[9] is not None
            lo = (prog.fnum[small].contiguous(), prog.pnum[small].contiguous()
                  ) + args[2:8] + (FSK_SMALL_CHUNK,) + args[9:]
            compare_decisions(name, kern(*lo), plain(*lo), FSK_SMALL, noisy)
            errs[name] = compare_decisions(name, kern(*args), plain(*args),
                                           (CHANNELS, N_SYMBOLS), noisy)
            continue
        got, want = kern(*args), plain(*args)
        torch.cuda.synchronize(device)
        err = max_err(got, want)
        if err > ATOL:
            fail(f"{name}: kernel vs plain max |err| {err}")
        errs[name] = (err, None)
        print(f"[fsk kernels] {name:30s} {tuple(args[0].shape)} in: max "
              f"|kernel - plain| = {err:.3e} (tol {ATOL})", flush=True)
    return errs


def read_launches(kernels: dict, path: str, tag: str = "fsk main") -> dict:
    """Each kernel's launch count since the last reset; fails if one of the
    path's kernels never launched."""
    torch.cuda.synchronize()
    counts = {name: k.launches for name, k in kernels.items()}
    print(f"[{tag}] {path} launches: {json.dumps(counts)}", flush=True)
    for name, n in counts.items():
        if n == 0:
            fail(f"{path} never launched the {name} kernel")
    return counts


def phase_fsk_main(chains, device) -> dict:
    """Phase 12: config #3 at full width through the public entry points,
    each path driven with every launch count set to 0 just before it and
    read just after. Returns the launches of each report entry."""
    from modem_tpu_torch import DifferentialChain, Rates, make_scheme
    from modem_tpu_torch.ops import chain_kernel, fir, fsk_kernel as fk, txrx
    from modem_tpu_torch.ops.llr import llr_hard_bits

    mfsk, bfsk, msk, gmsk = chains
    g = torch.Generator(device=device).manual_seed(SEED + 10)

    def bits_for(bps, n_ch=CHANNELS):
        return torch.randint(0, 2, (n_ch, N_SYMBOLS * bps), generator=g,
                             device=device, dtype=torch.int32)

    def same(name, got, want):
        if got.shape != want.shape or not torch.equal(got, want):
            fail(f"config #3: {name} differs")
        print(f"[fsk main] {name}: equal, shape {tuple(got.shape)}",
              flush=True)

    fsk_kernels = {"fused_fsk_chain": fk.FSK_CHAIN_KERNEL,
                   "fused_fsk_tx": fk.FSK_TX_KERNEL,
                   "fused_discriminator_means": fk.DISC_MEANS_KERNEL}
    launches = {}
    for label, chain, n_ch in (("16-MFSK", mfsk, CHANNELS),
                               ("BFSK", bfsk, FSK_SIDE_CHANNELS)):
        bits = bits_for(chain.scheme.bits_per_symbol, n_ch)
        reset_launches()
        same(f"{label} roundtrip_fused(bits) == bits",
             chain.roundtrip_fused(bits), bits)
        wave = chain.tx_fused(bits)
        same(f"{label} rx_fused(tx_fused(bits)) == bits",
             chain.rx_fused(*wave), bits)
        llr = chain.rx_soft_fused(*wave)
        if not torch.isfinite(llr).all():
            fail(f"{label}: non-finite LLRs")
        same(f"{label} hard bits of rx_soft_fused == bits",
             llr_hard_bits(llr), bits)
        counts = read_launches(fsk_kernels, label)
        if label == "16-MFSK":
            launches.update(counts)

    bits = bits_for(2)
    reset_launches()
    same("MSK rx_fused(tx_fused(bits)) == bits",
         msk.rx_fused(*msk.tx_fused(bits)), bits)
    counts = read_launches({"fused_msk_tx": fk.MSK_TX_KERNEL,
                            "fused_discriminator_means_msk":
                                fk.DISC_MEANS_KERNEL}, "MSK")
    launches.update(counts)

    bits = bits_for(1, FSK_SIDE_CHANNELS)
    reset_launches()
    same("GMSK (BT 0.3) roundtrip(bits) == bits", gmsk.roundtrip(bits), bits)
    launches.update(read_launches({"fir_filter_32": fir.FIR_KERNEL}, "GMSK"))

    r = Rates(FSK_BAUD, REF_SR)
    dq = DifferentialChain(make_scheme("dqpsk", r), r, device=device)
    bits = bits_for(2)
    reset_launches()
    same("DQPSK rx_fused(tx_fused(bits)) == bits",
         dq.rx_fused(dq.tx_fused(bits), N_SYMBOLS), bits)
    same("DQPSK roundtrip_fused(bits) == bits", dq.roundtrip_fused(bits), bits)
    read_launches({"fused_pulse_chain": chain_kernel.CHAIN_KERNEL,
                   "fused_tx": txrx.TX_KERNEL, "fused_rx": txrx.RX_HARD_KERNEL},
                  "DQPSK")
    return launches


def phase_fsk_noise(mfsk, device) -> int:
    """Phase 13: 16-MFSK through ``roundtrip_fused(snr_db, seed)`` (K6's
    in-kernel noise) against the staged path (``tx``, Gaussian noise of the
    same sigma from a seeded generator, ``rx``) over 256 x 4096 symbols:
    symbol error rates within FSK_SER_RTOL. Returns K6's launches."""
    from modem_tpu_torch.ops import fsk_kernel as fk
    from modem_tpu_torch.utils.bits import pack_bits

    g = torch.Generator(device=device).manual_seed(SEED + 11)
    bits = torch.randint(0, 2, (CHANNELS, N_SYMBOLS * 4), generator=g,
                         device=device, dtype=torch.int32)
    syms = pack_bits(bits, 4)
    reset_launches()
    fused = pack_bits(mfsk.roundtrip_fused(bits, snr_db=FSK_SNR_DB,
                                           seed=SEED + 12), 4)
    launches = read_launches({"fused_fsk_chain_noisy": fk.FSK_CHAIN_KERNEL},
                             "16-MFSK with noise")["fused_fsk_chain_noisy"]
    sigma = fk.fsk_noise_sigma(1.0, FSK_SNR_DB)
    wi, wq = mfsk.tx(bits)
    wi = wi + sigma * torch.randn(wi.shape, generator=g, device=device)
    wq = wq + sigma * torch.randn(wq.shape, generator=g, device=device)
    staged = pack_bits(mfsk.rx(wi, wq), 4)
    ser_f = float((fused != syms).double().mean())
    ser_s = float((staged != syms).double().mean())
    print(f"[fsk noise] 16-MFSK at {FSK_SNR_DB} dB per complex sample over "
          f"{syms.numel()} symbols: SER roundtrip_fused (K6 noise) {ser_f:.6e}"
          f", staged tx + noise + rx {ser_s:.6e}, ratio {ser_f / ser_s:.4f}",
          flush=True)
    if not 1e-3 < ser_s < 0.1 or abs(ser_f / ser_s - 1.0) > FSK_SER_RTOL:
        fail(f"SER {ser_f} vs staged {ser_s} beyond {FSK_SER_RTOL:.0%}")
    return launches


def fsk_work(name: str, args) -> tuple[float, float]:
    """Bytes each of K6, K8, K9, K10 must move (each input read once, each
    output written once) and its f32 operations, from the call's shapes.
    Counted as one operation each: a multiply, an add, an abs, a compare,
    a cos, a sin, a log, a sqrt; the polynomial atan2 as 20 (6 multiply-
    adds, the square, the division, abs, min, max and 3 selects); the
    int32 phase and hash arithmetic not counted. Per sample: synthesis 6
    (theta, 2 trig, 2 gains, the q rail's phase add); an increment 27
    (4 products, 2 sums, the atan2, the running sum); noise 16 (log, sqrt,
    cos, sin, 2 uniforms of 2, the -2 and the angle's product, 2 products by
    r, 2 of sigma and 2 adds)."""
    if name.startswith("fused_fsk_chain"):
        fnum, targets, sps, guard = args[0], args[2], args[4], args[7]
        k = fnum.numel()
        n_s = sps - guard + 1  # samples synthesized per symbol
        ops = k * (n_s * 6 + (sps - guard) * 27 + 1 + 3 * targets.numel())
        if args[9] is not None:
            ops += k * n_s * 16
        return 3 * 4 * k + 4 * targets.numel(), ops
    if name == "fused_fsk_tx":
        k = args[0].numel()
        return 2 * 4 * k + 2 * 4 * k * args[3], 6 * k * args[3]
    if name == "fused_msk_tx":
        k = args[0].numel()
        return 2 * 4 * k + 2 * 4 * k * args[2], 6 * k * args[2]
    wi, group, guard = args[0], args[2], args[3]
    k = wi.numel() // group
    return 2 * 4 * wi.numel() + 4 * k, k * ((group - guard) * 27 + 1)


def phase_fsk_times(chains, device, card: str) -> dict:
    """Phase 14: each kernel and its plain version per call, the profiler's
    device time, the bound; then the config #3 entry points per call with
    the device's busy time and idle share."""
    mfsk, _, msk, _ = chains
    _, cases = fsk_kernel_cases(mfsk, msk, device)
    times = {}
    for name, kern, plain, args, _ in cases:
        ms, plain_ms, dev_ms = kernel_times(kern, plain, args, device,
                                            FSK_REPORT[name][1])
        times[name] = (ms, plain_ms, dev_ms, None, fsk_work(name, args))
        samples = CHANNELS * N_SYMBOLS * mfsk.sps
        print_times(name, samples, times[name], card, "no library call")

    g = torch.Generator(device=device).manual_seed(SEED + 13)
    bits = torch.randint(0, 2, (CHANNELS, N_SYMBOLS * 4), generator=g,
                         device=device, dtype=torch.int32)
    mbits = torch.randint(0, 2, (CHANNELS, N_SYMBOLS * 2), generator=g,
                          device=device, dtype=torch.int32)
    wave, mwave = mfsk.tx_fused(bits), msk.tx_fused(mbits)
    samples = CHANNELS * N_SYMBOLS * mfsk.sps
    for name, fn, args in (
            ("FskChain.roundtrip_fused", mfsk.roundtrip_fused, (bits,)),
            ("FskChain.tx_fused", mfsk.tx_fused, (bits,)),
            ("FskChain.rx_fused", mfsk.rx_fused, wave),
            ("MskChain.tx_fused", msk.tx_fused, (mbits,)),
            ("MskChain.rx_fused", msk.rx_fused, mwave)):
        ms = time_calls(fn, args, device)
        busy = device_busy_ms(fn, args, device)
        print(f"[times] {name:28s} per call {ms:.4f} ms "
              f"({samples / ms * 1e3:.4e} samples/s), device busy "
              f"{busy:.4f} ms (idle share {1 - busy / ms:.3f}), {CHANNELS} "
              f"ch x {N_SYMBOLS} sym x sps {mfsk.sps} on {card}", flush=True)
    return times


# ---- config #4 (K11, K12) and the MSK loopback (K7) ----

def resampled_chain(device, bps: int = 4, up: int = RS_UP,
                    down: int = RS_DOWN):
    """``bench_rows.py:65``'s chain: ``ResampledChain(QAM(4, 0.0, 1.0),
    Rates(1250, 10000), 3, 2)``."""
    from modem_tpu_torch import Rates, ResampledChain
    from modem_tpu_torch.models.qam import QAM

    return ResampledChain(QAM(bps, 0.0, 1.0), Rates(FSK_BAUD, REF_SR), up,
                          down, device=device)


def rs_cases(chain, shape, device, seed: int):
    """``[(name, kernel fn, plain fn, args, decisions?)]`` for K11, K12 hard
    and K12 soft at ``shape`` symbols, with the inputs the main path gives
    them: random symbols, and their channel-rate waveform with a little
    noise (soft points off the grid, decisions still clean); K11 then takes
    the symbols with stream sentinels in front."""
    from modem_tpu_torch.ops import resampled_kernel as rk

    g = torch.Generator(device=device).manual_seed(seed)
    m = chain.lut.shape[0]
    syms = torch.randint(0, m, shape, generator=g, device=device,
                         dtype=torch.int32)
    h = chain._host
    n_modem = chain._padded_len(shape[-1])
    tx_params = rk._tx_params(h["rrc"].tobytes(), h["taps1"].tobytes(),
                              chain.up, chain.down, device)
    tx_args = (syms, chain.lut, *tx_params, chain.sps, chain.up, chain.down,
               n_modem)
    wi, wq = rk.resampled_tx_plain(*tx_args)
    wi = wi + 0.02 * torch.randn(wi.shape, generator=g, device=device)
    wq = wq + 0.02 * torch.randn(wq.shape, generator=g, device=device)
    rx_params = rk._rx_params(h["rrc"].tobytes(), h["taps2"].tobytes(),
                              chain.sps, chain.up, chain.down, chain.delay,
                              device)
    if shape[-1] > 20:  # as a streaming first block
        syms[0, :16] = -1
    return [
        ("fused_resampled_tx", rk.resampled_tx_kernel, rk.resampled_tx_plain,
         tx_args, False),
        ("fused_resampled_rx", rk.resampled_rx_kernel, rk.resampled_rx_plain,
         (wi, wq, shape[-1], chain.lut, *rx_params, False), True),
        ("fused_resampled_rx_soft", rk.resampled_rx_kernel,
         rk.resampled_rx_plain,
         (wi, wq, shape[-1], chain.lut, *rx_params, True), False),
    ]


def msk_cases(msk, shape, cs: int, device, seed: int):
    """K7's ``(name, args)`` without and with noise on random slot signs."""
    from modem_tpu_torch.ops import fsk_kernel as fk
    from modem_tpu_torch.models.base import f32

    g = torch.Generator(device=device).manual_seed(seed)
    s0, s1 = (2 * torch.randint(0, 2, shape, generator=g, device=device,
                                dtype=torch.int32) - 1 for _ in range(2))
    sigma = f32(fk.fsk_noise_sigma(1.0, MSK_SNR_DB))
    return [("fused_msk_slots", (s0, s1, msk.spb, 1.0, 1, cs, None, seed)),
            ("fused_msk_slots_noisy",
             (s0, s1, msk.spb, 1.0, 1, cs, sigma, seed))]


def phase_rs_kernels(msk, device) -> dict:
    """Phase 15: K7, K11 and K12 against their plain versions on the card;
    returns each report entry's (max |error|, agreement) at full width."""
    from modem_tpu_torch.ops import fsk_kernel as fk

    errs = {}
    for shape, cs in ((MSK_SMALL, FSK_SMALL_CHUNK),
                      ((CHANNELS, 2 * N_SYMBOLS), 256)):
        for name, args in msk_cases(msk, shape, cs, device, SEED + 20):
            errs[name] = compare_decisions(
                name, fk.msk_chain_kernel(*args), fk.msk_chain_plain(*args),
                shape, args[6] is not None)
    for up, down in ((RS_UP, RS_DOWN), (RS_DOWN, RS_UP)):
        chain = resampled_chain(device, up=up, down=down)
        for shape in (SMALL, (CHANNELS, N_SYMBOLS)):
            cases = rs_cases(chain, shape, device, SEED + 21)
            for name, kern, plain, args, exact in cases:
                got, want = kern(*args), plain(*args)
                torch.cuda.synchronize(device)
                err = max_err(got, want)
                if (exact and err != 0) or err > ATOL:
                    fail(f"{name} {up}/{down} at {shape}: kernel vs plain "
                         f"max |err| {err}")
                if (up, down) == (RS_UP, RS_DOWN):
                    errs[name] = (err, None)
                print(f"[rs kernels] {name:24s} {up}/{down} {shape[0]:4d} ch "
                      f"x {shape[1]:5d} sym: max |kernel - plain| = {err:.3e} "
                      f"({'exact' if exact else f'tol {ATOL}'})", flush=True)
    return errs


def phase_rs_main(msk, device) -> dict:
    """Phase 16: config #4 and the MSK loopback through the public entry
    points, each path with every launch count set to 0 just before it and
    read just after. Returns the launches of each report entry."""
    from modem_tpu_torch import StreamingResampledChain
    from modem_tpu_torch.ops import fsk_kernel as fk, resampled_kernel as rk
    from modem_tpu_torch.ops.llr import llr_hard_bits

    g = torch.Generator(device=device).manual_seed(SEED + 22)

    def same(name, got, want):
        if got.shape != want.shape or not torch.equal(got, want):
            fail(f"config #4: {name} differs")
        print(f"[rs main] {name}: equal, shape {tuple(got.shape)}", flush=True)

    def bits_for(chain, n_ch, n_sym):
        return torch.randint(0, 2, (n_ch, n_sym * chain.bits_per_symbol),
                             generator=g, device=device, dtype=torch.int32)

    tx_k, rx_k = ({"fused_resampled_tx": rk.RESAMPLED_TX_KERNEL},
                  {"fused_resampled_rx": rk.RESAMPLED_RX_KERNEL})
    chain = resampled_chain(device)
    bits = bits_for(chain, CHANNELS, N_SYMBOLS)
    launches = {}
    reset_launches()
    same("roundtrip_fused(bits) == bits", chain.roundtrip_fused(bits), bits)
    launches.update(read_launches({**tx_k, **rx_k}, "config #4 roundtrip_fused"))
    reset_launches()
    wave = chain.tx_fused(bits)
    same("rx_fused(tx_fused(bits)) == bits", chain.rx_fused(wave, N_SYMBOLS),
         bits)
    read_launches({**tx_k, **rx_k}, "config #4 rx_fused(tx_fused)")
    reset_launches()
    llr = chain.rx_soft_fused(wave, N_SYMBOLS, noise_var=0.05)
    if not torch.isfinite(llr).all():
        fail("config #4: non-finite LLRs")
    same("hard bits of rx_soft_fused == bits", llr_hard_bits(llr), bits)
    launches["fused_resampled_rx_soft"] = read_launches(
        {"fused_resampled_rx_soft": rk.RESAMPLED_RX_KERNEL},
        "config #4 rx_soft_fused")["fused_resampled_rx_soft"]
    staged = chain.tx(bits)
    err = max_err(wave, staged)
    print(f"[rs main] tx_fused vs staged tx: max |err| {err:.3e} (tol {ATOL})",
          flush=True)
    if err > ATOL:
        fail("config #4: tx_fused differs from tx")
    same("rx_fused(tx(bits)) == rx(tx(bits))", chain.rx_fused(staged, N_SYMBOLS),
         chain.rx(staged, N_SYMBOLS))

    for label, side in (("64-QAM 3/2", resampled_chain(device, bps=6)),
                        ("16-QAM 2/3", resampled_chain(device, up=RS_DOWN,
                                                       down=RS_UP))):
        b = bits_for(side, *RS_SIDE)
        reset_launches()
        same(f"{label} roundtrip_fused(bits) == bits", side.roundtrip_fused(b),
             b)
        same(f"{label} rx_fused(tx_fused(bits)) == bits",
             side.rx_fused(side.tx_fused(b), RS_SIDE[1]), b)
        read_launches({**tx_k, **rx_k}, label)

    b = bits[:RS_STREAM_CHANNELS]
    bps = chain.bits_per_symbol
    st = StreamingResampledChain(chain, (RS_STREAM_CHANNELS,))
    parts, start = [], 0
    for n in RS_STREAM_CUTS + (N_SYMBOLS - sum(RS_STREAM_CUTS),):
        parts.append(st.push(b[:, start * bps:(start + n) * bps]))
        start += n
    parts.append(st.flush())
    one = chain.roundtrip(b)
    same(f"StreamingResampledChain in {len(parts) - 1} ragged pushes == one "
         f"shot ({RS_STREAM_CHANNELS} ch)", torch.cat(parts, dim=-1), one)
    same("one shot == bits", one, b)

    mbits = torch.randint(0, 2, (CHANNELS, 2 * N_SYMBOLS), generator=g,
                          device=device, dtype=torch.int32)
    reset_launches()
    same("MSK roundtrip_fused(bits) == bits", msk.roundtrip_fused(mbits), mbits)
    launches["fused_msk_slots"] = read_launches(
        {"fused_msk_slots": fk.MSK_CHAIN_KERNEL},
        "MSK roundtrip_fused")["fused_msk_slots"]
    return launches


def slot_errors(msk, bits, sent) -> float:
    """Share of MSK slots whose sign ``c = -s0*s1`` differs between the
    decided ``bits`` and the ``sent`` ones (the prefix decode turns one slot
    error into a run of bit errors, so slots are what is compared)."""
    s0, s1 = msk._slot_signs(bits)
    t0, t1 = msk._slot_signs(sent)
    return float(((s0 * s1) != (t0 * t1)).double().mean())


def phase_rs_noise(msk, device) -> int:
    """Phase 17: the MSK loopback's in-kernel noise against the staged path,
    and config #4's rx_fused against rx on a noisy waveform. Returns K7's
    launches with noise."""
    from modem_tpu_torch.ops import fsk_kernel as fk
    from modem_tpu_torch.ops.channel import awgn

    g = torch.Generator(device=device).manual_seed(SEED + 23)
    bits = torch.randint(0, 2, (CHANNELS, 2 * N_SYMBOLS), generator=g,
                         device=device, dtype=torch.int32)
    reset_launches()
    fused = msk.roundtrip_fused(bits, snr_db=MSK_SNR_DB, seed=SEED + 24)
    launches = read_launches({"fused_msk_slots_noisy": fk.MSK_CHAIN_KERNEL},
                             "MSK with noise")["fused_msk_slots_noisy"]
    sigma = fk.fsk_noise_sigma(1.0, MSK_SNR_DB)
    wi, wq = msk.tx(bits)
    wi = wi + sigma * torch.randn(wi.shape, generator=g, device=device)
    wq = wq + sigma * torch.randn(wq.shape, generator=g, device=device)
    ser_f = slot_errors(msk, fused, bits)
    ser_s = slot_errors(msk, msk.rx(wi, wq), bits)
    print(f"[rs noise] MSK at {MSK_SNR_DB} dB per complex sample over "
          f"{bits.numel()} slots: slot SER roundtrip_fused (K7 noise) "
          f"{ser_f:.6e}, staged tx + noise + rx {ser_s:.6e}, ratio "
          f"{ser_f / ser_s:.4f}", flush=True)
    if not 1e-3 < ser_s < 0.1 or abs(ser_f / ser_s - 1.0) > MSK_SER_RTOL:
        fail(f"MSK SER {ser_f} vs staged {ser_s} beyond {MSK_SER_RTOL:.0%}")

    chain = resampled_chain(device)
    bits = torch.randint(0, 2, (CHANNELS, 4 * N_SYMBOLS), generator=g,
                         device=device, dtype=torch.int32)
    wave = awgn(g, *chain.tx(bits), RS_NOISE_SNR_DB)
    fused, staged = chain.rx_fused(wave, N_SYMBOLS), chain.rx(wave, N_SYMBOLS)
    agree = float((fused == staged).double().mean())
    ber = float((staged != bits).double().mean())
    print(f"[rs noise] config #4 at {RS_NOISE_SNR_DB} dB per channel sample: "
          f"rx_fused == rx on {agree:.6f} of {bits.numel()} bits (need >= "
          f"{RS_AGREE}); staged BER {ber:.6e}", flush=True)
    if agree < RS_AGREE or ber == 0:
        fail(f"config #4 rx_fused vs rx on a noisy waveform: {agree}")
    return launches


def rs_work(name: str, args) -> tuple[float, float]:
    """Bytes each of K7, K11, K12 must move (each input read once, each
    output written once) and its f32 operations, from the call's shapes and
    tables. K7 per slot as ``fsk_work`` counts K6. K11: the RRC's taps per
    symbol and rail over the ``ceil(n_modem/sps)`` symbols, then the stage
    table's nonzero taps per output and rail, 2 operations a tap. K12: the
    composite table's nonzero taps per symbol and rail, 2 operations a tap,
    and a slice of 5 per point (hard)."""
    if name.startswith("fused_msk_slots"):
        s0, spb, guard, sigma = args[0], args[2], args[4], args[6]
        k = s0.numel()
        n_s = spb - guard + 1
        ops = k * (n_s * 6 + (spb - guard) * 27 + 1)
        if sigma is not None:
            ops += k * n_s * 16
        return 3 * 4 * k, ops
    if name == "fused_resampled_tx":
        syms, lut, taps, table, _, sps, up, down, n_modem = args
        c, k = syms.shape
        n_out = n_modem * up // down
        nnz = int(torch.count_nonzero(table))
        params = 4 * (lut.numel() + taps.numel() + table.numel())
        ops = (2 * 2 * taps.numel() * c * -(-n_modem // sps)
               + 2 * 2 * c * n_out * nnz / up)
        return 4 * c * k + 2 * 4 * c * n_out + params, ops
    wi, _, k, lut, table, period, _, _, soft = args
    c = wi.shape[0]
    nnz = int(torch.count_nonzero(table))
    ops = 2 * 2 * c * k * nnz / period
    out_bytes = (8 if soft else 4) * c * k
    if not soft:
        ops += 5 * lut.shape[0] * c * k
    return (2 * 4 * wi.numel() + out_bytes
            + 4 * (lut.numel() + table.numel())), ops


def conv1d_yardstick(args, device):
    """K12 soft as ``conv1d``: at 3/2 the composite stage has period 1, so
    each rail is one strided cross-correlation with the table's one row,
    ``padding`` covering the zero history. Returns ``(fn, fn args, max
    |error| against the kernel)``; the port never calls it."""
    import torch.nn.functional as F
    from modem_tpu_torch.ops import resampled_kernel as rk

    wi, wq, k, _, table, period, width, first, _ = args
    if period != 1:
        fail("the conv1d yardstick needs a period-1 composite stage")
    w = table.reshape(1, 1, -1)
    pad = max(0, -first)
    xi = wi[:, max(0, first):].unsqueeze(1)
    xq = wq[:, max(0, first):].unsqueeze(1)

    def both(xi, xq, w):
        return (F.conv1d(xi, w, stride=width, padding=pad),
                F.conv1d(xq, w, stride=width, padding=pad))

    got = tuple(o[:, 0, :k] for o in both(xi, xq, w))
    err = max_err(got, rk.resampled_rx_kernel(*args))
    return both, (xi, xq, w), err


def phase_rs_times(msk, device, card: str) -> dict:
    """Phase 18: each kernel and its plain version per call, the profiler's
    device time, the bound and K12 soft's ``conv1d`` yardstick; then the
    config #4 and MSK loopback entry points per call with the device's busy
    time and idle share."""
    from modem_tpu_torch.ops import fsk_kernel as fk

    chain = resampled_chain(device)
    cases = rs_cases(chain, (CHANNELS, N_SYMBOLS), device, SEED + 25)
    cases = [(n, k, p, a) for n, k, p, a, _ in cases]
    cases += [(n, fk.msk_chain_kernel, fk.msk_chain_plain, a)
              for n, a in msk_cases(msk, (CHANNELS, 2 * N_SYMBOLS), 256,
                                    device, SEED + 26)]
    samples = CHANNELS * chain._padded_len(N_SYMBOLS) * RS_UP // RS_DOWN
    times = {}
    for name, kern, plain, args in cases:
        ms, plain_ms, dev_ms = kernel_times(kern, plain, args, device,
                                            RS_REPORT[name][0])
        lib_ms, extra = None, "no library call"
        if name == "fused_resampled_rx_soft":
            fn, fargs, lib_err = conv1d_yardstick(args, device)
            if lib_err > 1e-4:
                fail(f"conv1d yardstick disagrees with K12 soft ({lib_err})")
            lib_ms = time_calls(fn, fargs, device)
            extra = f"conv1d {lib_ms:.4f} ms (max |err| vs K12 {lib_err:.2e})"
        times[name] = (ms, plain_ms, dev_ms, lib_ms, rs_work(name, args))
        n = (CHANNELS * 2 * N_SYMBOLS * msk.spb
             if name.startswith("fused_msk") else samples)
        print_times(name, n, times[name], card, extra)

    g = torch.Generator(device=device).manual_seed(SEED + 27)
    bits = torch.randint(0, 2, (CHANNELS, 4 * N_SYMBOLS), generator=g,
                         device=device, dtype=torch.int32)
    mbits = torch.randint(0, 2, (CHANNELS, 2 * N_SYMBOLS), generator=g,
                          device=device, dtype=torch.int32)
    wave = chain.tx_fused(bits)
    for name, fn, args, n in (
            ("ResampledChain.roundtrip_fused", chain.roundtrip_fused, (bits,),
             samples),
            ("ResampledChain.tx_fused", chain.tx_fused, (bits,), samples),
            ("ResampledChain.rx_fused", chain.rx_fused, (wave, N_SYMBOLS),
             samples),
            ("MskChain.roundtrip_fused", msk.roundtrip_fused, (mbits,),
             CHANNELS * 2 * N_SYMBOLS * msk.spb)):
        ms = time_calls(fn, args, device)
        busy = device_busy_ms(fn, args, device)
        print(f"[times] {name:30s} per call {ms:.4f} ms "
              f"({n / ms * 1e3:.4e} samples/s), device busy {busy:.4f} ms "
              f"(idle share {1 - busy / ms:.3f}), {n} samples on {card}",
              flush=True)
    return times


# ---- the coded link (FramedLink) and K13 ----

def vit_case(k: int, polys, shape, sigma, seed: int, device):
    """A code, its data bits and their codeword's LLRs ``[C, T, n]``:
    ``2 y / sigma^2`` of ``y = 1 - 2c`` plus Gaussian noise (``sigma`` 0:
    noiseless, +-2)."""
    from modem_tpu_torch.fec import ConvCode

    code = ConvCode(k, polys)
    g = torch.Generator(device=device).manual_seed(seed)
    bits = torch.randint(0, 2, shape, generator=g, device=device,
                         dtype=torch.int32)
    y = 1.0 - 2.0 * code.encode(bits).to(torch.float32)
    if sigma:
        y = (y + sigma * torch.randn(y.shape, generator=g, device=device)
             ) * (2.0 / sigma ** 2)
    else:
        y = 2.0 * y
    return code, bits, y.reshape(shape[0], -1, code.n)


def phase_viterbi_kernel(device) -> float:
    """Phase 19: K13 against its plain version on the card, bit for bit.
    Returns the max |difference| at bench_fec's width (0 or it fails)."""
    from modem_tpu_torch.fec import ConvCode
    from modem_tpu_torch.ops import viterbi_kernel as vk

    worst = 0.0

    def check(label, got, want, bits=None):
        nonlocal worst
        torch.cuda.synchronize(device)
        err = max_err(got, want)
        ber = ("" if bits is None else
               f", BER vs sent {float((got != bits).double().mean()):.3e}")
        print(f"[viterbi kernel] {label}: max |kernel - plain| = {err:.0f} "
              f"(exact){ber}", flush=True)
        if err != 0:
            fail(f"K13 {label}: kernel and plain differ")
        worst = max(worst, err)

    ccsds = (7, (0o171, 0o133))
    for sigma in (0.8, 0.0):
        code, bits, lam = vit_case(*ccsds, (VIT_CHANNELS, VIT_BITS), sigma,
                                   SEED + 30, device)
        for b in (VIT_BLOCK, 256, 1024):
            check(f"CCSDS K=7 r1/2 {VIT_CHANNELS} ch x {VIT_BITS} bits, "
                  f"B={b} h={VIT_HALO}, sigma {sigma}",
                  vk.stream_kernel(code, lam, b, VIT_HALO, 1e6),
                  vk.stream_plain(code, lam, b, VIT_HALO, 1e6), bits)
    for label, k, polys in (("K=5 r1/2", 5, (0o23, 0o35)),
                            ("K=7 r1/3", 7, (0o171, 0o133, 0o165))):
        for sigma in (0.8, 0.0):
            code, bits, lam = vit_case(k, polys, VIT_SIDE, sigma, SEED + 31,
                                       device)
            check(f"{label} {VIT_SIDE[0]} ch x {VIT_SIDE[1]} bits, B=256, "
                  f"sigma {sigma}",
                  vk.stream_kernel(code, lam, 256, 10 * k, 1e6),
                  vk.stream_plain(code, lam, 256, 10 * k, 1e6), bits)
    code, _, lam = vit_case(*ccsds, (VIT_CHANNELS, VIT_BITS), 0.8, SEED + 32,
                            device)
    win = lam[:, :VIT_BLOCK + 2 * VIT_HALO]
    g = torch.Generator(device=device).manual_seed(SEED + 33)
    pin = torch.randint(0, 2, (VIT_CHANNELS,), generator=g,
                        device=device).float()
    check(f"{VIT_CHANNELS} ready windows of {win.shape[1]} steps, "
          f"{int(pin.sum())} pinned", vk.windows_kernel(code, win, pin),
          vk.windows_plain(code, win, pin))
    for k, polys in VIT_PACKED:
        code = ConvCode(k, polys)
        rpw = vk.rows_per_warp_max(code.n_states)
        rows = 5 * rpw + rpw // 2 + 1  # the last warp partly empty
        for kind in ("zero", "ties", "large"):
            lam = hazard_costs(kind, code, rows, VIT_PACKED_TW,
                               SEED + 40 + k, device)
            pin = (torch.arange(rows, device=device) % 3 == 1).float()
            check(f"K={k} (S={code.n_states}, {rpw} rows a warp) {rows} "
                  f"windows of {VIT_PACKED_TW} steps, {kind} LLRs, "
                  f"{int(pin.sum())} pinned",
                  vk.windows_kernel(code, lam, pin),
                  vk.windows_plain(code, lam, pin))
            check(f"K={k} {rows} ch x {VIT_PACKED_TW} steps, B=64, {kind} "
                  f"LLRs", vk.stream_kernel(code, lam, 64, 10 * k, 1e6),
                  vk.stream_plain(code, lam, 64, 10 * k, 1e6))
    return worst


def hazard_costs(kind: str, code, rows: int, steps: int, seed: int,
                 device) -> torch.Tensor:
    """Costs ``[rows, steps, n]`` on which K13's compares tie or its
    metrics grow: ``zero`` (+0 and -0 only: every compare ties), ``ties``
    (-1, +1 and signed zeros), ``large`` (Gaussian times 1e4)."""
    g = torch.Generator(device=device).manual_seed(seed)
    shape = (rows, steps, code.n)
    if kind == "large":
        return 1e4 * torch.randn(shape, generator=g, device=device)
    sign = torch.where(torch.rand(shape, generator=g, device=device) < 0.5,
                       1.0, -1.0)
    zero = 0.0 * sign
    if kind == "zero":
        return zero
    v = torch.randint(-1, 2, shape, generator=g, device=device).float()
    return torch.where(v == 0, zero, v)


def link_noise(g, wave, snr_db: float):
    """``wave`` plus seeded Gaussian noise at ``snr_db`` per complex
    sample; returns the noisy rails and the per-rail noise variance."""
    from modem_tpu_torch.ops.channel import awgn

    i, q = wave
    p = float(torch.mean(i * i + q * q))
    return (awgn(g, i, q, snr_db, signal_power=p),
            p / (2.0 * 10.0 ** (snr_db / 10.0)))


def link_kernels() -> dict:
    from modem_tpu_torch.ops import txrx, viterbi_kernel as vk

    return {"fused_tx": txrx.TX_KERNEL, "fused_rx_soft": txrx.RX_SOFT_KERNEL,
            VIT_REPORT[0]: vk.VITERBI_KERNEL}


def hold_link_kernels(link, pay, clean, wave, nv: float) -> None:
    """K2, K3 soft and K13 against their plain versions on exactly the
    inputs one link run gave them: the frames' symbols, the received
    waveform, and the deinterleaved LLRs of ``chain.rx_soft_fused``."""
    from modem_tpu_torch.fec import block_deinterleave
    from modem_tpu_torch.ops import txrx, viterbi_kernel as vk

    ch, conv = link.chain, link.conv
    syms = ch.map_symbols(link.frame(pay))
    tx_args = (syms, ch.lut, ch.rrc, ch.sps, ch.span)
    rx_args = (*wave, link.n_symbols, ch.lut, ch.rrc, ch.sps, ch.span, True)
    llr = ch.rx_soft_fused(wave, link.n_symbols, noise_var=nv)
    if link.rows:
        llr = block_deinterleave(llr, link.rows)
    lam = llr.reshape(llr.shape[0], -1, conv.n)
    stream = (conv, lam, link.conv_window, 10 * conv.k, 1e6)
    for name, got, want, tol in (
            ("fused_tx (the link's tx_fused)", clean,
             txrx.tx_plain(*tx_args), ATOL),
            ("fused_rx_soft", txrx.rx_kernel(*rx_args),
             txrx.rx_plain(*rx_args), ATOL),
            (VIT_REPORT[0], vk.stream_kernel(*stream),
             vk.stream_plain(*stream), 0)):
        torch.cuda.synchronize(wave[0].device)
        err = max_err(got, want)
        shape = tuple((got[0] if isinstance(got, tuple) else got).shape)
        print(f"[link] {name} on the link's own inputs, output {shape}: max "
              f"|kernel - plain| = {err:.3e} "
              f"({'exact' if tol == 0 else f'tol {tol}'})", flush=True)
        if err > tol:
            fail(f"{name} at the link's inputs: kernel and plain differ")


def run_link(link, frames: int, snr_db: float, seed: int, device,
             hold=None, kernels: dict | None = None, tag: str = ""):
    """``tx_fused`` -> seeded AWGN -> ``rx_fused`` on ``frames`` random
    payloads with every launch count set to 0 just before; fails unless
    every payload comes back with a true CRC, or one of ``kernels`` (the
    conv link's by default) did not launch. Then ``hold(link, pay, clean,
    wave, nv)``, if given, holds the path's kernels against their plain
    versions on the run's own inputs. Returns the launch counts of the
    run."""
    g = torch.Generator(device=device).manual_seed(seed)
    pay = torch.randint(0, 2, (frames, link.payload_bits), generator=g,
                        device=device, dtype=torch.int32)
    reset_launches()
    clean = link.tx_fused(pay)
    wave, nv = link_noise(g, clean, snr_db)
    out, ok = link.rx_fused(wave, nv)
    counts = read_launches(kernels or link_kernels(),
                           f"{frames}-frame link {tag}".rstrip(), "link")
    errors = int((out != pay).sum())
    print(f"[link] {tag + ': ' if tag else ''}{frames} frames x "
          f"{link.payload_bits} payload bits at {snr_db} dB per complex "
          f"sample ({link.n_symbols} QPSK symbols a frame, "
          f"{wave[0].numel()} samples a rail): {errors} payload bit errors, "
          f"{int(ok.sum())}/{frames} CRCs true", flush=True)
    if errors or not bool(ok.all()):
        fail(f"link at {snr_db} dB: {errors} errors, {int(ok.sum())} CRCs")
    if hold is not None:
        hold(link, pay, clean, wave, nv)
    return counts


def phase_link_main(device) -> int:
    """Phase 20: the coded link through its entry points on the card.
    Returns K13's launches in ``reference_link()``'s run."""
    from modem_tpu_torch import presets
    from modem_tpu_torch.fec import (StreamingViterbi, crc16_ccitt,
                                     dvb_scrambler, rs_255_223)

    counts = run_link(presets.reference_link(device=device), LINK_FRAMES,
                      LINK_SNR_DB, SEED + 34, device, hold=hold_link_kernels)
    for name, snr in RS_LINK_SNR_DB.items():
        run_link(getattr(presets, name)(device=device), RS_LINK_FRAMES, snr,
                 SEED + 35, device)

    g = torch.Generator(device=device).manual_seed(SEED + 36)
    bits = torch.randint(0, 2, (LINK_FRAMES, 1002), generator=g,
                         device=device, dtype=torch.int32)
    crc, scr, rs = crc16_ccitt(), dvb_scrambler(), rs_255_223()
    ks, nxt = scr.keystream(scr.init_state((LINK_FRAMES,), device), 1018)
    ks_c, nxt_c = scr.keystream(scr.init_state((LINK_FRAMES,), "cpu"), 1018)
    msg = torch.randint(0, 256, (RS_LINK_FRAMES, 223), generator=g,
                        device=device, dtype=torch.int32)
    recv = rs.encode(msg)
    recv[:, :rs.t] ^= 0x3C  # t symbol errors in every codeword
    dec, ok = rs.decode(recv)
    dec_c, ok_c = rs.decode(recv.cpu())
    for name, got, want in (
            ("CRC-16", crc.compute(bits).cpu(), crc.compute(bits.cpu())),
            ("scrambler keystream", ks.cpu(), ks_c),
            ("scrambler state", nxt.cpu(), nxt_c),
            ("RS(255,223) decode, t errors", dec.cpu(), dec_c),
            ("RS ok", ok.cpu(), ok_c)):
        if not torch.equal(got, want):
            fail(f"{name} on the card differs from the CPU")
        print(f"[link] {name} on CUDA tensors == CPU", flush=True)
    if not bool(ok.all()) or not torch.equal(dec, msg):
        fail("RS(255,223) did not correct t errors on the card")

    # a stream of whole pushes: 4090 data bits + 6 flush = 8 x 512 steps
    code, _, lam = vit_case(7, (0o171, 0o133), (VIT_CHANNELS, VIT_BITS - 6),
                            0.8, SEED + 37, device)
    llr = lam.reshape(VIT_CHANNELS, -1)
    one = code.decode_soft_windowed(llr, VIT_BLOCK)
    sv = StreamingViterbi(code, VIT_BLOCK)
    step = code.n * VIT_BLOCK
    outs = [sv.push(llr[:, a:a + step]) for a in range(0, llr.shape[-1], step)]
    stream = torch.cat([o for o in outs if o is not None] + [sv.flush()], -1)
    if not torch.equal(stream, one):
        fail("StreamingViterbi pushes differ from one shot")
    print(f"[link] StreamingViterbi in {len(outs)} pushes of {VIT_BLOCK} "
          f"steps == decode_soft_windowed at {VIT_CHANNELS} ch x "
          f"{VIT_BITS - 6} bits", flush=True)
    return counts[VIT_REPORT[0]]


def phase_link_cli(device) -> None:
    """Phase 21: ``link tx`` -> ``link rx`` on the card."""
    import io
    import numpy as np
    from modem_tpu_torch.cli import link as cli
    from modem_tpu_torch.ops import viterbi_kernel as vk

    bits = np.random.default_rng(SEED).integers(0, 2, CLI_FRAMES * 1002)
    common = ["--preset", "reference", "--batch-frames", "16", "--device",
              str(device)]
    wave = io.BytesIO()
    rc = cli.run(cli.build_parser().parse_args(["tx", *common]),
                 "".join("01"[b] for b in bits).encode(), wave)
    reset_launches()
    out, err = io.BytesIO(), io.StringIO()
    rc_rx = cli.run(cli.build_parser().parse_args(
        ["rx", "--noise-var", "0.05", *common]), wave.getvalue(), out,
        stderr=err)
    torch.cuda.synchronize(device)
    got = np.array([int(c) for c in "".join(out.getvalue().decode().split())])
    n_ok = err.getvalue().count("frame: OK")
    k13 = vk.VITERBI_KERNEL.launches
    print(f"[cli] link tx ({CLI_FRAMES} frames, {len(wave.getvalue())} bytes)"
          f" -> link rx: exit {rc}/{rc_rx}, {n_ok} OK verdicts, payload "
          f"{'equal' if np.array_equal(got, bits) else 'DIFFERENT'}, K13 "
          f"launches {k13}", flush=True)
    if (rc, rc_rx, n_ok) != (0, 0, CLI_FRAMES) or k13 == 0 or \
            not np.array_equal(got, bits):
        fail("link CLI pair on the card")


def viterbi_work(code, c: int, t: int, block: int, halo: int):
    """Bytes K13 must move on a ``c``-channel stream of ``t`` steps (the
    costs read once, the data bits written once) and the f32 operations of
    its recursion over W windows of ``block + 2 halo`` steps per channel:
    per state-step two path adds, a compare and a select, and the
    renormalisation's min and subtract every 8 steps; per row-step the
    2^n distinct branch sums, n - 1 adds each, shared by every state."""
    w = -(-t // block)
    rows, t_w = c * w, block + 2 * halo
    ops = rows * t_w * (code.n_states * (4 + 2 / 8)
                        + 2 ** code.n * (code.n - 1))
    return 4 * c * t * code.n + 4 * c * (t - code.k + 1), ops, rows, t_w


def phase_link_times(device, card: str) -> tuple:
    """Phase 22: K13 and its plain version, the bound and the time per
    trellis step; the info rate of ``decode_soft_windowed``; the link's
    entry points per call with the device's busy time and idle share.
    Returns K13's report times."""
    from modem_tpu_torch import presets

    code, _, lam = vit_case(7, (0o171, 0o133), (VIT_CHANNELS, VIT_BITS),
                            0.8, SEED + 38, device)
    times = viterbi_times(VIT_REPORT[0], VIT_REPORT[1], code, lam,
                          VIT_CHANNELS, VIT_BLOCK, VIT_HALO, device, card,
                          plain_calls=2)
    # reference_link()'s trellis: 384 frames of 1024 steps, 2 windows each
    _, _, link_lam = vit_case(7, (0o171, 0o133), (LINK_FRAMES, 1024 - 6),
                              0.8, SEED + 38, device)
    viterbi_times("viterbi_link_rows", VIT_REPORT[1], code, link_lam,
                  LINK_FRAMES, VIT_BLOCK, VIT_HALO, device, card,
                  plain_calls=1)
    llr = lam.reshape(VIT_CHANNELS, -1)
    dec_ms = time_calls(code.decode_soft_windowed, (llr, VIT_BLOCK), device)
    info = VIT_CHANNELS * VIT_BITS
    print(f"[times] decode_soft_windowed per call {dec_ms:.4f} ms: "
          f"{info / dec_ms / 1e3:.2f} Mbit/s of info bits ({VIT_CHANNELS} ch"
          f" x {VIT_BITS} bits, B={VIT_BLOCK}, h={VIT_HALO}) on {card}",
          flush=True)

    for name, frames in (("reference_link", LINK_FRAMES),
                         ("ccsds_deep_space_link", RS_LINK_FRAMES),
                         ("dvb_like_link", RS_LINK_FRAMES)):
        link = getattr(presets, name)(device=device)
        g = torch.Generator(device=device).manual_seed(SEED + 39)
        pay = torch.randint(0, 2, (frames, link.payload_bits), generator=g,
                            device=device, dtype=torch.int32)
        wave, nv = link_noise(g, link.tx_fused(pay),
                              RS_LINK_SNR_DB.get(name, LINK_SNR_DB))
        calls = ([("tx_fused", link.tx_fused, (pay,))]
                 if name == "reference_link" else []) + [
            ("rx_fused", link.rx_fused, (wave, nv))]
        for label, fn, fargs in calls:
            t = time_calls(fn, fargs, device, calls=5, reps=3)
            busy = device_busy_ms(fn, fargs, device, calls=5)
            bits = frames * link.payload_bits
            print(f"[times] {name}.{label:9s} per call {t:.4f} ms "
                  f"({bits / t / 1e3:.2f} Mbit/s of payload), device busy "
                  f"{busy:.4f} ms (idle share {1 - busy / t:.3f}), {frames} "
                  f"frames on {card}", flush=True)
    return times


# ---- the K1-K3 modes, the passband main path, the harness, widened K13 ----

def mode_symbols(shape, bps: int, device, seed: int) -> torch.Tensor:
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(0, 1 << bps, shape, generator=g, device=device,
                         dtype=torch.int32)


def mode_cases():
    """(entry, kernel kind, spec, profiler name, replaced TPU kernel) for
    each new mode of K1-K3: ``spec`` holds ``qam`` (square 256-QAM),
    ``carrier`` ((hz, sr)), ``sigma`` (K1's noise), ``store`` (K2's
    (out_scale, dtype)), ``in`` (K3's input dtype), ``soft``."""
    from modem_tpu_torch.ops import txrx

    qam = txrx.qam_mparams(MODE_QAM_BPS, 0.0, 1.0)
    pb, pb17 = (2000, REF_SR), (1700, REF_SR)
    sig_bb = math.sqrt(0.5 / 10.0 ** (MODE_SNR_DB / 10.0))
    chain = ("chain", "pulse_chain_kernel", "modem_tpu/ops/pallas_chain.py:195")
    tx = ("tx", "pulse_tx_kernel", "modem_tpu/ops/pallas_txrx.py:61")
    rx = ("rx", "pulse_rx_kernel<false,", "modem_tpu/ops/pallas_txrx.py:277")
    rxs = ("rx", "pulse_rx_kernel<true,", "modem_tpu/ops/pallas_txrx.py:277")
    cases = [
        ("fused_pulse_chain_passband", chain, {"carrier": pb}),
        ("fused_pulse_chain_passband_1700", chain, {"carrier": pb17}),
        ("fused_pulse_chain_qam256", chain, {"qam": qam}),
        ("fused_pulse_chain_noisy", chain, {"sigma": sig_bb}),
        ("fused_pulse_chain_noisy_passband", chain,
         {"carrier": pb, "sigma": sig_bb / 2}),
        ("fused_tx_passband", tx, {"carrier": pb}),
        ("fused_tx_passband_1700", tx, {"carrier": pb17}),
        ("fused_tx_qam256", tx, {"qam": qam}),
        ("fused_tx_bf16", tx, {"store": (None, torch.bfloat16)}),
        ("fused_tx_int16", tx, {"store": (MODE_OUT_SCALE, torch.int16)}),
        ("fused_rx_passband", rx, {"carrier": pb}),
        ("fused_rx_passband_1700", rx, {"carrier": pb17}),
        ("fused_rx_qam256", rx, {"qam": qam}),
        ("fused_rx_bf16", rx, {"in": torch.bfloat16}),
        ("fused_rx_soft_passband", rxs, {"carrier": pb, "soft": True}),
    ]
    return [(n, kind, spec, sym, rep) for n, (kind, sym, rep), spec in cases]


def mode_args(kind: str, spec: dict, syms, off: int, cs: int, chain):
    """The kernel's (and its plain version's) positional arguments for
    ``syms``; K3 gets the plain TX's waveform of them, with light noise
    where it is float32."""
    from modem_tpu_torch.ops import txrx

    qam, car = spec.get("qam"), spec.get("carrier")
    lut = None if qam is not None else chain.lut
    common = (syms, lut, chain.rrc, chain.sps, chain.span, qam, car, off)
    if kind == "chain":
        return common + (spec.get("sigma"), SEED + 40, cs)
    if kind == "tx":
        return common + spec.get("store", (None, torch.float32))
    dtype = spec.get("in", torch.float32)
    wave = txrx.tx_plain(*common, None, dtype)
    rails = wave if isinstance(wave, tuple) else (wave,)
    if dtype == torch.float32:
        g = torch.Generator(device=syms.device).manual_seed(SEED + 41)
        sigma = 0.002 if qam is not None else 0.05
        rails = tuple(w + sigma * torch.randn(w.shape, generator=g,
                                              device=w.device) for w in rails)
    rails = rails if len(rails) == 2 else (rails[0], None)
    return (*rails, syms.shape[-1], lut, chain.rrc, chain.sps, chain.span,
            spec.get("soft", False), qam, car, off)


def mode_fns(kind: str):
    from modem_tpu_torch.ops import chain_kernel as ck, txrx

    return {"chain": (ck.chain_kernel, ck.chain_plain),
            "tx": (txrx.tx_kernel, txrx.tx_plain),
            "rx": (txrx.rx_kernel, txrx.rx_plain)}[kind]


def mode_compare(name: str, spec: dict, got, want) -> tuple:
    """(max |kernel - plain|, agreement or None); fails past the bars:
    decisions equal (K1 with noise on >= MODE_AGREE), waveforms and soft
    points within ATOL, bf16 within one bf16 ulp (past f32 rounding near
    zero), int16 within one step."""
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    if got[0].dtype in (torch.int32,):
        agree = float((got[0] == want[0]).double().mean())
        err = float((got[0] - want[0]).abs().max())
        need = MODE_AGREE if "sigma" in spec else 1.0
        if agree < need:
            fail(f"{name}: decisions agree on {agree} < {need}")
        return err, agree if "sigma" in spec else None
    err = 0.0
    for g, w in zip(got, want):
        if g.dtype != w.dtype or g.shape != w.shape:
            fail(f"{name}: {g.dtype}{tuple(g.shape)} vs {w.dtype}"
                 f"{tuple(w.shape)}")
        gf, wf = g.double(), w.double()
        d = (gf - wf).abs()
        if g.dtype == torch.bfloat16:
            ok = bool((d <= torch.maximum(gf.abs(), wf.abs()) * 2.0 ** -7
                       + 1e-7).all())
        elif g.dtype == torch.int16:
            ok = float(d.max()) <= 1
        else:
            ok = float(d.max()) <= ATOL
        if not ok or not torch.isfinite(gf).all():
            fail(f"{name}: kernel vs plain beyond the bar, max |err| "
                 f"{float(d.max())}")
        err = max(err, float(d.max()))
    return err, None


def phase_mode_kernels(chain, device) -> dict:
    """Phase 23 (a): each new mode of K1-K3 against its plain version at a
    small shape that crosses the lane and time tiles with a negative
    sym_offset (130 x 600, K1 in tiles of 32), and at 256 x 4096. Returns
    each entry's (max |error|, agreement) at the full shape."""
    errs = {}
    for name, kind, spec, _, _ in mode_cases():
        bps = MODE_QAM_BPS if "qam" in spec else 2
        kern, plain = mode_fns(kind)
        for shape, off, cs in ((MODE_SMALL, -16, MODE_SMALL_CHUNK),
                               ((CHANNELS, N_SYMBOLS), N_SYMBOLS, 256)):
            syms = mode_symbols(shape, bps, device, SEED + 42)
            args = mode_args(kind, spec, syms, off, cs, chain)
            err, agree = mode_compare(name, spec, kern(*args), plain(*args))
            errs[name] = (err, agree)
            ag = "" if agree is None else f", decisions agree {agree:.6f}"
            print(f"[modes] {name:32s} {shape[0]:4d} ch x {shape[1]:5d} sym, "
                  f"sym_offset {off:5d}: max |kernel - plain| = {err:.3e}"
                  f"{ag}", flush=True)
    return errs


def phase_passband_main(chain, device) -> dict:
    """Phase 24 (b): the passband chain (``PulseShapedChain(QPSK(0.0, 1.0),
    Rates(1250, 10000), carrier_hz=2000)``, and 1700 Hz) at 256 x 4096
    through the public entry points, 256-QAM, int16 and bf16 waveforms,
    each path driven with every launch count set to 0 just before and read
    just after. Returns each mode entry's launches."""
    from modem_tpu_torch import (Rates, StreamingFusedChain, StreamingFusedRx,
                                 StreamingFusedTx)
    from modem_tpu_torch.chain import PulseShapedChain
    from modem_tpu_torch.models.psk import QPSK
    from modem_tpu_torch.models.qam import QAM
    from modem_tpu_torch.ops import chain_kernel as ck, txrx
    from modem_tpu_torch.ops.llr import llr_hard_bits

    r = Rates(REF_BAUD, REF_SR)
    g = torch.Generator(device=device).manual_seed(SEED + 43)

    def bits_for(bps):
        return torch.randint(0, 2, (CHANNELS, N_SYMBOLS * bps), generator=g,
                             device=device, dtype=torch.int32)

    def same(what, got, want):
        if got.shape != want.shape or not torch.equal(got, want):
            fail(f"passband main path: {what} differs")
        print(f"[passband main] {what}: equal, shape {tuple(got.shape)}",
              flush=True)

    launches = {}
    for hz, tag in ((2000, "passband"), (1700, "passband_1700")):
        pbc = PulseShapedChain(QPSK(0.0, 1.0), r, carrier_hz=hz, device=device)
        bits = bits_for(2)
        reset_launches()
        same(f"{hz} Hz roundtrip_fused(bits) == bits",
             pbc.roundtrip_fused(bits), bits)
        launches.update(read_launches(
            {f"fused_pulse_chain_{tag}": ck.CHAIN_KERNEL}, f"{hz} Hz loopback",
            "passband main"))
        reset_launches()
        wave = pbc.tx_fused(bits)
        same(f"{hz} Hz rx_fused(tx_fused(bits)) == bits",
             pbc.rx_fused(wave, N_SYMBOLS), bits)
        same(f"{hz} Hz hard bits of rx_soft_fused == bits",
             llr_hard_bits(pbc.rx_soft_fused(wave, N_SYMBOLS, noise_var=0.5)),
             bits)
        kernels = {f"fused_tx_{tag}": txrx.TX_KERNEL,
                   f"fused_rx_{tag}": txrx.RX_HARD_KERNEL}
        if hz == 2000:
            kernels["fused_rx_soft_passband"] = txrx.RX_SOFT_KERNEL
            step = N_SYMBOLS // N_PUSH
            st = StreamingFusedTx(pbc, (CHANNELS,))
            parts = [st.push(bits[:, 2 * i * step:2 * (i + 1) * step])
                     for i in range(N_PUSH)] + [st.flush()]
            same("StreamingFusedTx x4 == tx_fused", torch.cat(parts, -1), wave)
            sr = StreamingFusedRx(pbc, (CHANNELS,))
            cuts = [i * step * pbc.sps for i in range(N_PUSH + 1)] + [
                wave.shape[-1]]
            out = [sr.push(wave[:, a:b]) for a, b in zip(cuts, cuts[1:])]
            same("StreamingFusedRx x4 == bits", torch.cat(out, -1), bits)
            sc = StreamingFusedChain(pbc, (CHANNELS,))
            out = [sc.push(bits[:, 2 * i * step:2 * (i + 1) * step])
                   for i in range(N_PUSH)] + [sc.flush()]
            same("StreamingFusedChain x4 == bits", torch.cat(out, -1), bits)
        launches.update(read_launches(kernels, f"{hz} Hz one-way and streams",
                                      "passband main"))
        if hz == 2000:
            reset_launches()
            w16 = pbc.tx_fused(bits, out_scale=MODE_OUT_SCALE)
            if w16.dtype != torch.int16:
                fail("tx_fused(out_scale=...) is not int16")
            same("2000 Hz rx_fused(tx_fused(bits, out_scale)) == bits",
                 pbc.rx_fused(w16, N_SYMBOLS), bits)
            launches.update(read_launches({"fused_tx_int16": txrx.TX_KERNEL},
                                          "int16 TX", "passband main"))

    q256 = PulseShapedChain(QAM(MODE_QAM_BPS, 0.0, 1.0), r, device=device)
    bits = bits_for(MODE_QAM_BPS)
    reset_launches()
    same("256-QAM roundtrip_fused(bits) == bits", q256.roundtrip_fused(bits),
         bits)
    same("256-QAM rx_fused(tx_fused(bits)) == bits",
         q256.rx_fused(q256.tx_fused(bits), N_SYMBOLS), bits)
    launches.update(read_launches({"fused_pulse_chain_qam256": ck.CHAIN_KERNEL,
                                   "fused_tx_qam256": txrx.TX_KERNEL,
                                   "fused_rx_qam256": txrx.RX_HARD_KERNEL},
                                  "256-QAM", "passband main"))
    bits = bits_for(2)
    reset_launches()
    wb = chain.tx_fused(bits, wave_dtype=torch.bfloat16)
    if wb[0].dtype != torch.bfloat16:
        fail("tx_fused(wave_dtype=bfloat16) is not bf16")
    same("flagship rx_fused(tx_fused(bits, bf16)) == bits",
         chain.rx_fused(wb, N_SYMBOLS), bits)
    launches.update(read_launches({"fused_tx_bf16": txrx.TX_KERNEL,
                                   "fused_rx_bf16": txrx.RX_HARD_KERNEL},
                                  "bf16 waveform", "passband main"))
    return launches


def phase_harness(chain, device, card: str) -> dict:
    """Phase 25 (c): the BER harness on K1's noise at 256 x 4096: QPSK at 7
    dB (and at passband) within 10% of the closed form, natural 16-QAM at
    14 dB within 10% of its, a monotone waterfall, ``release_gates(scale=
    4)``; ``fused_ber_point``'s time per call. Returns the noisy K1
    entries' launches."""
    from modem_tpu_torch import Rates, harness
    from modem_tpu_torch.chain import PulseShapedChain
    from modem_tpu_torch.models.qam import QAM
    from modem_tpu_torch.ops import chain_kernel as ck
    from modem_tpu_torch.utils.bits import unpack_symbols

    def near(what, pt, theory):
        ratio = pt.ber / theory
        print(f"[harness] {what}: BER {pt.ber:.6e} over {pt.bits} bits "
              f"({pt.bit_errors} errors), closed form {theory:.6e}, ratio "
              f"{ratio:.4f}", flush=True)
        if abs(ratio - 1.0) > BER_RTOL:
            fail(f"{what}: BER {pt.ber} vs closed form {theory}")

    launches = {}
    reset_launches()
    pt = harness.fused_ber_point(chain, MODE_SNR_DB, N_SYMBOLS, CHANNELS,
                                 SEED + 44)
    launches.update(read_launches({"fused_pulse_chain_noisy":
                                   ck.CHAIN_KERNEL}, "fused_ber_point",
                                  "harness"))
    near(f"fused_ber_point QPSK at {MODE_SNR_DB} dB", pt,
         harness.qpsk_ber_theory(MODE_SNR_DB))
    syms = mode_symbols((CHANNELS, N_SYMBOLS), 2, device, SEED + 45)
    reset_launches()
    dec = ck.fused_pulse_chain(syms, chain.lut, chain.rrc, chain.sps,
                               chain.span, snr_db=MODE_SNR_DB, seed=SEED + 46,
                               carrier_hz=2000, sample_rate=REF_SR)
    launches.update(read_launches({"fused_pulse_chain_noisy_passband":
                                   ck.CHAIN_KERNEL}, "passband BER point",
                                  "harness"))
    errors = int((unpack_symbols(dec, 2) != unpack_symbols(syms, 2)).sum())
    near(f"passband (2000 Hz) K1 noise at {MODE_SNR_DB} dB",
         harness.BerPoint(MODE_SNR_DB, errors, syms.numel() * 2),
         harness.qpsk_ber_theory(MODE_SNR_DB))
    q16 = PulseShapedChain(QAM(4, 0.0, 1.0), Rates(REF_BAUD, REF_SR),
                           device=device)
    near("fused_ber_point natural 16-QAM at 14 dB",
         harness.fused_ber_point(q16, 14.0, N_SYMBOLS, CHANNELS, SEED + 47),
         harness.mqam_ber_theory(14.0, 16))
    pts = harness.ber_waterfall(chain, [3.0, 5.0, 7.0, 9.0], 1024, 64,
                                SEED + 48)
    bers = [p.ber for p in pts]
    print(f"[harness] ber_waterfall 3/5/7/9 dB: {bers}", flush=True)
    if not all(a > b for a, b in zip(bers, bers[1:])) or bers[-1] <= 0:
        fail(f"ber_waterfall not monotone: {bers}")
    gates = harness.release_gates(seed=SEED, scale=GATES_SCALE,
                                  device=device)
    for gate in gates:
        print(f"[harness] gate {json.dumps(gate)}", flush=True)
        run = gate["gate"] not in harness.NOT_RUN
        if (gate["passed"] is not True) if run else (
                gate["passed"] is not None or not gate.get("not_run")):
            fail(f"release gate {gate['gate']}: {gate}")
    args = (chain, MODE_SNR_DB, N_SYMBOLS, CHANNELS, SEED + 44)
    ms = time_calls(harness.fused_ber_point, args, device, calls=5, reps=3)
    bits = CHANNELS * N_SYMBOLS * 2
    print(f"[times] harness.fused_ber_point per call {ms:.4f} ms "
          f"({bits / ms * 1e3:.4e} bits/s, {CHANNELS} ch x {N_SYMBOLS} QPSK "
          f"symbols, host symbol draw included) on {card}", flush=True)
    return launches


def phase_viterbi_wide(device) -> tuple[dict, dict]:
    """Phase 26 (d): K13 on the shapes F1 widened: K = 3 (S = 4, the warp
    route with idle lanes) and K = 15 (S = 16384, the block route, the
    decisions in the global scratch) through ``decode_soft_windowed`` with
    every launch count set to 0 just before and read just after, bit for
    bit against the plain version. Returns (errors, launches)."""
    from modem_tpu_torch.ops import viterbi_kernel as vk

    errs, launches = {}, {}
    for name, (k, polys) in WIDE_VIT.items():
        code, bits, lam = vit_case(k, polys, WIDE_VIT_SHAPE, 0.8, SEED + 50,
                                   device)
        llr = lam.reshape(lam.shape[0], -1)
        t_w = WIDE_VIT_BLOCK + 20 * k
        kernel = (vk.VITERBI_KERNEL if vk.warp_route(code, t_w)
                  else vk.VITERBI_BLOCK_KERNEL)
        reset_launches()
        got = code.decode_soft_windowed(llr, WIDE_VIT_BLOCK)
        launches.update(read_launches({name: kernel}, f"K={k} decode",
                                      "viterbi wide"))
        want = vk.stream_plain(code, lam, WIDE_VIT_BLOCK, 10 * k, 1e6)
        torch.cuda.synchronize(device)
        errs[name] = max_err(got, want)
        print(f"[viterbi wide] K={k} (S={code.n_states}, "
              f"{'warp' if kernel is vk.VITERBI_KERNEL else 'block'} route) "
              f"{WIDE_VIT_SHAPE[0]} ch x {WIDE_VIT_SHAPE[1]} bits, B="
              f"{WIDE_VIT_BLOCK}: max |kernel - plain| = {errs[name]:.0f} "
              f"(exact), BER vs sent "
              f"{float((got != bits).double().mean()):.3e}", flush=True)
        if errs[name] != 0:
            fail(f"K13 at K={k}: kernel and plain differ")
    return errs, launches


def mode_work(kind: str, spec: dict, c: int, k: int, chain):
    """Bytes a mode must move (each input read once, each output written
    once) and its f32 operations, from the shapes; as ``chain_work``, with
    the mode's own counts: the algebraic QAM map 8 operations a symbol and
    its slice 12 (against 5 a table point); the NCO 3 a sample to mix up
    and 2 to detect, plus a cos and a sin a sample where the carrier has
    more than NCO_TABLE phases (a table otherwise, whose few entries are
    not counted); the noise 16 a waveform sample
    (as ``fsk_work``). Storage: f32 4 B, bf16 and int16 2 B a sample."""
    taps, sps, span = chain.rrc.shape[0], chain.sps, chain.span
    qam, car = spec.get("qam") is not None, spec.get("carrier")
    m = chain.lut.shape[0]
    n_wave = (k + span) * sps
    samples = c * n_wave
    params = 4 * taps + (0 if qam else 8 * m)
    map_ops = 8 * c * (k + span) if qam else 0
    slice_ops = c * k * (12 if qam else 5 * m)
    tx_ops = 2 * 2 * (k + span) * taps * c + map_ops
    rx_ops = 2 * 2 * k * taps * c
    trig = 2 if car and car[1] // math.gcd(*car) > NCO_TABLE else 0
    rails = 1 if car else 2
    if kind == "chain":
        ops = tx_ops + rx_ops + slice_ops
        if car:
            ops += samples * (5 + trig)
        if spec.get("sigma") is not None:
            ops += samples * 16
        return 4 * c * k * 2 + params, ops
    if kind == "tx":
        out_bytes = 4 if spec.get("store", (None, torch.float32))[1] == \
            torch.float32 else 2
        return (4 * c * k + out_bytes * rails * samples + params,
                tx_ops + (samples * (3 + trig) if car else 0))
    in_bytes = 2 if spec.get("in") == torch.bfloat16 else 4
    soft = spec.get("soft", False)
    return (in_bytes * rails * samples + (8 if soft else 4) * c * k + params,
            rx_ops + (0 if soft else slice_ops)
            + (samples * (2 + trig) if car else 0))


def phase_mode_times(chain, device, card: str) -> dict:
    """Phase 27 (e): each new mode's kernel and plain version per call at
    256 x 4096, the profiler's device time and the bound; then widened K13
    at K = 3 and 15."""
    from modem_tpu_torch.ops import viterbi_kernel as vk

    times = {}
    for name, kind, spec, sym, _ in mode_cases():
        bps = MODE_QAM_BPS if "qam" in spec else 2
        syms = mode_symbols((CHANNELS, N_SYMBOLS), bps, device, SEED + 42)
        args = mode_args(kind, spec, syms, N_SYMBOLS, 256, chain)
        kern, plain = mode_fns(kind)
        ms, plain_ms, dev_ms = kernel_times(kern, plain, args, device, sym,
                                            plain_calls=5)
        times[name] = (ms, plain_ms, dev_ms, None,
                       mode_work(kind, spec, CHANNELS, N_SYMBOLS, chain))
        print_times(name, CHANNELS * N_SYMBOLS * chain.sps, times[name], card,
                    "no library call")
    for name, (k, polys) in WIDE_VIT.items():
        code, _, lam = vit_case(k, polys, WIDE_VIT_SHAPE, 0.8, SEED + 51,
                                device)
        t_w = WIDE_VIT_BLOCK + 20 * k
        sym = ("viterbi_kernel" if vk.warp_route(code, t_w)
               else "viterbi_block_kernel")
        times[name] = viterbi_times(name, sym, code, lam, WIDE_VIT_SHAPE[0],
                                    WIDE_VIT_BLOCK, 10 * k, device, card,
                                    plain_calls=1)
    return times


def viterbi_times(name: str, sym: str, code, lam, channels: int, block: int,
                  halo: int, device, card: str, plain_calls: int) -> tuple:
    """K13's stream form and its plain version per call, the profiler's
    device time of kernel symbol ``sym``, the bound and the time per trellis
    step, printed; returns the report times."""
    from modem_tpu_torch.ops import viterbi_kernel as vk

    ms, plain_ms, dev_ms = kernel_times(
        vk.stream_kernel, vk.stream_plain, (code, lam, block, halo, 1e6),
        device, sym, plain_calls=plain_calls)
    nbytes, flops, rows, t_w = viterbi_work(code, channels, lam.shape[1],
                                            block, halo)
    bound_ms, bound_by = bound(nbytes, flops)
    step = dev_ms if dev_ms is not None else ms
    dev_txt = "not measured" if dev_ms is None else f"{dev_ms:.4f} ms"
    print(f"[times] {name:26s} per call: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, no library call; kernel alone in the profiler "
          f"{dev_txt}; bound {bound_ms:.6f} ms by {bound_by} "
          f"({nbytes / 1e6:.3f} MB, {flops / 1e9:.4f} GFLOP); per trellis "
          f"step {step / t_w * 1e3:.4f} us; {rows} rows x {t_w} steps x "
          f"{code.n_states} states on {card}", flush=True)
    acs_ms, trace_ms = k13_floor(code, t_w)
    clock = sm_clock_mhz()
    print(f"[times] {name}: {step / t_w * clock * 1e3:.1f} cycles a trellis "
          f"step at {clock:.0f} MHz; {100 * bound_ms / step:.3f}% of the "
          f"bound; serial floor {acs_ms:.6f} ms of ACS + {trace_ms:.6f} ms "
          f"of traceback a row ({K13_ACS_OPS} dependent f32 operations a "
          f"step and the renormalisation's share, {K13_TRACE_OPS} a "
          f"traceback step, x {K14_CHAIN_CYCLES} cycles), "
          f"{100 * (acs_ms + trace_ms) / step:.1f}% of it, on {card}",
          flush=True)
    return ms, plain_ms, dev_ms, None, (nbytes, flops)


def k13_floor(code, t_w: int) -> tuple[float, float]:
    """K13's serial floor in ms at the card's SM clock: one row's ACS
    chain (t_w steps of K13_ACS_OPS dependent operations, plus a min tree
    of log2(S) levels and a subtract every 8 steps) and its traceback's
    (t_w steps of K13_TRACE_OPS), each K14_CHAIN_CYCLES; every row runs at
    once, so no call can be shorter than their sum."""
    per_step = K13_ACS_OPS + (math.log2(code.n_states) + 1) / 8
    clock = sm_clock_mhz()
    cycles = K14_CHAIN_CYCLES / clock / 1e3
    return t_w * per_step * cycles, t_w * K13_TRACE_OPS * cycles


# ---- the turbo and polar inner codes (K14, K15, K16) ----

def turbo_llrs(code, cws: int, snr_db: float, seed: int, device):
    """Random info bits ``[cws, K]`` and their codeword's BPSK LLRs at
    ``snr_db`` per code bit: ``2 y / sigma^2`` of ``y = 1 - 2c`` plus
    Gaussian noise."""
    g = torch.Generator(device=device).manual_seed(seed)
    bits = torch.randint(0, 2, (cws, code.k), generator=g, device=device,
                         dtype=torch.int32)
    sigma = 10.0 ** (-snr_db / 20.0)
    y = 1.0 - 2.0 * code.encode(bits).to(torch.float32)
    y = y + sigma * torch.randn(y.shape, generator=g, device=device)
    return bits, y * (2.0 / sigma ** 2)


def turbo_rows(code, llr, window=None, guard=32):
    """The rows of both half-iterations of a decode's first iteration (the
    second with the first's extrinsics as a-priori), at ``pick_geometry``
    or at an explicit window widened by ``pick_guard``: ``[(rows, guard,
    window)]``."""
    from modem_tpu_torch.ops import bcjr_kernel as bk

    k = code.k
    w, g = (bk.pick_geometry(k + 3, guard) if window is None
            else (window, bk.pick_guard(window, guard)))
    ls, lp1, lp2 = llr[:, :k], llr[:, k:2 * k], llr[:, 2 * k:3 * k]
    tail = [llr[:, 3 * k + 3 * i:3 * k + 3 * i + 3] for i in range(4)]
    rows1, _ = bk.make_rows(ls, lp1, torch.zeros_like(ls), tail[0], tail[1],
                            w, g)
    le1 = bk.bcjr_windowed(ls, lp1, torch.zeros_like(ls), tail[0], tail[1],
                           w, g)
    rows2, _ = bk.make_rows(code._il(ls), lp2, code._il(le1), tail[2],
                            tail[3], w, g)
    return [(rows1, g, w), (rows2, g, w)]


def check_exact(tag: str, label: str, got, want) -> float:
    torch.cuda.synchronize()
    err = max_err(got, want)
    print(f"[{tag}] {label}: max |kernel - plain| = {err:.0f} (exact)",
          flush=True)
    if err != 0:
        fail(f"{label}: kernel and plain differ")
    return err


def phase_turbo_kernel(device) -> float:
    """Phase 28: K14 against its plain version, bit for bit: both
    half-iterations of a first iteration at ``TurboCode(1024)`` x 512
    codewords (``pick_geometry``: one window of 1092 steps a row) on LLRs
    at 1 dB, then K = 40 with an explicit window of 16 (``pick_guard``:
    guard 34) and ``decode(window=16)`` against the CPU route at that
    guard."""
    from modem_tpu_torch.fec import TurboCode
    from modem_tpu_torch.ops import bcjr_kernel as bk

    code = TurboCode(TURBO_K)
    _, llr = turbo_llrs(code, TURBO_CW, TURBO_SNR_DB, SEED + 60, device)
    errs = []
    for half, (rows, g, w) in enumerate(turbo_rows(code, llr), 1):
        errs.append(check_exact(
            "turbo kernel", f"K14 half-iteration {half}, {rows.shape[1]} rows"
            f" x {rows.shape[2]} steps (window {w}, guard {g})",
            bk.rows_kernel(rows, g, w), bk.rows_plain(rows, g, w)))
    k, w = TURBO_SMALL
    small = TurboCode(k)
    bits, llr = turbo_llrs(small, 64, TURBO_SNR_DB, SEED + 61, device)
    for half, (rows, g, w) in enumerate(turbo_rows(small, llr, w), 1):
        errs.append(check_exact(
            "turbo kernel", f"K14 K={k} half-iteration {half}, "
            f"{rows.shape[1]} rows (window {w}, pick_guard -> {g})",
            bk.rows_kernel(rows, g, w), bk.rows_plain(rows, g, w)))
    got = small.decode(llr, window=w)
    want = small.decode(llr.cpu(), window=w, guard=bk.pick_guard(w, 32))
    errs.append(check_exact(
        "turbo kernel", f"TurboCode({k}).decode(window={w}) on the card vs "
        f"the CPU route at guard {bk.pick_guard(w, 32)}", got.cpu(), want))
    try:
        small.decode(llr, window=w - 1)
    except ValueError as e:
        print(f"[turbo kernel] window {w - 1} refused: {e}", flush=True)
    else:
        fail("an odd window was not refused")
    return max(errs)


def phase_turbo_main(device) -> dict:
    """Phase 29: ``TurboCode(1024).decode`` at 512 codewords on the card,
    6 iterations fixed and with early exit, each with every launch count
    set to 0 just before: decisions equal to the plain route's (the CPU
    full-block BCJR) and to the sent bits. Returns K14's launches."""
    from modem_tpu_torch.fec import TurboCode
    from modem_tpu_torch.ops import bcjr_kernel as bk

    code = TurboCode(TURBO_K)
    bits, llr = turbo_llrs(code, TURBO_CW, TURBO_SNR_DB, SEED + 62, device)
    counts = {}
    for early in (False, True):
        reset_launches()
        got = code.decode(llr, iters=TURBO_ITERS, early_exit=early)
        tag = "early exit" if early else "fixed"
        counts[tag] = read_launches({TURBO_NAME: bk.BCJR_KERNEL},
                                    f"turbo decode ({tag})", "turbo main")
        want = code.decode(llr.cpu(), iters=TURBO_ITERS, early_exit=early)
        errs = int((got != bits).sum())
        print(f"[turbo main] decode {tag}, {TURBO_ITERS} iterations at most:"
              f" {counts[tag][TURBO_NAME]} K14 launches, equal to the CPU "
              f"route: {torch.equal(got.cpu(), want)}, {errs} bit errors "
              f"in {bits.numel()}", flush=True)
        if not torch.equal(got.cpu(), want) or errs:
            fail(f"turbo decode ({tag}) on the card")
    return counts["fixed"]


def polar_llrs(code, crc, cws: int, sigma: float, seed: int, device):
    """Random data bits with a CRC-16 in the code's K, and their
    codeword's BPSK LLRs at noise ``sigma`` (``bench_fec.py``'s form)."""
    g = torch.Generator(device=device).manual_seed(seed)
    data = torch.randint(0, 2, (cws, code.k - crc.w), generator=g,
                         device=device, dtype=torch.int32)
    framed = crc.append(data)
    y = 1.0 - 2.0 * code.encode(framed).to(torch.float32)
    y = y + sigma * torch.randn(y.shape, generator=g, device=device)
    return framed, y * (2.0 / sigma ** 2)


def phase_polar_kernels(device) -> dict:
    """Phase 30: K15 and K16 against their plain versions at
    ``PolarCode(256, 128)`` x 4096 codewords (CRC-16 inside K), noise
    sigma 0.3 (``bench_fec.py``'s) and 0.8: SC u and x, SCL-8 u and path
    metrics bit for bit; ``decode`` and ``decode_list(crc)`` on the card
    equal to the CPU route, with K15 / K16 launched once a call; K16 also
    at the link's 1024 codewords. Returns each kernel's largest error
    against its plain version."""
    from modem_tpu_torch.fec import PolarCode, crc16_ccitt
    from modem_tpu_torch.ops import sc_kernel as sk, scl_kernel as lk

    code, crc = PolarCode(POLAR_N, POLAR_K), crc16_ccitt()
    errs = {SC_NAME: 0.0, SCL_NAME: 0.0}
    for sigma in POLAR_SIGMAS:
        framed, lam = polar_llrs(code, crc, POLAR_CW, sigma, SEED + 63,
                                 device)
        label = f"{POLAR_CW} x ({POLAR_N}, {POLAR_K}), sigma {sigma}"
        errs[SC_NAME] = max(errs[SC_NAME], check_exact(
            "polar kernel", f"K15 SC u, x at {label}",
            sk.sc_kernel(code, lam), sk.sc_plain(code, lam)))
        errs[SCL_NAME] = max(errs[SCL_NAME], check_exact(
            "polar kernel", f"K16 CA-SCL-8 u, pm at {label}",
            lk.scl_kernel(code, lam), lk.scl_plain(code, lam)))
        reset_launches()
        sc = code.decode(lam)
        scl = code.decode_list(lam, 8, crc=crc)
        read_launches({SC_NAME: sk.SC_KERNEL, SCL_NAME: lk.SCL_KERNEL},
                      f"decode, decode_list at sigma {sigma}", "polar kernel")
        lam_c = lam.cpu()
        for name, got, want in (("decode", sc, code.decode(lam_c)), (
                "decode_list(crc)", scl, code.decode_list(lam_c, 8,
                                                          crc=crc))):
            n_err = int((got != framed).sum())
            print(f"[polar kernel] {name} at sigma {sigma}: equal to the CPU"
                  f" route: {torch.equal(got.cpu(), want)}, {n_err} bit "
                  f"errors in {framed.numel()}", flush=True)
            if not torch.equal(got.cpu(), want):
                fail(f"polar {name} on the card differs from the CPU")
    # the link's shape: 1024 codewords, one partial wave of the card
    _, lam = polar_llrs(code, crc, POLAR_LINK_CW, POLAR_SIGMAS[-1], SEED + 64,
                        device)
    errs[SCL_NAME] = max(errs[SCL_NAME], check_exact(
        "polar kernel", f"K16 CA-SCL-8 u, pm at {POLAR_LINK_CW} x ({POLAR_N},"
        f" {POLAR_K}), sigma {POLAR_SIGMAS[-1]}", lk.scl_kernel(code, lam),
        lk.scl_plain(code, lam)))
    return errs


def fec_link_kernels(inner: str) -> dict:
    from modem_tpu_torch.ops import (bcjr_kernel as bk, sc_kernel as sk,
                                     scl_kernel as lk, txrx)

    kern = {TURBO_NAME: bk.BCJR_KERNEL, SC_NAME: sk.SC_KERNEL,
            SCL_NAME: lk.SCL_KERNEL}[inner]
    return {"fused_tx": txrx.TX_KERNEL, "fused_rx_soft": txrx.RX_SOFT_KERNEL,
            inner: kern}


def hold_inner_kernel(link, inner: str, wave, nv: float) -> float:
    """The inner decoder's kernel against its plain version on exactly the
    inputs the link run gave it: the first half-iteration's rows (K14) or
    the de-matched mother-code LLRs (K15, K16). Returns the error."""
    from modem_tpu_torch.fec import block_deinterleave
    from modem_tpu_torch.ops import (bcjr_kernel as bk, sc_kernel as sk,
                                     scl_kernel as lk)

    llr = link.chain.rx_soft_fused(wave, link.n_symbols, noise_var=nv)
    if link.rows:
        llr = block_deinterleave(llr, link.rows)
    if inner == TURBO_NAME:
        x = llr.reshape(-1, link.turbo.n)
        rows, g, w = turbo_rows(link.turbo, x)[0]
        got, want = bk.rows_kernel(rows, g, w), bk.rows_plain(rows, g, w)
    else:
        lam = link.polar.dematch(llr.reshape(-1, link.polar.e))
        code = link.polar.code
        pair = ((sk.sc_kernel, sk.sc_plain) if inner == SC_NAME
                else (lk.scl_kernel, lk.scl_plain))
        got, want = pair[0](code, lam), pair[1](code, lam)
    shape = tuple((got[0] if isinstance(got, tuple) else got).shape)
    return check_exact("fec link", f"{inner} on the link's own inputs, "
                       f"output {shape}", got, want)


def phase_fec_links(device, errs: dict) -> dict:
    """Phase 31: the slice's main paths through their entry points:
    ``lte_like_turbo_link()`` at 256 frames and 1 dB (K14),
    ``nr_like_control_link()`` at 256 frames and 3 dB (CA-SCL-8, K16) and
    ``nr_like_control_link(list_size=None)`` at 5 dB (SC, K15), each
    ``tx_fused`` -> seeded AWGN -> ``rx_fused`` with every launch count set
    to 0 just before: every payload back, every CRC true, K2, K3 soft and
    the inner kernel launched; then the inner kernel against its plain
    version on that run's own inputs, its error folded into ``errs``.
    Returns each inner kernel's launches in its run."""
    from modem_tpu_torch import presets

    launches = {}

    def hold(link, pay, clean, wave, nv, inner):
        errs[inner] = max(errs[inner], hold_inner_kernel(link, inner, wave,
                                                         nv))

    for name, inner, kw, snr in (
            ("lte_like_turbo_link", TURBO_NAME, {}, FEC_LINK_SNR_DB[0]),
            ("nr_like_control_link", SCL_NAME, {}, FEC_LINK_SNR_DB[1]),
            ("nr_like_control_link", SC_NAME, {"list_size": None},
             FEC_LINK_SNR_DB[2])):
        link = getattr(presets, name)(device=device, **kw)
        counts = run_link(
            link, FEC_LINK_FRAMES, snr, SEED + 64, device,
            hold=lambda *a, inner=inner: hold(*a, inner),
            kernels=fec_link_kernels(inner),
            tag=f"{name}({', '.join(f'{a}={b}' for a, b in kw.items())})")
        launches[inner] = counts[inner]
    return launches


def phase_fec_cli(device) -> None:
    """Phase 32: ``link tx`` -> ``link rx`` on the card for the turbo and
    polar presets: every payload back with an OK verdict a frame, K14 /
    K16 launched."""
    import io
    import numpy as np
    from modem_tpu_torch.cli import link as cli

    for preset, inner in (("lte_like_turbo", TURBO_NAME),
                          ("nr_like_control", SCL_NAME)):
        make = cli.PRESETS[preset]
        pb = make(device=device).payload_bits
        bits = np.random.default_rng(SEED + 65).integers(0, 2, 16 * pb)
        common = ["--preset", preset, "--batch-frames", "8", "--device",
                  str(device)]
        wave = io.BytesIO()
        rc = cli.run(cli.build_parser().parse_args(["tx", *common]),
                     "".join("01"[b] for b in bits).encode(), wave)
        reset_launches()
        out, err = io.BytesIO(), io.StringIO()
        rc_rx = cli.run(cli.build_parser().parse_args(
            ["rx", "--noise-var", "0.05", *common]), wave.getvalue(), out,
            stderr=err)
        torch.cuda.synchronize(device)
        got = np.array([int(c) for c in
                        "".join(out.getvalue().decode().split())])
        n_ok = err.getvalue().count("frame: OK")
        n = fec_link_kernels(inner)[inner].launches
        print(f"[cli] link tx --preset {preset} (16 frames) -> link rx: exit "
              f"{rc}/{rc_rx}, {n_ok} OK verdicts, payload "
              f"{'equal' if np.array_equal(got, bits) else 'DIFFERENT'}, "
              f"{inner} launches {n}", flush=True)
        if (rc, rc_rx, n_ok) != (0, 0, 16) or n == 0 or \
                not np.array_equal(got, bits):
            fail(f"link CLI pair for {preset} on the card")


def bcjr_work(cws: int, k: int) -> tuple[float, float]:
    """Bytes a half-iteration must move over ``cws`` codewords of ``k``
    info bits (``lu`` and ``lp`` read once over the K+3 trellis steps, K
    extrinsics written once; no pin mask, which follows from the geometry,
    and no guard pads) and its f32 operations: per state-step of the K+3
    steps the alpha sweep's 2 adds, the pair's max, the max over the
    states and the renormalising subtract (5) and the beta sweep's 5, and
    4 branch metrics of 2 products and an add each; per state-step of the
    K info steps the APP's 4 adds and 2 maxima (6), and 2 subtracts for
    the extrinsic."""
    return (4.0 * cws * (2 * (k + 3) + k),
            cws * ((k + 3) * (8 * 10 + 4 * 3) + k * (8 * 6 + 2)))


def sc_work(b: int, n: int, n_bits: int) -> tuple[float, float]:
    """Bytes K15 must move (the LLRs read once, u and x written once as
    bytes) and its f32 operations: per level n/2 f's (2 abs, a min, 2
    sign products: 5) and n/2 g's (2x, 1 - 2x, the product, the add: 4),
    a compare a leaf."""
    return 4.0 * b * n + 2.0 * b * n, b * (n_bits * n / 2 * 9 + n)


def scl_work(b: int, n: int, n_bits: int, k: int) -> tuple[float, float]:
    """Bytes K16 must move (the LLRs read once, 8 paths' u bytes and 8
    metrics written once) and its f32 operations: 8 paths' SC node work;
    an info leaf's 16 candidates (a negation, a max, an add each) and the
    8 smallest in order by a 16-input sorting network's 60 comparators
    (the fewest known), a compare each; a frozen leaf's 8 penalties (3
    each)."""
    return (4.0 * b * n + 8.0 * b * n + 32.0 * b,
            b * (8 * (n_bits * n / 2 * 9 + n) + k * (48 + 60)
                 + (n - k) * 24))


def phase_fec_times(device, card: str) -> dict:
    """Phase 33: K14, K15 and K16 and their plain versions per call at the
    main path's widths, the profiler's device time and the bound (K14 also
    at window 256, 2560 rows, held bit for bit first; its time a lane's
    step, share of the bound and serial floor; K16 also at the link's 1024
    codewords, with its serial floor); the encoders and decoders per call
    in Mbit/s of info bits; the two links' ``tx_fused`` and ``rx_fused``
    per call at 256 frames with the device's busy time and idle share.
    Returns the report times."""
    from modem_tpu_torch import presets
    from modem_tpu_torch.fec import PolarCode, TurboCode, crc16_ccitt
    from modem_tpu_torch.ops import (bcjr_kernel as bk, sc_kernel as sk,
                                     scl_kernel as lk)

    times = {}
    code = TurboCode(TURBO_K)
    bits, llr = turbo_llrs(code, TURBO_CW, TURBO_SNR_DB, SEED + 66, device)
    rows, g, w = turbo_rows(code, llr)[0]
    ms, plain_ms, dev_ms = kernel_times(bk.rows_kernel, bk.rows_plain,
                                        (rows, g, w), device, "bcjr_kernel",
                                        plain_calls=1)
    work = bcjr_work(TURBO_CW, TURBO_K)
    times[TURBO_NAME] = (ms, plain_ms, dev_ms, None, work)
    print_k14_times(TURBO_NAME, rows, g, w, times[TURBO_NAME], card)
    rows, g, w = turbo_rows(code, llr, TURBO_WINDOW)[0]
    check_exact("times", f"K14 window {TURBO_WINDOW}, {rows.shape[1]} rows "
                f"x {rows.shape[2]} steps", bk.rows_kernel(rows, g, w),
                bk.rows_plain(rows, g, w))
    ms, plain_ms, dev_ms = kernel_times(bk.rows_kernel, bk.rows_plain,
                                        (rows, g, w), device, "bcjr_kernel",
                                        plain_calls=1)
    print_k14_times(f"{TURBO_NAME} w{TURBO_WINDOW}", rows, g, w,
                    (ms, plain_ms, dev_ms, None, work), card)
    for label, fn, args, info in (
            ("TurboCode(1024).encode", code.encode, (bits,), bits.numel()),
            (f"TurboCode(1024).decode {TURBO_ITERS} iters",
             lambda x: code.decode(x, iters=TURBO_ITERS), (llr,),
             bits.numel()),
            ("TurboCode(1024).decode early exit",
             lambda x: code.decode(x, iters=TURBO_ITERS, early_exit=True),
             (llr,), bits.numel())):
        t = time_calls(fn, args, device, calls=3, reps=3)
        busy = device_busy_ms(fn, args, device, calls=3)
        print(f"[times] {label:34s} per call {t:.4f} ms: {info / t / 1e3:.2f}"
              f" Mbit/s of info bits ({TURBO_CW} codewords), device busy "
              f"{busy:.4f} ms (idle share {1 - busy / t:.3f}) on {card}",
              flush=True)

    pcode, crc = PolarCode(POLAR_N, POLAR_K), crc16_ccitt()
    framed, lam = polar_llrs(pcode, crc, POLAR_CW, POLAR_SIGMAS[-1],
                             SEED + 67, device)
    for name, kern, plain, sym, work in (
            (SC_NAME, sk.sc_kernel, sk.sc_plain, "sc_kernel",
             sc_work(POLAR_CW, POLAR_N, pcode.n_bits)),
            (SCL_NAME, lk.scl_kernel, lk.scl_plain, "scl_kernel",
             scl_work(POLAR_CW, POLAR_N, pcode.n_bits, POLAR_K))):
        ms, plain_ms, dev_ms = kernel_times(kern, plain, (pcode, lam),
                                            device, sym, plain_calls=1)
        times[name] = (ms, plain_ms, dev_ms, None, work)
        print_fec_times(name, f"{POLAR_CW} x ({POLAR_N}, {POLAR_K})",
                        times[name], card)
    print_k16_floor(f"{SCL_NAME}", POLAR_CW, times[SCL_NAME], card)
    _, lam_link = polar_llrs(pcode, crc, POLAR_LINK_CW, POLAR_SIGMAS[-1],
                             SEED + 69, device)
    t_link = (*kernel_times(lk.scl_kernel, lk.scl_plain, (pcode, lam_link),
                            device, "scl_kernel", plain_calls=1), None,
              scl_work(POLAR_LINK_CW, POLAR_N, pcode.n_bits, POLAR_K))
    print_fec_times(f"{SCL_NAME} x{POLAR_LINK_CW}",
                    f"{POLAR_LINK_CW} x ({POLAR_N}, {POLAR_K})", t_link, card)
    print_k16_floor(f"{SCL_NAME} x{POLAR_LINK_CW}", POLAR_LINK_CW, t_link,
                    card)
    info = framed.numel()
    for label, fn, args in (
            ("PolarCode(256,128).encode", pcode.encode, (framed,)),
            ("PolarCode(256,128).decode (SC)", pcode.decode, (lam,)),
            ("decode_list(8, crc)", lambda x: pcode.decode_list(x, 8,
                                                                crc=crc),
             (lam,))):
        t = time_calls(fn, args, device, calls=5, reps=3)
        print(f"[times] {label:34s} per call {t:.4f} ms: {info / t / 1e3:.2f}"
              f" Mbit/s of coded-block bits ({POLAR_CW} codewords) on {card}",
              flush=True)

    for name, snr in (("lte_like_turbo_link", FEC_LINK_SNR_DB[0]),
                      ("nr_like_control_link", FEC_LINK_SNR_DB[1])):
        link = getattr(presets, name)(device=device)
        g = torch.Generator(device=device).manual_seed(SEED + 68)
        pay = torch.randint(0, 2, (FEC_LINK_FRAMES, link.payload_bits),
                            generator=g, device=device, dtype=torch.int32)
        wave, nv = link_noise(g, link.tx_fused(pay), snr)
        for label, fn, fargs in (("frame", link.frame, (pay,)),
                                 ("tx_fused", link.tx_fused, (pay,)),
                                 ("rx_fused", link.rx_fused, (wave, nv))):
            t = time_calls(fn, fargs, device, calls=3, reps=3)
            busy = device_busy_ms(fn, fargs, device, calls=3)
            bits_n = FEC_LINK_FRAMES * link.payload_bits
            print(f"[times] {name}.{label:9s} per call {t:.4f} ms "
                  f"({bits_n / t / 1e3:.2f} Mbit/s of payload), device busy "
                  f"{busy:.4f} ms (idle share {1 - busy / t:.3f}), "
                  f"{FEC_LINK_FRAMES} frames at {snr} dB on {card}",
                  flush=True)
    return times


def long_route_names(sps: int, span: int) -> dict:
    """Report names of K1, K3 hard and K3 soft on a long-route chain."""
    tag = f"sps{sps}_span{span}"
    return {"fused_pulse_chain": f"fused_pulse_chain_{tag}",
            "fused_rx": f"fused_rx_{tag}",
            "fused_rx_soft": f"fused_rx_soft_{tag}"}


def long_route_entries() -> list:
    """(name, source, replaced TPU kernel) of each long-route entry."""
    out = []
    for baud, sr, span in LONG_ROUTE:
        names = long_route_names(sr // baud, span)
        out += [(names["fused_pulse_chain"], "modem_tpu_torch/csrc/chain.cu",
                 "modem_tpu/ops/pallas_chain.py:195"),
                (names["fused_rx"], "modem_tpu_torch/csrc/txrx.cu",
                 "modem_tpu/ops/pallas_txrx.py:277"),
                (names["fused_rx_soft"], "modem_tpu_torch/csrc/txrx.cu",
                 "modem_tpu/ops/pallas_txrx.py:277")]
    return out


def phase_long_route(device, card: str) -> tuple[dict, dict, dict]:
    """Phase 34: K1's and K3's long route (taps from a device array in
    shared memory), for chains past 256 taps or 64 samples a symbol
    (LONG_ROUTE) at 256 x 1024 symbols: ``roundtrip_fused``,
    ``rx_fused(tx_fused)`` and ``rx_soft_fused`` give the bits back, with
    every launch count set to 0 just before and read just after; then K1
    and K3 hard bit for bit and K3 soft within ATOL against their plain
    versions, and their times beside the plain versions', the profiler's
    device time, the bound and, for K3 soft, the ``conv1d`` yardstick.
    Returns (errors, launches, times)."""
    from modem_tpu_torch import Rates
    from modem_tpu_torch.chain import PulseShapedChain
    from modem_tpu_torch.models.psk import QPSK
    from modem_tpu_torch.ops import chain_kernel as ck, txrx
    from modem_tpu_torch.ops.llr import llr_hard_bits

    errs, launches, times = {}, {}, {}
    for baud, sr, span in LONG_ROUTE:
        chain = PulseShapedChain(QPSK(0.0, 1.0), Rates(baud, sr),
                                 span_symbols=span, device=device)
        sps, k = chain.sps, LONG_SYMBOLS
        names = long_route_names(sps, span)
        if txrx.kernel_taps(chain.rrc, sps)[0] is not None:
            fail(f"sps {sps}, span {span} did not take the long route")
        g = torch.Generator(device=device).manual_seed(SEED + 80 + sps)
        bits = torch.randint(0, 2, (CHANNELS, 2 * k), generator=g,
                             device=device, dtype=torch.int32)
        label = f"sps {sps}, span {span} ({chain.rrc.shape[0]} taps)"
        reset_launches()
        ok = torch.equal(chain.roundtrip_fused(bits), bits)
        launches.update(read_launches(
            {names["fused_pulse_chain"]: ck.CHAIN_KERNEL},
            f"{label} loopback", "long route"))
        reset_launches()
        wave = chain.tx_fused(bits)
        ok &= torch.equal(chain.rx_fused(wave, k), bits)
        ok &= torch.equal(llr_hard_bits(chain.rx_soft_fused(
            wave, k, noise_var=0.5)), bits)
        launches.update(read_launches(
            {names["fused_rx"]: txrx.RX_HARD_KERNEL,
             names["fused_rx_soft"]: txrx.RX_SOFT_KERNEL},
            f"{label} tx_fused -> rx_fused, rx_soft_fused", "long route"))
        print(f"[long route] {label}: the bits back through every fused form"
              f": {ok}", flush=True)
        if not ok:
            fail(f"long route {label}: bits differ")
        syms = random_symbols((CHANNELS, k), device, sentinels=True)
        for name, _, kern, plain, make_args, exact, _, _ in kernel_cases(
                chain):
            if name not in names:
                continue
            args = make_args(syms if name != "fused_rx" else syms.clamp(0))
            got, want = kern(*args), plain(*args)
            torch.cuda.synchronize()
            if name == "fused_pulse_chain":  # -1: no symbol, no decision
                real = syms >= 0
                got, want = got[real], want[real]
            err = max_err(got, want)
            print(f"[long route] {names[name]} vs plain at {CHANNELS} x {k}:"
                  f" max |kernel - plain| = {err:.3e}"
                  f"{' (exact)' if exact else ''}", flush=True)
            if (exact and err != 0) or err > ATOL:
                fail(f"long route {names[name]}: kernel and plain differ")
            errs[names[name]] = err
            ms, plain_ms, dev_ms = kernel_times(kern, plain, args, device,
                                                DEVICE_NAMES[name],
                                                plain_calls=2)
            lib_ms, lib_txt = None, "no library call"
            if name == "fused_rx_soft":
                fn, fargs, lib_err = rx_conv1d_yardstick(args)
                if lib_err > 1e-4:
                    fail(f"long route {names[name]}: conv1d yardstick "
                         f"disagrees with K3 soft ({lib_err})")
                lib_ms = time_calls(fn, fargs, device)
                lib_txt = (f"conv1d {lib_ms:.4f} ms (max |err| vs K3 "
                           f"{lib_err:.2e})")
            times[names[name]] = (ms, plain_ms, dev_ms, lib_ms,
                                  chain_work(chain, name, CHANNELS, k))
            print_times(names[name], CHANNELS * k * sps, times[names[name]],
                        card, lib_txt)
    return errs, launches, times


def phase_fir_routes(device) -> dict:
    """Phase 35: K4's generic and long routes and K5 without its carrier
    table, through the demodulator a user builds with other filters or
    another carrier, at 256 x 32768 (the reference path's passband): each
    call with every launch count set to 0 just before it and read just
    after, and the card against the CPU on two channels (and
    ``demodulate_fused`` against ``demodulate`` without the table). Returns
    the launches of each report entry."""
    from modem_tpu_torch import Demodulator
    from modem_tpu_torch.ops import demod_kernel as dk, filters, fir

    g = torch.Generator(device=device).manual_seed(SEED + 90)
    x = reference_path(device, ref_bits(g, device))[2]
    scale = float(x.abs().max())
    launches = {}

    def run(name, kernel, build, call, prep=lambda d, v: None):
        """``call(dem, x, prep(dem, x))`` for ``dem = build(device)`` on the
        card with the launches of ``call`` alone counted, then on the CPU
        for two channels; the outputs compared."""
        d = build(device)
        st = prep(d, x)
        reset_launches()
        got = call(d, x, st)
        launches.update(read_launches({name: kernel}, name, "fir routes"))
        d, xc = build(torch.device("cpu")), x[:2].cpu()
        want = call(d, xc, prep(d, xc))
        err = max_err(tuple(v[:2].cpu() for v in got), want)
        print(f"[fir routes] {name}: card vs CPU, 2 channels, max |err| "
              f"{err:.3e} (tol {ATOL} x max |x| = {ATOL * scale:.3e})",
              flush=True)
        if err > ATOL * scale:
            fail(f"{name}: the card differs from the CPU")
        return got

    def dem(lowpass=None, hilbert=None, carrier=(REF_CF, REF_SR)):
        return lambda d: Demodulator(*carrier, lowpass=lowpass,
                                     hilbert=hilbert, device=d)

    def locked(d, v):
        return d.lock_phase(v[:, :64], d.init_state((v.shape[0],)))

    run("fir_filter_7", fir.FIR_KERNEL, dem(hilbert=filters.hilbert_taps(7)),
        lambda d, v, _: (locked(d, v).phase_offset,))
    for k in (256, 257, 1000):
        run(fir_name(k), fir.FIR_KERNEL, dem(lowpass=windowed_lowpass(k)),
            lambda d, v, st: d.demodulate(v[:, 64:], st)[0], locked)
    name = DEMOD_NAMES[K5_UNTABLED]
    build = dem(carrier=K5_UNTABLED)
    fused = run(name, dk.DEMOD_KERNEL, build,
                lambda d, v, st: d.demodulate_fused(v[:, 64:], st)[0], locked)
    d = build(device)
    staged = d.demodulate(x[:, 64:], locked(d, x))[0]
    err = max_err(fused, staged)
    print(f"[fir routes] {name}: demodulate_fused vs demodulate max |err| "
          f"{err:.3e}", flush=True)
    if err > ATOL * scale:
        fail(f"{name}: demodulate_fused differs from demodulate")
    return launches


def k14_lane_steps(tw: int, keep_lo: int, keep_n: int) -> int:
    """Trellis steps the busier of K14's two lanes of a row walks: alpha
    over 0 .. keep_lo + keep_n, beta over tw - 1 .. keep_lo, meeting at
    tw // 2."""
    mid = tw // 2
    return max(max(mid, keep_lo + keep_n), tw - min(mid, keep_lo))


def print_k14_times(name: str, rows, keep_lo: int, keep_n: int, t,
                    card: str) -> None:
    """K14's times, its time a trellis step of a lane, its share of the
    bound and the serial floor: the steps a lane walks times the dependent
    operations of a step times their latency, at the card's SM clock."""
    ms, _, dev_ms, _, work = t
    tw = rows.shape[2]
    steps = k14_lane_steps(tw, keep_lo, keep_n)
    dev = dev_ms or ms
    clock = sm_clock_mhz()
    floor_ms = steps * K14_CHAIN_OPS * K14_CHAIN_CYCLES / clock / 1e3
    bound_ms, bound_by = bound(*work)
    print_fec_times(name, f"{rows.shape[1]} rows x {tw} steps", t, card)
    print(f"[times] {name}: {steps} steps a lane, {dev / steps * 1e6:.2f} ns "
          f"({dev / steps * clock * 1e3:.1f} cycles at {clock:.0f} MHz) a "
          f"step; {100 * bound_ms / dev:.3f}% of the bound ({bound_by}); "
          f"serial floor {floor_ms:.6f} ms ({K14_CHAIN_OPS} dependent f32 "
          f"operations x {K14_CHAIN_CYCLES} cycles a step), "
          f"{100 * floor_ms / dev:.1f}% of it, on {card}", flush=True)


def print_k16_floor(name: str, cws: int, t, card: str) -> None:
    """K16's serial floor: one codeword's chain of dependent operations
    (K16_*_OPS) at K14_CHAIN_CYCLES each, at the card's SM clock; every
    codeword runs at once, so no call can be shorter. Also the kernel's
    time a leaf of a codeword if all ran at once."""
    ms, _, dev_ms, _, _ = t
    dev = dev_ms or ms
    n, k = POLAR_N, POLAR_K
    ops = ((n - 1) * (K16_F_OPS + K16_G_OPS) + n * K16_LEAF_OPS
           + k * K16_RANK_OPS)
    clock = sm_clock_mhz()
    floor_ms = ops * K14_CHAIN_CYCLES / clock / 1e3
    print(f"[times] {name}: {dev / n * 1e6:.2f} ns ({dev / n * clock * 1e3:.1f}"
          f" cycles at {clock:.0f} MHz) a leaf over {cws} codewords; serial "
          f"floor {floor_ms:.6f} ms ({ops} dependent f32 operations x "
          f"{K14_CHAIN_CYCLES} cycles a codeword), {100 * floor_ms / dev:.1f}%"
          f" of it, on {card}", flush=True)


def print_fec_times(name: str, shape: str, t, card: str) -> None:
    ms, plain_ms, dev_ms, _, (nbytes, flops) = t
    dev_txt = "not measured" if dev_ms is None else f"{dev_ms:.4f} ms"
    bound_ms, bound_by = bound(nbytes, flops)
    print(f"[times] {name:26s} per call: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, no library call; kernel alone in the profiler "
          f"{dev_txt}; bound {bound_ms:.6f} ms by {bound_by} "
          f"({nbytes / 1e6:.3f} MB, {flops / 1e9:.4f} GFLOP); {shape} on "
          f"{card}", flush=True)


def print_times(name: str, samples: int, t, card: str, extra: str) -> None:
    ms, plain_ms, dev_ms, _, (nbytes, flops) = t
    dev_txt = "not measured" if dev_ms is None else f"{dev_ms:.4f} ms"
    bound_ms, bound_by = bound(nbytes, flops)
    print(f"[times] {name:26s} per call: kernel {ms:.4f} ms "
          f"({samples / ms * 1e3:.4e} samples/s), plain {plain_ms:.4f} ms, "
          f"{extra}; kernel alone in the profiler {dev_txt}; bound "
          f"{bound_ms:.4f} ms by {bound_by} ({nbytes / 1e6:.1f} MB, "
          f"{flops / 1e9:.3f} GFLOP); {samples} samples on {card}",
          flush=True)


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
        if "Compiling entry" in line or "registers" in line or \
                "spill" in line:
            print(f"[build] {line.strip()}", flush=True)

    chain = qpsk_reference_chain(Rates(1250, 10000), device=device)
    errs = phase_kernels(chain, device)
    launches = phase_main_path(chain, device)
    phase_noise(chain, device)
    times = {n: t + (chain_work(chain, n, CHANNELS, N_SYMBOLS),)
             for n, t in phase_times(chain, device, card).items()}
    errs.update(phase_ref_kernels(chain, device))
    launches.update(phase_ref_path(chain, device))
    phase_cli(device)
    times.update(phase_ref_times(chain, device, card))
    chains = fsk_chains(device)
    fsk_errs = phase_fsk_kernels(chains[0], chains[2], device)
    launches.update(phase_fsk_main(chains, device))
    launches["fused_fsk_chain_noisy"] = phase_fsk_noise(chains[0], device)
    times.update(phase_fsk_times(chains, device, card))
    msk = chains[2]
    rs_errs = phase_rs_kernels(msk, device)
    launches.update(phase_rs_main(msk, device))
    launches["fused_msk_slots_noisy"] = phase_rs_noise(msk, device)
    times.update(phase_rs_times(msk, device, card))
    fsk_errs.update(rs_errs)
    errs.update({n: err for n, (err, _) in fsk_errs.items()})
    errs[VIT_REPORT[0]] = phase_viterbi_kernel(device)
    launches[VIT_REPORT[0]] = phase_link_main(device)
    phase_link_cli(device)
    times[VIT_REPORT[0]] = phase_link_times(device, card)
    mode_errs = phase_mode_kernels(chain, device)
    launches.update(phase_passband_main(chain, device))
    launches.update(phase_harness(chain, device, card))
    vit_errs, vit_launches = phase_viterbi_wide(device)
    launches.update(vit_launches)
    times.update(phase_mode_times(chain, device, card))
    fsk_errs.update(mode_errs)
    errs.update({n: err for n, (err, _) in mode_errs.items()})
    errs.update(vit_errs)
    errs[TURBO_NAME] = phase_turbo_kernel(device)
    phase_turbo_main(device)
    errs.update(phase_polar_kernels(device))
    launches.update(phase_fec_links(device, errs))
    phase_fec_cli(device)
    times.update(phase_fec_times(device, card))
    long_errs, long_launches, long_times = phase_long_route(device, card)
    errs.update(long_errs)
    launches.update(long_launches)
    times.update(long_times)
    launches.update(phase_fir_routes(device))

    entries = [(n, src, rep)
               for n, _, _, _, _, _, src, rep in kernel_cases(chain)] + [
        (fir_name(k), "modem_tpu_torch/csrc/fir.cu",
         "modem_tpu/ops/pallas_fir.py:44") for k in FIR_ROUTE_TAPS] + [
        (name, "modem_tpu_torch/csrc/demod.cu",
         "modem_tpu/ops/pallas_demod.py:43")
        for name in DEMOD_NAMES.values()] + [
        (n, "modem_tpu_torch/csrc/fsk.cu", f"modem_tpu/ops/pallas_fsk.py:{line}")
        for n, (line, _) in FSK_REPORT.items()] + [
        (n, src, rep) for n, (_, src, rep) in RS_REPORT.items()] + [
        (VIT_REPORT[0], VIT_REPORT[2], VIT_REPORT[3])] + [
        (n, f"modem_tpu_torch/csrc/{'chain' if kind == 'chain' else 'txrx'}"
            ".cu", rep) for n, kind, _, _, rep in mode_cases()] + [
        (n, VIT_REPORT[2], VIT_REPORT[3]) for n in WIDE_VIT] + [
        (n, src, rep) for n, (_, src, rep) in FEC_REPORT.items()] + \
        long_route_entries()
    report = {"kernels": []}
    for n, src, rep in entries:
        ms, plain_ms, dev_ms, lib_ms, work = times[n]
        bound_ms, bound_by = bound(*work)
        report["kernels"].append({
            "name": n, "route": "cuda", "source": src, "replaces": rep,
            "launches": launches[n], "max_abs_err": errs[n], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib_ms, "device_ms": dev_ms})
        if n in fsk_errs and fsk_errs[n][1] is not None:
            report["kernels"][-1]["agreement"] = fsk_errs[n][1]
    print(json.dumps(report))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
