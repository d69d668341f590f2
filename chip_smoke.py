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
   yardstick (each rail one strided cross-correlation, TF32 off) and K2's
   ``conv_transpose1d`` one (the shaping alone, stride sps); and per
   call of the chain's ``roundtrip_fused``, ``tx_fused`` and ``rx_fused``,
   bits included.

The reference modulate -> demodulate path (``Modulator``, ``Demodulator``,
the two CLIs) runs at the JAX package's demod-bank size (``bench_demod.py``:
256 channels x 32768 samples, ``sample_rate`` 10000, carrier 2000 Hz):

7. FIR and product-detector kernels: K4 on every route (23, 32, 64 and 65
   taps compiled; 7 and 256 generic; 257, 1000 and 4096 the long route's
   core, 15010 its first version, one past the core's last count) and K5
   with its carrier table (2000 Hz at 10000) and without (2001 Hz at 10007)
   against their plain versions, at a small shape with carried state, at
   256 x 32768 and on rows of 1, 5 and 5001 samples, unit-scale inputs, max
   |error| <= 1e-5, the long route also against its first version forced
   (``fir_kernel(..., first=True)``) bit for bit; each in ragged pushes
   equal to one shot exactly;
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
   each count took the route ``ops.fir.fir_route`` and
   ``fir_long_route`` name) and the bound, K4's ``conv1d`` yardstick; on
   the long route the f32 rate as a share of the published 67 TFLOP/s and
   of the card's attained ceiling (one ``torch.mm`` of two 8192 x 8192
   float32 matrices, TF32 off, with the SM clock under it), and at 257 and
   1000 taps the first version forced beside the core; and
   ``Modulator.passband``,
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
    waveforms and means within 1e-5; K6's and K8's long route (den 20000,
    past their cores' cap) and K10's (spb 100) likewise; K6's core against
    its long route bit for bit at the odd cases (``fsk_odd_cases``) and the
    probes that read the mean to a few ulps, its tone table against the
    plain twin within 1e-6, and which kernel 16-MFSK's ``roundtrip_fused``
    with and without noise, BFSK's and the den-20000 chain's run, by the
    profiler; K8's and K10's TX core against their long route bit for bit
    and both against the plain versions at ``tx_odd_cases`` (rows of 1, 3
    and 603, 7 and 130 of them, and 256 x 4096; K8 for 16-MFSK with both
    maps, BFSK and CPFSK, K10 at spb 2, 3, 4 and 8), and which kernel
    ``tx_fused`` runs at den 10000 and 20000, spb 4 and 100;
12. main path: 16-MFSK and BFSK ``FskChain`` (``roundtrip_fused``,
    ``rx_fused(tx_fused)``, the hard bits of ``rx_soft_fused``), MSK
    ``rx_fused(tx_fused)``, GMSK ``roundtrip`` and the DQPSK
    ``DifferentialChain`` (``rx_fused(tx_fused)``, ``roundtrip_fused``)
    give the bits back exactly, and 16-MFSK at den 20000 (K6's long
    route) through ``roundtrip_fused`` and ``rx_fused(tx_fused)``, MSK at
    spb 100 (K10's long route) ``rx_fused(tx_fused)``, each path with every
    launch count set to 0 just before and read just after (the tone table's
    cache cleared before the FSK paths, which make one table for K6 and K8
    together; the den-20000 chain makes none);
13. noise: 16-MFSK ``roundtrip_fused(snr_db=21, seed)`` over 1,048,576
    symbols, SER within 10% of the staged path's (``tx``, seeded Gaussian
    noise of the same sigma, ``rx``);
14. times: K6 (without and with noise, and its long route), K8 and K10
    (and their long routes past the caps, and at the core's inputs beside
    one ``fill_`` of the two planes, the write stream's ceiling), K9 per
    call beside their plain versions, the profiler's device time and the
    bound; K6's tone table kernel, and 0 launches of it over 10
    ``roundtrip_fused`` after the first; and
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
    at 256 x 8192 slots; its long route at spb 100, 256 x 2048), K7's core
    against its long route bit for bit at the odd cases
    (``msk_odd_cases``) and which kernel MSK's ``roundtrip_fused`` with and
    without noise and at spb 100 run, by the profiler; K11 and K12 hard and soft on every route (3/2 and
    its 64-QAM, 2/3: the compiled instantiations; 5/4 and 3/2 with 257 RRC
    taps: the long route) at 3 x 500, 3 x 257 (rows off a 16-byte
    boundary), 2 x 1 and 256 x 4096 symbols: decisions equal (K7 with noise
    on >= 99.99%), waveforms and soft points within 1e-5;
16. main path: config #4's ``roundtrip_fused``, ``rx_fused(tx_fused)`` and
    the hard bits of ``rx_soft_fused`` give the bits back exactly;
    ``tx_fused`` within 1e-5 of the staged ``tx``, ``rx_fused`` equal to
    ``rx``; 64-QAM, 2/3, 5/4 and 3/2 with 257 RRC taps at 64 x 1024;
    ``StreamingResampledChain`` in ragged pushes equal to one shot on 4
    channels; ``MskChain.roundtrip_fused`` gives the bits back exactly,
    at spb 4 and at spb 100 (K7's long route); each path with every launch
    count set to 0 just before and read just after;
17. noise: MSK ``roundtrip_fused(snr_db=7, seed)`` against the staged path
    (``tx``, seeded noise of the same sigma, ``rx``): slot error rates
    (about 1e-2) within 10%; config #4 with seeded channel-rate noise:
    ``rx_fused`` equal to ``rx`` on >= 99.99% of the bits;
18. times: K7 (without and with noise, and its long route), K11, K12
    hard and soft per call
    beside their plain versions (K11 and K12 hard also on the 2/3 and long
    routes), the profiler's device time of the kernel each route runs
    (failing where the profile has none: the C entry sent the shape
    elsewhere), the bound and K12 soft's ``conv1d`` yardstick;
    ``ResampledChain.tx_fused``,
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
    ``release_gates(scale=4)`` with all 5 gates passed (``gates_total``
    5); ``fused_ber_point`` per call in bits/s;
26. (d) K13 at K = 3 (S = 4, the warp route) and K = 15 (S = 16384, the
    block core) through ``decode_soft_windowed``, and a K = 16 code (its
    long route, the first version) at 2 x 100 bits, each with the launch
    counts set to 0 just before and read just after, bit for bit against
    the plain version; at K = 15 the long route forced on the same stream
    (``stream_kernel(..., long_route=True)``) bit for bit against the core;
27. (e) times: each mode's kernel and plain version per call, the
    profiler's device time and the bound; widened K13 per call, per
    trellis step, its share of the bound and its serial floor; at K = 15
    the core and the long route forced in the same run, at 16 and 64
    channels x 1024 bits, each with the bound and the per-row floor (a
    row's f32 operations at one SM's share of the f32 peak: a block a row,
    so no call is shorter).

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
    both also at the link's 1024 codewords;
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
    profiler's device time and the bound; K15 and K16 also at 1024
    codewords, and their serial floors (one codeword's chain of dependent
    operations; K15's over the nodes outside its skipped subtrees); the
    turbo and polar encoders and decoders in Mbit/s; the three presets'
    (``nr_like_control_link`` with CA-SCL-8 at 3 dB and with SC at 5 dB)
    ``frame``, ``tx_fused`` and ``rx_fused`` per call at 256 frames with
    the device's busy time and idle share.

The long route of K1, K2 and K3, for chains past the short route's 256
taps or 64 samples a symbol:

34. ``PulseShapedChain(QPSK)`` at sps 8 and span 32 (257 taps), sps 20
    and span 16 (321 taps), sps 96 and span 1, 256 x 1024 symbols:
    ``roundtrip_fused``, ``rx_fused(tx_fused)`` and ``rx_soft_fused`` give
    the bits back with K1, K2, K3 hard and K3 soft launched (counts set to
    0 just before, read just after); each kernel against its plain version
    (decisions bit for bit, waveforms and soft points within 1e-5) and its
    times, K2's from the profile of the long route's kernel.

K4's generic and long routes and K5 without its carrier table, through the
demodulator a user builds with other filters or another carrier:

35. ``Demodulator(2000, 10000, hilbert=<7 taps>, lowpass=<256 taps>)``:
    ``lock_phase`` (K4 generic, 7 taps) and ``demodulate`` (K4 generic, 256
    taps); ``lowpass`` of 257, 1000 and 4096 taps: ``demodulate`` (the
    long route's core), and of 15010 (its first version, past the core's
    last count); ``Demodulator(2001, 10007)``: ``lock_phase`` and
    ``demodulate_fused`` (K5 without a table) against ``demodulate``; each at
    256 x 32768 with the launch counts set to 0 just before and read just
    after, and the card against the CPU on two channels.

K2's two routes:

36. the short route (sps 8, span 8) against the long route (the first
    version's body, ``_tx_launch(..., host=None)``) bit for bit, both
    against the plain version within phase 23's bars, and the kernel each
    call ran by the profiler: every K2 mode and 1999 Hz (past the carrier
    table) at a sym_offset near 10^9, at 256 x 4096; K = 1, 31 and 257
    at sps 8, and sps 2, 4 and 16 (the long route both ways) in f32, bf16,
    int16 and at 1700 and 1999 Hz; then ``StreamingFusedTx`` in 5 ragged
    pushes and its flush equal to one ``tx_fused`` (sps 4 in f32 and
    int16, sps 16 at 1700 Hz); a push of the flagship's stream and the
    links' ``tx_fused`` run the short route. Phases 6 and 27 fail too
    where a K2 call of the flagship's shape runs any other kernel.

The LDPC-coded OFDM link (``QcLdpc`` at ``bench_fec.py:221``'s 4096
codewords, ``OfdmModem`` at ``bench_ofdm.py``'s 256 channels x 64 symbols
with max_lag 96, ``wifi_like_ofdm_link()`` at ``bench_link.py``'s 256
frames):

37. ``QcLdpc().decode`` at 4.5 dB, 20 iterations, layered (float32 and
    bf16 messages, with and without early exit) and flooding: posteriors
    and decisions on the card equal the CPU twin's bit for bit;
38. blind ``OfdmModem(qpsk).acquire`` and ``acquire_soft`` on a capture
    of ``tx_frame`` at per-channel offsets in [0, 96), a phase, a CFO of
    0.3 subcarriers and AWGN at 30 dB: every start and bit right, K4 at
    240 taps (its generic route, the reversed preamble as taps) launched
    (counts set to 0 just before, read just after) and held against its
    plain version on the capture; ``burst_ofdm_receiver`` over a stream of
    4 wifi frames with gaps of noise, pushed in chunks of 3000 samples:
    every frame found and its payload decoded, K4 launched;
39. ``wifi_like_ofdm_link()``: ``tx`` -> AWGN at 8 dB -> ``rx`` and
    ``tx_fused`` -> ``rx_fused``, every payload exact and every CRC true,
    the decode equal to the CPU twin's; the ``link`` CLI pair with
    ``--preset wifi_like_ofdm`` on the card for 4 frames;
40. times: K4 at 240 taps per call beside its plain version, the
    profiler's device time, the bound and its ``conv1d`` yardstick; wall
    time, device busy time, idle share and CUDA launches per call of
    ``wifi_like_ofdm_link().tx`` and ``rx``, ``QcLdpc.decode`` (4096
    codewords, 20 layered iterations), ``OfdmModem.acquire`` and one
    ``OfdmStreamReceiver.push``.

Blind single-carrier burst acquisition (``AcquiringReceiver`` over the
flagship chain at ``bench_sync.py``'s block: 64 channels x 512 payload
symbols, the 32-symbol preamble, max_lag 160) and BCH at
``bench_fec.py:358-376``'s 2048 codewords:

41. K4 at the acquisition's tap counts, its generic route: the mild
    multipath channel's 4 taps, the 3-ray channel's 13 and
    ``apply_static_delay``'s 63, against the plain version at the
    capture's shape (64 x 4416), at 3 x 5000 with carried state and on rows
    of 1, 5 and 5001 samples, unit-scale inputs, max |error| <= 1e-5;
    ragged pushes equal one shot exactly;
42. ``tx_burst`` (K4 at 65 taps), bench_sync's impairment stack (a delay
    of 0.37: K4 at 63 taps; 9 Hz with phase 1.3, gain 0.8, AWGN at 30 dB
    from a ``torch.Generator``) and ``rx`` (K4 at 65 taps), each with the
    launch counts set to 0 just before and read just after: every payload
    bit right; ``acquire`` on the card against the CPU twin on the same
    capture (lag equal, timing within 1e-3 samples circular, CFO within
    1e-5 rad/symbol, phase within 1e-4, gain within 1e-4 relative, the
    payload points within 1e-4); the mild multipath (K4 at 4 taps), the
    3-ray channel at 35 dB with ``eq_taps=7, track_block=16`` (K4 at 13
    taps) and ``track_block=16, track_order=2`` under a 6 Hz residual CFO:
    every bit right;
43. ``sfo_track(block_len=4096, max_delay=32)`` on a 300 ppm capture of a
    4096-symbol payload (gain 0.8, phase 0.4, 30 dB) at 64 channels, then
    ``rx``: every bit right where the one-shot receiver fails, the block
    timings within 1e-3 of the CPU twin's; ``phase_track`` at 8e-4
    rad/symbol; ``Agc.process`` in 4 ragged pushes equal to one shot;
44. ``bch_255_191`` and ``bch_255_239``: ``encode``, then ``decode`` with
    4 (2) errors a codeword, every message right and every ``ok`` true;
    with t + 1 errors the card decodes as the CPU twin bit for bit;
    BCH(255, 191) over the flagship chain at -2 dB: every codeword within t
    raw errors decoded with ``ok``, all of it equal to the CPU twin;
45. times: K4 at 4, 13 and 63 taps at the capture's shape (and at 65, the
    matched filter's, at 64 x 4505) per call beside its plain version, the
    profiler's device time, the bound and its ``conv1d`` yardstick (per
    call and its device time); wall time, device busy time, idle share and CUDA
    launches per call of ``AcquiringReceiver.rx`` at 64 and 256 channels,
    ``acquire`` with ``eq_taps=7, track_block=16``, ``sfo_track`` on the
    4096-symbol capture, and ``Bch.encode`` and ``decode`` (Mbit/s of info
    bits) at 2048 codewords.

SC-FDE, Alamouti STBC, MIMO and bit loading at ``bench_scfde.py``'s 256
channels (phases 46-49 under PyTorch's default math settings, which keep
TF32 off for matmuls):

46. ``ScFdeModem(qpsk)`` (n 64, cp 16, 64 blocks a frame): ``tx_frame``,
    tests/test_scfde.py's deep-null channel (K4 at 4 taps) and AWGN at 30
    dB from a ``torch.Generator``, ``rx_frame`` and ``rx_soft_frame``: every
    bit right, decision points and LLRs within 1e-4 of the CPU twin's;
    blind ``acquire`` at max_lag 128 under per-channel offsets, a gain of
    1.3, phases, a CFO of 0.3/sym_len cycles/sample and AWGN at 40 dB
    (SC-FDE tracks no residual CFO over its 5280-sample frame): every start
    and bit right, K4 at 160 taps (its generic route) launched 4 times
    (counts set to 0 just before, read just after) and held against its
    plain version on the capture (within 1e-6 of the output's largest
    magnitude: the correlation peaks near 200); ``OfdmStreamReceiver`` over
    4 SC-FDE frames with gaps of noise, in chunks of 3000 samples: every
    frame found and decoded;
47. the conv-coded ``FramedLink`` over ``ScFdeChain`` at 1002 payload bits
    (1024 trellis steps, windows of 512 set explicitly), 256 frames
    through the deep-null channel at 10 dB: every payload and CRC, K13's
    warp route launched and bit for bit with its plain version on the
    run's LLRs;
48. ``AlamoutiOfdm(qpsk)`` at 256 x 32 pairs through test_stbc.py's two
    dispersive channels at 30 dB, every bit right; its LDPC-framed link (26
    codewords in 81 pairs) at 256 frames and 14 dB, every payload and CRC;
    ``mimo_ofdm_link()`` at 256 frames through test_presets.py's
    cross-coupled flat 2x2 channel at 16 dB, every payload and CRC, and at
    its 12 dB (where the JAX preset loses frames too) the decode equal to
    the CPU twin's; ``MimoOfdmN(nt=4)`` at 256 x 16 slots through
    test_mimo_n.py's random 4x4 channels: ZF noiseless (QPSK) and MMSE at
    45 dB (16-QAM) exact, each one's decision points within 1e-4 of the CPU
    twin's, MMSE at 30 dB (QPSK) too; ``_cinv_h`` on the card at 256 x 52
    4x4 matrices against float64 ``np.linalg.inv`` (rtol 2e-3, atol 2e-4);
49. ``bit_loading`` from test_bitloading.py's selective channel at a 30 dB
    floor (gap 12 dB, at most 6 bits); ``AdaptiveOfdm`` at 256 x 64 symbols
    through that channel at 30 dB, every bit right; the conv-coded
    ``FramedLink`` over it (at least 1024 trellis steps) at 256 frames and
    20 dB: every payload and CRC, K13 launched and held to its plain
    version;
50. times: K4 at 160 taps per call beside its plain version, the
    profiler's device time, the bound and its ``conv1d`` yardstick (TF32
    off); wall time, device busy time, idle share and CUDA launches per
    call of ``ScFdeModem.rx_frame`` and ``acquire``, ``AlamoutiOfdm.rx``,
    ``MimoOfdm.rx_frame``, ``MimoOfdmN.rx_frame`` at 4x4,
    ``AdaptiveOfdm.rx_frame`` and ``mimo_ofdm_link().rx``;
51. the wideband front end under PyTorch's default math settings (as 46-49,
    through 55): ``Channelizer`` at M 256, a batch of 4 x 4096
    channel-rate samples: both banks against the CPU twin, in 4 pushes
    equal to one shot bit for bit, the bf16 DFT (float32 outputs, its
    floor against f32, every bit of 256 bursts through both bf16 banks),
    5 tones each 40 dB above every other channel;
52. ``DsssChain`` at 256 ch x 512 QPSK symbols, L 16: every bit right, K4's
    launches counted (2 each way), 4 channels against the CPU twin; at -4
    dB chip SNR and under a 10x CW jammer at L 32, every bit right;
53. ``FhssModem``, 16 links over 64 channels, 64 dwells of 32 symbols on a
    seeded permutation: every bit, K4's launches (2 each way); a 10x
    jammer's dwell loses bits, the other 63 exact; hybrid DS/FH;
54. ``WidebandModem`` at M 256 x 512 payload symbols: every bit, K4's
    launches (2 each way); through tests/test_wideband.py's front end held
    to the CPU twin (the preamble's CFO estimate drifts a few channels past
    a boundary over 512 symbols, for the JAX receiver too), every bit with
    ``track_block=16`` and at 96 symbols;
55. times: wall, device busy, idle share and CUDA launches per call of each
    new entry point, the DFT GEMMs' share of the busy time, and
    ``profiling.measure``/``measure_marginal`` beside CUDA events.

The multi-device layer (``modem_tpu_torch.parallel``, ``debug``,
``LinkStats.psum``, ``WidebandModem(mesh=)``), each sharded entry point at
full width against the single-device port on the same global input: the
flagship (256 ch x 4096 sym; staged, fused, one-way pair, noisy BER,
passband, DQPSK), 16-MFSK (baseband and the K6 loopback), the FIR and
demodulator on a 256 x 32768 stream, config #4 at 3/2, the slab Viterbi
(64 ch x 1024 bits) and K13 over the channels (256 x 4096), acquisition
(64 x 512), OFDM (256 x 64, max_lag 96), the channelizer and
``WidebandModem`` at M 256 over a 1x4 mesh (the rest 2x2), ``LinkStats.psum``
and ``halo_mismatch`` on a K4 overlap-save:

56. a world of one over NCCL on the card (``initialize_multihost``, a 1x1
    mesh; one NCCL ``all_reduce``): every sharded call equal to the
    single-device call bit for bit, waveforms included, the noisy BER's
    errors equal to K1's on the rank's layout; K1-K4, K6, K11-K13 each
    launched by the sharded calls; then per-call wall, device busy, idle
    share and CUDA launches of the sharded fused and staged roundtrips
    against ``roundtrip_fused`` and ``roundtrip``;
57. four ranks on the one card: four ``spawn`` processes over a gloo group
    (NCCL refuses two ranks of one device; CUDA tensors staged through the
    host), each making the global input from the seed, running the
    single-device call on the card and its own sharded call, holding its
    block (decisions bit for bit, waveforms within 1e-5 of the largest
    value; mismatches summed and differences maxed over the ranks), each
    rank's launches of K1-K4, K6, K11-K13 read (every rank, those with t >
    0 among them, launching each); the sharded QPSK BER at 7 dB within 10%
    of the closed form;
58. times: the per-rank wall of the sharded fused roundtrip, four ranks
    sharing one card (not a scaling number).

Then ``fir_filter``'s backends and the launch path every kernel shares:

59. the ``conv``, ``matmul`` and ``fft`` backends through every entry point
    that takes ``fir_backend=``, held to K4 with TF32 off and on, and their
    times;
60. each C entry through its wrapper at 4 x 64 and at 256 x 4096 symbols
    makes no runtime query after its first launch (``cuda.host_queries``:
    over 100 launches of K4, 20 of each other), with its host microseconds
    and CUDA-event milliseconds a call; K4 beside ``fir_filter(...,
    backend="conv")`` at the acquisition's and the OFDM timing's shapes.

Then a JSON line of the kernels (K1, K2, K3 hard and soft, K4 with the
demodulator's 64-tap lowpass, the chain's 65-tap RRC, each other count of
phase 7, the OFDM preamble's 240 taps, the acquisition's 4, 13 and 63
and SC-FDE's 160, and the long route's first version
(``fir_filter_long_first``: its times forced at 1000 taps, its launches
phase 35's demodulator at 15010 taps),
K5 with and without its carrier table; K6
without and with noise, with ``agreement``, the share of its decisions
equal to the plain version's; K8; K9 on the FSK symbol and the MSK slot;
K10; K7 without and with noise, with ``agreement``; K11 and K12 hard on
each route (3/2, 2/3, long), K12 soft; K13; each mode of K1-K3, K1 with
noise with ``agreement``; K13 at K = 3 and 15 (the block core) and its long
route (``viterbi_k15_long``: its times at K = 15 forced, its launches
phase 26's K = 16 decode's); K14, K15, K16; K1, K2, K3
hard and K3 soft on each long-route chain), each with its launches on its path
(K1-K4, K6, K11-K13 also ``sharded_launches``, those of phase 56's sharded
calls), error, per-call times (``ms`` from CUDA
events, ``device_ms`` from the profiler), the least time the card could
take (``bound_ms``: the larger of the bytes it must move at 3.35 TB/s and
its f32 operations at 67 TFLOP/s, the H100 SXM's published peaks at 700 W;
``bound_by`` says which), ``share`` (``bound_ms`` over ``device_ms``) and
the time of one PyTorch call computing the same function where there is
one (``library_ms``, else null; K2's ``conv_transpose1d`` times the
shaping only); then the
card's name and power limit, and last ``{"ok": true, "device": {...}}``.
Any failure exits non-zero before that line; without a CUDA device it
exits non-zero at once.
"""

from __future__ import annotations

import functools
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
#: generic instantiation), 257, 1000 and 4096 (the long route's core) and
#: FIR_FIRST_TAPS, one past the core's last count (the long route's first
#: version, ``ops.fir.FIR_CORE_MAX_TAPS + 1``: phase 7 checks it)
FIR_FIRST_TAPS = 15010
FIR_ROUTE_TAPS = (23, 32, 64, 65, 7, 256, 257, 1000, 4096, FIR_FIRST_TAPS)
#: the report entry of the long route's first version: its times forced at
#: FIR_FIRST_AT taps, its launches those of the path at FIR_FIRST_TAPS
FIR_FIRST = "fir_filter_long_first"
FIR_FIRST_AT = 1000
#: the attained f32 ceiling: one torch.mm of two square float32 matrices of
#: this size, TF32 off
MM_CEILING_N = 8192
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
#: K6's and K7's odd shapes: two 128-lane keys of the noise stream; rows
#: not a whole number of runs, most of them off a 16-byte boundary
FSK_ODD = ((130, 600), (7, 603))
FSK_ODD_SPS = (2, 8, 16)
MSK_ODD_SPB = (2, 4, 8)
FSK_ODD_SNR_DB = 12.0            # noisy odd shapes: errors at every sps
#: past the cores' caps (the long route): 16-MFSK at this sample rate (den
#: 20000, sps 8); MSK at this baud (spb 100) over 256 x MSK_FAR_SLOTS slots
FSK_FAR_SR = 20000
MSK_FAR_BAUD = 50
MSK_FAR_SLOTS = 2048
TONE_ATOL = 1e-6                 # K6's tone table against its plain twin
#: profiler name (of the kernel the route runs) and replaced TPU kernel of
#: each config #3 report entry
FSK_REPORT = {
    "fused_fsk_chain": ("63", "fsk_chain_core"),
    "fused_fsk_chain_noisy": ("63", "fsk_chain_core"),
    "fused_fsk_chain_long": ("63", "fsk_chain_kernel"),
    "fsk_tone_table": ("63", "fsk_tone_kernel"),
    "fused_fsk_tx": ("460", "fsk_tx_core"),
    "fused_fsk_tx_long": ("460", "fsk_tx_kernel"),
    "fused_discriminator_means": ("545", "disc_means_kernel"),
    "fused_discriminator_means_msk": ("545", "disc_means_kernel"),
    "fused_msk_tx": ("621", "msk_tx_core"),
    "fused_msk_tx_long": ("621", "msk_tx_kernel"),
}
#: K8's and K10's odd shapes in phase 11 (channels, symbols or slots):
#: rows of 1, 3 and 603 (at spb 2 and 3 most off a 16-byte boundary), 7
#: and 130 of them; and the spb K10's core is held at
FSK_TX_ODD = ((7, 1), (7, 3), (7, 603), (130, 1), (130, 3), (130, 603))
FSK_TX_SPB = (2, 3, 4, 8)
# config #4 at bench_rows.py:65's row, and the MSK loopback
RS_UP, RS_DOWN = 3, 2
RS_SIDE = (64, 1024)             # 64-QAM and 2/3 in phase 16
RS_STREAM_CHANNELS = 4
RS_STREAM_CUTS = (7, 1, 1000, 2000)  # ragged pushes, then the rest
RS_NOISE_SNR_DB = 5.0            # per channel sample: 16-QAM BER ~3e-3
RS_AGREE = 0.9999
#: K11's and K12's routes (csrc/resampled.cu's C entries choose them):
#: report suffix -> (up, down, RRC span, the profiler names, spaces dropped,
#: of the K11 and K12 kernels the route runs, K12's with {} for its mode).
#: Config #4's 3/2 and 2/3 the core's compiled instantiations, 257 RRC taps
#: (span 32) the long route
RS_ROUTES = {
    "": (3, 2, 8, "resampled_tx_core<8,65,3,2,17>",
         "resampled_rx_core<{},1,12,112>"),
    "_2_3": (2, 3, 8, "resampled_tx_core<8,65,2,3,17>",
             "resampled_rx_core<{},3,16,71>"),
    "_long": (3, 2, 32, "resampled_tx_kernel", "resampled_rx_kernel<{}>"),
}
RS_EDGES = ((3, 257), (2, 1))    # tile edges beside SMALL: odd rows, one symbol
MSK_SMALL = (130, 600)
MSK_SNR_DB = 7.0                 # per complex sample: slot SER ~9e-3
MSK_SER_RTOL = 0.10
#: profiler name (K11's and K12's: ``rs_symbol``), source and replaced TPU
#: kernel of each config #4 and MSK loopback report entry
RS_REPORT = {
    "fused_msk_slots": ("msk_chain_core", "modem_tpu_torch/csrc/fsk.cu",
                        "modem_tpu/ops/pallas_fsk.py:313"),
    "fused_msk_slots_noisy": ("msk_chain_core",
                              "modem_tpu_torch/csrc/fsk.cu",
                              "modem_tpu/ops/pallas_fsk.py:313"),
    "fused_msk_slots_long": ("msk_chain_kernel",
                             "modem_tpu_torch/csrc/fsk.cu",
                             "modem_tpu/ops/pallas_fsk.py:313"),
    **{f"fused_resampled_{d}{suffix}": (
        None, "modem_tpu_torch/csrc/resampled.cu",
        f"modem_tpu/ops/pallas_resampled.py:{111 if d == 'tx' else 235}")
       for suffix in RS_ROUTES for d in ("tx", "rx")},
    "fused_resampled_rx_soft": (None, "modem_tpu_torch/csrc/resampled.cu",
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
#: K = 15 over the whole card (320 rows on 132 SMs), and the long route's
#: own shape: a K = 16 code (S = 32768, metrics past shared memory)
WIDE_VIT_FULL = (64, 1024)
VIT_LONG = ((16, (0o172675, 0o137323)), (2, 100), 32)
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
#: K15's decision at an information leaf (a compare), in dependent f32
#: operations; its f's and g's are K16's
K15_LEAF_OPS = 1
#: K2's odd shapes in phase 36: (sps, span, K), sps 8 span 8 the short
#: route's, sps 2, 4 and 16 (rows off a 16-byte boundary among them) the
#: long route's
TX_ODD = ((8, 8, 1), (8, 8, 31), (8, 8, 257), (2, 10, 31), (2, 10, 1),
          (4, 6, 257), (4, 5, 31), (16, 4, 31), (16, 4, 257))
#: phase 36's sym_offset on a carrier of more phases than the table holds
TX_FAR_OFFSET = 987654321
#: K1's and K3's long route: (Rates, span) past 256 taps or 64 samples a
#: symbol (sps 8 span 32, sps 20 span 16, sps 96 span 1, and the reference
#: CLI's rates, 220 baud at 10 kHz: sps 45, span 8), on the long core, at
#: 256 x LONG_SYMBOLS and at the flagship's 256 x 4096 symbols
LONG_ROUTE = ((1250, 10000, 32), (500, 10000, 16), (100, 9600, 1),
              (220, 10000, 8))
LONG_SYMBOLS = 1024
LONG_SIZES = (LONG_SYMBOLS, 4096)
#: a chain past the core's shared memory (sps 256, span 1), which the
#: host's rule sends to the first version: entries of its own at 256 x
#: LONG_SYMBOLS
LONG_FIRST_ROUTE = (100, 25600, 1)
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
# the LDPC-coded OFDM link: bench_fec.py:221's 4096 codewords, bench_ofdm.py's
# block (256 channels x 64 symbols, max_lag 96), bench_link.py's 256 frames
LDPC_CW = 4096
LDPC_EBN0_DB = 4.5
LDPC_ITERS = 20
LDPC_VARIANTS = {
    "layered f32": {}, "layered bf16": {"msg_dtype": torch.bfloat16},
    "layered f32 early exit": {"early_exit": True},
    "layered bf16 early exit": {"msg_dtype": torch.bfloat16,
                                "early_exit": True},
    "flooding": {"schedule": "flooding"}}
OFDM_SYMBOLS = 64
OFDM_MAX_LAG = 96
OFDM_SNR_DB = 30.0
OFDM_FIR = "fir_filter_240"      # K4 at the preamble's 240 taps
BURST_FRAMES = 4
BURST_CHUNK = 3000
WIFI_FRAMES = 256
WIFI_SNR_DB = 8.0
WIFI_CLI_FRAMES = 4
# blind single-carrier burst acquisition at bench_sync.py:42-50,63-68's block
# (64 channels x 512 payload symbols, the 32-symbol preamble, max_lag 160,
# a delay of 0.37, 9 Hz with phase 1.3, gain 0.8, 30 dB) and BCH at
# bench_fec.py:358-376's 2048 codewords with 4 errors each
ACQ_CHANNELS, ACQ_PAYLOAD, ACQ_WIDE = 64, 512, 256
ACQ_PRE = (0, 1, 3, 2, 2, 0, 1, 1, 3, 0, 2, 3, 0, 0, 1, 2,
           3, 3, 1, 0, 2, 1, 0, 2, 1, 3, 2, 2, 0, 3, 1, 0)
ACQ_MAX_LAG = 160
ACQ_MU, ACQ_CFO_HZ, ACQ_PHASE, ACQ_GAIN, ACQ_SNR_DB = 0.37, 9.0, 1.3, 0.8, 30.0
#: the multipath channels of tests/test_sync.py:191-192 (4 taps) and
#: :214-215 (13 taps): K4's generic route, with apply_static_delay's 63
ACQ_MILD = ((1.0, 0.0, 0.0, 0.1), (0.0, 0.0, 0.0, 0.05))
ACQ_3RAY = ((1, 0, 0, 0, 0.3, 0, 0, 0, 0, 0, 0, 0, 0.45),
            (0, 0, 0, 0, -0.2, 0, 0, 0, 0, 0, 0, 0, 0.25))
ACQ_FIR_TAPS = (4, 13, 63)
ACQ_ATOL_POINTS = 1e-4           # the card's payload points against the CPU's
SFO_PAYLOAD, SFO_PPM = 4096, 300.0
BCH_CW, BCH_ERRS = 2048, 4
BCH_CHAIN_SNR_DB = -2.0
# SC-FDE, Alamouti STBC, MIMO and bit loading at bench_scfde.py's 256
# channels (QPSK, n 64, cp 16, 64 blocks a frame; the deep-null channel of
# tests/test_scfde.py, the channel pairs of test_stbc.py, test_mimo_n.py's
# random 4x4 and test_bitloading.py's selective channel)
SCFDE_BLOCKS, SCFDE_MAX_LAG, SCFDE_SNR_DB = 64, 128, 30.0
# SC-FDE tracks no residual CFO: over a frame of 5280 samples the blind
# estimate must hold to about 1e-5 rad/sample, so the acquisition runs at
# 40 dB on a flat channel (at 30 dB through the deep-null channel the
# estimate's bias and noise turn the last blocks by up to a radian)
SCFDE_ACQ_SNR_DB = 40.0
SCFDE_FIR = "fir_filter_160"     # K4 at the CP'd training blocks' 160 taps
SCFDE_FIR_RTOL = 1e-6            # of the correlation's largest magnitude
SCFDE_CH = ((1.0, 0.0, 0.0, -0.85), (0.0, 0.25, 0.0, 0.1))
SCFDE_CFO = 0.3 / 80             # cycles/sample, inside +-0.5/sym_len
SCFDE_STREAM_FRAMES, SCFDE_STREAM_CHUNK = 4, 3000
CONV_LINK_PAYLOAD = 1002         # 1024 trellis steps: K13's windowed route
SCFDE_LINK_FRAMES, SCFDE_LINK_SNR_DB = 256, 10.0
STBC_PAIRS, STBC_SNR_DB, STBC_LINK_SNR_DB = 32, 30.0, 14.0
STBC_CH_A = ((0.9, 0.0, 0.25, 0.0, -0.1), (0.1, -0.3, 0.0, 0.12, 0.05))
STBC_CH_B = ((0.8, 0.3, 0.0, -0.15, 0.0), (0.0, 0.1, -0.25, 0.0, 0.1))
# mimo_ofdm_link() at 256 frames: at test_presets.py's 12 dB the JAX preset
# and the port both lose frames (7 of 16 in a CPU run, the same ones), so
# there the card is held to the CPU twin; every frame decodes at 16 dB
MIMO_FRAMES, MIMO_SNR_DB, MIMO_EXACT_SNR_DB = 256, 12.0, 16.0
MIMO_FLAT = ((1.0, 0.3, 0.6, -1.2), (0.5, 2.0, 0.9, 0.8))
MIMON_NT, MIMON_SYMBOLS, MIMON_SNR_DB = 4, 16, 30.0
# 16-QAM through test_mimo_n.py's random 4x4 channel (seed 1) at its 45 dB
# is exact; QPSK at 30 dB is not, for the JAX detector either (50 of 53248
# bits wrong at 8 channels on the CPU: the worst bins' noise enhancement),
# so there the card is held to the CPU twin's decision points
MIMON_EXACT_SNR_DB = 45.0
LOAD_SYMBOLS, LOAD_FLOOR_DB, LOAD_GAP_DB, LOAD_MAX_BITS = 64, 30.0, 12.0, 6
LOAD_CH = ((0.75, 0.0, 0.0, 0.55, 0.0, 0.0, 0.3),
           (0.0, 0.3, 0.0, 0.0, -0.35, 0.0, 0.0))
LOAD_LINK_FRAMES, LOAD_LINK_SNR_DB = 256, 20.0
# the wideband front end: the channelizer at bench_channelizer.py's block
# (M 256, 4096 channel-rate samples, a batch of 4: 1,048,576 wideband
# samples a row), DSSS at 256 channels x 512 QPSK symbols (L 16; the CW
# jammer of tests/test_dsss.py at L 32), FHSS at 16 links over 64 channels
# (64 dwells on a seeded permutation, 32 QPSK symbols a dwell), and
# WidebandModem at M 256 with tests/test_wideband.py's front end
WB_M, WB_K, WB_BATCH, WB_PUSHES = 256, 4096, 4, 4
WB_TONE_CH, WB_TONE_K = (0, 1, 100, 128, 255), 512
WB_TWIN_RTOL = 1e-4              # of the largest output, card vs CPU twin
WB_BF16_SNR_DB = 35.0            # bf16 DFT against f32: the floor it keeps
DS_CHANNELS, DS_SYMBOLS, DS_L, DS_JAM_L, DS_SNR_DB = 256, 512, 16, 32, -4.0
DS_TWIN = 4                      # channels held against the CPU twin
FH_LINKS, FH_M, FH_DWELLS, FH_SYMBOLS, FH_JAM_CH = 16, 64, 64, 32, 5
FH_DS_L, FH_DS_DWELLS, FH_DS_SYMBOLS = 8, 16, 16
WB_PAYLOAD, WB_MAX_LAG = 512, 200
WB_CFO_HZ, WB_PHASE, WB_GAIN, WB_SNR_DB = 3.0, 0.4, 0.9, 28.0
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

    for k in (chain_kernel.CHAIN_KERNEL, chain_kernel.CHAIN_FIRST_KERNEL,
              txrx.TX_KERNEL, txrx.RX_HARD_KERNEL, txrx.RX_SOFT_KERNEL,
              txrx.RX_HARD_FIRST_KERNEL, txrx.RX_SOFT_FIRST_KERNEL,
              fir.FIR_KERNEL, fir.FIR_FIRST_KERNEL,
              demod_kernel.DEMOD_KERNEL,
              fk.FSK_CHAIN_KERNEL, fk.FSK_TONE_KERNEL, fk.FSK_TX_KERNEL,
              fk.DISC_MEANS_KERNEL, fk.MSK_TX_KERNEL, fk.MSK_CHAIN_KERNEL,
              rk.RESAMPLED_TX_KERNEL,
              rk.RESAMPLED_RX_KERNEL, vk.VITERBI_KERNEL,
              vk.VITERBI_BLOCK_KERNEL, vk.VITERBI_CORE_KERNEL,
              bcjr_kernel.BCJR_KERNEL,
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
    contains ``symbol``, from ``torch.profiler``; None if five profiles
    hold none (profiled again only where one lost every record of it, as
    a profile now and then does; each begins on an idle device)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(5):
        torch.cuda.synchronize(device)
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
                "fused_tx": "pulse_tx_core",
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


def tx_conv_yardstick(args):
    """K2's shaping at baseband as ``conv_transpose1d``: the mapped points
    of both rails as ``[2*C, 1, K + span]`` (``span`` zero flush points),
    the taps as the weight, ``stride=sps``; the first ``(K + span)*sps``
    outputs are K2's ``w[n] = sum_m z[m] taps[n - m*sps]``. The map is left
    out: the yardstick times the shaping only. Returns ``(fn, fn args, max
    |error| against the kernel)``; the port never calls it."""
    import torch.nn.functional as F
    from modem_tpu_torch.ops import txrx

    syms, lut, taps, sps, span = args[:5]
    c, k = syms.shape
    n = (k + span) * sps
    zi, zq = txrx.map_plain(syms, lut)
    z = torch.cat([torch.stack([zi, zq]).reshape(2 * c, 1, k),
                   torch.zeros((2 * c, 1, span), device=syms.device)], -1)
    w = taps.reshape(1, 1, -1)

    def shape(z, w):
        return F.conv_transpose1d(z, w, stride=sps)[..., :n]

    got = shape(z, w).reshape(2, c, n)
    err = max_err((got[0], got[1]), txrx.tx_kernel(*args))
    return shape, (z, w), err


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
        if name == "fused_tx":
            tx_route_check("the flagship's K2", kern, args, device)
        lib_ms, lib_txt = None, "no library call"
        if name in ("fused_rx_soft", "fused_tx"):
            soft = name == "fused_rx_soft"
            what, lib = (("conv1d", "K3 soft") if soft else
                         ("conv_transpose1d (shaping only)", "K2"))
            fn, fargs, lib_err = (rx_conv1d_yardstick if soft else
                                  tx_conv_yardstick)(args)
            if lib_err > 1e-4:
                fail(f"{what} yardstick disagrees with {lib} ({lib_err})")
            lib_ms = time_calls(fn, fargs, device)
            lib_dev = device_busy_ms(fn, fargs, device)
            lib_txt = (f"{what} {lib_ms:.4f} ms, device busy {lib_dev:.4f} "
                       f"ms (max |err| vs {lib} {lib_err:.2e})")
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

    route = fir.fir_route(k)
    if route == "long":
        return {"core": "fir_long_core",
                "first": "fir_long_kernel"}[fir.fir_long_route(k)]
    return {"fixed": f"fir_core_kernel<{k}>",
            "generic": "fir_core_kernel<0>"}[route]


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

    if FIR_FIRST_TAPS != fir.FIR_CORE_MAX_TAPS + 1 or \
            fir.fir_long_route(FIR_FIRST_TAPS) != "first":
        fail(f"FIR_FIRST_TAPS {FIR_FIRST_TAPS} is not one past the long "
             f"core's last count {fir.FIR_CORE_MAX_TAPS}")
    for k in FIR_ROUTE_TAPS:
        what = f"fir_filter {k} taps ({fir_symbol(k)})"
        for shape in ((3, 5000), (CHANNELS, REF_SAMPLES), *FIR_ROWS):
            args = fir_case(taps[k], shape, gen, device)
            got, want = fir.fir_kernel(*args), fir.fir_plain(*args)
            check(fir_name(k), what, shape, got, want)
            if fir.fir_route(k) == "long":
                # the long route against its first version forced: bit for
                # bit (one fmaf chain an output in the same order)
                first = fir.fir_kernel(*args, first=True)
                check(FIR_FIRST, f"fir first version {k} taps", shape, first,
                      want)
                if not torch.equal(got, first):
                    fail(f"K4 at {k} taps on {shape}: the long route differs "
                         "from its first version")
                print(f"[kernels] fir_filter {k} taps == its first version "
                      f"at {shape} (exact)", flush=True)
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
    ceiling = f32_ceiling(device, card)
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
            plain_calls=20 if k <= 65 else 2 if k <= 1000 else 1)
        if dev_ms is None:
            fail(f"K4 at {k} taps: no {fir_symbol(k)} in the profile (the "
                 f"route fir_route names)")
        lib_ms = time_calls(F.conv1d, (xp, w), device,
                            calls=20 if k <= 1000 else 2)
        work = (4 * (2 * CHANNELS * n + CHANNELS * (k - 1) + k),
                2 * k * CHANNELS * n)
        times[name] = (ms, plain_ms, dev_ms, lib_ms, work)
        print_times(f"{name} ({k} taps, {fir_symbol(k)})", CHANNELS * n,
                    times[name], card,
                    f"conv1d {lib_ms:.4f} ms (max |err| vs K4 {lib_err:.2e})")
        if fir.fir_route(k) != "long":
            continue
        print_shares(name, work[1], dev_ms, ceiling, card)
        if k in (257, FIR_FIRST_AT):
            # the first version forced at the same inputs, beside the core
            first = functools.partial(fir.fir_kernel, first=True)
            f_ms = (time_calls(first, args, device) +
                    time_calls(first, args, device)) / 2
            f_dev = kernel_device_ms(first, args, device, "fir_long_kernel")
            if f_dev is None:
                fail(f"K4 forced to its first version at {k} taps: no "
                     "fir_long_kernel in the profile")
            if k == FIR_FIRST_AT:
                times[FIR_FIRST] = (f_ms, plain_ms, f_dev, lib_ms, work)
            print(f"[times] {name} first version (fir_long_kernel) per call "
                  f"{f_ms:.4f} ms, alone in the profiler {f_dev:.4f} ms; the "
                  f"core {dev_ms:.4f} ms ({f_dev / dev_ms:.2f}x); conv1d "
                  f"{lib_ms:.4f} ms; on {card}", flush=True)
            print_shares(f"{name} first version", work[1], f_dev, ceiling,
                         card)

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


def far_chains(device):
    """The chains past K6's and K7's core caps (the long route): 16-MFSK
    at ``Rates(2500, 20000)`` (den 20000, sps 8, 50 Hz) and MSK at
    ``Rates(50, 10000)`` (spb 100)."""
    import numpy as np
    from modem_tpu_torch import FskChain, MskChain, Rates, make_scheme

    r = Rates(FSK_FAR_SR // 8, FSK_FAR_SR)
    return (FskChain(make_scheme("mfsk", r), r, 2 * np.arange(16),
                     2 * math.pi * 50 / FSK_FAR_SR, device=device),
            MskChain(Rates(MSK_FAR_BAUD, REF_SR), device=device))


def fsk_kernel_cases(mfsk, msk, device):
    """``(16-MFSK program, cases)``, a case ``(name, kernel fn, plain fn,
    args at the full shape, decisions?)`` for each of K6 (noiseless and
    noisy; and at the den of ``far_chains``, the long route), K8 (and at
    that den, the long route), K9 (the FSK symbol and the MSK slot) and K10
    (and at the spb of ``far_chains``, the long route, 256 x MSK_FAR_SLOTS
    slots), with the inputs the main path gives them: 16-MFSK phase
    programs, their waveform with noise for K9 (means off the tones), MSK
    slot signs."""
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
    far, far_msk = far_chains(device)
    fp = far._phase_program(bits)
    far_args = (fp.fnum, fp.pnum,
                fk._candidate_increments(fk.fsk_coef_table(far.scheme),
                                         fp.den, device),
                fp.den, far.sps, 1.0, f32(fp.qshift), 1, 256, None, SEED + 9)
    return prog, [
        ("fused_fsk_chain", fk.fsk_chain_kernel, fk.fsk_chain_plain,
         chain_args(prog, 256, False), True),
        ("fused_fsk_chain_noisy", fk.fsk_chain_kernel, fk.fsk_chain_plain,
         chain_args(prog, 256, True), True),
        ("fused_fsk_chain_long", fk.fsk_chain_kernel, fk.fsk_chain_plain,
         far_args, True),
        ("fused_fsk_tx", fk.fsk_tx_kernel, fk.fsk_tx_plain, tx_args, False),
        ("fused_fsk_tx_long", fk.fsk_tx_kernel, fk.fsk_tx_plain,
         (fp.fnum, fp.pnum, fp.den, far.sps, 1.0, f32(fp.qshift)), False),
        ("fused_discriminator_means", fk.disc_means_kernel,
         fk.disc_means_plain, (wi, wq, mfsk.sps, 1), False),
        ("fused_discriminator_means_msk", fk.disc_means_kernel,
         fk.disc_means_plain, (mi, mq, msk.spb, 1), False),
        ("fused_msk_tx", fk.msk_tx_kernel, fk.msk_tx_plain,
         (s0, s1, msk.spb, 1.0), False),
        ("fused_msk_tx_long", fk.msk_tx_kernel, fk.msk_tx_plain,
         (s0[:, :MSK_FAR_SLOTS].contiguous(),
          s1[:, :MSK_FAR_SLOTS].contiguous(), far_msk.spb, 1.0), False),
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


def fsk_odd_cases(device, seed: int):
    """K6's arguments ``(label, args)`` at the odd cases: 16-MFSK (the
    ``increase`` and ``default`` maps) and BFSK at den 10000 and sps
    FSK_ODD_SPS, on each shape of FSK_ODD, at guard 1, sps/2 and sps - 1,
    without noise and with noise in tiles of 32 and 256 symbols."""
    from modem_tpu_torch import Rates
    from modem_tpu_torch.models import fsk
    from modem_tpu_torch.models.base import f32
    from modem_tpu_torch.ops import fsk_kernel as fk

    schemes = {"16-MFSK increase": fsk.MFSK(4, 50, REF_SR, 1.0, "increase"),
               "16-MFSK default": fsk.MFSK(4, 50, REF_SR, 1.0, "default"),
               "BFSK": fsk.BFSK(200, REF_SR, 1.0)}
    sigma = f32(fk.fsk_noise_sigma(1.0, FSK_ODD_SNR_DB))
    g = torch.Generator(device=device).manual_seed(seed)
    for tag, scheme in schemes.items():
        targets = fk._candidate_increments(fk.fsk_coef_table(scheme), REF_SR,
                                           device)
        for sps in FSK_ODD_SPS:
            for shape in FSK_ODD:
                syms = torch.randint(0, 1 << scheme.bits_per_symbol, shape,
                                     generator=g, device=device,
                                     dtype=torch.int32)
                p, _ = scheme.program(
                    syms, scheme.init_state(shape[:-1], device),
                    Rates(REF_SR // sps, REF_SR), 0)
                for guard in sorted({1, sps // 2, sps - 1}):
                    for cs, sig in ((256, None), (32, sigma), (256, sigma)):
                        yield (f"{tag} sps {sps} guard {guard} {shape[0]}x"
                               f"{shape[1]} {f'cs {cs}' if sig else 'clean'}",
                               (p.fnum, p.pnum, targets, p.den, sps, 1.0,
                                f32(p.qshift), guard, cs, sig, seed))


def msk_odd_cases(device, seed: int):
    """K7's arguments ``(label, args)`` at the odd cases: spb MSK_ODD_SPB on
    each shape of FSK_ODD, guard 1 and spb - 1, without noise and at 4 dB
    in tiles of 32 and 256 slots."""
    from modem_tpu_torch.models.base import f32
    from modem_tpu_torch.ops import fsk_kernel as fk

    sigma = f32(fk.fsk_noise_sigma(0.9, 4.0))
    g = torch.Generator(device=device).manual_seed(seed)
    for spb in MSK_ODD_SPB:
        for shape in FSK_ODD:
            s0, s1 = (2 * torch.randint(0, 2, shape, generator=g,
                                        device=device, dtype=torch.int32) - 1
                      for _ in range(2))
            for guard in sorted({1, spb - 1}):
                for cs, sig in ((256, None), (32, sigma), (256, sigma)):
                    yield (f"MSK spb {spb} guard {guard} {shape[0]}x"
                           f"{shape[1]} {f'cs {cs}' if sig else 'clean'}",
                           (s0, s1, spb, 0.9, guard, cs, sig, seed))


def k6_probe_cases(device, seed: int):
    """K6's arguments ``(label, args)`` whose decisions read the mean to a
    few ulps: one tone (fnum 10 of den 10000, sps 8) at random phases, and
    256 candidates spread evenly over the range of the means the plain
    version finds; guard 1 and 3, without noise and with sigma 1e-4."""
    from modem_tpu_torch.models.base import f32
    from modem_tpu_torch.ops import fsk_kernel as fk

    g = torch.Generator(device=device).manual_seed(seed)
    shape, den, sps, qshift = (CHANNELS, 1024), REF_SR, 8, f32(-math.pi / 2)
    fnum = torch.full(shape, 10, dtype=torch.int32, device=device)
    pnum = torch.randint(0, den, shape, generator=g, device=device,
                         dtype=torch.int32)
    for guard in (1, 3):
        for sigma in (None, f32(1e-4)):
            wi, wq = fk.fsk_tx_plain(fnum, pnum, den, sps, 1.0, qshift)
            if sigma is not None:
                gi, gq = fk.fsk_noise(shape, sps, 256, seed, device)
                wi = wi + sigma * gi.reshape(wi.shape)
                wq = wq + sigma * gq.reshape(wq.shape)
            mean = fk.disc_means_plain(wi, wq, sps, guard)
            ladder = torch.linspace(float(mean.min()), float(mean.max()),
                                    256, device=device)
            yield (f"probe guard {guard} sigma {sigma}",
                   (fnum, pnum, ladder, den, sps, 1.0, qshift, guard, 256,
                    sigma, seed))


def route_check(what: str, fn, args, device, family: str, want: str,
                other: str, calls: int = 20) -> None:
    """Fails unless ``calls`` calls of ``fn`` run a kernel named ``want``
    and none named ``other``, among the kernels whose names hold
    ``family``, as the profiler sees them (profiled again, up to five
    times, only where a profile lost every record: a profile of one short
    call can end before its record arrives; each begins on an idle
    device)."""
    from torch.profiler import ProfilerActivity, profile

    ran = set()
    for _ in range(5):
        torch.cuda.synchronize(device)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn(*args)
            torch.cuda.synchronize(device)
        ran = {e.key.replace(" ", "") for e in prof.key_averages()
               if family in e.key}
        if ran:
            break
    if not any(want in k for k in ran) or any(other in k for k in ran):
        fail(f"routes: {what} ran {sorted(ran)}, not {want} alone")


def hold_routes(name: str, cases, core, long, plain=None) -> int:
    """Each case's decisions on the core (``core``) equal the long route's
    (``long``) bit for bit, and noiseless the plain version's (``plain``,
    where given); returns the cases held."""
    n = 0
    for label, args in cases:
        got, ref = core(*args), long(*args)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            fail(f"{name} routes: {label}: the core differs from the long "
                 f"route on {int((got != ref).sum())} of {got.numel()}")
        noisy = args[9 if name == "K6" else 6] is not None
        if plain and not noisy and not torch.equal(got, plain(*args)):
            fail(f"{name} routes: {label}: the kernel differs from plain")
        n += 1
    return n


def phase_k6_routes(chains, device) -> float:
    """Phase 11, K6's routes: the core against the long route (the first
    version, ``_fsk_launch(..., tone=None)``) bit for bit at every odd case
    and probe case, noiseless also against the plain version; the tone
    table against its plain twin; then which kernel each entry point runs,
    by the profiler: the core for 16-MFSK's ``roundtrip_fused`` with and
    without noise and BFSK's, the long route at a den past the cap.
    Returns the table's max |kernel - twin|."""
    from modem_tpu_torch.models.base import f32
    from modem_tpu_torch.ops import fsk_kernel as fk

    def long(*a):
        return fk._fsk_launch(*a, tone=None)

    n = hold_routes("K6", fsk_odd_cases(device, SEED + 40),
                    fk.fsk_chain_kernel, long, fk.fsk_chain_plain)
    probes = list(k6_probe_cases(device, SEED + 41))
    hold_routes("K6", probes, fk.fsk_chain_kernel, long)
    spread = min(len(torch.unique(fk.fsk_chain_kernel(*a))) for _, a in probes)
    if spread < 100:
        fail(f"K6 routes: the probe reads the mean on {spread} candidates")
    mfsk, bfsk = chains[0], chains[1]
    qshift = f32(mfsk._phase_program(torch.zeros(
        (1, 4), dtype=torch.int32, device=device)).qshift)
    err = max_err(fk.tone_table_kernel(REF_SR, 1.0, qshift, device),
                  fk.tone_table_plain(REF_SR, 1.0, qshift, device))
    if err > TONE_ATOL:
        fail(f"K6's tone table against its plain twin: {err}")
    print(f"[fsk kernels] K6 core == long route bit for bit at {n} odd cases "
          f"and {len(probes)} probes (the mean read on >= {spread} "
          f"candidates); tone table vs plain twin max |err| {err:.3e} "
          f"(tol {TONE_ATOL})", flush=True)
    g = torch.Generator(device=device).manual_seed(SEED + 42)
    far = far_chains(device)[0]
    for what, fn, bps, want in (
            ("16-MFSK roundtrip_fused", mfsk.roundtrip_fused, 4, True),
            ("16-MFSK roundtrip_fused at 21 dB",
             lambda b: mfsk.roundtrip_fused(b, snr_db=FSK_SNR_DB, seed=1), 4,
             True),
            ("BFSK roundtrip_fused", bfsk.roundtrip_fused, 1, True),
            (f"16-MFSK at den {FSK_FAR_SR} roundtrip_fused",
             far.roundtrip_fused, 4, False)):
        bits = torch.randint(0, 2, (CHANNELS, N_SYMBOLS * bps), generator=g,
                             device=device, dtype=torch.int32)
        names = ("fsk_chain_core", "fsk_chain_kernel")
        route_check(what, fn, (bits,), device, "fsk_chain_",
                    *(names if want else names[::-1]))
        print(f"[fsk kernels] {what} ran {names[0 if want else 1]} alone",
              flush=True)
    return err


def tx_odd_cases(device, seed: int):
    """K8's and K10's arguments ``(kernel, label, args)`` at the odd shapes
    FSK_TX_ODD and at 256 x 4096: K8 for 16-MFSK (both maps), BFSK and
    CPFSK at ``Rates(1250, 10000)``, K10 at each spb of FSK_TX_SPB."""
    from modem_tpu_torch import Rates
    from modem_tpu_torch.models import fsk
    from modem_tpu_torch.models.base import f32

    r = Rates(FSK_BAUD, REF_SR)
    schemes = {"16-MFSK increase": fsk.MFSK(4, 50, REF_SR, 1.0, "increase"),
               "16-MFSK default": fsk.MFSK(4, 50, REF_SR, 1.0, "default"),
               "BFSK": fsk.BFSK(200, REF_SR, 1.0),
               "CPFSK": fsk.CPFSK(2, r, 1.0, 1)}
    g = torch.Generator(device=device).manual_seed(seed)
    shapes = FSK_TX_ODD + ((CHANNELS, N_SYMBOLS),)
    for tag, scheme in schemes.items():
        for shape in shapes:
            syms = torch.randint(0, 1 << scheme.bits_per_symbol, shape,
                                 generator=g, device=device, dtype=torch.int32)
            p, _ = scheme.program(syms, scheme.init_state(shape[:-1], device),
                                  r, 0)
            yield ("K8", f"{tag} {shape[0]}x{shape[1]}",
                   (p.fnum, p.pnum, p.den, 8, 1.0, f32(p.qshift)))
    for spb in FSK_TX_SPB:
        for shape in shapes:
            s0, s1 = (2 * torch.randint(0, 2, shape, generator=g,
                                        device=device, dtype=torch.int32) - 1
                      for _ in range(2))
            yield "K10", f"MSK spb {spb} {shape[0]}x{shape[1]}", (s0, s1, spb,
                                                                  0.7)


def phase_fsk_tx_routes(chains, device) -> None:
    """Phase 11, K8's and K10's routes: the TX core against the long route
    (the first versions, ``_fsk_tx_launch(..., tone=None)`` and
    ``_msk_tx_launch(..., core=False)``) bit for bit at every case of
    ``tx_odd_cases``, both within ATOL of the plain versions; then which
    kernel each ``tx_fused`` runs, by the profiler: the core for 16-MFSK at
    den 10000 and MSK at spb 4, the first versions at den 20000 and spb
    100."""
    from modem_tpu_torch.ops import fsk_kernel as fk

    routes = {"K8": (fk.fsk_tx_kernel,
                     lambda *a: fk._fsk_tx_launch(*a, tone=None),
                     fk.fsk_tx_plain),
              "K10": (fk.msk_tx_kernel,
                      lambda *a: fk._msk_tx_launch(*a, core=False),
                      fk.msk_tx_plain)}
    n, err = 0, 0.0
    for kind, label, args in tx_odd_cases(device, SEED + 45):
        core, long, plain = routes[kind]
        got, ref, want = core(*args), long(*args), plain(*args)
        torch.cuda.synchronize(device)
        for g, r, w in zip(got, ref, want):
            if not torch.equal(g, r):
                fail(f"{kind} routes: {label}: the core differs from the long "
                     f"route on {int((g != r).sum())} of {g.numel()} samples")
            err = max(err, max_err(g, w))
        if err > ATOL:
            fail(f"{kind} routes: {label}: kernel vs plain max |err| {err}")
        n += 1
    print(f"[fsk kernels] K8 and K10 core == long route bit for bit at {n} "
          f"cases; both vs plain max |err| {err:.3e} (tol {ATOL})", flush=True)
    mfsk, msk = chains[0], chains[2]
    far, far_msk = far_chains(device)
    g = torch.Generator(device=device).manual_seed(SEED + 46)
    for what, chain, bps, family, want in (
            ("16-MFSK tx_fused", mfsk, 4, "fsk_tx_", True),
            (f"16-MFSK at den {FSK_FAR_SR} tx_fused", far, 4, "fsk_tx_",
             False),
            ("MSK tx_fused", msk, 2, "msk_tx_", True),
            (f"MSK at spb {far_msk.spb} tx_fused", far_msk, 2, "msk_tx_",
             False)):
        bits = torch.randint(0, 2, (CHANNELS, N_SYMBOLS * bps), generator=g,
                             device=device, dtype=torch.int32)
        if not want:
            bits = bits[:, :MSK_FAR_SLOTS].contiguous()
        names = (family + "core", family + "kernel")
        route_check(what, chain.tx_fused, (bits,), device, family,
                    *(names if want else names[::-1]))
        print(f"[fsk kernels] {what} ran {names[0 if want else 1]} alone",
              flush=True)


def phase_fsk_kernels(chains, device) -> dict:
    """Phase 11: K6 (noiseless and noisy, at 130 x 600 in tiles of 32
    symbols, which crosses the 128-lane and tile keys of the noise stream,
    and at 256 x 4096; and the long route at a den past the core's cap),
    K8 (and past its cap), K9 (groups 8 and 4) and K10 (and past its cap)
    against their plain versions on the card; then K6's routes
    (phase_k6_routes), K8's and K10's (phase_fsk_tx_routes). Returns each
    report entry's (max |error|, agreement)."""
    mfsk, msk = chains[0], chains[2]
    _, cases = fsk_kernel_cases(mfsk, msk, device)
    errs = {}
    small = (slice(0, FSK_SMALL[0]), slice(0, FSK_SMALL[1]))
    for name, kern, plain, args, exact in cases:
        if exact:  # K6: the small tiled shape, then the full one
            noisy = args[9] is not None
            lo = (args[0][small].contiguous(), args[1][small].contiguous()
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
    errs["fsk_tone_table"] = (phase_k6_routes(chains, device), None)
    phase_fsk_tx_routes(chains, device)
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
                   "fused_discriminator_means": fk.DISC_MEANS_KERNEL,
                   "fsk_tone_table": fk.FSK_TONE_KERNEL}
    launches = {}
    for label, chain, n_ch in (("16-MFSK", mfsk, CHANNELS),
                               ("BFSK", bfsk, FSK_SIDE_CHANNELS)):
        bits = bits_for(chain.scheme.bits_per_symbol, n_ch)
        fk.tone_table.cache_clear()  # the path makes its tone table
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
        if counts["fsk_tone_table"] != 1:  # K6 and K8 share one table
            fail(f"{label}: {counts['fsk_tone_table']} tone tables made")
        if label == "16-MFSK":
            launches.update(counts)

    far, far_msk = far_chains(device)
    bits = bits_for(4)
    reset_launches()
    same(f"16-MFSK at den {FSK_FAR_SR} (the long route) roundtrip_fused(bits)"
         " == bits", far.roundtrip_fused(bits), bits)
    same(f"16-MFSK at den {FSK_FAR_SR} rx_fused(tx_fused(bits)) == bits",
         far.rx_fused(*far.tx_fused(bits)), bits)
    counts = read_launches({"fused_fsk_chain_long": fk.FSK_CHAIN_KERNEL,
                            "fused_fsk_tx_long": fk.FSK_TX_KERNEL},
                           f"16-MFSK at den {FSK_FAR_SR}")
    if fk.FSK_TONE_KERNEL.launches:
        fail(f"16-MFSK at den {FSK_FAR_SR} made a tone table")
    launches.update(counts)

    bits = bits_for(2)
    reset_launches()
    same("MSK rx_fused(tx_fused(bits)) == bits",
         msk.rx_fused(*msk.tx_fused(bits)), bits)
    counts = read_launches({"fused_msk_tx": fk.MSK_TX_KERNEL,
                            "fused_discriminator_means_msk":
                                fk.DISC_MEANS_KERNEL}, "MSK")
    launches.update(counts)
    bits = bits_for(2)[:, :MSK_FAR_SLOTS].contiguous()
    reset_launches()
    same(f"MSK at spb {far_msk.spb} (the long route) rx_fused(tx_fused(bits))"
         " == bits", far_msk.rx_fused(*far_msk.tx_fused(bits)), bits)
    launches.update(read_launches({"fused_msk_tx_long": fk.MSK_TX_KERNEL},
                                  f"MSK at spb {far_msk.spb}"))

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
    if name == "fsk_tone_table":  # den entries: theta, 2 cos, 2 gains, add
        return 8 * args[0], 6 * args[0]
    if name.startswith("fused_fsk_chain"):
        fnum, targets, sps, guard = args[0], args[2], args[4], args[7]
        k = fnum.numel()
        n_s = sps - guard + 1  # samples synthesized per symbol
        ops = k * (n_s * 6 + (sps - guard) * 27 + 1 + 3 * targets.numel())
        if args[9] is not None:
            ops += k * n_s * 16
        return 3 * 4 * k + 4 * targets.numel(), ops
    if name.startswith("fused_fsk_tx"):
        k = args[0].numel()
        return 2 * 4 * k + 2 * 4 * k * args[3], 6 * k * args[3]
    if name.startswith("fused_msk_tx"):
        k = args[0].numel()
        return 2 * 4 * k + 2 * 4 * k * args[2], 6 * k * args[2]
    wi, group, guard = args[0], args[2], args[3]
    k = wi.numel() // group
    return 2 * 4 * wi.numel() + 4 * k, k * ((group - guard) * 27 + 1)


def tx_samples(args) -> int:
    """Samples a plane of K8 (args ``fnum, pnum, den, sps, ...``) or K10
    (``s0, s1, spb, amp``)."""
    return args[0].numel() * args[2 if len(args) == 4 else 3]


def fill_yardstick_ms(args, device):
    """The write stream's ceiling for K8 and K10 at ``args``: the profiler's
    device time of one ``fill_`` of their two output planes (one tensor of
    the same 8 bytes a sample), timed beside them; no part of the port."""
    planes = torch.empty((2, tx_samples(args)), dtype=torch.float32,
                         device=device)
    return kernel_device_ms(lambda: planes.fill_(1.0), (), device,
                            "FillFunctor")


def phase_fsk_times(chains, device, card: str) -> dict:
    """Phase 14: each kernel and its plain version per call, the profiler's
    device time, the bound (K8 and K10 on both routes: the core's inputs
    also on the long route, by ``_fsk_tx_launch(..., tone=None)`` and
    ``_msk_tx_launch(..., core=False)``, beside the write stream's ceiling,
    one ``fill_`` of the two planes); K6's tone table kernel, and its
    launches over 10 calls of ``roundtrip_fused`` (0: the table is made
    once); then the config #3 entry points per call with the device's busy
    time and idle share."""
    from modem_tpu_torch.ops import fsk_kernel as fk

    mfsk, _, msk, _ = chains
    _, cases = fsk_kernel_cases(mfsk, msk, device)
    long_routes = {"fused_fsk_tx": lambda *a: fk._fsk_tx_launch(*a, tone=None),
                   "fused_msk_tx": lambda *a: fk._msk_tx_launch(*a,
                                                                core=False)}
    times = {}
    for name, kern, plain, args, _ in cases:
        ms, plain_ms, dev_ms = kernel_times(kern, plain, args, device,
                                            FSK_REPORT[name][1])
        times[name] = (ms, plain_ms, dev_ms, None, fsk_work(name, args))
        samples = CHANNELS * N_SYMBOLS * mfsk.sps
        if name.startswith(("fused_fsk_tx", "fused_msk_tx")):
            samples = tx_samples(args)
        print_times(name, samples, times[name], card, "no library call")
        if name in long_routes:
            long_ms = kernel_device_ms(long_routes[name], args, device,
                                       FSK_REPORT[name + "_long"][1])
            fill_ms = fill_yardstick_ms(args, device)
            if None in (long_ms, fill_ms, dev_ms):
                fail(f"{name}: a profile lost the long route or fill_")
            print(f"[times] {name:26s} long route at the same inputs "
                  f"{long_ms:.4f} ms; fill_ of the two planes (the write "
                  f"ceiling) {fill_ms:.4f} ms, the core at "
                  f"{fill_ms / dev_ms:.1%} of its rate; on {card}",
                  flush=True)

    args = (REF_SR, 1.0, cases[0][3][6], device)
    ms, plain_ms, dev_ms = kernel_times(fk.tone_table_kernel,
                                        fk.tone_table_plain, args, device,
                                        "fsk_tone_kernel")
    times["fsk_tone_table"] = (ms, plain_ms, dev_ms, None,
                               fsk_work("fsk_tone_table", args))
    print_times("fsk_tone_table", REF_SR, times["fsk_tone_table"], card,
                "no library call")

    g = torch.Generator(device=device).manual_seed(SEED + 13)
    bits = torch.randint(0, 2, (CHANNELS, N_SYMBOLS * 4), generator=g,
                         device=device, dtype=torch.int32)
    mbits = torch.randint(0, 2, (CHANNELS, N_SYMBOLS * 2), generator=g,
                          device=device, dtype=torch.int32)
    mfsk.roundtrip_fused(bits)
    before = fk.FSK_TONE_KERNEL.launches
    for _ in range(10):
        mfsk.roundtrip_fused(bits)
    made = fk.FSK_TONE_KERNEL.launches - before
    print(f"[times] fsk_tone_table: {made} launches over 10 calls of "
          "FskChain.roundtrip_fused after the first", flush=True)
    if made:
        fail("FskChain.roundtrip_fused made its tone table again")
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
                    down: int = RS_DOWN, span: int = 8):
    """``bench_rows.py:65``'s chain: ``ResampledChain(QAM(4, 0.0, 1.0),
    Rates(1250, 10000), 3, 2)``."""
    from modem_tpu_torch import Rates, ResampledChain
    from modem_tpu_torch.models.qam import QAM

    return ResampledChain(QAM(bps, 0.0, 1.0), Rates(FSK_BAUD, REF_SR), up,
                          down, span_symbols=span, device=device)


def rs_route_chains(device) -> list:
    """``[(label, chain, report suffix)]``: the chains of RS_ROUTES, then
    config #4's 64-QAM and a 5/4 chain (the long route at 65 RRC taps),
    checked but with no report entry of their own (suffix None)."""
    return [(f"{up}/{down} span {span}",
             resampled_chain(device, up=up, down=down, span=span), suffix)
            for suffix, (up, down, span, _, _) in RS_ROUTES.items()] + [
        ("64-QAM 3/2", resampled_chain(device, bps=6), None),
        ("5/4", resampled_chain(device, up=5, down=4), None)]


def rs_symbol(name: str) -> str:
    """The profiler name (spaces dropped) of the kernel that K11 or K12
    report entry ``name`` runs on its route (RS_ROUTES)."""
    tx = name.startswith("fused_resampled_tx")
    soft = name.endswith("_soft")
    suffix = name[len("fused_resampled_tx"):].removesuffix("_soft")
    _, _, _, tx_name, rx_name = RS_ROUTES[suffix]
    return tx_name if tx else rx_name.format("true" if soft else "false")


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
    """K7's ``(name, args)`` without and with noise on random slot signs;
    at 256 channels also without noise past the core's cap (spb of
    ``far_chains``' MSK, MSK_FAR_SLOTS slots), the long route."""
    from modem_tpu_torch.ops import fsk_kernel as fk
    from modem_tpu_torch.models.base import f32

    g = torch.Generator(device=device).manual_seed(seed)
    s0, s1 = (2 * torch.randint(0, 2, shape, generator=g, device=device,
                                dtype=torch.int32) - 1 for _ in range(2))
    sigma = f32(fk.fsk_noise_sigma(1.0, MSK_SNR_DB))
    cases = [("fused_msk_slots", (s0, s1, msk.spb, 1.0, 1, cs, None, seed)),
             ("fused_msk_slots_noisy",
              (s0, s1, msk.spb, 1.0, 1, cs, sigma, seed))]
    if shape[0] == CHANNELS:
        far = far_chains(device)[1]
        f0, f1 = (v[:, :MSK_FAR_SLOTS].contiguous() for v in (s0, s1))
        cases.append(("fused_msk_slots_long",
                      (f0, f1, far.spb, 1.0, 1, cs, None, seed)))
    return cases


def phase_k7_routes(msk, device) -> None:
    """Phase 15, K7's routes: the core against the long route (the first
    version, ``_msk_launch(..., core=False)``) bit for bit at every odd
    case, noiseless also against the plain version; then which kernel each
    entry point runs, by the profiler: the core for MSK's
    ``roundtrip_fused`` with and without noise, the long route past the
    core's spb cap."""
    from modem_tpu_torch.ops import fsk_kernel as fk

    n = hold_routes("K7", msk_odd_cases(device, SEED + 43),
                    fk.msk_chain_kernel,
                    lambda *a: fk._msk_launch(*a, core=False),
                    fk.msk_chain_plain)
    print(f"[rs kernels] K7 core == long route bit for bit at {n} odd cases",
          flush=True)
    g = torch.Generator(device=device).manual_seed(SEED + 44)
    far = far_chains(device)[1]
    for what, fn, slots, want in (
            ("MSK roundtrip_fused", msk.roundtrip_fused, 2 * N_SYMBOLS, True),
            ("MSK roundtrip_fused at 7 dB",
             lambda b: msk.roundtrip_fused(b, snr_db=MSK_SNR_DB, seed=1),
             2 * N_SYMBOLS, True),
            (f"MSK at spb {far.spb} roundtrip_fused", far.roundtrip_fused,
             MSK_FAR_SLOTS, False)):
        bits = torch.randint(0, 2, (CHANNELS, slots), generator=g,
                             device=device, dtype=torch.int32)
        names = ("msk_chain_core", "msk_chain_kernel")
        route_check(what, fn, (bits,), device, "msk_chain_",
                    *(names if want else names[::-1]))
        print(f"[rs kernels] {what} ran {names[0 if want else 1]} alone",
              flush=True)


def phase_rs_kernels(msk, device) -> dict:
    """Phase 15: K7 (and its long route past the core's cap), K11 and K12
    against their plain versions on the card, K7's routes
    (phase_k7_routes), K11 and K12 on every route (rs_route_chains) at the
    tile edges and at full width; returns each report entry's (max |error|,
    agreement) at full width."""
    from modem_tpu_torch.ops import fsk_kernel as fk

    errs = {}
    for shape, cs in ((MSK_SMALL, FSK_SMALL_CHUNK),
                      ((CHANNELS, 2 * N_SYMBOLS), 256)):
        for name, args in msk_cases(msk, shape, cs, device, SEED + 20):
            errs[name] = compare_decisions(
                name, fk.msk_chain_kernel(*args), fk.msk_chain_plain(*args),
                tuple(args[0].shape), args[6] is not None)
    phase_k7_routes(msk, device)
    for label, chain, suffix in rs_route_chains(device):
        for shape in (SMALL,) + RS_EDGES + ((CHANNELS, N_SYMBOLS),):
            cases = rs_cases(chain, shape, device, SEED + 21)
            for name, kern, plain, args, exact in cases:
                got, want = kern(*args), plain(*args)
                torch.cuda.synchronize(device)
                err = max_err(got, want)
                if (exact and err != 0) or err > ATOL:
                    fail(f"{name} {label} at {shape}: kernel vs plain "
                         f"max |err| {err}")
                entry = name + (suffix or "")
                if (suffix is not None and shape[0] == CHANNELS
                        and entry in RS_REPORT):
                    errs[entry] = (err, None)
                print(f"[rs kernels] {name:24s} {label:14s} {shape[0]:4d} ch "
                      f"x {shape[1]:5d} sym: max |kernel - plain| = "
                      f"{err:.3e} ({'exact' if exact else f'tol {ATOL}'})",
                      flush=True)
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

    for label, side, suffix in rs_route_chains(device):
        if suffix == "":
            continue  # config #4's chain, above
        b = bits_for(side, *RS_SIDE)
        reset_launches()
        same(f"{label} roundtrip_fused(bits) == bits", side.roundtrip_fused(b),
             b)
        same(f"{label} rx_fused(tx_fused(bits)) == bits",
             side.rx_fused(side.tx_fused(b), RS_SIDE[1]), b)
        counts = read_launches({**tx_k, **rx_k}, label)
        if suffix is not None:
            for name, n in counts.items():
                launches[name + suffix] = n

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
    far = far_chains(device)[1]
    mbits = mbits[:, :MSK_FAR_SLOTS].contiguous()
    reset_launches()
    same(f"MSK at spb {far.spb} (the long route) roundtrip_fused(bits) == "
         "bits", far.roundtrip_fused(mbits), mbits)
    launches["fused_msk_slots_long"] = read_launches(
        {"fused_msk_slots_long": fk.MSK_CHAIN_KERNEL},
        f"MSK at spb {far.spb}")["fused_msk_slots_long"]
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
    if name.startswith("fused_resampled_tx"):
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


def rs_samples(name: str, args) -> int:
    """The channel-rate samples a call of K11 writes or of K12 reads."""
    if name.startswith("fused_resampled_tx"):
        syms, _, _, _, _, _, up, down, n_modem = args
        return syms.shape[0] * n_modem * up // down
    return args[0].numel()


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
    """Phase 18: each kernel and its plain version per call (K11 and K12 on
    every route), the profiler's device time of the kernel each route runs
    (rs_symbol; failing where the profile has none), the bound and K12
    soft's ``conv1d`` yardstick; then
    the config #4 and MSK loopback entry points per call with the device's
    busy time and idle share."""
    from modem_tpu_torch.ops import fsk_kernel as fk

    chain = resampled_chain(device)
    cases = rs_cases(chain, (CHANNELS, N_SYMBOLS), device, SEED + 25)
    cases = [(n, k, p, a) for n, k, p, a, _ in cases]
    for _, side, suffix in rs_route_chains(device):
        if not suffix:
            continue  # config #4's chain, above; chains without an entry
        cases += [(n + suffix, k, p, a) for n, k, p, a, _ in rs_cases(
            side, (CHANNELS, N_SYMBOLS), device, SEED + 25)
            if n + suffix in RS_REPORT]
    cases += [(n, fk.msk_chain_kernel, fk.msk_chain_plain, a)
              for n, a in msk_cases(msk, (CHANNELS, 2 * N_SYMBOLS), 256,
                                    device, SEED + 26)]
    samples = CHANNELS * chain._padded_len(N_SYMBOLS) * RS_UP // RS_DOWN
    times = {}
    for name, kern, plain, args in cases:
        symbol = (RS_REPORT[name][0] if name.startswith("fused_msk")
                  else rs_symbol(name))
        ms, plain_ms, dev_ms = kernel_times(kern, plain, args, device, symbol)
        if dev_ms is None:
            fail(f"{name}: no {symbol} in three profiles (the kernel its "
                 f"route runs)")
        lib_ms, extra = None, "no library call"
        if name == "fused_resampled_rx_soft":
            fn, fargs, lib_err = conv1d_yardstick(args, device)
            if lib_err > 1e-4:
                fail(f"conv1d yardstick disagrees with K12 soft ({lib_err})")
            lib_ms = time_calls(fn, fargs, device)
            extra = f"conv1d {lib_ms:.4f} ms (max |err| vs K12 {lib_err:.2e})"
        times[name] = (ms, plain_ms, dev_ms, lib_ms, rs_work(name, args))
        n = (args[0].numel() * args[2] if name.startswith("fused_msk")
             else rs_samples(name, args))
        print_times(name, n, times[name], card, f"{extra}, {symbol}")

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
    tx = ("tx", "pulse_tx_core", "modem_tpu/ops/pallas_txrx.py:61")
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
        if gate["passed"] is not True or "not_run" in gate:
            fail(f"release gate {gate['gate']}: {gate}")
    passed = sum(g["passed"] is True for g in gates)
    print(f"[harness] release_gates(scale={GATES_SCALE}): gates_passed "
          f"{passed}, gates_total {len(gates)}", flush=True)
    if (passed, len(gates)) != (5, 5):
        fail(f"release_gates: {passed} of {len(gates)} gates passed")
    args = (chain, MODE_SNR_DB, N_SYMBOLS, CHANNELS, SEED + 44)
    ms = time_calls(harness.fused_ber_point, args, device, calls=5, reps=3)
    bits = CHANNELS * N_SYMBOLS * 2
    print(f"[times] harness.fused_ber_point per call {ms:.4f} ms "
          f"({bits / ms * 1e3:.4e} bits/s, {CHANNELS} ch x {N_SYMBOLS} QPSK "
          f"symbols, host symbol draw included) on {card}", flush=True)
    return launches


def phase_viterbi_wide(device) -> tuple[dict, dict]:
    """Phase 26 (d): K13 on the shapes F1 widened: K = 3 (S = 4, the warp
    route with idle lanes) and K = 15 (S = 16384, the block core) through
    ``decode_soft_windowed``, then a K = 16 code through it (the long
    route), each with every launch count set to 0 just before and read just
    after, bit for bit against the plain version; at K = 15 the long route
    forced on the same stream, bit for bit against the core. Returns
    (errors, launches)."""
    from modem_tpu_torch.ops import viterbi_kernel as vk

    kernels = {"warp": vk.VITERBI_KERNEL, "core": vk.VITERBI_CORE_KERNEL,
               "long": vk.VITERBI_BLOCK_KERNEL}
    cases = [(name, k, polys, WIDE_VIT_SHAPE, WIDE_VIT_BLOCK)
             for name, (k, polys) in WIDE_VIT.items()]
    cases.append(("viterbi_k15_long", *VIT_LONG[0], *VIT_LONG[1:]))
    errs, launches = {}, {}
    for name, k, polys, shape, block in cases:
        code, bits, lam = vit_case(k, polys, shape, 0.8, SEED + 50, device)
        llr = lam.reshape(lam.shape[0], -1)
        way = vk.route(code, block + 20 * k)
        reset_launches()
        got = code.decode_soft_windowed(llr, block)
        launches.update(read_launches({name: kernels[way]}, f"K={k} decode",
                                      "viterbi wide"))
        want = vk.stream_plain(code, lam, block, 10 * k, 1e6)
        torch.cuda.synchronize(device)
        errs[name] = max_err(got, want)
        print(f"[viterbi wide] K={k} (S={code.n_states}, the {way} route) "
              f"{shape[0]} ch x {shape[1]} bits, B={block}: max |kernel - "
              f"plain| = {errs[name]:.0f} (exact), BER vs sent "
              f"{float((got != bits).double().mean()):.3e}", flush=True)
        if errs[name] != 0:
            fail(f"K13 at K={k}: kernel and plain differ")
        if name == "viterbi_k15":
            if way != "core":
                fail(f"K13 at K={k} took the {way} route, not the core")
            long = vk.stream_kernel(code, lam, block, 10 * k, 1e6,
                                    long_route=True)
            torch.cuda.synchronize(device)
            err = max_err(long, got)
            print(f"[viterbi wide] K={k}: the long route forced on the same "
                  f"stream against the core: max |long - core| = {err:.0f} "
                  f"(exact)", flush=True)
            if err != 0:
                fail(f"K13 at K={k}: the long route and the core differ")
        if name == "viterbi_k15_long" and way != "long":
            fail(f"K13 at K={k} took the {way} route, not the long route")
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
        if kind == "tx":
            tx_route_check(name, kern, args, device)
        times[name] = (ms, plain_ms, dev_ms, None,
                       mode_work(kind, spec, CHANNELS, N_SYMBOLS, chain))
        print_times(name, CHANNELS * N_SYMBOLS * chain.sps, times[name], card,
                    "no library call")
    for name, (k, polys) in WIDE_VIT.items():
        code, _, lam = vit_case(k, polys, WIDE_VIT_SHAPE, 0.8, SEED + 51,
                                device)
        t_w = WIDE_VIT_BLOCK + 20 * k
        sym = {"warp": "viterbi_kernel", "core": "viterbi_block_core",
               "long": "viterbi_block_kernel"}[vk.route(code, t_w)]
        times[name] = viterbi_times(name, sym, code, lam, WIDE_VIT_SHAPE[0],
                                    WIDE_VIT_BLOCK, 10 * k, device, card,
                                    plain_calls=1)
    # K = 15: the long route forced on the core's stream in the same run,
    # then both over the whole card
    code, _, lam = vit_case(*WIDE_VIT["viterbi_k15"], WIDE_VIT_SHAPE, 0.8,
                            SEED + 51, device)
    times["viterbi_k15_long"] = viterbi_times(
        "viterbi_k15_long", "viterbi_block_kernel", code, lam,
        WIDE_VIT_SHAPE[0], WIDE_VIT_BLOCK, 150, device, card, plain_calls=1,
        long_route=True)
    code, _, lam = vit_case(*WIDE_VIT["viterbi_k15"], WIDE_VIT_FULL, 0.8,
                            SEED + 52, device)
    for name, sym, long_route in (
            ("viterbi_k15_64ch", "viterbi_block_core", False),
            ("viterbi_k15_64ch_long", "viterbi_block_kernel", True)):
        viterbi_times(name, sym, code, lam, WIDE_VIT_FULL[0], WIDE_VIT_BLOCK,
                      150, device, card, plain_calls=1, long_route=long_route)
    return times


def viterbi_times(name: str, sym: str, code, lam, channels: int, block: int,
                  halo: int, device, card: str, plain_calls: int,
                  long_route: bool = False) -> tuple:
    """K13's stream form (its long route where ``long_route``) and its plain
    version per call, the profiler's device time of kernel symbol ``sym``,
    the bound and the time per trellis step, printed (for the block route
    also the per-row floor); returns the report times."""
    from modem_tpu_torch.ops import viterbi_kernel as vk

    def kern(*args):
        return vk.stream_kernel(*args, long_route=long_route)

    ms, plain_ms, dev_ms = kernel_times(
        kern, vk.stream_plain, (code, lam, block, halo, 1e6), device, sym,
        plain_calls=plain_calls)
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
    if vk.route(code, t_w) != "warp":
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        row_ms = flops / rows / (F32_FLOP_PER_S / sms) * 1e3
        waves = -(-rows // sms)
        print(f"[times] {name}: per-row floor {row_ms:.6f} ms (a row's "
              f"{flops / rows / 1e6:.3f} MFLOP at one SM's share of "
              f"{F32_FLOP_PER_S / 1e12:.0f} TFLOP/s, {sms} SMs; a block a "
              f"row, {rows} rows in {waves} wave(s) of one block an SM: "
              f"{waves * row_ms:.6f} ms), {100 * waves * row_ms / step:.2f}% "
              f"of it, on {card}", flush=True)
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
    equal to the CPU route, with K15 / K16 launched once a call; both also
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
    errs[SC_NAME] = max(errs[SC_NAME], check_exact(
        "polar kernel", f"K15 SC u, x at {POLAR_LINK_CW} x ({POLAR_N}, "
        f"{POLAR_K}), sigma {POLAR_SIGMAS[-1]}", sk.sc_kernel(code, lam),
        sk.sc_plain(code, lam)))
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


def sc_work(b: int, code) -> tuple[float, float]:
    """Bytes K15 must move (the LLRs read once, u and x written once as
    bytes) and its f32 operations on ``b`` codewords of ``code``: at each
    node outside the all-frozen subtrees, whose outputs do not depend on
    the LLRs, an f (2 abs, a min, 2 sign products: 5) or a g (2x, 1 - 2x,
    the product, the add: 4) an element, and a compare at each information
    leaf."""
    fz, ops, w = code.frozen, 0, 1
    while w < code.n:
        for lo in range(0, code.n, w):
            if not fz[lo:lo + w].all():
                ops += (5 if lo % (2 * w) == 0 else 4) * w
        w *= 2
    return 6.0 * b * code.n, float(b * (ops + int((~fz).sum())))


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
    step, share of the bound and serial floor; K15 and K16 also at the
    link's 1024 codewords, with their serial floors); the encoders and
    decoders per call in Mbit/s of info bits; the three links' (the polar
    one with CA-SCL-8 and with SC) ``tx_fused`` and ``rx_fused`` per call
    at 256 frames with the device's busy time and idle share. Returns the
    report times."""
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
             sc_work(POLAR_CW, pcode)),
            (SCL_NAME, lk.scl_kernel, lk.scl_plain, "scl_kernel",
             scl_work(POLAR_CW, POLAR_N, pcode.n_bits, POLAR_K))):
        ms, plain_ms, dev_ms = kernel_times(kern, plain, (pcode, lam),
                                            device, sym, plain_calls=1)
        times[name] = (ms, plain_ms, dev_ms, None, work)
        print_fec_times(name, f"{POLAR_CW} x ({POLAR_N}, {POLAR_K})",
                        times[name], card)
    print_k15_floor(SC_NAME, pcode, POLAR_CW, times[SC_NAME], card)
    print_k16_floor(f"{SCL_NAME}", POLAR_CW, times[SCL_NAME], card)
    _, lam_link = polar_llrs(pcode, crc, POLAR_LINK_CW, POLAR_SIGMAS[-1],
                             SEED + 69, device)
    for name, kern, plain, sym, work in (
            (SC_NAME, sk.sc_kernel, sk.sc_plain, "sc_kernel",
             sc_work(POLAR_LINK_CW, pcode)),
            (SCL_NAME, lk.scl_kernel, lk.scl_plain, "scl_kernel",
             scl_work(POLAR_LINK_CW, POLAR_N, pcode.n_bits, POLAR_K))):
        t_link = (*kernel_times(kern, plain, (pcode, lam_link), device, sym,
                                plain_calls=1), None, work)
        label = f"{name} x{POLAR_LINK_CW}"
        print_fec_times(label, f"{POLAR_LINK_CW} x ({POLAR_N}, {POLAR_K})",
                        t_link, card)
        if name == SC_NAME:
            print_k15_floor(label, pcode, POLAR_LINK_CW, t_link, card)
        else:
            print_k16_floor(label, POLAR_LINK_CW, t_link, card)
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

    for name, kw, snr in (
            ("lte_like_turbo_link", {}, FEC_LINK_SNR_DB[0]),
            ("nr_like_control_link", {}, FEC_LINK_SNR_DB[1]),
            ("nr_like_control_link", {"list_size": None},
             FEC_LINK_SNR_DB[2])):
        link = getattr(presets, name)(device=device, **kw)
        if kw:
            name = f"{name}(list_size=None)"
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


def long_route_names(sps: int, span: int, k: int = LONG_SYMBOLS) -> dict:
    """Report names of K1, K2, K3 hard and K3 soft on a long-route chain at
    256 x ``k`` symbols (K2 at LONG_SYMBOLS alone)."""
    tag = f"sps{sps}_span{span}{'' if k == LONG_SYMBOLS else f'_{k}'}"
    out = {"fused_pulse_chain": f"fused_pulse_chain_{tag}",
           "fused_rx": f"fused_rx_{tag}",
           "fused_rx_soft": f"fused_rx_soft_{tag}"}
    if k == LONG_SYMBOLS:
        out["fused_tx"] = f"fused_tx_{tag}"
    return out


def long_route_shapes() -> list:
    """((baud, sample rate, span), sizes) of each chain phase 34 drives:
    LONG_ROUTE's on the core at both sizes, LONG_FIRST_ROUTE's on the
    first version at LONG_SYMBOLS."""
    return ([(r, LONG_SIZES) for r in LONG_ROUTE]
            + [(LONG_FIRST_ROUTE, (LONG_SYMBOLS,))])


#: the profiler's names of the long route's kernels where they differ from
#: the short route's (DEVICE_NAMES): K1's and K3's long core; K2's is the
#: first version's template's
LONG_DEVICE_NAMES = {"fused_pulse_chain": "pulse_chain_long_core",
                     "fused_tx": "pulse_tx_kernel",
                     "fused_rx": "pulse_rx_long_core<false,",
                     "fused_rx_soft": "pulse_rx_long_core<true,"}
#: the names of K1's and K3's first versions in a profile (the short
#: route's template, DEVICE_NAMES), and K2's long route
LONG_FIRST_NAMES = {**{n: DEVICE_NAMES[n]
                       for n in ("fused_pulse_chain", "fused_rx",
                                 "fused_rx_soft")},
                    "fused_tx": LONG_DEVICE_NAMES["fused_tx"]}
LONG_SOURCES = {"fused_pulse_chain": ("modem_tpu_torch/csrc/chain.cu",
                                      "modem_tpu/ops/pallas_chain.py:195"),
                "fused_tx": ("modem_tpu_torch/csrc/txrx.cu",
                             "modem_tpu/ops/pallas_txrx.py:61"),
                "fused_rx": ("modem_tpu_torch/csrc/txrx.cu",
                             "modem_tpu/ops/pallas_txrx.py:277"),
                "fused_rx_soft": ("modem_tpu_torch/csrc/txrx.cu",
                                  "modem_tpu/ops/pallas_txrx.py:277")}
#: K3's modes beside baseband f32 that phase 34 times on the core and on
#: the first version at 256 x 4096: the reference CLI's carrier (1000 Hz)
#: on the real waveform, bf16 rails, and both
LONG_RX_MODES = ("passband", "bf16", "passband_bf16")
LONG_CARRIER_HZ = 1000


def long_route_entries() -> list:
    """(name, source, replaced TPU kernel) of each long-route entry: each
    chain of :func:`long_route_shapes` at each of its sizes."""
    out = []
    for (baud, sr, span), sizes in long_route_shapes():
        for k in sizes:
            out += [(n, *LONG_SOURCES[kind]) for kind, n in
                    long_route_names(sr // baud, span, k).items()]
    return out


def equal_outputs(a, b) -> bool:
    """Whether two kernel outputs (a tensor, or a tuple of them) are equal
    bit for bit."""
    a, b = (a, b) if isinstance(a, tuple) else ((a,), (b,))
    return all(torch.equal(x, y) for x, y in zip(a, b))


def long_rx_mode_args(chain, syms, soft: bool, mode: str) -> tuple:
    """``rx_kernel``'s arguments for K3 in ``mode`` on ``chain``'s waveform
    of ``syms``, for ``soft`` with noise (sigma 0.3) as kernel_cases's:
    passband, the real waveform at LONG_CARRIER_HZ; bf16, the rails
    rounded to bf16."""
    from modem_tpu_torch.ops import txrx

    carrier = ((LONG_CARRIER_HZ, chain.rates.sample_rate)
               if mode.startswith("passband") else None)
    k = syms.shape[-1]
    wave = txrx.tx_plain(syms, chain.lut, chain.rrc, chain.sps, chain.span,
                         None, carrier)
    g = torch.Generator(device=syms.device).manual_seed(SEED + 2)
    rails = tuple(w + 0.3 * soft * torch.randn(w.shape, generator=g,
                                               device=w.device)
                  for w in ((wave,) if carrier else wave))
    if mode.endswith("bf16"):
        rails = tuple(w.to(torch.bfloat16) for w in rails)
    wq = None if carrier else rails[1]
    return (rails[0], wq, k, chain.lut, chain.rrc, chain.sps, chain.span,
            soft, None, carrier)


def phase_long_route(device, card: str) -> tuple[dict, dict, dict, dict]:
    """Phase 34: the long route of K1, K2 and K3 (taps from a device array
    in shared memory), for chains past 256 taps or 64 samples a symbol:
    LONG_ROUTE's on K1's and K3's long core at 256 x 1024 and 256 x 4096
    symbols, LONG_FIRST_ROUTE's (past the core's shared memory) on their
    first version by the host's rule at 256 x 1024. For each:
    ``roundtrip_fused``, ``rx_fused(tx_fused)`` and ``rx_soft_fused`` give
    the bits back, with every launch count set to 0 just before and read
    just after (the other route's counts 0); K1 and K3 hard bit for bit and
    K2 and K3 soft within ATOL against their plain versions, and the times
    beside the plain versions', the profiler's device time of the kernel
    the route runs, the bound and, for K3 soft and K2, the ``conv1d`` and
    ``conv_transpose1d`` yardsticks. On the core's chains the first version
    is forced on the same inputs (K1, K3 hard and soft bit for bit with the
    core) and timed, a comparison on the core's entry; at 256 x 4096 so is
    K3 in LONG_RX_MODES. Returns (errors, launches, times, the entries'
    comparisons)."""
    import functools

    from modem_tpu_torch import Rates
    from modem_tpu_torch.chain import PulseShapedChain
    from modem_tpu_torch.models.psk import QPSK
    from modem_tpu_torch.ops import chain_kernel as ck, txrx
    from modem_tpu_torch.ops.llr import llr_hard_bits

    errs, launches, times, extras = {}, {}, {}, {}
    first_kernels = {"fused_pulse_chain": ck.CHAIN_FIRST_KERNEL,
                     "fused_rx": txrx.RX_HARD_FIRST_KERNEL,
                     "fused_rx_soft": txrx.RX_SOFT_FIRST_KERNEL}
    core_kernels = {"fused_pulse_chain": ck.CHAIN_KERNEL,
                    "fused_tx": txrx.TX_KERNEL,
                    "fused_rx": txrx.RX_HARD_KERNEL,
                    "fused_rx_soft": txrx.RX_SOFT_KERNEL}

    def main_path(chain, k, label, first):
        """The three fused forms at 256 x k; their launches by kind."""
        g = torch.Generator(device=device).manual_seed(SEED + 80 + chain.sps)
        bits = torch.randint(0, 2, (CHANNELS, 2 * k), generator=g,
                             device=device, dtype=torch.int32)
        ran = {**core_kernels, **first_kernels} if first else core_kernels
        idle = [kn for n, kn in (core_kernels if first else
                                 first_kernels).items() if n != "fused_tx"]
        counts = {}
        reset_launches()
        ok = torch.equal(chain.roundtrip_fused(bits), bits)
        counts.update(read_launches(
            {"fused_pulse_chain": ran["fused_pulse_chain"]},
            f"{label} loopback", "long route"))
        idle_runs = sum(kn.launches for kn in idle)
        reset_launches()
        wave = chain.tx_fused(bits)
        ok &= torch.equal(chain.rx_fused(wave, k), bits)
        ok &= torch.equal(llr_hard_bits(chain.rx_soft_fused(
            wave, k, noise_var=0.5)), bits)
        counts.update(read_launches(
            {n: ran[n] for n in ("fused_tx", "fused_rx", "fused_rx_soft")},
            f"{label} tx_fused -> rx_fused, rx_soft_fused", "long route"))
        if idle_runs + sum(kn.launches for kn in idle):
            fail(f"long route {label}: the other route's kernels launched")
        print(f"[long route] {label}: the bits back through every fused form"
              f" ({'first version' if first else 'core'}): {ok}", flush=True)
        if not ok:
            fail(f"long route {label}: bits differ")
        return counts

    def first_beside(name, entry, kern, args, dev_ms, work):
        """The first version forced on the core's inputs: its outputs equal
        the core's bit for bit; its times, the core's entry's comparison."""
        fv = functools.partial(kern, first=True)
        before = first_kernels[name].launches
        out = fv(*args)
        torch.cuda.synchronize()
        if first_kernels[name].launches != before + 1:
            fail(f"long route {entry}: the forced first version did not "
                 "launch")
        same = equal_outputs(out, kern(*args))
        print(f"[long route] {entry}: the forced first version's outputs "
              f"equal the core's bit for bit: {same}", flush=True)
        if not same:
            fail(f"long route {entry}: core and first version differ")
        f_ms = (time_calls(fv, args, device) + time_calls(fv, args, device)) / 2
        f_dev = kernel_device_ms(fv, args, device, LONG_FIRST_NAMES[name])
        if f_dev is None:
            fail(f"long route {entry}: the profile holds no launch of the "
                 "first version")
        bound_ms = bound(*work)[0]
        print(f"[times] {entry} forced first version: per call {f_ms:.4f} ms, "
              f"in the profiler {f_dev:.4f} ms ({bound_ms / f_dev:.3f} of "
              f"the bound), the core {dev_ms:.4f} ms: the first version at "
              f"{f_dev / dev_ms:.2f}x the core's device time; on {card}",
              flush=True)
        return {"ms": f_ms, "device_ms": f_dev, "share": bound_ms / f_dev,
                "launches": 1}

    def modes_beside(chain, name, entry, syms, k):
        """K3 in LONG_RX_MODES on the core and on the forced first version:
        bit for bit with each other and against the plain version (hard
        exact, soft within ATOL); their device times."""
        soft = name == "fused_rx_soft"
        out = {}
        for mode in LONG_RX_MODES:
            args = long_rx_mode_args(chain, syms, soft, mode)
            got, want = txrx.rx_kernel(*args), txrx.rx_plain(*args)
            fv = functools.partial(txrx.rx_kernel, first=True)
            same = equal_outputs(fv(*args), got)
            err = max_err(got, want)
            print(f"[long route] {entry} {mode}: core vs plain max |err| "
                  f"{err:.3e}; the forced first version's outputs equal the "
                  f"core's bit for bit: {same}", flush=True)
            if not same or (not soft and err != 0) or err > ATOL:
                fail(f"long route {entry} {mode}: core, first version and "
                     "plain differ")
            c_dev = kernel_device_ms(txrx.rx_kernel, args, device,
                                     LONG_DEVICE_NAMES[name])
            f_dev = kernel_device_ms(fv, args, device, LONG_FIRST_NAMES[name])
            if c_dev is None or f_dev is None:
                fail(f"long route {entry} {mode}: a profile holds no launch")
            out[mode] = {"device_ms": c_dev, "first_device_ms": f_dev,
                         "max_abs_err": err}
            print(f"[times] {entry} {mode}: core {c_dev:.4f} ms, forced "
                  f"first version {f_dev:.4f} ms in the profiler "
                  f"({f_dev / c_dev:.2f}x); {CHANNELS} x {k} on {card}",
                  flush=True)
        return out

    for (baud, sr, span), sizes in long_route_shapes():
        chain = PulseShapedChain(QPSK(0.0, 1.0), Rates(baud, sr),
                                 span_symbols=span, device=device)
        sps = chain.sps
        first = (baud, sr, span) == LONG_FIRST_ROUTE
        if txrx.kernel_taps(chain.rrc, sps)[0] is not None:
            fail(f"sps {sps}, span {span} did not take the long route")
        if txrx.pulse_long_route(sps, span) != ("first" if first else "core"):
            fail(f"sps {sps}, span {span}: the host's rule chose "
                 f"{txrx.pulse_long_route(sps, span)}")
        dev_names = LONG_FIRST_NAMES if first else LONG_DEVICE_NAMES
        for k in sizes:
            names = long_route_names(sps, span, k)
            label = (f"sps {sps}, span {span} ({chain.rrc.shape[0]} taps), "
                     f"{CHANNELS} x {k}")
            counts = main_path(chain, k, label, first)
            launches.update({names[n]: c for n, c in counts.items()
                             if n in names})
            syms = random_symbols((CHANNELS, k), device, sentinels=True)
            for name, _, kern, plain, make_args, exact, _, _ in kernel_cases(
                    chain):
                if name not in names:
                    continue
                entry = names[name]
                args = make_args(syms if name != "fused_rx"
                                 else syms.clamp(0))
                got, want = kern(*args), plain(*args)
                torch.cuda.synchronize()
                real = syms >= 0
                if name == "fused_pulse_chain":  # -1: no decision
                    got, want = got[real], want[real]
                err = max_err(got, want)
                print(f"[long route] {entry} vs plain at {CHANNELS} x "
                      f"{k}: max |kernel - plain| = {err:.3e}"
                      f"{' (exact)' if exact else ''}", flush=True)
                if (exact and err != 0) or err > ATOL:
                    fail(f"long route {entry}: kernel and plain differ")
                errs[entry] = err
                ms, plain_ms, dev_ms = kernel_times(
                    kern, plain, args, device, dev_names[name],
                    plain_calls=2)
                if dev_ms is None:
                    fail(f"long route {entry}: the profile holds no launch "
                         "of the route's kernel")
                lib_ms, lib_txt = None, "no library call"
                if name in ("fused_rx_soft", "fused_tx"):
                    soft = name == "fused_rx_soft"
                    what, lib = (("conv1d", "K3 soft") if soft else
                                 ("conv_transpose1d (shaping only)", "K2"))
                    fn, fargs, lib_err = (rx_conv1d_yardstick if soft else
                                          tx_conv_yardstick)(args)
                    if lib_err > 1e-4:
                        fail(f"long route {entry}: {what} yardstick "
                             f"disagrees with {lib} ({lib_err})")
                    lib_ms = time_calls(fn, fargs, device)
                    lib_txt = (f"{what} {lib_ms:.4f} ms (max |err| vs {lib} "
                               f"{lib_err:.2e})")
                work = chain_work(chain, name, CHANNELS, k)
                times[entry] = (ms, plain_ms, dev_ms, lib_ms, work)
                print_times(entry, CHANNELS * k * sps, times[entry], card,
                            f"{lib_txt}; route "
                            f"{'first version' if first else 'core'}")
                if first or name not in first_kernels:
                    continue
                extras[entry] = {"first_version": first_beside(
                    name, entry, kern, args, dev_ms, work)}
                if name != "fused_pulse_chain" and k == LONG_SIZES[-1]:
                    extras[entry]["modes"] = modes_beside(
                        chain, name, entry, syms.clamp(0), k)
    return errs, launches, times, extras


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
    for k in (256, 257, 1000, 4096, FIR_FIRST_TAPS):
        run(fir_name(k), fir.FIR_KERNEL, dem(lowpass=windowed_lowpass(k)),
            lambda d, v, st: d.demodulate(v[:, 64:], st)[0], locked)
    # past the core's last count the path runs the first version
    launches[FIR_FIRST] = launches[fir_name(FIR_FIRST_TAPS)]
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


def tx_route_check(what: str, fn, args, device, short: bool = True,
                   calls: int = 20):
    """Fails unless ``calls`` calls of ``fn`` run K2's short route
    (``pulse_tx_core``) and not its long route (``pulse_tx_kernel``), or,
    with ``short=False``, the long route alone, as the profiler sees it
    (profiled again, up to three times, only where a profile lost every
    record: a profile of one short call can end before its record
    arrives)."""
    names = ("pulse_tx_core", "pulse_tx_kernel")
    route_check(f"K2 {what}", fn, args, device, "pulse_tx_",
                *(names if short else names[::-1]), calls)


def phase_tx_routes(chain, device) -> None:
    """Phase 36: K2's short route (``pulse_tx_core``, sps 8 and span 8)
    against its long route (the first version's body, which
    ``_tx_launch(..., host=None)`` takes at any shape) bit for bit, both
    against ``tx_plain`` within phase 23's bars, and each call's kernel by
    the profiler: every K2 mode of phase 23, the baseband f32 one and 1999
    Hz (more phases than the table, cosf and sinf a sample) with a
    sym_offset near 10^9, at 256 x 4096; the odd shapes TX_ODD (K = 1, 31
    and 257 at sps 8; sps 2, 4 and 16, the long route both ways) in f32,
    bf16, int16 and at 1700 and 1999 Hz; then ``StreamingFusedTx`` in
    ragged pushes equal to one ``tx_fused`` (baseband and int16 at sps 4,
    passband at sps 16), and one push of the flagship's stream and every
    link's ``tx_fused`` on the short route."""
    from modem_tpu_torch import Rates, StreamingFusedTx, presets
    from modem_tpu_torch.chain import PulseShapedChain
    from modem_tpu_torch.models.psk import QPSK
    from modem_tpu_torch.ops import txrx

    def both(what, args, spec):
        got = txrx.tx_kernel(*args)
        ref = txrx._tx_launch(*args, host=None)
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        if not all(torch.equal(g, r) for g, r in zip(got, ref)):
            fail(f"K2 routes: {what}: the short route differs from the long")
        err, _ = mode_compare(f"K2 routes: {what}", spec,
                              got if len(got) == 2 else got[0],
                              txrx.tx_plain(*args))
        tx_route_check(what, txrx.tx_kernel, args, device,
                       short=args[3:5] == (8, 8))
        return err

    far = {"carrier": (1999, REF_SR)}
    for name, kind, spec, _, _ in [("fused_tx", "tx", {}, None, None)] + \
            mode_cases() + [("fused_tx_passband_1999", "tx", far, None,
                             None)]:
        if kind != "tx":
            continue
        bps = MODE_QAM_BPS if "qam" in spec else 2
        syms = mode_symbols((CHANNELS, N_SYMBOLS), bps, device, SEED + 90)
        off = TX_FAR_OFFSET if spec is far else N_SYMBOLS
        err = both(name, mode_args("tx", spec, syms, off, 256, chain), spec)
        print(f"[tx routes] {name:22s} {CHANNELS} ch x {N_SYMBOLS} sym, "
              f"sym_offset {off}: short == long route, pulse_tx_core ran, "
              f"max |kernel - plain| = {err:.3e}", flush=True)
    stores = (("f32", (None, torch.float32)), ("bf16", (None, torch.bfloat16)),
              ("int16", (MODE_OUT_SCALE, torch.int16)))
    for sps, span, k in TX_ODD:
        tc = PulseShapedChain(QPSK(0.0, 1.0), Rates(1, sps),
                              span_symbols=span, device=device)
        syms = random_symbols((3, k), device, sentinels=k > 20)
        for tag, store in stores:
            args = (syms, tc.lut, tc.rrc, sps, span, None, None, 0, *store)
            both(f"sps {sps} span {span} K {k} {tag}", args,
                 {"store": store})
        for hz, off in ((1700, -16), (1999, TX_FAR_OFFSET)):
            args = (syms, tc.lut, tc.rrc, sps, span, None, (hz, REF_SR), off)
            err = both(f"sps {sps} span {span} K {k} at {hz} Hz", args,
                       {"carrier": (hz, REF_SR)})
        route = "short" if (sps, span) == (8, 8) else "long"
        print(f"[tx routes] sps {sps:2d} span {span:2d} K {k:3d}: short == "
              f"long route in f32, bf16, int16, at 1700 and 1999 Hz, the "
              f"{route} route ran, max |kernel - plain| {err:.3e}",
              flush=True)
    g = torch.Generator(device=device).manual_seed(SEED + 91)
    for sps, span, hz, scale in ((4, 6, None, None), (4, 6, None, 3000.0),
                                 (16, 4, 1700, None)):
        tc = PulseShapedChain(QPSK(0.0, 1.0), Rates(10000 // sps, 10000),
                              span_symbols=span, carrier_hz=hz, device=device)
        bits = torch.randint(0, 2, (CHANNELS, 2 * 1000), generator=g,
                             device=device, dtype=torch.int32)
        one = tc.tx_fused(bits, out_scale=scale)
        st = StreamingFusedTx(tc, (CHANNELS,), out_scale=scale)
        cuts = (0, 2, 66, 700, 1234, 2000)
        parts = [st.push(bits[:, a:b]) for a, b in zip(cuts, cuts[1:])]
        parts.append(st.flush())
        one = one if isinstance(one, tuple) else (one,)
        parts = [q if isinstance(q, tuple) else (q,) for q in parts]
        for r, o in enumerate(one):
            if not torch.equal(torch.cat([q[r] for q in parts], -1), o):
                fail(f"K2 routes: sps {sps} stream pushes differ from one "
                     "shot")
        print(f"[tx routes] StreamingFusedTx sps {sps} span {span}"
              f"{f' at {hz} Hz' if hz else ''}"
              f"{' int16' if scale else ''}: 5 ragged pushes and the flush "
              "== tx_fused", flush=True)
    bits = torch.randint(0, 2, (CHANNELS, 2 * (N_SYMBOLS // N_PUSH)),
                         generator=g, device=device, dtype=torch.int32)
    tx_route_check("a StreamingFusedTx push of the flagship",
                   lambda: StreamingFusedTx(chain, (CHANNELS,)).push(bits),
                   (), device)
    links = ("reference_link", "lte_like_turbo_link", "nr_like_control_link")
    for name in links:
        link = getattr(presets, name)(device=device)
        payload = torch.randint(0, 2, (LINK_FRAMES, link.payload_bits),
                                generator=g, device=device,
                                dtype=torch.int32)
        tx_route_check(f"{name}().tx_fused", link.tx_fused, (payload,),
                       device)
    print(f"[tx routes] a StreamingFusedTx push of the flagship and "
          f"{', '.join(links)} tx_fused at {LINK_FRAMES} frames ran "
          "pulse_tx_core", flush=True)


# ---- the LDPC-coded OFDM link ----

def ldpc_llrs(code, n_cw: int, eb_n0_db: float, device, seed: int):
    """``(data, llrs)``: ``n_cw`` codewords of random data through BPSK and
    AWGN at ``eb_n0_db``, drawn by a ``torch.Generator`` on ``device``."""
    g = torch.Generator(device=device).manual_seed(seed)
    data = torch.randint(0, 2, (n_cw, code.k), generator=g, device=device,
                         dtype=torch.int32)
    cw = code.encode(data)
    sigma2 = 1.0 / (2.0 * code.k / code.n * 10.0 ** (eb_n0_db / 10.0))
    y = 1.0 - 2.0 * cw.to(torch.float32) + math.sqrt(sigma2) * torch.randn(
        cw.shape, generator=g, device=device)
    return data, 2.0 * y / sigma2


def cuda_launches(fn, args, device) -> int:
    """CUDA kernels (and copies) one call of ``fn`` runs, by the profiler:
    the most of three profiles of one call each, each begun on an idle
    device (a profile now and then loses records)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    n = 0
    for _ in range(3):
        torch.cuda.synchronize(device)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn(*args)
            torch.cuda.synchronize(device)
        n = max(n, sum(e.count for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA))
    return n


def phase_ldpc(device) -> None:
    """Phase 37: ``QcLdpc().decode`` at bench_fec's 4096 codewords and 4.5
    dB, layered (float32 and bf16 messages, with and without early exit)
    and flooding, 20 iterations: the card's posteriors and decisions equal
    the CPU twin's on the same LLRs bit for bit."""
    from modem_tpu_torch.fec import QcLdpc

    code = QcLdpc()
    data, llr = ldpc_llrs(code, LDPC_CW, LDPC_EBN0_DB, device, SEED + 100)
    cpu = llr.cpu()
    for label, kw in LDPC_VARIANTS.items():
        got = code.posteriors(llr, iters=LDPC_ITERS, **kw)
        want = code.posteriors(cpu, iters=LDPC_ITERS, **kw)
        torch.cuda.synchronize(device)
        if torch.isnan(got).any() or not torch.equal(got.cpu(), want):
            fail(f"LDPC {label}: the card's posteriors differ from the CPU")
        errs = int(((got[:, :code.k] < 0).to(torch.int32) != data).sum())
        print(f"[ldpc] {label}: {LDPC_CW} codewords at {LDPC_EBN0_DB} dB, "
              f"{LDPC_ITERS} iterations: posteriors and decisions equal the "
              f"CPU twin's bit for bit; {errs} data-bit errors of "
              f"{data.numel()}", flush=True)


def ofdm_capture(modem, bits, device, seed: int, snr_db: float):
    """``tx_frame(bits)`` of each channel at its own offset in ``[0,
    OFDM_MAX_LAG)`` of a capture, rotated by a phase and a CFO of 0.3
    subcarriers, with AWGN at ``snr_db`` per complex sample. Returns
    ``(ci, cq, offsets)``."""
    g = torch.Generator(device=device).manual_seed(seed)
    wi, wq = modem.tx_frame(bits)
    c, n = wi.shape
    off = torch.randint(0, OFDM_MAX_LAG, (c,), generator=g, device=device)
    t = torch.arange(n, device=device, dtype=torch.float32)
    ph = 2.0 * math.pi * torch.rand((c, 1), generator=g, device=device)
    z = torch.complex(wi, wq) * torch.polar(
        torch.ones_like(wi), 0.3 * 2.0 * math.pi / modem.n_fft * t + ph)
    cap = torch.zeros((c, n + OFDM_MAX_LAG), dtype=z.dtype, device=device)
    idx = off[:, None] + torch.arange(n, device=device)
    cap.scatter_(1, idx, z)
    sigma = math.sqrt(float(torch.mean(wi * wi + wq * wq))
                      / (2.0 * 10.0 ** (snr_db / 10.0)))
    ci = cap.real + sigma * torch.randn(cap.shape, generator=g, device=device)
    cq = cap.imag + sigma * torch.randn(cap.shape, generator=g, device=device)
    return ci.contiguous(), cq.contiguous(), off


def burst_stream(link, n_frames: int, device, seed: int):
    """``n_frames`` frames of ``link`` in one stream with gaps of noise,
    the frames scaled, rotated and noisy at 25 dB. Returns ``(si, sq,
    payload, starts)``."""
    g = torch.Generator(device=device).manual_seed(seed)
    payload = torch.randint(0, 2, (n_frames, link.payload_bits), generator=g,
                            device=device, dtype=torch.int32)
    wi, wq = link.tx(payload)
    parts_i, parts_q, starts, pos = [], [], [], 0
    for f in range(n_frames + 1):
        gap = int(torch.randint(100, 900, (1,), generator=g, device=device))
        parts_i.append(0.01 * torch.randn(gap, generator=g, device=device))
        parts_q.append(0.01 * torch.randn(gap, generator=g, device=device))
        pos += gap
        if f == n_frames:
            break
        z = 0.9 * torch.complex(wi[f], wq[f]) * complex(math.cos(0.4 * f),
                                                         math.sin(0.4 * f))
        parts_i.append(z.real + 0.05 * torch.randn(z.shape, generator=g,
                                                   device=device))
        parts_q.append(z.imag + 0.05 * torch.randn(z.shape, generator=g,
                                                   device=device))
        starts.append(pos)
        pos += z.shape[-1]
    return torch.cat(parts_i), torch.cat(parts_q), payload, starts


def phase_ofdm(device) -> tuple[dict, dict]:
    """Phase 38: blind OFDM acquisition at bench_ofdm's block (256 channels
    x 64 symbols, max_lag 96): ``tx_frame``, then per-channel offsets, a
    phase, a CFO of 0.3 subcarriers and AWGN at 30 dB, then ``acquire``
    and ``acquire_soft``: every located start and every bit right, K4
    launched (counts set to 0 just before, read just after); K4 at 240
    taps against its plain version on the capture; ``burst_ofdm_receiver``
    over a stream of 4 wifi frames in noise, pushed in chunks: every frame
    found at its start and its payload decoded. Returns K4's error and
    launches."""
    from modem_tpu_torch import OfdmModem, Rates, make_scheme, presets
    from modem_tpu_torch.ops import fir

    modem = OfdmModem(make_scheme("qpsk", Rates(1250, 10000)), device=device)
    g = torch.Generator(device=device).manual_seed(SEED + 101)
    bits = torch.randint(0, 2, (CHANNELS, modem.bits_per_frame(OFDM_SYMBOLS)),
                         generator=g, device=device, dtype=torch.int32)
    ci, cq, off = ofdm_capture(modem, bits, device, SEED + 102,
                               OFDM_SNR_DB)
    reset_launches()
    got, rep = modem.acquire(ci, cq, OFDM_SYMBOLS, OFDM_MAX_LAG)
    launches = read_launches({OFDM_FIR: fir.FIR_KERNEL}, "OfdmModem.acquire",
                             "ofdm")
    llr, _ = modem.acquire_soft(ci, cq, OFDM_SYMBOLS, OFDM_MAX_LAG)
    starts_ok = torch.equal(rep["start"], off.to(torch.int32))
    bits_ok = torch.equal(got, bits) and torch.equal(
        (llr < 0).to(torch.int32), bits)
    print(f"[ofdm] acquire at {CHANNELS} ch x {OFDM_SYMBOLS} symbols, "
          f"{OFDM_SNR_DB} dB, CFO 0.3 bins, offsets in [0, {OFDM_MAX_LAG}): "
          f"starts {'all right' if starts_ok else 'WRONG'}, bits "
          f"{'all right' if bits_ok else 'WRONG'} (acquire and the hard "
          f"bits of acquire_soft); CFO estimate mean "
          f"{float(rep['cfo_rad_per_sample'].mean()):.6f} rad/sample "
          f"(sent {0.3 * 2 * math.pi / modem.n_fft:.6f})", flush=True)
    if not (starts_ok and bits_ok):
        fail("OfdmModem.acquire: a start or a bit is wrong")
    taps = torch.as_tensor(modem._preamble_i[::-1].copy(), device=device)
    head = ci[:, :OFDM_MAX_LAG + taps.shape[0] - 1].contiguous()
    st = torch.zeros((CHANNELS, taps.shape[0] - 1), device=device)
    err = max_err(fir.fir_kernel(head, taps, st), fir.fir_plain(head, taps,
                                                                 st))
    print(f"[ofdm] {OFDM_FIR} (K4 {fir.fir_route(240)} route) on the capture"
          f" head {tuple(head.shape)}: max |kernel - plain| {err:.3e} (tol "
          f"{ATOL})", flush=True)
    if err > ATOL:
        fail(f"{OFDM_FIR}: kernel vs plain max |err| {err}")

    link = presets.wifi_like_ofdm_link(device=device)
    si, sq, payload, starts = burst_stream(link, BURST_FRAMES, device,
                                           SEED + 103)
    rx = presets.burst_ofdm_receiver(device=device)
    reset_launches()
    frames = []
    for a in range(0, si.shape[-1], BURST_CHUNK):
        frames += rx.push(si[a:a + BURST_CHUNK], sq[a:a + BURST_CHUNK])
    frames += rx.flush()
    read_launches({OFDM_FIR: fir.FIR_KERNEL}, "burst_ofdm_receiver", "ofdm")
    found = [r["start"] for _, r in frames]
    modem_l = link.chain.modem
    n = modem_l.frame_len(link.n_symbols)
    ok_all = len(frames) == BURST_FRAMES
    if ok_all:
        fi = torch.stack([si[s:s + n] for s in found])
        fq = torch.stack([sq[s:s + n] for s in found])
        out, ok = link.rx((fi, fq), 0.05)
        ok_all = bool(ok.all()) and torch.equal(out, payload) and all(
            abs(a - b) <= 4 for a, b in zip(found, starts))
    print(f"[ofdm] burst_ofdm_receiver: {len(frames)} of {BURST_FRAMES} "
          f"frames found at {found} (sent at {starts}), in pushes of "
          f"{BURST_CHUNK} samples; payloads "
          f"{'decoded, every CRC true' if ok_all else 'WRONG'}", flush=True)
    if not ok_all:
        fail("burst_ofdm_receiver: a frame was missed or decoded wrong")
    return {OFDM_FIR: err}, launches


def phase_wifi_link(device) -> None:
    """Phase 39: ``wifi_like_ofdm_link()`` at bench_link's 256 frames (8
    codewords and 54 OFDM symbols a frame): ``tx`` -> AWGN at 8 dB from a
    ``torch.Generator`` -> ``rx``, and ``tx_fused`` -> ``rx_fused`` (the
    staged route: the OFDM chain has no fused forms), every payload back
    and every CRC true, the decode equal to the CPU twin's on the same
    LLRs; then the ``link`` CLI with ``--preset wifi_like_ofdm`` on the
    card for a few frames."""
    import io
    import numpy as np
    from modem_tpu_torch import presets
    from modem_tpu_torch.cli import link as cli
    from modem_tpu_torch.ops.channel import awgn

    link = presets.wifi_like_ofdm_link(device=device)
    g = torch.Generator(device=device).manual_seed(SEED + 104)
    payload = torch.randint(0, 2, (WIFI_FRAMES, link.payload_bits),
                            generator=g, device=device, dtype=torch.int32)
    for label, tx, rx in (("tx -> rx", link.tx, link.rx),
                          ("tx_fused -> rx_fused", link.tx_fused,
                           link.rx_fused)):
        i, q = tx(payload)
        p = float(torch.mean(i * i + q * q))
        nv = p / (2.0 * 10.0 ** (WIFI_SNR_DB / 10.0))
        wave = awgn(g, i, q, WIFI_SNR_DB, signal_power=p)
        out, ok = rx(wave, nv)
        good = torch.equal(out, payload) and bool(ok.all())
        print(f"[wifi] {label}: {WIFI_FRAMES} frames of {link.payload_bits} "
              f"payload bits at {WIFI_SNR_DB} dB: payload "
              f"{'exact' if good else 'WRONG'}, {int(ok.sum())} CRCs true",
              flush=True)
        if not good:
            fail(f"wifi_like_ofdm_link {label}")
    llr = link.chain.rx_soft(wave, link.n_symbols, noise_var=nv)
    cout, cok = presets.wifi_like_ofdm_link(device="cpu").decode(llr.cpu())
    if not (torch.equal(cout, out.cpu()) and torch.equal(cok, ok.cpu())):
        fail("wifi_like_ofdm_link: the card's decode differs from the CPU")
    print("[wifi] the decode of the last LLRs equals the CPU twin's",
          flush=True)

    bits = np.random.default_rng(SEED).integers(
        0, 2, WIFI_CLI_FRAMES * link.payload_bits)
    common = ["--preset", "wifi_like_ofdm", "--batch-frames", "2",
              "--device", str(device)]
    wave = io.BytesIO()
    rc = cli.run(cli.build_parser().parse_args(["tx", *common]),
                 "".join("01"[b] for b in bits).encode(), wave)
    out, err = io.BytesIO(), io.StringIO()
    rc_rx = cli.run(cli.build_parser().parse_args(
        ["rx", "--noise-var", "0.05", *common]), wave.getvalue(), out,
        stderr=err)
    got = np.array([int(c) for c in "".join(out.getvalue().decode().split())])
    n_ok = err.getvalue().count("frame: OK")
    print(f"[cli] link tx --preset wifi_like_ofdm ({WIFI_CLI_FRAMES} frames) "
          f"-> link rx: exit {rc}/{rc_rx}, {n_ok} OK verdicts, payload "
          f"{'equal' if np.array_equal(got, bits) else 'DIFFERENT'}",
          flush=True)
    if (rc, rc_rx, n_ok) != (0, 0, WIFI_CLI_FRAMES) or \
            not np.array_equal(got, bits):
        fail("link CLI pair for wifi_like_ofdm on the card")


def phase_wifi_times(device, card: str) -> dict:
    """Phase 40: K4 at 240 taps per call beside its plain version, the
    profiler's device time, the bound and its ``conv1d`` yardstick; wall
    time, device busy time and idle share per call of
    ``wifi_like_ofdm_link().tx`` and ``rx`` (256 frames), ``QcLdpc.decode``
    (4096 codewords, 20 layered iterations; and its CUDA launches a call),
    ``OfdmModem.acquire`` (256 x 64 symbols) and one
    ``OfdmStreamReceiver.push`` of a chunk holding one frame."""
    import torch.nn.functional as F
    from modem_tpu_torch import OfdmModem, OfdmStreamReceiver, Rates, \
        make_scheme, presets
    from modem_tpu_torch.fec import QcLdpc
    from modem_tpu_torch.ops import fir
    from modem_tpu_torch.ops.channel import awgn

    modem = OfdmModem(make_scheme("qpsk", Rates(1250, 10000)), device=device)
    g = torch.Generator(device=device).manual_seed(SEED + 105)
    bits = torch.randint(0, 2, (CHANNELS, modem.bits_per_frame(OFDM_SYMBOLS)),
                         generator=g, device=device, dtype=torch.int32)
    ci, cq, _ = ofdm_capture(modem, bits, device, SEED + 106, OFDM_SNR_DB)
    k = modem.preamble_len
    taps = torch.as_tensor(modem._preamble_i[::-1].copy(), device=device)
    n = OFDM_MAX_LAG + k - 1
    args = (ci[:, :n].contiguous(), taps,
            torch.zeros((CHANNELS, k - 1), device=device))
    xp = torch.cat([args[2], args[0]], dim=-1).unsqueeze(1)
    w = taps.flip(0).reshape(1, 1, k)
    lib_err = max_err(F.conv1d(xp, w).squeeze(1), fir.fir_kernel(*args))
    if lib_err > 1e-3:
        fail(f"conv1d yardstick disagrees with K4 at 240 taps ({lib_err})")
    ms, plain_ms, dev_ms = kernel_times(fir.fir_kernel, fir.fir_plain, args,
                                        device, fir_symbol(k), plain_calls=2)
    if dev_ms is None:
        fail(f"K4 at {k} taps: no {fir_symbol(k)} in the profile")
    lib_ms = time_calls(F.conv1d, (xp, w), device)
    work = (4 * (2 * CHANNELS * n + CHANNELS * (k - 1) + k),
            2 * k * CHANNELS * n)
    times = {OFDM_FIR: (ms, plain_ms, dev_ms, lib_ms, work)}
    print_times(f"{OFDM_FIR} ({k} taps, {fir.fir_route(k)})", CHANNELS * n,
                times[OFDM_FIR], card,
                f"conv1d {lib_ms:.4f} ms (max |err| vs K4 {lib_err:.2e})")

    link = presets.wifi_like_ofdm_link(device=device)
    payload = torch.randint(0, 2, (WIFI_FRAMES, link.payload_bits),
                            generator=g, device=device, dtype=torch.int32)
    i, q = link.tx(payload)
    p = float(torch.mean(i * i + q * q))
    nv = p / (2.0 * 10.0 ** (WIFI_SNR_DB / 10.0))
    wave = awgn(g, i, q, WIFI_SNR_DB, signal_power=p)
    code = QcLdpc()
    _, llr = ldpc_llrs(code, LDPC_CW, LDPC_EBN0_DB, device, SEED + 107)
    link_b = presets.burst_ofdm_receiver(device=device).modem
    si, sq, _, _ = burst_stream(link, 1, device, SEED + 108)
    for name, fn, fargs, what in (
            ("wifi_like_ofdm_link().tx", link.tx, (payload,),
             (WIFI_FRAMES * link.payload_bits, "payload bits")),
            ("wifi_like_ofdm_link().rx", link.rx, (wave, nv),
             (WIFI_FRAMES * link.payload_bits, "payload bits")),
            ("QcLdpc.decode (20 layered)",
             lambda x: code.decode(x, iters=LDPC_ITERS), (llr,),
             (LDPC_CW * code.k, "info bits")),
            ("OfdmModem.acquire", modem.acquire,
             (ci, cq, OFDM_SYMBOLS, OFDM_MAX_LAG),
             (ci.numel(), "samples")),
            ("OfdmStreamReceiver.push (1 frame)",
             lambda a, b: OfdmStreamReceiver(link_b, 54).push(a, b),
             (si, sq), (si.numel(), "samples"))):
        calls = 3 if "decode" in name or ".rx" in name else 10
        ms = time_calls(fn, fargs, device, calls=calls, reps=3)
        busy = device_busy_ms(fn, fargs, device, calls=calls)
        launches = cuda_launches(fn, fargs, device)
        count, unit = what
        print(f"[times] {name:34s} per call {ms:.4f} ms "
              f"({count / ms * 1e3:.4e} {unit}/s), device busy {busy:.4f} ms "
              f"(idle share {1 - busy / ms:.3f}), {launches} CUDA launches a "
              f"call, on {card}", flush=True)
    return times


# ---- blind single-carrier burst acquisition and BCH ----

def acq_taps(device) -> dict:
    """K4's taps on the acquisition path by count: the mild multipath
    channel's 4 (its real rail), the 3-ray channel's 13 and
    ``apply_static_delay``'s windowed sinc of 63 at mu 0.37."""
    from modem_tpu_torch.ops.impairments import sinc_delay_taps

    return {4: torch.tensor(ACQ_MILD[0], device=device),
            13: torch.tensor(ACQ_3RAY[0], dtype=torch.float32, device=device),
            63: torch.as_tensor(sinc_delay_taps(ACQ_MU), device=device)}


def burst_len(n_payload: int) -> int:
    """Samples of a burst of ``n_payload`` symbols from ``tx_burst``: the
    preamble, the payload and the chain's 8 flush symbols at sps 8."""
    return (len(ACQ_PRE) + n_payload + 8) * 8


def phase_acq_fir(device) -> dict:
    """Phase 41: K4 at the acquisition's tap counts (4, 13 and 63: the
    generic route, each ending in a partial chunk of 16 taps) against its
    plain version, unit-scale inputs: at the capture's shape (64 channels x
    the burst), at a small shape with carried state and on rows of 1, 5
    and 5001 samples; ragged pushes equal one shot. Returns the max
    |error| of each."""
    from modem_tpu_torch.ops import fir

    gen = torch.Generator(device=device).manual_seed(SEED + 110)
    errs = {}
    for k, taps in acq_taps(device).items():
        name = fir_name(k)
        if fir.fir_route(k) != "generic":
            fail(f"{name}: route {fir.fir_route(k)}, not the generic one")
        for shape in ((ACQ_CHANNELS, burst_len(ACQ_PAYLOAD)), (3, 5000),
                      *FIR_ROWS):
            args = fir_case(taps, shape, gen, device)
            got, want = fir.fir_kernel(*args), fir.fir_plain(*args)
            torch.cuda.synchronize(device)
            err = max_err(got, want)
            print(f"[acq fir] {name} ({k} taps, generic) {shape[0]:3d} ch x "
                  f"{shape[1]:5d} samples: max |kernel - plain| = "
                  f"{err:.3e} (tol {ATOL})", flush=True)
            if err > ATOL:
                fail(f"{name} at {shape}: kernel vs plain max |err| {err}")
            errs[name] = max(errs.get(name, 0.0), err)
        x = unit((4, FIR_PUSHES[-1]), gen, device)
        state, parts = None, []
        for a, b in zip(FIR_PUSHES[:-1], FIR_PUSHES[1:]):
            y, state = fir.fir_filter(x[:, a:b], taps, state)
            parts.append(y)
        torch.cuda.synchronize(device)
        if not torch.equal(torch.cat(parts, -1), fir.fir_filter(x, taps)[0]):
            fail(f"{name} in {len(parts)} pushes differs from one shot")
        print(f"[acq fir] {name} in {len(parts)} ragged pushes == one shot "
              "(exact)", flush=True)
    return errs


def acq_receiver(device, **kw):
    from modem_tpu_torch import AcquiringReceiver, Rates, qpsk_reference_chain

    chain = qpsk_reference_chain(Rates(1250, 10000), device=device)
    return AcquiringReceiver(chain, list(ACQ_PRE), max_lag=ACQ_MAX_LAG, **kw)


def acq_bits(channels: int, n_payload: int, g, device) -> torch.Tensor:
    return torch.randint(0, 2, (channels, 2 * n_payload), generator=g,
                         device=device, dtype=torch.int32)


def acq_capture(rxr, channels: int, n_payload: int, device, seed: int):
    """``(bits, i, q)``: a burst through bench_sync's impairment stack (a
    static delay of 0.37, 9 Hz with phase 1.3, gain 0.8, AWGN at 30 dB)."""
    from modem_tpu_torch.ops import impairments as imp
    from modem_tpu_torch.ops.channel import awgn

    g = torch.Generator(device=device).manual_seed(seed)
    bits = acq_bits(channels, n_payload, g, device)
    i, q = imp.apply_static_delay(*rxr.tx_burst(bits), ACQ_MU)
    i, q = imp.apply_cfo(i, q, ACQ_CFO_HZ, 10000, phase0=ACQ_PHASE)
    i, q = imp.apply_gain_phase(i, q, gain=ACQ_GAIN)
    i, q = awgn(g, i, q, ACQ_SNR_DB)
    return bits, i, q


def bit_errors(got, want) -> int:
    if got.shape != want.shape:
        fail(f"bits of shape {tuple(got.shape)}, sent {tuple(want.shape)}")
    return int((got != want).sum())


def circ_max(a, b, period: float) -> float:
    d = torch.remainder(a.double() - b.double(), period)
    return float(torch.minimum(d, period - d).max())


def phase_acquire(device) -> dict:
    """Phase 42: ``AcquiringReceiver`` at bench_sync's block (64 channels x
    512 payload symbols): ``tx_burst`` (K4 at 65 taps), the impairment stack
    (K4 at 63), ``rx`` (K4 at 65): every payload bit right, each step's K4
    launches counted from 0; ``acquire`` held against the CPU twin on the
    same capture; the options through the channels of tests/test_sync.py
    and test_agc_track.py. Returns the launches of K4's new counts."""
    from modem_tpu_torch.ops import fir, impairments as imp
    from modem_tpu_torch.ops.channel import awgn

    rxr = acq_receiver(device)
    g = torch.Generator(device=device).manual_seed(SEED + 111)
    bits = acq_bits(ACQ_CHANNELS, ACQ_PAYLOAD, g, device)
    counts = {}

    def count(what, fn, *args):
        reset_launches()
        out = fn(*args)
        counts.update(read_launches({what: fir.FIR_KERNEL}, what, "acq"))
        return out

    wave = count("tx_burst (65 taps)", rxr.tx_burst, bits)
    i, q = count("fir_filter_63", imp.apply_static_delay, *wave, ACQ_MU)
    i, q = imp.apply_cfo(i, q, ACQ_CFO_HZ, 10000, phase0=ACQ_PHASE)
    i, q = imp.apply_gain_phase(i, q, gain=ACQ_GAIN)
    i, q = awgn(g, i, q, ACQ_SNR_DB)
    out = count("rx (65 taps)", rxr.rx, i, q, ACQ_PAYLOAD)
    errs = bit_errors(out, bits)
    print(f"[acq] rx at {ACQ_CHANNELS} ch x {ACQ_PAYLOAD} payload symbols "
          f"through delay {ACQ_MU}, {ACQ_CFO_HZ} Hz, phase {ACQ_PHASE}, gain "
          f"{ACQ_GAIN}, {ACQ_SNR_DB} dB: {errs} bit errors of {bits.numel()}",
          flush=True)
    if errs:
        fail("AcquiringReceiver.rx: payload bits wrong")
    if counts["tx_burst (65 taps)"] != 2 or counts["rx (65 taps)"] != 2:
        fail(f"K4 at 65 taps: {counts}, not 2 and 2")

    (pi_, pq_), rep = rxr.acquire(i, q, ACQ_PAYLOAD)
    cpu = acq_receiver(torch.device("cpu"))
    (wi, wq), want = cpu.acquire(i.cpu(), q.cpu(), ACQ_PAYLOAD)
    diffs = {
        "timing": circ_max(rep["timing"].cpu(), want["timing"], 8.0),
        "cfo_rad_per_symbol": float((rep["cfo_rad_per_symbol"].cpu()
                                     - want["cfo_rad_per_symbol"]).abs()
                                    .max()),
        "phase": float((rep["phase"].cpu() - want["phase"]).abs().max()),
        "gain": float(((rep["gain"].cpu() - want["gain"]) / want["gain"])
                      .abs().max()),
        "points": max_err((pi_.cpu(), pq_.cpu()), (wi, wq))}
    bars = {"timing": 1e-3, "cfo_rad_per_symbol": 1e-5, "phase": 1e-4,
            "gain": 1e-4, "points": ACQ_ATOL_POINTS}
    lag_ok = torch.equal(rep["lag"].cpu(), want["lag"])
    print(f"[acq] acquire on the card vs the CPU twin: lag "
          f"{'equal' if lag_ok else 'DIFFERENT'}; max differences "
          f"{json.dumps(diffs)} (bars {json.dumps(bars)}); CFO mean "
          f"{float(rep['cfo_rad_per_symbol'].mean()):.6f} rad/symbol (sent "
          f"{2 * math.pi * ACQ_CFO_HZ * 8 / 10000:.6f}), gain mean "
          f"{float(rep['gain'].mean()):.5f}", flush=True)
    if not lag_ok or any(diffs[k] > bars[k] for k in bars):
        fail("AcquiringReceiver.acquire: the card differs from the CPU")

    launches = {"fir_filter_63": counts["fir_filter_63"]}
    cases = (
        ("mild multipath (4 taps)", "fir_filter_4", {}, ACQ_MILD, None, 256),
        ("eq_taps=7, track_block=16, 3-ray (13 taps), 35 dB",
         "fir_filter_13", {"eq_taps": 7, "track_block": 16}, ACQ_3RAY, 35.0,
         256),
        ("track_block=16, track_order=2, 6 Hz residual CFO", None,
         {"track_block": 16, "track_order": 2}, None, None, 512))
    for label, entry, kw, channel, snr, n_pay in cases:
        r = acq_receiver(device, **kw)
        b = acq_bits(ACQ_CHANNELS, n_pay, g, device)
        i, q = r.tx_burst(b)
        if channel is None:
            i, q = imp.apply_cfo(i, q, 6.0, 10000, phase0=0.7)
        else:
            taps = [torch.tensor(t, dtype=torch.float32, device=device)
                    for t in channel]
            i, q = count(entry, imp.multipath_fir, i, q, *taps)
            launches[entry] = counts[entry]
        if snr is not None:
            i, q = awgn(g, i, q, snr)
        errs = bit_errors(r.rx(i, q, n_pay), b)
        print(f"[acq] {label}: {ACQ_CHANNELS} ch x {n_pay} payload symbols, "
              f"{errs} bit errors", flush=True)
        if errs:
            fail(f"AcquiringReceiver ({label}): payload bits wrong")
    return launches


def slow_clock(x: torch.Tensor, ppm: float) -> torch.Tensor:
    """A slow receive clock: ``x(n / (1 + ppm*1e-6))`` by linear
    interpolation, the last sample held (as ``np.interp``)."""
    n = x.shape[-1]
    t = torch.arange(n, dtype=torch.float64, device=x.device) / (
        1.0 + ppm * 1e-6)
    i0 = torch.clamp(t.floor().long(), max=n - 1)
    i1 = torch.clamp(i0 + 1, max=n - 1)
    f = (t - i0).to(x.dtype)
    return x[..., i0] * (1.0 - f) + x[..., i1] * f


def sfo_capture(device, seed: int):
    """The 300 ppm capture of tests/test_sfo_track.py:84-100 at 64
    channels: a 4096-symbol payload, gain 0.8, phase 0.4, AWGN at 30 dB.
    Returns ``(receiver, bits, i, q)``."""
    from modem_tpu_torch.ops import impairments as imp
    from modem_tpu_torch.ops.channel import awgn

    rxr = acq_receiver(device, track_block=32, track_order=2)
    g = torch.Generator(device=device).manual_seed(seed)
    bits = acq_bits(ACQ_CHANNELS, SFO_PAYLOAD, g, device)
    i, q = (slow_clock(v, SFO_PPM) for v in rxr.tx_burst(bits))
    i, q = imp.apply_gain_phase(i, q, gain=0.8, phase=0.4)
    i, q = awgn(g, i, q, 30.0)
    return rxr, bits, i, q


def phase_long_streams(device) -> None:
    """Phase 43: ``sfo_track(block_len=4096, max_delay=32)`` on the 300 ppm
    capture then ``rx``: every bit right where the one-shot receiver fails;
    ``phase_track`` on a residual CFO; ``Agc.process`` in ragged pushes
    equal to one shot."""
    from modem_tpu_torch import sync
    from modem_tpu_torch.ops.agc import Agc

    rxr, bits, i, q = sfo_capture(device, SEED + 112)
    direct = bit_errors(rxr.rx(i, q, SFO_PAYLOAD), bits)
    ci, cq, rep = sync.sfo_track(i, q, 8, SFO_PAYLOAD, max_delay=32)
    errs = bit_errors(rxr.rx(ci, cq, SFO_PAYLOAD), bits)
    ppm = rep["sfo_ppm"]
    _, _, want = sync.sfo_track(i.cpu(), q.cpu(), 8, SFO_PAYLOAD,
                                max_delay=32)
    t0_diff = float((rep["t0_blocks"].cpu() - want["t0_blocks"]).abs().max())
    print(f"[long] sfo_track at {SFO_PPM} ppm, {ACQ_CHANNELS} ch x "
          f"{SFO_PAYLOAD} payload symbols: SFO estimate {float(ppm.min()):.2f}"
          f"-{float(ppm.max()):.2f} ppm, clipped {int(rep['clipped'].sum())}; "
          f"t0_blocks vs the CPU twin max |diff| {t0_diff:.2e} (bar 1e-3); "
          f"one-shot rx {direct} bit errors, after sfo_track {errs}",
          flush=True)
    if errs or direct <= 100 or t0_diff > 1e-3 or bool(rep["clipped"].any()):
        fail("sfo_track: the long stream is not rescued as it should be")

    g = torch.Generator(device=device).manual_seed(SEED + 113)
    n, slope = 8192, 8e-4
    k = torch.randint(0, 4, (ACQ_CHANNELS, n), generator=g, device=device)
    ang = (math.pi / 4 + k * (math.pi / 2) + 0.9
           + slope * torch.arange(n, device=device))
    di = torch.cos(ang) + 0.02 * torch.randn(ang.shape, generator=g,
                                             device=device)
    dq = torch.sin(ang) + 0.02 * torch.randn(ang.shape, generator=g,
                                             device=device)
    ci, cq, rep = sync.phase_track(di, dq, 4, 256)
    _, _, want = sync.phase_track(di.cpu(), dq.cpu(), 4, 256)
    est = rep["cfo_rad_per_sym"]
    diff = float((est.cpu() - want["cfo_rad_per_sym"]).abs().max())
    pb_diff = float((rep["phase_blocks"].cpu() - want["phase_blocks"]).abs()
                    .max())
    resid = torch.atan2(cq, ci) - (math.pi / 4 + k * (math.pi / 2))
    spread = float(torch.remainder(resid - resid[:, :1] + math.pi / 4,
                                   math.pi / 2).std(dim=-1).max())
    print(f"[long] phase_track at {slope} rad/symbol, {ACQ_CHANNELS} ch x "
          f"{n}: estimate {float(est.min()):.3e}-{float(est.max()):.3e}, vs "
          f"the CPU twin max |diff| {diff:.2e} (bar 1e-5), phase_blocks "
          f"{pb_diff:.2e} (bar 1e-4); residual spread {spread:.4f} rad",
          flush=True)
    if float((est - slope).abs().max()) > 5e-6 or diff > 1e-5 or \
            pb_diff > 1e-4 or spread > 0.05:
        fail("phase_track: residual CFO not removed")

    agc = Agc(loop_gain=0.2, sub_block=64)
    x = 0.1 * torch.randn((2, ACQ_CHANNELS, 64 * 60), generator=g,
                          device=device)
    (yi, yq), st = agc.process(x[0], x[1], agc.init_state((ACQ_CHANNELS,),
                                                          device))
    s2, parts = agc.init_state((ACQ_CHANNELS,), device), []
    for a, b in ((0, 64), (64, 64 * 9), (64 * 9, 64 * 10), (64 * 10, 64 * 60)):
        (pi_, pq_), s2 = agc.process(x[0][:, a:b], x[1][:, a:b], s2)
        parts.append((pi_, pq_))
    same = (torch.equal(torch.cat([p[0] for p in parts], -1), yi)
            and torch.equal(torch.cat([p[1] for p in parts], -1), yq)
            and torch.equal(s2, st))
    rms = (yi[:, -1024:] ** 2 + yq[:, -1024:] ** 2).mean(-1).sqrt()
    print(f"[long] Agc.process at {ACQ_CHANNELS} ch x {64 * 60}, 20 dB low: "
          f"4 ragged pushes {'== one shot' if same else 'DIFFER'}; tail RMS "
          f"{float(rms.min()):.4f}-{float(rms.max()):.4f}", flush=True)
    if not same or float((rms - 1.0).abs().max()) > 0.05:
        fail("Agc.process: pushes differ from one shot or no convergence")


def bch_words(code, n_err: int, g, device):
    """``(data, codewords, received)``: ``BCH_CW`` random messages encoded,
    ``n_err`` distinct bits of each codeword flipped."""
    data = torch.randint(0, 2, (BCH_CW, code.k), generator=g, device=device,
                         dtype=torch.int32)
    cw = code.encode(data)
    pos = torch.argsort(torch.rand(cw.shape, generator=g, device=device),
                        dim=-1)[:, :n_err]
    flips = torch.zeros_like(cw).scatter_(1, pos, 1)
    return data, cw, cw ^ flips


def phase_bch(device) -> None:
    """Phase 44: ``bch_255_191`` and ``bch_255_239`` at 2048 codewords:
    up to t errors every message right and every ``ok`` true; t + 1 errors
    decoded on the card exactly as the CPU twin decodes them; BCH(255, 191)
    over the flagship chain at -2 dB: every codeword within t raw errors
    decoded, the rest as the CPU twin decides them."""
    from modem_tpu_torch import Rates, qpsk_reference_chain
    from modem_tpu_torch.fec import bch_255_191, bch_255_239
    from modem_tpu_torch.ops.channel import awgn

    g = torch.Generator(device=device).manual_seed(SEED + 114)
    for code, n_err in ((bch_255_191(), BCH_ERRS), (bch_255_239(), 2)):
        for e in (n_err, code.t + 1):
            data, cw, recv = bch_words(code, e, g, device)
            msg, ok = code.decode(recv)
            cmsg, cok = code.decode(recv.cpu())
            twin = torch.equal(msg.cpu(), cmsg) and torch.equal(ok.cpu(), cok)
            right = int((msg == data).all(dim=-1).sum())
            print(f"[bch] BCH(255, {code.k}) t={code.t}, {BCH_CW} codewords "
                  f"with {e} errors: {right} messages right, {int(ok.sum())} "
                  f"ok; card {'==' if twin else '!='} CPU twin bit for bit",
                  flush=True)
            if not twin or (e <= code.t and (right, int(ok.sum()))
                            != (BCH_CW, BCH_CW)):
                fail(f"BCH(255, {code.k}) with {e} errors")

    code = bch_255_191()
    chain = qpsk_reference_chain(Rates(1250, 10000), device=device)
    data = torch.randint(0, 2, (BCH_CW, code.k), generator=g, device=device,
                         dtype=torch.int32)
    cw = code.encode(data)
    i, q = chain.tx(torch.cat([cw, torch.zeros_like(cw[:, :1])], -1))
    i, q = awgn(g, i, q, BCH_CHAIN_SNR_DB)
    hard = chain.rx((i, q), 128)[:, :code.n]
    raw = (hard != cw).sum(-1)
    msg, ok = code.decode(hard)
    cmsg, cok = code.decode(hard.cpu())
    within = raw <= code.t
    good = (msg == data).all(-1) & ok
    print(f"[bch] BCH(255, 191) over the flagship chain at "
          f"{BCH_CHAIN_SNR_DB} dB, {BCH_CW} codewords: {int(raw.sum())} raw "
          f"bit errors (max {int(raw.max())} in a codeword; "
          f"{int((~within).sum())} codewords past t); {int(good.sum())} "
          f"decoded exactly with ok, {int(good[within].sum())} of the "
          f"{int(within.sum())} within t; card == CPU twin: "
          f"{torch.equal(msg.cpu(), cmsg) and torch.equal(ok.cpu(), cok)}",
          flush=True)
    if not bool(good[within].all()) or not (
            torch.equal(msg.cpu(), cmsg) and torch.equal(ok.cpu(), cok)):
        fail("BCH(255, 191) over the flagship chain")


def phase_acq_times(device, card: str) -> dict:
    """Phase 45: K4 at 4, 13 and 63 taps per call at the capture's shape
    beside its plain version, the profiler's device time, the bound and
    ``conv1d``; wall time, device busy time, idle share and CUDA launches
    per call of ``AcquiringReceiver.rx`` (64 and 256 channels x 512 payload
    symbols), ``acquire`` with ``eq_taps=7, track_block=16``, ``sfo_track``
    on the 4096-symbol capture, and ``Bch.encode`` and ``decode`` at 2048
    codewords."""
    import torch.nn.functional as F
    from modem_tpu_torch import sync
    from modem_tpu_torch.fec import bch_255_191
    from modem_tpu_torch.ops import fir

    gen = torch.Generator(device=device).manual_seed(SEED + 115)
    times = {}
    rxr = acq_receiver(device)
    filters = acq_taps(device)
    filters[65] = rxr.chain.rrc
    for k, taps in filters.items():
        # the matched filter's input is the capture padded to acquire's
        # last candidate decision instant
        n = burst_len(ACQ_PAYLOAD) if k != 65 else (
            ACQ_MAX_LAG + (len(ACQ_PRE) + ACQ_PAYLOAD - 1) * 8 + 1)
        name = fir_name(k)
        args = fir_case(taps, (ACQ_CHANNELS, n), gen, device)
        x, t, state = args
        xp = torch.cat([state, x], dim=-1).unsqueeze(1)
        w = t.flip(0).reshape(1, 1, k)
        lib_err = max_err(F.conv1d(xp, w).squeeze(1), fir.fir_kernel(*args))
        if lib_err > 1e-3:
            fail(f"conv1d yardstick disagrees with K4 at {k} taps")
        ms, plain_ms, dev_ms = kernel_times(fir.fir_kernel, fir.fir_plain,
                                            args, device, fir_symbol(k))
        if dev_ms is None:
            fail(f"K4 at {k} taps: no {fir_symbol(k)} in the profile")
        lib_ms = time_calls(F.conv1d, (xp, w), device)
        lib_dev = device_busy_ms(F.conv1d, (xp, w), device)
        work = (4 * (2 * ACQ_CHANNELS * n + ACQ_CHANNELS * (k - 1) + k),
                2 * k * ACQ_CHANNELS * n)
        t_k = (ms, plain_ms, dev_ms, lib_ms, work)
        if k != 65:  # the 65-tap entry of the kernels line is phase 10's
            times[name] = t_k
        print_times(f"{name} ({k} taps, {fir.fir_route(k)})",
                    ACQ_CHANNELS * n, t_k, card,
                    f"conv1d {lib_ms:.4f} ms, its device busy {lib_dev:.4f} "
                    f"ms (max |err| vs K4 {lib_err:.2e})")

    _, i, q = acq_capture(rxr, ACQ_CHANNELS, ACQ_PAYLOAD, device, SEED + 116)
    _, wi, wq = acq_capture(rxr, ACQ_WIDE, ACQ_PAYLOAD, device, SEED + 117)
    eq = acq_receiver(device, eq_taps=7, track_block=16)
    sfo_rx, _, si, sq = sfo_capture(device, SEED + 118)
    code = bch_255_191()
    data, _, recv = bch_words(code, BCH_ERRS, gen, device)
    for name, fn, fargs, what in (
            (f"AcquiringReceiver.rx, {ACQ_CHANNELS} ch", rxr.rx,
             (i, q, ACQ_PAYLOAD), (i.numel(), "samples")),
            (f"AcquiringReceiver.rx, {ACQ_WIDE} ch", rxr.rx,
             (wi, wq, ACQ_PAYLOAD), (wi.numel(), "samples")),
            ("acquire, eq_taps=7, track_block=16", eq.acquire,
             (i, q, ACQ_PAYLOAD), (i.numel(), "samples")),
            (f"sfo_track, {ACQ_CHANNELS} ch x {SFO_PAYLOAD} sym",
             lambda a, b: sync.sfo_track(a, b, 8, SFO_PAYLOAD, max_delay=32),
             (si, sq), (si.numel(), "samples")),
            (f"Bch(t=8).encode, {BCH_CW} codewords", code.encode, (data,),
             (data.numel(), "info bits")),
            (f"Bch(t=8).decode, {BCH_CW} codewords", code.decode, (recv,),
             (data.numel(), "info bits"))):
        ms = time_calls(fn, fargs, device, calls=5, reps=3)
        busy = device_busy_ms(fn, fargs, device, calls=5)
        launches = cuda_launches(fn, fargs, device)
        count, unit_ = what
        rate = (f"{count / ms / 1e3:.2f} Mbit/s" if "bits" in unit_ else
                f"{count / ms * 1e3:.4e} {unit_}/s")
        print(f"[times] {name:40s} per call {ms:.4f} ms ({rate}), device "
              f"busy {busy:.4f} ms (idle share {1 - busy / ms:.3f}), "
              f"{launches} CUDA launches a call, on {card}", flush=True)
    return times


# ---- SC-FDE, Alamouti STBC, MIMO and bit loading ----

class pytorch_defaults:
    """PyTorch's default math settings (TF32 off for matmuls, on for cuDNN)
    for the ``with`` block, the script's own restored after it: the new
    PHYs' DFTs and small-matrix products must be right as a user runs
    them."""

    def __init__(self, phases: str = "46-49"):
        self.phases = phases

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = True
        print("[phy] PyTorch's default math settings for phases "
              f"{self.phases}: matmul TF32 "
              f"{torch.backends.cuda.matmul.allow_tf32}, cuDNN "
              f"TF32 {torch.backends.cudnn.allow_tf32}", flush=True)

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.saved


def channel_taps(ch, device):
    return [torch.tensor(t, dtype=torch.float32, device=device) for t in ch]


def scfde_modem(device):
    from modem_tpu_torch import Rates, ScFdeModem, make_scheme

    return ScFdeModem(make_scheme("qpsk", Rates(1250, 10000)), device=device)


def scfde_capture(modem, bits, device, seed: int):
    """``tx_frame(bits)`` of each channel at its own offset in ``[0,
    SCFDE_MAX_LAG)``, with a gain of 1.3, a phase per channel, a CFO of
    0.3/sym_len cycles/sample and AWGN at 40 dB. Returns ``(ci, cq,
    offsets, noise_var)``."""
    from modem_tpu_torch.ops.channel import awgn

    g = torch.Generator(device=device).manual_seed(seed)
    wi, wq = modem.tx_frame(bits)
    c, n = wi.shape
    off = torch.randint(0, SCFDE_MAX_LAG, (c,), generator=g, device=device)
    cap = torch.zeros((c, n + SCFDE_MAX_LAG), dtype=torch.complex64,
                      device=device)
    idx = off[:, None] + torch.arange(n, device=device)
    cap.scatter_(1, idx, torch.complex(wi, wq))
    t = torch.arange(cap.shape[-1], device=device, dtype=torch.float32)
    ph = 2.0 * math.pi * torch.rand((c, 1), generator=g, device=device)
    z = 1.3 * cap * torch.polar(torch.ones_like(cap.real),
                                2.0 * math.pi * SCFDE_CFO * t + ph)
    p = 1.3 ** 2 * float(torch.mean(wi * wi + wq * wq))
    ci, cq = awgn(g, z.real.contiguous(), z.imag.contiguous(),
                  SCFDE_ACQ_SNR_DB, signal_power=p)
    return ci, cq, off, p / 10.0 ** (SCFDE_ACQ_SNR_DB / 10.0)


def phase_scfde(device) -> tuple[dict, dict]:
    """Phase 46: SC-FDE at bench_scfde's block (QPSK, 256 channels x 64
    blocks): ``tx_frame``, the deep-null channel (K4 at 4 taps) and AWGN at
    30 dB, then ``rx_frame`` and ``rx_soft_frame``: every bit right, the
    decision points and LLRs against the CPU twin's; blind ``acquire`` at
    max_lag 128 under per-channel offsets, a gain, phases, a CFO and AWGN at
    40 dB: every start and bit right, K4 at 160 taps launched (counts set
    to 0 just before, read just after) and held against its plain version
    on the capture; ``OfdmStreamReceiver`` over a stream of SC-FDE frames with
    gaps of noise, in chunks: every frame found and decoded. Returns K4's
    error and launches at 160 taps."""
    from modem_tpu_torch import OfdmStreamReceiver
    from modem_tpu_torch.ops import fir, impairments as imp
    from modem_tpu_torch.ops.channel import awgn

    modem, cpu = scfde_modem(device), scfde_modem("cpu")
    g = torch.Generator(device=device).manual_seed(SEED + 120)
    bits = torch.randint(0, 2, (CHANNELS, modem.bits_per_frame(SCFDE_BLOCKS)),
                         generator=g, device=device, dtype=torch.int32)
    wi, wq = modem.tx_frame(bits)
    ci, cq = imp.multipath_fir(wi, wq, *channel_taps(SCFDE_CH, device))
    p = float(torch.mean(wi * wi + wq * wq))
    ci, cq = awgn(g, ci, cq, SCFDE_SNR_DB, signal_power=p)
    nv = p / 10.0 ** (SCFDE_SNR_DB / 10.0)
    hard = modem.rx_frame(ci, cq, SCFDE_BLOCKS, nv)
    llr = modem.rx_soft_frame(ci, cq, SCFDE_BLOCKS, nv)
    pre = modem.preamble_len
    pts = modem._equalize(ci[:, pre:], cq[:, pre:], SCFDE_BLOCKS,
                          modem.estimate_channel(ci[:, :pre], cq[:, :pre]),
                          nv)[:2]
    c_i, c_q = ci.cpu(), cq.cpu()
    want_pts = cpu._equalize(c_i[:, pre:], c_q[:, pre:], SCFDE_BLOCKS,
                             cpu.estimate_channel(c_i[:, :pre], c_q[:, :pre]),
                             nv)[:2]
    want_llr = cpu.rx_soft_frame(c_i, c_q, SCFDE_BLOCKS, nv)
    errs = bit_errors(hard, bits) + bit_errors((llr < 0).to(torch.int32),
                                               bits)
    d_pts = max_err(tuple(x.cpu() for x in pts), want_pts)
    d_llr = float((llr.cpu() - want_llr).abs().max()
                  / want_llr.abs().max())
    print(f"[scfde] rx_frame and rx_soft_frame at {CHANNELS} ch x "
          f"{SCFDE_BLOCKS} blocks through the deep-null channel at "
          f"{SCFDE_SNR_DB} dB: {errs} bit errors of {2 * bits.numel()}; vs "
          f"the CPU twin: decision points max |d| {d_pts:.3e} (bar 1e-4), "
          f"LLRs {d_llr:.3e} of their largest (bar 1e-4)", flush=True)
    if errs or d_pts > 1e-4 or d_llr > 1e-4:
        fail("ScFdeModem.rx_frame / rx_soft_frame")

    ci, cq, off, nv = scfde_capture(modem, bits, device, SEED + 121)
    reset_launches()
    got, rep = modem.acquire(ci, cq, SCFDE_BLOCKS, SCFDE_MAX_LAG, nv)
    launches = read_launches({SCFDE_FIR: fir.FIR_KERNEL},
                             "ScFdeModem.acquire", "scfde")
    starts_ok = torch.equal(rep["start"], off.to(torch.int32))
    errs = bit_errors(got, bits)
    print(f"[scfde] acquire at {CHANNELS} ch x {SCFDE_BLOCKS} blocks, "
          f"offsets in [0, {SCFDE_MAX_LAG}), gain 1.3, CFO "
          f"{SCFDE_CFO:.6f} cycles/sample, {SCFDE_ACQ_SNR_DB} dB: starts "
          f"{'all right' if starts_ok else 'WRONG'}"
          f", {errs} bit errors; CFO estimate mean "
          f"{float(rep['cfo_rad_per_sample'].mean()):.6f} rad/sample (sent "
          f"{2 * math.pi * SCFDE_CFO:.6f})", flush=True)
    if not starts_ok or errs:
        fail("ScFdeModem.acquire: a start or a bit is wrong")
    if launches[SCFDE_FIR] != 4:
        fail(f"K4 at 160 taps: {launches[SCFDE_FIR]} launches, not 4")
    taps = torch.as_tensor(modem._preamble_i[::-1].copy(), device=device)
    head = ci[:, :SCFDE_MAX_LAG + taps.shape[0] - 1].contiguous()
    st = torch.zeros((CHANNELS, taps.shape[0] - 1), device=device)
    want = fir.fir_plain(head, taps, st)
    err = max_err(fir.fir_kernel(head, taps, st), want)
    peak = float(want.abs().max())
    print(f"[scfde] {SCFDE_FIR} (K4 {fir.fir_route(160)} route) on the "
          f"capture head {tuple(head.shape)}: max |kernel - plain| "
          f"{err:.3e}, {err / peak:.3e} of the output's largest magnitude "
          f"{peak:.2f} (bar {SCFDE_FIR_RTOL}: the correlation of "
          f"unit-amplitude samples with the unit-modulus preamble peaks near "
          f"the tap count)", flush=True)
    if err > SCFDE_FIR_RTOL * peak:
        fail(f"{SCFDE_FIR}: kernel vs plain max |err| {err}")

    sb = torch.randint(0, 2, (SCFDE_STREAM_FRAMES, bits.shape[-1]),
                       generator=g, device=device, dtype=torch.int32)
    fi, fq = modem.tx_frame(sb)
    parts_i, parts_q, starts, pos = [], [], [], 0
    for f in range(SCFDE_STREAM_FRAMES + 1):
        gap = int(torch.randint(100, 900, (1,), generator=g, device=device))
        parts_i.append(0.03 * torch.randn(gap, generator=g, device=device))
        parts_q.append(0.03 * torch.randn(gap, generator=g, device=device))
        pos += gap
        if f == SCFDE_STREAM_FRAMES:
            break
        z = torch.complex(fi[f], fq[f]) * complex(math.cos(0.5 * f),
                                                  math.sin(0.5 * f))
        parts_i += [z.real]
        parts_q += [z.imag]
        starts.append(pos)
        pos += z.shape[-1]
    si, sq = torch.cat(parts_i), torch.cat(parts_q)
    rx = OfdmStreamReceiver(modem, SCFDE_BLOCKS)
    reset_launches()
    frames = []
    for a in range(0, si.shape[-1], SCFDE_STREAM_CHUNK):
        frames += rx.push(si[a:a + SCFDE_STREAM_CHUNK],
                          sq[a:a + SCFDE_STREAM_CHUNK])
    frames += rx.flush()
    read_launches({SCFDE_FIR: fir.FIR_KERNEL}, "OfdmStreamReceiver (SC-FDE)",
                  "scfde")
    found = [r["start"] for _, r in frames]
    ok = len(frames) == SCFDE_STREAM_FRAMES and all(
        torch.equal(b, w) for (b, _), w in zip(frames, sb)) and all(
        abs(a - b) <= 4 for a, b in zip(found, starts))
    print(f"[scfde] OfdmStreamReceiver over SC-FDE frames: {len(frames)} of "
          f"{SCFDE_STREAM_FRAMES} found at {found} (sent at {starts}), in "
          f"pushes of {SCFDE_STREAM_CHUNK} samples; bits "
          f"{'all right' if ok else 'WRONG'}", flush=True)
    if not ok:
        fail("OfdmStreamReceiver over SC-FDE: a frame missed or wrong")
    return {SCFDE_FIR: err}, launches


def conv_link_run(link, frames: int, channel, snr_db: float, seed: int,
                  device, tag: str, per_rail: bool = False) -> dict:
    """``tx`` -> ``channel`` (a list of (taps_i, taps_q) or None) -> AWGN at
    ``snr_db`` -> ``rx`` for ``frames`` payloads, every launch count set to
    0 just before the receive: every payload back with its CRC true, K13
    launched; then K13 bit for bit against its plain version on the run's
    own deinterleaved LLRs. ``per_rail``: the noise variance the receiver
    takes is the per-rail one (OFDM), not the per-complex-sample one."""
    from modem_tpu_torch.fec import block_deinterleave
    from modem_tpu_torch.ops import impairments as imp, viterbi_kernel as vk
    from modem_tpu_torch.ops.channel import awgn

    g = torch.Generator(device=device).manual_seed(seed)
    pay = torch.randint(0, 2, (frames, link.payload_bits), generator=g,
                        device=device, dtype=torch.int32)
    i, q = link.tx(pay)
    p = float(torch.mean(i * i + q * q))
    if channel is not None:
        i, q = imp.multipath_fir(i, q, *channel_taps(channel, device))
    i, q = awgn(g, i, q, snr_db, signal_power=p)
    nv = p / 10.0 ** (snr_db / 10.0) / (2.0 if per_rail else 1.0)
    reset_launches()
    out, ok = link.rx((i, q), nv)
    counts = read_launches({VIT_REPORT[0]: vk.VITERBI_KERNEL}, tag, "phy")
    errors = int((out != pay).sum())
    print(f"[phy] {tag}: {frames} frames x {link.payload_bits} payload bits "
          f"({link._steps} trellis steps, window {link.conv_window}) at "
          f"{snr_db} dB: {errors} payload bit errors, {int(ok.sum())}/"
          f"{frames} CRCs true", flush=True)
    if errors or not bool(ok.all()):
        fail(f"{tag}: {errors} errors, {int(ok.sum())} CRCs")
    llr = link.chain.rx_soft((i, q), link.n_symbols, noise_var=nv)
    lam = block_deinterleave(llr, link.rows).reshape(frames, -1,
                                                     link.conv.n)
    stream = (link.conv, lam, link.conv_window, 10 * link.conv.k, 1e6)
    err = max_err(vk.stream_kernel(*stream), vk.stream_plain(*stream))
    print(f"[phy] {tag}: K13 on the run's own LLRs {tuple(lam.shape)}: max "
          f"|kernel - plain| = {err:.3e} (exact)", flush=True)
    if err:
        fail(f"{tag}: K13 and its plain version differ")
    return counts


def phase_scfde_link(device) -> None:
    """Phase 47: the conv-coded ``FramedLink`` over ``ScFdeChain`` at 1002
    payload bits (1024 trellis steps: K13's windowed route, windows of 512
    set explicitly; 16 SC-FDE blocks a frame), 256 frames through the
    deep-null channel at 10 dB: every payload back, every CRC true, K13
    launched and held bit for bit against its plain version."""
    from modem_tpu_torch import FramedLink, ScFdeChain

    link = FramedLink(ScFdeChain(scfde_modem(device)),
                      payload_bits=CONV_LINK_PAYLOAD, interleave_rows=8,
                      conv_window=512)
    conv_link_run(link, SCFDE_LINK_FRAMES, SCFDE_CH, SCFDE_LINK_SNR_DB,
                  SEED + 122, device, "FramedLink over ScFdeChain")


def rand_channel(nr: int, nt: int, seed: int, taps: int = 5) -> dict:
    """tests/test_mimo_n.py's well-conditioned random matrix channel."""
    import numpy as np

    rng = np.random.default_rng(seed)
    ch = {}
    for r in range(nr):
        for a in range(nt):
            hi = rng.normal(0, 0.08, taps).astype(np.float32)
            hq = rng.normal(0, 0.08, taps).astype(np.float32)
            hi[0] += 0.9 if r == a else 0.3
            ch[(r, a)] = (tuple(hi.tolist()), tuple(hq.tolist()))
    return ch


def mix_antennas(waves, ch, nr: int, device):
    """Receive antenna r: the sum over transmit antennas a of ``waves[a]``
    through ``ch[(r, a)]`` (K4 at its tap count). Returns ``[(i, q)] *
    nr``."""
    from modem_tpu_torch.ops import impairments as imp

    out = []
    for r in range(nr):
        parts = [imp.multipath_fir(*w, *channel_taps(ch[(r, a)], device))
                 for a, w in enumerate(waves)]
        out.append((sum(x[0] for x in parts), sum(x[1] for x in parts)))
    return out


def phase_stbc_mimo(device) -> None:
    """Phase 48: ``AlamoutiOfdm(qpsk)`` at 256 channels x 32 pairs through
    test_stbc.py's two dispersive channels at 30 dB, every bit right; its
    LDPC-framed link (26 codewords in 81 pairs) at 256 frames and 14 dB,
    every payload and CRC; ``mimo_ofdm_link()`` at 256 frames through the
    cross-coupled flat 2x2 channel at 16 dB, every payload and CRC, and at
    12 dB (where the JAX preset loses frames too), the decode equal to the
    CPU twin's; ``MimoOfdmN(nt=4)`` at 256 channels x 16 slots through
    test_mimo_n.py's random 4x4 channels: ZF noiseless (QPSK) and MMSE at
    45 dB (16-QAM) exact, and with MMSE at 30 dB (QPSK) each one's decision
    points within 1e-4 of the CPU twin's; ``_cinv_h`` on the card at the
    detector's shape against float64 ``np.linalg.inv``."""
    import numpy as np
    from modem_tpu_torch import (AlamoutiOfdm, FramedLink, MimoOfdmN, Rates,
                                 make_scheme, presets)
    from modem_tpu_torch.fec import QcLdpc
    from modem_tpu_torch.mimo import _cinv_h
    from modem_tpu_torch.ops.channel import awgn

    r = Rates(1250, 10000)
    g = torch.Generator(device=device).manual_seed(SEED + 123)
    st = AlamoutiOfdm(make_scheme("qpsk", r), device=device)
    bits = torch.randint(0, 2, (CHANNELS, st.bits_per_frame(STBC_PAIRS)),
                         generator=g, device=device, dtype=torch.int32)
    wa, wb = st.tx(bits)
    (ci, cq), = mix_antennas((wa, wb), {(0, 0): STBC_CH_A,
                                        (0, 1): STBC_CH_B}, 1, device)
    ci, cq = awgn(g, ci, cq, STBC_SNR_DB)
    errs = bit_errors(st.rx(ci, cq, STBC_PAIRS), bits)
    print(f"[stbc] AlamoutiOfdm(qpsk) {CHANNELS} ch x {STBC_PAIRS} pairs "
          f"through two dispersive channels at {STBC_SNR_DB} dB: {errs} bit "
          f"errors of {bits.numel()}", flush=True)
    if errs:
        fail("AlamoutiOfdm.rx: bits wrong")

    link = FramedLink(st.as_link_chain(), payload_bits=26 * 324 - 16,
                      ldpc=QcLdpc(), ldpc_iters=40, interleave_rows=16,
                      ldpc_early_exit=True)
    pay = torch.randint(0, 2, (MIMO_FRAMES, link.payload_bits), generator=g,
                        device=device, dtype=torch.int32)
    wa, wb = link.tx(pay)
    p = float(torch.mean(wa[0] ** 2 + wa[1] ** 2))
    (ci, cq), = mix_antennas((wa, wb), {(0, 0): STBC_CH_A,
                                        (0, 1): STBC_CH_B}, 1, device)
    ci, cq = awgn(g, ci, cq, STBC_LINK_SNR_DB, signal_power=2 * p)
    out, ok = link.rx((ci, cq), 2 * p / 10.0 ** (STBC_LINK_SNR_DB / 10.0)
                      / 2.0)
    errs = int((out != pay).sum())
    print(f"[stbc] LDPC-framed link over Alamouti: {MIMO_FRAMES} frames x "
          f"{link.payload_bits} payload bits at {STBC_LINK_SNR_DB} dB: "
          f"{errs} payload bit errors, {int(ok.sum())} CRCs true", flush=True)
    if errs or not bool(ok.all()):
        fail("LDPC link over AlamoutiOfdm")

    link = presets.mimo_ofdm_link(device=device)
    cpu_link = presets.mimo_ofdm_link(device="cpu")
    pay = torch.randint(0, 2, (MIMO_FRAMES, link.payload_bits), generator=g,
                        device=device, dtype=torch.int32)
    (ia, qa), (ib, qb) = link.tx(pay)
    za, zb = torch.complex(ia, qa), torch.complex(ib, qb)
    for snr in (MIMO_EXACT_SNR_DB, MIMO_SNR_DB):
        y = []
        for ga, pa, gb, pb in MIMO_FLAT:
            z = (ga * complex(math.cos(pa), math.sin(pa)) * za
                 + gb * complex(math.cos(pb), math.sin(pb)) * zb)
            y += awgn(g, z.real.contiguous(), z.imag.contiguous(), snr)
        nv = float(torch.mean(y[0] ** 2 + y[1] ** 2)) / 10.0 ** (snr / 10.0)
        out, ok = link.rx(tuple(y), nv)
        llr = link.chain.rx_soft(tuple(y), link.n_symbols, noise_var=nv)
        cout, cok = cpu_link.decode(llr.cpu())
        errs = int((out != pay).sum())
        twin = torch.equal(cout, out.cpu()) and torch.equal(cok, ok.cpu())
        print(f"[mimo] mimo_ofdm_link(): {MIMO_FRAMES} frames x "
              f"{link.payload_bits} payload bits (81 slots) through the "
              f"cross-coupled 2x2 channel at {snr} dB: {errs} payload bit "
              f"errors, {int(ok.sum())} CRCs true; the decode "
              f"{'equals' if twin else 'DIFFERS FROM'} the CPU twin's",
              flush=True)
        if not twin or (snr == MIMO_EXACT_SNR_DB
                        and (errs or not bool(ok.all()))):
            fail(f"mimo_ofdm_link at {snr} dB")

    results = {}
    for label, scheme, seed, snr in (
            ("ZF noiseless", "qpsk", 0, None),
            (f"MMSE at {MIMON_EXACT_SNR_DB} dB", "qam16", 1,
             MIMON_EXACT_SNR_DB),
            (f"MMSE at {MIMON_SNR_DB} dB", "qpsk", 0, MIMON_SNR_DB)):
        mm = MimoOfdmN(make_scheme(scheme, r), nt=MIMON_NT, device=device)
        bits = torch.randint(0, 2, (CHANNELS,
                                    mm.bits_per_frame(MIMON_SYMBOLS)),
                             generator=g, device=device, dtype=torch.int32)
        ti, tq = mm.tx(bits)
        rx = mix_antennas([(ti[:, a], tq[:, a]) for a in range(MIMON_NT)],
                          rand_channel(MIMON_NT, MIMON_NT, seed), MIMON_NT,
                          device)
        yi = torch.stack([x[0] for x in rx], -2)
        yq = torch.stack([x[1] for x in rx], -2)
        nv = 0.0
        if snr is not None:
            p = float(torch.mean(yi * yi + yq * yq))
            yi, yq = awgn(g, yi, yq, snr, signal_power=p)
            nv = p / 10.0 ** (snr / 10.0)
        out = mm.rx_frame(yi, yq, MIMON_SYMBOLS, noise_var=nv)
        cpu = MimoOfdmN(make_scheme(scheme, r), nt=MIMON_NT, device="cpu")
        d = max_err(tuple(x.cpu() for x in mm.detect(yi, yq, MIMON_SYMBOLS,
                                                    nv)[:2]),
                    cpu.detect(yi.cpu(), yq.cpu(), MIMON_SYMBOLS, nv)[:2])
        results[label] = (bit_errors(out, bits), bits.numel(), d)
    print(f"[mimo] MimoOfdmN(nt={MIMON_NT}) {CHANNELS} ch x {MIMON_SYMBOLS} "
          f"slots through test_mimo_n's random {MIMON_NT}x{MIMON_NT} "
          f"channels, (bit errors, bits, max |decision points - the CPU "
          f"twin's|, bar 1e-4): {json.dumps(results)}", flush=True)
    if any(e for e, _, _ in list(results.values())[:2]) or any(
            d > 1e-4 for _, _, d in results.values()):
        fail("MimoOfdmN.rx_frame: bits wrong or the card differs from the "
             "CPU twin")
    rng = np.random.default_rng(SEED + 124)
    n = MIMON_NT
    b = (rng.normal(0, 1, (CHANNELS * 52, n, n))
         + 1j * rng.normal(0, 1, (CHANNELS * 52, n, n)))
    a = np.einsum("bij,bkj->bik", b, b.conj()) + np.eye(n)
    got = _cinv_h(tuple(torch.as_tensor(x, dtype=torch.float32,
                                        device=device)
                        for x in (a.real, a.imag)), n)
    want = np.linalg.inv(a)
    bad = [not np.allclose(x.cpu().numpy(), w, rtol=2e-3, atol=2e-4)
           for x, w in zip(got, (want.real, want.imag))]
    d = max(float(np.abs(x.cpu().numpy() - w).max())
            for x, w in zip(got, (want.real, want.imag)))
    print(f"[mimo] _cinv_h on the card, {a.shape[0]} Hermitian PD {n}x{n}: "
          f"max |d| against float64 np.linalg.inv {d:.3e} (rtol 2e-3, atol "
          f"2e-4: {'within' if not any(bad) else 'OUTSIDE'})", flush=True)
    if any(bad):
        fail("_cinv_h on the card")


def loading_snr_db(floor_db: float):
    """Per-data-bin SNR (dB) of test_bitloading.py's selective channel at a
    noise floor ``floor_db`` (per complex sample, unit power)."""
    import numpy as np
    from modem_tpu_torch.ofdm import _default_grid

    hi, hq = (np.asarray(t) for t in LOAD_CH)
    k = np.asarray(_default_grid(64)[0], np.float64)
    h = np.sum((hi + 1j * hq) * np.exp(-2j * np.pi * np.arange(len(hi))
                                       * k[:, None] / 64), axis=-1)
    return floor_db + 20.0 * np.log10(np.abs(h))


def loaded_modem(device):
    from modem_tpu_torch import AdaptiveOfdm, bit_loading

    return AdaptiveOfdm(bit_loading(loading_snr_db(LOAD_FLOOR_DB),
                                    gap_db=LOAD_GAP_DB,
                                    max_bits=LOAD_MAX_BITS), device=device)


def loaded_link_payload(bps: int) -> int:
    """The least payload of at least 1002 bits whose conv-coded wire (rate
    1/2, CRC-16 and 6 flush bits) fills whole loaded symbols and the
    interleaver's 8 rows."""
    p = CONV_LINK_PAYLOAD
    while (2 * (p + 22)) % math.lcm(bps, 8):
        p += 1
    return p


def phase_loading(device) -> None:
    """Phase 49: ``bit_loading`` from the per-bin SNR of test_bitloading.py's
    selective channel at a 30 dB floor (gap 12 dB, at most 6 bits);
    ``AdaptiveOfdm`` at 256 channels x 64 symbols through that channel at
    30 dB: every bit right; the conv-coded ``FramedLink`` over it (at least
    1024 trellis steps: K13's windowed route) at 256 frames and 20 dB: every
    payload and CRC."""
    from modem_tpu_torch import FramedLink
    from modem_tpu_torch.ops import impairments as imp
    from modem_tpu_torch.ops.channel import awgn

    mm = loaded_modem(device)
    hist = {b: mm.loading.count(b) for b in sorted(set(mm.loading))}
    g = torch.Generator(device=device).manual_seed(SEED + 125)
    bits = torch.randint(0, 2, (CHANNELS, mm.bits_per_frame(LOAD_SYMBOLS)),
                         generator=g, device=device, dtype=torch.int32)
    i, q = mm.tx_frame(bits)
    i, q = imp.multipath_fir(i, q, *channel_taps(LOAD_CH, device))
    i, q = awgn(g, i, q, LOAD_FLOOR_DB, signal_power=1.0)
    errs = bit_errors(mm.rx_frame(i, q, LOAD_SYMBOLS), bits)
    print(f"[load] bit_loading (gap {LOAD_GAP_DB} dB, at most "
          f"{LOAD_MAX_BITS} bits) over the selective channel at "
          f"{LOAD_FLOOR_DB} dB: bins by bits {json.dumps(hist)}, "
          f"{mm.bits_per_sym} bits a symbol; AdaptiveOfdm {CHANNELS} ch x "
          f"{LOAD_SYMBOLS} symbols: {errs} bit errors of {bits.numel()}",
          flush=True)
    if errs:
        fail("AdaptiveOfdm.rx_frame: bits wrong")
    link = FramedLink(mm.as_link_chain(),
                      payload_bits=loaded_link_payload(mm.bits_per_sym),
                      conv_window=512)
    conv_link_run(link, LOAD_LINK_FRAMES, LOAD_CH, LOAD_LINK_SNR_DB,
                  SEED + 126, device, "FramedLink over AdaptiveOfdm",
                  per_rail=True)


def phase_phy_times(device, card: str) -> dict:
    """Phase 50: K4 at 160 taps per call beside its plain version, the
    profiler's device time, the bound and its ``conv1d`` yardstick; wall
    time, device busy time, idle share and CUDA launches per call of
    ``ScFdeModem.rx_frame`` and ``acquire``, ``AlamoutiOfdm.rx``,
    ``MimoOfdm.rx_frame``, ``MimoOfdmN.rx_frame`` at 4x4,
    ``AdaptiveOfdm.rx_frame`` and ``mimo_ofdm_link().rx``."""
    import torch.nn.functional as F
    from modem_tpu_torch import AlamoutiOfdm, MimoOfdm, MimoOfdmN, Rates, \
        make_scheme, presets
    from modem_tpu_torch.ops import fir
    from modem_tpu_torch.ops.channel import awgn

    modem = scfde_modem(device)
    g = torch.Generator(device=device).manual_seed(SEED + 127)
    bits = torch.randint(0, 2, (CHANNELS, modem.bits_per_frame(SCFDE_BLOCKS)),
                         generator=g, device=device, dtype=torch.int32)
    ci, cq, _, nv = scfde_capture(modem, bits, device, SEED + 128)
    k = modem.preamble_len
    taps = torch.as_tensor(modem._preamble_i[::-1].copy(), device=device)
    n = SCFDE_MAX_LAG + k - 1
    args = (ci[:, :n].contiguous(), taps,
            torch.zeros((CHANNELS, k - 1), device=device))
    xp = torch.cat([args[2], args[0]], dim=-1).unsqueeze(1)
    w = taps.flip(0).reshape(1, 1, k)
    lib_err = max_err(F.conv1d(xp, w).squeeze(1), fir.fir_kernel(*args))
    if lib_err > 1e-3:
        fail(f"conv1d yardstick disagrees with K4 at {k} taps ({lib_err})")
    ms, plain_ms, dev_ms = kernel_times(fir.fir_kernel, fir.fir_plain, args,
                                        device, fir_symbol(k), plain_calls=2)
    if dev_ms is None:
        fail(f"K4 at {k} taps: no {fir_symbol(k)} in the profile")
    lib_ms = time_calls(F.conv1d, (xp, w), device)
    lib_dev = device_busy_ms(F.conv1d, (xp, w), device)
    work = (4 * (2 * CHANNELS * n + CHANNELS * (k - 1) + k),
            2 * k * CHANNELS * n)
    times = {SCFDE_FIR: (ms, plain_ms, dev_ms, lib_ms, work)}
    print_times(f"{SCFDE_FIR} ({k} taps, {fir.fir_route(k)})", CHANNELS * n,
                times[SCFDE_FIR], card,
                f"conv1d {lib_ms:.4f} ms, its device busy {lib_dev:.4f} ms "
                f"(max |err| vs K4 {lib_err:.2e})")

    r = Rates(1250, 10000)
    aligned = modem.locate_frame(ci, cq, SCFDE_BLOCKS, SCFDE_MAX_LAG)[:2]
    st = AlamoutiOfdm(make_scheme("qpsk", r), device=device)
    sb = torch.randint(0, 2, (CHANNELS, st.bits_per_frame(STBC_PAIRS)),
                       generator=g, device=device, dtype=torch.int32)
    (ai, aq), (bi, bq) = st.tx(sb)
    m2 = MimoOfdm(make_scheme("qpsk", r), device=device)
    mb = torch.randint(0, 2, (CHANNELS, m2.bits_per_frame(2 * STBC_PAIRS)),
                       generator=g, device=device, dtype=torch.int32)
    (ma, mq), (na, nq) = m2.tx(mb)
    m2y = (ma + 0.4 * na, mq + 0.4 * nq, 0.3 * ma + na, 0.3 * mq + nq)
    mn = MimoOfdmN(make_scheme("qpsk", r), nt=MIMON_NT, device=device)
    nb = torch.randint(0, 2, (CHANNELS, mn.bits_per_frame(MIMON_SYMBOLS)),
                       generator=g, device=device, dtype=torch.int32)
    ti, tq = mn.tx(nb)
    mix = torch.eye(MIMON_NT, device=device) + 0.25
    lm = loaded_modem(device)
    lb = torch.randint(0, 2, (CHANNELS, lm.bits_per_frame(LOAD_SYMBOLS)),
                       generator=g, device=device, dtype=torch.int32)
    li, lq = lm.tx_frame(lb)
    link = presets.mimo_ofdm_link(device=device)
    pay = torch.randint(0, 2, (MIMO_FRAMES, link.payload_bits), generator=g,
                        device=device, dtype=torch.int32)
    (ia, qa), (ib, qb) = link.tx(pay)
    ly = (*awgn(g, ia + 0.6 * ib, qa + 0.6 * qb, MIMO_EXACT_SNR_DB),
          *awgn(g, 0.5 * ia + ib, 0.5 * qa + qb, MIMO_EXACT_SNR_DB))
    lnv = float(torch.mean(ly[0] ** 2 + ly[1] ** 2)) / 10.0 ** (
        MIMO_EXACT_SNR_DB / 10.0)
    for name, fn, fargs, what in (
            ("ScFdeModem.rx_frame", modem.rx_frame,
             (*aligned, SCFDE_BLOCKS, nv), (aligned[0].numel(), "samples")),
            ("ScFdeModem.acquire", modem.acquire,
             (ci, cq, SCFDE_BLOCKS, SCFDE_MAX_LAG, nv),
             (ci.numel(), "samples")),
            ("AlamoutiOfdm.rx", st.rx, (ai + bi, aq + bq, STBC_PAIRS),
             (ai.numel(), "samples")),
            ("MimoOfdm.rx_frame", m2.rx_frame, (*m2y, 2 * STBC_PAIRS),
             (2 * ma.numel(), "samples")),
            (f"MimoOfdmN.rx_frame ({MIMON_NT}x{MIMON_NT})", mn.rx_frame,
             (mix @ ti, mix @ tq, MIMON_SYMBOLS, 1e-3),
             (ti.numel(), "samples")),
            ("AdaptiveOfdm.rx_frame", lm.rx_frame, (li, lq, LOAD_SYMBOLS),
             (li.numel(), "samples")),
            ("mimo_ofdm_link().rx, 16 dB", link.rx, (ly, lnv),
             (MIMO_FRAMES * link.payload_bits, "payload bits"))):
        calls = 3 if "link" in name else 10
        ms = time_calls(fn, fargs, device, calls=calls, reps=3)
        busy = device_busy_ms(fn, fargs, device, calls=calls)
        launches = cuda_launches(fn, fargs, device)
        count, unit_ = what
        rate = (f"{count / ms / 1e3:.2f} Mbit/s" if "bits" in unit_ else
                f"{count / ms * 1e3:.4e} {unit_}/s")
        print(f"[times] {name:34s} per call {ms:.4f} ms ({rate}), device "
              f"busy {busy:.4f} ms (idle share {1 - busy / ms:.3f}), "
              f"{launches} CUDA launches a call, {CHANNELS} ch, on {card}",
              flush=True)
    return times


# ---- the wideband front end: channelizer, DSSS, FHSS, WidebandModem ----

def rel_err(got, want) -> float:
    """max |got - want| over the largest |want| (both moved to the CPU)."""
    got, want = got.detach().cpu(), want.detach().cpu()
    if got.shape != want.shape:
        fail(f"shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not torch.isfinite(got).all():
        fail("non-finite output")
    return float((got - want).abs().max() / want.abs().max())


def count_k4(what: str, tag: str, fn, *args):
    """``fn(*args)`` with every launch count set to 0 just before it;
    returns ``(out, K4's launches)`` read just after."""
    from modem_tpu_torch.ops import fir

    reset_launches()
    out = fn(*args)
    return out, read_launches({what: fir.FIR_KERNEL}, what, tag)[what]


def wb_pushes(bank, x, y, n_rows: int, analyze: bool):
    """``bank`` over ``(x, y)`` in ``WB_PUSHES`` equal pushes of ``n_rows``
    channel-rate rows (wideband samples for analysis)."""
    step = n_rows // WB_PUSHES
    if analyze:
        st, width, fn = bank.init_analyze_state(x.shape[:-1]), bank.m, \
            bank.analyze_stream
    else:
        st, width, fn = bank.init_synthesize_state(x.shape[:-2]), 1, \
            bank.synthesize_stream
    parts = []
    for p in range(WB_PUSHES):
        a, b = p * step * width, (p + 1) * step * width
        oi, oq, st = fn(x[..., a:b], y[..., a:b], st)
        parts.append((oi, oq))
    return (torch.cat([o[0] for o in parts], -1),
            torch.cat([o[1] for o in parts], -1))


def wb_receiver(device, **kw):
    from modem_tpu_torch import AcquiringReceiver, Rates, qpsk_reference_chain

    return AcquiringReceiver(qpsk_reference_chain(Rates(1250, 10000),
                                                  device=device),
                             list(ACQ_PRE), max_lag=WB_MAX_LAG, **kw)


def gemm_share(fn, args, device, calls=5) -> tuple[float, float, set]:
    """``(GEMM ms, busy ms, GEMM kernel names)`` a call, by the profiler:
    the device time of the cuBLAS kernels (names holding ``gemm``) beside
    all the call's device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn(*args)
        torch.cuda.synchronize(device)
    evs = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    gemm = [e for e in evs if "gemm" in e.key.lower()]
    return (sum(e.device_time_total for e in gemm) / calls / 1e3,
            sum(e.device_time_total for e in evs) / calls / 1e3,
            {e.key[:60] for e in gemm})


def phase_channelizer(device) -> None:
    """Phase 51: the channelizer at M 256, 4096 channel-rate samples, a
    batch of 4: ``synthesize`` and ``analyze`` held against the CPU twin on
    the same inputs (one row: a row's result does not depend on the
    others); both banks in 4 pushes equal to one shot, bit for bit; the
    bf16 DFT (float32 outputs, its floor against f32, exact decisions
    through both bf16 banks and ``AcquiringReceiver`` at 256 bursts); tones
    at 5 channels, each suppressed 40 dB in every other channel, as
    tests/test_channelizer.py asks at M 8."""
    from modem_tpu_torch import Channelizer

    g = torch.Generator(device=device).manual_seed(SEED + 130)
    bank = Channelizer(WB_M, device=device)
    twin = Channelizer(WB_M, device="cpu")
    ci = torch.randn((WB_BATCH, WB_M, WB_K), generator=g, device=device)
    cq = torch.randn((WB_BATCH, WB_M, WB_K), generator=g, device=device)
    wi, wq = bank.synthesize(ci, cq)
    yi, yq = bank.analyze(wi, wq)
    torch.cuda.synchronize(device)
    twi, twq = twin.synthesize(ci[:1].cpu(), cq[:1].cpu())
    tyi, tyq = twin.analyze(wi[:1].cpu(), wq[:1].cpu())
    errs = {"synthesize": max(rel_err(wi[:1], twi), rel_err(wq[:1], twq)),
            "analyze": max(rel_err(yi[:1], tyi), rel_err(yq[:1], tyq))}
    pi_, pq_ = wb_pushes(bank, ci, cq, WB_K, analyze=False)
    ai, aq = wb_pushes(bank, wi, wq, WB_K, analyze=True)
    same = {"synthesize": torch.equal(pi_, wi) and torch.equal(pq_, wq),
            "analyze": torch.equal(ai, yi) and torch.equal(aq, yq)}
    print(f"[wideband] Channelizer({WB_M}) on {WB_BATCH} x {WB_M} x {WB_K} "
          f"(wideband {WB_M * WB_K} samples a row): vs the CPU twin "
          f"{json.dumps(errs)} of the largest (bar {WB_TWIN_RTOL}); "
          f"{WB_PUSHES} pushes == one shot {json.dumps(same)}", flush=True)
    if max(errs.values()) > WB_TWIN_RTOL or not all(same.values()):
        fail("Channelizer: the card differs from the CPU twin, or pushes "
             "differ from one shot")

    b16 = Channelizer(WB_M, dft_dtype=torch.bfloat16, device=device)
    t16 = Channelizer(WB_M, dft_dtype=torch.bfloat16, device="cpu")
    hi, hq = b16.synthesize(ci, cq)
    gi, gq = b16.analyze(wi, wq)
    e16 = max(rel_err(hi[:1], t16.synthesize(ci[:1].cpu(), cq[:1].cpu())[0]),
              rel_err(gi[:1], t16.analyze(wi[:1].cpu(), wq[:1].cpu())[0]))
    floor = 10 * math.log10(float((wi ** 2 + wq ** 2).sum())
                            / float(((hi - wi) ** 2 + (hq - wq) ** 2).sum()))
    si, sq = wb_pushes(b16, wi, wq, WB_K, analyze=True)
    same16 = torch.equal(si, gi) and torch.equal(sq, gq)
    rxr = wb_receiver(device)
    bits = acq_bits(WB_M, WB_PAYLOAD, g, device)
    bi, bq = rxr.tx_burst(bits)
    pad = bi.new_zeros((WB_M, 2 * b16.taps_per_phase + 64))
    bi, bq = torch.cat([bi, pad], -1), torch.cat([bq, pad], -1)
    out = rxr.rx(*b16.analyze(*b16.synthesize(bi, bq)), WB_PAYLOAD)
    errs16 = bit_errors(out, bits)
    print(f"[wideband] bf16 DFT: outputs {hi.dtype}/{gi.dtype}; vs the CPU "
          f"twin {e16:.2e} of the largest (bar {WB_TWIN_RTOL}); synthesis "
          f"{floor:.1f} dB above its difference from f32 (bar "
          f"{WB_BF16_SNR_DB}); {WB_PUSHES} pushes == one shot {same16}; "
          f"{WB_M} bursts of {WB_PAYLOAD} QPSK symbols through both bf16 "
          f"banks and AcquiringReceiver: {errs16} bit errors", flush=True)
    if (hi.dtype != torch.float32 or gi.dtype != torch.float32
            or e16 > WB_TWIN_RTOL or floor < WB_BF16_SNR_DB or not same16
            or errs16):
        fail("Channelizer(dft_dtype=torch.bfloat16) is not right")

    t = torch.arange(WB_M * WB_TONE_K, device=device, dtype=torch.float64)
    f = torch.tensor(WB_TONE_CH, device=device, dtype=torch.float64)[:, None]
    ang = 2.0 * math.pi * f / WB_M * t
    ti, tq = bank.analyze(torch.cos(ang).float(), torch.sin(ang).float())
    p = (ti[..., 64:] ** 2 + tq[..., 64:] ** 2).mean(-1)  # [tones, M]
    worst = 0.0
    for r, m0 in enumerate(WB_TONE_CH):
        others = torch.cat([p[r, :m0], p[r, m0 + 1:]])
        worst = max(worst, float(others.max() / p[r, m0]))
        if float(p[r, m0]) <= 1.0:
            fail(f"Channelizer: the tone at channel {m0} is missing")
    print(f"[wideband] tones at channels {WB_TONE_CH}, M {WB_M}: the "
          f"strongest other channel {10 * math.log10(worst):.1f} dB under "
          "the tone's (bar -40 dB)", flush=True)
    if worst >= 1e-4:
        fail("Channelizer: a tone leaks into another channel")


def phase_dsss(device) -> None:
    """Phase 52: ``DsssChain`` at 256 channels x 512 QPSK symbols, L 16
    (about 65,600 samples a channel): noiseless, every bit right, K4's
    launches counted from 0 (2 a call each way); 4 channels held against
    the CPU twin (waveforms within ATOL, decision points and bits); at -4
    dB chip SNR every bit right; the 10x CW jammer at L 32, every bit
    right."""
    from modem_tpu_torch import DsssChain, Rates, make_scheme
    from modem_tpu_torch.ops.channel import awgn

    r = Rates(1250, 10000)
    g = torch.Generator(device=device).manual_seed(SEED + 131)
    ds = DsssChain(make_scheme("qpsk", r), r, DS_L, device=device)
    bits = acq_bits(DS_CHANNELS, DS_SYMBOLS, g, device)
    (i, q), n_tx = count_k4("DsssChain.tx", "dsss", ds.tx, bits)
    out, n_rx = count_k4("DsssChain.rx", "dsss", ds.rx, (i, q), DS_SYMBOLS)
    errs = bit_errors(out, bits)
    twin = DsssChain(make_scheme("qpsk", r), r, DS_L, device="cpu")
    tb = bits[:DS_TWIN].cpu()
    ti, tq = twin.tx(tb)
    w_err = max_err((i[:DS_TWIN].cpu(), q[:DS_TWIN].cpu()), (ti, tq))
    di, dq = ds._despread(i[:DS_TWIN], q[:DS_TWIN], DS_SYMBOLS)
    tdi, tdq = twin._despread(ti, tq, DS_SYMBOLS)
    p_err = max(rel_err(di, tdi), rel_err(dq, tdq))
    twin_bits = torch.equal(twin.rx((ti, tq), DS_SYMBOLS), tb)
    print(f"[dsss] {DS_CHANNELS} ch x {DS_SYMBOLS} QPSK symbols, L {DS_L} "
          f"({i.shape[-1]} samples a channel, "
          f"{2 * i.numel() * 4 / 1e6:.1f} MB both planes): {errs} bit "
          f"errors; K4 launches tx {n_tx}, rx {n_rx}; {DS_TWIN} channels vs "
          f"the CPU twin: waveform {w_err:.2e} (tol {ATOL}), decision "
          f"points {p_err:.2e} of the largest (bar {WB_TWIN_RTOL}), twin bits "
          f"{'right' if twin_bits else 'WRONG'}", flush=True)
    if errs or n_tx != 2 or n_rx != 2 or w_err > ATOL or \
            p_err > WB_TWIN_RTOL or not twin_bits:
        fail("DsssChain: bits, launches or the CPU twin wrong")

    ni, nq = awgn(g, i, q, DS_SNR_DB)
    errs = bit_errors(ds.rx((ni, nq), DS_SYMBOLS), bits)
    jam = DsssChain(make_scheme("qpsk", r), r, DS_JAM_L, device=device)
    ji, jq = jam.tx(bits)
    amp = math.sqrt(10.0 * float((ji * ji + jq * jq).mean()))
    th = (2.0 * math.pi * 0.013 * torch.arange(ji.shape[-1], device=device,
                                               dtype=torch.float32) + 0.7)
    jerrs = bit_errors(jam.rx((ji + amp * torch.cos(th),
                               jq + amp * torch.sin(th)), DS_SYMBOLS), bits)
    print(f"[dsss] at {DS_SNR_DB} dB chip SNR: {errs} bit errors; a CW tone "
          f"10x the signal power at L {DS_JAM_L}: {jerrs} bit errors of "
          f"{bits.numel()}", flush=True)
    if errs or jerrs:
        fail("DsssChain: bits wrong in noise or under the jammer")


def fh_modem(chain, hop, symbols: int):
    from modem_tpu_torch import FhssModem

    return FhssModem(chain, m=FH_M, hop_seq=hop, dwell_symbols=symbols)


def phase_fhss(device) -> None:
    """Phase 53: ``FhssModem`` at 16 links over 64 channels, 64 dwells on a
    seeded permutation, 32 QPSK symbols a dwell: every bit right, K4's
    launches counted (2 a call each way, the wrapped staged chain); a 10x
    CW jammer on channel 5: its dwell loses bits, every other dwell exact;
    hybrid DS/FH over a ``DsssChain`` (L 8, 16 dwells of 16 symbols), every
    bit right."""
    from modem_tpu_torch import DsssChain, PulseShapedChain, Rates, \
        make_scheme

    r = Rates(1250, 10000)
    g = torch.Generator(device=device).manual_seed(SEED + 132)
    hop = torch.randperm(FH_M, generator=g, device=device)[:FH_DWELLS].cpu()
    fm = fh_modem(PulseShapedChain(make_scheme("qpsk", r), r, device=device),
                  hop.numpy(), FH_SYMBOLS)
    bits = torch.randint(0, 2, (FH_LINKS, fm.bits_per_frame()), generator=g,
                         device=device, dtype=torch.int32)
    (wi, wq), n_tx = count_k4("FhssModem.tx", "fhss", fm.tx, bits)
    out, n_rx = count_k4("FhssModem.rx", "fhss", fm.rx, wi, wq)
    errs = bit_errors(out, bits)
    print(f"[fhss] {FH_LINKS} links x {FH_DWELLS} dwells x {FH_SYMBOLS} QPSK "
          f"symbols over {FH_M} channels ({wi.shape[-1]} wideband samples a "
          f"link): {errs} bit errors; K4 launches tx {n_tx}, rx {n_rx}; bank "
          f"delay and gain {fm._calibrate()}", flush=True)
    if errs or n_tx != 2 or n_rx != 2:
        fail("FhssModem: bits or launches wrong")

    amp = math.sqrt(10.0 * float((wi * wi + wq * wq).mean()) * FH_M)
    th = (2.0 * math.pi * FH_JAM_CH / FH_M
          * torch.arange(wi.shape[-1], device=device, dtype=torch.float32)
          + 1.1)
    out = fm.rx(wi + amp * torch.cos(th), wq + amp * torch.sin(th))
    per = (out != bits).reshape(FH_LINKS, FH_DWELLS, -1).sum(-1).cpu()
    hit = int((hop == FH_JAM_CH).nonzero()[0, 0])
    rest = torch.cat([per[:, :hit], per[:, hit + 1:]], dim=-1)
    print(f"[fhss] 10x CW jammer on channel {FH_JAM_CH} (dwell {hit}): bit "
          f"errors there {int(per[:, hit].min())}-{int(per[:, hit].max())} a "
          f"link, in the other {FH_DWELLS - 1} dwells {int(rest.sum())}",
          flush=True)
    if int(per[:, hit].min()) <= 5 or int(rest.sum()):
        fail("FhssModem: the jammer's selectivity is not right")

    hy = fh_modem(DsssChain(make_scheme("qpsk", r), r, FH_DS_L,
                            device=device), hop[:FH_DS_DWELLS].numpy(),
                  FH_DS_SYMBOLS)
    hb = torch.randint(0, 2, (FH_LINKS, hy.bits_per_frame()), generator=g,
                       device=device, dtype=torch.int32)
    herrs = bit_errors(hy.rx(*hy.tx(hb)), hb)
    print(f"[fhss] hybrid DS/FH (L {FH_DS_L}, {FH_DS_DWELLS} dwells of "
          f"{FH_DS_SYMBOLS} symbols, {FH_LINKS} links): {herrs} bit errors",
          flush=True)
    if herrs:
        fail("FhssModem over DsssChain: bits wrong")


def wb_front_end(wi, wq, g):
    """tests/test_wideband.py's front end: the whole bank tilted together,
    3 Hz of CFO at the wideband rate, gain 0.9, AWGN at 28 dB."""
    from modem_tpu_torch.ops.channel import awgn
    from modem_tpu_torch.ops.impairments import apply_cfo, apply_gain_phase

    wi, wq = apply_cfo(wi, wq, WB_CFO_HZ, 10000 * WB_M, phase0=WB_PHASE)
    wi, wq = apply_gain_phase(wi, wq, gain=WB_GAIN)
    return awgn(g, wi, wq, WB_SNR_DB)


def phase_wideband(device) -> None:
    """Phase 54: ``WidebandModem`` at M 256, 512 payload symbols, max_lag
    200: every payload bit right, K4's launches counted (2 in ``tx``, the
    bursts' shaping; 2 in ``rx``, the matched filter). Through the front
    end: the receiver's CFO estimate from the 32-symbol preamble lets a few
    channels of 256 drift past a decision boundary over 512 symbols (the
    JAX package's receiver loses the same channel on the same capture, a
    CPU run), so there the card is held to the CPU twin (the same channels
    wrong, every other bit right); with the receiver's block tracker
    (``track_block=16``), and at tests/test_wideband.py's 96 symbols, every
    bit right."""
    from modem_tpu_torch import WidebandModem

    g = torch.Generator(device=device).manual_seed(SEED + 133)
    wm = WidebandModem(wb_receiver(device), WB_M, WB_PAYLOAD)
    bits = acq_bits(WB_M, WB_PAYLOAD, g, device)
    (wi, wq), n_tx = count_k4("WidebandModem.tx", "wideband", wm.tx, bits)
    out, n_rx = count_k4("WidebandModem.rx", "wideband", wm.rx, wi, wq)
    errs = bit_errors(out, bits)
    print(f"[wideband] WidebandModem M {WB_M}, {WB_PAYLOAD} payload symbols, "
          f"window {wm.window} ({wi.shape[-1]} wideband samples): {errs} bit "
          f"errors; K4 launches tx {n_tx}, rx {n_rx}", flush=True)
    if errs or n_tx != 2 or n_rx != 2:
        fail("WidebandModem: bits or launches wrong")

    fi, fq = wb_front_end(wi, wq, g)
    bad = (wm.rx(fi, fq) != bits).sum(-1).cpu()
    twin = WidebandModem(wb_receiver("cpu"), WB_M, WB_PAYLOAD)
    tbad = (twin.rx(fi.cpu(), fq.cpu()) != bits.cpu()).sum(-1)
    same = torch.equal(bad > 0, tbad > 0)
    tracked = WidebandModem(wb_receiver(device, track_block=16), WB_M,
                            WB_PAYLOAD)
    terrs = bit_errors(tracked.rx(fi, fq), bits)
    short = WidebandModem(wb_receiver(device), WB_M, 96)
    sbits = acq_bits(WB_M, 96, g, device)
    serrs = bit_errors(short.rx(*wb_front_end(*short.tx(sbits), g)), sbits)
    print(f"[wideband] through {WB_CFO_HZ} Hz, gain {WB_GAIN}, {WB_SNR_DB} "
          f"dB: {int(bad.sum())} bit errors in channels "
          f"{bad.nonzero().flatten().tolist()}, the CPU twin "
          f"{int(tbad.sum())} in {tbad.nonzero().flatten().tolist()}; with "
          f"track_block=16 {terrs}; at 96 payload symbols {serrs}",
          flush=True)
    if not same or terrs or serrs:
        fail("WidebandModem through the front end: bits wrong")


def phase_wideband_times(device, card: str) -> None:
    """Phase 55: wall time, device busy time, idle share and CUDA launches
    per call of ``Channelizer.synthesize``/``analyze`` (phase 51's block),
    ``DsssChain.tx``/``rx`` (phase 52's), ``FhssModem.tx``/``rx`` (phase
    53's) and ``WidebandModem.tx``/``rx`` (phase 54's); then
    ``profiling.measure`` and ``measure_marginal`` on ``analyze`` beside
    the CUDA-event time of the same calls."""
    from modem_tpu_torch import (Channelizer, DsssChain, PulseShapedChain,
                                 Rates, WidebandModem, make_scheme, profiling)

    r = Rates(1250, 10000)
    g = torch.Generator(device=device).manual_seed(SEED + 134)
    bank = Channelizer(WB_M, device=device)
    ci = torch.randn((WB_BATCH, WB_M, WB_K), generator=g, device=device)
    cq = torch.randn((WB_BATCH, WB_M, WB_K), generator=g, device=device)
    wi, wq = bank.synthesize(ci, cq)
    ds = DsssChain(make_scheme("qpsk", r), r, DS_L, device=device)
    dbits = acq_bits(DS_CHANNELS, DS_SYMBOLS, g, device)
    dwave = ds.tx(dbits)
    hop = torch.randperm(FH_M, generator=g, device=device)[:FH_DWELLS].cpu()
    fm = fh_modem(PulseShapedChain(make_scheme("qpsk", r), r, device=device),
                  hop.numpy(), FH_SYMBOLS)
    fbits = torch.randint(0, 2, (FH_LINKS, fm.bits_per_frame()), generator=g,
                          device=device, dtype=torch.int32)
    fwave = fm.tx(fbits)
    wm = WidebandModem(wb_receiver(device), WB_M, WB_PAYLOAD)
    wbits = acq_bits(WB_M, WB_PAYLOAD, g, device)
    wwave = wm.tx(wbits)
    for name, fn, fargs, what in (
            (f"Channelizer.synthesize, {WB_BATCH} x {WB_M} x {WB_K}",
             bank.synthesize, (ci, cq), (wi.numel(), "samples")),
            (f"Channelizer.analyze, {WB_BATCH} x {WB_M * WB_K}",
             bank.analyze, (wi, wq), (wi.numel(), "samples")),
            (f"DsssChain.tx, {DS_CHANNELS} ch x {DS_SYMBOLS} sym, L {DS_L}",
             ds.tx, (dbits,), (dwave[0].numel(), "samples")),
            ("DsssChain.rx, same", ds.rx, (dwave, DS_SYMBOLS),
             (dwave[0].numel(), "samples")),
            (f"FhssModem.tx, {FH_LINKS} links x {FH_DWELLS} dwells",
             fm.tx, (fbits,), (fwave[0].numel(), "samples")),
            ("FhssModem.rx, same", fm.rx, fwave,
             (fwave[0].numel(), "samples")),
            (f"WidebandModem.tx, M {WB_M} x {WB_PAYLOAD} sym", wm.tx,
             (wbits,), (wwave[0].numel(), "samples")),
            ("WidebandModem.rx, same", wm.rx, wwave,
             (wwave[0].numel(), "samples"))):
        ms = time_calls(fn, fargs, device, calls=5, reps=3)
        busy = device_busy_ms(fn, fargs, device, calls=5)
        launches = cuda_launches(fn, fargs, device)
        count, unit_ = what
        print(f"[times] {name:44s} per call {ms:.4f} ms "
              f"({count / ms * 1e3:.4e} {unit_}/s), device busy "
              f"{busy:.4f} ms (idle share {1 - busy / ms:.3f}), {launches} "
              f"CUDA launches a call, on {card}", flush=True)

    for name, fn, fargs in (("Channelizer.synthesize", bank.synthesize,
                             (ci, cq)),
                            ("Channelizer.analyze", bank.analyze, (wi, wq)),
                            ("FhssModem.rx", fm.rx, fwave)):
        gemm, busy, kinds = gemm_share(fn, fargs, device)
        print(f"[times] {name}: the DFT's GEMMs {gemm:.4f} ms of {busy:.4f} "
              f"ms busy a call ({100 * gemm / max(busy, 1e-12):.1f}%), "
              f"{len(kinds)} GEMM kernel(s): {sorted(kinds)}", flush=True)

    reps = torch.stack([wi, wi.flip(-1), wq, wq.flip(-1)])
    qreps = torch.stack([wq, wq.flip(-1), wi, wi.flip(-1)])
    samples = wi.numel()
    ev = time_calls(bank.analyze, (wi, wq), device, calls=4, reps=5)
    m = profiling.measure(lambda a, b: bank.analyze(a, b)[0], (reps, qreps),
                          samples)
    mm = profiling.measure_marginal(lambda a, b: bank.analyze(a, b)[0],
                                    (reps[:2], qreps[:2]), (reps, qreps),
                                    samples)
    print(f"[times] profiling.measure(Channelizer.analyze), 4 reps: "
          f"{m.summary()} (median {m.median_seconds_per_call * 1e3:.4f} ms); "
          f"measure_marginal 2 -> 4 reps: {mm.summary()}; CUDA events over "
          f"the same calls {ev:.4f} ms a call, on {card}", flush=True)
    if not (m.seconds_per_call > 0 and mm.marginal_samples_per_s > 0):
        fail("profiling.measure: no time")


# the multi-device layer (phases 56-58): the flagship and its kin at full
# width over a 2x2 ("ch", "time") mesh, the channelizer and WidebandModem
# over 1x4; a world of one over NCCL, then four ranks on the one card
SH_WORLD = 4
SH_VIT = (64, 1024)              # channels x data bits of the slab decode
SH_WAVE_RTOL = 1e-5              # four ranks' waveforms, of the largest value
SH_HALO = 16                     # halo_mismatch's overlap, in samples
SH_CALLS = 20
#: the report entry of each kernel the sharded paths run, and its K number
#: (K4's count is every tap count's: 65, 64, 240)
SHARDED_ENTRIES = {"fused_pulse_chain": "K1", "fused_tx": "K2",
                   "fused_rx": "K3", "fir_filter_rrc": "K4",
                   "fused_fsk_chain": "K6", "fused_resampled_tx": "K11",
                   "fused_resampled_rx": "K12", VIT_REPORT[0]: "K13"}


def sharded_kernels() -> dict:
    """The kernels of the sharded paths, by their K number."""
    from modem_tpu_torch.ops import (chain_kernel, fir, fsk_kernel as fk,
                                     resampled_kernel as rk, txrx,
                                     viterbi_kernel as vk)

    return {"K1": chain_kernel.CHAIN_KERNEL, "K2": txrx.TX_KERNEL,
            "K3": txrx.RX_HARD_KERNEL, "K4": fir.FIR_KERNEL,
            "K6": fk.FSK_CHAIN_KERNEL, "K11": rk.RESAMPLED_TX_KERNEL,
            "K12": rk.RESAMPLED_RX_KERNEL, "K13": vk.VITERBI_KERNEL}


class ShardedRun:
    """One rank's sharded calls, each held against the single-device port
    on the same global inputs (made from the seed alike on every rank):
    ``bits`` the mismatched elements of each decision check, ``waves`` the
    largest difference of each waveform over the largest value, and the
    launches of the sharded calls alone."""

    def __init__(self, meshes: dict, device, world: int):
        self.meshes, self.device, self.world = meshes, device, world
        self.launches = dict.fromkeys(sharded_kernels(), 0)
        self.bits, self.waves = {}, {}
        self.ber = None

    def call(self, fn, *args):
        """A sharded call: every count set to 0 just before it, its
        kernels' launches read just after and added up."""
        reset_launches()
        out = fn(*args)
        torch.cuda.synchronize(self.device)
        for k, kern in sharded_kernels().items():
            self.launches[k] += kern.launches
        return out

    def same(self, label: str, got, want) -> None:
        if got.shape != want.shape:
            fail(f"{label}: shape {tuple(got.shape)} != {tuple(want.shape)}")
        self.bits[label] = int((got != want).sum())

    def close(self, label: str, got, want) -> None:
        self.waves[label] = rel_err(got, want)


def sharded_checks(run: ShardedRun) -> None:
    """Every sharded entry point on this rank's block at full width,
    against the single-device port's call on the whole input."""
    from modem_tpu_torch import (Channelizer, Demodulator, DifferentialChain,
                                 LinkStats, Modulator, OfdmModem,
                                 PulseShapedChain, Rates, WidebandModem,
                                 make_scheme, qpsk_reference_chain)
    from modem_tpu_torch import parallel as par
    from modem_tpu_torch.debug import halo_mismatch
    from modem_tpu_torch.fec import ccsds_code
    from modem_tpu_torch.models.psk import QPSK
    from modem_tpu_torch.ops.chain_kernel import fused_pulse_chain
    from modem_tpu_torch.ops.fir import fir_filter
    from modem_tpu_torch.ops.fsk_kernel import fused_fsk_chain
    from modem_tpu_torch.ops.pll import LOCK_SAMPLES
    from modem_tpu_torch.parallel.chain import device_seed
    from modem_tpu_torch.parallel.collectives import axis_index
    from modem_tpu_torch.parallel.mesh import shard_block
    from modem_tpu_torch.utils.bits import pack_bits, unpack_symbols

    dev, ct, tm = run.device, run.meshes["ct"], run.meshes["t"]
    r = Rates(1250, 10000)
    g = torch.Generator(device=dev).manual_seed(SEED + 200)

    def rbits(c: int, n: int):
        return torch.randint(0, 2, (c, n), generator=g, device=dev,
                             dtype=torch.int32)

    def blk(x, mesh=ct, dims=("ch", "time")):
        return shard_block(x, mesh, dims)

    t_ct = axis_index(ct.get_group("time"))
    t_tm = axis_index(tm.get_group("time"))
    d_ct = ct.size(1)

    # the flagship, 256 ch x 4096 symbols: staged (K4) and fused (K1-K3)
    chain = qpsk_reference_chain(r, device=dev)
    bits = rbits(CHANNELS, 2 * N_SYMBOLS)
    sc = par.ShardedPulseChain(chain, ct)
    bl = sc.shard_bits(bits)
    run.same("ShardedPulseChain.roundtrip_fn (K4)",
             run.call(sc.roundtrip_fn(), bl, 0), blk(chain.roundtrip(bits)))
    run.same("fused_roundtrip_fn (K1)", run.call(sc.fused_roundtrip_fn(),
                                                 bl, 0),
             blk(chain.roundtrip_fused(bits)))
    full = chain.tx_fused(bits)
    n = N_SYMBOLS * chain.sps
    wave, ext = run.call(sc.fused_tx_fn(), bl)
    for i, w in enumerate(wave):
        run.close(f"fused_tx_fn rail {i} (K2)", w, blk(full[i][..., :n]))
        # the flush tail is the stream's on the last rank only
        run.waves[f"fused_tx_fn flush {i}"] = (
            rel_err(ext[i], blk(full[i][..., n:], ct, ("ch", None)))
            if t_ct == d_ct - 1 else 0.0)
    run.same("fused_rx_fn (K3)", run.call(sc.fused_rx_fn(), wave, ext),
             blk(chain.rx_fused(full, N_SYMBOLS)))
    err, tot = run.call(sc.fused_ber_fn(ES_N0_DB), bl, SEED)
    run.ber = (int(err), int(tot))
    if run.world == 1:  # K1 alone on the rank's layout: the same draws
        syms = pack_bits(bits, 2)
        pad = torch.full((CHANNELS, chain.span), -1, dtype=torch.int32,
                         device=dev)
        ext_syms = torch.cat([pad, syms, pad[:, :1], pad], dim=-1)
        dec = fused_pulse_chain(ext_syms, chain.lut, chain.rrc, chain.sps,
                                chain.span, snr_db=ES_N0_DB,
                                seed=device_seed(SEED, 0, 0),
                                sym_offset=-chain.span)
        dec = dec[..., chain.span:chain.span + N_SYMBOLS]
        run.same("fused_ber_fn errors (K1 noisy)", err,
                 (unpack_symbols(dec, 2) != bits).sum())
    pb = PulseShapedChain(QPSK(0.0, 1.0), r, carrier_hz=2000, device=dev)
    spb = par.ShardedPulseChain(pb, ct)
    run.same("passband fused_roundtrip_fn (K1)",
             run.call(spb.fused_roundtrip_fn(), bl, 0),
             blk(pb.roundtrip_fused(bits)))
    dch = DifferentialChain(make_scheme("dqpsk", r), r, device=dev)
    sd = par.ShardedDifferentialChain(dch, ct)
    run.same("ShardedDifferentialChain (K1)",
             run.call(sd.fused_roundtrip_fn(), bl),
             blk(dch.roundtrip_fused(bits)))

    # the sharded FIR, modulator, demodulator and FSK loopback over 1x4
    x = torch.randn((CHANNELS, n), generator=g, device=dev)
    run.close("sharded_fir (K4, 65 taps)",
              run.call(par.sharded_fir, blk(x, tm), chain.rrc, tm),
              blk(fir_filter(x, chain.rrc)[0], tm))
    mfsk = make_scheme("mfsk", r)
    mod = Modulator(mfsk, r, device=dev)
    mbits = rbits(CHANNELS, 4 * N_SYMBOLS)
    si, sq = run.call(par.time_sharded_baseband, mod, blk(mbits, tm), tm)
    (wi, wq), _ = mod.baseband(mbits, mod.init_state((CHANNELS,)))
    run.close("time_sharded_baseband i (16-MFSK)", si, blk(wi, tm))
    run.close("time_sharded_baseband q", sq, blk(wq, tm))
    pmod = Modulator(make_scheme("qpsk", r), r, carrier_hz=2000, device=dev)
    pw, _ = pmod.passband(bits, pmod.init_state((CHANNELS,)))
    demod = Demodulator(2000, 10000, device=dev)
    di, dq = run.call(par.sharded_demodulate, demod, blk(pw, tm), tm)
    st = demod.lock_phase(pw[..., :LOCK_SAMPLES],
                          demod.init_state((CHANNELS,)))
    (ri, rq), _ = demod.demodulate(pw[..., LOCK_SAMPLES:], st)
    z = torch.zeros((CHANNELS, LOCK_SAMPLES), device=dev)
    run.close("sharded_demodulate i (K4, 64 taps)", di,
              blk(torch.cat([z, ri], -1), tm))
    run.close("sharded_demodulate q", dq, blk(torch.cat([z, rq], -1), tm))
    fn = par.time_sharded_fsk_roundtrip_fn(mfsk, r, ct)
    run.same("time_sharded_fsk_roundtrip_fn (K6)",
             run.call(fn, blk(mbits), SEED),
             blk(unpack_symbols(fused_fsk_chain(pack_bits(mbits, 4), mfsk,
                                                r), 4)))

    # config #4 at 3/2 (K11, K12)
    rch = resampled_chain(dev)
    rb = rbits(CHANNELS, 4 * N_SYMBOLS)
    sr = par.ShardedResampledChain(rch, ct)
    rbl = sr.shard_bits(rb)
    rw, rd = run.call(sr.fused_tx_fn(), rbl)
    ci, cq = rch.tx_fused(rb)
    nr = N_SYMBOLS * rch.sps * rch.up // rch.down
    run.close("ShardedResampledChain.fused_tx_fn i (K11)", rw[0],
              blk(ci[..., :nr]))
    run.close("ShardedResampledChain.fused_tx_fn q", rw[1], blk(cq[..., :nr]))
    run.same("ShardedResampledChain.fused_rx_fn (K12)",
             run.call(sr.fused_rx_fn(), rw, rd),
             blk(rch.rx_fused((ci, cq), N_SYMBOLS)))
    run.same("ShardedResampledChain.fused_roundtrip_fn (K11, K12)",
             run.call(sr.fused_roundtrip_fn(), rbl),
             blk(rch.roundtrip_fused(rb)))

    # Viterbi: the time-sharded slab decode and K13 over channels
    code = ccsds_code()

    def llrs(data):
        c = code.encode(data).to(torch.float32)
        y = 1.0 - 2.0 * c + 0.8 * torch.randn(c.shape, generator=g,
                                               device=dev)
        return 2.0 * y / 0.64

    vl = llrs(rbits(*SH_VIT))
    dec = run.call(par.sharded_viterbi_fn(code, ct), blk(vl))
    slab = vl.shape[-1] // code.n // d_ct
    run.same("sharded_viterbi_fn (slab decode)", dec,
             shard_block(code.decode_soft(vl), ct, ("ch",))[
                 ..., t_ct * slab:t_ct * slab + dec.shape[-1]])
    wl = llrs(rbits(VIT_CHANNELS, VIT_BITS))
    win = par.channel_sharded(
        lambda a: code.decode_soft_windowed(a, VIT_BLOCK, VIT_HALO), ct)
    run.same("channel_sharded(decode_soft_windowed) (K13)",
             run.call(win, shard_block(wl, ct, ("ch",))),
             shard_block(code.decode_soft_windowed(wl, VIT_BLOCK, VIT_HALO),
                         ct, ("ch",)))

    # acquisition and OFDM over the channels (K4 at 65 and 240 taps)
    rxr = acq_receiver(dev)
    _, ai, aq = acq_capture(rxr, ACQ_CHANNELS, ACQ_PAYLOAD, dev, SEED + 201)
    run.same("sharded_acquire_fn (K4, 65 taps)",
             run.call(par.sharded_acquire_fn(rxr, ct, ACQ_PAYLOAD),
                      shard_block(ai, ct, ("ch",)),
                      shard_block(aq, ct, ("ch",))),
             shard_block(rxr.rx(ai, aq, ACQ_PAYLOAD), ct, ("ch",)))
    om = OfdmModem(make_scheme("qpsk", r), device=dev)
    ob = rbits(CHANNELS, om.bits_per_frame(OFDM_SYMBOLS))
    oi, oq = run.call(par.sharded_ofdm_tx_fn(om, ct),
                      shard_block(ob, ct, ("ch",)))
    ti, tq = om.tx_frame(ob)
    run.close("sharded_ofdm_tx_fn i", oi, shard_block(ti, ct, ("ch",)))
    run.close("sharded_ofdm_tx_fn q", oq, shard_block(tq, ct, ("ch",)))
    ci, cq, _ = ofdm_capture(om, ob, dev, SEED + 202, OFDM_SNR_DB)
    run.same("sharded_ofdm_rx_fn, max_lag (K4, 240 taps)",
             run.call(par.sharded_ofdm_rx_fn(om, ct, OFDM_SYMBOLS,
                                             max_lag=OFDM_MAX_LAG),
                      shard_block(ci, ct, ("ch",)),
                      shard_block(cq, ct, ("ch",))),
             shard_block(om.acquire(ci, cq, OFDM_SYMBOLS, OFDM_MAX_LAG)[0],
                         ct, ("ch",)))

    # the channelizer at M 256 and WidebandModem(mesh=) over 1x4
    bank = Channelizer(WB_M, device=dev)
    ci = torch.randn((WB_M, WB_K), generator=g, device=dev)
    cq = torch.randn((WB_M, WB_K), generator=g, device=dev)
    wi, wq = bank.synthesize(ci, cq)
    yi, yq = bank.analyze(wi, wq)
    t1, t2 = ("time",), (None, "time")
    ai_, aq_ = run.call(par.sharded_analyze_fn(bank, tm), blk(wi, tm, t1),
                        blk(wq, tm, t1))
    run.close("sharded_analyze_fn i", ai_, blk(yi, tm, t2))
    run.close("sharded_analyze_fn q", aq_, blk(yq, tm, t2))
    si, sq = run.call(par.sharded_synthesize_fn(bank, tm), blk(ci, tm, t2),
                      blk(cq, tm, t2))
    run.close("sharded_synthesize_fn i", si, blk(wi, tm, t1))
    run.close("sharded_synthesize_fn q", sq, blk(wq, tm, t1))
    xi, xq = run.call(par.wideband_tx_fn(bank, tm), blk(ci, tm, t1),
                      blk(cq, tm, t1))
    run.close("wideband_tx_fn i (all-to-all re-deal)", xi, blk(wi, tm, t1))
    run.close("wideband_tx_fn q", xq, blk(wq, tm, t1))
    zi, zq = run.call(par.wideband_rx_fn(bank, tm), xi, xq)
    run.close("wideband_rx_fn i", zi, blk(yi, tm, t1))
    run.close("wideband_rx_fn q", zq, blk(yq, tm, t1))
    wrx = wb_receiver(dev)
    wbits = acq_bits(WB_M, WB_PAYLOAD, g, dev)
    wm = WidebandModem(wrx, WB_M, WB_PAYLOAD, mesh=tm)
    lb = blk(wbits, tm, t1)
    wwi, wwq = run.call(wm.tx, lb)
    run.same("WidebandModem(mesh=) every bit (K4, 65 taps)",
             run.call(wm.rx, wwi, wwq), lb)
    if run.world == 1:
        solo = WidebandModem(wrx, WB_M, WB_PAYLOAD)
        swi, swq = solo.tx(wbits)
        run.close("WidebandModem(mesh=) tx i", wwi, swi)
        run.close("WidebandModem(mesh=) tx q", wwq, swq)

    # LinkStats.psum and halo_mismatch
    flips = (torch.rand(bits.shape, generator=g, device=dev) < 0.01).to(
        torch.int32)
    stats = LinkStats.zero(dev).update_bits(bl, blk(bits ^ flips))
    stats = stats.psum(ct.get_group("time")).psum(ct.get_group("ch"))
    run.same("LinkStats.psum bit errors", stats.bit_err,
             flips.sum().to(torch.int64))
    run.same("LinkStats.psum bits", stats.bit_tot,
             torch.tensor(bits.numel(), device=dev))
    k, h = chain.rrc.shape[0], SH_HALO
    n_l = n // tm.size(1)
    lo = t_tm * n_l - h
    if t_tm == 0:  # coordinate 0 has no overlap to check
        y = torch.cat([torch.zeros((CHANNELS, h), device=dev),
                       fir_filter(x[..., :n_l], chain.rrc)[0]], -1)
    else:  # the neighbour's last h outputs recomputed from its inputs
        y = fir_filter(x[..., lo:lo + n_l + h], chain.rrc,
                       x[..., lo - (k - 1):lo])[0]
    run.waves["halo_mismatch, K4 overlap-save"] = float(
        run.call(halo_mismatch, y, tm, h))


def print_sharded(tag: str, bits: dict, waves: dict, launches,
                  exact_waves: bool) -> None:
    """Print every check; fail on any decision that differs, on a
    waveform past its bar (0.0 in a world of one) or on an overlap-save
    that disagrees."""
    for label, nbad in bits.items():
        print(f"[{tag}] {label}: {nbad} mismatched", flush=True)
    for label, diff in waves.items():
        print(f"[{tag}] {label}: largest difference {diff:.3e} of the "
              f"largest value", flush=True)
    print(f"[{tag}] sharded launches: {json.dumps(launches)}", flush=True)
    bad = [lb for lb, nbad in bits.items() if nbad]
    bar = 0.0 if exact_waves else SH_WAVE_RTOL
    bad += [lb for lb, d in waves.items()
            if d > bar or ("halo_mismatch" in lb and d != 0.0)]
    if bad:
        fail(f"{tag}: {bad}")


def sharded_ber_line(tag: str, err: int, tot: int, card: str) -> None:
    from modem_tpu_torch.harness import qpsk_ber_theory

    ber, theory = err / tot, qpsk_ber_theory(ES_N0_DB)
    print(f"[{tag}] fused_ber_fn QPSK {ES_N0_DB} dB: {err} / {tot} = "
          f"{ber:.6e} (closed form {theory:.6e}, {ber / theory:.4f}), on "
          f"{card}", flush=True)
    if abs(ber / theory - 1) > BER_RTOL:
        fail(f"{tag}: sharded BER {ber} not within 10% of {theory}")


def phase_nccl_world_of_one(device, card: str) -> dict:
    """Phase 56: a world of one over NCCL on the card (``initialize_
    multihost``, a 1x1 mesh): every sharded entry point at full width
    equals the single-device port's call bit for bit, waveforms included;
    each of K1-K4, K6, K11-K13 launched by the sharded calls; one NCCL
    ``all_reduce`` on the card. Phase 58's first half: per-call wall,
    device busy, idle share and CUDA launches of the sharded fused
    roundtrip against ``roundtrip_fused``. Returns the sharded calls'
    launches by K number."""
    import torch.distributed as dist
    from modem_tpu_torch import Rates, qpsk_reference_chain
    from modem_tpu_torch.parallel import ShardedPulseChain
    from modem_tpu_torch.parallel.multihost import _free_port, \
        initialize_multihost

    mesh = initialize_multihost(
        ch=1, time=1, coordinator_address=f"localhost:{_free_port()}",
        num_processes=1, process_id=0, backend="nccl", device=device)
    probe = torch.ones(4, device=device)
    dist.all_reduce(probe)
    backend = dist.get_backend(mesh.get_group("time"))
    print(f"[nccl 1x1] world {dist.get_world_size()}, transport {backend}; "
          f"all_reduce on the card: {probe.tolist()}", flush=True)
    if backend != "nccl" or probe.tolist() != [1.0] * 4:
        fail("the NCCL world of one")
    run = ShardedRun({"ct": mesh, "t": mesh}, device, 1)
    sharded_checks(run)
    print_sharded("nccl 1x1", run.bits, run.waves, run.launches, True)
    for k, n in run.launches.items():
        if n == 0:
            fail(f"the sharded calls never launched {k}")
    sharded_ber_line("nccl 1x1", *run.ber, card)

    chain = qpsk_reference_chain(Rates(1250, 10000), device=device)
    g = torch.Generator(device=device).manual_seed(SEED + 203)
    bits = torch.randint(0, 2, (CHANNELS, 2 * N_SYMBOLS), generator=g,
                         device=device, dtype=torch.int32)
    fused = ShardedPulseChain(chain, mesh).fused_roundtrip_fn()
    staged = ShardedPulseChain(chain, mesh).roundtrip_fn()
    for name, fn, args in (
            ("roundtrip_fused (single device)", chain.roundtrip_fused,
             (bits,)),
            ("fused_roundtrip_fn (1x1 mesh)", fused, (bits, 0)),
            ("roundtrip (single device, staged)", chain.roundtrip, (bits,)),
            ("roundtrip_fn (1x1 mesh, staged)", staged, (bits, 0))):
        ms = time_calls(fn, args, device, calls=SH_CALLS)
        busy = device_busy_ms(fn, args, device, calls=SH_CALLS)
        print(f"[times] {name:36s} per call {ms:.4f} ms, device busy "
              f"{busy:.4f} ms (idle share {1 - busy / ms:.3f}), "
              f"{cuda_launches(fn, args, device)} CUDA launches a call, "
              f"{CHANNELS} ch x {N_SYMBOLS} sym, on {card}", flush=True)
    dist.destroy_process_group()
    return run.launches


def sharded_rank(rank: int, world: int, port: int, queue) -> None:
    """One of the four ranks of phase 57, a process of its own on the one
    card over a gloo group (CUDA tensors staged through the host)."""
    import torch.distributed as dist
    from modem_tpu_torch import Rates, cuda, qpsk_reference_chain
    from modem_tpu_torch.parallel import ShardedPulseChain, make_modem_mesh
    from modem_tpu_torch.parallel.collectives import all_gather, pmax, psum
    from modem_tpu_torch.parallel.multihost import initialize_multihost

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda.library()
    ct = initialize_multihost(
        ch=2, time=2, coordinator_address=f"localhost:{port}",
        num_processes=world, process_id=rank, backend="gloo", device="cuda")
    tm = make_modem_mesh(ch=1, time=world, device_type="cuda")
    device = torch.device("cuda", torch.cuda.current_device())
    run = ShardedRun({"ct": ct, "t": tm}, device, world)
    sharded_checks(run)

    chain = qpsk_reference_chain(Rates(1250, 10000), device=device)
    sc = ShardedPulseChain(chain, ct)
    g = torch.Generator(device=device).manual_seed(SEED + 203)
    bits = sc.shard_bits(torch.randint(0, 2, (CHANNELS, 2 * N_SYMBOLS),
                                       generator=g, device=device,
                                       dtype=torch.int32))
    fn = sc.fused_roundtrip_fn()
    for _ in range(2):
        fn(bits, 0)
    torch.cuda.synchronize(device)
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(SH_CALLS):
        fn(bits, 0)
    torch.cuda.synchronize(device)
    wall = (time.perf_counter() - t0) / SH_CALLS * 1e3

    world_g = dist.group.WORLD
    nbad = psum(torch.tensor(list(run.bits.values()), device=device),
                world_g)
    diffs = pmax(torch.tensor(list(run.waves.values()), device=device),
                 world_g)
    counts = all_gather(torch.tensor(list(run.launches.values()),
                                     device=device), world_g)
    walls = all_gather(torch.tensor([wall], device=device), world_g)
    if rank == 0:
        queue.put({
            "transport": dist.get_backend(ct.get_group("time")),
            "staged": dist.get_backend(ct.get_group("time")) == "gloo",
            "bits": dict(zip(run.bits, nbad.tolist())),
            "waves": dict(zip(run.waves, diffs.tolist())),
            "launches": {f"rank {r} (ch {r // 2}, t {r % 2}; 1x4 t {r})":
                         dict(zip(run.launches, row))
                         for r, row in enumerate(counts.tolist())},
            "ber": run.ber, "walls": walls.flatten().tolist()})
    dist.barrier()
    dist.destroy_process_group()


def phase_four_ranks(card: str) -> None:
    """Phase 57: four processes (``spawn``) on the one card, each a rank of
    a gloo world (NCCL refuses two ranks on one device), meshes 2x2 and
    1x4: every rank makes the global input from the seed, runs the
    single-device entry point on the card and its own sharded call, and
    holds its block (decisions bit for bit; waveforms within 1e-5 of the
    largest value, K2's and K11's expected exact; mismatches summed, the
    largest differences maxed over the ranks); each rank's launches of K1-K4,
    K6, K11-K13 read, every rank (those with t > 0 among them) launching
    each; the sharded QPSK BER at 7 dB within 10% of the closed form.
    Phase 58's second half: the per-rank wall of the sharded fused
    roundtrip, four ranks sharing one card (not a scaling number)."""
    import torch.multiprocessing as mp
    from modem_tpu_torch.parallel.multihost import _free_port

    t0 = time.perf_counter()
    queue = mp.get_context("spawn").SimpleQueue()
    ranks = mp.spawn(sharded_rank, args=(SH_WORLD, _free_port(), queue),
                     nprocs=SH_WORLD, join=False)
    res = None
    while not ranks.join(timeout=1):  # raises if a rank failed
        if res is None and not queue.empty():  # drained before the join
            res = queue.get()
    if res is None:
        res = queue.get()
    print(f"[4 ranks] {SH_WORLD} processes on one card, transport "
          f"{res['transport']}"
          f"{' (CUDA tensors staged through the host)' if res['staged'] else ''}"
          f", {time.perf_counter() - t0:.1f} s with their start", flush=True)
    print_sharded("4 ranks", res["bits"], res["waves"], res["launches"],
                  False)
    for who, counts in res["launches"].items():
        missing = [k for k, n in counts.items() if n == 0]
        if missing:
            fail(f"4 ranks: {who} never launched {missing}")
    sharded_ber_line("4 ranks", *res["ber"], card)
    walls = res["walls"]
    print(f"[times] fused_roundtrip_fn, 2x2 mesh, 128 ch x 2048 sym a rank, "
          f"four ranks sharing one card over gloo: per-rank wall "
          f"{', '.join(f'{w:.4f}' for w in walls)} ms a call (ranks sharing "
          f"one card, not a scaling number), on {card}", flush=True)


# the FIR engine's other backends (phase 59): conv1d with the reversed taps,
# the banded Toeplitz matmul and chunked overlap-save FFT, each held to K4
# ("direct") at the reference path's and the flagship's widths
FIR_BACKENDS = ("conv", "matmul", "fft")
#: the outputs of ``fir_backend_outputs`` that are bits: held equal
BACKEND_BITS = ("rx bits", "roundtrip_fn bits")


def fir_backend_outputs(backend: str, device, x, bits, mesh) -> dict:
    """One pass of every entry point that takes ``fir_backend=backend``:
    ``Demodulator.lock_phase`` and ``demodulate`` on the reference path's
    passband ``x``; the flagship's staged ``tx`` and ``rx`` on ``bits``;
    ``sharded_fir`` over the TX's I rail and the staged
    ``ShardedPulseChain.roundtrip_fn`` on ``mesh``. ``{label: (tensor,
    scale)}``, the scale the largest |input| of each output (None: bits,
    held equal)."""
    from modem_tpu_torch import Demodulator, Rates, qpsk_reference_chain
    from modem_tpu_torch import parallel as par
    from modem_tpu_torch.ops.pll import LOCK_SAMPLES

    dem = Demodulator(REF_CF, REF_SR, fir_backend=backend, device=device)
    st = dem.lock_phase(x[:, :LOCK_SAMPLES], dem.init_state((x.shape[0],)))
    (i, q), _ = dem.demodulate(x[:, LOCK_SAMPLES:], st)
    chain = qpsk_reference_chain(Rates(1250, 10000), fir_backend=backend,
                                 device=device)
    wave = chain.tx(bits)
    sc = par.ShardedPulseChain(chain, mesh)
    px, pw = float(x.abs().max()), float(wave[0].abs().max())
    return {"Demodulator phase": (st.phase_offset, math.pi),
            "Demodulator i": (i, px), "Demodulator q": (q, px),
            "tx i": (wave[0], pw), "tx q": (wave[1], pw),
            "rx bits": (chain.rx(wave, N_SYMBOLS), None),
            "sharded_fir": (par.sharded_fir(wave[0], chain.rrc, mesh,
                                            backend=backend), pw),
            "roundtrip_fn bits": (sc.roundtrip_fn()(sc.shard_bits(bits), 0),
                                  None)}


def backend_times(backend: str, device, x, bits, card: str) -> None:
    """Per call (CUDA events), device busy (the profiler) and CUDA launches
    of ``fir_filter(backend=...)`` at the demodulator's lowpass (64 taps,
    256 x 32784) and the flagship's matched filter (65 taps, 256 x 32832),
    ``Demodulator.demodulate`` on a locked block and the flagship's staged
    ``tx`` and ``rx``."""
    from modem_tpu_torch import Demodulator, Rates, qpsk_reference_chain
    from modem_tpu_torch.ops.fir import fir_filter
    from modem_tpu_torch.ops.pll import LOCK_SAMPLES

    dem = Demodulator(REF_CF, REF_SR, fir_backend=backend, device=device)
    locked = dem.lock_phase(x[:, :LOCK_SAMPLES],
                            dem.init_state((x.shape[0],)))
    chain = qpsk_reference_chain(Rates(1250, 10000), fir_backend=backend,
                                 device=device)
    wave = chain.tx(bits)
    rest = x[:, LOCK_SAMPLES:].contiguous()
    for name, fn, args, n in (
            ("fir_filter, 64 taps", fir_filter,
             (rest, dem.lowpass, None, backend), rest.numel()),
            ("fir_filter, 65 taps", fir_filter,
             (wave[0], chain.rrc, None, backend), wave[0].numel()),
            ("Demodulator.demodulate", dem.demodulate, (rest, locked),
             rest.numel()),
            ("chain.tx (staged)", chain.tx, (bits,), wave[0].numel()),
            ("chain.rx (staged)", chain.rx, (wave, N_SYMBOLS),
             wave[0].numel())):
        ms = time_calls(fn, args, device)
        busy = device_busy_ms(fn, args, device)
        print(f"[fir backends] times {backend:6s} {name:24s} per call "
              f"{ms:.4f} ms ({n / ms * 1e3:.4e} samples/s), device busy "
              f"{busy:.4f} ms, {cuda_launches(fn, args, device)} CUDA "
              f"launches a call, {x.shape[0]} ch x {n // x.shape[0]} "
              f"samples, on {card}", flush=True)


def phase_fir_backends(device, card: str) -> None:
    """Phase 59: ``fir_filter``'s ``conv``, ``matmul`` and ``fft`` backends
    through every entry point that takes ``fir_backend=``, at full width in
    an NCCL world of one: each output held to K4's (``direct``) within
    ``ATOL`` of its input's largest value, bits equal (and to the sent
    bits); no K4 launch on a backend's path, K4's on ``direct``'s; each
    backend again under PyTorch's default math settings (cuDNN TF32 on),
    within the same bound of its TF32-off run. Then each backend's and
    K4's times, with ``conv1d``'s at the FIR shapes."""
    import torch.distributed as dist
    import torch.nn.functional as F
    from modem_tpu_torch import Rates, qpsk_reference_chain
    from modem_tpu_torch.ops import filters, fir
    from modem_tpu_torch.parallel.multihost import _free_port, \
        initialize_multihost

    mesh = initialize_multihost(
        ch=1, time=1, coordinator_address=f"localhost:{_free_port()}",
        num_processes=1, process_id=0, backend="nccl", device=device)
    g = torch.Generator(device=device).manual_seed(SEED + 300)
    _, _, x, _, _, _ = reference_path(device, ref_bits(g, device))
    bits = torch.randint(0, 2, (CHANNELS, 2 * N_SYMBOLS), generator=g,
                         device=device, dtype=torch.int32)
    reset_launches()
    want = fir_backend_outputs("direct", device, x, bits, mesh)
    torch.cuda.synchronize(device)
    k4 = fir.FIR_KERNEL.launches
    if k4 == 0:
        fail("the direct backend's paths never launched K4")
    for label in BACKEND_BITS:
        if not torch.equal(want[label][0], bits):
            fail(f"direct {label}: the bits did not come back")
    print(f"[fir backends] direct (K4): {k4} K4 launches over the paths; "
          f"x {tuple(x.shape)}, bits {tuple(bits.shape)}", flush=True)
    for b in FIR_BACKENDS:
        reset_launches()
        got = fir_backend_outputs(b, device, x, bits, mesh)
        torch.cuda.synchronize(device)
        if fir.FIR_KERNEL.launches:
            fail(f"{b}: launched K4 {fir.FIR_KERNEL.launches} times")
        with pytorch_defaults("59"):
            again = fir_backend_outputs(b, device, x, bits, mesh)
            torch.cuda.synchronize(device)
        for label, (y, scale) in got.items():
            w, y2 = want[label][0], again[label][0]
            if scale is None:
                if not (torch.equal(y, w) and torch.equal(y2, w)):
                    fail(f"{b} {label}: bits differ from K4's")
                print(f"[fir backends] {b:6s} {label:20s} equal to K4's and "
                      "to the sent bits, TF32 off and on", flush=True)
                continue
            err, tf = max_err(y, w), max_err(y2, y)
            tol = ATOL * scale
            print(f"[fir backends] {b:6s} {label:20s} max |{b} - K4| = "
                  f"{err:.3e}, TF32 on vs off {tf:.3e} (tol {tol:.3e}: "
                  f"{ATOL} x {scale:.4f})", flush=True)
            if err > tol or tf > tol:
                fail(f"{b} {label}: {err} / {tf} past {tol}")
    dist.destroy_process_group()

    for b in ("direct",) + FIR_BACKENDS:
        backend_times(b, device, x, bits, card)
    chain = qpsk_reference_chain(Rates(1250, 10000), device=device)
    lowpass = torch.as_tensor(filters.lowpass_taps(sample_rate=REF_SR),
                              device=device)
    for sig, taps in ((x[:, 64:], lowpass), (chain.tx(bits)[0], chain.rrc)):
        k = taps.shape[0]
        xp = F.pad(sig, (k - 1, 0)).unsqueeze(1)
        w = taps.flip(0).reshape(1, 1, k)
        ms = time_calls(F.conv1d, (xp, w), device)
        busy = device_busy_ms(F.conv1d, (xp, w), device)
        print(f"[fir backends] times conv1d (the library call, TF32 off) "
              f"{k} taps per call {ms:.4f} ms, device busy {busy:.4f} ms, "
              f"{sig.shape[0]} ch x {sig.shape[1]} samples, on {card}",
              flush=True)


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


def k15_chain_ops(code) -> int:
    """K15's serial chain a codeword, in dependent f32 operations: at every
    node outside the skipped (all-frozen) subtrees an f (K16_F_OPS, a left
    child) or a g (K16_G_OPS, a right child), and K15_LEAF_OPS at every
    information leaf."""
    fz, ops, w = code.frozen, 0, 1
    while w < code.n:
        for lo in range(0, code.n, w):
            if not fz[lo:lo + w].all():
                ops += K16_F_OPS if lo % (2 * w) == 0 else K16_G_OPS
        w *= 2
    return ops + int((~fz).sum()) * K15_LEAF_OPS


def print_k15_floor(name: str, code, cws: int, t, card: str) -> None:
    """K15's serial floor: one codeword's chain (:func:`k15_chain_ops`) at
    K14_CHAIN_CYCLES an operation, at the card's SM clock; every codeword
    runs at once, so no call can be shorter."""
    ms, _, dev_ms, _, _ = t
    dev = dev_ms or ms
    ops = k15_chain_ops(code)
    clock = sm_clock_mhz()
    floor_ms = ops * K14_CHAIN_CYCLES / clock / 1e3
    print(f"[times] {name}: {dev / code.n * 1e6:.2f} ns "
          f"({dev / code.n * clock * 1e3:.1f} cycles at {clock:.0f} MHz) a "
          f"leaf over {cws} codewords; serial floor {floor_ms:.6f} ms ({ops} "
          f"dependent f32 operations x {K14_CHAIN_CYCLES} cycles a codeword, "
          f"the skipped subtrees left out), {100 * floor_ms / dev:.1f}% of it,"
          f" on {card}", flush=True)


def print_fec_times(name: str, shape: str, t, card: str) -> None:
    ms, plain_ms, dev_ms, _, (nbytes, flops) = t
    dev_txt = "not measured" if dev_ms is None else f"{dev_ms:.4f} ms"
    bound_ms, bound_by = bound(nbytes, flops)
    print(f"[times] {name:26s} per call: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, no library call; kernel alone in the profiler "
          f"{dev_txt}; bound {bound_ms:.6f} ms by {bound_by} "
          f"({nbytes / 1e6:.3f} MB, {flops / 1e9:.4f} GFLOP); {shape} on "
          f"{card}", flush=True)


def f32_ceiling(device, card: str) -> float:
    """The card's attained float32 rate in FLOP/s: one ``torch.mm`` of two
    MM_CEILING_N x MM_CEILING_N float32 matrices with TF32 off, CUDA-event
    median of 5 runs of 3 calls; printed with the SM clock ``nvidia-smi``
    reads while a run of them is queued. A yardstick only: the port never
    calls it."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        g = torch.Generator(device=device).manual_seed(SEED + 171)
        a, b = (torch.randn((MM_CEILING_N, MM_CEILING_N), generator=g,
                            device=device) for _ in range(2))
        ms = time_calls(torch.mm, (a, b), device, calls=3)
        for _ in range(40):  # about a second of work queued
            torch.mm(a, b)
        clock = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
        torch.cuda.synchronize(device)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    rate = 2 * MM_CEILING_N ** 3 / (ms * 1e-3)
    print(f"[times] f32 ceiling: torch.mm {MM_CEILING_N}^2 x "
          f"{MM_CEILING_N}^2, TF32 off: {ms:.4f} ms, {rate / 1e12:.2f} "
          f"TFLOP/s ({rate / F32_FLOP_PER_S:.3f} of the published "
          f"{F32_FLOP_PER_S / 1e12:.0f}); SM clock and power under it: "
          f"{clock}; on {card}", flush=True)
    return rate


def print_shares(name: str, flops: float, dev_ms: float, ceiling: float,
                 card: str) -> None:
    """The f32 rate a kernel attained in the profiler, as a share of the
    published 67 TFLOP/s and of the measured ``torch.mm`` ceiling."""
    rate = flops / (dev_ms * 1e-3)
    print(f"[times] {name}: {rate / 1e12:.2f} TFLOP/s, "
          f"{rate / F32_FLOP_PER_S:.3f} of {F32_FLOP_PER_S / 1e12:.0f} "
          f"TFLOP/s, {rate / ceiling:.3f} of torch.mm's "
          f"{ceiling / 1e12:.2f}; on {card}", flush=True)


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


# ---- phase 60: the launch path every kernel shares ----

#: (channels, symbols) where a launch's host work outweighs the kernel's
LAUNCH_SMALL = (4, 64)
LAUNCH_AFTER_WARM = 20           # launches of an entry that ask the runtime nothing
K4_LAUNCHES = 100
#: K4's shapes beside fir_filter(conv): the acquisition's capture at 4, 13
#: and 63 taps, its matched filter at 65, the OFDM fine timing at 240
K4_SHAPES = {4: (64, 4416), 13: (64, 4416), 63: (64, 4416), 65: (64, 4505),
             240: (256, 335)}


def launch_cases(chain, device, shape) -> dict:
    """For each C entry of the kernel library, ``(label, its wrapper, args)``
    at ``shape`` = (channels, symbols): the chains' symbols, 8 samples a
    symbol for K4 and K5 (the demodulator's 64-tap lowpass), 4 bits a
    symbol for K6-K10, a bit a symbol for K13 (the CCSDS code; its block
    core and, forced, its long route at K = 15). At the full shape,
    ``(CHANNELS, N_SYMBOLS)``, each takes §6's inputs: K13's block route 16
    x 1024 bits, K14 the rows of
    ``TurboCode(1024)`` x 512 codewords, K15 and K16 ``PolarCode(256,
    128)`` x 4096; at a small one a codeword a channel (K14 at
    ``TurboCode(40)``)."""
    from modem_tpu_torch.fec import PolarCode, TurboCode, crc16_ccitt
    from modem_tpu_torch.models.base import f32
    from modem_tpu_torch.ops import (bcjr_kernel as bk, chain_kernel as ck,
                                     demod_kernel as dk, fir, filters,
                                     fsk_kernel as fk, sc_kernel as sk,
                                     scl_kernel as lk, txrx,
                                     viterbi_kernel as vk)

    c, k = shape
    full = shape == (CHANNELS, N_SYMBOLS)
    gen = torch.Generator(device=device).manual_seed(SEED + 160)
    syms = random_symbols(shape, device, False)
    lut, rrc, sps, span = chain.lut, chain.rrc, chain.sps, chain.span
    wi, wq = txrx.tx_plain(syms, lut, rrc, sps, span)
    lowpass = torch.as_tensor(filters.lowpass_taps(sample_rate=REF_SR),
                              device=device)
    mfsk, _, msk, _ = fsk_chains(device)
    bits = torch.randint(0, 2, (c, 4 * k), generator=gen, device=device,
                         dtype=torch.int32)
    prog = mfsk._phase_program(bits)
    qs = f32(prog.qshift)
    targets = fk._candidate_increments(fk.fsk_coef_table(mfsk.scheme),
                                       prog.den, device)
    fi, fq = fk.fsk_tx_plain(prog.fnum, prog.pnum, prog.den, mfsk.sps, 1.0,
                             qs)
    s0, s1 = msk._slot_signs(bits[:, :2 * k])
    rs = {n: (fn, a) for n, fn, _, a, _ in
          rs_cases(resampled_chain(device), shape, device, SEED + 161)}
    code, _, lam = vit_case(7, (0o171, 0o133), shape, 0.8, SEED + 162,
                            device)
    k15_shape = WIDE_VIT_SHAPE if full else (2, k)
    k15, _, lam15 = vit_case(*WIDE_VIT["viterbi_k15"], k15_shape, 0.8,
                             SEED + 163, device)
    block = min(VIT_BLOCK, k)
    turbo = TurboCode(TURBO_K if full else 40)
    _, tllr = turbo_llrs(turbo, TURBO_CW if full else c, TURBO_SNR_DB,
                         SEED + 164, device)
    rows, guard, window = turbo_rows(turbo, tllr)[0]
    polar = PolarCode(POLAR_N, POLAR_K)
    _, plam = polar_llrs(polar, crc16_ccitt(), POLAR_CW if full else c,
                         POLAR_SIGMAS[0], SEED + 165, device)
    x = unit((c, 8 * k), gen, device)
    return {
        "modem_chain": ("K1", ck.chain_kernel, (syms, lut, rrc, sps, span)),
        "modem_tx": ("K2", txrx.tx_kernel, (syms, lut, rrc, sps, span)),
        "modem_rx_hard": ("K3", txrx.rx_kernel,
                          (wi, wq, k, lut, rrc, sps, span, False)),
        "modem_rx_soft": ("K3 soft", txrx.rx_kernel,
                          (wi, wq, k, lut, rrc, sps, span, True)),
        "modem_chain_first": ("K1 first", functools.partial(
            ck.chain_kernel, first=True), (syms, lut, rrc, sps, span)),
        "modem_rx_hard_first": ("K3 first", functools.partial(
            txrx.rx_kernel, first=True),
                                (wi, wq, k, lut, rrc, sps, span, False)),
        "modem_rx_soft_first": ("K3s first", functools.partial(
            txrx.rx_kernel, first=True),
                                (wi, wq, k, lut, rrc, sps, span, True)),
        "modem_fir": ("K4", fir.fir_kernel, (x, lowpass)),
        "modem_fir_long_first": ("K4 first", functools.partial(
            fir.fir_kernel, first=True), (x, lowpass)),
        "modem_demod": ("K5", dk.demod_kernel,
                        demod_case(lowpass, (c, 8 * k), gen, device)),
        "modem_fsk_chain": ("K6", fk.fsk_chain_kernel,
                            (prog.fnum, prog.pnum, targets, prog.den,
                             mfsk.sps, 1.0, qs, 1, 256, None, SEED + 166)),
        "modem_fsk_tone_table": ("K6 table", fk.tone_table_kernel,
                                 (prog.den, 1.0, qs, device)),
        "modem_msk_chain": ("K7", fk.msk_chain_kernel,
                            (s0, s1, msk.spb, 1.0, 1, 256, None, SEED + 167)),
        "modem_fsk_tx": ("K8", fk.fsk_tx_kernel,
                         (prog.fnum, prog.pnum, prog.den, mfsk.sps, 1.0, qs)),
        "modem_disc_means": ("K9", fk.disc_means_kernel,
                             (fi, fq, mfsk.sps, 1)),
        "modem_msk_tx": ("K10", fk.msk_tx_kernel, (s0, s1, msk.spb, 1.0)),
        "modem_resampled_tx": ("K11", *rs["fused_resampled_tx"]),
        "modem_resampled_rx": ("K12", *rs["fused_resampled_rx"]),
        "modem_viterbi": ("K13", vk.stream_kernel,
                          (code, lam, block, VIT_HALO, 1e6)),
        "modem_viterbi_block": ("K13 long", functools.partial(
            vk.stream_kernel, long_route=True),
                                (k15, lam15, min(WIDE_VIT_BLOCK, k), 150,
                                 1e6)),
        "modem_viterbi_block_core": ("K13 core", vk.stream_kernel,
                                     (k15, lam15, min(WIDE_VIT_BLOCK, k),
                                      150, 1e6)),
        "modem_bcjr": ("K14", bk.rows_kernel, (rows, guard, window)),
        "modem_polar_sc": ("K15", sk.sc_kernel, (polar, plam)),
        "modem_polar_scl": ("K16", lk.scl_kernel, (polar, plam)),
    }


def host_us_a_call(fn, args, device, calls=50, reps=3) -> float:
    """Median over ``reps`` of the host time a call of ``calls`` calls back
    to back, not waiting for the card, in microseconds."""
    out = []
    for _ in range(reps):
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        for _ in range(calls):
            fn(*args)
        out.append((time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize(device)
    return statistics.median(out)


def queries_still(what: str, fn, args, calls: int) -> None:
    """Fails unless ``calls`` calls of ``fn`` make no runtime query (device
    attributes, occupancy, shared-memory opt-ins) of the kernel library."""
    from modem_tpu_torch import cuda

    before = cuda.host_queries()
    for _ in range(calls):
        fn(*args)
    torch.cuda.synchronize()
    moved = cuda.host_queries() - before
    if moved:
        fail(f"{what}: {moved} runtime queries over {calls} launches after "
             "the first")


def phase_launch_path(chain, device, card: str) -> None:
    """Phase 60: the launch path every kernel shares. Each C entry at a
    small shape and at §6's, through its wrapper: after two warm-up calls
    LAUNCH_AFTER_WARM more ask the runtime nothing (K4: K4_LAUNCHES), then
    host microseconds and CUDA-event milliseconds a call; K4 beside
    ``fir_filter(conv)`` at K4_SHAPES."""
    from modem_tpu_torch import cuda
    from modem_tpu_torch.ops import fir

    print(f"[launch] runtime queries so far: {cuda.host_queries()}",
          flush=True)
    for shape in (LAUNCH_SMALL, (CHANNELS, N_SYMBOLS)):
        for sym, (label, fn, args) in launch_cases(chain, device,
                                                   shape).items():
            for _ in range(2):
                fn(*args)
            queries_still(f"{sym} at {shape}", fn, args,
                          K4_LAUNCHES if sym == "modem_fir"
                          else LAUNCH_AFTER_WARM)
            host = host_us_a_call(fn, args, device)
            ms = time_calls(fn, args, device)
            print(f"[launch] {sym:21s} ({label:9s}) {shape[0]:3d} x "
                  f"{shape[1]:4d}: host {host:8.2f} us a call, CUDA events "
                  f"{ms:.4f} ms a call, on {card}", flush=True)
    taps = dict(acq_taps(device))
    taps[65] = chain.rrc
    gen = torch.Generator(device=device).manual_seed(SEED + 170)
    taps[240] = unit((240,), gen, device) / 240 ** 0.5
    for k, (c, n) in K4_SHAPES.items():
        x = unit((c, n), gen, device)
        row = []
        for backend in ("direct", "conv"):
            args = (x, taps[k], None, backend)
            for _ in range(2):
                fir.fir_filter(*args)
            queries_still(f"fir_filter({backend}) at {k} taps",
                          fir.fir_filter, args, LAUNCH_AFTER_WARM)
            row.append((backend, host_us_a_call(fir.fir_filter, args, device),
                        time_calls(fir.fir_filter, args, device)))
        print(f"[launch] fir_filter {k:3d} taps, {c} x {n}: " + "; ".join(
            f"{b} host {h:.2f} us, {ms:.4f} ms a call" for b, h, ms in row)
            + f", on {card}", flush=True)
    print(f"[launch] runtime queries in all: {cuda.host_queries()}",
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
    fsk_errs = phase_fsk_kernels(chains, device)
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
    long_errs, long_launches, long_times, long_extras = phase_long_route(
        device, card)
    errs.update(long_errs)
    launches.update(long_launches)
    times.update(long_times)
    launches.update(phase_fir_routes(device))
    phase_tx_routes(chain, device)
    phase_ldpc(device)
    ofdm_errs, ofdm_launches = phase_ofdm(device)
    errs.update(ofdm_errs)
    launches.update(ofdm_launches)
    phase_wifi_link(device)
    times.update(phase_wifi_times(device, card))
    errs.update(phase_acq_fir(device))
    launches.update(phase_acquire(device))
    phase_long_streams(device)
    phase_bch(device)
    times.update(phase_acq_times(device, card))
    with pytorch_defaults():
        phy_errs, phy_launches = phase_scfde(device)
        phase_scfde_link(device)
        phase_stbc_mimo(device)
        phase_loading(device)
    errs.update(phy_errs)
    launches.update(phy_launches)
    times.update(phase_phy_times(device, card))
    with pytorch_defaults("51-55"):
        phase_channelizer(device)
        phase_dsss(device)
        phase_fhss(device)
        phase_wideband(device)
        phase_wideband_times(device, card)
    sharded = phase_nccl_world_of_one(device, card)
    phase_four_ranks(card)
    phase_fir_backends(device, card)
    phase_launch_path(chain, device, card)

    entries = [(n, src, rep)
               for n, _, _, _, _, _, src, rep in kernel_cases(chain)] + [
        (fir_name(k), "modem_tpu_torch/csrc/fir.cu",
         "modem_tpu/ops/pallas_fir.py:44")
        for k in FIR_ROUTE_TAPS + (240,) + ACQ_FIR_TAPS + (160,)] + [
        (FIR_FIRST, "modem_tpu_torch/csrc/fir.cu",
         "modem_tpu/ops/pallas_fir.py:44")] + [
        (name, "modem_tpu_torch/csrc/demod.cu",
         "modem_tpu/ops/pallas_demod.py:43")
        for name in DEMOD_NAMES.values()] + [
        (n, "modem_tpu_torch/csrc/fsk.cu", f"modem_tpu/ops/pallas_fsk.py:{line}")
        for n, (line, _) in FSK_REPORT.items()] + [
        (n, src, rep) for n, (_, src, rep) in RS_REPORT.items()] + [
        (VIT_REPORT[0], VIT_REPORT[2], VIT_REPORT[3])] + [
        (n, f"modem_tpu_torch/csrc/{'chain' if kind == 'chain' else 'txrx'}"
            ".cu", rep) for n, kind, _, _, rep in mode_cases()] + [
        (n, VIT_REPORT[2], VIT_REPORT[3])
        for n in (*WIDE_VIT, "viterbi_k15_long")] + [
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
            "library_ms": lib_ms, "device_ms": dev_ms,
            "share": None if dev_ms is None else bound_ms / dev_ms})
        if n in fsk_errs and fsk_errs[n][1] is not None:
            report["kernels"][-1]["agreement"] = fsk_errs[n][1]
        if n in SHARDED_ENTRIES:
            report["kernels"][-1]["sharded_launches"] = \
                sharded[SHARDED_ENTRIES[n]]
        report["kernels"][-1].update(long_extras.get(n, {}))
    print(json.dumps(report))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
