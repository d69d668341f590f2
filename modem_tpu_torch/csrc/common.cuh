// Shared pieces of the kernels: the pulse-shaped chain's (txrx.cu,
// chain.cu: constellations, the passband NCO, waveform storage, the taps
// as a kernel parameter and the register-blocked matched filter), the
// causal FIR core of K4 and K5 (fir.cu, demod.cu: the same filter, the
// persistent tile walk's pieces) and the noise stream the FSK and
// pulse-shaped loopbacks draw (fsk.cu, chain.cu).
//
// Layout everywhere: one row per channel, time contiguous ([C, K] symbols,
// [C, N] waveform samples), threads along time. The constellation table
// arrives as a device array and is staged in shared memory; K1's and K3's
// RRC taps and K4's and K5's filter taps arrive by value in a kernel
// parameter (Taps), K2's as a device array from which it builds its
// polyphase bank in shared memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace modem {

constexpr int kThreads = 256;  // threads per block
constexpr int kTile = 256;     // symbols per block (time tile)
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr int kNcoTable = 2048;  // carrier phases held in a table, at most
constexpr int kLane = 128;     // channels per JAX tile (the noise keys)
constexpr int kMaxTaps = 256;  // taps K1, K3, K4 and K5 take (Taps, 1 KB)
constexpr int kMaxSps = 64;    // samples a symbol K1's and K3's tiles fit

// Filter taps by value. Passed as a __grid_constant__ kernel parameter, they
// live in the constant bank: with the filter loops unrolled at compile time
// each tap reaches its FFMA as a constant-bank or uniform-register operand,
// with no shared-memory or per-thread load, as the TPU kernel's taps baked
// in at trace time cost none.
struct Taps {
  float v[kMaxTaps];
};

// The long route of K1 and K3, for a chain past either limit (more than
// kMaxTaps taps, or more than kMaxSps samples a symbol): the taps arrive as
// a device array, which the kernel stages in shared memory and reads at a
// run-time index from there.
struct TapsPtr {
  const float* p;
};

// The kernel parameter of the short route (false) or the long one (true).
template <bool kLong>
using TapsArg = std::conditional_t<kLong, TapsPtr, Taps>;

// What the filters read a tap from: the parameter itself on the short
// route, the shared-memory copy `staged` on the long one.
__device__ __forceinline__ const Taps& tap_view(const Taps& t, const float*) {
  return t;
}

__device__ __forceinline__ const float* tap_view(const TapsPtr&,
                                                 const float* staged) {
  return staged;
}

__device__ __forceinline__ float tap(const Taps& t, int j) { return t.v[j]; }

__device__ __forceinline__ float tap(const float* t, int j) { return t[j]; }

// The symbol <-> I/Q map of the pulse-shaped chain: a table of n_points
// entries (lut, staged in shared memory by the kernel), or, with lut null,
// natural-binary square QAM from the bit halves
// (modem_tpu/ops/pallas_chain.py::_qam_map, ::_qam_slice): the symbol's top
// and bottom cshift bits give the levels pm, pl = 2*half - ms, and
//   i = a*(pm*c - pl*s),  q = a*(pl*c + pm*s).
// Every product and sum rounds once (__fmul_rn, __fadd_rn), as the plain
// version's separate tensor ops do, so the two decide alike at boundaries.
struct Constellation {
  const float* lut;
  int n_points;
  int cshift;
  float ms, a, c, s;
};

// The passband NCO (pallas_chain.py::_nco_cos_sin, pallas_txrx.py::_theta).
// sr == 0 is baseband. Call-local waveform sample s (sample 0 is stream
// symbol sym_offset's first) has the exact phase
//   u = (((s_off + s) mod sr) * hz) mod sr,
// s_off = ((sym_offset mod sr) * sps) mod sr with a floor mod (streams pass
// negative offsets), and the angle __fmul_rn(u, scale), scale =
// f32(2*pi/sr); the accurate cosf and sinf of that angle. u is always a
// multiple of g = gcd(hz, sr), so the kernels count the phase k = u / unit
// in units (unit = g where the carrier's n_ph = sr / g phases fit the
// table, else 1) over a period of n_ph (else sr) units, and advance it by
// `step` units a sample with a 32-bit add and one conditional subtract:
// no division and no 64-bit arithmetic a sample. Only the phase of a
// tile's first sample is reckoned in 64 bits. hz * sr < 2^31 (make_nco)
// bounds every 32-bit product below. The table holds the cosf and sinf of
// the same angles __fmul_rn(k * g, scale), bit-identical to per-sample ones.
struct Nco {
  int sr;       // 0: baseband
  int hz;
  int period;   // units a carrier cycle: n_ph with the table, else sr
  int step;     // units a sample: (hz mod sr) / unit
  int unit;     // g with the table, else 1
  int table;    // the carrier's phases come from the table
  int s_off;    // sample 0's offset mod sr
  float scale;
};

// Waveform storage: f32, bf16 (round to nearest even) or int16
// (clip(rint(x * out_scale), -32768, 32767)), one overload per type. The
// TX kernel is instantiated per type, so the f32 path compiles to plain
// float stores.
enum WaveKind { kF32 = 0, kBf16 = 1, kI16 = 2 };

__device__ __forceinline__ void store_wave(float* p, float x, float) {
  *p = x;
}

__device__ __forceinline__ void store_wave(__nv_bfloat16* p, float x, float) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ void store_wave(short* p, float x,
                                           float out_scale) {
  const float v =
      fminf(fmaxf(rintf(__fmul_rn(x, out_scale)), -32768.f), 32767.f);
  *p = static_cast<short>(v);
}

// The carrier phase's table, `period` entries of cos and sin, all threads.
__device__ inline void stage_nco(float* tc, float* ts, const Nco& n) {
  for (int k = threadIdx.x; k < n.period; k += blockDim.x) {
    const float th = __fmul_rn(static_cast<float>(k * n.unit), n.scale);
    tc[k] = cosf(th);
    ts[k] = sinf(th);
  }
}

// The phase, in units, of call-local sample s >= 0: 64-bit, once a tile.
__device__ __forceinline__ int nco_phase(const Nco& n, long long s) {
  const long long sm = (n.s_off + s % n.sr) % n.sr;
  return static_cast<int>((sm * n.hz) % n.sr) / n.unit;
}

// Phase k advanced by d >= 0 samples, in 32-bit integers.
__device__ __forceinline__ int nco_skip(const Nco& n, int k, int d) {
  return (k + (d % n.period) * n.step % n.period) % n.period;
}

// Phase k advanced by d units, 0 <= d < period.
__device__ __forceinline__ int nco_add(const Nco& n, int k, int d) {
  k += d;
  return k >= n.period ? k - n.period : k;
}

__device__ __forceinline__ void nco_cos_sin(const Nco& n, int k,
                                            const float* tc, const float* ts,
                                            float& c, float& s) {
  if (n.table) {
    c = tc[k];
    s = ts[k];
  } else {
    const float th = __fmul_rn(static_cast<float>(k), n.scale);
    c = cosf(th);
    s = sinf(th);
  }
}

// Square-QAM point of symbol index sym >= 0.
__device__ __forceinline__ void qam_point(int sym, const Constellation& m,
                                          float& zi, float& zq) {
  const float pm = __fsub_rn(2.f * static_cast<float>(sym >> m.cshift), m.ms);
  const float pl = __fsub_rn(
      2.f * static_cast<float>(sym & ((1 << m.cshift) - 1)), m.ms);
  zi = __fmul_rn(m.a, __fsub_rn(__fmul_rn(pm, m.c), __fmul_rn(pl, m.s)));
  zq = __fmul_rn(m.a, __fadd_rn(__fmul_rn(pl, m.c), __fmul_rn(pm, m.s)));
}

// The square-QAM slice: un-rotate, divide by a, round half to even and
// clip each half to [0, ms].
__device__ __forceinline__ int qam_slice(float ai, float aq,
                                         const Constellation& m) {
  const float pm = __fdiv_rn(__fadd_rn(__fmul_rn(ai, m.c), __fmul_rn(aq, m.s)),
                             m.a);
  const float pl = __fdiv_rn(__fsub_rn(__fmul_rn(aq, m.c), __fmul_rn(ai, m.s)),
                             m.a);
  const float hm = fminf(fmaxf(rintf(__fmul_rn(__fadd_rn(pm, m.ms), 0.5f)),
                               0.f), m.ms);
  const float hl = fminf(fmaxf(rintf(__fmul_rn(__fadd_rn(pl, m.ms), 0.5f)),
                               0.f), m.ms);
  return (static_cast<int>(hm) << m.cshift) | static_cast<int>(hl);
}

// Copy n floats from global to shared memory, all threads of the block.
__device__ inline void stage(float* dst, const float* __restrict__ src, int n) {
  for (int t = threadIdx.x; t < n; t += blockDim.x) dst[t] = src[t];
}

// Polyphase bank of the taps, [sps][kp] with kp = ceil(n_taps / sps):
// bank[p][k] = taps[k*sps + p], zero past the last tap.
__device__ inline void stage_bank(float* bank, const float* __restrict__ taps,
                                  int n_taps, int sps, int kp) {
  for (int t = threadIdx.x; t < sps * kp; t += blockDim.x) {
    const int p = t / kp;
    const int j = (t - p * kp) * sps + p;
    bank[t] = j < n_taps ? taps[j] : 0.f;
  }
}

// Constellation point of the symbol at global index g of a row of k_real
// symbols: zero I/Q before the stream (g < 0, the zero start state), after
// it (g >= k_real, the flush tail) and for any symbol outside the table
// (negative values are the streaming "no symbol here" sentinel).
__device__ inline void map_symbol(const int* __restrict__ row, long long g,
                                  long long k_real, const float* lut,
                                  int n_points, float& zi, float& zq) {
  zi = 0.f;
  zq = 0.f;
  if (g >= 0 && g < k_real) {
    const int s = row[g];
    if (s >= 0 && s < n_points) {
      zi = lut[2 * s];
      zq = lut[2 * s + 1];
    }
  }
}

// Minimum-distance slice; of equal distances the lowest index wins.
__device__ inline int nearest_point(float ai, float aq, const float* lut,
                                    int n_points) {
  int best = 0;
  float best_d = __int_as_float(0x7f800000);  // +inf
  for (int m = 0; m < n_points; ++m) {
    const float di = ai - lut[2 * m];
    const float dq = aq - lut[2 * m + 1];
    const float dist = di * di + dq * dq;
    if (dist < best_d) {
      best_d = dist;
      best = m;
    }
  }
  return best;
}

// map_symbol for either form of the map: slut is the table staged in shared
// memory (unused for QAM). A QAM symbol is any s >= 0, as in the JAX map.
__device__ inline void map_point(const int* __restrict__ row, long long g,
                                 long long k_real, const Constellation& m,
                                 const float* slut, float& zi, float& zq) {
  if (m.lut != nullptr) {
    map_symbol(row, g, k_real, slut, m.n_points, zi, zq);
    return;
  }
  zi = 0.f;
  zq = 0.f;
  if (g >= 0 && g < k_real) {
    const int s = row[g];
    if (s >= 0) qam_point(s, m, zi, zq);
  }
}

__device__ __forceinline__ int decide(float ai, float aq,
                                      const Constellation& m,
                                      const float* slut) {
  return m.lut != nullptr ? nearest_point(ai, aq, slut, m.n_points)
                          : qam_slice(ai, aq, m);
}

// The waveform tiles of K1 and K3 lie in shared memory in sample order,
// skewed: logical sample i at i + 4 * (i / 32). A thread of the matched
// filter reads the samples of R consecutive symbols, a run that starts on
// a multiple of 32 where R * sps is one (the flagship's R = 4, sps = 8), so
// the 8 threads of a quarter warp read their 16-byte pieces from 8
// different groups of 4 banks: no conflict.
__host__ __device__ __forceinline__ int skew(int i) {
  return i + ((i >> 5) << 2);
}

// Floats a skewed buffer of n logical samples takes, a multiple of 4.
__host__ __device__ __forceinline__ int skew_len(int n) {
  const int n32 = (n + 31) & ~31;
  return n32 + n32 / 8;
}

// 16-byte asynchronous copy from device memory to shared memory.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

// 4-byte asynchronous copy (an element of a row that is not 16-byte
// aligned).
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copy elements first .. n - 1 of src (device memory) to logical positions
// pos0 + first .. pos0 + n - 1 of dst (shared memory, skewed or not), all
// threads of the block: those below n_valid from src, the rest zero
// (samples past the end of the waveform read as zero). Where src and the
// destination are 16-byte aligned the whole 16-byte pieces go by cp.async
// (commit and wait are the caller's); a misaligned row, and a piece's head
// or tail, element by element: 4-byte elements by cp.async too, 2-byte
// ones by loads.
template <bool kSkew, typename T>
__device__ inline void load_span(T* dst, const T* __restrict__ src, int pos0,
                                 int n, int n_valid, int first = 0) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  int a = n, b = n;  // the pieces copy elements a .. b - 1
  if (((reinterpret_cast<uintptr_t>(src) |
        static_cast<uintptr_t>(pos0) * sizeof(T)) & 15) == 0) {
    const int p0 = (first + kVec - 1) / kVec;
    const int p1 = n_valid / kVec;
    if (p1 > p0) {
      a = p0 * kVec;
      b = p1 * kVec;
    }
    for (int k = p0 + threadIdx.x; k < p1; k += blockDim.x) {
      const int p = pos0 + k * kVec;
      cp_async16(dst + (kSkew ? skew(p) : p), src + k * kVec);
    }
  }
  auto one = [&](int e) {
    const int p = pos0 + e;
    T* d = dst + (kSkew ? skew(p) : p);
    if constexpr (sizeof(T) == 4) {
      if (e < n_valid)
        cp_async4(d, src + e);
      else
        *d = T(0);
    } else {
      *d = e < n_valid ? src[e] : T(0);
    }
  };
  for (int e = first + threadIdx.x; e < a; e += blockDim.x) one(e);
  for (int e = b + threadIdx.x; e < n; e += blockDim.x) one(e);
}

// The register-blocked filter of K1, K3 (the polyphase matched filter, two
// rails) and K4, K5 (a causal FIR, SPS = 1; K4 one rail, K5 two): R
// consecutive outputs of each of the NR rails y[],
//   z[r] = sum_{j < L} taps[j] * y[base + r*SPS + LEAD + L - 1 - j],
// from skewed tiles. Each thread walks the (R-1)*SPS + LEAD + L samples of
// its run once, newest first, and feeds each to every output it belongs
// to: one fmaf chain per output and rail with the taps in the order
// j = 0, 1, ..., L-1 from 0, the order of the plain versions, so an output
// never depends on the run or the tile it falls in. acc[][] start at 0.
// The run starts at `base`, a multiple of 4; its first LEAD samples are
// loaded and not used (K4 and K5 put them before the history so that the
// new samples land 16-byte aligned). SPS, L at compile time: the samples
// in 16-byte loads, every tap a constant or uniform operand.
template <int R, int SPS, int L, int LEAD = 0, int NR>
__device__ __forceinline__ void matched_fixed(const float* const (&y)[NR],
                                              int base, const Taps& taps,
                                              float (&acc)[NR][R]) {
  static_assert(R * SPS % 4 == 0, "a run starts 16-byte aligned");
  constexpr int W = (R - 1) * SPS + LEAD + L;
  constexpr int NQ = (W + 3) / 4;
  constexpr bool kRow = R * SPS % 32 == 0;  // every run starts a skew row
  const int pb = skew(base);
#pragma unroll
  for (int q = NQ - 1; q >= 0; --q) {
    const int off = kRow ? pb + 4 * q + 4 * (q >> 3) : skew(base + 4 * q);
    float e[NR][4];
#pragma unroll
    for (int k = 0; k < NR; ++k) {
      const float4 v = *reinterpret_cast<const float4*>(y[k] + off);
      e[k][0] = v.x;
      e[k][1] = v.y;
      e[k][2] = v.z;
      e[k][3] = v.w;
    }
#pragma unroll
    for (int u = 3; u >= 0; --u) {
      const int i = W - 1 - (4 * q + u);  // newest sample first
      if (i < 0) continue;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int j = i - (R - 1 - r) * SPS;
        if (j >= 0 && j < L) {
#pragma unroll
          for (int k = 0; k < NR; ++k)
            acc[k][r] = fmaf(taps.v[j], e[k][u], acc[k][r]);
        }
      }
    }
  }
}

// The same for any (sps, L): the taps read at a run-time index from the
// parameter bank (Taps) or, on the long route, from shared memory (a
// pointer). Any sps (SPS = 0): scalar loads, a run at any base. SPS = 1
// (K4's and K5's generic route; base + L - 1 a multiple of 4): the taps in
// chunks of C from j = 0, each chunk's C + R - 1 samples in 16-byte loads,
// then each tap of the chunk to every output, so one tap read feeds R
// outputs and the order of every output's chain is still j = 0, 1, ...
template <int R, int SPS = 0, int NR, typename T>
__device__ __forceinline__ void matched_generic(const float* const (&y)[NR],
                                                int base, int sps, int L,
                                                const T& taps,
                                                float (&acc)[NR][R]) {
  if constexpr (SPS == 1) {
    constexpr int C = 16;
    static_assert((C + R) % 4 == 0, "a chunk's window is whole pieces");
    for (int j0 = 0; j0 < L; j0 += C) {
      const int cnt = L - j0 < C ? L - j0 : C;
      // e[k] = y[s + k]: output r at tap j0 + m reads e[C + r - m]
      const int s = base + L - 1 - j0 - C;
      float e[NR][C + R];
#pragma unroll
      for (int g = 0; g < (C + R) / 4; ++g) {
        if (4 * g + 3 > C - cnt) {  // a piece some tap of the chunk reads
          const int p = skew(s + 4 * g);
#pragma unroll
          for (int k = 0; k < NR; ++k) {
            const float4 v = *reinterpret_cast<const float4*>(y[k] + p);
            e[k][4 * g] = v.x;
            e[k][4 * g + 1] = v.y;
            e[k][4 * g + 2] = v.z;
            e[k][4 * g + 3] = v.w;
          }
        }
      }
#pragma unroll
      for (int m = 0; m < C; ++m) {
        if (m < cnt) {
          const float t = tap(taps, j0 + m);
#pragma unroll
          for (int r = 0; r < R; ++r) {
#pragma unroll
            for (int k = 0; k < NR; ++k)
              acc[k][r] = fmaf(t, e[k][C + r - m], acc[k][r]);
          }
        }
      }
    }
  } else {
    const int W = (R - 1) * sps + L;
    for (int i = 0; i < W; ++i) {
      const int p = skew(base + W - 1 - i);
      float v[NR];
#pragma unroll
      for (int k = 0; k < NR; ++k) v[k] = y[k][p];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int j = i - (R - 1 - r) * sps;
        if (j >= 0 && j < L) {
          const float t = tap(taps, j);
#pragma unroll
          for (int k = 0; k < NR; ++k) acc[k][r] = fmaf(t, v[k], acc[k][r]);
        }
      }
    }
  }
}

// ---- the causal FIR core of K4 (fir.cu) and K5 (demod.cu) ----
//
// A persistent block of kCoreThreads threads walks a contiguous range of
// (channel, tile of R * kCoreThreads outputs) items; thread t owns the R
// outputs R*t .. R*t + R - 1 of a tile (R: each kernel's own, K4 16, K5 8).
// A tile's filter input lies in a skewed buffer: position lead + i holds
// stream sample o0 - h + i (h = L - 1 samples of history before the tile's
// first output o0, then the tile's own), lead = fir_lead(L) so that the
// tile's own samples start 16-byte aligned at fir_pos0(L) and stream in by
// cp.async. The next tile's history is this tile's last h samples, copied
// in shared memory.
constexpr int kCoreThreads = 128;  // threads a block
constexpr int kCoreBlocks = 8;     // persistent blocks an SM, at most

__host__ __device__ constexpr int fir_lead(int L) { return (1 - L) & 3; }

__host__ __device__ constexpr int fir_pos0(int L) {
  return fir_lead(L) + L - 1;
}

// Floats of a skewed filter buffer for L taps and tiles of `tile` outputs.
__host__ __device__ inline int fir_buf_len(int L, int tile) {
  return skew_len(fir_pos0(L) + tile);
}

// This block's items [lo, hi) of n_items, in order.
__device__ __forceinline__ void block_items(long long n_items, long long& lo,
                                            long long& hi) {
  lo = blockIdx.x * n_items / gridDim.x;
  hi = (blockIdx.x + 1) * n_items / gridDim.x;
}

// A thread's R outputs of every rail into the skewed staging rows ys[]
// (16-byte stores), times `gain`.
template <int NR, int R>
__device__ __forceinline__ void stage_run(float* const (&ys)[NR], int r0,
                                          const float (&acc)[NR][R],
                                          float gain) {
  static_assert(R % 4 == 0, "whole 16-byte pieces");
#pragma unroll
  for (int k = 0; k < NR; ++k) {
#pragma unroll
    for (int m = 0; m < R; m += 4)
      *reinterpret_cast<float4*>(ys[k] + skew(r0 + m)) =
          make_float4(gain * acc[k][m], gain * acc[k][m + 1],
                      gain * acc[k][m + 2], gain * acc[k][m + 3]);
  }
}

// Staged outputs first .. end - 1 (skewed ys) to the same places of dst in
// device memory, all threads: consecutive threads store consecutive 16-byte
// pieces where dst is 16-byte aligned, else, and at a piece's head or tail,
// single floats.
__device__ inline void store_tile(float* __restrict__ dst, const float* ys,
                                  int first, int end) {
  int a = end, b = end;  // the pieces store outputs a .. b - 1
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    const int p0 = (first + 3) >> 2;
    const int p1 = end >> 2;
    if (p1 > p0) {
      a = p0 << 2;
      b = p1 << 2;
    }
    for (int q = p0 + threadIdx.x; q < p1; q += blockDim.x)
      *reinterpret_cast<float4*>(dst + 4 * q) =
          *reinterpret_cast<const float4*>(ys + skew(4 * q));
  }
  for (int e = first + threadIdx.x; e < a; e += blockDim.x)
    dst[e] = ys[skew(e)];
  for (int e = b + threadIdx.x; e < end; e += blockDim.x)
    dst[e] = ys[skew(e)];
}

// How far (in floats, 0 to 3) p lies past a 16-byte boundary. K4 and K5
// start a row's tiles that many samples early, so that every tile's samples
// and outputs but the first tile's head lie on 16-byte boundaries.
__host__ __device__ __forceinline__ int misalign(const float* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

// Tiles of `tile` samples a row of n takes, starting up to `shift` early.
__host__ __device__ __forceinline__ long long fir_tiles(long long n,
                                                        int shift, int tile) {
  return (n + shift + tile - 1) / tile;
}

// The shift K4 and K5 must allow for rows of n floats from x: none where
// every row starts on a 16-byte boundary.
inline int fir_shift(const float* x, long long n) {
  return misalign(x) == 0 && n % 4 == 0 ? 0 : 3;
}

// Blocks of a flattened (channel, tile) grid, or 0 if they exceed the
// grid's x limit (the launcher then reports an invalid configuration).
inline unsigned grid_blocks(long long n_ch, long long n_tiles) {
  const long long n = n_ch * n_tiles;
  return n > 0x7fffffffLL ? 0u : static_cast<unsigned>(n);
}

// The noise stream of the fused kernels' in-kernel AWGN: the counter-based
// stream the JAX kernels draw in interpret mode
// (modem_tpu/ops/pallas_chain.py::_gauss_pair), bit for bit. lowbias32
// avalanche hash on uint32 with wrap-around.
__device__ __forceinline__ unsigned hash_u32(unsigned x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// Standard-normal pair by Box-Muller for draw counter ctr under key (the
// tile key plus salt * 0x9E3779B9): 24-bit uniforms in (0, 1), exact in
// f32, then r = sqrt(-2 log u1) and the angle 2*pi*u2.
__device__ __forceinline__ void gauss_pair(unsigned ctr, unsigned key,
                                           float& g1, float& g2) {
  const unsigned b1 = hash_u32(ctr * 2654435761u + key);
  const unsigned b2 = hash_u32(ctr * 2246822519u + (key ^ 0x85EBCA6Bu));
  const float u1 = (static_cast<float>(b1 >> 8) + 0.5f) * 5.9604644775390625e-8f;
  const float u2 = (static_cast<float>(b2 >> 8) + 0.5f) * 5.9604644775390625e-8f;
  const float r = sqrtf(-2.0f * logf(u1));
  const float ang = 6.283185307179586f * u2;
  g1 = r * cosf(ang);
  g2 = r * sinf(ang);
}

// The C entries' map and NCO arguments as the kernels take them: lut null
// selects QAM; sr == 0 is baseband. False where the NCO's arithmetic would
// leave int32 in the JAX form (hz * sr >= 2^31) or the rates are negative.
inline Constellation make_map(const float* lut, int n_points, int cshift,
                              float ms, float a, float c, float s) {
  return Constellation{lut, lut != nullptr ? n_points : 0, cshift, ms, a, c,
                       s};
}

inline bool make_nco(int hz, int sr, int sps, long long sym_offset,
                     float scale, Nco& n) {
  n = Nco{sr, hz, 1, 0, 1, 0, 0, scale};
  if (sr == 0) return true;
  if (hz < 0 || sr < 0 || static_cast<long long>(hz) * sr >= (1LL << 31))
    return false;
  int a = hz, b = sr;
  while (b != 0) {
    const int t = a % b;
    a = b;
    b = t;
  }
  const int n_ph = sr / a;
  n.table = n_ph <= kNcoTable;
  n.unit = n.table ? a : 1;
  n.period = n.table ? n_ph : sr;
  n.step = (hz % sr) / n.unit;
  long long off = sym_offset % sr;
  if (off < 0) off += sr;
  n.s_off = static_cast<int>(off * sps % sr);
  return true;
}

// The floats of shared memory the pulse-shaped kernels give the table and
// the carrier's phase table (2 * n_ph floats when it has one).
inline int side_floats(const Constellation& m, const Nco& n) {
  return (m.lut != nullptr ? 2 * m.n_points : 0) +
         (n.sr != 0 && n.table ? 2 * n.period : 0);
}

// Dynamic shared memory above the default 48 KB needs an opt-in.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// The grid of a persistent kernel: as many blocks as fit the card, at most
// `cap` an SM, and never more than the n_items items (asked at every
// launch, a few microseconds).
template <typename Kernel>
inline cudaError_t persistent_grid(Kernel kernel, int threads, size_t smem,
                                   int cap, long long n_items,
                                   unsigned& grid) {
  int dev = 0, n_sm = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long slots = static_cast<long long>(per_sm < cap ? per_sm : cap) *
                          n_sm;
  grid = static_cast<unsigned>(n_items < slots ? n_items : slots);
  return cudaSuccess;
}

}  // namespace modem
