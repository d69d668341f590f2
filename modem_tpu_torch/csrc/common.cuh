// Shared pieces of the kernels: the pulse-shaped chain's (txrx.cu,
// chain.cu: constellations, the passband NCO, waveform storage, the taps
// as a kernel parameter and the register-blocked matched filter) and the
// noise stream the FSK and pulse-shaped loopbacks draw (fsk.cu, chain.cu).
//
// Layout everywhere: one row per channel, time contiguous ([C, K] symbols,
// [C, N] waveform samples), threads along time. The constellation table
// arrives as a device array and is staged in shared memory; K1's and K3's
// RRC taps arrive by value in a kernel parameter (Taps), K2's as a device
// array from which it builds its polyphase bank in shared memory.
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
constexpr int kMaxTaps = 256;  // taps K1 and K3 take (Taps, 1 KB)
constexpr int kMaxSps = 64;    // samples a symbol K1's and K3's tiles fit

// RRC taps by value. Passed as a __grid_constant__ kernel parameter, they
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

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copy n elements from src (device memory) to logical positions pos0 ..
// pos0 + n - 1 of dst (shared memory, skewed or not), all threads of the
// block: the first n_valid from src, the rest zero (samples past the end of
// the waveform read as zero). Where src and the destination are 16-byte
// aligned the whole 16-byte pieces go by cp.async (commit and wait are the
// caller's); a misaligned row, and the tail, by scalar loads.
template <bool kSkew, typename T>
__device__ inline void load_span(T* dst, const T* __restrict__ src, int pos0,
                                 int n, int n_valid) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  int done = 0;
  if (((reinterpret_cast<uintptr_t>(src) |
        static_cast<uintptr_t>(pos0) * sizeof(T)) & 15) == 0) {
    const int pieces = n_valid / kVec;
    for (int k = threadIdx.x; k < pieces; k += blockDim.x) {
      const int p = pos0 + k * kVec;
      cp_async16(dst + (kSkew ? skew(p) : p), src + k * kVec);
    }
    done = pieces * kVec;
  }
  for (int e = done + threadIdx.x; e < n; e += blockDim.x) {
    const int p = pos0 + e;
    dst[kSkew ? skew(p) : p] = e < n_valid ? src[e] : T(0);
  }
}

// The register-blocked polyphase matched filter: R consecutive decision
// points of both rails,
//   z[r] = sum_j taps[j] * y[base + r*sps + d - j],  d = L - 1,
// from the skewed tiles yi, yq. Each thread walks the (R-1)*sps + L
// samples of its run once, newest first, and feeds each to every output it
// belongs to: one fmaf chain per output and rail with the taps in the order
// j = 0, 1, ..., L-1 from 0, the order of the plain version, so an output
// never depends on the run or the tile it falls in. acc[] start at 0.
// The flagship shape (sps, L at compile time, base a multiple of 32): the
// samples in 16-byte loads, every tap a constant or uniform operand.
template <int R, int SPS, int L>
__device__ __forceinline__ void matched_fixed(const float* __restrict__ yi,
                                              const float* __restrict__ yq,
                                              int base, const Taps& taps,
                                              float (&ai)[R], float (&aq)[R]) {
  static_assert(R * SPS % 32 == 0, "a run starts on a skew row");
  constexpr int W = (R - 1) * SPS + L;
  constexpr int NQ = (W + 3) / 4;
  const int pb = skew(base);
#pragma unroll
  for (int q = NQ - 1; q >= 0; --q) {
    const int off = pb + 4 * q + 4 * (q >> 3);
    const float4 vi = *reinterpret_cast<const float4*>(yi + off);
    const float4 vq = *reinterpret_cast<const float4*>(yq + off);
    const float ei[4] = {vi.x, vi.y, vi.z, vi.w};
    const float eq[4] = {vq.x, vq.y, vq.z, vq.w};
#pragma unroll
    for (int u = 3; u >= 0; --u) {
      const int i = W - 1 - (4 * q + u);  // newest sample first
      if (i < 0) continue;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int j = i - (R - 1 - r) * SPS;
        if (j >= 0 && j < L) {
          ai[r] = fmaf(taps.v[j], ei[u], ai[r]);
          aq[r] = fmaf(taps.v[j], eq[u], aq[r]);
        }
      }
    }
  }
}

// The same for any (sps, L): scalar loads, the taps read at a run-time
// index from the parameter bank (Taps) or, on the long route, from shared
// memory (a pointer).
template <int R, typename T>
__device__ __forceinline__ void matched_generic(const float* __restrict__ yi,
                                                const float* __restrict__ yq,
                                                int base, int sps, int L,
                                                const T& taps, float (&ai)[R],
                                                float (&aq)[R]) {
  const int W = (R - 1) * sps + L;
  for (int i = 0; i < W; ++i) {
    const int p = skew(base + W - 1 - i);
    const float vi = yi[p], vq = yq[p];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int j = i - (R - 1 - r) * sps;
      if (j >= 0 && j < L) {
        const float t = tap(taps, j);
        ai[r] = fmaf(t, vi, ai[r]);
        aq[r] = fmaf(t, vq, aq[r]);
      }
    }
  }
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

}  // namespace modem
