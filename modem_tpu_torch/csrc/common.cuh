// Shared pieces of the kernels: the pulse-shaped chain's (txrx.cu,
// chain.cu: constellations, the passband NCO, waveform storage) and the
// noise stream the FSK and pulse-shaped loopbacks draw (fsk.cu, chain.cu).
//
// Layout everywhere: one row per channel, time contiguous ([C, K] symbols,
// [C, N] waveform samples), one block per (channel, time tile), threads
// along time. Small parameters (constellation table, RRC taps) arrive as
// device arrays and are staged in shared memory, where the polyphase bank
// is built from the taps.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace modem {

constexpr int kThreads = 256;  // threads per block
constexpr int kTile = 256;     // symbols per block (time tile)
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr int kNcoTable = 16;  // carrier phases held in a table, at most
constexpr int kLane = 128;     // channels per JAX tile (the noise keys)

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
// sr == 0 is baseband. Waveform sample p of symbol row gsym (stream-global:
// sym_offset plus the row in this call) has the exact phase
//   u = ((((gsym mod sr) * sps + p) mod sr) * hz) mod sr,
// gsym mod sr a floor mod (streams pass negative offsets), and the angle
// __fmul_rn(u, scale), scale = f32(2*pi/sr). The accurate cosf and sinf of
// that angle; where the carrier has n_ph = sr / gcd(hz, sr) <= kNcoTable
// phases they come from a table of the same cosf and sinf of u = k*g,
// bit-identical to the per-sample values.
struct Nco {
  int hz, sr, sps;
  long long sym_offset;
  int n_ph, g;
  float scale;
};

// Waveform storage: f32, bf16 (round to nearest even) or int16
// (clip(rint(x * out_scale), -32768, 32767)), one overload per type. The
// kernels are instantiated per type, so the f32 path compiles to plain
// float loads and stores.
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

__device__ __forceinline__ float load_wave(float v) { return v; }

__device__ __forceinline__ float load_wave(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// The carrier phase's table, n_ph entries of cos and sin, all threads.
__device__ inline void stage_nco(float* tc, float* ts, const Nco& n) {
  for (int k = threadIdx.x; k < n.n_ph; k += blockDim.x) {
    const float th = __fmul_rn(static_cast<float>(k * n.g), n.scale);
    tc[k] = cosf(th);
    ts[k] = sinf(th);
  }
}

__device__ __forceinline__ void nco_cos_sin(const Nco& n, long long gsym,
                                            int p, const float* tc,
                                            const float* ts, float& c,
                                            float& s) {
  long long gm = gsym % n.sr;
  if (gm < 0) gm += n.sr;
  const long long smod = (gm * n.sps + p) % n.sr;
  const int u = static_cast<int>((smod * n.hz) % n.sr);
  if (n.n_ph <= kNcoTable) {
    const int k = u / n.g;
    c = tc[k];
    s = ts[k];
  } else {
    const float th = __fmul_rn(static_cast<float>(u), n.scale);
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

// Polyphase matched filter at the decision instant of local symbol ml:
//   z = sum_j taps[j] * y[ml*sps + d - j],  d = n_taps - 1 = span*sps,
// reading y from phase-major planes (plane p, row r holds the tile's sample
// r*sps + p), so the threads of a warp, one symbol each, read consecutive
// words. Taps are taken in order j = 0, 1, ... as in the plain version.
__device__ inline float matched_point(const float* planes, int stride,
                                      const float* taps, int n_taps, int sps,
                                      int span, int ml) {
  float acc = 0.f;
  int q = span, p = 0;  // a = d - j = q*sps + p, starting at j = 0
  for (int j = 0; j < n_taps; ++j) {
    acc = fmaf(taps[j], planes[p * stride + ml + q], acc);
    if (p == 0) {
      p = sps - 1;
      --q;
    } else {
      --p;
    }
  }
  return acc;
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
  n = Nco{hz, sr, sps, sym_offset, 0, 1, scale};
  if (sr == 0) return true;
  if (hz < 0 || sr < 0 || static_cast<long long>(hz) * sr >= (1LL << 31))
    return false;
  int a = hz, b = sr;
  while (b != 0) {
    const int t = a % b;
    a = b;
    b = t;
  }
  n.g = a;
  n.n_ph = sr / a;
  return true;
}

// The floats of shared memory the pulse-shaped kernels give the table and
// the carrier's phase table (2 * n_ph floats when it has one).
inline int side_floats(const Constellation& m, const Nco& n) {
  return (m.lut != nullptr ? 2 * m.n_points : 0) +
         (n.sr != 0 && n.n_ph <= kNcoTable ? 2 * n.n_ph : 0);
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
