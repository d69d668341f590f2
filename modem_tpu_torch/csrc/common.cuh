// Shared pieces of the kernels: the pulse-shaped chain's (txrx.cu,
// chain.cu) and the noise stream the FSK loopback draws (fsk.cu).
//
// Layout everywhere: one row per channel, time contiguous ([C, K] symbols,
// [C, N] waveform samples), one block per (channel, time tile), threads
// along time. Small parameters (constellation table, RRC taps) arrive as
// device arrays and are staged in shared memory, where the polyphase bank
// is built from the taps.
#pragma once

#include <cuda_runtime.h>

namespace modem {

constexpr int kThreads = 256;  // threads per block
constexpr int kTile = 256;     // symbols per block (time tile)
constexpr size_t kDefaultSmem = 48 * 1024;

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

// Dynamic shared memory above the default 48 KB needs an opt-in.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace modem
