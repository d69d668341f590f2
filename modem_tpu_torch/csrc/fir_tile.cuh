// The causal FIR inner loop of K4's long route (fir.cu, more than 256 taps:
// the taps staged in shared memory).
//
// A block of kFirThreads threads computes kFirTile consecutive outputs of
// one channel; thread t owns the kFirPer outputs 8t .. 8t+7. The tile's
// inputs and their K-1-sample history sit in shared memory, "padded": word
// i is stored at pad8(i) = i + i/8, so the 32 threads of a warp, reading
// words 8t + c, hit 32 different banks. Each thread keeps 15 consecutive
// inputs in registers per group of 8 taps and reads each tap once, as a
// broadcast: 15 + 8 shared-memory loads per 64 FMAs instead of 128.
//
// Every output is the same sequence of FMAs, taps in order j = 0, 1, ...,
// whatever tile or block boundary it falls at, so streamed and one-shot
// runs give identical bits.
#pragma once

#include <cuda_runtime.h>

namespace modem {

constexpr int kFirThreads = 256;
constexpr int kFirPer = 8;  // consecutive outputs per thread
constexpr int kFirTile = kFirThreads * kFirPer;  // outputs per block
constexpr size_t kMaxSmem = 232448;  // dynamic shared memory a block may use

__device__ __forceinline__ int pad8(int i) { return i + (i >> 3); }

// Shared-memory words that hold n padded values.
__host__ __device__ constexpr int padded_len(int n) { return n + (n >> 3) + 1; }

// acc[r] = sum_{j < k} taps[j] * xs[b + r - j] for r < kFirPer, xs padded,
// taps 16-byte aligned in shared memory. Needs b - (k-1) >= 0.
__device__ __forceinline__ void fir_outputs(const float* xs, const float* taps,
                                            int k, int b,
                                            float (&acc)[kFirPer]) {
#pragma unroll
  for (int r = 0; r < kFirPer; ++r) acc[r] = 0.f;
  int j0 = 0;
  for (; j0 + kFirPer <= k; j0 += kFirPer) {
    // v[m] = xs[b - j0 - 7 + m]: the inputs of outputs r < 8, taps j0 .. j0+7
    float v[2 * kFirPer - 1];
#pragma unroll
    for (int m = 0; m < 2 * kFirPer - 1; ++m)
      v[m] = xs[pad8(b - j0 - (kFirPer - 1) + m)];
    const float4 t0 = *reinterpret_cast<const float4*>(taps + j0);
    const float4 t1 = *reinterpret_cast<const float4*>(taps + j0 + 4);
    const float t[kFirPer] = {t0.x, t0.y, t0.z, t0.w, t1.x, t1.y, t1.z, t1.w};
#pragma unroll
    for (int u = 0; u < kFirPer; ++u) {
#pragma unroll
      for (int r = 0; r < kFirPer; ++r)
        acc[r] = fmaf(t[u], v[r - u + kFirPer - 1], acc[r]);
    }
  }
  for (int j = j0; j < k; ++j) {
    const float t = taps[j];
#pragma unroll
    for (int r = 0; r < kFirPer; ++r)
      acc[r] = fmaf(t, xs[pad8(b + r - j)], acc[r]);
  }
}

}  // namespace modem
