// Causal FIR with a carried history: replaces
// modem_tpu/ops/pallas_fir.py::_fir_kernel (K4).
//
//   y[c, n] = sum_{j < K} taps[j] * e[c, n + K-1 - j],  e = state ++ x,
//
// x [C, N] and y [C, N] time contiguous, state [C, K-1] the previous
// block's last K-1 inputs (zeros at a stream's start), read in place: the
// wrapper concatenates nothing. One block per (channel, tile of kFirTile
// outputs); the block stages its tile and K-1 samples of history in shared
// memory (one read of each input, plus (K-1)/kFirTile of overlap, 3% at 65
// taps), filters it (fir_tile.cuh) and writes the tile back through shared
// memory so that stores coalesce.
//
// What bounds it on this card: at 64 taps it moves 8 B per output (4 in, 4
// out) and does 64 FMAs = 128 FLOP, 16 FLOP/B against the H100's 20
// (67 TFLOP/s f32 over 3.35 TB/s): memory first, the FMA rate close
// behind. The register window keeps shared-memory loads at about 0.4 per
// FMA, under the FMA issue rate. K is limited only by the shared-memory
// tile: (K rounded up to 4) + padded(kFirTile + K - 1) + padded(kFirTile)
// floats must fit 227 KB, about 25,000 taps.

#include "fir_tile.cuh"

namespace {

using modem::kFirThreads;
using modem::kFirTile;
using modem::pad8;
using modem::padded_len;

size_t fir_smem_bytes(int k) {
  const int kt = (k + 3) & ~3;
  return (static_cast<size_t>(kt) + padded_len(kFirTile + k - 1) +
          padded_len(kFirTile)) * sizeof(float);
}

__global__ void __launch_bounds__(kFirThreads)
fir_kernel(const float* __restrict__ x, const float* __restrict__ state,
           long long n, long long n_tiles, const float* __restrict__ taps,
           int k, float* __restrict__ y) {
  extern __shared__ float4 smem4[];
  float* staps = reinterpret_cast<float*>(smem4);
  float* xs = staps + ((k + 3) & ~3);
  float* ys = xs + padded_len(kFirTile + k - 1);

  const long long c = blockIdx.x / n_tiles;
  const long long o0 = (blockIdx.x % n_tiles) * kFirTile;
  const int h = k - 1;
  for (int t = threadIdx.x; t < k; t += blockDim.x) staps[t] = taps[t];

  // xs[i] = e[o0 + i]: history first, then x, zero past x's end
  const float* xr = x + c * n;
  const float* sr = state + c * h;
  for (int i = threadIdx.x; i < kFirTile + h; i += blockDim.x) {
    const long long e = o0 + i;
    float v = 0.f;
    if (e < h) {
      v = sr[e];
    } else if (e - h < n) {
      v = xr[e - h];
    }
    xs[pad8(i)] = v;
  }
  __syncthreads();

  float acc[modem::kFirPer];
  modem::fir_outputs(xs, staps, k, modem::kFirPer * threadIdx.x + h, acc);
#pragma unroll
  for (int r = 0; r < modem::kFirPer; ++r)
    ys[pad8(modem::kFirPer * threadIdx.x + r)] = acc[r];
  __syncthreads();

  const long long left = n - o0;
  const int count = static_cast<int>(left < kFirTile ? left : kFirTile);
  float* yr = y + c * n + o0;
  for (int i = threadIdx.x; i < count; i += blockDim.x) yr[i] = ys[pad8(i)];
}

}  // namespace

extern "C" {

// x [n_ch, n], state [n_ch, n_taps-1], taps [n_taps] f32 -> y [n_ch, n].
// Returns cudaGetLastError(), or cudaErrorInvalidValue for n_taps < 1 or a
// tile that does not fit shared memory.
int modem_fir(const float* x, const float* state, long long n_ch, long long n,
              const float* taps, int n_taps, float* y, void* stream) {
  if (n_taps < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = fir_smem_bytes(n_taps);
  if (smem > modem::kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const long long n_tiles = (n + kFirTile - 1) / kFirTile;
  const long long blocks = n_ch * n_tiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fir_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  fir_kernel<<<static_cast<unsigned>(blocks), kFirThreads, smem,
               static_cast<cudaStream_t>(stream)>>>(x, state, n, n_tiles, taps,
                                                    n_taps, y);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
