// The reference receiver's product detector: replaces
// modem_tpu/ops/pallas_demod.py::_demod_kernel (K5), the hot loop of
// `demodulator.rs:44-56`. Per passband sample at position p of the stream
// e = hist ++ x (hist: the previous block's last samples, read in place),
//
//   u     = ((p mod sr + off) mod sr * hz) mod sr        exact, int32
//   total = f32(u) * w + phi[c],  w = f32(2*pi/sr)
//   mi    = x * cos(total),  mq = -x * sin(total)
//   i[n]  = 2 * sum_{j < K} taps[j] * mi[n - j],  q likewise from mq,
//
// for the positions of x only (outputs n = h .. h+N-1 of e); positions
// before e's start read zero (the zero FIR history at a stream's start).
// off is e[0]'s carrier counter mod sr, read from the device, so a stream
// never waits on the host. hz * sr < 2^31 keeps u exact (the wrapper
// checks), and sincosf is the accurate one: no fast math.
//
// One block per (channel, tile of kFirTile outputs): the block mixes its
// tile and the K-1 samples before it into two shared-memory rails (one
// sincosf per input, 3% recomputed at the halo for 65 taps), then runs both
// lowpass rails (fir_tile.cuh) and writes them back through shared memory.
// Each output's arithmetic depends only on its own position, never on the
// tile or on where a streaming push began, so pushes equal one shot bit
// for bit.
//
// What bounds it on this card: 4 B in and 8 B out per sample against 128
// FMAs (256 FLOP) and a sincosf per sample, 21 FLOP/B before the sincosf:
// the FMA and shared-memory issue rates, a little above the 3.35 TB/s
// memory floor.

#include "fir_tile.cuh"

namespace {

using modem::kFirThreads;
using modem::kFirTile;
using modem::pad8;
using modem::padded_len;

constexpr int kMaxTaps = 65;

__device__ __forceinline__ long long floor_mod(long long a, long long m) {
  const long long r = a % m;
  return r < 0 ? r + m : r;
}

__global__ void __launch_bounds__(kFirThreads)
demod_kernel(const float* __restrict__ hist, int h,
             const float* __restrict__ x, long long n, long long n_tiles,
             const float* __restrict__ taps, int k, int hz, int sr, float w,
             const int* __restrict__ off_ptr, const float* __restrict__ phi,
             float* __restrict__ out_i, float* __restrict__ out_q) {
  extern __shared__ float4 smem4[];
  float* staps = reinterpret_cast<float*>(smem4);
  float* mi = staps + ((k + 3) & ~3);
  float* mq = mi + padded_len(kFirTile + k - 1);

  const long long c = blockIdx.x / n_tiles;
  const long long o0 = (blockIdx.x % n_tiles) * kFirTile;
  const int lb = k - 1;
  for (int t = threadIdx.x; t < k; t += blockDim.x) staps[t] = taps[t];

  const long long off = floor_mod(*off_ptr, sr);
  const float ph = phi[c];
  const float* hr = hist + c * h;
  const float* xr = x + c * n;
  // local i holds stream position p = h + o0 - lb + i
  const long long p0 = h + o0 - lb;
  for (int i = threadIdx.x; i < kFirTile + lb; i += blockDim.x) {
    const long long p = p0 + i;
    float xv = 0.f;
    if (p >= 0) {
      if (p < h) {
        xv = hr[p];
      } else if (p - h < n) {
        xv = xr[p - h];
      }
    }
    const int u = static_cast<int>((floor_mod(p, sr) + off) % sr) * hz % sr;
    // two roundings, as the plain version: no FMA contraction here
    const float total = __fadd_rn(__fmul_rn(static_cast<float>(u), w), ph);
    float s, co;
    sincosf(total, &s, &co);
    mi[pad8(i)] = xv * co;
    mq[pad8(i)] = -xv * s;
  }
  __syncthreads();

  float ai[modem::kFirPer], aq[modem::kFirPer];
  const int b = modem::kFirPer * threadIdx.x + lb;
  modem::fir_outputs(mi, staps, k, b, ai);
  modem::fir_outputs(mq, staps, k, b, aq);
  __syncthreads();  // every thread has read the rails: reuse them for output
#pragma unroll
  for (int r = 0; r < modem::kFirPer; ++r) {
    mi[pad8(modem::kFirPer * threadIdx.x + r)] = 2.f * ai[r];
    mq[pad8(modem::kFirPer * threadIdx.x + r)] = 2.f * aq[r];
  }
  __syncthreads();

  const long long left = n - o0;
  const int count = static_cast<int>(left < kFirTile ? left : kFirTile);
  float* oi = out_i + c * n + o0;
  float* oq = out_q + c * n + o0;
  for (int i = threadIdx.x; i < count; i += blockDim.x) {
    oi[i] = mi[pad8(i)];
    oq[i] = mq[pad8(i)];
  }
}

}  // namespace

extern "C" {

// hist [n_ch, h], x [n_ch, n] f32, taps [n_taps <= 65] f32, off: one int32
// on the device (hist[0]'s carrier counter), phi [n_ch] f32 ->
// out_i, out_q [n_ch, n]. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for arguments the kernel does not take.
int modem_demod(const float* hist, int h, const float* x, long long n_ch,
                long long n, const float* taps, int n_taps, int hz, int sr,
                float w, const int* off, const float* phi, float* out_i,
                float* out_q, void* stream) {
  if (n_taps < 1 || n_taps > kMaxTaps || h < 0 || sr < 1 || hz < 0 ||
      static_cast<long long>(hz) * sr >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_tiles = (n + kFirTile - 1) / kFirTile;
  const long long blocks = n_ch * n_tiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (static_cast<size_t>((n_taps + 3) & ~3) +
                       2 * padded_len(kFirTile + n_taps - 1)) * sizeof(float);
  demod_kernel<<<static_cast<unsigned>(blocks), kFirThreads, smem,
                 static_cast<cudaStream_t>(stream)>>>(
      hist, h, x, n, n_tiles, taps, n_taps, hz, sr, w, off, phi, out_i, out_q);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
