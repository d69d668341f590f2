// Fused one-way TX and RX of the pulse-shaped chain, LUT constellations.
//
// TX replaces modem_tpu/ops/pallas_txrx.py::_tx_kernel (K2): int32 symbols
// -> constellation map -> polyphase RRC interpolation -> baseband I/Q,
//   w[m*sps + p] = sum_k bank[p][k] * z[m - k],  m < K + span,
// z = 0 outside [0, K) and for negative symbols.
// RX replaces modem_tpu/ops/pallas_txrx.py::_rx_kernel (K3): baseband I/Q
// -> polyphase matched filter at the decision instants
//   z[m] = sum_j taps[j] * y[m*sps + span*sps - j],  m < K,
// -> min-distance slice to int32 symbols, or the soft (i, q) points.
//
// What bounds them on this card: bytes. TX reads 4 B per symbol and writes
// 2 x 4 B per sample (64 B per symbol at sps = 8), about 9*2 FMAs per
// sample; RX reads 8 B per sample and writes 4 or 8 B per symbol, 65*2 FMAs
// per symbol. Both are far below the FMA rate, so their floor is the
// device-memory write (TX) and read (RX) time. The design therefore touches
// device memory once per element: each block stages its own halo (span
// symbols back for TX, span*sps samples ahead for RX, under 4% extra at the
// 256-symbol tile) in shared memory, and stores and loads run along time,
// so a warp's accesses are contiguous. This first version is not at that
// floor (on an H100 80GB HBM3 at 700 W, TX reaches about 44% and RX about
// 25% of the 3.35 TB/s peak; PERF.md): TX issues 27 shared-memory loads per
// 18 FMAs, and RX's block loads its tile with scalar loads before it
// filters. Registers for the taps, vector loads and TMA come next.

#include "common.cuh"

namespace {

using modem::kThreads;
using modem::kTile;

// Grid: one block per (channel, tile of kTile output symbols), flattened.
__global__ void tx_lut_kernel(const int* __restrict__ syms, long long k_sym,
                              long long n_tiles, const float* __restrict__ lut,
                              int n_points, const float* __restrict__ taps,
                              int n_taps, int sps, int span,
                              float* __restrict__ out_i,
                              float* __restrict__ out_q) {
  extern __shared__ float smem[];
  const int kp = (n_taps + sps - 1) / sps;  // taps per polyphase branch
  const int z_len = kTile + kp - 1;  // the tile's symbols and kp-1 behind
  float* zi = smem;
  float* zq = zi + z_len;
  float* sbank = zq + z_len;
  float* slut = sbank + sps * kp;

  const long long c = blockIdx.x / n_tiles;
  const long long m0 = (blockIdx.x % n_tiles) * kTile;
  const long long n_out = (k_sym + span) * sps;
  modem::stage_bank(sbank, taps, n_taps, sps, kp);
  modem::stage(slut, lut, 2 * n_points);
  __syncthreads();

  const int* row = syms + c * k_sym;
  for (int t = threadIdx.x; t < z_len; t += blockDim.x)
    modem::map_symbol(row, m0 - (kp - 1) + t, k_sym, slut, n_points, zi[t],
                      zq[t]);
  __syncthreads();

  const long long n_sym_out = k_sym + span;
  const long long left = n_sym_out - m0;
  const int n_local = static_cast<int>((left < kTile ? left : kTile) * sps);
  float* oi = out_i + c * n_out + m0 * sps;
  float* oq = out_q + c * n_out + m0 * sps;
  for (int t = threadIdx.x; t < n_local; t += blockDim.x) {
    const int ml = t / sps;
    const int p = t - ml * sps;
    const float* b = sbank + p * kp;
    float ai = 0.f, aq = 0.f;
    for (int k = 0; k < kp; ++k) {
      const int zk = ml + kp - 1 - k;
      ai = fmaf(b[k], zi[zk], ai);
      aq = fmaf(b[k], zq[zk], aq);
    }
    oi[t] = ai;
    oq[t] = aq;
  }
}

// Grid: one block per (channel, tile of kTile decided symbols), flattened.
template <bool kSoft>
__global__ void rx_lut_kernel(const float* __restrict__ wi,
                              const float* __restrict__ wq, long long n_wave,
                              long long n_sym, long long n_tiles,
                              const float* __restrict__ taps, int n_taps,
                              int sps, int span, const float* __restrict__ lut,
                              int n_points, int* __restrict__ out_sym,
                              float* __restrict__ out_i,
                              float* __restrict__ out_q) {
  extern __shared__ float smem[];
  const int rows = kTile + span;  // the tile's samples and span*sps ahead
  const int stride = rows | 1;    // odd plane stride: fewer bank conflicts
  float* yi = smem;
  float* yq = yi + sps * stride;
  float* staps = yq + sps * stride;
  float* slut = staps + n_taps;

  const long long c = blockIdx.x / n_tiles;
  const long long m0 = (blockIdx.x % n_tiles) * kTile;
  modem::stage(staps, taps, n_taps);
  modem::stage(slut, lut, 2 * n_points);

  // Samples past the end of the waveform read as zero.
  const long long s0 = m0 * sps;
  const float* ri = wi + c * n_wave;
  const float* rq = wq + c * n_wave;
  for (int t = threadIdx.x; t < rows * sps; t += blockDim.x) {
    const long long s = s0 + t;
    const int r = t / sps;
    const int p = t - r * sps;
    const bool in = s < n_wave;
    yi[p * stride + r] = in ? ri[s] : 0.f;
    yq[p * stride + r] = in ? rq[s] : 0.f;
  }
  __syncthreads();

  for (int ml = threadIdx.x; ml < kTile; ml += blockDim.x) {
    const long long m = m0 + ml;
    if (m >= n_sym) break;
    const float ai = modem::matched_point(yi, stride, staps, n_taps, sps, span, ml);
    const float aq = modem::matched_point(yq, stride, staps, n_taps, sps, span, ml);
    if (kSoft) {
      out_i[c * n_sym + m] = ai;
      out_q[c * n_sym + m] = aq;
    } else {
      out_sym[c * n_sym + m] = modem::nearest_point(ai, aq, slut, n_points);
    }
  }
}

template <bool kSoft>
int launch_rx(const float* wi, const float* wq, long long n_ch,
              long long n_wave, long long n_sym, const float* taps, int n_taps,
              int sps, int span, const float* lut, int n_points, int* out_sym,
              float* out_i, float* out_q, void* stream) {
  // the matched filter's sample window is exactly the tile's halo
  if (n_taps != span * sps + 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long n_tiles = (n_sym + kTile - 1) / kTile;
  const int stride = (kTile + span) | 1;
  const size_t smem =
      (2 * static_cast<size_t>(sps) * stride + n_taps + 2 * n_points) *
      sizeof(float);
  cudaError_t err = modem::allow_smem(rx_lut_kernel<kSoft>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  rx_lut_kernel<kSoft><<<modem::grid_blocks(n_ch, n_tiles), kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      wi, wq, n_wave, n_sym, n_tiles, taps, n_taps, sps, span, lut, n_points,
      out_sym, out_i, out_q);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// syms [n_ch, k_sym] int32 -> out_i, out_q [n_ch, (k_sym+span)*sps] f32;
// lut [n_points, 2] f32, taps [n_taps] f32. Returns cudaGetLastError().
int modem_tx_lut(const int* syms, long long n_ch, long long k_sym,
                 const float* lut, int n_points, const float* taps,
                 int n_taps, int sps, int span, float* out_i, float* out_q,
                 void* stream) {
  const long long n_tiles = (k_sym + span + kTile - 1) / kTile;
  const int kp = (n_taps + sps - 1) / sps;
  const size_t smem =
      (2 * static_cast<size_t>(kTile + kp - 1) + sps * kp + 2 * n_points) *
      sizeof(float);
  cudaError_t err = modem::allow_smem(tx_lut_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  tx_lut_kernel<<<modem::grid_blocks(n_ch, n_tiles), kThreads, smem,
                  static_cast<cudaStream_t>(stream)>>>(
      syms, k_sym, n_tiles, lut, n_points, taps, n_taps, sps, span, out_i,
      out_q);
  return static_cast<int>(cudaGetLastError());
}

// wi, wq [n_ch, n_wave] f32 with n_wave >= (n_sym+span)*sps -> out_sym
// [n_ch, n_sym] int32; taps [span*sps+1] f32.
int modem_rx_lut_hard(const float* wi, const float* wq, long long n_ch,
                      long long n_wave, long long n_sym, const float* taps,
                      int n_taps, int sps, int span, const float* lut,
                      int n_points, int* out_sym, void* stream) {
  return launch_rx<false>(wi, wq, n_ch, n_wave, n_sym, taps, n_taps, sps, span,
                          lut, n_points, out_sym, nullptr, nullptr, stream);
}

// As modem_rx_lut_hard, to the decision-point I/Q out_i, out_q [n_ch, n_sym].
int modem_rx_lut_soft(const float* wi, const float* wq, long long n_ch,
                      long long n_wave, long long n_sym, const float* taps,
                      int n_taps, int sps, int span, float* out_i,
                      float* out_q, void* stream) {
  return launch_rx<true>(wi, wq, n_ch, n_wave, n_sym, taps, n_taps, sps, span,
                         nullptr, 0, nullptr, out_i, out_q, stream);
}

const char* modem_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
