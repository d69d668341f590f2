// Fused loopback of the pulse-shaped chain, LUT constellations.
//
// Replaces modem_tpu/ops/pallas_chain.py::_chain_kernel (K1) on its
// baseband, noiseless path: int32 symbols -> constellation map -> polyphase
// RRC waveform -> polyphase matched filter at the decision instants ->
// min-distance slice -> int32 decisions. It is the TX kernel followed by the
// RX kernel of txrx.cu with the waveform kept in shared memory: a block
// deciding kTile symbols synthesizes the (kTile + span) * sps samples its
// matched filter reads, from the symbols [m0 - (kp-1), m0 + kTile + span)
// that it loads itself, kp - 1 = span for the RRC (zero I/Q outside [0, K)
// and for negative symbols, the streaming sentinel).
//
// What bounds it on this card: device memory carries only 4 B in and 4 B
// out per symbol, so the waveform never costs bandwidth; the work is about
// (9*2 + 65*2/sps) FMAs per sample plus shared-memory traffic, all on-chip,
// and the shared-memory load instructions (about 1.5 per FMA) are the limit
// of this first version. With kTile = 256, sps = 8 and span = 8 the
// waveform planes take 2 x 8 x 265 x 4 B = 17 KB of shared memory per
// block, so several blocks share an SM. The span-symbol overlap between
// neighbouring tiles is synthesized twice (3% extra work) instead of
// exchanged.

#include "common.cuh"

namespace {

using modem::kTile;

__global__ void chain_lut_kernel(const int* __restrict__ syms, long long k_sym,
                                 long long n_tiles,
                                 const float* __restrict__ lut, int n_points,
                                 const float* __restrict__ taps, int n_taps,
                                 int sps, int span, int* __restrict__ out) {
  extern __shared__ float smem[];
  const int kp = (n_taps + sps - 1) / sps;  // taps per polyphase branch
  const int rows = kTile + span;      // waveform symbols the filter reads
  const int stride = rows | 1;        // odd plane stride
  const int z_len = rows + kp - 1;    // and the symbols they are made of
  float* wi = smem;
  float* wq = wi + sps * stride;
  float* zi = wq + sps * stride;
  float* zq = zi + z_len;
  float* sbank = zq + z_len;
  float* staps = sbank + sps * kp;
  float* slut = staps + n_taps;

  const long long c = blockIdx.x / n_tiles;
  const long long m0 = (blockIdx.x % n_tiles) * kTile;
  modem::stage_bank(sbank, taps, n_taps, sps, kp);
  modem::stage(staps, taps, n_taps);
  modem::stage(slut, lut, 2 * n_points);
  __syncthreads();

  const int* row = syms + c * k_sym;
  for (int t = threadIdx.x; t < z_len; t += blockDim.x)
    modem::map_symbol(row, m0 - (kp - 1) + t, k_sym, slut, n_points, zi[t],
                      zq[t]);
  __syncthreads();

  // waveform sample (m0 + r)*sps + p into plane p, row r
  for (int t = threadIdx.x; t < rows * sps; t += blockDim.x) {
    const int r = t / sps;
    const int p = t - r * sps;
    const float* b = sbank + p * kp;
    float ai = 0.f, aq = 0.f;
    for (int k = 0; k < kp; ++k) {
      const int zk = r + kp - 1 - k;
      ai = fmaf(b[k], zi[zk], ai);
      aq = fmaf(b[k], zq[zk], aq);
    }
    wi[p * stride + r] = ai;
    wq[p * stride + r] = aq;
  }
  __syncthreads();

  for (int ml = threadIdx.x; ml < kTile; ml += blockDim.x) {
    const long long m = m0 + ml;
    if (m >= k_sym) break;
    const float ai = modem::matched_point(wi, stride, staps, n_taps, sps, span, ml);
    const float aq = modem::matched_point(wq, stride, staps, n_taps, sps, span, ml);
    out[c * k_sym + m] = modem::nearest_point(ai, aq, slut, n_points);
  }
}

}  // namespace

extern "C" {

// syms [n_ch, k_sym] int32 -> out [n_ch, k_sym] int32 decisions; lut
// [n_points, 2] and taps [span*sps+1] f32.
int modem_chain_lut(const int* syms, long long n_ch, long long k_sym,
                    const float* lut, int n_points, const float* taps,
                    int n_taps, int sps, int span, int* out, void* stream) {
  // the matched filter's sample window is exactly the tile's halo
  if (n_taps != span * sps + 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long n_tiles = (k_sym + kTile - 1) / kTile;
  const int kp = (n_taps + sps - 1) / sps;
  const int rows = kTile + span;
  const size_t smem =
      (2 * static_cast<size_t>(sps) * (rows | 1) + 2 * (rows + kp - 1) +
       sps * kp + n_taps + 2 * n_points) *
      sizeof(float);
  cudaError_t err = modem::allow_smem(chain_lut_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  chain_lut_kernel<<<modem::grid_blocks(n_ch, n_tiles), modem::kThreads,
                     smem, static_cast<cudaStream_t>(stream)>>>(
      syms, k_sym, n_tiles, lut, n_points, taps, n_taps, sps, span, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
