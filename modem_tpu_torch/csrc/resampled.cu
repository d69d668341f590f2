// Config #4's fused pair, the QAM chain with a rational resampler in it:
// replaces the two kernels of modem_tpu/ops/pallas_resampled.py.
//
// K11 resampled_tx_kernel (_resampled_tx_kernel): int32 symbols ->
//   constellation map -> polyphase RRC interpolation to the modem rate
//   (kept in shared memory) -> rational up/down stage -> channel-rate I/Q.
// K12 resampled_rx_kernel (_resampled_rx_kernel): channel-rate I/Q -> one
//   periodically time-varying stage to the symbol rate (the down/up
//   resampler, the matched filter and the decimation collapsed into one
//   table) -> min-distance slice to int32 symbols, or the soft (i, q).
//
// Both rate stages have one form, a periodically time-varying FIR
//   out[m] = sum_o table[m % P][o] * x[(m / P) * S + first + o],
// x zero outside [0, N): K11's up/down stage with P = up, S = down (the
// table from _stage_weights), K12 with P = down / gcd(sps*up, down),
// S = sps*up / gcd(sps*up, down) (_composite_rx_weights). The tables are
// built on the host (ops/resampled_kernel.py) and staged in shared memory.
// Each block holds its window of x in phase-major planes (plane p, row r
// holds window sample r*S + p), so the threads of a warp, consecutive
// outputs, read consecutive words of one plane, or one word together.
//
// What bounds them on this card: bytes. At 3/2 (sps 8) K11 writes 8 B per
// channel sample and reads 4 B per symbol, against 16 MACs per sample and
// rail for the stage plus 65 per symbol and rail for the RRC; K12 reads 8 B
// per channel sample and writes 4-8 B per symbol, against about 112 MACs
// per symbol and rail. Both sit under the f32 FMA rate, so their floor is
// the channel-rate write (K11) and read (K12). The design touches device
// memory once per element: a K11 block maps its own symbols and builds its
// modem-rate waveform in shared memory (the stage's lookback recomputed
// per tile, about 1% extra at 3/2), which never reaches device memory; a
// K12 block loads its channel window with coalesced loads before it
// filters (the table's n_o-sample reach read again per tile, under 4% at
// 3/2). Shared-memory loads, one per tap and rail plus one per tap for the
// table, are the limit of this first version; registers for the taps and
// overlapped loads come next. No fast math: kernel and plain version agree
// to f32 rounding (nvcc's FMAs).

#include "common.cuh"

namespace {

using modem::kThreads;
constexpr int kOutTile = 2048;  // K11: channel samples per block, at most
constexpr int kSymTile = 256;   // K12: symbols per block, at most
constexpr int kWindow = 4096;   // either: window samples per block, about

__device__ __forceinline__ long long floor_div(long long a, long long b) {
  return a >= 0 ? a / b : -((b - 1 - a) / b);
}

// Both rails of one output: sum_o tab[o] * x[gl * width + o] over a window
// in phase-major planes of row stride `stride`, the q rail's planes
// width * stride after the i rail's; taps in order o = 0, 1, ... as in the
// plain version, each tap loaded once for the two rails.
__device__ __forceinline__ void ptv_pair(const float* planes, int stride,
                                         int width, const float* tab, int n_o,
                                         int gl, float& ai, float& aq) {
  const int rail = width * stride;
  int at = gl;  // plane p, row gl + q
  int p = 0;
  ai = 0.f;
  aq = 0.f;
  for (int o = 0; o < n_o; ++o) {
    const float w = tab[o];
    ai = fmaf(w, planes[at], ai);
    aq = fmaf(w, planes[at + rail], aq);
    if (++p == width) {
      p = 0;
      at += 1 - (width - 1) * stride;
    } else {
      at += stride;
    }
  }
}

// Window rows per plane for `groups` output groups of n_o taps.
__host__ __device__ inline int window_rows(int groups, int n_o, int width) {
  return groups + (n_o - 1) / width;
}

// K11. Grid: one block per (channel, tile of `groups` groups of `up`
// channel samples), flattened. The block's window holds modem samples
// [n0, n0 + rows*down), n0 = g0*down + first; their symbols
// [ms_lo, ...) sit in zi/zq, mapped (zero outside [0, K) and for negative
// symbols, the streaming sentinel).
__global__ void __launch_bounds__(kThreads)
resampled_tx_kernel(const int* __restrict__ syms, long long k_sym,
                    long long n_tiles, const float* __restrict__ lut,
                    int n_points, const float* __restrict__ taps, int n_taps,
                    int sps, const float* __restrict__ table, int up,
                    int down, int n_o, int first, int groups, int z_cap,
                    long long n_out, float* __restrict__ out_i,
                    float* __restrict__ out_q) {
  extern __shared__ float smem[];
  const int kp = (n_taps + sps - 1) / sps;  // taps per RRC branch
  const int rows = window_rows(groups, n_o, down);
  const int stride = rows | 1;  // odd plane stride: fewer bank conflicts
  float* wi = smem;
  float* wq = wi + down * stride;
  float* zi = wq + down * stride;
  float* zq = zi + z_cap;
  float* sbank = zq + z_cap;
  float* stab = sbank + sps * kp;
  float* slut = stab + up * n_o;

  const long long c = blockIdx.x / n_tiles;
  const long long g0 = (blockIdx.x % n_tiles) * groups;
  const long long n0 = g0 * down + first;
  const int win = rows * down;
  const long long ms0 = floor_div(n0, sps);  // the symbol of modem sample n0
  const int ph0 = static_cast<int>(n0 - ms0 * sps);
  const long long ms_lo = ms0 - (kp - 1);
  const int z_len = (ph0 + win - 1) / sps + kp;
  modem::stage_bank(sbank, taps, n_taps, sps, kp);
  modem::stage(stab, table, up * n_o);
  modem::stage(slut, lut, 2 * n_points);
  __syncthreads();

  const int* row = syms + c * k_sym;
  for (int t = threadIdx.x; t < z_len; t += blockDim.x)
    modem::map_symbol(row, ms_lo + t, k_sym, slut, n_points, zi[t], zq[t]);
  __syncthreads();

  // modem sample n0 + t, of symbol ms0 + dm and phase ph, into plane
  // t % down, row t / down
  for (int t = threadIdx.x; t < win; t += blockDim.x) {
    const int dm = (ph0 + t) / sps;
    const float* b = sbank + (ph0 + t - dm * sps) * kp;
    const int z0 = kp - 1 + dm;
    float ai = 0.f, aq = 0.f;
    for (int k = 0; k < kp; ++k) {
      ai = fmaf(b[k], zi[z0 - k], ai);
      aq = fmaf(b[k], zq[z0 - k], aq);
    }
    const int r = t / down;
    wi[(t - r * down) * stride + r] = ai;
    wq[(t - r * down) * stride + r] = aq;
  }
  __syncthreads();

  const long long m0 = g0 * up;
  const long long left = n_out - m0;
  const int n_local = static_cast<int>(left < groups * up ? left : groups * up);
  float* oi = out_i + c * n_out + m0;
  float* oq = out_q + c * n_out + m0;
  for (int t = threadIdx.x; t < n_local; t += blockDim.x) {
    const int gl = t / up;
    float ai, aq;
    ptv_pair(wi, stride, down, stab + (t - gl * up) * n_o, n_o, gl, ai, aq);
    oi[t] = ai;
    oq[t] = aq;
  }
}

// K12. Grid: one block per (channel, tile of `groups` groups of `period`
// symbols), flattened. The block's window holds channel samples
// [s0, s0 + rows*width), s0 = g0*width + first, zero outside the waveform
// (before it: the resampler's zero history).
template <bool kSoft>
__global__ void __launch_bounds__(kThreads)
resampled_rx_kernel(const float* __restrict__ wi, const float* __restrict__ wq,
                    long long n_wave, long long n_sym, long long n_tiles,
                    const float* __restrict__ table, int period, int width,
                    int n_o, int first, int groups,
                    const float* __restrict__ lut, int n_points,
                    int* __restrict__ out_sym, float* __restrict__ out_i,
                    float* __restrict__ out_q) {
  extern __shared__ float smem[];
  const int rows = window_rows(groups, n_o, width);
  const int stride = rows | 1;
  float* yi = smem;
  float* yq = yi + width * stride;
  float* stab = yq + width * stride;
  float* slut = stab + period * n_o;

  const long long c = blockIdx.x / n_tiles;
  const long long g0 = (blockIdx.x % n_tiles) * groups;
  const long long s0 = g0 * width + first;
  modem::stage(stab, table, period * n_o);
  modem::stage(slut, lut, 2 * n_points);
  const float* ri = wi + c * n_wave;
  const float* rq = wq + c * n_wave;
  for (int t = threadIdx.x; t < rows * width; t += blockDim.x) {
    const long long s = s0 + t;
    const int r = t / width;
    const bool in = s >= 0 && s < n_wave;
    yi[(t - r * width) * stride + r] = in ? ri[s] : 0.f;
    yq[(t - r * width) * stride + r] = in ? rq[s] : 0.f;
  }
  __syncthreads();

  const long long m0 = g0 * period;
  for (int ml = threadIdx.x; ml < groups * period; ml += blockDim.x) {
    const long long m = m0 + ml;
    if (m >= n_sym) break;
    const int gl = ml / period;
    float ai, aq;
    ptv_pair(yi, stride, width, stab + (ml - gl * period) * n_o, n_o, gl, ai,
             aq);
    if (kSoft) {
      out_i[c * n_sym + m] = ai;
      out_q[c * n_sym + m] = aq;
    } else {
      out_sym[c * n_sym + m] = modem::nearest_point(ai, aq, slut, n_points);
    }
  }
}

inline int tile_groups(int cap, int per_group, int width) {
  const int g = cap / per_group < kWindow / width ? cap / per_group
                                                  : kWindow / width;
  return g > 1 ? g : 1;
}

template <bool kSoft>
int launch_rx(const float* wi, const float* wq, long long n_ch,
              long long n_wave, long long n_sym, const float* table,
              int period, int width, int n_o, int first, const float* lut,
              int n_points, int* out_sym, float* out_i, float* out_q,
              void* stream) {
  const int groups = tile_groups(kSymTile, period, width);
  const int stride = window_rows(groups, n_o, width) | 1;
  const long long n_tiles = ((n_sym + period - 1) / period + groups - 1) / groups;
  const size_t smem = (2 * static_cast<size_t>(width) * stride +
                       static_cast<size_t>(period) * n_o + 2 * n_points) *
                      sizeof(float);
  cudaError_t err = modem::allow_smem(resampled_rx_kernel<kSoft>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  resampled_rx_kernel<kSoft><<<modem::grid_blocks(n_ch, n_tiles), kThreads,
                               smem, static_cast<cudaStream_t>(stream)>>>(
      wi, wq, n_wave, n_sym, n_tiles, table, period, width, n_o, first, groups,
      lut, n_points, out_sym, out_i, out_q);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// syms [n_ch, k_sym] int32 -> out_i, out_q [n_ch, n_out] f32; lut
// [n_points, 2], taps [n_taps] (the RRC), table [up, n_o] (the up/down
// stage) f32. Returns cudaGetLastError(), or cudaErrorInvalidValue for
// arguments the kernel does not take.
int modem_resampled_tx(const int* syms, long long n_ch, long long k_sym,
                       const float* lut, int n_points, const float* taps,
                       int n_taps, int sps, const float* table, int up,
                       int down, int n_o, int first, long long n_out,
                       float* out_i, float* out_q, void* stream) {
  if (sps < 1 || n_taps < 1 || up < 1 || down < 1 || n_o < 1 ||
      n_points < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int groups = tile_groups(kOutTile, up, down);
  const int rows = window_rows(groups, n_o, down);
  const int kp = (n_taps + sps - 1) / sps;
  const int z_cap = (rows * down - 1) / sps + 1 + kp;
  const long long n_tiles = ((n_out + up - 1) / up + groups - 1) / groups;
  const size_t smem =
      (2 * static_cast<size_t>(down) * (rows | 1) + 2 * z_cap + sps * kp +
       static_cast<size_t>(up) * n_o + 2 * n_points) *
      sizeof(float);
  cudaError_t err = modem::allow_smem(resampled_tx_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  resampled_tx_kernel<<<modem::grid_blocks(n_ch, n_tiles), kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      syms, k_sym, n_tiles, lut, n_points, taps, n_taps, sps, table, up, down,
      n_o, first, groups, z_cap, n_out, out_i, out_q);
  return static_cast<int>(cudaGetLastError());
}

// wi, wq [n_ch, n_wave] f32 -> out_sym [n_ch, n_sym] int32 decisions
// against lut [n_points, 2] (soft == 0), or the decision-point I/Q out_i,
// out_q [n_ch, n_sym] f32 (soft != 0); table [period, n_o] f32.
int modem_resampled_rx(const float* wi, const float* wq, long long n_ch,
                       long long n_wave, long long n_sym, const float* table,
                       int period, int width, int n_o, int first,
                       const float* lut, int n_points, int soft, int* out_sym,
                       float* out_i, float* out_q, void* stream) {
  if (period < 1 || period > kSymTile || width < 1 || n_o < 1 ||
      (!soft && n_points < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (soft)
    return launch_rx<true>(wi, wq, n_ch, n_wave, n_sym, table, period, width,
                           n_o, first, lut, n_points, nullptr, out_i, out_q,
                           stream);
  return launch_rx<false>(wi, wq, n_ch, n_wave, n_sym, table, period, width,
                          n_o, first, lut, n_points, out_sym, nullptr,
                          nullptr, stream);
}

}  // extern "C"
