// Fused one-way TX and RX of the pulse-shaped chain.
//
// TX replaces modem_tpu/ops/pallas_txrx.py::_tx_kernel (K2): int32 symbols
// -> constellation map (a table of up to 64 points, or algebraic square
// QAM) -> polyphase RRC interpolation -> baseband I/Q,
//   w[m*sps + p] = sum_k bank[p][k] * z[m - k],  m < K + span,
// z = 0 outside [0, K) and for negative symbols; at passband the one real
// waveform x = wi*cos - wq*sin of the exact integer NCO (common.cuh, Nco);
// stored as f32, bf16 or int16 (common.cuh, store_wave). Each kernel is
// instantiated per carrier mode and waveform type, so the baseband f32 mode
// runs no NCO code and plain float loads and stores.
// RX replaces modem_tpu/ops/pallas_txrx.py::_rx_kernel (K3): baseband I/Q
// (f32 or bf16), or at passband the real waveform product-detected with 2x
// gain (yi = 2x*cos, yq = -2x*sin), -> polyphase matched filter at the
// decision instants
//   z[m] = sum_j taps[j] * y[m*sps + span*sps - j],  m < K,
// -> the slice (min-distance, or QAM's algebraic one) to int32 symbols, or
// the soft (i, q) points. sym_offset, the stream-global index of symbol 0,
// keeps the carrier phase of a stream's blocks aligned.
//
// What bounds them on this card: bytes. TX reads 4 B per symbol and writes
// 2 x 4 B per sample (64 B per symbol at sps = 8; half that at passband or
// in bf16, int16), about 9*2 FMAs per sample; RX reads 8 B per sample and
// writes 4 or 8 B per symbol, 65*2 FMAs per symbol. The NCO adds a cos and a
// sin per sample where the carrier has more than 16 phases (a table
// otherwise) and a few multiplies: still under the byte time. Both are far
// below the FMA rate, so their floor is the device-memory write (TX) and
// read (RX) time. The design therefore touches device memory once per
// element: each block stages its own halo (span symbols back for TX,
// span*sps samples ahead for RX, under 4% extra at the 256-symbol tile) in
// shared memory, and stores and loads run along time, so a warp's accesses
// are contiguous. This first version is not at that floor (on an H100 80GB
// HBM3 at 700 W, TX reaches about 44% and RX about 25% of the 3.35 TB/s
// peak in the flagship mode; PERF.md): TX issues 27 shared-memory loads per
// 18 FMAs, and RX's block loads its tile with scalar loads before it
// filters. Registers for the taps, vector loads and TMA come next.

#include "common.cuh"

namespace {

using modem::kThreads;
using modem::kTile;

// Grid: one block per (channel, tile of kTile output symbols), flattened.
template <bool kPassband, typename TOut>
__global__ void pulse_tx_kernel(const int* __restrict__ syms, long long k_sym,
                                long long n_tiles, modem::Constellation map,
                                const float* __restrict__ taps, int n_taps,
                                int sps, int span, modem::Nco nco,
                                float out_scale, TOut* __restrict__ out_i,
                                TOut* __restrict__ out_q) {
  extern __shared__ float smem[];
  const int kp = (n_taps + sps - 1) / sps;  // taps per polyphase branch
  const int z_len = kTile + kp - 1;  // the tile's symbols and kp-1 behind
  float* zi = smem;
  float* zq = zi + z_len;
  float* sbank = zq + z_len;
  float* slut = sbank + sps * kp;
  float* tc = slut + (map.lut != nullptr ? 2 * map.n_points : 0);
  float* ts = tc + nco.n_ph;

  const long long c = blockIdx.x / n_tiles;
  const long long m0 = (blockIdx.x % n_tiles) * kTile;
  const long long n_out = (k_sym + span) * sps;
  modem::stage_bank(sbank, taps, n_taps, sps, kp);
  if (map.lut != nullptr) modem::stage(slut, map.lut, 2 * map.n_points);
  if (kPassband && nco.n_ph <= modem::kNcoTable) modem::stage_nco(tc, ts, nco);
  __syncthreads();

  const int* row = syms + c * k_sym;
  for (int t = threadIdx.x; t < z_len; t += blockDim.x)
    modem::map_point(row, m0 - (kp - 1) + t, k_sym, map, slut, zi[t], zq[t]);
  __syncthreads();

  const long long n_sym_out = k_sym + span;
  const long long left = n_sym_out - m0;
  const int n_local = static_cast<int>((left < kTile ? left : kTile) * sps);
  const long long base = c * n_out + m0 * sps;
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
    if (kPassband) {
      float cs, sn;
      modem::nco_cos_sin(nco, nco.sym_offset + m0 + ml, p, tc, ts, cs, sn);
      const float x = __fsub_rn(__fmul_rn(ai, cs), __fmul_rn(aq, sn));
      modem::store_wave(out_i + base + t, x, out_scale);
    } else {
      modem::store_wave(out_i + base + t, ai, out_scale);
      modem::store_wave(out_q + base + t, aq, out_scale);
    }
  }
}

// Grid: one block per (channel, tile of kTile decided symbols), flattened.
template <bool kSoft, bool kPassband, typename TIn>
__global__ void pulse_rx_kernel(const TIn* __restrict__ wi,
                                const TIn* __restrict__ wq,
                                long long n_wave, long long n_sym,
                                long long n_tiles,
                                const float* __restrict__ taps, int n_taps,
                                int sps, int span, modem::Constellation map,
                                modem::Nco nco, int* __restrict__ out_sym,
                                float* __restrict__ out_i,
                                float* __restrict__ out_q) {
  extern __shared__ float smem[];
  const int rows = kTile + span;  // the tile's samples and span*sps ahead
  const int stride = rows | 1;    // odd plane stride: fewer bank conflicts
  float* yi = smem;
  float* yq = yi + sps * stride;
  float* staps = yq + sps * stride;
  float* slut = staps + n_taps;
  float* tc = slut + (map.lut != nullptr ? 2 * map.n_points : 0);
  float* ts = tc + nco.n_ph;

  const long long c = blockIdx.x / n_tiles;
  const long long m0 = (blockIdx.x % n_tiles) * kTile;
  modem::stage(staps, taps, n_taps);
  if (map.lut != nullptr) modem::stage(slut, map.lut, 2 * map.n_points);
  if (kPassband && nco.n_ph <= modem::kNcoTable) {
    modem::stage_nco(tc, ts, nco);
    __syncthreads();  // the staging below reads the phase table
  }

  // Samples past the end of the waveform read as zero.
  const long long s0 = m0 * sps;
  const long long off = c * n_wave;
  for (int t = threadIdx.x; t < rows * sps; t += blockDim.x) {
    const long long s = s0 + t;
    const int r = t / sps;
    const int p = t - r * sps;
    const bool in = s < n_wave;
    float vi, vq;
    if (kPassband) {
      const float x2 = in ? 2.f * modem::load_wave(wi[off + s]) : 0.f;
      float cs, sn;
      modem::nco_cos_sin(nco, nco.sym_offset + m0 + r, p, tc, ts, cs, sn);
      vi = __fmul_rn(x2, cs);
      vq = __fmul_rn(-x2, sn);
    } else {
      vi = in ? modem::load_wave(wi[off + s]) : 0.f;
      vq = in ? modem::load_wave(wq[off + s]) : 0.f;
    }
    yi[p * stride + r] = vi;
    yq[p * stride + r] = vq;
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
      out_sym[c * n_sym + m] = modem::decide(ai, aq, map, slut);
    }
  }
}

template <bool kPassband, typename TOut>
int launch_tx(const int* syms, long long n_ch, long long k_sym,
              const modem::Constellation& map, const float* taps, int n_taps,
              int sps, int span, const modem::Nco& nco, float out_scale,
              void* out_i, void* out_q, void* stream) {
  const long long n_tiles = (k_sym + span + kTile - 1) / kTile;
  const int kp = (n_taps + sps - 1) / sps;
  const size_t smem = (2 * static_cast<size_t>(kTile + kp - 1) + sps * kp +
                       modem::side_floats(map, nco)) *
                      sizeof(float);
  cudaError_t err =
      modem::allow_smem(pulse_tx_kernel<kPassband, TOut>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  pulse_tx_kernel<kPassband, TOut>
      <<<modem::grid_blocks(n_ch, n_tiles), kThreads, smem,
         static_cast<cudaStream_t>(stream)>>>(
          syms, k_sym, n_tiles, map, taps, n_taps, sps, span, nco, out_scale,
          static_cast<TOut*>(out_i), static_cast<TOut*>(out_q));
  return static_cast<int>(cudaGetLastError());
}

// The TX instantiation for a storage kind (common.cuh, WaveKind).
template <bool kPassband, typename... Args>
int launch_tx_kind(int out_kind, Args... args) {
  switch (out_kind) {
    case modem::kF32: return launch_tx<kPassband, float>(args...);
    case modem::kBf16: return launch_tx<kPassband, __nv_bfloat16>(args...);
    case modem::kI16: return launch_tx<kPassband, short>(args...);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <bool kSoft, bool kPassband, typename TIn>
int launch_rx(const void* wi, const void* wq, long long n_ch,
              long long n_wave, long long n_sym, const float* taps, int n_taps,
              int sps, int span, const modem::Constellation& map,
              const modem::Nco& nco, int* out_sym, float* out_i, float* out_q,
              void* stream) {
  // the matched filter's sample window is exactly the tile's halo
  if (n_taps != span * sps + 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long n_tiles = (n_sym + kTile - 1) / kTile;
  const int stride = (kTile + span) | 1;
  const size_t smem = (2 * static_cast<size_t>(sps) * stride + n_taps +
                       modem::side_floats(map, nco)) *
                      sizeof(float);
  cudaError_t err =
      modem::allow_smem(pulse_rx_kernel<kSoft, kPassband, TIn>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  pulse_rx_kernel<kSoft, kPassband, TIn>
      <<<modem::grid_blocks(n_ch, n_tiles), kThreads, smem,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const TIn*>(wi), static_cast<const TIn*>(wq), n_wave,
          n_sym, n_tiles, taps, n_taps, sps, span, map, nco, out_sym, out_i,
          out_q);
  return static_cast<int>(cudaGetLastError());
}

// The RX instantiation for a carrier mode and an input type.
template <bool kSoft, typename... Args>
int launch_rx_mode(bool passband, int in_bf16, Args... args) {
  if (passband)
    return in_bf16 ? launch_rx<kSoft, true, __nv_bfloat16>(args...)
                   : launch_rx<kSoft, true, float>(args...);
  return in_bf16 ? launch_rx<kSoft, false, __nv_bfloat16>(args...)
                 : launch_rx<kSoft, false, float>(args...);
}

}  // namespace

extern "C" {

// syms [n_ch, k_sym] int32 -> out_i, out_q [n_ch, (k_sym+span)*sps]
// (out_q unused at passband) of out_kind (0 f32, 1 bf16, 2 int16 with
// out_scale). The map: lut [n_points, 2] f32, or with lut null square QAM
// (cshift, ms, a, c, s); the carrier: sr == 0 baseband, else hz, sr,
// sym_offset and scale = f32(2*pi/sr); taps [n_taps] f32. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a carrier the NCO does
// not take.
int modem_tx(const int* syms, long long n_ch, long long k_sym,
             const float* lut, int n_points, int cshift, float ms, float a,
             float c, float s, const float* taps, int n_taps, int sps,
             int span, int hz, int sr, long long sym_offset, float scale,
             int out_kind, float out_scale, void* out_i, void* out_q,
             void* stream) {
  const modem::Constellation map =
      modem::make_map(lut, n_points, cshift, ms, a, c, s);
  modem::Nco nco;
  if (!modem::make_nco(hz, sr, sps, sym_offset, scale, nco))
    return static_cast<int>(cudaErrorInvalidValue);
  if (sr != 0)
    return launch_tx_kind<true>(out_kind, syms, n_ch, k_sym, map, taps,
                                n_taps, sps, span, nco, out_scale, out_i,
                                out_q, stream);
  return launch_tx_kind<false>(out_kind, syms, n_ch, k_sym, map, taps, n_taps,
                               sps, span, nco, out_scale, out_i, out_q,
                               stream);
}

// wi, wq [n_ch, n_wave] (f32, or bf16 with in_bf16; wq unused at passband)
// with n_wave >= (n_sym+span)*sps -> out_sym [n_ch, n_sym] int32; the map
// and carrier as modem_tx's; taps [span*sps+1] f32.
int modem_rx_hard(const void* wi, const void* wq, int in_bf16, long long n_ch,
                  long long n_wave, long long n_sym, const float* taps,
                  int n_taps, int sps, int span, const float* lut,
                  int n_points, int cshift, float ms, float a, float c,
                  float s, int hz, int sr, long long sym_offset, float scale,
                  int* out_sym, void* stream) {
  modem::Nco nco;
  if (!modem::make_nco(hz, sr, sps, sym_offset, scale, nco))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_rx_mode<false>(
      sr != 0, in_bf16, wi, wq, n_ch, n_wave, n_sym, taps, n_taps, sps, span,
      modem::make_map(lut, n_points, cshift, ms, a, c, s), nco, out_sym,
      static_cast<float*>(nullptr), static_cast<float*>(nullptr), stream);
}

// As modem_rx_hard, to the decision-point I/Q out_i, out_q [n_ch, n_sym].
int modem_rx_soft(const void* wi, const void* wq, int in_bf16, long long n_ch,
                  long long n_wave, long long n_sym, const float* taps,
                  int n_taps, int sps, int span, int hz, int sr,
                  long long sym_offset, float scale, float* out_i,
                  float* out_q, void* stream) {
  modem::Nco nco;
  if (!modem::make_nco(hz, sr, sps, sym_offset, scale, nco))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_rx_mode<true>(
      sr != 0, in_bf16, wi, wq, n_ch, n_wave, n_sym, taps, n_taps, sps, span,
      modem::make_map(nullptr, 0, 0, 0.f, 1.f, 1.f, 0.f), nco,
      static_cast<int*>(nullptr), out_i, out_q, stream);
}

const char* modem_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
