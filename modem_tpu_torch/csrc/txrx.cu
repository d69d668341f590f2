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
// TX (K2). What bounds it on this card: bytes. It reads 4 B a symbol and
// writes 2 x 4 B a sample (64 B a symbol at sps = 8; half that at passband
// or in bf16, int16) with about 9*2 FMAs a sample, far below the FMA rate,
// so its floor is the device-memory write. Each block stages its span
// symbols of history in shared memory and stores along time, so a warp's
// stores are contiguous. The carrier phase is walked a sample in 32-bit
// integers (common.cuh, Nco). Its body is the first version's: it issues
// about 27 shared-memory loads per 18 FMAs.
//
// RX (K3). What bounds it on this card: bytes, 8 B read a sample (4 at
// passband, half that in bf16) against 65*2 FMAs a symbol, 16 a sample:
// its floor is the device-memory read. The design keeps a block's next
// bytes in flight while it computes and makes the compute cheap in
// instructions:
// - persistent blocks, two or three an SM, each walking a contiguous range
//   of (channel, tile) items, so most items continue the previous tile of
//   their channel; a tile is 4 decisions a thread (512 at sps = 8);
// - double buffering: while a tile is filtered, the next one's samples come
//   into the other buffer by cp.async in 16-byte pieces (8 bf16 values a
//   piece); the span*sps-sample lookahead is copied from the tile before
//   in shared memory rather than read again. A misaligned row (an odd
//   waveform length, the second rail of a [2, C, N] tensor, odd bf16 rows)
//   and the tail go by scalar loads;
// - baseband f32 lands in the filter's buffers as it is; bf16 and passband
//   land raw in a staging buffer and one pass per tile converts them, the
//   passband pass product-detecting with the carrier phase walked in 32-bit
//   integers from a table of up to 2048 phases (common.cuh, Nco);
// - the register-blocked matched filter (common.cuh, matched_fixed): a
//   thread decides 4 consecutive symbols from one walk of their samples in
//   16-byte loads with the taps as constant operands (Taps, a
//   __grid_constant__ parameter), instantiated for the flagship's sps 8,
//   span 8 and once generically.
// - the long route, for a chain past the parameter's 256 taps or 64 samples
//   a symbol: the taps as a device array staged in shared memory, the
//   generic instantiation with one decision a thread (tiles of 32 to 128
//   symbols), each tile loading its whole window where the lookahead is
//   longer than the tile.
// Every decision keeps the first version's one fmaf chain a rail, taps in
// order from j = 0, so pushes of a stream equal one shot and the decisions
// equal the plain version's; tensor cores are no lever here, their TF32
// keeps 10 mantissa bits.

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
  float* ts = tc + nco.period;

  const long long c = blockIdx.x / n_tiles;
  const long long m0 = (blockIdx.x % n_tiles) * kTile;
  const long long n_out = (k_sym + span) * sps;
  modem::stage_bank(sbank, taps, n_taps, sps, kp);
  if (map.lut != nullptr) modem::stage(slut, map.lut, 2 * map.n_points);
  if (kPassband && nco.table) modem::stage_nco(tc, ts, nco);
  __syncthreads();

  const int* row = syms + c * k_sym;
  for (int t = threadIdx.x; t < z_len; t += blockDim.x)
    modem::map_point(row, m0 - (kp - 1) + t, k_sym, map, slut, zi[t], zq[t]);
  __syncthreads();

  const long long n_sym_out = k_sym + span;
  const long long left = n_sym_out - m0;
  const int n_local = static_cast<int>((left < kTile ? left : kTile) * sps);
  const long long base = c * n_out + m0 * sps;
  // the carrier phase of this thread's first sample, then a stride's worth
  // of phase added a sample (common.cuh, Nco)
  int ph = 0, ph_stride = 0;
  if (kPassband) {
    ph = modem::nco_skip(nco, modem::nco_phase(nco, m0 * sps), threadIdx.x);
    ph_stride = modem::nco_skip(nco, 0, blockDim.x);
  }
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
      modem::nco_cos_sin(nco, ph, tc, ts, cs, sn);
      ph = modem::nco_add(nco, ph, ph_stride);
      const float x = __fsub_rn(__fmul_rn(ai, cs), __fmul_rn(aq, sn));
      modem::store_wave(out_i + base + t, x, out_scale);
    } else {
      modem::store_wave(out_i + base + t, ai, out_scale);
      modem::store_wave(out_q + base + t, aq, out_scale);
    }
  }
}

constexpr int kRxR = 4;  // decisions a thread (short route)

// Decisions a thread: one on the long route, so that its tiles of longer
// samples a symbol still fit shared memory.
template <bool kLong>
__host__ __device__ constexpr int rx_r() {
  return kLong ? 1 : kRxR;
}
// Persistent blocks an SM, at most: 2 where baseband f32 lands in the
// filter's buffers directly, 3 where a staging pass converts it (on the
// H100 a third block slowed the direct mode, by a coarser split of the
// items, and sped the staged modes).
constexpr int kRxBlocksDirect = 2;
constexpr int kRxBlocksStaged = 3;

// K3's threads a block, 32 to 128: a tile of r * threads symbols holds
// about 4096 samples a rail (8192 where sps > 32 leaves 32 threads).
inline int rx_threads(int sps, int r) {
  const int t = (4096 / (r * sps)) & ~31;
  return t < 32 ? 32 : t > 128 ? 128 : t;
}

// Samples 4q .. 4q+3 of a staged rail as f32: one 16-byte load of f32, one
// 8-byte load of bf16 (its bits; exact in f32).
__device__ __forceinline__ void raw4(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}

__device__ __forceinline__ void raw4(const unsigned short* p, float (&v)[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(t.x << 16);
  v[1] = __uint_as_float(t.x & 0xFFFF0000u);
  v[2] = __uint_as_float(t.y << 16);
  v[3] = __uint_as_float(t.y & 0xFFFF0000u);
}

// Persistent: block b takes items [b*n/G, (b+1)*n/G) of the n = C * n_tiles
// (channel, tile of `tile` decided symbols) items in channel-major order.
// SPS > 0 is the instantiation for (SPS, SPAN); 0 the generic one. kLong:
// the long route (common.cuh, TapsPtr), always generic.
template <bool kSoft, bool kPassband, typename TRaw, int SPS, int SPAN,
          bool kLong>
__global__ void __launch_bounds__(128)
    pulse_rx_kernel(const TRaw* __restrict__ wi, const TRaw* __restrict__ wq,
                    long long n_wave, long long n_sym, long long n_tiles,
                    long long n_items, int tile, int sps_rt, int span_rt,
                    const __grid_constant__ modem::TapsArg<kLong> taps,
                    modem::Constellation map, modem::Nco nco,
                    int* __restrict__ out_sym, float* __restrict__ out_i,
                    float* __restrict__ out_q) {
  constexpr bool kFixed = SPS > 0;
  static_assert(!(kFixed && kLong), "the long route is generic");
  constexpr int R = rx_r<kLong>();
  constexpr bool kDirect = !kPassband && sizeof(TRaw) == sizeof(float);
  constexpr int kRails = kPassband ? 1 : 2;  // rails read from device memory
  const int sps = kFixed ? SPS : sps_rt;
  const int span = kFixed ? SPAN : span_rt;
  const int n_taps = span * sps + 1;
  const int halo = span * sps;    // lookahead samples of a tile
  const int body = tile * sps;    // the tile's own samples
  const int win = body + halo;    // samples its filter reads
  const int f_len = modem::skew_len(win + 4);
  const int s_len = (win + 7) & ~7;
  const int nt = blockDim.x;
  // a tile's tail is the next one's lookahead, unless the lookahead is the
  // longer (the long route's spans): then each tile loads its whole window
  const bool reuse = !kLong || halo <= body;

  // filter buffers [kDirect ? 2 : 1][2 rails][f_len] f32, skewed; staging
  // [2][kRails][s_len] raw (not direct); the table; the phase table
  extern __shared__ __align__(16) float smem[];
  float* fbuf = smem;
  TRaw* stg = reinterpret_cast<TRaw*>(fbuf + (kDirect ? 4 : 2) * f_len);
  float* slut =
      reinterpret_cast<float*>(stg + (kDirect ? 0 : 2 * kRails * s_len));
  float* tc = slut + (map.lut != nullptr ? 2 * map.n_points : 0);
  float* ts = tc + nco.period;
  float* staps = tc + (kPassband && nco.table ? 2 * nco.period : 0);

  long long lo, hi;
  modem::block_items(n_items, lo, hi);
  if (map.lut != nullptr) modem::stage(slut, map.lut, 2 * map.n_points);
  if (kPassband && nco.table) modem::stage_nco(tc, ts, nco);
  if constexpr (kLong) modem::stage(staps, taps.p, span * sps + 1);
  const auto& tv = modem::tap_view(taps, staps);

  // Bring item `it`'s samples into buffer b: the whole window, or past the
  // lookahead the tile before leaves (cont).
  auto issue = [&](long long it, int b, bool cont) {
    const long long c = it / n_tiles;
    const long long s0 = (it % n_tiles) * tile * sps;
    const int pos0 = cont ? halo : 0;
    const int n = win - pos0;
    const long long avail = n_wave - (s0 + pos0);
    const int n_valid =
        avail <= 0 ? 0 : avail < n ? static_cast<int>(avail) : n;
    for (int rail = 0; rail < kRails; ++rail) {
      const TRaw* src = (rail ? wq : wi) + c * n_wave + s0 + pos0;
      if constexpr (kDirect)
        modem::load_span<true>(fbuf + (2 * b + rail) * f_len, src, pos0, n,
                               n_valid);
      else
        modem::load_span<false>(stg + (b * kRails + rail) * s_len, src, pos0,
                                n, n_valid);
    }
    modem::cp_async_commit();
  };

  if (lo < hi) issue(lo, 0, false);
  for (long long it = lo; it < hi; ++it) {
    const int b = static_cast<int>((it - lo) & 1);
    const bool cont = reuse && it != lo && it % n_tiles != 0;
    const bool cont_next = reuse && it + 1 < hi && (it + 1) % n_tiles != 0;
    if (it + 1 < hi) {
      issue(it + 1, b ^ 1, cont_next);
      modem::cp_async_wait<1>();
    } else {
      modem::cp_async_wait<0>();
    }
    __syncthreads();

    const long long c = it / n_tiles;
    const long long m0 = (it % n_tiles) * tile;
    float* yi;
    float* yq;
    if (kDirect) {
      yi = fbuf + 2 * b * f_len;
      yq = yi + f_len;
      if (cont_next) {  // the next tile's lookahead is this one's tail
        float* ni = fbuf + 2 * (b ^ 1) * f_len;
        for (int e = threadIdx.x; e < halo; e += nt) {
          ni[modem::skew(e)] = yi[modem::skew(body + e)];
          ni[f_len + modem::skew(e)] = yq[modem::skew(body + e)];
        }
      }
    } else {
      yi = fbuf;
      yq = fbuf + f_len;
      // raw -> f32 [product detection], in pieces of 4 samples
      const TRaw* ri = stg + b * kRails * s_len;
      const TRaw* rq = ri + (kPassband ? 0 : s_len);
      const int pos0 = cont ? halo : 0;
      const int q0 = pos0 >> 2;
      int ph = 0, ph_stride = 0;
      if (kPassband) {
        ph = modem::nco_skip(nco, modem::nco_phase(nco, m0 * sps),
                             4 * (q0 + static_cast<int>(threadIdx.x)));
        ph_stride = modem::nco_skip(nco, 0, 4 * nt);
      }
      for (int q = q0 + threadIdx.x; 4 * q < win; q += nt) {
        float vi[4], vq[4];
        raw4(ri + 4 * q, vi);  // past win: not stored
        if (kPassband) {
          int k = ph;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float cs, sn;
            modem::nco_cos_sin(nco, k, tc, ts, cs, sn);
            k = modem::nco_add(nco, k, nco.step);
            const float x2 = 2.f * vi[e];
            vi[e] = __fmul_rn(x2, cs);
            vq[e] = __fmul_rn(-x2, sn);
          }
        } else {
          raw4(rq + 4 * q, vq);
        }
        if (kPassband) ph = modem::nco_add(nco, ph, ph_stride);
        const int sk = modem::skew(4 * q);
        if (4 * q >= pos0 && 4 * q + 4 <= win) {
          *reinterpret_cast<float4*>(yi + sk) =
              make_float4(vi[0], vi[1], vi[2], vi[3]);
          *reinterpret_cast<float4*>(yq + sk) =
              make_float4(vq[0], vq[1], vq[2], vq[3]);
        } else {
          for (int e = 0; e < 4; ++e) {
            const int p = 4 * q + e;
            if (p >= pos0 && p < win) {
              yi[modem::skew(p)] = vi[e];
              yq[modem::skew(p)] = vq[e];
            }
          }
        }
      }
      __syncthreads();
    }

    // the matched filter: decisions m0 + r0 .. m0 + r0 + kRxR - 1
    const long long left = n_sym - m0;
    const int n_out = left < tile ? static_cast<int>(left) : tile;
    const int r0 = R * static_cast<int>(threadIdx.x);
    if (r0 < n_out) {
      float acc[2][R] = {};
      const float* const rails[2] = {yi, yq};
      if constexpr (kFixed)
        modem::matched_fixed<R, SPS, SPAN * SPS + 1>(rails, r0 * SPS, taps,
                                                     acc);
      else
        modem::matched_generic<R>(rails, r0 * sps, sps, n_taps, tv, acc);
      const long long o = c * n_sym + m0 + r0;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r0 + r >= n_out) break;
        if (kSoft) {
          out_i[o + r] = acc[0][r];
          out_q[o + r] = acc[1][r];
        } else {
          out_sym[o + r] = modem::decide(acc[0][r], acc[1][r], map, slut);
        }
      }
    }
    if (!kDirect && cont_next) {  // the next tile's lookahead: this tail
      __syncthreads();
      for (int e = threadIdx.x; e < halo; e += nt) {
        yi[modem::skew(e)] = yi[modem::skew(body + e)];
        yq[modem::skew(e)] = yq[modem::skew(body + e)];
      }
    }
    if (kDirect) __syncthreads();  // before the next issue reuses buffer b
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

template <bool kSoft, bool kPassband, typename TRaw, int SPS, int SPAN,
          bool kLong>
int launch_rx(const void* wi, const void* wq, long long n_ch,
              long long n_wave, long long n_sym,
              const modem::TapsArg<kLong>& taps, int sps, int span,
              const modem::Constellation& map, const modem::Nco& nco,
              int* out_sym, float* out_i, float* out_q, void* stream) {
  constexpr bool kDirect = !kPassband && sizeof(TRaw) == sizeof(float);
  constexpr int kRails = kPassband ? 1 : 2;
  auto kernel = pulse_rx_kernel<kSoft, kPassband, TRaw, SPS, SPAN, kLong>;
  const int nt = rx_threads(sps, rx_r<kLong>());
  const int tile = rx_r<kLong>() * nt;
  const int win = (tile + span) * sps;
  const long long n_tiles = (n_sym + tile - 1) / tile;
  const long long n_items = n_ch * n_tiles;
  const size_t smem =
      (kDirect ? 4 : 2) * sizeof(float) * modem::skew_len(win + 4) +
      (kDirect ? 0 : 2 * kRails * sizeof(TRaw) * ((win + 7) & ~7)) +
      sizeof(float) * (modem::side_floats(map, nco) +
                       (kLong ? span * sps + 1 : 0));
  cudaError_t err = modem::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  unsigned grid = 0;
  err = modem::persistent_grid(kernel, nt, smem,
                               kDirect ? kRxBlocksDirect : kRxBlocksStaged,
                               n_items, grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, nt, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const TRaw*>(wi), static_cast<const TRaw*>(wq), n_wave,
      n_sym, n_tiles, n_items, tile, sps, span, taps, map, nco, out_sym, out_i,
      out_q);
  return static_cast<int>(cudaGetLastError());
}

// The RX instantiation for a route, a shape, a carrier mode and an input
// type: taps is a host modem::Taps (the short route), or null for the long
// route, which reads taps_dev.
template <bool kSoft, bool kPassband, typename TRaw>
int launch_rx_shape(const void* wi, const void* wq, long long n_ch,
                    long long n_wave, long long n_sym, const void* taps,
                    const float* taps_dev, int n_taps, int sps, int span,
                    const modem::Constellation& map, const modem::Nco& nco,
                    int* out_sym, float* out_i, float* out_q, void* stream) {
  // the matched filter's sample window is exactly the tile's halo
  if (n_taps != span * sps + 1 || sps < 1 || span < 0 ||
      (taps == nullptr ? taps_dev == nullptr
                       : n_taps > modem::kMaxTaps || sps > modem::kMaxSps))
    return static_cast<int>(cudaErrorInvalidValue);
  if (taps == nullptr)
    return launch_rx<kSoft, kPassband, TRaw, 0, 0, true>(
        wi, wq, n_ch, n_wave, n_sym, modem::TapsPtr{taps_dev}, sps, span, map,
        nco, out_sym, out_i, out_q, stream);
  const modem::Taps& t = *static_cast<const modem::Taps*>(taps);
  if (sps == 8 && span == 8)
    return launch_rx<kSoft, kPassband, TRaw, 8, 8, false>(
        wi, wq, n_ch, n_wave, n_sym, t, sps, span, map, nco, out_sym, out_i,
        out_q, stream);
  return launch_rx<kSoft, kPassband, TRaw, 0, 0, false>(
      wi, wq, n_ch, n_wave, n_sym, t, sps, span, map, nco, out_sym, out_i,
      out_q, stream);
}

template <bool kSoft, typename... Args>
int launch_rx_mode(bool passband, int in_bf16, Args... args) {
  using Bf16 = unsigned short;  // bf16 travels as its bits
  if (passband)
    return in_bf16 ? launch_rx_shape<kSoft, true, Bf16>(args...)
                   : launch_rx_shape<kSoft, true, float>(args...);
  return in_bf16 ? launch_rx_shape<kSoft, false, Bf16>(args...)
                 : launch_rx_shape<kSoft, false, float>(args...);
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
// -> out_sym [n_ch, n_sym] int32, samples past n_wave read as zero; the map
// and carrier as modem_tx's; the span*sps+1 taps: taps a host pointer to
// them in a modem::Taps, passed to the kernel by value (the short route:
// n_taps <= 256, sps <= 64), or taps null and taps_dev the device array
// (the long route: any chain whose tile fits shared memory).
int modem_rx_hard(const void* wi, const void* wq, int in_bf16, long long n_ch,
                  long long n_wave, long long n_sym, const void* taps,
                  const float* taps_dev, int n_taps, int sps, int span,
                  const float* lut, int n_points, int cshift, float ms,
                  float a, float c, float s, int hz, int sr,
                  long long sym_offset, float scale, int* out_sym,
                  void* stream) {
  modem::Nco nco;
  if (!modem::make_nco(hz, sr, sps, sym_offset, scale, nco))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_rx_mode<false>(
      sr != 0, in_bf16, wi, wq, n_ch, n_wave, n_sym, taps, taps_dev, n_taps,
      sps, span, modem::make_map(lut, n_points, cshift, ms, a, c, s), nco,
      out_sym, static_cast<float*>(nullptr), static_cast<float*>(nullptr),
      stream);
}

// As modem_rx_hard, to the decision-point I/Q out_i, out_q [n_ch, n_sym].
int modem_rx_soft(const void* wi, const void* wq, int in_bf16, long long n_ch,
                  long long n_wave, long long n_sym, const void* taps,
                  const float* taps_dev, int n_taps, int sps, int span,
                  int hz, int sr, long long sym_offset, float scale,
                  float* out_i, float* out_q, void* stream) {
  modem::Nco nco;
  if (!modem::make_nco(hz, sr, sps, sym_offset, scale, nco))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_rx_mode<true>(
      sr != 0, in_bf16, wi, wq, n_ch, n_wave, n_sym, taps, taps_dev, n_taps,
      sps, span,
      modem::make_map(nullptr, 0, 0, 0.f, 1.f, 1.f, 0.f), nco,
      static_cast<int*>(nullptr), out_i, out_q, stream);
}

const char* modem_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
