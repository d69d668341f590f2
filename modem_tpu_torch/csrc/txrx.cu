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
// or in bf16, int16) against about 2*L FMAs a symbol (L = span*sps + 1
// taps: 130 at the flagship's sps 8, span 8), far below the FMA rate, so
// its floor is the device-memory write. The first version ran one thread a
// sample with a run-time t / sps and tap loop, and issued about 27
// shared-memory loads (its polyphase bank, staged by every block, and the
// points) per 18 FMAs. The design (pulse_tx_core), on K1's synthesis
// (chain.cu):
// - the taps are a __grid_constant__ kernel parameter (common.cuh, Taps):
//   with the loops unrolled each entry of the polyphase bank reaches its
//   FFMA as a constant operand, and no block stages a bank; compiled
//   for the flagship's sps 8, span 8, the one shape every preset and link
//   runs;
// - a block of 128 threads makes a tile of 256 rows (a row: a symbol's sps
//   samples). Each thread loads its symbols of the tile's points (the
//   rows and span before them) first, so that their latency runs under
//   the staging of the tables, then maps them once into shared memory as
//   float2, zero outside [0, K) and for negative symbols (the streaming
//   sentinel);
// - synthesis: a thread makes all sps phases of kTxRows consecutive rows
//   from a window of span + 1 points in registers, one new point (an
//   8-byte load) a row for 2*L FMAs;
// - stores: the rows go into a skewed tile in shared memory (float4 a
//   quarter row) and the block writes the tile out in 16-byte pieces,
//   consecutive threads on consecutive pieces (8 bf16 or int16 samples a
//   piece, converted there, store_wave's rounding; a row at sps 8 is two
//   pieces in f32 and one in bf16 or int16, so every row starts on a
//   16-byte boundary). On the H100 this beat each thread storing its
//   rows' 32-byte sectors straight from registers at baseband by 2x, and
//   persistent blocks that prefetch the next tile's symbols lost to one
//   tile a block (PERF.md, section 6);
// - at passband the phase walks a row in 32-bit integers from the table of
//   up to 2048 phases (common.cuh, Nco), each sample mixed with the first
//   version's __fmul_rn / __fsub_rn; the unrolled rows are compiled apart
//   for a carrier from the table and one computed by cosf and sinf, so
//   that the table's code runs without the other's in between.
// Every sample is one fmaf chain a rail, bank[p][k] * z[m - k] for k from
// 0, as in the first version (whose zero bank entries past the last tap
// add nothing), so the outputs are its bit for bit and pushes of a stream
// equal one shot. The long route, for every other shape: the first
// version's body unchanged (pulse_tx_kernel, its bank staged from a device
// array, one sample a thread).
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
//   a symbol, the long core (pulse_rx_long_core): the same persistent walk
//   and buffers, the taps as a device array staged once a block as
//   common.cuh's four shifted copies (16-byte broadcasts), the filter
//   common.cuh's matched_long (4 decisions a thread, L a run-time value,
//   the buffers run-skewed); blocks of 128 threads, with 128, 64 or 32 of
//   them filtering, the most whose block fits 56 KB (four blocks an SM),
//   else 32 up to a block's shared memory. Past that, by the host's rule
//   (ops/txrx.py, pulse_long_route), the first version through its own C
//   entries: the
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

// K2's long route, the first version. Grid: one block per (channel, tile of
// kTile output symbols), flattened.
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

constexpr int kTxThreads = 128;  // K2 short route: threads a block
constexpr int kTxRows = 2;       // rows a thread
constexpr int kTxTile = kTxThreads * kTxRows;  // rows a block

// The 16 bits of a stored bf16 or int16 sample.
__device__ __forceinline__ unsigned short wave_bits(__nv_bfloat16 v) {
  return __bfloat16_as_ushort(v);
}

__device__ __forceinline__ unsigned short wave_bits(short v) {
  return static_cast<unsigned short>(v);
}

// Two samples in their storage form (common.cuh, store_wave), as the
// 32-bit word that holds them side by side.
template <typename TOut>
__device__ __forceinline__ unsigned wave_pair(float a, float b,
                                              float out_scale) {
  TOut lo, hi;
  modem::store_wave(&lo, a, out_scale);
  modem::store_wave(&hi, b, out_scale);
  return wave_bits(lo) | (static_cast<unsigned>(wave_bits(hi)) << 16);
}

// 16 bytes of samples in storage form at dst (16-byte aligned) from the
// floats x[0 .. 16 / sizeof(TOut)).
__device__ __forceinline__ void store_piece(float* dst, const float* x,
                                            float) {
  *reinterpret_cast<float4*>(dst) = make_float4(x[0], x[1], x[2], x[3]);
}

template <typename TOut>
__device__ __forceinline__ void store_piece(TOut* dst, const float* x,
                                            float out_scale) {
  *reinterpret_cast<uint4*>(dst) = make_uint4(
      wave_pair<TOut>(x[0], x[1], out_scale),
      wave_pair<TOut>(x[2], x[3], out_scale),
      wave_pair<TOut>(x[4], x[5], out_scale),
      wave_pair<TOut>(x[6], x[7], out_scale));
}

// The staged samples 0 .. n - 1 (skewed floats ys; n a whole number of
// 16-byte pieces) to dst[0 .. n - 1] in device memory (16-byte aligned) in
// storage form, all threads: consecutive threads on consecutive pieces.
template <typename TOut>
__device__ inline void store_rows(TOut* __restrict__ dst, const float* ys,
                                  int n, float out_scale) {
  constexpr int V = 16 / static_cast<int>(sizeof(TOut));
  for (int q = threadIdx.x; q < n / V; q += blockDim.x) {
    float x[V];
#pragma unroll
    for (int h = 0; h < V; h += 4) {
      const float4 f =
          *reinterpret_cast<const float4*>(ys + modem::skew(q * V + h));
      x[h] = f.x;
      x[h + 1] = f.y;
      x[h + 2] = f.z;
      x[h + 3] = f.w;
    }
    store_piece(dst + q * V, x, out_scale);
  }
}

// The carrier's cos and sin at phase k, as common.cuh's nco_cos_sin
// computes them, with the table (or not) known at compile time.
template <bool kTable>
__device__ __forceinline__ void tx_carrier(const modem::Nco& n, int k,
                                           const float* tc, const float* ts,
                                           float& c, float& s) {
  if (kTable) {
    c = tc[k];
    s = ts[k];
  } else {
    const float th = __fmul_rn(static_cast<float>(k), n.scale);
    c = cosf(th);
    s = sinf(th);
  }
}

// The point of an already loaded symbol s, as common.cuh's map_point gives
// it: zero for a negative symbol (the streaming sentinel, and -1 for no
// symbol) and past a table's end.
__device__ __forceinline__ void map_value(int s, const modem::Constellation& m,
                                          const float* slut, float& zi,
                                          float& zq) {
  zi = 0.f;
  zq = 0.f;
  if (m.lut != nullptr) {
    if (s >= 0 && s < m.n_points) {
      zi = slut[2 * s];
      zq = slut[2 * s + 1];
    }
  } else if (s >= 0) {
    modem::qam_point(s, m, zi, zq);
  }
}

// K2's short route, compiled for the flagship's (SPS, SPAN) = (8, 8).
// Grid: one block per (channel, tile of kTxTile waveform rows), flattened;
// row m is symbol m's sps samples w[m*sps + p].
template <bool kPassband, typename TOut, int SPS, int SPAN>
__global__ void __launch_bounds__(kTxThreads)
    pulse_tx_core(const int* __restrict__ syms, long long k_sym,
                  long long n_tiles, modem::Constellation map,
                  const __grid_constant__ modem::Taps taps, modem::Nco nco,
                  float out_scale, TOut* __restrict__ out_i,
                  TOut* __restrict__ out_q) {
  static_assert(SPS % 4 == 0 && SPS * sizeof(TOut) % 16 == 0,
                "rows staged and stored in 16-byte pieces");
  constexpr int kRails = kPassband ? 1 : 2;
  constexpr int L = SPAN * SPS + 1;
  constexpr int KP = SPAN + 1;  // points a row is made of
  // symbols a thread loads for its block's points: the tile's rows and the
  // span before them
  constexpr int kSyms = (kTxTile + SPAN + kTxThreads - 1) / kTxThreads;
  const int f_len = modem::skew_len(kTxTile * SPS);
  // the rows, skewed, a rail each [kRails][f_len]; the points of symbols
  // m0 - span .. m0 + kTxTile - 1; the table; the phase table
  extern __shared__ __align__(16) float smem[];
  float* ys = smem;
  float2* zp = reinterpret_cast<float2*>(ys + kRails * f_len);
  float* slut = reinterpret_cast<float*>(zp + ((kTxTile + SPAN + 1) & ~1));
  float* tc = slut + (map.lut != nullptr ? 2 * map.n_points : 0);
  float* ts = tc + nco.period;

  const int tid = threadIdx.x;
  const long long c = blockIdx.x / n_tiles;
  const long long m0 = (blockIdx.x % n_tiles) * kTxTile;
  const long long left = k_sym + SPAN - m0;
  const int rows = left < kTxTile ? static_cast<int>(left) : kTxTile;
  // the symbols of points tid, tid + kTxThreads, ..., loaded while the
  // tables are staged: -1 (no point) outside [0, K)
  const int* row = syms + c * k_sym;
  int sv[kSyms];
#pragma unroll
  for (int j = 0; j < kSyms; ++j) {
    const long long g = m0 - SPAN + tid + j * kTxThreads;
    sv[j] = tid + j * kTxThreads < rows + SPAN && g >= 0 && g < k_sym
                ? row[g]
                : -1;
  }
  __shared__ int ph_tile;  // the carrier phase of the tile's first sample
  if (map.lut != nullptr) modem::stage(slut, map.lut, 2 * map.n_points);
  if (kPassband && nco.table) modem::stage_nco(tc, ts, nco);
  if (kPassband && tid == 0) ph_tile = modem::nco_phase(nco, m0 * SPS);
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kSyms; ++j) {
    const int z = tid + j * kTxThreads;
    if (z < rows + SPAN) {
      float zi, zq;
      map_value(sv[j], map, slut, zi, zq);
      zp[z] = make_float2(zi, zq);
    }
  }
  __syncthreads();

  const long long base = c * (k_sym + SPAN) * SPS + m0 * SPS;
  float* const rail_i = ys;
  float* const rail_q = ys + (kPassband ? 0 : f_len);
  const int r_first = kTxRows * tid;
  // one copy of the unrolled rows for a carrier from its table and one for
  // a carrier computed by cosf and sinf (more than 2048 phases), so that
  // the table's code runs without the other's in between
  auto make_rows = [&](auto table) {
    constexpr bool kTable = decltype(table)::value;
    float2 w[KP];  // the points of rows rl - KP + 1 .. rl, oldest first
#pragma unroll
    for (int k = 0; k < KP - 1; ++k) w[k] = zp[r_first + k];
    int ph = kPassband ? modem::nco_skip(nco, ph_tile, r_first * SPS) : 0;
#pragma unroll
    for (int i = 0; i < kTxRows; ++i) {
      const int rl = r_first + i;
      if (rl >= rows) break;
      w[KP - 1] = zp[rl + KP - 1];
      float yi[SPS], yq[SPS];
#pragma unroll
      for (int p = 0; p < SPS; ++p) {
        float ai = 0.f, aq = 0.f;
#pragma unroll
        for (int k = 0; k < KP; ++k) {  // bank[p][k] = taps[k*SPS + p]
          if (k * SPS + p < L) {
            ai = fmaf(taps.v[k * SPS + p], w[KP - 1 - k].x, ai);
            aq = fmaf(taps.v[k * SPS + p], w[KP - 1 - k].y, aq);
          }
        }
        if (kPassband) {
          float cs, sn;
          tx_carrier<kTable>(nco, ph, tc, ts, cs, sn);
          ph = modem::nco_add(nco, ph, nco.step);
          ai = __fsub_rn(__fmul_rn(ai, cs), __fmul_rn(aq, sn));
        }
        yi[p] = ai;
        yq[p] = aq;
      }
#pragma unroll
      for (int h = 0; h < SPS; h += 4) {
        const int sk = modem::skew(rl * SPS + h);
        *reinterpret_cast<float4*>(rail_i + sk) =
            make_float4(yi[h], yi[h + 1], yi[h + 2], yi[h + 3]);
        if (!kPassband)
          *reinterpret_cast<float4*>(rail_q + sk) =
              make_float4(yq[h], yq[h + 1], yq[h + 2], yq[h + 3]);
      }
#pragma unroll
      for (int k = 0; k < KP - 1; ++k) w[k] = w[k + 1];
    }
  };
  if (r_first < rows) {
    if (!kPassband || nco.table)
      make_rows(std::true_type{});
    else
      make_rows(std::false_type{});
  }
  __syncthreads();
  store_rows(out_i + base, rail_i, rows * SPS, out_scale);
  if (!kPassband) store_rows(out_q + base, rail_q, rows * SPS, out_scale);
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

// ---- the long core (pulse_rx_long_core) ----
//
// The first version's persistent walk (a tile's tail kept as the next
// one's lookahead), with one set of filter rails, run-skewed (common.cuh,
// run_pos) for matched_long's kLongR decisions a thread, and the taps
// staged once a block as its shifted copies. Every mode lands in the
// rails by cp.async, the next tile's load issued once this one's filter is
// done, in the slots of the samples it holds (f32 in place, four bf16
// samples in the first 8 bytes of their 16-byte slot): baseband f32 and
// bf16 as they are, the filter reading bf16 slots as f32 (long_load4); at
// passband the real waveform, each slot then mixed down to both rails in
// place by the thread that reads it. So no staging buffer takes shared
// memory, every mode fits as many blocks (the warps that hide the
// filter's loads) an SM, and only passband adds a pass over the window
// (a pass converting bf16 left the core slower than the first version at
// sps 45 and 96, where a block has 32 filter threads). A tile is kRxCoreR
// decisions for each of its filter threads: the most of 128, 64 and 32
// whose block fits kRxCoreBudget, else 32 up to a block's shared memory.
// Every block has kRxCoreThreads threads, all of which load, mix down and
// copy: where a thread's samples are many (sps 45, 96), so are those
// passes.

constexpr int kRxCoreR = modem::kLongR;
constexpr int kRxCoreThreads = 128;          // a block's threads
constexpr size_t kRxCoreBudget = 56 * 1024;  // four blocks an SM
constexpr int kRxCoreBlocks = 8;             // persistent blocks an SM, at most

// The core's shared memory for nt filter threads: the two run-skewed
// filter rails of a tile of kRxCoreR * nt decisions and its lookahead, the
// taps' copies and `side` floats of tables.
inline size_t rx_core_smem(int nt, int sps, int span, int side) {
  const int win = (kRxCoreR * nt + span) * sps;
  return sizeof(float) *
         (2 * static_cast<size_t>(modem::run_len(win + 4, kRxCoreR * sps)) +
          4 * modem::long_tap_stride(span * sps + 1) + side);
}

// The core's filter threads for a shape, 0 where none fits.
inline int rx_core_threads(int sps, int span, int side) {
  for (int nt = 128; nt >= 32; nt /= 2)
    if (rx_core_smem(nt, sps, span, side) <= kRxCoreBudget) return nt;
  return rx_core_smem(32, sps, span, side) <= modem::kMaxSmem ? 32 : 0;
}

// Copy elements 0 .. n - 1 of src to logical positions pos0 .. pos0 + n - 1
// of the run-skewed dst, all threads (load_span's copy for the core's
// buffers; its 16-byte pieces never cross a run, whose length is a multiple
// of 4).
__device__ inline void load_run(float* dst, const float* __restrict__ src,
                                int pos0, int n, int n_valid, int run) {
  const int nt = blockDim.x;
  int a = n, b = n;  // the pieces copy elements a .. b - 1
  if (((reinterpret_cast<uintptr_t>(src) |
        static_cast<uintptr_t>(pos0) * sizeof(float)) & 15) == 0) {
    const int p1 = n_valid / 4;
    if (p1 > 0) {
      a = 0;
      b = 4 * p1;
    }
    modem::RunWalk w(pos0 + 4 * threadIdx.x, 4 * nt, run);
    for (int k = threadIdx.x; k < p1; k += nt, w.next())
      modem::cp_async16(dst + w.pos, src + 4 * k);
  }
  auto one = [&](int first, int end) {
    modem::RunWalk w(pos0 + first + threadIdx.x, nt, run);
    for (int e = first + threadIdx.x; e < end; e += nt, w.next()) {
      if (e < n_valid)
        modem::cp_async4(dst + w.pos, src + e);
      else
        dst[w.pos] = 0.f;
    }
  };
  one(0, a);
  one(b, n);
}

// load_run for a bf16 rail (its bits): sample pos0 + e into the first 8
// bytes of its group of four's 16-byte slot, at 2 bytes an index in the
// group; four samples by one 8-byte cp.async where src is 8-byte aligned,
// the rest (zero past n_valid) one at a time.
__device__ inline void load_run(float* dst, const unsigned short* __restrict__ src,
                                int pos0, int n, int n_valid, int run) {
  const int nt = blockDim.x;
  int a = n, b = n;  // the pieces copy elements a .. b - 1
  if (((reinterpret_cast<uintptr_t>(src) |
        static_cast<uintptr_t>(pos0) * sizeof(unsigned short)) & 7) == 0) {
    const int p1 = n_valid / 4;
    if (p1 > 0) {
      a = 0;
      b = 4 * p1;
    }
    modem::RunWalk w(pos0 + 4 * threadIdx.x, 4 * nt, run);
    for (int k = threadIdx.x; k < p1; k += nt, w.next())
      modem::cp_async8(dst + w.pos, src + 4 * k);
  }
  auto one = [&](int first, int end) {
    for (int e = first + threadIdx.x; e < end; e += nt) {
      const int p = pos0 + e;
      reinterpret_cast<unsigned short*>(dst + modem::run_pos(p & ~3, run))
          [p & 3] = e < n_valid ? src[e] : static_cast<unsigned short>(0);
    }
  };
  one(0, a);
  one(b, n);
}

// Logical positions 0 .. halo - 1 of the run-skewed rail `to` from the same
// positions past `off` floats of `from` (the tile's tail: the positions
// body .. body + halo - 1 lie off = body + 4*nt floats on, body a whole
// number of runs), in 16-byte pieces and the last few alone, never
// touching a position past halo.
__device__ inline void copy_head(float* to, const float* from, int off,
                                 int halo, int run) {
  const int nt = blockDim.x;
  const int whole = halo >> 2;
  modem::RunWalk w(4 * threadIdx.x, 4 * nt, run);
  for (int k = threadIdx.x; k < whole; k += nt, w.next())
    *reinterpret_cast<float4*>(to + w.pos) =
        *reinterpret_cast<const float4*>(from + off + w.pos);
  for (int e = 4 * whole + threadIdx.x; e < halo; e += nt) {
    const int p = modem::run_pos(e, run);
    to[p] = from[off + p];
  }
}

// Persistent: block b takes items [b*n/G, (b+1)*n/G) of the n = C * n_tiles
// (channel, tile of `tile` decided symbols: kRxCoreR a filter thread) items
// in channel-major order.
template <bool kSoft, bool kPassband, typename TRaw>
__global__ void __launch_bounds__(128)
    pulse_rx_long_core(const TRaw* __restrict__ wi,
                       const TRaw* __restrict__ wq, long long n_wave,
                       long long n_sym, long long n_tiles, long long n_items,
                       int tile, int sps, int span,
                       const float* __restrict__ taps,
                       modem::Constellation map, modem::Nco nco,
                       int* __restrict__ out_sym, float* __restrict__ out_i,
                       float* __restrict__ out_q) {
  constexpr int R = kRxCoreR;
  constexpr bool kDirect = !kPassband && sizeof(TRaw) == sizeof(float);
  constexpr bool kBf16 = !kPassband && !kDirect;  // the filter reads bf16
  constexpr int kRails = kPassband ? 1 : 2;  // rails read from device memory
  const int n_taps = span * sps + 1;
  const int run = R * sps;
  const int halo = span * sps;  // lookahead samples of a tile
  const int body = tile * sps;  // the tile's own samples, whole runs
  const int win = body + halo;  // samples its filter reads
  const int f_len = modem::run_len(win + 4, run);
  const int nt = blockDim.x;
  const int off = body + 4 * (tile / R);  // the tail's distance, in floats
  // a bf16 or passband rail's lookahead is kept only where it ends on a
  // slot (copy_head copies f32; a slot holds bf16 samples, or raw and
  // mixed ones at once, nowhere)
  const bool reuse = halo <= body && (kDirect || halo % 4 == 0);

  // the filter rails [2][f_len] f32, run-skewed; the taps' copies; the
  // table; the phase table
  extern __shared__ __align__(16) float smem[];
  float* yi = smem;
  float* yq = smem + f_len;
  float* taps4 = smem + 2 * f_len;
  float* slut = taps4 + 4 * modem::long_tap_stride(n_taps);
  float* tc = slut + (map.lut != nullptr ? 2 * map.n_points : 0);
  float* ts = tc + nco.period;

  long long lo, hi;
  modem::block_items(n_items, lo, hi);
  modem::stage_long_taps(taps4, taps, n_taps);
  if (map.lut != nullptr) modem::stage(slut, map.lut, 2 * map.n_points);
  if (kPassband && nco.table) modem::stage_nco(tc, ts, nco);

  // Bring item `it`'s samples in: the whole window, or past the lookahead
  // the tile before leaves (cont); passband's one rail into yq.
  auto issue = [&](long long it, bool cont) {
    const long long c = it / n_tiles;
    const long long s0 = (it % n_tiles) * tile * sps;
    const int pos0 = cont ? halo : 0;
    const int n = win - pos0;
    const long long avail = n_wave - (s0 + pos0);
    const int n_valid =
        avail <= 0 ? 0 : avail < n ? static_cast<int>(avail) : n;
    for (int rail = 0; rail < kRails; ++rail) {
      const TRaw* src = (rail ? wq : wi) + c * n_wave + s0 + pos0;
      load_run(rail || kPassband ? yq : yi, src, pos0, n, n_valid, run);
    }
    modem::cp_async_commit();
  };

  if (lo < hi) issue(lo, false);
  for (long long it = lo; it < hi; ++it) {
    const bool cont = reuse && it != lo && it % n_tiles != 0;
    const bool cont_next = reuse && it + 1 < hi && (it + 1) % n_tiles != 0;
    modem::cp_async_wait<0>();
    __syncthreads();

    const long long c = it / n_tiles;
    const long long m0 = (it % n_tiles) * tile;
    if (kPassband) {
      // each raw slot -> f32 by product detection, in place
      const int q0 = (cont ? halo : 0) >> 2;
      int ph = modem::nco_skip(nco, modem::nco_phase(nco, m0 * sps),
                               4 * (q0 + static_cast<int>(threadIdx.x)));
      const int ph_stride = modem::nco_skip(nco, 0, 4 * nt);
      modem::RunWalk w(4 * (q0 + threadIdx.x), 4 * nt, run);
      for (int q = q0 + threadIdx.x; 4 * q < win; q += nt, w.next()) {
        float vi[4], vq[4];
        raw4(reinterpret_cast<const TRaw*>(yq + w.pos), vi);
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
        ph = modem::nco_add(nco, ph, ph_stride);
        if (4 * q + 4 <= win) {
          *reinterpret_cast<float4*>(yi + w.pos) =
              make_float4(vi[0], vi[1], vi[2], vi[3]);
          *reinterpret_cast<float4*>(yq + w.pos) =
              make_float4(vq[0], vq[1], vq[2], vq[3]);
        } else {
          for (int e = 0; 4 * q + e < win; ++e) {
            yi[w.pos + e] = vi[e];
            yq[w.pos + e] = vq[e];
          }
        }
      }
      __syncthreads();
    }

    // the matched filter: decisions m0 + r0 .. m0 + r0 + R - 1
    const long long left = n_sym - m0;
    const int n_out = left < tile ? static_cast<int>(left) : tile;
    const int r0 = R * static_cast<int>(threadIdx.x);
    if (r0 < n_out) {  // the tile's filter threads, R decisions each
      float acc[2][R] = {};
      const float* const rails[2] = {yi, yq};
      modem::matched_long<R, kBf16>(rails, r0, sps, span, taps4, acc);
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
    __syncthreads();  // every read of the rails is done
    if (cont_next) {  // the next tile's lookahead: this tail
      copy_head(yi, yi, off, halo, run);
      copy_head(yq, yq, off, halo, run);
      __syncthreads();
    }
    if (it + 1 < hi) issue(it + 1, cont_next);
  }
}

template <bool kSoft, bool kPassband, typename TRaw>
int launch_rx_core(const void* wi, const void* wq, long long n_ch,
                   long long n_wave, long long n_sym, const float* taps,
                   int sps, int span, const modem::Constellation& map,
                   const modem::Nco& nco, int* out_sym, float* out_i,
                   float* out_q, void* stream) {
  auto kernel = pulse_rx_long_core<kSoft, kPassband, TRaw>;
  const int side = modem::side_floats(map, nco);
  const int nt = rx_core_threads(sps, span, side);
  if (nt == 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = rx_core_smem(nt, sps, span, side);
  const int tile = kRxCoreR * nt;
  const long long n_tiles = (n_sym + tile - 1) / tile;
  const long long n_items = n_ch * n_tiles;
  unsigned grid = 0;
  const cudaError_t err = modem::persistent_grid(
      kernel, kRxCoreThreads, smem, kRxCoreBlocks, n_items, grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kRxCoreThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const TRaw*>(wi), static_cast<const TRaw*>(wq), n_wave,
      n_sym, n_tiles, n_items, tile, sps, span, taps, map, nco, out_sym, out_i,
      out_q);
  return static_cast<int>(cudaGetLastError());
}

// The long route: the first version's kernel.
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

// The short route.
template <bool kPassband, typename TOut, int SPS, int SPAN>
int launch_tx_core(const int* syms, long long n_ch, long long k_sym,
                   const modem::Constellation& map, const modem::Taps& taps,
                   const modem::Nco& nco, float out_scale, void* out_i,
                   void* out_q, void* stream) {
  auto kernel = pulse_tx_core<kPassband, TOut, SPS, SPAN>;
  constexpr int kRails = kPassband ? 1 : 2;
  const long long n_tiles = (k_sym + SPAN + kTxTile - 1) / kTxTile;
  const size_t smem =
      kRails * modem::skew_len(kTxTile * SPS) * sizeof(float) +
      ((kTxTile + SPAN + 1) & ~1) * sizeof(float2) +
      modem::side_floats(map, nco) * sizeof(float);
  cudaError_t err = modem::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<modem::grid_blocks(n_ch, n_tiles), kTxThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      syms, k_sym, n_tiles, map, taps, nco, out_scale,
      static_cast<TOut*>(out_i), static_cast<TOut*>(out_q));
  return static_cast<int>(cudaGetLastError());
}

// The TX route for a shape: the short route for the flagship's sps 8,
// span 8 with taps a host modem::Taps (its rows go out in 16-byte pieces:
// the outputs must be 16-byte aligned); every other shape, and taps null,
// the long route, which reads taps_dev.
template <bool kPassband, typename TOut>
int launch_tx_shape(const int* syms, long long n_ch, long long k_sym,
                    const modem::Constellation& map, const void* taps,
                    const float* taps_dev, int n_taps, int sps, int span,
                    const modem::Nco& nco, float out_scale, void* out_i,
                    void* out_q, void* stream) {
  if (taps != nullptr && sps == 8 && span == 8) {
    if (((reinterpret_cast<uintptr_t>(out_i) |
          reinterpret_cast<uintptr_t>(out_q)) & 15) != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    return launch_tx_core<kPassband, TOut, 8, 8>(
        syms, n_ch, k_sym, map, *static_cast<const modem::Taps*>(taps), nco,
        out_scale, out_i, out_q, stream);
  }
  return launch_tx<kPassband, TOut>(syms, n_ch, k_sym, map, taps_dev, n_taps,
                                    sps, span, nco, out_scale, out_i, out_q,
                                    stream);
}

// The TX instantiation for a storage kind (common.cuh, WaveKind).
template <bool kPassband, typename... Args>
int launch_tx_kind(int out_kind, Args... args) {
  switch (out_kind) {
    case modem::kF32: return launch_tx_shape<kPassband, float>(args...);
    case modem::kBf16:
      return launch_tx_shape<kPassband, __nv_bfloat16>(args...);
    case modem::kI16: return launch_tx_shape<kPassband, short>(args...);
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
  unsigned grid = 0;
  const cudaError_t err = modem::persistent_grid(
      kernel, nt, smem, kDirect ? kRxBlocksDirect : kRxBlocksStaged, n_items,
      grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, nt, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const TRaw*>(wi), static_cast<const TRaw*>(wq), n_wave,
      n_sym, n_tiles, n_items, tile, sps, span, taps, map, nco, out_sym, out_i,
      out_q);
  return static_cast<int>(cudaGetLastError());
}

// The RX instantiation for a route, a shape, a carrier mode and an input
// type: taps is a host modem::Taps (the short route), or null for the long
// route, which reads taps_dev: the long core, or with `first` the first
// version.
template <bool kSoft, bool kPassband, typename TRaw>
int launch_rx_shape(const void* wi, const void* wq, long long n_ch,
                    long long n_wave, long long n_sym, const void* taps,
                    const float* taps_dev, bool first, int n_taps, int sps,
                    int span, const modem::Constellation& map,
                    const modem::Nco& nco, int* out_sym, float* out_i,
                    float* out_q, void* stream) {
  // the matched filter's sample window is exactly the tile's halo
  if (n_taps != span * sps + 1 || sps < 1 || span < 0 ||
      (taps == nullptr ? taps_dev == nullptr
                       : n_taps > modem::kMaxTaps || sps > modem::kMaxSps))
    return static_cast<int>(cudaErrorInvalidValue);
  if (taps == nullptr && !first)
    return launch_rx_core<kSoft, kPassband, TRaw>(
        wi, wq, n_ch, n_wave, n_sym, taps_dev, sps, span, map, nco, out_sym,
        out_i, out_q, stream);
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

// modem_rx_hard's and modem_rx_hard_first's body.
int rx_hard_entry(const void* wi, const void* wq, int in_bf16, long long n_ch,
                  long long n_wave, long long n_sym, const void* taps,
                  const float* taps_dev, bool first, int n_taps, int sps,
                  int span, const float* lut, int n_points, int cshift,
                  float ms, float a, float c, float s, int hz, int sr,
                  long long sym_offset, float scale, int* out_sym,
                  void* stream) {
  modem::Nco nco;
  if (!modem::make_nco(hz, sr, sps, sym_offset, scale, nco))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_rx_mode<false>(
      sr != 0, in_bf16, wi, wq, n_ch, n_wave, n_sym, taps, taps_dev, first,
      n_taps, sps, span, modem::make_map(lut, n_points, cshift, ms, a, c, s),
      nco, out_sym, static_cast<float*>(nullptr),
      static_cast<float*>(nullptr), stream);
}

// modem_rx_soft's and modem_rx_soft_first's body.
int rx_soft_entry(const void* wi, const void* wq, int in_bf16, long long n_ch,
                  long long n_wave, long long n_sym, const void* taps,
                  const float* taps_dev, bool first, int n_taps, int sps,
                  int span, int hz, int sr, long long sym_offset, float scale,
                  float* out_i, float* out_q, void* stream) {
  modem::Nco nco;
  if (!modem::make_nco(hz, sr, sps, sym_offset, scale, nco))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_rx_mode<true>(
      sr != 0, in_bf16, wi, wq, n_ch, n_wave, n_sym, taps, taps_dev, first,
      n_taps, sps, span, modem::make_map(nullptr, 0, 0, 0.f, 1.f, 1.f, 0.f),
      nco, static_cast<int*>(nullptr), out_i, out_q, stream);
}

}  // namespace

extern "C" {

// syms [n_ch, k_sym] int32 -> out_i, out_q [n_ch, (k_sym+span)*sps]
// (out_q unused at passband) of out_kind (0 f32, 1 bf16, 2 int16 with
// out_scale). The map: lut [n_points, 2] f32, or with lut null square QAM
// (cshift, ms, a, c, s); the span*sps+1 taps: taps_dev the device array,
// and taps a host pointer to them in a modem::Taps (n_taps <= 256,
// sps <= 64) or null. The route: at sps 8, span 8 with taps given, the
// short route (the taps by value); otherwise the long route, from
// taps_dev. The carrier: sr == 0 baseband, else hz, sr, sym_offset and
// scale = f32(2*pi/sr). Returns cudaGetLastError(), or
// cudaErrorInvalidValue for arguments the kernels do not take.
int modem_tx(const int* syms, long long n_ch, long long k_sym,
             const float* lut, int n_points, int cshift, float ms, float a,
             float c, float s, const void* taps, const float* taps_dev,
             int n_taps, int sps, int span, int hz, int sr,
             long long sym_offset, float scale, int out_kind,
             float out_scale, void* out_i, void* out_q, void* stream) {
  if (n_taps != span * sps + 1 || sps < 1 || span < 0 ||
      taps_dev == nullptr ||
      (taps != nullptr &&
       (n_taps > modem::kMaxTaps || sps > modem::kMaxSps)))
    return static_cast<int>(cudaErrorInvalidValue);
  const modem::Constellation map =
      modem::make_map(lut, n_points, cshift, ms, a, c, s);
  modem::Nco nco;
  if (!modem::make_nco(hz, sr, sps, sym_offset, scale, nco))
    return static_cast<int>(cudaErrorInvalidValue);
  if (sr != 0)
    return launch_tx_kind<true>(out_kind, syms, n_ch, k_sym, map, taps,
                                taps_dev, n_taps, sps, span, nco, out_scale,
                                out_i, out_q, stream);
  return launch_tx_kind<false>(out_kind, syms, n_ch, k_sym, map, taps,
                               taps_dev, n_taps, sps, span, nco, out_scale,
                               out_i, out_q, stream);
}

// wi, wq [n_ch, n_wave] (f32, or bf16 with in_bf16; wq unused at passband)
// -> out_sym [n_ch, n_sym] int32, samples past n_wave read as zero; the map
// and carrier as modem_tx's; the span*sps+1 taps: taps a host pointer to
// them in a modem::Taps, passed to the kernel by value (the short route:
// n_taps <= 256, sps <= 64), or taps null and taps_dev the device array
// (the long route's core, pulse_rx_long_core: any chain whose block of 32
// threads fits shared memory; the host's rule, ops.txrx.pulse_long_route,
// sends the others to modem_rx_hard_first).
int modem_rx_hard(const void* wi, const void* wq, int in_bf16, long long n_ch,
                  long long n_wave, long long n_sym, const void* taps,
                  const float* taps_dev, int n_taps, int sps, int span,
                  const float* lut, int n_points, int cshift, float ms,
                  float a, float c, float s, int hz, int sr,
                  long long sym_offset, float scale, int* out_sym,
                  void* stream) {
  return rx_hard_entry(wi, wq, in_bf16, n_ch, n_wave, n_sym, taps, taps_dev,
                       false, n_taps, sps, span, lut, n_points, cshift, ms, a,
                       c, s, hz, sr, sym_offset, scale, out_sym, stream);
}

// As modem_rx_hard, to the decision-point I/Q out_i, out_q [n_ch, n_sym].
int modem_rx_soft(const void* wi, const void* wq, int in_bf16, long long n_ch,
                  long long n_wave, long long n_sym, const void* taps,
                  const float* taps_dev, int n_taps, int sps, int span,
                  int hz, int sr, long long sym_offset, float scale,
                  float* out_i, float* out_q, void* stream) {
  return rx_soft_entry(wi, wq, in_bf16, n_ch, n_wave, n_sym, taps, taps_dev,
                       false, n_taps, sps, span, hz, sr, sym_offset, scale,
                       out_i, out_q, stream);
}

// The long route's first version (pulse_rx_kernel, one decision a thread)
// at any shape whose tile fits, the taps from the device: the route for
// the chains past the core's shared memory, and forced here so that the
// two can be compared at any shape. Arguments as modem_rx_hard's and
// modem_rx_soft's without the host taps.
int modem_rx_hard_first(const void* wi, const void* wq, int in_bf16,
                        long long n_ch, long long n_wave, long long n_sym,
                        const float* taps_dev, int n_taps, int sps, int span,
                        const float* lut, int n_points, int cshift, float ms,
                        float a, float c, float s, int hz, int sr,
                        long long sym_offset, float scale, int* out_sym,
                        void* stream) {
  return rx_hard_entry(wi, wq, in_bf16, n_ch, n_wave, n_sym, nullptr,
                       taps_dev, true, n_taps, sps, span, lut, n_points,
                       cshift, ms, a, c, s, hz, sr, sym_offset, scale,
                       out_sym, stream);
}

int modem_rx_soft_first(const void* wi, const void* wq, int in_bf16,
                        long long n_ch, long long n_wave, long long n_sym,
                        const float* taps_dev, int n_taps, int sps, int span,
                        int hz, int sr, long long sym_offset, float scale,
                        float* out_i, float* out_q, void* stream) {
  return rx_soft_entry(wi, wq, in_bf16, n_ch, n_wave, n_sym, nullptr,
                       taps_dev, true, n_taps, sps, span, hz, sr, sym_offset,
                       scale, out_i, out_q, stream);
}

const char* modem_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The runtime queries every C entry has made since the library was loaded
// (common.cuh's host_queries): they stop once each kernel's shape is kept.
long long modem_host_queries() { return modem::host_queries.load(); }

}  // extern "C"
