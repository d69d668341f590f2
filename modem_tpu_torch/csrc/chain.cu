// Fused loopback of the pulse-shaped chain.
//
// Replaces modem_tpu/ops/pallas_chain.py::_chain_kernel (K1): int32 symbols
// -> constellation map (a table of up to 64 points, or algebraic square
// QAM; common.cuh) -> polyphase RRC waveform -> [passband: up-mix with the
// exact integer NCO, x = wi*cos - wq*sin] -> [AWGN] -> [passband: product
// detection with 2x gain, yi = 2x*cos, yq = -2x*sin] -> polyphase matched
// filter at the decision instants -> slice -> int32 decisions. It is the TX
// kernel followed by the RX kernel of txrx.cu with the waveform kept in
// shared memory: a block deciding cs symbols (one tile, cs = chunk_sym), in
// passes of up to 256, synthesizes the (256 + span) * sps samples a pass's
// matched filter reads, from the symbols it maps itself, kp - 1 = span
// before and span after the pass (zero I/Q outside [0, K) and for negative
// symbols, the streaming sentinel).
//
// Noise. The JAX kernel's interpret path draws gauss_pair (common.cuh) per
// tile of 128 channels by cs symbols: key seed + (c / 128) * 1000003 +
// (m0 / cs) * 7919 (uint32 wrap-around), one draw per phase p (salt p), the
// counter r * 128 + c mod 128 for waveform row r of the tile. The rows of
// the span-symbol lookahead take the tile's own draw, so the same sample
// is noised differently in the two tiles that read it, as there. Baseband
// adds sigma * (g1, g2) to (wi, wq); passband sigma * g1 to x. So the card
// draws the same Gaussians as the CPU tests hold the plain version to.
//
// What bounds it on this card: operations. Device memory carries only 4 B
// in and 4 B out a symbol, so the waveform never costs bandwidth; the work
// is 2*L FMAs a symbol to synthesize it (L = span*sps + 1 taps over sps
// phases of kp = span + 1 points) and 2*L to filter it, about 260 at the
// flagship's sps 8, span 8, all at the CUDA cores' f32 rate. Tensor cores
// are no lever: every decision keeps one f32 fmaf chain a rail with the
// taps in order from j = 0 (TF32 keeps 10 mantissa bits), so it equals the
// plain version's and streams equal one shot. The first version issued
// about 1.5 shared-memory loads an FMA (taps, points and samples each
// from shared memory at every use, a run-time t / sps a sample, a branch
// a tap), and those loads were its limit. The design:
// - the taps are a __grid_constant__ kernel parameter (common.cuh, Taps):
//   with the loops unrolled at compile time every tap, and every entry of
//   the polyphase bank, reaches its FFMA as a constant or uniform operand,
//   with no shared-memory load;
//   instantiated for the flagship's sps 8, span 8 (no division, no branch)
//   and once generically;
// - synthesis: a thread makes all sps phases of consecutive waveform rows
//   from a window of kp symbol points held in registers, one new point (an
//   8-byte load) a row for 2*L FMAs, and stores the row in 16-byte pieces;
// - the register-blocked matched filter (common.cuh, matched_fixed): a
//   thread decides 4 consecutive symbols from one walk of their samples in
//   16-byte loads, the waveform lying skewed in shared memory so that no
//   two threads of a quarter warp meet in a bank;
// - blocks of 64 threads, one tile each (256 decisions a pass; a longer
//   tile takes passes of 256), about 22 KB of shared memory, so ten blocks
//   share an SM and the flagship's 4096 tiles fill the 132 SMs in about
//   three waves;
// - the carrier phase is walked a sample in 32-bit integers, from a table
//   of up to 2048 phases (common.cuh, Nco).
// The long route: a chain past the parameter's 256 taps or 64 samples a
// symbol (the JAX kernel takes any; the reference CLI's 220 baud at 10 kHz
// is sps 45, 361 taps at span 8) gets its taps as a device array, and runs
// on the long core (pulse_chain_long_core):
// - persistent blocks of 64 threads walk (channel, tile) items and stage
//   the taps once a block, as common.cuh's four shifted copies, so that
//   every read of four taps is one 16-byte broadcast;
// - passes of up to 256 decisions, halved while a block is past 56 KB (not
//   below 16) so that four blocks share an SM: a pass's span rows of
//   lookahead are made again by the next one, 12.5% more synthesis at sps
//   8, span 32 against the first version's 50%;
// - synthesis in items of 4 rows by 4 phases (the phases fastest across
//   the threads, so that they share points and taps): a window of 4 points
//   in registers renamed by an unrolled loop, one point and one broadcast
//   of the 4 phases' taps a tap for 32 FMAs;
// - the filter, common.cuh's matched_long: 4 consecutive decisions a
//   thread from one walk of their samples in 16-byte loads, run-skewed.
// Every mode is kept, and every sample and decision is the first
// version's fmaf chain in its order, so decisions are bit for bit the
// same. The first version (pulse_chain_kernel's generic long instantiation:
// one decision a thread, passes of 64, a block a tile) runs where the
// core's smallest pass does not fit a block, by the host's rule
// (ops/txrx.py, pulse_long_route), through its own C entry.
// Noise adds two hashes, a logf, a sqrtf, a cosf and a sinf a sample, and a
// carrier of more than 2048 phases a cosf and a sinf: those modes are bound
// by those operations. The span-symbol overlap between neighbouring tiles
// is synthesized twice (3% extra work), as each tile's draw needs it.

#include "common.cuh"

namespace {

constexpr int kChainThreads = 64;  // the block's threads
constexpr int kChainR = 4;         // decisions a thread (short route)

// Decisions a thread: the long route takes one, a quarter of the short
// route's pass, so that its longer tiles still fit shared memory.
template <bool kLong>
__host__ __device__ constexpr int chain_r() {
  return kLong ? 1 : kChainR;
}

// One waveform sample's [up-mix, AWGN, product detection] in place.
template <bool kPassband, bool kNoisy>
__device__ __forceinline__ void finish_sample(float& ai, float& aq, int row,
                                              int p, unsigned key,
                                              unsigned lane, float sigma,
                                              const modem::Nco& nco, int& ph,
                                              const float* tc,
                                              const float* ts) {
  float g1 = 0.f, g2 = 0.f;
  if (kNoisy)
    modem::gauss_pair(static_cast<unsigned>(row) * modem::kLane + lane,
                      key + static_cast<unsigned>(p) * 0x9E3779B9u, g1, g2);
  if (kPassband) {
    float cs, sn;
    modem::nco_cos_sin(nco, ph, tc, ts, cs, sn);
    ph = modem::nco_add(nco, ph, nco.step);
    float x = __fsub_rn(__fmul_rn(ai, cs), __fmul_rn(aq, sn));
    if (kNoisy) x = __fadd_rn(x, __fmul_rn(sigma, g1));
    const float x2 = 2.f * x;
    ai = __fmul_rn(x2, cs);
    aq = __fmul_rn(-x2, sn);
  } else if (kNoisy) {
    // two roundings, as the plain version: no FMA contraction here
    ai = __fadd_rn(ai, __fmul_rn(sigma, g1));
    aq = __fadd_rn(aq, __fmul_rn(sigma, g2));
  }
}

// Grid: one block per (channel, tile of cs symbols), flattened. SPS > 0 is
// the instantiation for (SPS, SPAN); 0 the generic one. kLong: the long
// route (common.cuh, TapsPtr), always generic.
template <bool kPassband, bool kNoisy, int SPS, int SPAN, bool kLong>
__global__ void __launch_bounds__(kChainThreads, 8)
    pulse_chain_kernel(const int* __restrict__ syms, long long k_sym,
                       long long n_tiles, int cs, modem::Constellation map,
                       const __grid_constant__ modem::TapsArg<kLong> taps,
                       int sps_rt, int span_rt, modem::Nco nco, float sigma,
                       unsigned seed, int* __restrict__ out) {
  constexpr bool kFixed = SPS > 0;
  static_assert(!(kFixed && kLong), "the long route is generic");
  constexpr int R = chain_r<kLong>();
  constexpr int kSub = kChainThreads * R;  // decisions a pass
  const int sps = kFixed ? SPS : sps_rt;
  const int span = kFixed ? SPAN : span_rt;
  const int n_taps = span * sps + 1;
  const int kp = span + 1;  // points a waveform row is made of
  const int f_len = modem::skew_len((kSub + span) * sps + 4);
  const int z_len = kSub + span + kp - 1;
  extern __shared__ __align__(16) float smem[];
  float* wi = smem;  // the pass's waveform rows, skewed
  float* wq = wi + f_len;
  float2* zp = reinterpret_cast<float2*>(wq + f_len);  // their symbol points
  float* slut = reinterpret_cast<float*>(zp + ((z_len + 1) & ~1));
  float* tc = slut + (map.lut != nullptr ? 2 * map.n_points : 0);
  float* ts = tc + nco.period;
  float* staps = tc + (kPassband && nco.table ? 2 * nco.period : 0);

  const int tid = threadIdx.x;
  const long long c = blockIdx.x / n_tiles;
  const long long tile = blockIdx.x % n_tiles;
  const long long m0 = tile * cs;
  if (map.lut != nullptr) modem::stage(slut, map.lut, 2 * map.n_points);
  if (kPassband && nco.table) modem::stage_nco(tc, ts, nco);
  if constexpr (kLong) modem::stage(staps, taps.p, n_taps);
  const auto& tv = modem::tap_view(taps, staps);
  const unsigned key = seed +
                       static_cast<unsigned>(c / modem::kLane) * 1000003u +
                       static_cast<unsigned>(tile) * 7919u;
  const unsigned lane = static_cast<unsigned>(c % modem::kLane);
  const int ph_tile = kPassband ? modem::nco_phase(nco, m0 * sps) : 0;
  const int* row = syms + c * k_sym;

  for (int c0 = 0; c0 < cs; c0 += kSub) {
    const long long left = k_sym - m0 - c0;
    if (left <= 0) break;
    int n_out = cs - c0 < kSub ? cs - c0 : kSub;
    if (left < n_out) n_out = static_cast<int>(left);
    const int rows = n_out + span;  // waveform rows the filter reads
    __syncthreads();  // the tables, or the last pass's filter, are done
    // points of symbols m0 + c0 - (kp-1) .. (zero outside [0, K) and for
    // the sentinel)
    for (int z = tid; z < rows + kp - 1; z += kChainThreads) {
      float zi, zq;
      modem::map_point(row, m0 + c0 - (kp - 1) + z, k_sym, map, slut, zi, zq);
      zp[z] = make_float2(zi, zq);
    }
    __syncthreads();

    // synthesis: waveform row rl (tile row c0 + rl), phase p, into sample
    // rl*sps + p; this thread's rows are one run, the first `rem` threads
    // taking one more
    const int q = rows / kChainThreads, rem = rows % kChainThreads;
    const int r_first =
        tid < rem ? tid * (q + 1) : rem * (q + 1) + (tid - rem) * q;
    const int r_count = tid < rem ? q + 1 : q;
    int ph =
        kPassband ? modem::nco_skip(nco, ph_tile, (c0 + r_first) * sps) : 0;
    if constexpr (kFixed) {
      static_assert(SPS > 0 && SPS % 4 == 0 && 32 % (SPS > 0 ? SPS : 1) == 0,
                    "rows in 16-byte pieces");
      constexpr int L = SPAN * SPS + 1;
      constexpr int KP = SPAN + 1;
      float2 w[KP];  // the points of rows rl - KP + 1 .. rl, oldest first
#pragma unroll
      for (int k = 0; k < KP - 1; ++k) w[k] = zp[r_first + k];
      for (int i = 0; i < r_count; ++i) {
        const int rl = r_first + i;
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
          finish_sample<kPassband, kNoisy>(ai, aq, c0 + rl, p, key, lane,
                                           sigma, nco, ph, tc, ts);
          yi[p] = ai;
          yq[p] = aq;
        }
#pragma unroll
        for (int h = 0; h < SPS; h += 4) {
          const int sk = modem::skew(rl * SPS + h);
          *reinterpret_cast<float4*>(wi + sk) =
              make_float4(yi[h], yi[h + 1], yi[h + 2], yi[h + 3]);
          *reinterpret_cast<float4*>(wq + sk) =
              make_float4(yq[h], yq[h + 1], yq[h + 2], yq[h + 3]);
        }
#pragma unroll
        for (int k = 0; k < KP - 1; ++k) w[k] = w[k + 1];
      }
    } else {
      for (int i = 0; i < r_count; ++i) {
        const int rl = r_first + i;
        for (int p = 0; p < sps; ++p) {
          float ai = 0.f, aq = 0.f;
          for (int k = 0; k < kp && k * sps + p < n_taps; ++k) {
            const float t = modem::tap(tv, k * sps + p);
            const float2 z = zp[rl + kp - 1 - k];
            ai = fmaf(t, z.x, ai);
            aq = fmaf(t, z.y, aq);
          }
          finish_sample<kPassband, kNoisy>(ai, aq, c0 + rl, p, key, lane,
                                           sigma, nco, ph, tc, ts);
          wi[modem::skew(rl * sps + p)] = ai;
          wq[modem::skew(rl * sps + p)] = aq;
        }
      }
    }
    __syncthreads();

    // the matched filter: decisions m0 + c0 + r0 .. + kChainR - 1
    const int r0 = R * tid;
    if (r0 < n_out) {
      float acc[2][R] = {};
      const float* const rails[2] = {wi, wq};
      if constexpr (kFixed)
        modem::matched_fixed<R, SPS, SPAN * SPS + 1>(rails, r0 * SPS, taps,
                                                     acc);
      else
        modem::matched_generic<R>(rails, r0 * sps, sps, n_taps, tv, acc);
      int* o = out + c * k_sym + m0 + c0 + r0;
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (r0 + r < n_out)
          o[r] = modem::decide(acc[0][r], acc[1][r], map, slut);
    }
  }
}

// ---- the long core (pulse_chain_long_core) ----

constexpr int kChainCoreThreads = 64;  // the block's threads
constexpr int kG = 4;             // waveform rows a synthesis item makes
constexpr int kCoreR = modem::kLongR;
// decisions a pass at most, and at least where the budget cuts them
constexpr int kPassMax = 256;
constexpr int kPassMin = 16;
// shared memory a block aims at (four blocks an SM), and may take
constexpr size_t kPassBudget = 56 * 1024;

__host__ __device__ constexpr int round_up(int n, int m) {
  return (n + m - 1) / m * m;
}

// Waveform rows a pass of n_out decisions synthesizes: every row the
// filter of its decisions, rounded up to whole register blocks, reads,
// rounded up to whole synthesis items.
__host__ __device__ inline int core_rows(int n_out, int span) {
  return round_up(round_up(n_out, kCoreR) + span, kG);
}

// Floats of each rail's run-skewed waveform for passes of nsub decisions:
// the rows made, and the filter's last 16-byte group past them.
__host__ __device__ inline int core_wave_len(int nsub, int sps, int span) {
  const int ext = core_rows(nsub, span) * sps;
  const int read = (round_up(nsub, kCoreR) + span) * sps + 4;
  return modem::run_len(ext > read ? ext : read, kCoreR * sps);
}

// The block's shared memory for passes of nsub decisions (side: the
// table's and the carrier's floats, modem::side_floats).
inline size_t core_smem(int nsub, int sps, int span, int side) {
  const int points = round_up(2 * (core_rows(nsub, span) + span), 4);
  return sizeof(float) *
         (2 * static_cast<size_t>(core_wave_len(nsub, sps, span)) + points +
          4 * modem::long_tap_stride(span * sps + 1) + side);
}

// Decisions a pass of the core for tiles of cs symbols: the tile, at most
// kPassMax, halved while past kPassBudget (not below kPassMin); 0 where
// even that does not fit a block's shared memory.
inline int core_pass(int cs, int sps, int span, int side) {
  int nsub = round_up(cs < kPassMax ? cs : kPassMax, kCoreR);
  while (nsub > kPassMin && core_smem(nsub, sps, span, side) > kPassBudget)
    nsub = round_up(nsub / 2, kCoreR);
  return core_smem(nsub, sps, span, side) <= modem::kMaxSmem ? nsub : 0;
}

// Waveform rows r_first .. r_first + kG - 1 of the pass, phases p0 .. p0+3
// (those below sps): the polyphase synthesis (each sample one fmaf chain a
// rail over its taps k*sps + p, k = 0, 1, ..., as the first version), then
// [up-mix, AWGN, product detection], into the run-skewed rails. The points
// of rows r_first - span .. r_first + kG - 1 pass through a window of kG
// registers (slot (g - k) mod kG holds row g's point at tap k: the loop
// over k unrolled by kG renames, not moves, them); each step reads one
// point and the four phases' taps as one broadcast.
template <bool kPassband, bool kNoisy>
__device__ __forceinline__ void synth_item(
    float* wi, float* wq, const float2* zp, const float* taps4, int st,
    int r_first, int p0, int sps, int span, int c0, unsigned key,
    unsigned lane, float sigma, const modem::Nco& nco, int ph_pass,
    int row_step, const float* tc, const float* ts) {
  const int b = r_first + span;  // row g's point at tap k: zp[b - k + g]
  float2 w[kG];
#pragma unroll
  for (int g = 1; g < kG; ++g) w[g] = zp[b + g];
  float ai[4][kG] = {}, aq[4][kG] = {};
  for (int k0 = 0; k0 < span; k0 += kG) {
#pragma unroll
    for (int s = 0; s < kG; ++s) {
      const int k = k0 + s;
      if (k < span) {
        w[(kG - s) % kG] = zp[b - k];
        const float4 t = *reinterpret_cast<const float4*>(
            taps4 + modem::long_tap4(k * sps + p0, st));
        const float tv[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
        for (int g = 0; g < kG; ++g) {
          const float2 z = w[(g - s + kG) % kG];
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            ai[p][g] = fmaf(tv[p], z.x, ai[p][g]);
            aq[p][g] = fmaf(tv[p], z.y, aq[p][g]);
          }
        }
      }
    }
  }
  if (p0 == 0) {  // tap k = span: phase 0 alone (k*sps + p < L)
    const float t = taps4[span * sps];  // copy 0 holds t[j] at j
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      const float2 z = zp[r_first + g];
      ai[0][g] = fmaf(t, z.x, ai[0][g]);
      aq[0][g] = fmaf(t, z.y, aq[0][g]);
    }
  }
  int ph_row = kPassband
                   ? modem::nco_skip(nco, ph_pass, r_first * sps + p0)
                   : 0;
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    const int rl = r_first + g;
    int ph = ph_row;
#pragma unroll
    for (int p = 0; p < 4; ++p)
      if (p0 + p < sps)
        finish_sample<kPassband, kNoisy>(ai[p][g], aq[p][g], c0 + rl, p0 + p,
                                         key, lane, sigma, nco, ph, tc, ts);
    // row rl's samples all lie in run rl / kCoreR
    const int pos = rl * sps + p0 + 4 * (rl / kCoreR);
    if (sps % 4 == 0) {
      *reinterpret_cast<float4*>(wi + pos) =
          make_float4(ai[0][g], ai[1][g], ai[2][g], ai[3][g]);
      *reinterpret_cast<float4*>(wq + pos) =
          make_float4(aq[0][g], aq[1][g], aq[2][g], aq[3][g]);
    } else {
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        if (p0 + p < sps) {
          wi[pos + p] = ai[p][g];
          wq[pos + p] = aq[p][g];
        }
      }
    }
    if (kPassband) ph_row = modem::nco_add(nco, ph_row, row_step);
  }
}

// Persistent: block b takes items [b*n/G, (b+1)*n/G) of the n = C * n_tiles
// (channel, tile of cs symbols) items in channel-major order, each in
// passes of nsub decisions: map the pass's points, synthesize its rows
// (items of kG rows by 4 phases, the phases fastest, so that a warp's
// threads share points and taps), then each thread decides kCoreR
// consecutive symbols at a time with matched_long.
template <bool kPassband, bool kNoisy>
__global__ void __launch_bounds__(kChainCoreThreads, 8)
    pulse_chain_long_core(const int* __restrict__ syms, long long k_sym,
                          long long n_tiles, long long n_items, int cs,
                          int nsub, modem::Constellation map,
                          const float* __restrict__ taps, int sps, int span,
                          modem::Nco nco, float sigma, unsigned seed,
                          int* __restrict__ out) {
  const int n_taps = span * sps + 1;
  const int st = modem::long_tap_stride(n_taps);
  const int f_len = core_wave_len(nsub, sps, span);
  const int z_len = round_up(2 * (core_rows(nsub, span) + span), 4);
  extern __shared__ __align__(16) float smem[];
  float* wi = smem;  // the pass's waveform rows, run-skewed
  float* wq = wi + f_len;
  float2* zp = reinterpret_cast<float2*>(wq + f_len);  // their points
  float* taps4 = wq + f_len + z_len;
  float* slut = taps4 + 4 * st;
  float* tc = slut + (map.lut != nullptr ? 2 * map.n_points : 0);
  float* ts = tc + nco.period;

  const int tid = threadIdx.x;
  modem::stage_long_taps(taps4, taps, n_taps);
  if (map.lut != nullptr) modem::stage(slut, map.lut, 2 * map.n_points);
  if (kPassband && nco.table) modem::stage_nco(tc, ts, nco);
  const int nc = (sps + 3) / 4;  // 4-phase chunks a row
  const int row_step = kPassband ? modem::nco_skip(nco, 0, sps) : 0;

  long long lo, hi;
  modem::block_items(n_items, lo, hi);
  for (long long it = lo; it < hi; ++it) {
    const long long c = it / n_tiles;
    const long long tile = it % n_tiles;
    const long long m0 = tile * cs;
    const unsigned key = seed +
                         static_cast<unsigned>(c / modem::kLane) * 1000003u +
                         static_cast<unsigned>(tile) * 7919u;
    const unsigned lane = static_cast<unsigned>(c % modem::kLane);
    const int ph_tile = kPassband ? modem::nco_phase(nco, m0 * sps) : 0;
    const int* row = syms + c * k_sym;
    for (int c0 = 0; c0 < cs; c0 += nsub) {
      const long long left = k_sym - m0 - c0;
      if (left <= 0) break;
      int n_out = cs - c0 < nsub ? cs - c0 : nsub;
      if (left < n_out) n_out = static_cast<int>(left);
      const int rows = core_rows(n_out, span);
      __syncthreads();  // the tables, or the last pass's filter, are done
      for (int z = tid; z < rows + span; z += kChainCoreThreads) {
        float zi, zq;
        modem::map_point(row, m0 + c0 - span + z, k_sym, map, slut, zi, zq);
        zp[z] = make_float2(zi, zq);
      }
      __syncthreads();
      const int ph_pass =
          kPassband ? modem::nco_skip(nco, ph_tile, c0 * sps) : 0;
      const int n_syn = MODEM_LONG_PROBE == 3 ? 0 : rows / kG * nc;
      for (int i = tid; i < n_syn; i += kChainCoreThreads) {
        const int rg = i / nc;
        synth_item<kPassband, kNoisy>(wi, wq, zp, taps4, st, rg * kG,
                                      4 * (i - rg * nc), sps, span, c0, key,
                                      lane, sigma, nco, ph_pass, row_step, tc,
                                      ts);
      }
      __syncthreads();
      const float* const rails[2] = {wi, wq};
      for (int r0 = kCoreR * tid; r0 < n_out; r0 += kCoreR * kChainCoreThreads) {
        float acc[2][kCoreR] = {};
        if (MODEM_LONG_PROBE != 2)
          modem::matched_long<kCoreR>(rails, r0, sps, span, taps4, acc);
        int* o = out + c * k_sym + m0 + c0 + r0;
#pragma unroll
        for (int r = 0; r < kCoreR; ++r)
          if (r0 + r < n_out)
            o[r] = modem::decide(acc[0][r], acc[1][r], map, slut);
      }
    }
  }
}

template <bool kPassband, bool kNoisy>
int launch_chain_core(const int* syms, long long n_ch, long long k_sym,
                      int cs, const modem::Constellation& map,
                      const float* taps, int sps, int span,
                      const modem::Nco& nco, float sigma, unsigned seed,
                      int* out, void* stream) {
  auto kernel = pulse_chain_long_core<kPassband, kNoisy>;
  const int side = modem::side_floats(map, nco);
  const int nsub = core_pass(cs, sps, span, side);
  if (nsub == 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = core_smem(nsub, sps, span, side);
  const long long n_tiles = (k_sym + cs - 1) / cs;
  const long long n_items = n_ch * n_tiles;
  unsigned grid = 0;
  const cudaError_t err = modem::persistent_grid(
      kernel, kChainCoreThreads, smem, modem::kCoreBlocks, n_items, grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kChainCoreThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      syms, k_sym, n_tiles, n_items, cs, nsub, map, taps, sps, span, nco,
      sigma, seed, out);
  return static_cast<int>(cudaGetLastError());
}

template <bool kPassband, bool kNoisy, int SPS, int SPAN, bool kLong>
int launch_chain(const int* syms, long long n_ch, long long k_sym, int cs,
                 const modem::Constellation& map,
                 const modem::TapsArg<kLong>& taps, int sps, int span,
                 const modem::Nco& nco, float sigma, unsigned seed, int* out,
                 void* stream) {
  auto kernel = pulse_chain_kernel<kPassband, kNoisy, SPS, SPAN, kLong>;
  constexpr int kSub = kChainThreads * chain_r<kLong>();
  const long long n_tiles = (k_sym + cs - 1) / cs;
  const int z_len = kSub + 2 * span;
  const size_t smem =
      (2 * static_cast<size_t>(modem::skew_len((kSub + span) * sps + 4)) +
       2 * ((z_len + 1) & ~1) + modem::side_floats(map, nco) +
       (kLong ? span * sps + 1 : 0)) *
      sizeof(float);
  cudaError_t err = modem::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<modem::grid_blocks(n_ch, n_tiles), kChainThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(syms, k_sym, n_tiles, cs, map,
                                                taps, sps, span, nco, sigma,
                                                seed, out);
  return static_cast<int>(cudaGetLastError());
}

// The instantiation for a carrier mode, the noise, the route and the
// shape: taps is a host modem::Taps (the short route), or null for the long
// route, which reads taps_dev: the long core, or with `first` the first
// version.
template <bool kPassband, bool kNoisy>
int launch_chain_shape(const int* syms, long long n_ch, long long k_sym,
                       int cs, const modem::Constellation& map,
                       const void* taps, const float* taps_dev, bool first,
                       int sps, int span, const modem::Nco& nco, float sigma,
                       unsigned seed, int* out, void* stream) {
  if (taps == nullptr && !first)
    return launch_chain_core<kPassband, kNoisy>(syms, n_ch, k_sym, cs, map,
                                                taps_dev, sps, span, nco,
                                                sigma, seed, out, stream);
  if (taps == nullptr)
    return launch_chain<kPassband, kNoisy, 0, 0, true>(
        syms, n_ch, k_sym, cs, map, modem::TapsPtr{taps_dev}, sps, span, nco,
        sigma, seed, out, stream);
  const modem::Taps& t = *static_cast<const modem::Taps*>(taps);
  if (sps == 8 && span == 8)
    return launch_chain<kPassband, kNoisy, 8, 8, false>(
        syms, n_ch, k_sym, cs, map, t, sps, span, nco, sigma, seed, out,
        stream);
  return launch_chain<kPassband, kNoisy, 0, 0, false>(
      syms, n_ch, k_sym, cs, map, t, sps, span, nco, sigma, seed, out,
      stream);
}

// modem_chain's and modem_chain_first's checks, then the instantiation for
// the carrier mode and the noise.
int chain_entry(const int* syms, long long n_ch, long long k_sym, int cs,
                const float* lut, int n_points, int cshift, float ms, float a,
                float c, float s, const void* taps, const float* taps_dev,
                bool first, int n_taps, int sps, int span, int hz, int sr,
                long long sym_offset, float scale, int noisy, float sigma,
                unsigned seed, int* out, void* stream) {
  // the matched filter's sample window is exactly the tile's halo
  if (n_taps != span * sps + 1 || sps < 1 || span < 0 || cs < 1 ||
      (taps == nullptr ? taps_dev == nullptr
                       : n_taps > modem::kMaxTaps || sps > modem::kMaxSps))
    return static_cast<int>(cudaErrorInvalidValue);
  const modem::Constellation map =
      modem::make_map(lut, n_points, cshift, ms, a, c, s);
  modem::Nco nco;
  if (!modem::make_nco(hz, sr, sps, sym_offset, scale, nco))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool passband = sr != 0;
  if (passband && noisy)
    return launch_chain_shape<true, true>(syms, n_ch, k_sym, cs, map, taps,
                                          taps_dev, first, sps, span, nco,
                                          sigma, seed, out, stream);
  if (passband)
    return launch_chain_shape<true, false>(syms, n_ch, k_sym, cs, map, taps,
                                           taps_dev, first, sps, span, nco,
                                           sigma, seed, out, stream);
  if (noisy)
    return launch_chain_shape<false, true>(syms, n_ch, k_sym, cs, map, taps,
                                           taps_dev, first, sps, span, nco,
                                           sigma, seed, out, stream);
  return launch_chain_shape<false, false>(syms, n_ch, k_sym, cs, map, taps,
                                          taps_dev, first, sps, span, nco,
                                          sigma, seed, out, stream);
}

}  // namespace

extern "C" {

// syms [n_ch, k_sym] int32 -> out [n_ch, k_sym] int32 decisions, in tiles of
// cs symbols. The map: lut [n_points, 2] f32, or with lut null square QAM
// (cshift, ms, a, c, s); the carrier: sr == 0 baseband, else hz, sr,
// sym_offset and scale = f32(2*pi/sr); the span*sps+1 taps: taps a host
// pointer to them in a modem::Taps, passed to the kernel by value (the
// short route: n_taps <= 256, sps <= 64), or taps null and taps_dev the
// device array (the long route's core, pulse_chain_long_core: any chain
// whose smallest pass fits a block's shared memory; the host's rule,
// ops.txrx.pulse_long_route, sends the others to modem_chain_first);
// noisy != 0 adds sigma * N(0, 1) from the stream keyed by seed. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for arguments the kernel
// does not take.
int modem_chain(const int* syms, long long n_ch, long long k_sym, int cs,
                const float* lut, int n_points, int cshift, float ms, float a,
                float c, float s, const void* taps, const float* taps_dev,
                int n_taps, int sps, int span, int hz, int sr,
                long long sym_offset, float scale, int noisy, float sigma,
                unsigned seed, int* out, void* stream) {
  return chain_entry(syms, n_ch, k_sym, cs, lut, n_points, cshift, ms, a, c,
                     s, taps, taps_dev, false, n_taps, sps, span, hz, sr,
                     sym_offset, scale, noisy, sigma, seed, out, stream);
}

// The long route's first version (pulse_chain_kernel, one decision a
// thread, passes of 64) at any shape whose tile fits, the taps from the
// device: the route for the chains past the core's shared memory, and
// forced here so that the two can be compared at any shape. Arguments as
// modem_chain's without the host taps.
int modem_chain_first(const int* syms, long long n_ch, long long k_sym,
                      int cs, const float* lut, int n_points, int cshift,
                      float ms, float a, float c, float s,
                      const float* taps_dev, int n_taps, int sps, int span,
                      int hz, int sr, long long sym_offset, float scale,
                      int noisy, float sigma, unsigned seed, int* out,
                      void* stream) {
  return chain_entry(syms, n_ch, k_sym, cs, lut, n_points, cshift, ms, a, c,
                     s, nullptr, taps_dev, true, n_taps, sps, span, hz, sr,
                     sym_offset, scale, noisy, sigma, seed, out, stream);
}

}  // extern "C"
