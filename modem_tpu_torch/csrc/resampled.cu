// Config #4's fused pair, the QAM chain with a rational resampler in it:
// replaces the two kernels of modem_tpu/ops/pallas_resampled.py.
//
// K11 (_resampled_tx_kernel): int32 symbols -> constellation map ->
//   polyphase RRC interpolation to the modem rate (kept in shared memory)
//   -> rational up/down stage -> channel-rate I/Q.
// K12 (_resampled_rx_kernel): channel-rate I/Q -> one periodically
//   time-varying stage to the symbol rate (the down/up resampler, the
//   matched filter and the decimation collapsed into one table) ->
//   min-distance slice to int32 symbols, or the soft (i, q).
//
// Both rate stages have one form, a periodically time-varying FIR
//   out[g*P + p] = sum_{o < N} table[p][o] * x[g*S + first + o],
// x zero outside [0, n): K11's up/down stage with P = up, S = down (the
// table from _stage_weights), K12 with P = down / gcd(sps*up, down),
// S = sps*up / gcd(sps*up, down) (_composite_rx_weights). The tables are
// built on the host (ops/resampled_kernel.py).
//
// What bounds them on this card: bytes. At 3/2 (sps 8) K11 writes 8 B a
// channel sample and reads 4 B a symbol, against 17 FMAs a sample and rail
// in the stage and 72 a symbol and rail in the RRC; K12 reads 8 B a channel
// sample, 12 samples a symbol, against 112 FMAs a symbol and rail. Both sit
// under the f32 FMA rate, so their floors are the channel-rate write (K11)
// and read (K12). The first version (the long route below) reached 16% and
// 30-33% of them: three shared-memory loads a multiply-add (the tap and a
// sample a rail) and a branch a tap. The polyphase core of this file:
// - tables as kernel parameters: K11's RRC taps and stage table, K12's
//   composite table in one __grid_constant__ modem::Taps (256 floats at
//   most), so with the loops unrolled at compile time every tap reaches its
//   FFMA as a constant-bank operand;
// - register-blocked stages (ptv_fixed): a thread owns R consecutive groups
//   of P outputs and walks the (R-1)*S + N samples of its run once, oldest
//   first, in 16-byte loads from a skewed buffer (common.cuh, skew), feeding
//   each sample to every output it belongs to (at 3/2 K11's stage makes 24
//   outputs a thread from 31 samples, K12 4 decisions from 148);
// - K11's RRC register-blocked by symbol: a thread loads the points of its
//   2 (3/2) or 3 (2/3) consecutive symbols, 10 or 11 a rail, and emits their
//   8 phases each (144 FMAs a symbol); a tile of 1016 groups holds just the
//   symbols for one round of the block's threads. The modem-rate waveform
//   stays in shared memory; the outputs go through shared memory and out in
//   16-byte stores, each assembled from the two staged pieces it straddles
//   where the row starts off a 16-byte boundary (rows of 49257 samples:
//   three in four);
// - persistent blocks (block_items, persistent_grid) walking (channel,
//   tile) items with no division in the loop, the next item's input in
//   flight by cp.async while this one is filtered: K11's symbols; K12's
//   channel window in 16-byte pieces into a staging buffer, each rail as
//   many floats late as its first sample lies past a 16-byte boundary, then
//   one pass that realigns it into the filter's buffer;
// - K12's slice on a thread's decisions at once (nearest_points: each
//   point of the table loaded once for all of them);
// - compiled shapes: K11 at sps 8, 65 RRC taps, 3/2 and 2/3 (17 taps a
//   phase); K12 at (P, S, N) = (1, 12, 112) and (3, 16, 71), config #4's
//   tables at 3/2 and 2/3. Every other shape takes the long route, the first
//   version unchanged (tables staged in shared memory): no workload runs
//   another ratio, and one that comes to need speed gets an instantiation
//   of its own.
// Exactness: every output is one fmaf chain in the first version's order:
// the stage's o = 0, 1, ..., N-1 from 0 (oldest sample first, zero taps
// included), the RRC's k = 0, 1, ..., kp-1 (newest symbol first, zero taps
// past the last included), so the outputs are the first version's bit for
// bit and agree with the plain version to f32 rounding (nvcc's FMAs).

#include "common.cuh"

namespace {

using modem::kThreads;
using modem::skew;
using modem::skew_len;

__host__ __device__ __forceinline__ long long floor_div(long long a,
                                                        long long b) {
  return a >= 0 ? a / b : -((b - 1 - a) / b);
}

// ---- the polyphase core ----

// R consecutive groups of P outputs of each of the NR rails y[] (skewed
// buffers): acc[k][p][r] = sum_{o < N} t.v[OFF + p*N + o] *
// y[k][base + r*S + o]. The thread walks the (R-1)*S + N samples of its run
// once, oldest first, in 16-byte loads (base a multiple of 4), and feeds
// each to every output it belongs to: one fmaf chain an output, taps in the
// order o = 0, 1, ..., N-1. acc[][][] start at 0.
template <int R, int P, int S, int N, int OFF, int NR>
__device__ __forceinline__ void ptv_fixed(const float* const (&y)[NR],
                                          int base, const modem::Taps& t,
                                          float (&acc)[NR][P][R]) {
  static_assert(R * S % 4 == 0, "every run starts 16-byte aligned");
  constexpr int W = (R - 1) * S + N;
  constexpr int NQ = (W + 3) / 4;
  constexpr bool kRow = R * S % 32 == 0;  // every run starts a skew row
  const int pb = skew(base);
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    const int at = kRow ? pb + 4 * q + 4 * (q >> 3) : skew(base + 4 * q);
    float e[NR][4];
#pragma unroll
    for (int k = 0; k < NR; ++k) {
      const float4 v = *reinterpret_cast<const float4*>(y[k] + at);
      e[k][0] = v.x;
      e[k][1] = v.y;
      e[k][2] = v.z;
      e[k][3] = v.w;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = 4 * q + u;  // oldest sample first
      if (i >= W) continue;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int o = i - r * S;
        if (o >= 0 && o < N) {
#pragma unroll
          for (int p = 0; p < P; ++p) {
#pragma unroll
            for (int k = 0; k < NR; ++k)
              acc[k][p][r] =
                  fmaf(t.v[OFF + p * N + o], e[k][u], acc[k][p][r]);
          }
        }
      }
    }
  }
}

// Pieces q0 .. q1 - 1 of a row A floats past a 16-byte boundary: al[4q ..
// 4q+3] (al the boundary) holds staged outputs 4q - A .. 4q - A + 3, from
// the staged piece q and, for A > 0, the one before it.
template <int A>
__device__ __forceinline__ void store_pieces(float* __restrict__ al,
                                             const float* ys, int q0, int q1) {
  for (int q = q0 + threadIdx.x; q < q1; q += blockDim.x) {
    const float4 b = *reinterpret_cast<const float4*>(ys + skew(4 * q));
    float4 v = b;
    if constexpr (A > 0) {
      const float4 f = *reinterpret_cast<const float4*>(ys + skew(4 * q - 4));
      if constexpr (A == 1)
        v = make_float4(f.w, b.x, b.y, b.z);
      else if constexpr (A == 2)
        v = make_float4(f.z, f.w, b.x, b.y);
      else
        v = make_float4(f.y, f.z, f.w, b.x);
    }
    *reinterpret_cast<float4*>(al + 4 * q) = v;
  }
}

// Staged outputs 0 .. count-1 (skewed ys) to dst[0 .. count-1] in device
// memory, all threads: whole 16-byte pieces of the row where they fall,
// each assembled from the two staged pieces it straddles when dst lies a
// floats past a 16-byte boundary (a the same for the whole block: one
// branch); single floats at the head and the tail.
__device__ inline void store_shifted(float* __restrict__ dst, const float* ys,
                                     int count) {
  const int a = modem::misalign(dst);
  float* const al = dst - a;
  const int q0 = a == 0 ? 0 : 1;
  const int q1 = (count + a) >> 2;
  int lo = 0, hi = 0;  // the pieces store outputs lo .. hi - 1
  if (q1 > q0) {
    lo = 4 * q0 - a;
    hi = 4 * q1 - a;
  }
  switch (a) {
    case 0: store_pieces<0>(al, ys, q0, q1); break;
    case 1: store_pieces<1>(al, ys, q0, q1); break;
    case 2: store_pieces<2>(al, ys, q0, q1); break;
    default: store_pieces<3>(al, ys, q0, q1); break;
  }
  for (int j = threadIdx.x; j < lo; j += blockDim.x) dst[j] = ys[skew(j)];
  for (int j = hi + threadIdx.x; j < count; j += blockDim.x)
    dst[j] = ys[skew(j)];
}

// A persistent block's place in the (channel, tile) walk: channel c, tile t
// of n_tiles, advanced without a division (a 64-bit division is a call of
// some hundred instructions in every thread).
struct Walk {
  long long c, t;
  __device__ __forceinline__ Walk after(long long n_tiles) const {
    return t + 1 == n_tiles ? Walk{c + 1, 0} : Walk{c, t + 1};
  }
};

// ---- K11 on the core ----

constexpr int kTxThreads = 128;
constexpr int kTxR = 8;       // groups a thread
constexpr int kTxBlocks = 4;  // persistent blocks an SM, at most
// Groups a tile: one thread's worth short of the
// block's 1024, so that a tile's symbols (about (1015*down + 17)/8) fill
// whole rounds of the RRC's threads: 256 at 3/2 (3048 channel samples from
// 2047 modem samples), 383 at 2/3.
constexpr int kTxGroups = kTxR * (kTxThreads - 1);
constexpr int kTxSymbolsMax = 4;  // the RRC's symbols a thread, at most

// An item of K11's walk: channel c, groups [g0, g0 + gn), modem samples
// [n0, n0 + win) of which the first `live` lie before the modem-rate length,
// the symbols with samples among them [s0, s0 + ns).
struct TxItem {
  long long c, g0, n0, s0;
  int gn, win, live, ns;
};

// The instantiation for (SPS, NT RRC taps, UP/DOWN, NO stage taps a phase).
// tabs holds the RRC taps [NT], then the stage table [UP][NO].
template <int SPS, int NT, int UP, int DOWN, int NO>
__global__ void __launch_bounds__(kTxThreads)
    resampled_tx_core(const int* __restrict__ syms, long long k_sym,
                      long long n_tiles, long long n_items,
                      const float* __restrict__ lut, int n_points,
                      const __grid_constant__ modem::Taps tabs, int first,
                      int z_cap, long long n_modem, long long n_out,
                      float* __restrict__ out_i, float* __restrict__ out_q) {
  constexpr int R = kTxR;
  constexpr int groups = kTxGroups;
  constexpr int sps = SPS, up = UP, down = DOWN, n_o = NO;
  constexpr int kp = (NT + SPS - 1) / SPS;
  const int w_len = skew_len((groups - 1) * down + n_o + 4);
  const int y_len = skew_len(groups * up);
  const long long n_groups = (n_out + up - 1) / up;

  // the modem-rate window [2 rails][w_len] and the staged outputs [2 rails]
  // [y_len], skewed; the symbols [2 buffers][z_cap]; the table of points
  extern __shared__ __align__(16) float smem[];
  float* const wb = smem;
  float* const ys = wb + 2 * w_len;
  int* const raw = reinterpret_cast<int*>(ys + 2 * y_len);
  float* const slut = reinterpret_cast<float*>(raw + 2 * z_cap);

  long long lo, hi;
  modem::block_items(n_items, lo, hi);
  modem::stage(slut, lut, 2 * n_points);

  auto item = [&](Walk w) {
    TxItem t;
    t.c = w.c;
    t.g0 = w.t * groups;
    const long long left = n_groups - t.g0;
    t.gn = left < groups ? static_cast<int>(left) : groups;
    t.n0 = t.g0 * down + first;
    t.win = (t.gn - 1) * down + n_o;
    const long long live = n_modem - t.n0;
    t.live = live < 0 ? 0 : live < t.win ? static_cast<int>(live) : t.win;
    t.s0 = floor_div(t.n0, sps);
    t.ns = static_cast<int>(floor_div(t.n0 + t.win - 1, sps) - t.s0) + 1;
    return t;
  };

  // Item it's symbols s0 - kp + 1 .. s0 + ns - 1 into raw[b] by cp.async,
  // -1 (no point) outside the row.
  auto issue = [&](Walk w, int b) {
    const TxItem t = item(w);
    const long long g_lo = t.s0 - kp + 1;
    const int* row = syms + t.c * k_sym;
    int* dst = raw + b * z_cap;
    for (int j = threadIdx.x; j < t.ns + kp - 1; j += blockDim.x) {
      const long long g = g_lo + j;
      if (g >= 0 && g < k_sym)
        modem::cp_async4(dst + j, row + g);
      else
        dst[j] = -1;
    }
    modem::cp_async_commit();
  };

  Walk cur{lo / n_tiles, lo % n_tiles};
  if (lo < hi) issue(cur, 0);
  for (long long it = lo; it < hi; ++it) {
    const int b = static_cast<int>((it - lo) & 1);
    const Walk nxt = cur.after(n_tiles);
    if (it + 1 < hi) {
      issue(nxt, b ^ 1);
      modem::cp_async_wait<1>();
    } else {
      modem::cp_async_wait<0>();
    }
    __syncthreads();
    const TxItem t = item(cur);
    cur = nxt;

    // the point of raw[b][j], symbol s0 - kp + 1 + j: zero for symbols off
    // the table (and -1)
    const int* rb = raw + b * z_cap;
    auto point = [&](int j, float& zi, float& zq) {
      const int s = rb[j];
      const bool in = s >= 0 && s < n_points;
      zi = in ? slut[2 * s] : 0.f;
      zq = in ? slut[2 * s + 1] : 0.f;
    };

    // the RRC: sample s*sps + ph of symbol s = s0 + j is sum_k taps[k*sps +
    // ph] * z[s - k], k = 0 .. kp-1 (zero taps past the last), stored at its
    // offset from n0 where it falls in the window, zero past the modem-rate
    // length
    const int off_s0 = static_cast<int>(t.s0 * sps - t.n0);
    auto put = [&](int pos, float ai, float aq) {
      if (pos >= 0 && pos < t.win) {
        const bool live = pos < t.live;
        wb[skew(pos)] = live ? ai : 0.f;
        wb[w_len + skew(pos)] = live ? aq : 0.f;
      }
    };
    // KS consecutive symbols a thread, their kp + KS - 1 points in
    // registers: one round of the threads a tile (kTxGroups)
    constexpr int KS =
        (((kTxGroups - 1) * DOWN + NO - 1) / SPS + kTxThreads) / kTxThreads;
    static_assert(KS <= kTxSymbolsMax, "z_cap holds the last thread's run");
    for (int j0 = KS * threadIdx.x; j0 < t.ns; j0 += KS * blockDim.x) {
      float pz[2][kp + KS - 1];  // symbols s0 + j0 - kp + 1 ..
#pragma unroll
      for (int m = 0; m < kp + KS - 1; ++m)
        point(j0 + m, pz[0][m], pz[1][m]);
#pragma unroll
      for (int u = 0; u < KS; ++u) {
        if (j0 + u >= t.ns) break;
        const int pos = off_s0 + (j0 + u) * SPS;
        const bool whole = pos >= 0 && pos + SPS <= t.live;  // no guards
#pragma unroll
        for (int ph = 0; ph < SPS; ++ph) {
          float ai = 0.f, aq = 0.f;
#pragma unroll
          for (int k = 0; k < kp; ++k) {
            const float w = k * SPS + ph < NT ? tabs.v[k * SPS + ph] : 0.f;
            ai = fmaf(w, pz[0][u + kp - 1 - k], ai);
            aq = fmaf(w, pz[1][u + kp - 1 - k], aq);
          }
          if (whole) {
            wb[skew(pos + ph)] = ai;
            wb[w_len + skew(pos + ph)] = aq;
          } else {
            put(pos + ph, ai, aq);
          }
        }
      }
    }
    __syncthreads();

    // the stage: groups r0 .. r0 + R - 1 of the tile, outputs (r0 + r)*up + p
    // staged in ys
    const int r0 = R * static_cast<int>(threadIdx.x);
    const float* const y[2] = {wb, wb + w_len};
    static_assert(R * UP % 4 == 0, "whole 16-byte pieces");
    if (r0 < t.gn) {
      float acc[2][UP][R] = {};
      ptv_fixed<R, UP, DOWN, NO, NT>(y, r0 * DOWN, tabs, acc);
#pragma unroll
      for (int k = 0; k < 2; ++k) {
#pragma unroll
        for (int m = 0; m < R * UP; m += 4) {
          float v[4];
#pragma unroll
          for (int u = 0; u < 4; ++u)
            v[u] = acc[k][(m + u) % UP][(m + u) / UP];
          *reinterpret_cast<float4*>(ys + k * y_len + skew(r0 * UP + m)) =
              make_float4(v[0], v[1], v[2], v[3]);
        }
      }
    }
    __syncthreads();

    // the next item's first writes to ys follow two __syncthreads
    const long long m0 = t.g0 * up;
    const long long left = n_out - m0;
    const int count = left < t.gn * up ? static_cast<int>(left) : t.gn * up;
    store_shifted(out_i + t.c * n_out + m0, ys, count);
    store_shifted(out_q + t.c * n_out + m0, ys + y_len, count);
  }
}

template <int SPS, int NT, int UP, int DOWN, int NO>
int launch_tx_core(const int* syms, long long n_ch, long long k_sym,
                   const float* lut, int n_points, const modem::Taps& tabs,
                   int first, long long n_out, float* out_i, float* out_q,
                   cudaStream_t stream) {
  auto kernel = resampled_tx_core<SPS, NT, UP, DOWN, NO>;
  constexpr int groups = kTxGroups;
  constexpr int kp = (NT + SPS - 1) / SPS;
  constexpr int win = (groups - 1) * DOWN + NO;
  constexpr int z_cap = (win - 1) / SPS + kp + kTxSymbolsMax;
  const size_t smem = (2 * static_cast<size_t>(skew_len(win + 4)) +
                       2 * static_cast<size_t>(skew_len(groups * UP)) +
                       2 * static_cast<size_t>(z_cap) + 2 * n_points) *
                      sizeof(float);
  const long long n_tiles = ((n_out + UP - 1) / UP + groups - 1) / groups;
  const long long n_items = n_ch * n_tiles;
  unsigned grid = 0;
  const cudaError_t err = modem::persistent_grid(kernel, kTxThreads, smem,
                                                 kTxBlocks, n_items, grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kTxThreads, smem, stream>>>(
      syms, k_sym, n_tiles, n_items, lut, n_points, tabs, first, z_cap,
      n_out * DOWN / UP, n_out, out_i, out_q);
  return static_cast<int>(cudaGetLastError());
}

// ---- K12 on the core ----

constexpr int kRxR = 4;       // groups a thread
constexpr int kRxBlocks = 8;  // persistent blocks an SM, at most

// Floats of a staging rail for windows of up to `win` samples: a shift of
// up to 3 and the realigning pass's reads up to 7 past the window.
__host__ __device__ inline int stage_len(int win) { return (win + 11) & ~3; }

// Samples 4q .. 4q+3 of a window staged a floats late (a = 0..3): from the
// staged pieces p = st[4q .. 4q+3] and, for a > 0, the next.
__device__ __forceinline__ float4 unshift4(const float* st, int q, int a) {
  const float4 p = *reinterpret_cast<const float4*>(st + 4 * q);
  if (a == 0) return p;
  const float4 n = *reinterpret_cast<const float4*>(st + 4 * q + 4);
  return a == 1   ? make_float4(p.y, p.z, p.w, n.x)
         : a == 2 ? make_float4(p.z, p.w, n.x, n.y)
                  : make_float4(p.w, n.x, n.y, n.z);
}

// K12's threads a block, 32 to 128: a tile of kRxR * threads groups reads
// about 2048 samples a rail. At 3/2 that is one warp a block and 8 blocks
// an SM, faster there than blocks of 2 warps, 4 an SM, and a little slower
// at 2/3 (measured on the H100 80GB HBM3 at 700 W, PERF.md).
inline int rx_threads(int width) {
  const int t = (2048 / (kRxR * width)) & ~31;
  return t < 32 ? 32 : t > 128 ? 128 : t;
}

// The min-distance slice of R decision points at once: each point of the
// table loaded once for all R, each decided by common.cuh's nearest_point's
// operations (of equal distances the lowest index wins).
template <int R>
__device__ __forceinline__ void nearest_points(const float (&ai)[R],
                                               const float (&aq)[R],
                                               const float* lut, int n_points,
                                               int (&best)[R]) {
  float best_d[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    best[r] = 0;
    best_d[r] = __int_as_float(0x7f800000);  // +inf
  }
  for (int m = 0; m < n_points; ++m) {
    const float2 pt = *reinterpret_cast<const float2*>(lut + 2 * m);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float di = ai[r] - pt.x;
      const float dq = aq[r] - pt.y;
      const float dist = di * di + dq * dq;
      if (dist < best_d[r]) {
        best_d[r] = dist;
        best[r] = m;
      }
    }
  }
}

// The instantiation for (P, S, N). tab holds the composite table [P][N].
template <bool kSoft, int P, int S, int N>
__global__ void __launch_bounds__(128)
    resampled_rx_core(const float* __restrict__ wi,
                      const float* __restrict__ wq, long long n_wave,
                      long long n_sym, long long n_tiles, long long n_items,
                      const __grid_constant__ modem::Taps tab, int first,
                      int groups,
                      const float* __restrict__ lut, int n_points,
                      int* __restrict__ out_sym, float* __restrict__ out_i,
                      float* __restrict__ out_q) {
  constexpr int R = kRxR;
  constexpr int period = P, width = S, n_o = N;
  const int win_cap = (groups - 1) * width + n_o;
  const int f_len = skew_len(win_cap + 4);
  const int s_len = stage_len(win_cap);
  const long long n_groups = (n_sym + period - 1) / period;

  // the filter's window [2 rails][f_len], skewed; the next window's staging
  // [2 rails][s_len]; the table of points
  extern __shared__ __align__(16) float smem[];
  float* const stg = smem + 2 * f_len;
  float* const slut = stg + 2 * s_len;

  long long lo, hi;
  modem::block_items(n_items, lo, hi);
  if (!kSoft) modem::stage(slut, lut, 2 * n_points);

  auto tile_groups = [&](long long g0) {
    const long long left = n_groups - g0;
    return left < groups ? static_cast<int>(left) : groups;
  };

  // Item it's first channel sample s0 = g0*S + first of each rail in device
  // memory (zero outside the waveform; before it: the resampler's zero
  // history), and its window's length.
  auto source = [&](Walk w, int rail, int& win) {
    const long long g0 = w.t * groups;
    win = (tile_groups(g0) - 1) * width + n_o;
    return (rail ? wq : wi) + w.c * n_wave + g0 * width + first;
  };

  // Item it's window into the staging rails by cp.async, each rail a floats
  // late where its first sample lies a floats past a 16-byte boundary, so
  // that whole 16-byte pieces of the row land on whole pieces of the stage.
  auto issue = [&](Walk w) {
    const long long s0 = w.t * groups * width + first;
    const int head = s0 >= 0 ? 0 : -s0 < win_cap ? static_cast<int>(-s0)
                                                 : win_cap;
    const long long avail = n_wave - s0;
    for (int rail = 0; rail < 2; ++rail) {
      int win;
      const float* src = source(w, rail, win);
      const int a = modem::misalign(src);
      const int h = head < win ? head : win;
      const int n_valid =
          avail <= 0 ? 0 : avail < win ? static_cast<int>(avail) : win;
      float* dst = stg + rail * s_len;
      for (int i = threadIdx.x; i < h; i += blockDim.x) dst[a + i] = 0.f;
      modem::load_span<false>(dst, src - a, 0, a + win, a + n_valid, a + h);
    }
    modem::cp_async_commit();
  };

  // The staged window of item it into the filter's rails, realigned.
  auto realign = [&](Walk w) {
    for (int rail = 0; rail < 2; ++rail) {
      int win;
      const int a = modem::misalign(source(w, rail, win));
      const float* st = stg + rail * s_len;
      float* y = smem + rail * f_len;
      for (int q = threadIdx.x; 4 * q < win; q += blockDim.x)
        *reinterpret_cast<float4*>(y + skew(4 * q)) = unshift4(st, q, a);
    }
  };

  // decisions (or soft points) m0 + r*stride, r < R, of channel c
  auto emit = [&](long long c, long long m0, int stride, const float (&ai)[R],
                  const float (&aq)[R]) {
    int d[R];
    if (!kSoft) nearest_points<R>(ai, aq, slut, n_points, d);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const long long m = m0 + r * stride;
      if (m >= n_sym) break;
      if (kSoft) {
        out_i[c * n_sym + m] = ai[r];
        out_q[c * n_sym + m] = aq[r];
      } else {
        out_sym[c * n_sym + m] = d[r];
      }
    }
  };

  Walk cur{lo / n_tiles, lo % n_tiles};
  if (lo < hi) issue(cur);
  for (long long it = lo; it < hi; ++it) {
    modem::cp_async_wait<0>();
    __syncthreads();  // the stage holds item it; the filter is free
    realign(cur);
    __syncthreads();  // the filter holds item it; the stage is free
    const Walk nxt = cur.after(n_tiles);
    if (it + 1 < hi) issue(nxt);  // in flight while this item filters

    const long long c = cur.c;
    const long long g0 = cur.t * groups;
    cur = nxt;
    const float* const y[2] = {smem, smem + f_len};
    const int r0 = R * static_cast<int>(threadIdx.x);
    if (r0 < tile_groups(g0)) {
      float acc[2][P][R] = {};
      ptv_fixed<R, P, S, N, 0>(y, r0 * S, tab, acc);
#pragma unroll
      for (int p = 0; p < P; ++p)
        emit(c, (g0 + r0) * P + p, P, acc[0][p], acc[1][p]);
    }
  }
}

template <bool kSoft, int P, int S, int N>
int launch_rx_core(const float* wi, const float* wq, long long n_ch,
                   long long n_wave, long long n_sym, const modem::Taps& tab,
                   int first, const float* lut, int n_points, int* out_sym,
                   float* out_i, float* out_q, cudaStream_t stream) {
  auto kernel = resampled_rx_core<kSoft, P, S, N>;
  const int nt = rx_threads(S);
  const int groups = kRxR * nt;
  const int win = (groups - 1) * S + N;
  const size_t smem =
      (2 * static_cast<size_t>(skew_len(win + 4)) +
       2 * static_cast<size_t>(stage_len(win)) + 2 * n_points) *
      sizeof(float);
  const long long n_tiles = ((n_sym + P - 1) / P + groups - 1) / groups;
  const long long n_items = n_ch * n_tiles;
  unsigned grid = 0;
  const cudaError_t err =
      modem::persistent_grid(kernel, nt, smem, kRxBlocks, n_items, grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, nt, smem, stream>>>(wi, wq, n_wave, n_sym, n_tiles, n_items,
                                     tab, first, groups, lut, n_points,
                                     out_sym, out_i, out_q);
  return static_cast<int>(cudaGetLastError());
}

// ---- the long route: the first version, for tables past the parameter ----
//
// Each block holds its window of x in phase-major planes (plane p, row r
// holds window sample r*S + p), so the threads of a warp, consecutive
// outputs, read consecutive words of one plane, or one word together; the
// tables are staged in shared memory. A K11 block maps its own symbols and
// builds its modem-rate waveform in shared memory; a K12 block loads its
// channel window with coalesced loads before it filters.

constexpr int kOutTile = 2048;  // K11: channel samples per block, at most
constexpr int kSymTile = 256;   // K12: symbols per block, at most
constexpr int kWindow = 4096;   // either: window samples per block, about

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

int launch_tx_long(const int* syms, long long n_ch, long long k_sym,
                   const float* lut, int n_points, const float* taps,
                   int n_taps, int sps, const float* table, int up, int down,
                   int n_o, int first, long long n_out, float* out_i,
                   float* out_q, cudaStream_t stream) {
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
                        stream>>>(
      syms, k_sym, n_tiles, lut, n_points, taps, n_taps, sps, table, up, down,
      n_o, first, groups, z_cap, n_out, out_i, out_q);
  return static_cast<int>(cudaGetLastError());
}

template <bool kSoft>
int launch_rx_long(const float* wi, const float* wq, long long n_ch,
                   long long n_wave, long long n_sym, const float* table,
                   int period, int width, int n_o, int first, const float* lut,
                   int n_points, int* out_sym, float* out_i, float* out_q,
                   cudaStream_t stream) {
  const int groups = tile_groups(kSymTile, period, width);
  const int stride = window_rows(groups, n_o, width) | 1;
  const long long n_tiles = ((n_sym + period - 1) / period + groups - 1) / groups;
  const size_t smem = (2 * static_cast<size_t>(width) * stride +
                       static_cast<size_t>(period) * n_o + 2 * n_points) *
                      sizeof(float);
  cudaError_t err = modem::allow_smem(resampled_rx_kernel<kSoft>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  resampled_rx_kernel<kSoft><<<modem::grid_blocks(n_ch, n_tiles), kThreads,
                               smem, stream>>>(
      wi, wq, n_wave, n_sym, n_tiles, table, period, width, n_o, first, groups,
      lut, n_points, out_sym, out_i, out_q);
  return static_cast<int>(cudaGetLastError());
}

// K11's route: the core's instantiation for a compiled shape (tabs, the
// host tables, not null), else the long route on the device arrays.
int launch_tx(const int* syms, long long n_ch, long long k_sym,
              const float* lut, int n_points, const void* tabs,
              const float* taps, int n_taps, int sps, const float* table,
              int up, int down, int n_o, int first, long long n_out,
              float* out_i, float* out_q, cudaStream_t s) {
  if (tabs != nullptr && sps == 8 && n_taps == 65 && n_o == 17) {
    const modem::Taps& t = *static_cast<const modem::Taps*>(tabs);
    if (up == 3 && down == 2)
      return launch_tx_core<8, 65, 3, 2, 17>(syms, n_ch, k_sym, lut, n_points,
                                             t, first, n_out, out_i, out_q, s);
    if (up == 2 && down == 3)
      return launch_tx_core<8, 65, 2, 3, 17>(syms, n_ch, k_sym, lut, n_points,
                                             t, first, n_out, out_i, out_q, s);
  }
  return launch_tx_long(syms, n_ch, k_sym, lut, n_points, taps, n_taps, sps,
                        table, up, down, n_o, first, n_out, out_i, out_q, s);
}

// K12's route, as K11's.
template <bool kSoft>
int launch_rx(const float* wi, const float* wq, long long n_ch,
              long long n_wave, long long n_sym, const void* tab,
              const float* table, int period, int width, int n_o, int first,
              const float* lut, int n_points, int* out_sym, float* out_i,
              float* out_q, cudaStream_t s) {
  if (tab != nullptr) {
    const modem::Taps& t = *static_cast<const modem::Taps*>(tab);
    if (period == 1 && width == 12 && n_o == 112)
      return launch_rx_core<kSoft, 1, 12, 112>(wi, wq, n_ch, n_wave, n_sym, t,
                                               first, lut, n_points, out_sym,
                                               out_i, out_q, s);
    if (period == 3 && width == 16 && n_o == 71)
      return launch_rx_core<kSoft, 3, 16, 71>(wi, wq, n_ch, n_wave, n_sym, t,
                                              first, lut, n_points, out_sym,
                                              out_i, out_q, s);
  }
  if (period > kSymTile) return static_cast<int>(cudaErrorInvalidValue);
  return launch_rx_long<kSoft>(wi, wq, n_ch, n_wave, n_sym, table, period,
                               width, n_o, first, lut, n_points, out_sym,
                               out_i, out_q, s);
}

}  // namespace

extern "C" {

// syms [n_ch, k_sym] int32 -> out_i, out_q [n_ch, n_out] f32; lut
// [n_points, 2] f32. The filters: the device arrays taps [n_taps] (the RRC)
// and table [up, n_o] (the up/down stage), and tabs, a host pointer to a
// modem::Taps that holds the same taps and then the same table where they
// fit, else null. Config #4's shapes (sps 8, 65 taps, 3/2 and 2/3 with 17
// taps a phase) take the core, every other shape the long route. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for arguments the kernels do
// not take.
int modem_resampled_tx(const int* syms, long long n_ch, long long k_sym,
                       const float* lut, int n_points, const void* tabs,
                       const float* taps, int n_taps, int sps,
                       const float* table, int up, int down, int n_o,
                       int first, long long n_out, float* out_i, float* out_q,
                       void* stream) {
  if (sps < 1 || n_taps < 1 || up < 1 || down < 1 || n_o < 1 ||
      n_points < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_tx(syms, n_ch, k_sym, lut, n_points, tabs, taps, n_taps, sps,
                   table, up, down, n_o, first, n_out, out_i, out_q,
                   static_cast<cudaStream_t>(stream));
}

// wi, wq [n_ch, n_wave] f32 -> out_sym [n_ch, n_sym] int32 decisions
// against lut [n_points, 2] (soft == 0), or the decision-point I/Q out_i,
// out_q [n_ch, n_sym] f32 (soft != 0). The composite table [period, n_o]:
// the device array table, and tab, a host pointer to it in a modem::Taps
// where it fits, else null. Config #4's tables ((1, 12, 112) and (3, 16,
// 71)) take the core, every other table the long route.
int modem_resampled_rx(const float* wi, const float* wq, long long n_ch,
                       long long n_wave, long long n_sym, const void* tab,
                       const float* table, int period, int width, int n_o,
                       int first, const float* lut, int n_points, int soft,
                       int* out_sym, float* out_i, float* out_q,
                       void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (period < 1 || width < 1 || n_o < 1 || (!soft && n_points < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (soft)
    return launch_rx<true>(wi, wq, n_ch, n_wave, n_sym, tab, table, period,
                           width, n_o, first, lut, n_points, nullptr, out_i,
                           out_q, s);
  return launch_rx<false>(wi, wq, n_ch, n_wave, n_sym, tab, table, period,
                          width, n_o, first, lut, n_points, out_sym, nullptr,
                          nullptr, s);
}

}  // extern "C"
