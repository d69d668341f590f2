// Windowed soft-decision Viterbi: replaces
// modem_tpu/ops/pallas_viterbi.py::_viterbi_kernel (K13), for every code
// shape ConvCode builds (K >= 2, any n) and any window length, in three
// routes that decide alike:
//
// * the warp route (viterbi_kernel): S <= 256, n <= 32, a warp's rows in
//   shared memory (below);
// * the block core (viterbi_block_core): 512 <= S <= 16384 and n <= 8, a
//   block a row, whole butterflies a thread (its notes are at the core);
// * the long route (viterbi_block_kernel), the block route's first
//   version: everything else (K >= 16, n > 8, and rows of S <= 256 past the
//   warp route's shared memory). One block decodes one row, its threads
//   (min(S, 1024), at least a warp) own the
//   states s = tid + threads*k, one __syncthreads a step. A transition's
//   code bits are computed, parity(r & g_j) for the register r = in_bit
//   << (K-1) | predecessor and generator g_j, so no 2^n table limits n.
//   The metrics live in shared memory while 2*S*4 bytes fit (K <= 15), in
//   a global scratch otherwise (K >= 16); the decisions, packed 32 to a
//   word, in shared memory while the window's fit, in a global scratch
//   otherwise, where the traceback reads them. The step's costs are read
//   from device memory (a broadcast through L1).
//
// The recursion of both is ConvCode._acs's: for target state s the
// predecessors are p0 = (2s) mod S and p0 | 1, the branch metric from
// predecessor d the sum of the step's costs lam[j] over the code bits j
// that transition emits (bitmask masks[d][s]), added in the order
// j = 0..n-1 from +0 with round-to-nearest adds, c_d = pm[p_d] + bm_d, the
// decision c1 < c0 (a tie takes the even predecessor) and the new metric
// the smaller. After padded step q the metrics are renormalised (minus
// their minimum) where q % 8 == 7: the JAX forms pad the window's front
// with zero-cost steps to a multiple of 8 (which leave the free start's
// zero metrics as they are), and the subtraction rounds, so the cadence is
// part of the result. The end state is the first minimum of pm + pin * 1e9
// * (s > 0); the traceback walks back one decision bit per step, bit =
// state >> (K-2), state = ((state << 1) & (S-1)) | dec[t][state]. Every
// value equals the plain version's (no fast math), so the decisions are
// bit-identical.
//
// The warp route. One warp holds whole butterflies in registers: the lane
// that owns butterfly b (predecessors 2b and 2b+1) computes both of its
// targets, b and b + S/2, so both candidates of both targets are in the
// lane. S = 64: one butterfly a lane, one row a warp. S = 128, 256: 2 and
// 4 butterflies a lane (b = lane + 32k). S = 2..32: one butterfly a lane
// and S/2 lanes a row, 64/S rows a warp (K = 3: 16), every reduction
// segmented to the row's lanes. Between steps each lane fetches its
// predecessors' metrics with two __shfl_syncs, each a permutation (the
// lanes that hold states 2b and 2b+1 as targets send one metric each
// round): no shared memory and no barrier in the recursion. Up to 64
// states a lane keeps its lo target's metric first on even lanes and its
// hi target's first on odd ones, so each round sends one register with no
// select. The branch sums come once a step from the step's costs in
// registers: with n compiled in ((S, n) = (64, 2), (64, 3), (4, 2)) each
// branch sum is n FMAs with 0/1 multipliers (fma(1, l, a) is the rounded
// add a + l and fma(0, l, a) is a for the finite costs here, so the sum is
// the masked one exactly); every other shape runs the same exchange with n
// and the mask tests at run time. The decisions of a step are ballots
// (S/32 words, two for S <= 64 with each row's field in them); lane q mod
// 32 keeps step q's words and the warp stores 32 steps together, up to 64
// states put back in state order (and, S <= 32, each row's S decisions
// side by side) by a few bit operations a stored word. The renormalising
// minimum and the end state's first minimum are xor-shuffle reductions
// within the row's lanes (a whole warp's minimum one REDUX). The traceback
// reads a step's word at an address that does not depend on the state (S
// <= 64), so the loads run ahead of the state's chain of two to four
// integer operations a step; it stops at the 8-step group of the window's
// first output, and each row's lanes hold 32 steps of bits that the warp
// writes as 32 consecutive outputs.
//
// Where a row's costs come from: rows wi * n_ch + c read channel c of a
// stream [n_ch, t_stream, n] at steps wi*block - halo + p, with the guard
// cost outside [0, t_stream): the overlapping windows of a terminated
// stream, built here and never in device memory. A batch of ready windows
// is the same with n_win = 1, block = halo = 0 and t_stream = t_w. Before
// the recursion the warp stages its rows' costs (the front padding's zero
// steps included) into shared memory with 16-byte cp.asyncs where the row
// lies inside the stream and guard values only on the flanks: the
// recursion then reads 8 steps' costs with a few 16-byte shared loads, and
// no element's index is divided by n. (Streaming the costs in by chunks
// while the recursion runs would save shared memory, but the staged row
// and its decisions already fit every row bench_fec and the links launch
// in one wave, and the recursion, not the load, sets the time.)
//
// A warp's shared memory is laid out by the caller
// (ops/viterbi_kernel.py::row_layout, which also picks the route): rows of
// cost_floats each from 0, the decision words at dec_off. A block holds 1,
// 2 or 4 warps, whichever leaves the fewest warps on the busiest SM
// (bench_fec's 2304 rows and the link's 768 fit one wave). The block
// route's placement comes from ops/viterbi_kernel.py::block_plan.
//
// What bounds it on this card: a row is t_w dependent steps of a shuffle,
// a select, an add, a compare and a select, and only about 4 operations a
// state-step (the f32 bound at 67 TFLOP/s is ~6 us at bench_fec's 2304
// rows of 652 steps x 64 states). Where the card holds many rows
// (bench_fec: 4-5 warps a scheduler) a scheduler's throughput sets the
// time: a step at (64, 2) is 24 warp instructions, most of them selects,
// compares, votes and shuffles, and takes about 46 cycles of its
// scheduler; with few rows (the link, K = 3) the chain of a step, about
// 70 cycles, does. The block core holds a row of up to 16384 states in one
// SM: each step reads and writes every metric in shared memory, so the SM's
// shared-memory pipe (128 bytes a cycle) sets a step, not the f32 rate. The
// long route spends a barrier a step, recomputes the branch sums for each
// state and reads each step's costs and, past shared memory, its metrics
// and decisions from device memory (L2 at these sizes): a simple first
// version, not tuned.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kBlockWarps = 4;  // the warp route's warps a block: one a scheduler
constexpr int kRenorm = 8;
constexpr float kBig = 1e9f;
constexpr unsigned kFull = 0xffffffffu;

struct Geometry {
  long long n_ch, t_stream, block, n_win, out_stride;
  int n, n_states, km2, t_w, halo, out_lo, out_hi;
  float guard;
  int sym;  // the warp route's: the code's transitions mirror (see below)
};

// The warp route's shared memory for one warp, in floats, as the caller
// laid it out: `rows` rows' costs of cost_floats each from 0 (`pad`
// zero-cost steps, then the window's t_w; steps = t_w + pad, a multiple of
// 8), the decision words of the warp's `steps` steps at dec_off,
// warp_floats in all; a block's warps one after another. The traceback
// walks down to padded step q_stop (the 8-step group of the window's first
// output), not further.
struct WarpLayout {
  int rows, cost_floats, dec_off, warp_floats, pad, steps, q_stop;
};

constexpr int log2i(int v) { return v > 1 ? 1 + log2i(v / 2) : 0; }

// The compile-time shape of the warp route for S states.
template <int S>
struct Shape {
  static constexpr int kHalf = S / 2;                // butterflies
  static constexpr bool kSeg = S <= 64;              // one butterfly a lane
  static constexpr int kSlots = kSeg ? 1 : S / 64;   // butterflies a lane
  static constexpr int kLanes = kSeg ? kHalf : kWarp;  // lanes a row
  static constexpr int kRows = kWarp / kLanes;       // rows a warp, at most
  static constexpr int kWords = kSeg ? 2 : S / 32;   // decision words a step
  static constexpr int kKm2 = log2i(S) - 1;         // K - 2
  // S <= 32: rows whose S decisions (in state order) one stored word holds
  static constexpr int kRowsAWord = S <= 32 ? kWarp / S : 1;
  // the lanes whose first metric is their lo target (y even; S = 2: all)
  static constexpr unsigned kEven = kLanes >= 2 ? 0x55555555u : kFull;
};

// One row's costs into shared memory `dst` by the row's G lanes (this
// one is lane `lane` of them): `pad` zero steps, then the window's steps
// start .. start + t_w - 1 of channel c, the guard outside [0, t_stream).
// The part inside the stream goes by cp.async, 16 bytes at a time where
// the stream and the row agree modulo 16 bytes, else element by element;
// the caller commits and waits.
template <int G>
__device__ void stage_row(const float* __restrict__ lam, const Geometry& g,
                          const WarpLayout& w, long long c, long long start,
                          float* dst, int lane) {
  const int n = g.n;
  const long long lo_ll = start < 0 ? -start : 0;
  const int p_lo = static_cast<int>(lo_ll < g.t_w ? lo_ll : g.t_w);
  const long long room = g.t_stream - start;
  const int p_hi = static_cast<int>(
      room < p_lo ? p_lo : (room < g.t_w ? room : g.t_w));
  const int m0 = w.pad * n, m_lo = m0 + p_lo * n, m_hi = m0 + p_hi * n;
  const int m_end = w.steps * n;
  for (int m = lane; m < m0; m += G) dst[m] = 0.f;
  for (int m = m0 + lane; m < m_lo; m += G) dst[m] = g.guard;
  for (int m = m_hi + lane; m < m_end; m += G) dst[m] = g.guard;
  const int len = m_hi - m_lo;
  if (len <= 0) return;
  const float* src = lam + (c * g.t_stream + start + p_lo) * n;
  float* out = dst + m_lo;
  int head = len, body = 0;
  if (((reinterpret_cast<uintptr_t>(src) ^
        reinterpret_cast<uintptr_t>(out)) & 15) == 0) {
    head = ((16 - static_cast<int>(reinterpret_cast<uintptr_t>(src) & 15)) &
            15) >> 2;
    if (head > len) head = len;
    body = (len - head) >> 2;
  }
#pragma unroll 4
  for (int i = lane; i < body; i += G)
    modem::cp_async16(out + head + 4 * i, src + head + 4 * i);
  for (int i = lane; i < head; i += G) modem::cp_async4(out + i, src + i);
  for (int i = head + 4 * body + lane; i < len; i += G)
    modem::cp_async4(out + i, src + i);
}

// Metric i of a lane's 2 * kSlots (S >= 128): the lo targets (slots 0 ..
// kSlots-1), then the hi ones.
template <int KB>
__device__ __forceinline__ float held(const float (&lo)[KB],
                                      const float (&hi)[KB], int i) {
  return i < KB ? lo[i] : hi[i - KB];
}

// The minimum of v over the L lanes of each row (xor-shuffle levels; a
// whole warp's by one REDUX on integers that order as the floats do:
// v's bits, the magnitude flipped where the sign is set).
template <int L>
__device__ __forceinline__ float row_min(float v) {
  if constexpr (L == kWarp) {
    int b = __float_as_int(v);
    b ^= (b >> 31) & 0x7fffffff;
    b = __reduce_min_sync(kFull, b);
    return __int_as_float(b ^ ((b >> 31) & 0x7fffffff));
  } else {
#pragma unroll
    for (int off = L / 2; off > 0; off >>= 1)
      v = fminf(v, __shfl_xor_sync(kFull, v, off, L));
    return v;
  }
}

// The 16 low bits of x spread over 32, H-bit chunk i to chunk 2i.
template <int H>
__device__ __forceinline__ unsigned spread(unsigned x) {
  x &= 0xffffu;
  if constexpr (H <= 8) x = (x | (x << 8)) & 0x00ff00ffu;
  if constexpr (H <= 4) x = (x | (x << 4)) & 0x0f0f0f0fu;
  if constexpr (H <= 2) x = (x | (x << 2)) & 0x33333333u;
  if constexpr (H <= 1) x = (x | (x << 1)) & 0x55555555u;
  return x;
}

// S states; N code bits a step compiled in, for a code whose generators
// all tap the newest and the oldest register bit alike (g.sym: then the
// transitions into b + S/2 emit what those into b emit from the other
// predecessor, and a lane needs two branch sums, not four); N = 0: n and
// the symmetry at run time.
template <int S, int N>
__global__ void __launch_bounds__(kWarp * kBlockWarps, 4)
viterbi_kernel(const float* __restrict__ lam, const float* __restrict__ pin,
               const int* __restrict__ masks, Geometry g, WarpLayout w,
               int* __restrict__ out) {
  using Sh = Shape<S>;
  constexpr int H = Sh::kHalf, KB = Sh::kSlots, L = Sh::kLanes;
  constexpr int DW = Sh::kWords;
  extern __shared__ float4 smem4[];
  const int lane = threadIdx.x & (kWarp - 1);
  const long long rows = g.n_ch * g.n_win;
  const long long row0 =
      (static_cast<long long>(blockIdx.x) * (blockDim.x / kWarp) +
       threadIdx.x / kWarp) * w.rows;
  if (row0 >= rows) return;  // a whole warp
  float* const sm = reinterpret_cast<float*>(smem4) +
                    (threadIdx.x / kWarp) * w.warp_floats;
  unsigned* const dec = reinterpret_cast<unsigned*>(sm + w.dec_off);

  // this lane's row (wi * n_ch + c) and its butterflies y + 32k; the
  // row's L lanes stage its costs, every row's in flight at once
  const int r_me = Sh::kRows == 1 ? 0 : lane / L;
  const int y = lane & (L - 1);
  const bool live = r_me < w.rows && row0 + r_me < rows;
  const float* crow = sm + (live ? r_me : 0) * w.cost_floats;
  float pin_v = 0.f;
  if (live) {
    long long c = row0 % g.n_ch + r_me, wi = row0 / g.n_ch;
    if (c >= g.n_ch) {
      wi += c / g.n_ch;
      c %= g.n_ch;
    }
    stage_row<L>(lam, g, w, c, wi * g.block - g.halo,
                 sm + r_me * w.cost_floats, y);
    pin_v = pin != nullptr ? pin[row0 + r_me]
                           : (wi == g.n_win - 1 ? 1.f : 0.f);
  }
  modem::cp_async_commit();
  // A lane keeps two metrics a slot, fst and snd. S >= 128: the lo and the
  // hi target of butterfly y + 32k. S <= 64: the lo target first on even
  // lanes (y even) and the hi target first on odd ones, so that each
  // shuffle round below sends one register; the decision words are put
  // back in state order when they are stored.
  const bool odd = y & 1;
  const bool swap = KB == 1 && odd;
  int mk[KB][4];  // masks of fst's even and odd, snd's even and odd branch
#pragma unroll
  for (int k = 0; k < KB; ++k) {
    const int b = y + kWarp * k;
    const int lo0 = masks[b], lo1 = masks[S + b];
    const int hi0 = masks[b + H], hi1 = masks[S + b + H];
    mk[k][0] = swap ? hi0 : lo0;
    mk[k][1] = swap ? hi1 : lo1;
    mk[k][2] = swap ? lo0 : hi0;
    mk[k][3] = swap ? lo1 : hi1;
  }
  constexpr int NM = N > 0 ? N : 1;
  float mul[KB][2][NM];  // the 0/1 multipliers of the two branch sums
#pragma unroll
  for (int k = 0; k < KB; ++k)
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int j = 0; j < NM; ++j)
        mul[k][t][j] = static_cast<float>((mk[k][t] >> j) & 1);
  // the exchange: two shuffles a slot, each a permutation. The lane that
  // holds states 2b and 2b + 1 as targets is 2y and 2y + 1 of the row (mod
  // L): lo targets for the lower half of the lanes, hi for the upper (for
  // S >= 128, slots 2k and 2k + 1 of those lanes). Round A reads lane
  // 2y + up, which sends its hi (odd lanes) or lo (even): S <= 64 its fst;
  // round B lane 2y + !up, which sends the other.
  const bool up = Sh::kSeg ? 2 * y >= H : lane >= 16;
  const int src_a = 2 * y + (up ? 1 : 0), src_b = 2 * y + (up ? 0 : 1);

  float fst[KB], snd[KB];
#pragma unroll
  for (int k = 0; k < KB; ++k) fst[k] = snd[k] = 0.f;  // free start
  unsigned keep[DW];
#pragma unroll
  for (int i = 0; i < DW; ++i) keep[i] = 0u;
  modem::cp_async_wait<0>();
  __syncwarp();

  for (int q0 = 0; q0 < w.steps; q0 += kRenorm) {
    float cst[kRenorm * NM];
    if constexpr (N > 0) {
      const float4* c4 = reinterpret_cast<const float4*>(crow + q0 * N);
#pragma unroll
      for (int i = 0; i < 2 * N; ++i) {
        const float4 v = c4[i];
        cst[4 * i] = v.x;
        cst[4 * i + 1] = v.y;
        cst[4 * i + 2] = v.z;
        cst[4 * i + 3] = v.w;
      }
    }
    const int rel = lane - (q0 & (kWarp - 1));  // keeps step q0 + rel
#pragma unroll
    for (int i = 0; i < kRenorm; ++i) {
      float pe[KB], po[KB];
#pragma unroll
      for (int k = 0; k < KB; ++k) {
        float sa, sb;
        if constexpr (KB == 1) {
          sa = fst[0];
          sb = snd[0];
        } else {
          const float v0 = held<KB>(fst, snd, 2 * k);
          const float v1 = held<KB>(fst, snd, 2 * k + 1);
          sa = odd ? v1 : v0;
          sb = odd ? v0 : v1;
        }
        const float ra = __shfl_sync(kFull, sa, src_a, L);
        const float rb = __shfl_sync(kFull, sb, src_b, L);
        pe[k] = up ? rb : ra;
        po[k] = up ? ra : rb;
      }
      float bm[KB][4];
      if constexpr (N > 0) {
#pragma unroll
        for (int k = 0; k < KB; ++k)
#pragma unroll
          for (int t = 0; t < 2; ++t) {
            float a = __fmaf_rn(mul[k][t][0], cst[i * N], 0.f);
#pragma unroll
            for (int j = 1; j < N; ++j)
              a = __fmaf_rn(mul[k][t][j], cst[i * N + j], a);
            bm[k][t] = a;
            bm[k][3 - t] = a;
          }
      } else {
#pragma unroll
        for (int k = 0; k < KB; ++k)
#pragma unroll
          for (int t = 0; t < 4; ++t) bm[k][t] = 0.f;
        const float* lp = crow + (q0 + i) * g.n;
        for (int j = 0; j < g.n; ++j) {
          const float l = lp[j];
#pragma unroll
          for (int k = 0; k < KB; ++k)
#pragma unroll
            for (int t = 0; t < 2; ++t)
              if ((mk[k][t] >> j) & 1) bm[k][t] = __fadd_rn(bm[k][t], l);
          if (!g.sym) {
#pragma unroll
            for (int k = 0; k < KB; ++k)
#pragma unroll
              for (int t = 2; t < 4; ++t)
                if ((mk[k][t] >> j) & 1) bm[k][t] = __fadd_rn(bm[k][t], l);
          }
        }
        if (g.sym) {
#pragma unroll
          for (int k = 0; k < KB; ++k) {
            bm[k][2] = bm[k][1];
            bm[k][3] = bm[k][0];
          }
        }
      }
      unsigned word[DW];
#pragma unroll
      for (int k = 0; k < KB; ++k) {
        const float c0 = __fadd_rn(pe[k], bm[k][0]);
        const float c1 = __fadd_rn(po[k], bm[k][1]);
        const float e0 = __fadd_rn(pe[k], bm[k][2]);
        const float e1 = __fadd_rn(po[k], bm[k][3]);
        const bool dl = c1 < c0, dh = e1 < e0;
        fst[k] = dl ? c1 : c0;
        snd[k] = dh ? e1 : e0;
        word[k] = __ballot_sync(kFull, dl);
        word[DW / 2 + k] = __ballot_sync(kFull, dh);
      }
      if (rel == i) {
#pragma unroll
        for (int d = 0; d < DW; ++d) keep[d] = word[d];
      }
    }
    // renormalise after padded step q0 + 7
    float mn = fminf(fst[0], snd[0]);
#pragma unroll
    for (int k = 1; k < KB; ++k) mn = fminf(mn, fminf(fst[k], snd[k]));
    mn = row_min<L>(mn);
#pragma unroll
    for (int k = 0; k < KB; ++k) {
      fst[k] = __fsub_rn(fst[k], mn);
      snd[k] = __fsub_rn(snd[k], mn);
    }
    // the warp stores 32 steps' decision words, lane l those of step qb + l
    const int qn = q0 + kRenorm;
    if ((qn & (kWarp - 1)) == 0 || qn >= w.steps) {
      const int qb = q0 & ~(kWarp - 1);
      if (qb + lane < w.steps) {
        unsigned* dst = dec + (qb + lane) * DW;
        if constexpr (KB == 1) {
          // the lo and the hi targets' ballots (bit = lane), then, S <= 32,
          // each row's S decisions side by side (word 0: the first
          // kRowsAWord rows)
          constexpr unsigned E = Sh::kEven;
          const unsigned lo_w = (keep[0] & E) | (keep[1] & ~E);
          const unsigned hi_w = (keep[1] & E) | (keep[0] & ~E);
          uint2 v = make_uint2(lo_w, hi_w);
          if constexpr (S <= 32) {
            v.x = spread<H>(lo_w) | (spread<H>(hi_w) << H);
            v.y = spread<H>(lo_w >> 16) | (spread<H>(hi_w >> 16) << H);
          }
          *reinterpret_cast<uint2*>(dst) = v;
        } else {
#pragma unroll
          for (int d = 0; d < DW; d += 4)
            *reinterpret_cast<uint4*>(dst + d) =
                make_uint4(keep[d], keep[d + 1], keep[d + 2], keep[d + 3]);
        }
      }
    }
  }

  // end state: the first minimum of the (pinned) final metrics, the
  // states in increasing order (the lo slots, then the hi ones)
  float lo[KB], hi[KB];
#pragma unroll
  for (int k = 0; k < KB; ++k) {
    lo[k] = swap ? snd[k] : fst[k];
    hi[k] = swap ? fst[k] : snd[k];
  }
  const float pb = __fmul_rn(pin_v, kBig);
  float best = __int_as_float(0x7f800000);
  int best_s = S;
#pragma unroll
  for (int i = 0; i < 2 * KB; ++i) {
    const int s = y + kWarp * (i % KB) + (i < KB ? 0 : H);
    const float val = __fadd_rn(held<KB>(lo, hi, i),
                                __fmul_rn(pb, s > 0 ? 1.f : 0.f));
    if (val < best) {
      best = val;
      best_s = s;
    }
  }
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1) {
    const float ob = __shfl_xor_sync(kFull, best, off, L);
    const int os = __shfl_xor_sync(kFull, best_s, off, L);
    if (ob < best || (ob == best && os < best_s)) {
      best = ob;
      best_s = os;
    }
  }
  __syncwarp();  // every lane's decision words are stored

  // traceback: a row's lanes walk it together from the top step down to
  // q_stop, shifting each step's bit into acc, so that after a 32-step
  // block (or the last, partial one) bit q - q0 is step q's; the row's
  // lane 0 keeps the block's bits in the row's cost space, bit q % 32 of
  // word q / 32. The decision words' addresses do not depend on the state
  // (S <= 64), so their loads run ahead of the state's chain.
  unsigned* const bits =
      reinterpret_cast<unsigned*>(sm + (live ? r_me : 0) * w.cost_floats);
  int state = best_s;
  unsigned acc = 0u;
  const int t_word = r_me / Sh::kRowsAWord;              // S <= 32
  const int t_shift = (r_me % Sh::kRowsAWord) * S;
  for (int q0 = w.steps - kRenorm; q0 >= w.q_stop; q0 -= kRenorm) {
#pragma unroll
    for (int i = kRenorm - 1; i >= 0; --i) {
      const int q = q0 + i;
      acc = (acc << 1) | static_cast<unsigned>(state >> Sh::kKm2);
      unsigned d;
      if constexpr (S <= 32) {
        const unsigned f = dec[2 * q + t_word] >> t_shift;
        d = (f >> state) & 1u;
      } else if constexpr (S == 64) {
        const uint2 wd = reinterpret_cast<const uint2*>(dec)[q];
        const unsigned sel = (state & H) ? wd.y : wd.x;
        d = (sel >> (state & (H - 1))) & 1u;
      } else {
        const unsigned wd = dec[q * DW + ((state >> 5) & (DW - 1))];
        d = (wd >> (state & 31)) & 1u;
      }
      state = ((state << 1) & (S - 1)) | static_cast<int>(d);
    }
    if ((q0 & (kWarp - 1)) == 0 || q0 == w.q_stop) {
      if (live && y == 0) bits[q0 / kWarp] = acc << (q0 & (kWarp - 1));
      acc = 0u;
    }
  }
  __syncwarp();

  // the warp writes each row's outputs, 32 consecutive ones at a time
  {
    long long c = row0 % g.n_ch, wi = row0 / g.n_ch;
    const int p_end = g.out_hi < g.t_w ? g.out_hi : g.t_w;
    for (int r = 0; r < w.rows && row0 + r < rows; ++r) {
      const unsigned* rb = reinterpret_cast<const unsigned*>(
          sm + r * w.cost_floats);
      int* orow = out + c * g.out_stride + wi * g.block - g.out_lo;
      for (int p = g.out_lo + lane; p < p_end; p += kWarp) {
        const int q = p + w.pad;
        orow[p] = static_cast<int>((rb[q / kWarp] >> (q & (kWarp - 1))) & 1u);
      }
      if (++c == g.n_ch) {
        c = 0;
        ++wi;
      }
    }
  }
}

template <int S, int N>
cudaError_t launch(const float* lam, const float* pin, const int* masks,
                   const Geometry& g, const WarpLayout& w, int* out,
                   cudaStream_t stream) {
  const size_t per_warp = static_cast<size_t>(w.warp_floats) * sizeof(float);
  const long long warps = (g.n_ch * g.n_win + w.rows - 1) / w.rows;
  int dev = 0, sms = 0, optin = 0;
  cudaError_t err = modem::current_device(dev);
  if (err == cudaSuccess) err = modem::device_limits(dev, sms, optin);
  if (err != cudaSuccess) return err;
  const size_t cap = static_cast<size_t>(optin);
  if (per_warp > cap) return cudaErrorInvalidValue;
  // warps a block: 1, 2 or 4, the one that puts the fewest warps on the
  // busiest SM (the SMs share the step's shuffles, votes and selects), the
  // larger of equals
  int per_block = 1;
  long long best = -1;
  for (int pb = 1; pb <= kBlockWarps; pb *= 2) {
    if (pb * per_warp > cap) break;
    const long long blocks = (warps + pb - 1) / pb;
    const long long busiest = (blocks + sms - 1) / sms * pb;
    if (best < 0 || busiest <= best) {
      best = busiest;
      per_block = pb;
    }
  }
  const size_t smem = per_block * per_warp;
  err = modem::allow_smem(viterbi_kernel<S, N>, smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (warps + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  viterbi_kernel<S, N><<<static_cast<unsigned>(blocks), kWarp * per_block,
                         smem, stream>>>(lam, pin, masks, g, w, out);
  return cudaGetLastError();
}

// The compiled (S, n) of the main paths (their codes' transitions
// mirror), else n and the symmetry at run time.
template <int S>
cudaError_t launch_n(const float* lam, const float* pin, const int* masks,
                     const Geometry& g, const WarpLayout& w, int* out,
                     cudaStream_t stream) {
  if constexpr (S == 64) {
    if (g.sym && g.n == 2)
      return launch<64, 2>(lam, pin, masks, g, w, out, stream);
    if (g.sym && g.n == 3)
      return launch<64, 3>(lam, pin, masks, g, w, out, stream);
  }
  if constexpr (S == 4) {
    if (g.sym && g.n == 2)
      return launch<4, 2>(lam, pin, masks, g, w, out, stream);
  }
  return launch<S, 0>(lam, pin, masks, g, w, out, stream);
}

// ---- the block route ----

constexpr int kMaxBlock = 1024;

// The block route's placement of one row: shared memory holds the
// generators (n ints), the reduction slots (2 x 32 words), then the two
// metric buffers (pm_smem) and the decisions (dec_smem); what is not there
// is in the global scratch, pm_g [rows, 2, S] and dec_g [rows, t_w, words]
// for the n_rows rows of this launch.
struct BlockPlan {
  int threads, pm_smem, dec_smem;
  long long row0, n_rows;
};

__device__ __forceinline__ float step_cost(const float* src, long long s,
                                           int j, const Geometry& g) {
  return (s >= 0 && s < g.t_stream) ? src[s * g.n + j] : g.guard;
}

// Block-wide min of v (every thread calls it; slots >= 32 floats).
__device__ float block_min(float v, float* slots) {
  const int lane = threadIdx.x & (kWarp - 1), warp = threadIdx.x / kWarp;
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1)
    v = fminf(v, __shfl_xor_sync(kFull, v, off));
  if (lane == 0) slots[warp] = v;
  __syncthreads();
  const int n_warps = (blockDim.x + kWarp - 1) / kWarp;
  v = lane < n_warps ? slots[lane] : __int_as_float(0x7f800000);
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1)
    v = fminf(v, __shfl_xor_sync(kFull, v, off));
  __syncthreads();  // the slots are reused
  return v;
}

// Block-wide first minimum: the smallest value, of equal values the lowest
// state.
__device__ void block_argmin(float& v, int& s, float* fslots, int* islots) {
  const int lane = threadIdx.x & (kWarp - 1), warp = threadIdx.x / kWarp;
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(kFull, v, off);
    const int os = __shfl_xor_sync(kFull, s, off);
    if (ov < v || (ov == v && os < s)) {
      v = ov;
      s = os;
    }
  }
  if (lane == 0) {
    fslots[warp] = v;
    islots[warp] = s;
  }
  __syncthreads();
  const int n_warps = (blockDim.x + kWarp - 1) / kWarp;
  v = lane < n_warps ? fslots[lane] : __int_as_float(0x7f800000);
  s = lane < n_warps ? islots[lane] : 0x7fffffff;
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(kFull, v, off);
    const int os = __shfl_xor_sync(kFull, s, off);
    if (ov < v || (ov == v && os < s)) {
      v = ov;
      s = os;
    }
  }
}

__global__ void __launch_bounds__(kMaxBlock)
viterbi_block_kernel(const float* __restrict__ lam,
                     const float* __restrict__ pin,
                     const int* __restrict__ polys, Geometry g, BlockPlan b,
                     float* __restrict__ pm_g, unsigned* __restrict__ dec_g,
                     int* __restrict__ out) {
  extern __shared__ float4 smem4[];
  const long long local = blockIdx.x;
  const long long row = b.row0 + local;
  const long long c = row % g.n_ch;
  const long long wi = row / g.n_ch;
  const int n_s = g.n_states, n = g.n, t_w = g.t_w, nt = blockDim.x;
  const int words = n_s < kWarp ? 1 : n_s / kWarp;
  const unsigned live = n_s < kWarp ? (1u << n_s) - 1u : kFull;
  const int lane = threadIdx.x & (kWarp - 1);

  int* spolys = reinterpret_cast<int*>(smem4);
  float* fslots = reinterpret_cast<float*>(spolys + n);
  int* islots = reinterpret_cast<int*>(fslots + kWarp);
  float* after = reinterpret_cast<float*>(islots + kWarp);
  float* pmb = b.pm_smem ? after : pm_g + local * 2 * n_s;
  unsigned* dec = b.dec_smem ? reinterpret_cast<unsigned*>(after + 2 * n_s)
                             : dec_g + local * t_w * words;
  for (int j = threadIdx.x; j < n; j += nt) spolys[j] = polys[j];
  for (int s = threadIdx.x; s < n_s; s += nt) pmb[s] = 0.f;  // free start
  __syncthreads();

  const float* src = lam + c * g.t_stream * n;
  const long long start = wi * g.block - g.halo;
  const int km1 = g.km2 + 1;
  int cur = 0;
  for (int p = 0; p < t_w; ++p) {
    const float* pm = pmb + cur * n_s;
    float* nx = pmb + (cur ^ 1) * n_s;
    float mn = __int_as_float(0x7f800000);
    for (int s0 = threadIdx.x - lane; s0 < n_s; s0 += nt) {  // whole warps
      const int s = s0 + lane;
      bool d = false;
      if (s < n_s) {
        const int p0 = (s << 1) & (n_s - 1);
        const unsigned r0 = (static_cast<unsigned>(s >> g.km2) << km1) |
                            static_cast<unsigned>(p0);
        float bm0 = 0.f, bm1 = 0.f;
        for (int j = 0; j < n; ++j) {
          const float l = step_cost(src, start + p, j, g);
          const unsigned gj = static_cast<unsigned>(spolys[j]);
          if (__popc(r0 & gj) & 1) bm0 = __fadd_rn(bm0, l);
          if (__popc((r0 | 1u) & gj) & 1) bm1 = __fadd_rn(bm1, l);
        }
        const float c0 = __fadd_rn(pm[p0], bm0);
        const float c1 = __fadd_rn(pm[p0 | 1], bm1);
        d = c1 < c0;
        const float v = d ? c1 : c0;
        nx[s] = v;
        mn = fminf(mn, v);
      }
      const unsigned w = __ballot_sync(kFull, d) & live;
      if (lane == 0) dec[p * words + (s0 >> 5)] = w;
    }
    if ((t_w - 1 - p) % kRenorm == 0) {
      mn = block_min(mn, fslots);
      for (int s = threadIdx.x; s < n_s; s += nt) nx[s] = __fsub_rn(nx[s], mn);
    }
    __syncthreads();
    cur ^= 1;
  }

  // end state: the first minimum of the (pinned) final metrics
  const float pin_v = pin != nullptr ? pin[row]
                                     : (wi == g.n_win - 1 ? 1.f : 0.f);
  const float* pm = pmb + cur * n_s;
  float best = __int_as_float(0x7f800000);
  int best_s = 0x7fffffff;
  for (int s = threadIdx.x; s < n_s; s += nt) {
    const float bias = __fmul_rn(__fmul_rn(pin_v, kBig), s > 0 ? 1.f : 0.f);
    const float val = __fadd_rn(pm[s], bias);
    if (val < best) {
      best = val;
      best_s = s;
    }
  }
  block_argmin(best, best_s, fslots, islots);

  // traceback by the first warp, as the warp route's
  if (threadIdx.x >= kWarp) return;
  int state = best_s;
  int my_bit = 0;
  int* orow = out + c * g.out_stride + wi * g.block;
  for (int p = t_w - 1; p >= 0; --p) {
    const int bit = state >> g.km2;
    const unsigned w = dec[p * words + (state >> 5)];
    state = ((state << 1) & (n_s - 1)) | static_cast<int>((w >> (state & 31)) & 1u);
    if ((p & (kWarp - 1)) == lane) my_bit = bit;
    if ((p & (kWarp - 1)) == 0) {
      const int q = p + lane;
      if (q < t_w && q >= g.out_lo && q < g.out_hi) orow[q - g.out_lo] = my_bit;
    }
  }
}

// ---- the block core ----
//
// One block a row for S = 512 .. 16384 states and n <= 8 code bits, both
// metric buffers in shared memory. Thread t of T = min(S/2, 512) owns KB
// = S / (2T) whole butterflies, b = (warp*KB + k)*32 + lane: it reads the
// predecessors 2b and 2b+1 as one 8-byte shared load (consecutive lanes,
// consecutive pairs: no bank conflict) and writes the targets b and b +
// S/2. Up to 2 butterflies a thread the targets' ballots over the warp are
// decision words k and S/64 + k of the warp's run, in state order; with 4,
// 8 and 16 (S >= 4096) each thread packs its 2*KB decisions into a byte, a
// halfword or a word instead, which the traceback indexes (core_decision).
// The metrics ping-pong between two buffers, one __syncthreads a step.
//
// Branch sums once a step: the 2^n sums T[m] (T[m] = +0 plus cost j for
// each set bit j of m, in the order j = 0..n-1, as the first version adds
// them) are formed for step p+1 by 2^n threads at the start of step p, into
// one of two tables. A butterfly's four transitions emit the code-bit
// patterns m = M(2b), m^X, m^Y and m^X^Y (M the generators' parity map, X
// = M(1) the bits whose generator taps the newest register bit, Y = M(S)
// those that tap the oldest), so table entry m holds (T[m], T[m^X],
// T[m^Y], T[m^X^Y]) and a butterfly reads its four sums with one 16-byte
// load (8 bytes where the code is symmetric, Y = X), at a word offset
// computed once at the start.
//
// The renormalisation is folded into the recursion: the renormalising
// step's warps put their minimum in a slot, and the next step subtracts
// the block minimum from each metric it reads (the same __fsub_rn before
// the same __fadd_rn as the first version); the end-state search
// subtracts it too. A step's costs come from a chunk of 8 steps copied into
// shared memory by cp.async 8 steps ahead. A step's decisions are staged in
// shared memory (a warp's ballot words by its lane 0 in one store, or each
// thread's packed bits), and every 8 steps the whole block writes the
// group to the global scratch in 16-byte pieces, from the first step the
// traceback reads (out_lo) on. After the end state is chosen the metric
// buffers are free: the block pages the decisions back into them, 32 steps
// a half, newest first, by 16-byte cp.asyncs, and the first warp walks one
// half from shared memory while the next half loads.
//
// What bounds it: a step reads and writes every metric in shared memory
// (128 KB at S = 16384) and reads a butterfly's sums, so the SM's
// shared-memory pipe, not its f32 rate, sets the step; one block holds a
// row, so a row's steps on one SM are the floor. Beside that, what a step
// does outside the recursion sits on its critical path once a step: the
// sums (hence made first, from two 16-byte loads), the decision words (hence
// packed bits past 2 butterflies a thread, not 2*KB ballots and their
// staged stores), the barrier; 512 threads leave each more registers to
// keep a butterfly's loads in flight than 1024 would.

constexpr int kCoreThreads = 512;   // a block's threads, at most
constexpr int kCorePreload = 4;     // butterflies whose loads go together
constexpr int kCoreGroup = 8;       // steps a cost chunk, a staged group
constexpr int kCostStride = 8;      // floats a step of a cost chunk (n <= 8)
constexpr int kCorePage = 32;       // traceback steps a half of the buffers
constexpr int kCoreMaxBits = 8;

// The core's shared memory, in words, for S states: the two metric
// buffers from 0, two sum tables (256 entries of 2 or 4 floats), two cost
// chunks, two groups of 8 steps' staged decisions (S/32 words a step), and
// 3 x 32 slots.
struct CoreSmem {
  int q, qbuf, cost, stage, slots, bytes;
};

__host__ __device__ inline CoreSmem core_smem(int n_states, bool sym) {
  CoreSmem m;
  m.q = 2 * n_states;
  m.qbuf = (1 << kCoreMaxBits) * (sym ? 2 : 4);
  m.cost = m.q + 2 * m.qbuf;
  m.stage = m.cost + 2 * kCoreGroup * kCostStride;
  m.slots = m.stage + 2 * kCoreGroup * n_states / kWarp;
  m.bytes = 4 * (m.slots + 3 * kWarp);
  return m;
}

// The rows of one launch and the decision steps the scratch holds:
// dec_g [n_rows, t_dec, S/32] words, steps d_lo .. d_lo + t_dec - 1.
struct CorePlan {
  long long row0;
  int d_lo, t_dec;
};

// The minimum of the W warps' slots, in every lane (a REDUX on integers
// that order as the floats do).
__device__ __forceinline__ float slots_min(const float* slots, int w) {
  const int lane = threadIdx.x & (kWarp - 1);
  int b = __float_as_int(lane < w ? slots[lane] : __int_as_float(0x7f800000));
  b ^= (b >> 31) & 0x7fffffff;
  b = __reduce_min_sync(kFull, b);
  return __int_as_float(b ^ ((b >> 31) & 0x7fffffff));
}

// A warp's KB ballot words (KB <= 2) as one store.
template <int KB>
__device__ __forceinline__ void put_words(unsigned* dst,
                                          const unsigned (&w)[KB]) {
  if constexpr (KB == 2)
    *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
  else
    dst[0] = w[0];
}

// What a thread of the core keeps from step to step.
struct CoreThread {
  float* sm;        // shared memory
  int n_states, half, b0, lane, warp, warps;
  CoreSmem l;
};

// One step's add-compare-select on metric buffer P: the targets into
// buffer P^1, the decision words into the staged row `st`; SUB: subtract
// mn from each metric read; MIN: the warp's minimum of the new metrics
// into its slot.
template <int KB, bool SYM, int P, bool SUB, bool MIN>
__device__ __forceinline__ void core_acs(const CoreThread& c,
                                         const int (&qa)[KB], float mn,
                                         unsigned* st) {
  const float2* rd =
      reinterpret_cast<const float2*>(c.sm + P * c.n_states) + c.b0;
  float* wlo = c.sm + (P ^ 1) * c.n_states + c.b0;
  float* whi = wlo + c.half;
  const float* q = c.sm + P * c.l.qbuf;
  constexpr bool kPack = KB >= 4;
  unsigned wl[KB], wh[KB], bits = 0u;
  float tmin = __int_as_float(0x7f800000);
  // a group's loads all go before its stores, which the compiler cannot
  // otherwise move them past (the buffers are one array to it)
  constexpr int G = KB < kCorePreload ? KB : kCorePreload;
  using Sums = typename std::conditional<SYM, float2, float4>::type;
#pragma unroll
  for (int k0 = 0; k0 < KB; k0 += G) {
    float2 prs[G];
    Sums sums[G];
#pragma unroll
    for (int i = 0; i < G; ++i) {
      prs[i] = rd[kWarp * (k0 + i)];
      sums[i] = *reinterpret_cast<const Sums*>(q + qa[k0 + i]);
    }
#pragma unroll
    for (int i = 0; i < G; ++i) {
      const int k = k0 + i;
      float a0 = prs[i].x, a1 = prs[i].y;
      if constexpr (SUB) {
        a0 = __fsub_rn(a0, mn);
        a1 = __fsub_rn(a1, mn);
      }
      float s00, s01, s10, s11;
      if constexpr (SYM) {
        s00 = s11 = sums[i].x;
        s01 = s10 = sums[i].y;
      } else {
        s00 = sums[i].x;
        s01 = sums[i].y;
        s10 = sums[i].z;
        s11 = sums[i].w;
      }
      const float c0 = __fadd_rn(a0, s00), c1 = __fadd_rn(a1, s01);
      const float e0 = __fadd_rn(a0, s10), e1 = __fadd_rn(a1, s11);
      const bool dl = c1 < c0, dh = e1 < e0;
      const float vl = dl ? c1 : c0, vh = dh ? e1 : e0;
      wlo[kWarp * k] = vl;
      whi[kWarp * k] = vh;
      if constexpr (kPack) {
        bits |= dl ? 1u << k : 0u;
        bits |= dh ? 1u << (KB + k) : 0u;
      } else {
        wl[k] = __ballot_sync(kFull, dl);
        wh[k] = __ballot_sync(kFull, dh);
      }
      if constexpr (MIN) tmin = fminf(tmin, fminf(vl, vh));
    }
  }
  if constexpr (kPack) {
    const int t = c.warp * kWarp + c.lane;
    if constexpr (KB == 16)
      st[t] = bits;
    else if constexpr (KB == 8)
      reinterpret_cast<unsigned short*>(st)[t] =
          static_cast<unsigned short>(bits);
    else
      reinterpret_cast<unsigned char*>(st)[t] =
          static_cast<unsigned char>(bits);
  } else if (c.lane == 0) {
    put_words<KB>(st + c.warp * KB, wl);
    put_words<KB>(st + c.half / kWarp + c.warp * KB, wh);
  }
  if constexpr (MIN) {
    int b = __float_as_int(tmin);
    b ^= (b >> 31) & 0x7fffffff;
    b = __reduce_min_sync(kFull, b);
    if (c.lane == 0)
      c.sm[c.l.slots + c.warp] = __int_as_float(b ^ ((b >> 31) & 0x7fffffff));
  }
}

// The decision bit of `state` in a step's row of S/32 words. KB <= 2:
// the ballots' words in state order. KB >= 4: thread t = warp*32 + lane
// keeps the 2*KB bits of its butterflies (b = (warp*KB + k)*32 + lane: lo
// target b at bit k, hi target b + S/2 at bit KB + k) in entry t of the row.
template <int KB>
__device__ __forceinline__ int core_decision(const unsigned* row, int state,
                                             int km2) {
  if constexpr (KB >= 4) {
    constexpr int kShift = KB == 16 ? 9 : KB == 8 ? 8 : 7;  // 5 + log2(KB)
    const int sh = state & ((1 << km2) - 1);
    const int t = ((sh >> kShift) << 5) | (sh & 31);
    const int bit = ((state >> km2) & 1) * KB + ((sh >> 5) & (KB - 1));
    unsigned v;
    if constexpr (KB == 16)
      v = row[t];
    else if constexpr (KB == 8)
      v = reinterpret_cast<const unsigned short*>(row)[t];
    else
      v = reinterpret_cast<const unsigned char*>(row)[t];
    return static_cast<int>((v >> bit) & 1u);
  } else {
    return static_cast<int>((row[state >> 5] >> (state & 31)) & 1u);
  }
}

template <int KB, bool SYM>
__global__ void __launch_bounds__(kCoreThreads, 1)
viterbi_block_core(const float* __restrict__ lam,
                   const float* __restrict__ pin,
                   const int* __restrict__ polys, Geometry g, CorePlan cp,
                   unsigned* __restrict__ dec_g, int* __restrict__ out) {
  extern __shared__ float4 smem4[];
  CoreThread c;
  c.sm = reinterpret_cast<float*>(smem4);
  c.n_states = g.n_states;
  c.half = g.n_states / 2;
  c.lane = threadIdx.x & (kWarp - 1);
  c.warp = threadIdx.x / kWarp;
  c.warps = blockDim.x / kWarp;
  c.b0 = c.warp * KB * kWarp + c.lane;
  c.l = core_smem(g.n_states, SYM);
  const int S = g.n_states, n = g.n, t_w = g.t_w, nt = blockDim.x;
  const int tid = threadIdx.x, words = S / kWarp;
  const long long row = cp.row0 + blockIdx.x;
  const long long ch = row % g.n_ch, wi = row / g.n_ch;
  const float* src = lam + ch * g.t_stream * n;
  const long long start = wi * g.block - g.halo;
  float* const cbuf = c.sm + c.l.cost;
  unsigned* const stage = reinterpret_cast<unsigned*>(c.sm + c.l.stage);
  unsigned* const scratch =
      dec_g + static_cast<long long>(blockIdx.x) * cp.t_dec * words;

  // the generators' bits X (newest register bit) and Y (oldest), and this
  // thread's table entries M(2b)
  unsigned gen[kCoreMaxBits];
  int xm = 0, ym = 0;
#pragma unroll
  for (int j = 0; j < kCoreMaxBits; ++j) {
    gen[j] = j < n ? static_cast<unsigned>(polys[j]) : 0u;
    xm |= static_cast<int>(gen[j] & 1u) << j;
    ym |= static_cast<int>((gen[j] >> (g.km2 + 1)) & 1u) << j;
  }
  constexpr int kEntry = SYM ? 2 : 4;
  int qa[KB];
#pragma unroll
  for (int k = 0; k < KB; ++k) {
    const unsigned r = 2u * static_cast<unsigned>(c.b0 + kWarp * k);
    int m = 0;
#pragma unroll
    for (int j = 0; j < kCoreMaxBits; ++j)
      m |= (__popc(r & gen[j]) & 1) << j;
    qa[k] = c.l.q + m * kEntry;
  }

  // chunk ci of costs (steps 8ci .. 8ci+7) into cost buffer ci & 1: thread
  // tid < 64 copies cost tid & 7 of step tid >> 3, the guard outside the
  // stream
  auto load_chunk = [&](int ci) {
    const int p = ci * kCoreGroup + (tid >> 3), j = tid & 7;
    if (p < t_w && j < n) {
      float* d = cbuf + (ci & 1) * kCoreGroup * kCostStride + (tid & 63);
      const long long s = start + p;
      if (s >= 0 && s < g.t_stream)
        modem::cp_async4(d, src + s * n + j);
      else
        *d = g.guard;
    }
  };
  // the sums of step p into table p & 1 by thread m < 2^n
  auto make_sums = [&](int p) {
    const int m = tid;
    // a step's 8 cost slots in two 16-byte loads; a mask's bits past n
    // are 0, so the slots past n (never written) are never added
    const float4* cs = reinterpret_cast<const float4*>(
        cbuf + ((p / kCoreGroup) & 1) * kCoreGroup * kCostStride +
        (p % kCoreGroup) * kCostStride);
    const float4 c0 = cs[0], c1 = cs[1];
    const float cv[kCoreMaxBits] = {c0.x, c0.y, c0.z, c0.w,
                                    c1.x, c1.y, c1.z, c1.w};
    auto sum = [&](int mask) {
      float a = 0.f;
#pragma unroll
      for (int j = 0; j < kCoreMaxBits; ++j)
        if ((mask >> j) & 1) a = __fadd_rn(a, cv[j]);
      return a;
    };
    float* e = c.sm + c.l.q + (p & 1) * c.l.qbuf + m * kEntry;
    if constexpr (SYM) {
      *reinterpret_cast<float2*>(e) = make_float2(sum(m), sum(m ^ xm));
    } else {
      *reinterpret_cast<float4*>(e) = make_float4(
          sum(m), sum(m ^ xm), sum(m ^ ym), sum(m ^ xm ^ ym));
    }
  };
  // staged group gi's steps from d_lo on, and below `p_end`, to the
  // scratch in 16-byte pieces (S/128 a step)
  const int pieces = S / 128, piece_shift = __ffs(pieces) - 1;
  auto flush = [&](int gi, int p_end) {
    const unsigned* sb = stage + (gi & 1) * kCoreGroup * words;
    for (int q = tid; q < kCoreGroup * pieces; q += nt) {
      const int i = q >> piece_shift, w4 = 4 * (q & (pieces - 1));
      const int p = gi * kCoreGroup + i;
      if (p >= cp.d_lo && p < p_end) {
        const uint4 v = *reinterpret_cast<const uint4*>(sb + i * words + w4);
        *reinterpret_cast<uint4*>(
            scratch + static_cast<long long>(p - cp.d_lo) * words + w4) = v;
      }
    }
  };

  // free start, the first chunk of costs, the first step's sums
  for (int s = tid; s < S; s += nt) c.sm[s] = 0.f;
  if (tid < kCoreGroup * kCostStride) {
    load_chunk(0);
    modem::cp_async_commit();
    modem::cp_async_wait<0>();
  }
  __syncthreads();
  if (tid < (1 << n)) make_sums(0);
  __syncthreads();

  auto step = [&](auto parity, int p) {
    constexpr int P = decltype(parity)::value;
    const bool rn = ((t_w - 1 - p) & (kRenorm - 1)) == 0;
    const bool sub = p > 0 && ((t_w - p) & (kRenorm - 1)) == 0;
    const float mn = sub ? slots_min(c.sm + c.l.slots, c.warps) : 0.f;
    if ((p & (kCoreGroup - 1)) == 0) {
      if (p > 0) flush(p / kCoreGroup - 1, t_w);
      if (tid < kCoreGroup * kCostStride) {
        if (p + kCoreGroup < t_w) load_chunk(p / kCoreGroup + 1);
        modem::cp_async_commit();
      }
    }
    if ((p & (kCoreGroup - 1)) == kCoreGroup - 2 &&
        tid < kCoreGroup * kCostStride)
      modem::cp_async_wait<0>();
    // the next step's sums first, off the step's tail: their table was
    // last read a barrier ago
    if (p + 1 < t_w && tid < (1 << n)) make_sums(p + 1);
    unsigned* st = stage + ((p / kCoreGroup) & 1) * kCoreGroup * words +
                   (p & (kCoreGroup - 1)) * words;
    if (sub)
      core_acs<KB, SYM, P, true, false>(c, qa, mn, st);
    else if (rn)
      core_acs<KB, SYM, P, false, true>(c, qa, mn, st);
    else
      core_acs<KB, SYM, P, false, false>(c, qa, mn, st);
    __syncthreads();
  };
  for (int p = 0; p < t_w; p += 2) {
    step(std::integral_constant<int, 0>(), p);
    if (p + 1 < t_w) step(std::integral_constant<int, 1>(), p + 1);
  }

  // the last step renormalised: its minimum is in the slots. The last
  // group to the scratch; the end state, the first minimum of the final
  // metrics less that minimum, pinned
  const float mn = slots_min(c.sm + c.l.slots, c.warps);
  flush((t_w - 1) / kCoreGroup, t_w);
  const float* fin = c.sm + (t_w & 1) * S;
  const float pin_v = pin != nullptr ? pin[row]
                                     : (wi == g.n_win - 1 ? 1.f : 0.f);
  const float pb = __fmul_rn(pin_v, kBig);
  float best = __int_as_float(0x7f800000);
  int best_s = 0;  // state 0 where no metric is below +inf, as argmin
  for (int s = tid; s < S; s += nt) {
    const float val =
        __fadd_rn(__fsub_rn(fin[s], mn), __fmul_rn(pb, s > 0 ? 1.f : 0.f));
    if (val < best) {
      best = val;
      best_s = s;
    }
  }
  float* const aslots = c.sm + c.l.slots + kWarp;
  block_argmin(best, best_s, aslots,
               reinterpret_cast<int*>(aslots + kWarp));

  // traceback: outputs lo .. hi-1 need the decisions of steps lo+1 ..
  // t_w-1, paged back newest first into the halves of the metric buffers
  const int lo = g.out_lo > 0 ? g.out_lo : 0;
  const int hi = g.out_hi < t_w ? g.out_hi : t_w;
  if (lo >= hi) return;
  const int top = t_w - 1;
  const int n_pages = (top - lo + kCorePage - 1) / kCorePage;
  auto load_page = [&](int j) {
    const int p_hi = top + 1 - kCorePage * j;
    const int cnt = min(kCorePage, p_hi - (lo + 1));
    unsigned* dst = reinterpret_cast<unsigned*>(c.sm) + (j & 1) * S;
    for (int q = tid; q < cnt * pieces; q += nt) {
      const int i = q >> piece_shift, w4 = 4 * (q & (pieces - 1));
      modem::cp_async16(dst + i * words + w4,
                        scratch + static_cast<long long>(p_hi - cnt + i -
                                                         cp.d_lo) * words + w4);
    }
    modem::cp_async_commit();
  };
  int state = best_s, my_bit = 0, p = top;
  int* orow = out + ch * g.out_stride + wi * g.block;
  auto keep = [&](bool last) {
    const int bit = state >> g.km2;
    if ((p & (kWarp - 1)) == c.lane) my_bit = bit;
    if ((p & (kWarp - 1)) == 0 || last) {
      const int qq = (p & ~(kWarp - 1)) + c.lane;
      if (qq >= lo && qq <= top && qq >= g.out_lo && qq < g.out_hi)
        orow[qq - g.out_lo] = my_bit;
    }
  };
  // page j + 1 loads while the first warp walks page j; the barrier at the
  // top of each round also keeps a load off the half still being walked
  if (n_pages > 0) load_page(0);
  for (int j = 0; j < n_pages; ++j) {
    modem::cp_async_wait<0>();
    __syncthreads();
    if (j + 1 < n_pages) load_page(j + 1);
    if (c.warp == 0) {
      const int p_hi = top + 1 - kCorePage * j;
      const int cnt = min(kCorePage, p_hi - (lo + 1));
      const unsigned* pg = reinterpret_cast<const unsigned*>(c.sm) + (j & 1) * S;
      for (int i = cnt - 1; i >= 0; --i, --p) {
        keep(false);
        state = ((state << 1) & (S - 1)) |
                core_decision<KB>(pg + i * words, state, g.km2);
      }
    }
  }
  if (c.warp == 0) keep(true);
}

template <int KB>
cudaError_t launch_core(const float* lam, const float* pin, const int* polys,
                        const Geometry& g, const CorePlan& cp, int sym,
                        unsigned* dec_g, int* out, long long n_rows,
                        cudaStream_t stream) {
  const int threads = g.n_states / (2 * KB);
  const size_t smem = static_cast<size_t>(core_smem(g.n_states, sym).bytes);
  auto kernel = sym ? viterbi_block_core<KB, true>
                    : viterbi_block_core<KB, false>;
  const cudaError_t err = modem::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(n_rows), threads, smem, stream>>>(
      lam, pin, polys, g, cp, dec_g, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// lam [n_ch, t_stream, n] f32 costs; pin [n_ch] f32 (with n_win == 1) or
// null (then the last window of each channel is pinned); masks [2, S]
// int32 code-bit masks; sym 1 where masks[0][s + S/2] == masks[1][s] and
// masks[1][s + S/2] == masks[0][s] (every generator taps the newest and
// the oldest register bit alike) -> for each row wi * n_ch + c the
// decisions at window steps out_lo <= p < out_hi into out[c * out_stride +
// wi * block + p - out_lo] int32; a warp's shared memory laid out as
// rows_per_warp, cost_floats, dec_off and warp_floats say (floats). Returns
// cudaGetLastError(), or cudaErrorInvalidValue where S is not a power of
// two in 2..256, n is not in 1..32, the layout does not hold what the
// kernel writes or a warp's does not fit the shared memory of one block.
int modem_viterbi(const float* lam, const float* pin, const int* masks,
                  long long n_ch, long long t_stream, int n, int n_states,
                  int km2, int sym, int t_w, int rows_per_warp,
                  int cost_floats, int dec_off, int warp_floats,
                  long long block, int halo, long long n_win, float guard,
                  int out_lo, int out_hi, long long out_stride, int* out,
                  void* stream) {
  if (n_ch * n_win == 0) return static_cast<int>(cudaSuccess);
  const int pad = (kRenorm - t_w % kRenorm) % kRenorm;
  const int steps = t_w + pad;
  const bool seg = n_states <= 64;
  const int rows_max = seg && n_states > 1 ? 64 / n_states : 1;
  const long long words = seg ? 2 : n_states / 32;
  if (n_states < 2 || n_states > 256 || (n_states & (n_states - 1)) ||
      km2 < 0 || km2 > 7 || (1 << (km2 + 1)) != n_states || n < 1 ||
      n > 32 || t_w < 1 || rows_per_warp < 1 || rows_per_warp > rows_max || cost_floats % 4 ||
      dec_off % 4 || static_cast<long long>(cost_floats) < 1LL * steps * n ||
      dec_off < 1LL * rows_per_warp * cost_floats ||
      warp_floats < dec_off + steps * words)
    return static_cast<int>(cudaErrorInvalidValue);
  const Geometry g{n_ch, t_stream, block, n_win, out_stride, n, n_states,
                   km2, t_w, halo, out_lo, out_hi, guard, sym != 0};
  const int q_stop = (pad + (out_lo > 0 ? out_lo : 0)) / kRenorm * kRenorm;
  const WarpLayout w{rows_per_warp, cost_floats, dec_off, warp_floats, pad,
                     steps, q_stop};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (n_states) {
    case 2: err = launch_n<2>(lam, pin, masks, g, w, out, s); break;
    case 4: err = launch_n<4>(lam, pin, masks, g, w, out, s); break;
    case 8: err = launch_n<8>(lam, pin, masks, g, w, out, s); break;
    case 16: err = launch_n<16>(lam, pin, masks, g, w, out, s); break;
    case 32: err = launch_n<32>(lam, pin, masks, g, w, out, s); break;
    case 64: err = launch_n<64>(lam, pin, masks, g, w, out, s); break;
    case 128: err = launch_n<128>(lam, pin, masks, g, w, out, s); break;
    default: err = launch_n<256>(lam, pin, masks, g, w, out, s); break;
  }
  return static_cast<int>(err);
}

// The block route for rows row0 .. row0 + n_rows - 1 of the same geometry:
// polys [n] int32 generators; threads a multiple of 32 up to 1024;
// smem_bytes the shared memory of one block as the caller laid it out
// (ops/viterbi_kernel.py::block_plan); pm_g [n_rows, 2, S] f32 and dec_g
// [n_rows, t_w, max(1, S/32)] words of scratch where pm_smem / dec_smem
// are 0 (null otherwise). Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a geometry it does not take.
int modem_viterbi_block(const float* lam, const float* pin, const int* polys,
                        long long n_ch, long long t_stream, int n,
                        int n_states, int km2, int t_w, int threads,
                        int pm_smem, int dec_smem, int smem_bytes,
                        long long row0, long long n_rows, float* pm_g,
                        unsigned* dec_g, long long block, int halo,
                        long long n_win, float guard, int out_lo, int out_hi,
                        long long out_stride, int* out, void* stream) {
  if (n_rows == 0) return static_cast<int>(cudaSuccess);
  if (threads < kWarp || threads > kMaxBlock || threads % kWarp ||
      n_states < 2 || (n_states & (n_states - 1)) || km2 > 30 ||
      n_rows > 0x7fffffffLL || (!pm_smem && pm_g == nullptr) ||
      (!dec_smem && dec_g == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Geometry g{n_ch, t_stream, block, n_win, out_stride, n, n_states,
                   km2, t_w, halo, out_lo, out_hi, guard, 0};
  const BlockPlan plan{threads, pm_smem, dec_smem, row0, n_rows};
  const cudaError_t err = modem::allow_smem(
      viterbi_block_kernel, static_cast<size_t>(smem_bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  viterbi_block_kernel<<<static_cast<unsigned>(n_rows), threads, smem_bytes,
                         static_cast<cudaStream_t>(stream)>>>(
      lam, pin, polys, g, plan, pm_g, dec_g, out);
  return static_cast<int>(cudaGetLastError());
}

// K13's block core for rows row0 .. row0 + n_rows - 1 of one geometry
// (512 <= S <= 16384, n <= 8): polys [n] int32 generators; sym 1 where
// every generator taps the newest and the oldest register bit alike;
// dec_g [n_rows, t_w - d_lo, S/32] words of scratch for the decisions of
// steps d_lo .. t_w-1 (null where d_lo == t_w), d_lo at most max(out_lo,
// 0); the rest as modem_viterbi_block. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a geometry it does not take.
int modem_viterbi_block_core(const float* lam, const float* pin,
                             const int* polys, long long n_ch,
                             long long t_stream, int n, int n_states, int km2,
                             int sym, int t_w, long long row0,
                             long long n_rows, unsigned* dec_g, int d_lo,
                             long long block, int halo, long long n_win,
                             float guard, int out_lo, int out_hi,
                             long long out_stride, int* out, void* stream) {
  if (n_rows == 0) return static_cast<int>(cudaSuccess);
  const int lo = out_lo > 0 ? (out_lo < t_w ? out_lo : t_w) : 0;
  if (n_states < 512 || n_states > 16384 || (n_states & (n_states - 1)) ||
      (1 << (km2 + 1)) != n_states || n < 1 || n > kCoreMaxBits ||
      t_w < 1 || n_rows > 0x7fffffffLL || d_lo < 0 || d_lo > lo ||
      (d_lo < t_w && dec_g == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Geometry g{n_ch, t_stream, block, n_win, out_stride, n, n_states,
                   km2, t_w, halo, out_lo, out_hi, guard, sym != 0};
  const CorePlan cp{row0, d_lo, t_w - d_lo};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  // KB butterflies a thread, kCoreThreads threads a block at most
  switch (n_states / (2 * (n_states / 2 < kCoreThreads ? n_states / 2
                                                        : kCoreThreads))) {
    case 1:
      err = launch_core<1>(lam, pin, polys, g, cp, sym, dec_g, out, n_rows, s);
      break;
    case 2:
      err = launch_core<2>(lam, pin, polys, g, cp, sym, dec_g, out, n_rows, s);
      break;
    case 4:
      err = launch_core<4>(lam, pin, polys, g, cp, sym, dec_g, out, n_rows, s);
      break;
    case 8:
      err = launch_core<8>(lam, pin, polys, g, cp, sym, dec_g, out, n_rows, s);
      break;
    default:
      err = launch_core<16>(lam, pin, polys, g, cp, sym, dec_g, out, n_rows,
                            s);
      break;
  }
  return static_cast<int>(err);
}

}  // extern "C"
