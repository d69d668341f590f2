// Windowed soft-decision Viterbi: replaces
// modem_tpu/ops/pallas_viterbi.py::_viterbi_kernel (K13), for every code
// shape ConvCode builds (K >= 2, any n) and any window length, in two
// routes that decide alike:
//
// * the warp route (viterbi_kernel): S <= 256, n <= 32, a warp's rows in
//   shared memory (below);
// * the block route (viterbi_block_kernel): everything else. One block
//   decodes one row, its threads (min(S, 1024), at least a warp) own the
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
// 70 cycles, does. The block route is for the shapes the warp route
// cannot hold; it spends a barrier a step and reads each step's costs
// and, past shared memory, its metrics and decisions from device memory
// (L2 at these sizes): a simple first version, not tuned.

#include <cuda_runtime.h>

#include <cstdint>

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

}  // extern "C"
