// Max-log BCJR half-iteration of the 8-state LTE RSC: replaces
// modem_tpu/ops/pallas_bcjr.py::_bcjr_kernel (K14).
//
// One row is one (codeword, window) of tw trellis steps, its inputs laid out
// x[3][R][tw]: x[0] the systematic plus a-priori LLR lu, x[1] the parity LLR
// lp, x[2] the pin mask (> 0 on the padded steps outside the data). The
// extrinsics app - lu of steps keep_lo .. keep_lo + keep_n come out as
// out[R][keep_n].
//
// What bounds it on this card: not bytes (6.3 MB at 512 codewords of
// K = 1024, 1.9 us at the HBM rate) nor f32 operations (0.075 GFLOP), but the
// serial chain of dependent trellis steps in every row. At 512 rows the card
// has too few rows to hide one step's latency behind others, so the time is
// the steps a lane walks times the cycles a step takes on its own.
//
// The design:
// - One lane holds all eight state metrics of one row in registers. The
//   trellis (predecessors 2(s&3), 2(s&3)+1; successors next_state(s, u)) is
//   unrolled at compile time, so a step has no shuffle: 16 adds, 8 maxima of
//   a branch pair, a three-level max tree over the states and 8
//   renormalising subtracts.
// - Alpha and beta run at once, from both ends of a row (the X schedule).
//   Warp 0 of a block carries alpha over steps 0 .. mid - 1 and warp 1 beta
//   over steps tw - 1 .. mid, each storing every pre-step metric in the
//   history scratch. After a __syncthreads warp 0 carries alpha on over
//   mid .. keep_lo + keep_n - 1 and forms each step's APP from the stored
//   beta, and warp 1 carries beta down over mid - 1 .. keep_lo and forms the
//   APP from the stored alpha. A lane walks about tw steps instead of 2 tw.
//   The roles are warp-uniform, so the two instruction streams never
//   diverge.
// - The compute warps touch no device memory. A warp's loads share a few
//   scoreboards, so data loaded ahead into registers is waited for together
//   with every later load, and issuing cp.async or bulk copies for every row
//   stalls the warp that issues them. So each compute warp has a loader warp
//   (warps 2 and 3), and the pair shares two chunk buffers of kC steps in
//   shared memory, handed over by named barriers. The loader brings a
//   chunk's lu, lp and pin (16-byte loads where rows are aligned, tw % 4 ==
//   0) and, after the meeting point, the other sweep's metrics; it drains the
//   compute warp's pre-step metrics of the chunk before to the history, or
//   its extrinsics to out, a row's 128 bytes at once. The history is kept
//   per block as [tw][2][rows] float4, so each of those copies is one
//   contiguous run (17.9 MB at the main shape, L2-resident).
// - kRowsPerWarp rows a warp: 512 rows make 32 blocks of 4 warps, each warp
//   on a scheduler of its own; 2560 rows (window 256) fit the card at once.
//   Lanes past kRowsPerWarp, and past the last row, compute on a row of the
//   block and store nothing.
// - A step's branch metric from state s on info bit u with parity p is
//   fl(lu * 0.5(1-2u)) + fl(lp * 0.5(1-2p)) (fec/turbo._gammas). With
//   a = fl(0.5 lu) and b = fl(0.5 lp) its four values are fl(a+b), fl(a-b)
//   and their negations (scaling by 0.5 and negation are exact, rounding to
//   nearest is symmetric), so a step takes two adds, not sixteen products.
//   On a pinned step only (s, u) = (0, 0) is taken, at cost 0, every other
//   branch at -1e30: g * keep + kill with keep 1 or 0 and kill 0 or -1e30,
//   exact either way, on the FMA pipe rather than as selects.
// - Every add, max and subtract is the plain version's
//   (ops/bcjr_kernel.py::rows_plain), rounded once (__fadd_rn, __fsub_rn; no
//   fast math); the APP is ((alpha + g) + beta[next]) in its order, so the
//   extrinsics are bit-identical to it.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kS = 8;
constexpr int kRowsPerWarp = 16;
constexpr int kThreads = 128;  // alpha, beta, and a loader warp for each
constexpr int kC = 32;        // steps a chunk

__host__ __device__ constexpr int parity_bit(int s, int u) {
  return u ^ ((s >> 1) & 1) ^ ((s >> 2) & 1);
}

__host__ __device__ constexpr int next_state(int s, int u) {
  return ((u ^ ((s >> 1) & 1) ^ (s & 1)) << 2) | (s >> 1);
}

// info bit of the branch from predecessor p into state sp
__host__ __device__ constexpr int pred_bit(int sp, int p) {
  return ((sp >> 2) & 1) ^ ((p >> 1) & 1) ^ (p & 1);
}

// ---- barriers and predicated stores ----

// named barriers between a compute warp and its loader warp (64 threads)
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, 64;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ unsigned smem(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// shared-memory stores that a lane makes only where ok, without a branch:
// the same stores written as `if (ok) *p = ...` take 7% longer at 512 rows
// x 1092 steps on an H100 (bench_turbo_torch.py, 0.0891 against 0.0829 ms
// of device time; 166 against 168 registers, no spills either way)
__device__ __forceinline__ void store4_if(float4* p, float a, float b,
                                          float c, float d, bool ok) {
  asm volatile(
      "{\n .reg .pred q;\n setp.ne.b32 q, %5, 0;\n"
      " @q st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n}\n" ::"r"(smem(p)),
      "f"(a), "f"(b), "f"(c), "f"(d), "r"(static_cast<int>(ok))
      : "memory");
}

__device__ __forceinline__ void store1_if(float* p, float a, bool ok) {
  asm volatile(
      "{\n .reg .pred q;\n setp.ne.b32 q, %2, 0;\n"
      " @q st.shared.f32 [%0], %1;\n}\n" ::"r"(smem(p)),
      "f"(a), "r"(static_cast<int>(ok))
      : "memory");
}

// ---- one trellis step ----

// the branch metrics of one step: (0, 0)'s, then fl(a+b), fl(a-b) and their
// negations, each -1e30 on a pinned step
struct Gammas {
  float g00, p, q, mq, mp;
};

__device__ __forceinline__ Gammas step_gammas(float lu, float lp, float pin) {
  const float a = __fmul_rn(lu, 0.5f), b = __fmul_rn(lp, 0.5f);
  const float p = __fadd_rn(a, b), q = __fsub_rn(a, b);
  const float keep = pin > 0.f ? 0.f : 1.f;
  const float kill = __fmaf_rn(keep, 1e30f, kNeg);  // 0 or -1e30, exactly
  return {__fmul_rn(p, keep), __fmaf_rn(p, keep, kill),
          __fmaf_rn(q, keep, kill), __fmaf_rn(-q, keep, kill),
          __fmaf_rn(-p, keep, kill)};
}

// g(s, u); s and u are compile-time constants after unrolling
__device__ __forceinline__ float gamma(const Gammas& g, int s, int u) {
  if (s == 0 && u == 0) return g.g00;
  const int par = parity_bit(s, u);
  return u == 0 ? (par == 0 ? g.p : g.q) : (par == 0 ? g.mq : g.mp);
}

__device__ __forceinline__ float max8(const float (&v)[kS]) {
  return fmaxf(fmaxf(fmaxf(v[0], v[1]), fmaxf(v[2], v[3])),
               fmaxf(fmaxf(v[4], v[5]), fmaxf(v[6], v[7])));
}

// Step on metrics m: alpha forwards (kFwd) or beta backwards. With kApp,
// the APP's extrinsic from m and the other sweep's metrics o at this step.
template <bool kFwd, bool kApp>
__device__ __forceinline__ float step(float (&m)[kS], float lu, float lp,
                                      float pin, const float (&o)[kS]) {
  const Gammas g = step_gammas(lu, lp, pin);
  float n[kS], ext = 0.f;
  if constexpr (kFwd) {
    float c[kS][2];
#pragma unroll
    for (int s = 0; s < kS; ++s) {
      c[s][0] = __fadd_rn(m[s], gamma(g, s, 0));
      c[s][1] = __fadd_rn(m[s], gamma(g, s, 1));
    }
    if constexpr (kApp) {
      float v0[kS], v1[kS];
#pragma unroll
      for (int s = 0; s < kS; ++s) {
        v0[s] = __fadd_rn(c[s][0], o[next_state(s, 0)]);
        v1[s] = __fadd_rn(c[s][1], o[next_state(s, 1)]);
      }
      ext = __fsub_rn(__fsub_rn(max8(v0), max8(v1)), lu);
    }
#pragma unroll
    for (int sp = 0; sp < kS; ++sp) {
      const int pa = 2 * (sp & 3), pb = pa + 1;
      n[sp] = fmaxf(c[pa][pred_bit(sp, pa)], c[pb][pred_bit(sp, pb)]);
    }
  } else {
    if constexpr (kApp) {
      float v0[kS], v1[kS];
#pragma unroll
      for (int s = 0; s < kS; ++s) {
        v0[s] = __fadd_rn(__fadd_rn(o[s], gamma(g, s, 0)),
                          m[next_state(s, 0)]);
        v1[s] = __fadd_rn(__fadd_rn(o[s], gamma(g, s, 1)),
                          m[next_state(s, 1)]);
      }
      ext = __fsub_rn(__fsub_rn(max8(v0), max8(v1)), lu);
    }
#pragma unroll
    for (int s = 0; s < kS; ++s)
      n[s] = fmaxf(__fadd_rn(gamma(g, s, 0), m[next_state(s, 0)]),
                   __fadd_rn(gamma(g, s, 1), m[next_state(s, 1)]));
  }
  const float mx = max8(n);
#pragma unroll
  for (int s = 0; s < kS; ++s) m[s] = __fsub_rn(n[s], mx);
  return ext;
}

// ---- a pair's rows ----

// A pair (a compute warp and its loader warp) shares two buffers, each a
// chunk of kC steps: the inputs [3][kRowsPerWarp][kInRow] (a row's steps,
// padded so that 8 lanes' 16-byte reads of 8 rows hit 32 banks); the
// metrics [kC][2][nb] float4 in the history's own layout (the compute
// warp's pre-step metrics before the meeting point, the other sweep's
// after it); the extrinsics [kRowsPerWarp][kOutRow].
constexpr int kInRow = kC + 4;
constexpr int kOutRow = kC + 1;
constexpr int kInTile = 3 * kRowsPerWarp * kInRow;
constexpr int kHistTile = kC * 2 * kRowsPerWarp * 4;
constexpr int kOutTile = kRowsPerWarp * kOutRow;
constexpr int kBuf = kInTile + kHistTile + kOutTile;
constexpr int kSmemBytes = 2 * 2 * kBuf * 4;
static_assert(kC == 32 && kInRow % 4 == 0 && kBuf % 4 == 0,
              "a chunk row is a warp; 16-byte tiles");

struct Pair {
  const float* x;    // the block's first row of lu at step 0
  long long plane;   // floats from lu to lp to pin
  int tw, nb;        // steps a row; rows of this block
  float4* hist;      // the block's history, [tw][2][nb] float4
  float* out;        // the block's extrinsics, [nb][keep_n], step keep_lo
  int keep_lo, keep_n, keep_hi, lane, rl, bar;  // bar: first barrier id
  bool live, vec;
  float* buf;        // [2][kBuf]
};

__device__ __forceinline__ float* in_tile(const Pair& p, int b) {
  return p.buf + b * kBuf;
}
__device__ __forceinline__ float4* hist_tile(const Pair& p, int b) {
  return reinterpret_cast<float4*>(p.buf + b * kBuf + kInTile);
}
__device__ __forceinline__ float* out_tile(const Pair& p, int b) {
  return p.buf + b * kBuf + kInTile + kHistTile;
}

// The chunks of a sweep over steps lo .. hi - 1: kC-step chunks aligned to
// multiples of kC, ascending (kFwd) or descending.
struct Chunks {
  int first, n, dc;
};

template <bool kFwd>
__device__ __forceinline__ Chunks chunks(int lo, int hi) {
  const int first = (kFwd ? lo : hi - 1) / kC * kC;
  const int last = (kFwd ? hi - 1 : lo) / kC * kC;
  return {first, (kFwd ? last - first : first - last) / kC + 1,
          kFwd ? kC : -kC};
}

// ---- the loader warp ----

// Chunk c0's inputs (steps c0 .. c0 + kC - 1, zeros past tw) and, with
// kApp, the other sweep's metrics of its steps in lo .. hi - 1, into
// buffer b. Lane j takes step c0 + j of a row, or a row's 16-byte pieces.
template <bool kApp>
__device__ __forceinline__ void load_chunk(const Pair& p, int b, int c0,
                                           int lo, int hi) {
  float* in = in_tile(p, b);
  for (int a = 0; a < 3; ++a) {
    const float* src = p.x + a * p.plane + c0;
    float* dst = in + a * kRowsPerWarp * kInRow;
    if (p.vec && c0 + kC <= p.tw) {
      const int j = (p.lane & 7) * 4;
      for (int rr = p.lane >> 3; rr < p.nb; rr += 4)
        *reinterpret_cast<float4*>(dst + rr * kInRow + j) =
            __ldg(reinterpret_cast<const float4*>(
                src + static_cast<long long>(rr) * p.tw + j));
    } else {
      const bool ok = c0 + p.lane < p.tw;
      for (int rr = 0; rr < p.nb; ++rr)
        dst[rr * kInRow + p.lane] =
            ok ? __ldg(src + static_cast<long long>(rr) * p.tw + p.lane)
               : 0.f;
    }
  }
  if constexpr (kApp) {
    const int v0 = max(c0, lo), v1 = min(c0 + kC, hi);
    const int n4 = (v1 - v0) * 2 * p.nb;
    const float4* src = p.hist + v0 * 2 * p.nb;
    float4* dst = hist_tile(p, b) + (v0 - c0) * 2 * p.nb;
    for (int e = p.lane; e < n4; e += 32) dst[e] = __ldcg(src + e);
  }
}

// Buffer b after the compute warp is done with chunk c0: before the
// meeting point its pre-step metrics of the steps in lo .. hi - 1 go to the
// history, after it its extrinsics of the kept steps go to out.
template <bool kApp>
__device__ __forceinline__ void drain_chunk(const Pair& p, int b, int c0,
                                            int lo, int hi) {
  const int v0 = max(c0, lo), v1 = min(c0 + kC, hi);
  if constexpr (kApp) {
    const int t = c0 + p.lane;
    if (t < max(v0, p.keep_lo) || t >= min(v1, p.keep_hi)) return;
    const float* src = out_tile(p, b) + p.lane;
    float* dst = p.out + t - p.keep_lo;
    for (int rr = 0; rr < p.nb; ++rr)
      dst[static_cast<long long>(rr) * p.keep_n] = src[rr * kOutRow];
  } else {
    const int n4 = (v1 - v0) * 2 * p.nb;
    const float4* src = hist_tile(p, b) + (v0 - c0) * 2 * p.nb;
    float4* dst = p.hist + v0 * 2 * p.nb;
    for (int e = p.lane; e < n4; e += 32) dst[e] = src[e];
  }
}

// The loader's side of a sweep: each chunk loaded into its buffer once the
// compute warp is done with the chunk two before (which it drains first).
template <bool kFwd, bool kApp>
__device__ __forceinline__ void load_sweep(const Pair& p, int lo, int hi) {
  if (lo >= hi) return;  // uniform over the block
  const Chunks c = chunks<kFwd>(lo, hi);
  for (int i = 0; i < c.n + 2; ++i) {
    const int b = i & 1;
    if (i >= 2) {
      bar_sync(p.bar + 2 + b);  // the compute warp is done with i - 2
      drain_chunk<kApp>(p, b, c.first + (i - 2) * c.dc, lo, hi);
    }
    if (i < c.n) {
      load_chunk<kApp>(p, b, c.first + i * c.dc, lo, hi);
      __syncwarp();
      bar_arrive(p.bar + b);  // chunk i is in buffer b
    }
  }
}

// ---- the compute warp ----

// Steps cg .. cg + 3 (with kFull all of them, else those in lo .. hi - 1),
// in the sweep's order, from position kg of buffer b. Before the meeting
// point each step's pre-step metrics go to the buffer; after it the
// extrinsics do.
template <bool kFwd, bool kApp, bool kFull>
__device__ __forceinline__ void run_group(float (&m)[kS], const Pair& p,
                                          int b, int cg, int kg, int lo,
                                          int hi) {
  const float* in = in_tile(p, b);
  float4* hs = hist_tile(p, b);
  float* ot = out_tile(p, b) + p.rl * kOutRow + kg;
  float v[3][4];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float4 q = *reinterpret_cast<const float4*>(
        in + (a * kRowsPerWarp + p.rl) * kInRow + kg);
    v[a][0] = q.x, v[a][1] = q.y, v[a][2] = q.z, v[a][3] = q.w;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = kFwd ? i : 3 - i, t = cg + k;
    if (!kFull && (t < lo || t >= hi)) continue;  // uniform over the warp
    float4* h = hs + 2 * (kg + k) * p.nb + p.rl;
    float o[kS];
    if constexpr (kApp) {
      const float4 o0 = h[0], o1 = h[p.nb];
      o[0] = o0.x, o[1] = o0.y, o[2] = o0.z, o[3] = o0.w;
      o[4] = o1.x, o[5] = o1.y, o[6] = o1.z, o[7] = o1.w;
    } else {
      store4_if(h, m[0], m[1], m[2], m[3], p.live);
      store4_if(h + p.nb, m[4], m[5], m[6], m[7], p.live);
    }
    const float ext = step<kFwd, kApp>(m, v[0][k], v[1][k], v[2][k], o);
    if constexpr (kApp) store1_if(ot + k, ext, p.live);
  }
}

// The compute warp's side of a sweep over steps lo .. hi - 1.
template <bool kFwd, bool kApp>
__device__ __forceinline__ void run_sweep(float (&m)[kS], const Pair& p,
                                          int lo, int hi) {
  if (lo >= hi) return;  // uniform over the block
  const Chunks c = chunks<kFwd>(lo, hi);
  for (int i = 0; i < c.n; ++i) {
    const int c0 = c.first + i * c.dc, b = i & 1;
    bar_sync(p.bar + b);  // chunk i is in buffer b
    const int g0 = (kFwd ? max(lo, c0) : min(hi, c0 + kC) - 1) / 4 * 4;
    const int g1 = (kFwd ? min(hi, c0 + kC) - 1 : max(lo, c0)) / 4 * 4;
#pragma unroll 1
    for (int cg = g0; kFwd ? cg <= g1 : cg >= g1; cg += kFwd ? 4 : -4) {
      if (cg >= lo && cg + 4 <= hi)  // uniform over the warp
        run_group<kFwd, kApp, true>(m, p, b, cg, cg - c0, lo, hi);
      else
        run_group<kFwd, kApp, false>(m, p, b, cg, cg - c0, lo, hi);
    }
    __syncwarp();
    bar_arrive(p.bar + 2 + b);  // done with buffer b
  }
}

// Warps 0 and 1 compute alpha and beta; warps 2 and 3 load and store for
// them. Named barriers 1 + 4 * role: buffer 0, 1 full; 2 + .., 3 + ..:
// buffer 0, 1 done.
__global__ void __launch_bounds__(kThreads, 1)
    bcjr_kernel(const float* __restrict__ x, long long n_rows, int tw,
                int keep_lo, int keep_n, float* hist, float* out) {
  extern __shared__ float4 smem_f4[];
  const int warp = threadIdx.x >> 5;
  const bool fwd = (warp & 1) == 0, loader = warp >= 2;
  const long long base = static_cast<long long>(blockIdx.x) * kRowsPerWarp;
  Pair p;
  p.lane = threadIdx.x & 31;
  p.rl = p.lane % kRowsPerWarp;
  p.nb = static_cast<int>(min(static_cast<long long>(kRowsPerWarp),
                              n_rows - base));
  p.live = p.lane < kRowsPerWarp && p.rl < p.nb;
  p.x = x + base * tw;
  p.plane = n_rows * tw;
  p.tw = tw;
  p.hist = reinterpret_cast<float4*>(hist + base * tw * kS);
  p.out = out + base * keep_n;
  p.keep_lo = keep_lo;
  p.keep_n = keep_n;
  p.keep_hi = keep_lo + keep_n;
  p.bar = 1 + 4 * (warp & 1);
  p.vec = tw % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  p.buf = reinterpret_cast<float*>(smem_f4) + (warp & 1) * 2 * kBuf;
  const int mid = tw / 2;

  if (loader) {
    if (fwd)
      load_sweep<true, false>(p, 0, mid);
    else
      load_sweep<false, false>(p, mid, tw);
    __syncthreads();  // the history of both halves is written
    if (fwd)
      load_sweep<true, true>(p, mid, p.keep_hi);
    else
      load_sweep<false, true>(p, keep_lo, mid);
    return;
  }
  float m[kS];
#pragma unroll
  for (int s = 0; s < kS; ++s) m[s] = 0.f;  // neutral at both ends
  if (fwd)
    run_sweep<true, false>(m, p, 0, mid);
  else
    run_sweep<false, false>(m, p, mid, tw);
  __syncthreads();
  if (fwd)
    run_sweep<true, true>(m, p, mid, p.keep_hi);
  else
    run_sweep<false, true>(m, p, keep_lo, mid);
}

}  // namespace

extern "C" {

// x [3, n_rows, tw] f32 rows (lu, lp, pin); hist [n_rows, tw, 8] f32
// scratch -> out [n_rows, keep_n] f32, the extrinsics app - lu of steps
// keep_lo .. keep_lo + keep_n - 1. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a geometry it does not take.
int modem_bcjr(const float* x, long long n_rows, int tw, int keep_lo,
               int keep_n, float* hist, float* out, void* stream) {
  if (n_rows == 0 || keep_n == 0) return static_cast<int>(cudaSuccess);
  if (tw < 1 || keep_lo < 0 || keep_n < 0 || keep_lo + keep_n > tw)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (n_rows + kRowsPerWarp - 1) / kRowsPerWarp;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaFuncSetAttribute(
      bcjr_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (set != cudaSuccess) return static_cast<int>(set);
  bcjr_kernel<<<static_cast<unsigned>(blocks), kThreads, kSmemBytes,
                static_cast<cudaStream_t>(stream)>>>(x, n_rows, tw, keep_lo,
                                                     keep_n, hist, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
