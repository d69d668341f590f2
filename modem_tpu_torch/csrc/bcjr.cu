// Max-log BCJR half-iteration of the 8-state LTE RSC: replaces
// modem_tpu/ops/pallas_bcjr.py::_bcjr_kernel (K14).
//
// One row is one (codeword, window) of tw trellis steps, its inputs laid out
// x[3][R][tw]: x[0] the systematic plus a-priori LLR lu, x[1] the parity LLR
// lp, x[2] the pin mask (> 0 on the padded steps outside the data). Eight
// lanes of a warp hold one row, lane s the metric of state s = s1*4+s2*2+s3,
// four rows a warp; the butterfly partners come by __shfl_sync within the
// 8-lane group, and the max over the 8 states by three xor shuffles.
//
// A step's branch metric from state s on info bit u (parity p(s, u)) is
// fl(lu * 0.5(1-2u)) + fl(lp * 0.5(1-2p)) (fec/turbo._gammas; both products
// are exact, so no contraction can change the sum). On a pinned step only
// (s, u) = (0, 0) is taken, at cost 0, every other branch at -1e30: exactly
// the windowed XLA form's pin-gammas. (The JAX kernel gives cost 0 to every
// (u, p) = (0, 0) branch there, which only moves dead states; here there is
// no such deviation.) Alpha and beta start at 0 (neutral) at the row's ends.
//
// Alpha sweep: alpha'[s'] = max over its two branches of alpha[s] + g(s, u),
// minus the max over the states, every step; the pre-step alpha of each step
// goes to a global scratch [R][tw][8] (35 KB a row at K = 1024, more than a
// block's share of shared memory for 4 rows a warp, and L2-resident).
// Beta + APP sweep, backwards: m_u[s] = (alpha[s] + g(s, u)) + beta[nxt(s, u)],
// app = max_s m_0 - max_s m_1, the extrinsic app - lu; then beta[s] =
// max_u (g(s, u) + beta[nxt(s, u)]) renormalised. Every add, max and
// subtract is the plain version's (ops/bcjr_kernel.py::rows_plain), each
// rounded once (__fadd_rn, __fsub_rn; no fast math), so the extrinsics are
// bit-identical.
//
// Steps go in chunks of 8: lane k of a group loads step t0+k's three inputs
// (and, backwards, the 8 alpha values of its state for the chunk), one
// chunk ahead, and the group passes them round by shuffles; lane k keeps
// step t0+k's extrinsic and the group writes 8 at once.
//
// What bounds it on this card: each step is a chain of dependent shuffles
// and adds (about 8 shuffles a step forwards and 14 backwards), tw of them
// in series per row, and the work is tiny (about 16 f32 operations a
// state-step): at 512 codewords of K = 1024 the card holds 4096 lanes, one
// warp on each SM, so the serial chain sets the time, not the bytes or the
// arithmetic. A simple first version: no overlap of the two sweeps, no
// split of a row across more lanes.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr float kNeg = -1e30f;
constexpr int kS = 8;
constexpr int kRowsPerBlock = 4;  // one warp a block

__device__ __forceinline__ int parity_bit(int s, int u) {
  const int s1 = (s >> 2) & 1, s2 = (s >> 1) & 1, s3 = s & 1;
  return u ^ s2 ^ s3 ^ s1 ^ s3;
}

__device__ __forceinline__ int next_state(int s, int u) {
  const int s1 = (s >> 2) & 1, s2 = (s >> 1) & 1, s3 = s & 1;
  return ((u ^ s2 ^ s3) << 2) | (s1 << 1) | s2;
}

// g(s, u) at a step with inputs lu, lp; pinned: only (0, 0) at cost 0.
__device__ __forceinline__ float gamma(float lu, float lp, bool pinned, int s,
                                       int u) {
  if (pinned) return (s == 0 && u == 0) ? 0.f : kNeg;
  return __fadd_rn(__fmul_rn(lu, u ? -0.5f : 0.5f),
                   __fmul_rn(lp, parity_bit(s, u) ? -0.5f : 0.5f));
}

__device__ __forceinline__ float group_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(kFull, v, 1, kS));
  v = fmaxf(v, __shfl_xor_sync(kFull, v, 2, kS));
  return fmaxf(v, __shfl_xor_sync(kFull, v, 4, kS));
}

__global__ void __launch_bounds__(32) bcjr_kernel(const float* __restrict__ x,
                                                  long long n_rows, int tw,
                                                  int keep_lo, int keep_n,
                                                  float* __restrict__ hist,
                                                  float* __restrict__ out) {
  const int s = threadIdx.x & (kS - 1);
  const long long row_raw =
      static_cast<long long>(blockIdx.x) * kRowsPerBlock + (threadIdx.x >> 3);
  const bool live = row_raw < n_rows;
  const long long row = live ? row_raw : n_rows - 1;  // idle groups shadow
  const float* lu_r = x + row * tw;
  const float* lp_r = x + (n_rows + row) * tw;
  const float* pin_r = x + (2 * n_rows + row) * tw;
  float* hist_r = hist + row * tw * kS;

  // predecessors of state s and the info bits of their branches
  const int pa = 2 * (s & 3), pb = pa + 1, a_bit = s >> 2;
  const int ua = a_bit ^ ((pa >> 1) & 1) ^ (pa & 1);
  const int ub = a_bit ^ ((pb >> 1) & 1) ^ (pb & 1);
  const int n0 = next_state(s, 0), n1 = next_state(s, 1);

  // ---- alpha sweep ----
  float alpha = 0.f;
  float nlu = 0.f, nlp = 0.f, npin = 0.f;
  if (s < tw) {
    nlu = lu_r[s];
    nlp = lp_r[s];
    npin = pin_r[s];
  }
  for (int t0 = 0; t0 < tw; t0 += kS) {
    const float clu = nlu, clp = nlp, cpin = npin;
    const int tn = t0 + kS + s;
    if (tn < tw) {
      nlu = lu_r[tn];
      nlp = lp_r[tn];
      npin = pin_r[tn];
    }
#pragma unroll
    for (int k = 0; k < kS; ++k) {
      const int t = t0 + k;
      if (t >= tw) break;  // uniform over the warp
      const float lu = __shfl_sync(kFull, clu, k, kS);
      const float lp = __shfl_sync(kFull, clp, k, kS);
      const bool pinned = __shfl_sync(kFull, cpin, k, kS) > 0.f;
      if (live) hist_r[t * kS + s] = alpha;
      const float va = __shfl_sync(kFull, alpha, pa, kS);
      const float vb = __shfl_sync(kFull, alpha, pb, kS);
      const float na = fmaxf(__fadd_rn(va, gamma(lu, lp, pinned, pa, ua)),
                             __fadd_rn(vb, gamma(lu, lp, pinned, pb, ub)));
      alpha = __fsub_rn(na, group_max(na));
    }
  }
  __syncwarp();

  // ---- beta + APP sweep, backwards ----
  float beta = 0.f;
  const int c_last = (tw - 1) / kS * kS;
  float nah[kS];
  {
    const int t = c_last + s;
    nlu = t < tw ? lu_r[t] : 0.f;
    nlp = t < tw ? lp_r[t] : 0.f;
    npin = t < tw ? pin_r[t] : 0.f;
#pragma unroll
    for (int k = 0; k < kS; ++k)
      nah[k] = c_last + k < tw ? hist_r[(c_last + k) * kS + s] : 0.f;
  }
  for (int t0 = c_last; t0 >= 0; t0 -= kS) {
    const float clu = nlu, clp = nlp, cpin = npin;
    float ah[kS];
#pragma unroll
    for (int k = 0; k < kS; ++k) ah[k] = nah[k];
    if (t0 > 0) {
      const int tp = t0 - kS;
      nlu = lu_r[tp + s];
      nlp = lp_r[tp + s];
      npin = pin_r[tp + s];
#pragma unroll
      for (int k = 0; k < kS; ++k) nah[k] = hist_r[(tp + k) * kS + s];
    }
    float mine = 0.f;
#pragma unroll
    for (int k = kS - 1; k >= 0; --k) {
      const int t = t0 + k;
      if (t >= tw) continue;  // uniform over the warp
      const float lu = __shfl_sync(kFull, clu, k, kS);
      const float lp = __shfl_sync(kFull, clp, k, kS);
      const bool pinned = __shfl_sync(kFull, cpin, k, kS) > 0.f;
      const float g0 = gamma(lu, lp, pinned, s, 0);
      const float g1 = gamma(lu, lp, pinned, s, 1);
      const float b0 = __shfl_sync(kFull, beta, n0, kS);
      const float b1 = __shfl_sync(kFull, beta, n1, kS);
      const float m0 = group_max(__fadd_rn(__fadd_rn(ah[k], g0), b0));
      const float m1 = group_max(__fadd_rn(__fadd_rn(ah[k], g1), b1));
      if (s == k) mine = __fsub_rn(__fsub_rn(m0, m1), lu);
      const float nb = fmaxf(__fadd_rn(g0, b0), __fadd_rn(g1, b1));
      beta = __fsub_rn(nb, group_max(nb));
    }
    const int t = t0 + s;
    if (live && t < tw && t >= keep_lo && t < keep_lo + keep_n)
      out[row * keep_n + (t - keep_lo)] = mine;
  }
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
  const long long blocks = (n_rows + kRowsPerBlock - 1) / kRowsPerBlock;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  bcjr_kernel<<<static_cast<unsigned>(blocks), 32, 0,
                static_cast<cudaStream_t>(stream)>>>(x, n_rows, tw, keep_lo,
                                                     keep_n, hist, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
