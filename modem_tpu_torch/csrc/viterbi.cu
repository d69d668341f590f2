// Windowed soft-decision Viterbi: replaces
// modem_tpu/ops/pallas_viterbi.py::_viterbi_kernel (K13), for every code
// shape ConvCode builds (K >= 2, any n) and any window length, in two
// routes that decide alike:
//
// * the warp route (viterbi_kernel): S <= 256, n <= 32, a row's costs,
//   decisions and metrics in shared memory (below);
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
// One warp decodes one trellis row (window) of t_w steps over S = 2^(K-1)
// states in natural order, S/32 states per lane (one for S <= 32, lanes
// >= S idle and their ballot bits masked off). A step is the butterfly of
// ConvCode._acs: for target state s
// the predecessors are p0 = (2s) mod S and p0 | 1, the branch metric from
// predecessor d is the sum of the step's costs lam[j] over the code bits j
// that transition emits (bitmask masks[d][s], summed in the order
// j = 0..n-1), c_d = pm[p_d] + bm_d, the decision is c1 < c0 (a tie takes
// the even predecessor) and the new metric the smaller. Metrics go through
// two per-warp buffers in shared memory, one __syncwarp per step; decisions
// are packed with __ballot_sync, one bit per state and step, S/32 words a
// step. After step i the metrics are renormalised (minus their minimum)
// where (t_w - 1 - i) % 8 == 0: the JAX forms pad the window's front with
// zero-cost steps to a multiple of 8 and renormalise after every 8th padded
// step, and the subtraction rounds, so the cadence is part of the result.
// The end state is the first minimum of pm + pin * 1e9 * (s > 0); the
// traceback walks back one decision bit per step (every lane in step,
// reading the same word), bit = state >> (K-2), state = ((state << 1) &
// (S-1)) | dec[t][state], and the warp writes 32 decisions at a time.
// Every value equals the plain version's, so the decisions are bit-identical
// (no fast math; each add is __fadd_rn).
//
// Where the row's costs come from: rows wi * n_ch + c read channel c of a
// stream [n_ch, t_stream, n] at steps wi*block - halo + p, with the guard
// cost outside [0, t_stream): the overlapping windows of a terminated
// stream, built here and never in device memory. A batch of ready windows
// is the same with n_win = 1, block = halo = 0 and t_stream = t_w.
//
// The row's shared memory is laid out by the caller
// (ops/viterbi_kernel.py::row_layout, which also picks the route): the
// costs at 0, the decision words (max(1, S/32) a step) at dec_off, the two
// metric buffers at pm_off, row_floats per warp. This entry trusts it. The
// block route's placement comes from ops/viterbi_kernel.py::block_plan.
//
// What bounds it on this card: each step is a chain of dependent shared
// loads, adds, a warp vote and a barrier, t_w of them in series per row,
// and only about 4 operations a state-step (two path adds, a compare and a
// select; the f32 bound at 67 TFLOP/s is ~6 us at bench_fec's 2304 rows of
// 652 steps x 64 states). The design
// keeps every row's costs and decisions on chip (no device-memory round
// trip between the passes) and runs as many rows at once as shared memory
// allows (up to four warps a block, all of bench_fec's rows in one wave), so
// the serial chain of each row, not the arithmetic, sets the time. The
// block route is for the shapes the warp route cannot hold; it spends a
// barrier a step and reads each step's costs and, past shared memory, its
// metrics and decisions from device memory (L2 at these sizes): a simple
// first version, not tuned.

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxWarps = 4;  // rows (warps) per block
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr int kRenorm = 8;
constexpr float kBig = 1e9f;
constexpr unsigned kFull = 0xffffffffu;

struct Geometry {
  long long n_ch, t_stream, block, n_win, out_stride;
  int n, n_states, km2, t_w, halo, out_lo, out_hi;
  int dec_off, pm_off, row_floats;  // the caller's shared-memory layout
  float guard;
};

template <int kSpl>  // states per lane
__global__ void __launch_bounds__(kWarp * kMaxWarps)
viterbi_kernel(const float* __restrict__ lam, const float* __restrict__ pin,
               const int* __restrict__ masks, Geometry g,
               int* __restrict__ out) {
  extern __shared__ float4 smem4[];
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x / kWarp;
  const long long row =
      static_cast<long long>(blockIdx.x) * (blockDim.x / kWarp) + warp;
  if (row >= g.n_ch * g.n_win) return;  // whole warps only
  const long long c = row % g.n_ch;
  const long long wi = row / g.n_ch;
  const int n_s = g.n_states, n = g.n, t_w = g.t_w;
  const int words = n_s < kWarp ? 1 : n_s / kWarp;
  const unsigned live = n_s < kWarp ? (1u << n_s) - 1u : kFull;

  float* costs = reinterpret_cast<float*>(smem4) +
                 static_cast<size_t>(warp) * g.row_floats;
  unsigned* dec = reinterpret_cast<unsigned*>(costs + g.dec_off);
  float* pmb = costs + g.pm_off;

  // the row's costs, guard outside the stream
  const float* src = lam + c * g.t_stream * n;
  const long long start = wi * g.block - g.halo;
  for (int i = lane; i < t_w * n; i += kWarp) {
    const int p = i / n;
    const long long s = start + p;
    costs[i] = (s >= 0 && s < g.t_stream) ? src[s * n + (i - p * n)]
                                          : g.guard;
  }
  int m0[kSpl], m1[kSpl];
  float v[kSpl];
#pragma unroll
  for (int k = 0; k < kSpl; ++k) {
    const int s = lane + kWarp * k;
    const bool ok = s < n_s;
    m0[k] = ok ? masks[s] : 0;
    m1[k] = ok ? masks[n_s + s] : 0;
    v[k] = 0.f;
    if (ok) pmb[s] = 0.f;  // free start
  }
  __syncwarp();

  int cur = 0;
  for (int p = 0; p < t_w; ++p) {
    const float* lp = costs + p * n;
    const float* pm = pmb + cur * n_s;
#pragma unroll
    for (int k = 0; k < kSpl; ++k) {
      const int s = lane + kWarp * k;
      bool d = false;
      if (s < n_s) {
        float bm0 = 0.f, bm1 = 0.f;
        for (int j = 0; j < n; ++j) {
          const float l = lp[j];
          if ((m0[k] >> j) & 1) bm0 = __fadd_rn(bm0, l);
          if ((m1[k] >> j) & 1) bm1 = __fadd_rn(bm1, l);
        }
        const int p0 = (s << 1) & (n_s - 1);
        const float c0 = __fadd_rn(pm[p0], bm0);
        const float c1 = __fadd_rn(pm[p0 | 1], bm1);
        d = c1 < c0;
        v[k] = d ? c1 : c0;
      }
      const unsigned w = __ballot_sync(kFull, d) & live;
      if (lane == 0) dec[p * words + k] = w;
    }
    if ((t_w - 1 - p) % kRenorm == 0) {
      float mn = __int_as_float(0x7f800000);  // +inf
#pragma unroll
      for (int k = 0; k < kSpl; ++k)
        if (lane + kWarp * k < n_s) mn = fminf(mn, v[k]);
#pragma unroll
      for (int off = kWarp / 2; off > 0; off >>= 1)
        mn = fminf(mn, __shfl_xor_sync(kFull, mn, off));
#pragma unroll
      for (int k = 0; k < kSpl; ++k) v[k] = __fsub_rn(v[k], mn);
    }
    float* nx = pmb + (cur ^ 1) * n_s;
#pragma unroll
    for (int k = 0; k < kSpl; ++k)
      if (lane + kWarp * k < n_s) nx[lane + kWarp * k] = v[k];
    __syncwarp();
    cur ^= 1;
  }

  // end state: the first minimum of the (pinned) final metrics
  const float pin_v = pin != nullptr ? pin[row]
                                     : (wi == g.n_win - 1 ? 1.f : 0.f);
  float best = __int_as_float(0x7f800000);
  int best_s = n_s;
#pragma unroll
  for (int k = 0; k < kSpl; ++k) {
    const int s = lane + kWarp * k;
    if (s < n_s) {
      const float bias = __fmul_rn(__fmul_rn(pin_v, kBig), s > 0 ? 1.f : 0.f);
      const float val = __fadd_rn(v[k], bias);
      if (val < best) {
        best = val;
        best_s = s;
      }
    }
  }
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    const float ob = __shfl_xor_sync(kFull, best, off);
    const int os = __shfl_xor_sync(kFull, best_s, off);
    if (ob < best || (ob == best && os < best_s)) {
      best = ob;
      best_s = os;
    }
  }

  // traceback; lane l keeps the bit of step p with p % 32 == l until the
  // warp writes the 32 steps from p & ~31 together
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

template <int kSpl>
cudaError_t launch(const float* lam, const float* pin, const int* masks,
                   const Geometry& g, int* out, cudaStream_t stream) {
  int dev = 0, cap = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&cap, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 dev);
  if (err != cudaSuccess) return err;
  const size_t per_row = static_cast<size_t>(g.row_floats) * sizeof(float);
  int warps = static_cast<int>(static_cast<size_t>(cap) / per_row);
  if (warps < 1) return cudaErrorInvalidValue;
  if (warps > kMaxWarps) warps = kMaxWarps;
  const long long rows = g.n_ch * g.n_win;
  if (rows < warps) warps = static_cast<int>(rows);
  const long long blocks = (rows + warps - 1) / warps;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const size_t smem = per_row * warps;
  if (smem > kDefaultSmem) {
    err = cudaFuncSetAttribute(
        viterbi_kernel<kSpl>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  viterbi_kernel<kSpl><<<static_cast<unsigned>(blocks), kWarp * warps, smem,
                         stream>>>(lam, pin, masks, g, out);
  return cudaGetLastError();
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
// int32 code-bit masks -> for each row wi * n_ch + c the decisions at
// window steps out_lo <= p < out_hi into out[c * out_stride + wi * block +
// p - out_lo] int32; the row's shared memory laid out as dec_off, pm_off
// and row_floats say (floats). Returns cudaGetLastError(), or
// cudaErrorInvalidValue where S is not a power of two in 2..256 or a row
// does not fit the shared memory of one block.
int modem_viterbi(const float* lam, const float* pin, const int* masks,
                  long long n_ch, long long t_stream, int n, int n_states,
                  int km2, int t_w, int dec_off, int pm_off, int row_floats,
                  long long block, int halo, long long n_win, float guard,
                  int out_lo, int out_hi, long long out_stride, int* out,
                  void* stream) {
  if (n_ch * n_win == 0) return static_cast<int>(cudaSuccess);
  const Geometry g{n_ch, t_stream, block, n_win, out_stride, n, n_states,
                   km2, t_w, halo, out_lo, out_hi, dec_off, pm_off,
                   row_floats, guard};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (n_states) {
    case 2:
    case 4:
    case 8:
    case 16:
    case 32:
      err = launch<1>(lam, pin, masks, g, out, s);
      break;
    case 64:
      err = launch<2>(lam, pin, masks, g, out, s);
      break;
    case 128:
      err = launch<4>(lam, pin, masks, g, out, s);
      break;
    case 256:
      err = launch<8>(lam, pin, masks, g, out, s);
      break;
    default:
      err = cudaErrorInvalidValue;
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
                   km2, t_w, halo, out_lo, out_hi, 0, 0, 0, guard};
  const BlockPlan plan{threads, pm_smem, dec_smem, row0, n_rows};
  if (static_cast<size_t>(smem_bytes) > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        viterbi_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  viterbi_block_kernel<<<static_cast<unsigned>(n_rows), threads, smem_bytes,
                         static_cast<cudaStream_t>(stream)>>>(
      lam, pin, polys, g, plan, pm_g, dec_g, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
