// Polar successive-cancellation decoders over the whole tree, one warp a
// codeword:
//
// * sc_kernel replaces modem_tpu/ops/pallas_sc.py::_sc_kernel (K15): SC
//   decisions u and the re-encoded partial sums x;
// * scl_kernel replaces modem_tpu/ops/pallas_scl.py::_scl_kernel (K16):
//   CA-SCL with a list of 8, the post-selection decisions u of every path
//   and the path metrics (the CRC test and the final argmin stay in torch,
//   as in the JAX package).
//
// The frozen mask is a runtime array (one byte a leaf), so one compiled
// kernel serves every code of n = 2^n_bits, 2 <= n <= 1024.
//
// The tree is walked leaf by leaf, as the recursion PolarCode._sc visits it.
// Node LLRs of depth d (width n >> d) live in shared memory; depth 0 is the
// channel. To reach leaf i the warp runs one g at the depth where leaf i's
// path turns right (n_bits - 1 - ctz(i)), with the left sibling's partial
// sums, then f down to the leaf; lanes share a node's width. Partial sums
// live in one array x[0, n) in natural position: after leaf i, every node
// that leaf i completes as a right child folds x[lo, mid) ^= x[mid, hi), so
// x[lo, hi) is always the finished node's re-encoding (the root's x is the
// codeword). f = sign(a)*sign(b)*min(|a|,|b|) with sign(0) = 0 (jnp.sign),
// g = b + (1 - 2x)*a, a leaf decides llr < 0, a frozen leaf 0: every value is
// the plain version's, each op rounded once (no fast math), so decisions are
// bit-identical.
//
// SCL keeps 8 paths in 8 slots of state (their node LLRs below the channel,
// x and u); logical path l (its place in the sorted list) lives in slot
// phys[l], its metric in pm[l]. A frozen leaf adds max(-llr, 0) to every
// path. An info leaf makes 16 candidates, c = u*8 + l with metric
// pm[l] + max(-llr, 0) (u = 0) or max(llr, 0) (u = 1); lanes 0-15 rank them
// by (metric, c) ascending (16 shuffles each: lax.top_k's order, lower index
// first on ties) and the 8 best survive, rank r becoming logical path r. A
// path with both children kept is cloned: its u = 1 child takes the slot of
// a path with none kept, into which the warp copies the parent's state (the
// node LLRs still to be used, x and u up to leaf i); the other children keep
// their parent's slot. That is an eager copy, equal in value to the JAX
// form's composed one-hot reorders. Clones start at metric 2e30.
//
// What bounds it on this card: the walk is inherently serial (n leaves, a
// chain of dependent f/g levels and warp barriers each); the arithmetic is
// tiny (about n log2 n f/g a codeword, for SCL 8 times that and a 16-way
// ranking per info leaf) and the bytes are the LLRs in and the decisions out.
// The design keeps every node in shared memory, so device memory sees one
// read of the LLRs and one write of the results, and runs as many codewords
// at once as shared memory allows. A simple first version: lanes idle at the
// deep levels of the tree, where a node is narrower than the warp.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarp = 32;
constexpr int kL = 8;
constexpr int kScWarps = 4;
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr float kTwoBig = 2e30f;

__device__ __forceinline__ float sgn(float a) {
  return a > 0.f ? 1.f : (a < 0.f ? -1.f : 0.f);
}

__device__ __forceinline__ float f_op(float a, float b) {
  return __fmul_rn(__fmul_rn(sgn(a), sgn(b)), fminf(fabsf(a), fabsf(b)));
}

__device__ __forceinline__ float g_op(float a, float b, unsigned char x) {
  return __fadd_rn(b, __fmul_rn(__fsub_rn(1.f, __fmul_rn(2.f, x)), a));
}

// offset of depth d >= 1 in a path's node buffer (widths n/2, n/4, .., 1)
__device__ __forceinline__ int node_off(int n, int d) {
  return n - (n >> (d - 1));
}

// ---------------------------------------------------------------- SC ----

// shared memory of one warp: the channel (n floats), nodes (n floats), x and
// u (n bytes each)
__host__ __device__ inline size_t sc_warp_bytes(int n) {
  return (8 * static_cast<size_t>(n) + 2 * n + 15) / 16 * 16;
}

__global__ void __launch_bounds__(kScWarps * kWarp) sc_kernel(
    const float* __restrict__ lam, long long n_cw, int n, int n_bits,
    const unsigned char* __restrict__ frozen, unsigned char* __restrict__ u_out,
    unsigned char* __restrict__ x_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x >> 5;
  const long long cw = static_cast<long long>(blockIdx.x) * kScWarps + warp;
  if (cw >= n_cw) return;  // no block-wide barrier below
  unsigned char* base = smem + warp * sc_warp_bytes(n);
  float* chan = reinterpret_cast<float*>(base);
  float* nodes = chan + n;
  unsigned char* xs = reinterpret_cast<unsigned char*>(nodes + n);
  unsigned char* us = xs + n;
  const float* src = lam + cw * n;
  for (int j = lane; j < n; j += kWarp) chan[j] = src[j];
  __syncwarp();

  for (int i = 0; i < n; ++i) {
    int d0 = 0;
    if (i) {
      const int t = __ffs(i) - 1;
      const int dd = n_bits - 1 - t, h = 1 << t;
      const float* p = dd ? nodes + node_off(n, dd) : chan;
      float* c = nodes + node_off(n, dd + 1);
      for (int j = lane; j < h; j += kWarp)
        c[j] = g_op(p[j], p[j + h], xs[i - h + j]);
      __syncwarp();
      d0 = dd + 1;
    }
    for (int d = d0; d < n_bits; ++d) {
      const int h = n >> (d + 1);
      const float* p = d ? nodes + node_off(n, d) : chan;
      float* c = nodes + node_off(n, d + 1);
      for (int j = lane; j < h; j += kWarp) c[j] = f_op(p[j], p[j + h]);
      __syncwarp();
    }
    if (lane == 0) {
      const unsigned char u =
          frozen[i] ? 0 : (nodes[node_off(n, n_bits)] < 0.f ? 1 : 0);
      us[i] = u;
      xs[i] = u;
    }
    __syncwarp();
    for (int s = 1; s < n && (i & s); s <<= 1) {
      const int lo = i + 1 - 2 * s;
      for (int j = lane; j < s; j += kWarp) xs[lo + j] ^= xs[lo + s + j];
      __syncwarp();
    }
  }
  for (int j = lane; j < n; j += kWarp) {
    u_out[cw * n + j] = us[j];
    x_out[cw * n + j] = xs[j];
  }
}

// ---------------------------------------------------------------- SCL ---

// shared memory of one warp (one block): the channel (n floats), 8 slots'
// nodes (8n floats), x and u (8n bytes each), pm and phys (8 each)
__host__ __device__ inline size_t scl_bytes(int n) {
  return 4 * static_cast<size_t>(n) + 32 * static_cast<size_t>(n) +
         16 * static_cast<size_t>(n) + 2 * 4 * kL;
}

__global__ void __launch_bounds__(kWarp) scl_kernel(
    const float* __restrict__ lam, int n, int n_bits,
    const unsigned char* __restrict__ frozen, unsigned char* __restrict__ u_out,
    float* __restrict__ pm_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x;
  const long long cw = blockIdx.x;
  float* chan = reinterpret_cast<float*>(smem);
  float* nodes = chan + n;                       // slot s at nodes + s*n
  unsigned char* xs = reinterpret_cast<unsigned char*>(nodes + kL * n);
  unsigned char* us = xs + kL * n;               // slot s at + s*n
  float* pm = reinterpret_cast<float*>(us + kL * n);
  int* phys = reinterpret_cast<int*>(pm + kL);
  const float* src = lam + cw * n;
  for (int j = lane; j < n; j += kWarp) chan[j] = src[j];
  if (lane < kL) {
    pm[lane] = lane ? kTwoBig : 0.f;
    phys[lane] = lane;
  }
  __syncwarp();

  for (int i = 0; i < n; ++i) {
    // node LLRs of every slot down to leaf i
    int d0 = 0;
    if (i) {
      const int t = __ffs(i) - 1;
      const int dd = n_bits - 1 - t, h = 1 << t;
      for (int e = lane; e < kL * h; e += kWarp) {
        const int sl = e >> t, j = e & (h - 1);
        const float* p = dd ? nodes + sl * n + node_off(n, dd) : chan;
        nodes[sl * n + node_off(n, dd + 1) + j] =
            g_op(p[j], p[j + h], xs[sl * n + i - h + j]);
      }
      __syncwarp();
      d0 = dd + 1;
    }
    for (int d = d0; d < n_bits; ++d) {
      const int lh = n_bits - d - 1, h = 1 << lh;
      for (int e = lane; e < kL * h; e += kWarp) {
        const int sl = e >> lh, j = e & (h - 1);
        const float* p = d ? nodes + sl * n + node_off(n, d) : chan;
        nodes[sl * n + node_off(n, d + 1) + j] = f_op(p[j], p[j + h]);
      }
      __syncwarp();
    }
    const int leaf = node_off(n, n_bits);
    if (frozen[i]) {
      if (lane < kL) {
        const int sl = phys[lane];
        pm[lane] = __fadd_rn(pm[lane], fmaxf(-nodes[sl * n + leaf], 0.f));
        us[sl * n + i] = 0;
        xs[sl * n + i] = 0;
      }
      __syncwarp();
    } else {
      // 16 candidates on lanes 0-15 (lanes 16-31 mirror them)
      const int c = lane & 15, l = c & 7, u = c >> 3;
      const int sl_par = phys[l];
      const float lam_l = nodes[sl_par * n + leaf];
      const float m = __fadd_rn(pm[l], fmaxf(u ? lam_l : -lam_l, 0.f));
      int rank = 0;
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const float mk = __shfl_sync(kFull, m, k);
        rank += (mk < m || (mk == m && k < c)) ? 1 : 0;
      }
      const bool kept = lane < 16 && rank < kL;
      const unsigned kb = __ballot_sync(kFull, kept);
      const unsigned k0 = kb & 0xffu, k1 = (kb >> 8) & 0xffu;
      const unsigned both = k0 & k1, none = ~(k0 | k1) & 0xffu;
      // clone each doubly-kept path into the slot of a path with none kept
      unsigned todo = both, free_m = none;
      while (todo) {
        const int pl = __ffs(todo) - 1, fl = __ffs(free_m) - 1;
        todo &= todo - 1;
        free_m &= free_m - 1;
        const int from = phys[pl], to = phys[fl];
        for (int d = 1; d < n_bits; ++d) {
          if ((i >> (n_bits - 1 - d)) & 1) continue;  // recomputed before use
          const int w = n >> d, off = node_off(n, d);
          for (int j = lane; j < w; j += kWarp)
            nodes[to * n + off + j] = nodes[from * n + off + j];
        }
        for (int j = lane; j < i; j += kWarp) {
          xs[to * n + j] = xs[from * n + j];
          us[to * n + j] = us[from * n + j];
        }
      }
      // the slot each kept candidate lands in
      int slot = sl_par;
      if (u && ((both >> l) & 1)) {
        int j = __popc(both & ((1u << l) - 1));
        unsigned f = none;
        while (j--) f &= f - 1;
        slot = phys[__ffs(f) - 1];
      }
      __syncwarp();
      if (kept) {
        us[slot * n + i] = static_cast<unsigned char>(u);
        xs[slot * n + i] = static_cast<unsigned char>(u);
        pm[rank] = m;
        phys[rank] = slot;
      }
      __syncwarp();
    }
    // fold the partial sums of every node leaf i completes, in every slot
    for (int s = 1; s < n && (i & s); s <<= 1) {
      const int lo = i + 1 - 2 * s, ls = __ffs(s) - 1;
      for (int e = lane; e < kL * s; e += kWarp) {
        const int sl = e >> ls, j = e & (s - 1);
        xs[sl * n + lo + j] ^= xs[sl * n + lo + s + j];
      }
      __syncwarp();
    }
  }
  for (int e = lane; e < kL * n; e += kWarp) {
    const int l = e / n, j = e - l * n;
    u_out[cw * kL * n + e] = us[phys[l] * n + j];
  }
  if (lane < kL) pm_out[cw * kL + lane] = pm[lane];
}

}  // namespace

extern "C" {

// lam [n_cw, n] f32 channel LLRs; frozen [n] bytes -> u_out, x_out
// [n_cw, n] bytes. Returns cudaGetLastError(), or
// cudaErrorInvalidValue unless n = 2^n_bits with 1 <= n_bits <= 10.
int modem_polar_sc(const float* lam, long long n_cw, int n, int n_bits,
                   const unsigned char* frozen, unsigned char* u_out,
                   unsigned char* x_out, void* stream) {
  if (n_bits < 1 || n_bits > 10 || n != (1 << n_bits))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_cw == 0) return static_cast<int>(cudaSuccess);
  const long long blocks = (n_cw + kScWarps - 1) / kScWarps;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = kScWarps * sc_warp_bytes(n);
  sc_kernel<<<static_cast<unsigned>(blocks), kScWarps * kWarp, smem,
              static_cast<cudaStream_t>(stream)>>>(lam, n_cw, n, n_bits,
                                                   frozen, u_out, x_out);
  return static_cast<int>(cudaGetLastError());
}

// lam [n_cw, n] f32 channel LLRs; frozen [n] bytes -> u_out [n_cw, 8, n]
// bytes (the post-selection decisions of the 8 paths, in list order) and
// pm_out [n_cw, 8] f32 path metrics. Returns cudaGetLastError(), or
// cudaErrorInvalidValue unless n = 2^n_bits with 1 <= n_bits <= 10.
int modem_polar_scl(const float* lam, long long n_cw, int n, int n_bits,
                    const unsigned char* frozen, unsigned char* u_out,
                    float* pm_out, void* stream) {
  if (n_bits < 1 || n_bits > 10 || n != (1 << n_bits) ||
      n_cw > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_cw == 0) return static_cast<int>(cudaSuccess);
  const size_t smem = scl_bytes(n);
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        scl_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  scl_kernel<<<static_cast<unsigned>(n_cw), kWarp, smem,
               static_cast<cudaStream_t>(stream)>>>(lam, n, n_bits, frozen,
                                                    u_out, pm_out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
