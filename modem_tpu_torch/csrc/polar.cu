// Polar successive-cancellation decoders over the whole tree:
//
// * sc_kernel replaces modem_tpu/ops/pallas_sc.py::_sc_kernel (K15): SC
//   decisions u and the re-encoded partial sums x, eight codewords a warp;
// * scl_kernel replaces modem_tpu/ops/pallas_scl.py::_scl_kernel (K16):
//   CA-SCL with a list of 8, one codeword a warp, the post-selection
//   decisions u of every path and the path metrics (the CRC test and the
//   final argmin stay in torch, as in the JAX package).
//
// One compiled kernel serves every code of n = 2^n_bits, 2 <= n <= 1024:
// K16 takes the frozen mask as a runtime array (one byte a leaf), K15 the
// code's skip plan by value (ScPlan).
//
// Both walk the tree leaf by leaf, as the recursion PolarCode._sc visits
// it. Node LLRs of depth d have width n >> d; depth 0 is the channel. To
// reach leaf i the walk runs one g at the depth where leaf i's path turns
// right (d0 = n_bits - ctz(i)), with the left sibling's partial sums, then
// f down to the leaf. Partial sums live in one array x[0, n) in natural
// position: after leaf i, every node that leaf i completes as a right
// child folds x[lo, mid) ^= x[mid, hi), so x[lo, hi) is always the finished
// node's re-encoding (the root's x is the codeword). f = sign(a)*sign(b)*
// min(|a|,|b|) with sign(0) = 0 (jnp.sign), g = b + (1 - 2x)*a, a leaf
// decides llr < 0, a frozen leaf 0: every value is the plain version's,
// each op rounded once (no fast math), so decisions are bit-identical.
//
// SC (redesigned for Hopper). Eight codewords a warp, four lanes a
// codeword: slot s (lanes 4s .. 4s+3) holds codeword s of the warp's
// eight, which share one code and so walk in lockstep (every branch is
// uniform). The slot's codeword is staged in shared memory by cp.async at
// the start. The walk goes a width-16 node at a time: the levels of width
// 32 and more (sc_level) spread their elements over the slot's four lanes,
// 16 bytes a load and a store, from and to the slot's own node buffers
// (depths 1 .. n_bits - 5), a warp barrier a level; the width-16 node is
// then held whole by every lane of the slot, in registers (from eight
// 16-byte loads of its width-32 parent), and its subtree of 16 leaves is
// decided there with no shuffle, barrier or shared memory (sc_node,
// unrolled at compile time). Below the levels the data are registers, so
// what sets the time is the chain of dependent operations, not the count:
// a right child's g forms both sums b + a and b - a before its x bit is
// known, and a left leaf decides f(a, b) < 0 from the signs of a and b
// without forming f. x and u are bit-packed, 32 leaves a word, as K16's:
// the current word in a register, finished words in shared memory; the
// fold is a shift within the register at 16 leaves and word XORs, all
// slots at once, above.
// What a step skips: in SC a frozen leaf decides 0 whatever its LLR, and
// a subtree whose leaves are all frozen re-encodes to x = 0, so none of
// its f's and g's changes an output. The plan (ops/sc_kernel.py::
// plan_codes, 4 bits a leaf) marks the first leaf of each maximal such
// subtree with its width; a step over one of 16 leaves or more computes
// the levels above it that the rest of the tree needs, none of it or below
// it, leaves its u and x at 0 and jumps past its leaves, folding what its
// last leaf would close (the right sibling's g is then b + a, the value
// g_op gives for x = 0). Inside a width-16 node the plan's information
// leaves (a bit a leaf) skip each all-frozen child the same way, down to
// pairs; a frozen leaf of a pair with an information leaf is decided 0.
//
// What bounds K15 on this card: the walk is serial (after the skips, at
// (256, 128) 286 of the 510 nodes, 128 of them leaves), the arithmetic
// tiny and the bytes the LLRs in and the decisions out, so a codeword's
// time is its chain of dependent instructions. At 4096 codewords that is
// 512 warps, about one a scheduler, so the chain sets the time; eight
// codewords share each instruction. Shared memory is the channel, n - 32
// node floats and 2n bits of x and u a codeword, padded (16,960 bytes a
// warp of eight at n = 256).
//
// SCL (redesigned for Hopper). One warp a codeword, 4 lanes a path: the 8
// paths live in 8 slots (lanes 4s .. 4s+3 hold slot s), in no order; slot
// s's path knows its place in the list (lg) and its metric in registers.
// Each level of a node spreads its elements over the slot's 4 lanes; the
// channel (depth 0) is read from device memory, at the two levels that
// use it. A frozen leaf adds max(-llr, 0) to every path. An info leaf
// makes 16 candidates, c = u*8 + lg, metric pm + max(-llr, 0) (u = 0) or
// max(llr, 0) (u = 1), each held by two lanes of its slot that rank it
// against 8 candidates apiece by (metric, c) ascending (lax.top_k's order,
// lower index first on ties); the 8 best survive, rank r becoming list
// place r. A slot keeps its own u = 0 child where that survives, else its
// u = 1 child; a path with both children kept gives its u = 1 child to a
// slot whose path has none, the j-th such parent to the j-th such slot.
// Clones start at metric 2e30. Four frozen leaves in an aligned run are
// decided in one step from the width-4 node, and a frozen left leaf with
// a frozen right sibling in one step from the width-2 node: the same f's
// and g's (x = 0), the penalties added in leaf order, so only the skipped
// leaves' bookkeeping is saved.
//
// What a clone copies, and why so little:
// * Node LLRs are never copied. Depths 1 .. n_bits - 3 (widths n/2 .. 8)
//   lie in shared memory, one buffer a slot and depth; each path keeps a
//   map (3 bits a depth, one register) from depth to the slot whose buffer
//   holds its LLRs there. A path always writes a depth into its own slot's
//   buffer and then points its map there; a clone copies its parent's map.
//   This is safe because all 8 paths walk the tree in lockstep: leaf i
//   rewrites depths d0 .. n_bits (d0 = n_bits - ctz(i)) in every path at
//   once and reads only depth d0 - 1 (the g's parent), which no path
//   writes at that leaf. Depth d is rewritten by every path at the same
//   leaves, so between two rewrites of depth d no path writes it, and a
//   buffer a map names keeps its value until the map's owner rewrites the
//   depth itself, even after the slot has passed to another path. Every
//   read of another slot's buffer is of a depth nobody writes then.
// * The width-4 node (element q on lane q of the slot), the width-2 node
//   (on every lane), the leaf and the candidates' metrics stay in
//   registers and shuffles, with no shared-memory round trip and no warp
//   barrier a level: a right leaf (i odd) is one g of the width-2 node, a
//   left leaf's last two levels a few shuffles. A clone takes them, and
//   its map, by one shuffle each.
// * x and u are bit-packed, 32 leaves a word: the current word in a
//   register, finished words in shared memory (n/32 a slot). The fold
//   x[lo, lo+s) ^= x[lo+s, lo+2s) is a shift and mask within the register
//   for s < 32 and word XORs for s >= 32; a g reads its x bit from the
//   register or a word. A clone copies the parent's finished words, every
//   clone of a leaf in one warp-wide loop over (clone, word) pairs.
// f and g take the values the plain version's do: f as its sign and min
// (f_op), g = b + a or b - a (= b + (1 - 2x)*a exactly), one rounding each,
// so u and the path metrics equal the plain version's bit for bit.
//
// What bounds it on this card: the walk is serial (n leaves; 2n - 2 node
// levels, each a few dependent operations; an info leaf's ranking, a
// ballot and the clone shuffles), the arithmetic tiny and the bytes the
// LLRs in and the decisions out, so a codeword's time is its chain of
// dependent instructions (an info leaf's ranking and clones the longest
// part, then the levels read from memory), a few cycles each, with few
// other warps to hide them at the link's 1024 codewords and the card's
// issue slots shared at 4096. Shared memory is 8 (n - 8) node floats and 2n
// bytes of x and u a codeword (8,832 bytes at n = 256), two codewords a
// block, about 24 warps an SM.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarp = 32;
constexpr int kL = 8;
constexpr float kTwoBig = 2e30f;

// sign(a)*sign(b)*min(|a|,|b|) (sign(0) = 0): the products are by +-1 or
// +0, so no rounding; the magnitude is the min and the sign negative iff
// exactly one of a, b is below zero (a zero operand makes the min +0 and
// the product -0 iff the other is negative), computed as such
__device__ __forceinline__ float f_op(float a, float b) {
  const float m = fminf(fabsf(a), fabsf(b));
  return (a < 0.f) != (b < 0.f) ? -m : m;
}

// b + (1 - 2x)*a: (1 - 2x)*a is a or -a exactly, so one rounded add
__device__ __forceinline__ float g_op(float a, float b, unsigned x) {
  return __fadd_rn(b, x ? -a : a);
}

// offset of depth d >= 1 in a path's node buffer (widths n/2, n/4, .., 1)
__device__ __forceinline__ int node_off(int n, int d) {
  return n - (n >> (d - 1));
}

// -------------------------------------------- shared by K15 and K16 ---

constexpr int kG = 4;  // lanes a slot (a codeword of K15, a path of K16)

// 32-bit words of one slot's x (and of its u).
__host__ __device__ inline int scl_words(int n) { return n >= 32 ? n / 32 : 1; }

// Bits 0 .. 3 of x as the bytes 0/1 of a word.
__device__ __forceinline__ unsigned spread4(unsigned x) {
  return ((x & 15u) * 0x00204081u) & 0x01010101u;
}

// ---------------------------------------------------------------- SC ----

constexpr int kScWarps = 1;  // warps (eight codewords each) a block
constexpr int kScReg = 16;   // the widest node held in registers

// The code's plan, by value in a kernel parameter (ops/sc_kernel.py::
// host_plan): w, the walk's steps (plan_codes), 4 bits a leaf, leaf i in
// bits 4 (i % 8) of word i / 8 (at the leaf where a step starts: 15 an
// information leaf, t <= 10 a maximal all-frozen subtree of 2^t leaves);
// info, the information leaves, leaf i in bit i % 32 of word i / 32.
struct ScPlan {
  unsigned w[128];
  unsigned info[32];
};

// The code of leaf i (a step's first leaf).
__device__ __forceinline__ unsigned plan_code(const ScPlan& p, int i) {
  return (p.w[i >> 3] >> (4 * (i & 7))) & 15u;
}

// Floats of one slot's staged channel and of its node buffers (depths 1 ..
// n_bits - 5, widths n/2 .. 32, node_off order), each padded to 16 more
// than a multiple of 32 floats: a 16-byte load of four slot lanes covers
// four 16-byte bank groups, and the next slot's the other four.
__host__ __device__ inline int sc_pad16(int w) { return (w + 15) / 32 * 32 + 16; }
__host__ __device__ inline int sc_chan_stride(int n) { return sc_pad16(n); }
__host__ __device__ inline int sc_node_stride(int n) {
  return n > 2 * kScReg ? sc_pad16(n - 2 * kScReg) : 0;
}

// Words of one slot's x (and of its u), odd so that the slots' words of
// one leaf lie in distinct banks.
__host__ __device__ inline int sc_word_stride(int n) {
  return scl_words(n) + 1;
}

// shared memory of one warp (eight codewords): each slot's channel, node
// buffers, x words and u words
__host__ __device__ inline size_t sc_warp_bytes(int n) {
  return 4 * static_cast<size_t>(kL) *
         (sc_chan_stride(n) + sc_node_stride(n) + 2 * sc_word_stride(n));
}

// g with its x bit chosen last: both b + a and b - a, then the bit picks
// one (g_op's value, one rounding), so the bit is not on the add's path.
__device__ __forceinline__ float g_pick(float a, float b, bool x) {
  const float plus = __fadd_rn(b, a), minus = __fadd_rn(b, -a);
  return x ? minus : plus;
}

// f of four element pairs, or g with their x bits (bits 0 .. 3 of x).
template <bool kGOp>
__device__ __forceinline__ float4 fg4(float4 a, float4 b, unsigned x) {
  if (kGOp)
    return make_float4(g_pick(a.x, b.x, x & 1u), g_pick(a.y, b.y, x & 2u),
                       g_pick(a.z, b.z, x & 4u), g_pick(a.w, b.w, x & 8u));
  return make_float4(f_op(a.x, b.x), f_op(a.y, b.y), f_op(a.z, b.z),
                     f_op(a.w, b.w));
}

// One level of K15's walk from shared memory to shared memory (h >= 32):
// the width-h node's elements j .. j + 3 and j + 16 .. j + 19 (j = 4q, 4q +
// 32, ..) from its parent's elements j and j + h in src, by g (kGOp, with
// the x bits of leaf i's left sibling from the slot's words) or f, into
// dst, 16 bytes a load and a store, the loads of a pass first.
template <bool kGOp>
__device__ __forceinline__ void sc_level(const float* __restrict__ src,
                                         float* __restrict__ dst, int h,
                                         int q, int i,
                                         const unsigned* own_x) {
  const auto ld = [&](int j) {
    return *reinterpret_cast<const float4*>(src + j);
  };
  const auto xb = [&](int j) {
    return kGOp ? own_x[(i - h + j) >> 5] >> (j & 31) : 0u;
  };
  for (int j = 4 * q; j < h; j += 8 * kG) {
    const int k = j + 4 * kG;
    const float4 a0 = ld(j), b0 = ld(j + h), a1 = ld(k), b1 = ld(k + h);
    const unsigned x0 = xb(j), x1 = xb(k);
    *reinterpret_cast<float4*>(dst + j) = fg4<kGOp>(a0, b0, x0);
    *reinterpret_cast<float4*>(dst + k) = fg4<kGOp>(a1, b1, x1);
  }
}

// Decisions u and partial sums x (bit k leaf k) of a node in registers.
struct Bits {
  unsigned u, x;
};

// The decisions and re-encoding of a width-W node's leaves (W <= 16) from
// its LLRs r, whole in registers, and its information leaves (bit k leaf
// k): each child unless all frozen (its u and x are 0), the left one from
// f's, the right one from g's with the left one's x (both sums formed
// first, the x bit picking one); x = [x_l ^ x_r, x_r]. At W = 2 the two
// leaves: the left decides f(a, b) < 0, which by f_op's sign rule is
// (a < 0) != (b < 0) with neither 0, so its f is not formed; the right
// decides g(a, b, u_l) < 0 from the sum u_l picks. A frozen leaf decides 0.
template <int W>
__device__ __forceinline__ Bits sc_node(const float (&r)[W], unsigned info) {
  if constexpr (W == 2) {
    const float a = r[0], b = r[1];
    const float plus = __fadd_rn(b, a), minus = __fadd_rn(b, -a);
    const bool b0 = (info & 1u) && a != 0.f && b != 0.f &&
                    ((a < 0.f) != (b < 0.f));
    const bool b1 = (info & 2u) && (b0 ? minus : plus) < 0.f;
    return {b0 | (b1 << 1), (b0 != b1) | (b1 << 1)};
  } else {
    constexpr int H = W / 2;
    constexpr unsigned kHalf = (1u << H) - 1u;
    float h[H];
    Bits lo = {0u, 0u}, hi = {0u, 0u};
    if (info & kHalf) {
#pragma unroll
      for (int k = 0; k < H; ++k) h[k] = f_op(r[k], r[k + H]);
      lo = sc_node<H>(h, info & kHalf);
    }
    if (info >> H) {
#pragma unroll
      for (int k = 0; k < H; ++k)
        h[k] = g_pick(r[k], r[k + H], (lo.x >> k) & 1u);
      hi = sc_node<H>(h, info >> H);
    }
    return {lo.u | (hi.u << H), (lo.x ^ hi.x) | (hi.x << H)};
  }
}

// A code of n <= 16: its root (the slot's channel) walked in registers.
template <int W>
__device__ __forceinline__ Bits sc_small(const float* chan,
                                         const ScPlan& plan) {
  float r[W];
#pragma unroll
  for (int k = 0; k < W; ++k) r[k] = chan[k];
  return sc_node<W>(r, plan.info[0] & ((1u << W) - 1u));
}

__global__ void __launch_bounds__(kScWarps * kWarp) sc_kernel(
    const float* __restrict__ lam, long long n_cw, int n, int n_bits,
    const __grid_constant__ ScPlan plan, unsigned char* __restrict__ u_out,
    unsigned char* __restrict__ x_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x >> 5;
  const long long cw0 =
      (static_cast<long long>(blockIdx.x) * kScWarps + warp) * kL;
  if (cw0 >= n_cw) return;  // no block-wide barrier below
  const int s = lane >> 2, q = lane & (kG - 1);  // the slot, the lane in it
  const long long cw = cw0 + s;  // past n_cw: walks zeros, writes nothing
  const bool live = cw < n_cw;
  const int cst = sc_chan_stride(n), stride = sc_node_stride(n);
  const int xst = sc_word_stride(n);
  float* chans = reinterpret_cast<float*>(smem + warp * sc_warp_bytes(n));
  float* nodes = chans + kL * cst;
  unsigned* xw = reinterpret_cast<unsigned*>(nodes + kL * stride);
  unsigned* uw = xw + kL * xst;
  float* chan = chans + s * cst;
  float* own = nodes + s * stride;
  unsigned* own_x = xw + s * xst;
  unsigned* own_u = uw + s * xst;

  // the slot's codeword into shared memory, 16 bytes a copy where the
  // rows are aligned; x and u to 0 (a skipped word is never written)
  if (!live) {
    for (int j = q; j < n; j += kG) chan[j] = 0.f;
  } else if (n >= 4 && (reinterpret_cast<uintptr_t>(lam) & 15u) == 0) {
    const float* src = lam + cw * n;
    for (int j = 4 * q; j < n; j += 4 * kG) modem::cp_async16(chan + j, src + j);
  } else {
    const float* src = lam + cw * n;
    for (int j = q; j < n; j += kG) modem::cp_async4(chan + j, src + j);
  }
  modem::cp_async_commit();
  for (int e = lane; e < 2 * kL * xst; e += kWarp) xw[e] = 0u;
  modem::cp_async_wait<0>();
  __syncwarp();

  if (n <= kScReg) {  // the whole tree in registers
    const Bits b = n == 2   ? sc_small<2>(chan, plan)
                   : n == 4 ? sc_small<4>(chan, plan)
                   : n == 8 ? sc_small<8>(chan, plan)
                            : sc_small<16>(chan, plan);
    if (q == 0) {
      own_x[0] = b.x;
      own_u[0] = b.u;
    }
  }
  unsigned xcur = 0, ucur = 0;  // x and u of the current word
  unsigned c = plan_code(plan, 0);  // the code of leaf i
  for (int i = 0; n > kScReg && i < n;) {
    // the step: a width-16 node whose leaves are not all frozen, or a
    // skipped subtree of 2^t >= 16 leaves
    const bool node = c == 15u || c < 4u;
    const int t = node ? 4 : static_cast<int>(c);
    const int last = i + (1 << t) - 1;
    const unsigned cn = plan_code(plan, (last + 1) & (n - 1));
    // depths d0 .. n_bits - 1 - t through shared memory (widths >= 32):
    // from the first that leaf i rewrites to the step's parent
    const int d0 = i ? n_bits - (__ffs(i) - 1) : 1;
    for (int d = d0; d <= n_bits - 1 - t; ++d) {
      const float* src = d == 1 ? chan : own + node_off(n, d - 1);
      float* dst = own + node_off(n, d);
      if (i != 0 && d == d0)
        sc_level<true>(src, dst, n >> d, q, i, own_x);
      else
        sc_level<false>(src, dst, n >> d, q, i, own_x);
      __syncwarp();
    }
    Bits b = {0u, 0u};  // u and x of leaves i .. i + 15
    if (node) {
      // the width-16 node (depth n_bits - 4), whole on every lane of the
      // slot: f's or g's of the width-32 node's 32 elements (the channel at
      // n = 32), eight 16-byte loads
      const float* src = n == 32 ? chan : own + node_off(n, n_bits - 5);
      const bool g = i != 0 && d0 == n_bits - 4;
      const unsigned x = g ? xcur >> ((i - 16) & 31) : 0u;
      float r[16];
#pragma unroll
      for (int k = 0; k < 16; k += 4) {
        const float4 pa = *reinterpret_cast<const float4*>(src + k);
        const float4 pb = *reinterpret_cast<const float4*>(src + k + 16);
        const float4 v = g ? fg4<true>(pa, pb, x >> k) : fg4<false>(pa, pb, 0u);
        r[k] = v.x;
        r[k + 1] = v.y;
        r[k + 2] = v.z;
        r[k + 3] = v.w;
      }
      b = sc_node<16>(r, (plan.info[i >> 5] >> (i & 16)) & 0xffffu);
    }

    // the node's u and x, then the folds of every wider node that the
    // step's last leaf completes (those inside a skipped subtree XOR
    // zeros, and are not run)
    xcur |= b.x << (i & 31);
    ucur |= b.u << (i & 31);
    if (t < 5 && (last & 16)) xcur ^= xcur >> 16;  // the width-32 node
    if ((last & 31) == 31) {
      if (q == 0) {
        own_x[last >> 5] = xcur;
        own_u[last >> 5] = ucur;
      }
      __syncwarp();
      for (int sf = t > 5 ? 1 << t : kWarp; sf < n && (last & sf);
           sf <<= 1) {
        const int ws = sf >> 5, lws = __ffs(ws) - 1;
        const int lw = (last + 1 - 2 * sf) >> 5;
        for (int e = lane; e < kL * ws; e += kWarp) {
          unsigned* p = xw + (e >> lws) * xst + lw + (e & (ws - 1));
          p[0] ^= p[ws];
        }
        __syncwarp();
      }
      xcur = 0;
      ucur = 0;
    }
    c = cn;
    i = last + 1;
  }
  __syncwarp();

  // u and x of slot s's codeword, as bytes
  if (live) {
    unsigned char* uo = u_out + cw * n;
    unsigned char* xo = x_out + cw * n;
    if (n >= 16) {
      for (int p = q; p < n / 16; p += kG) {
        const int sh = (p & 1) * 16;
        const unsigned ub = own_u[p >> 1] >> sh, xb = own_x[p >> 1] >> sh;
        reinterpret_cast<uint4*>(uo)[p] =
            make_uint4(spread4(ub), spread4(ub >> 4), spread4(ub >> 8),
                       spread4(ub >> 12));
        reinterpret_cast<uint4*>(xo)[p] =
            make_uint4(spread4(xb), spread4(xb >> 4), spread4(xb >> 8),
                       spread4(xb >> 12));
      }
    } else {
      for (int j = q; j < n; j += kG) {
        uo[j] = static_cast<unsigned char>((own_u[0] >> j) & 1u);
        xo[j] = static_cast<unsigned char>((own_x[0] >> j) & 1u);
      }
    }
  }
}

// ---------------------------------------------------------------- SCL ---

constexpr int kSclWarps = 2;  // codewords (warps) a block

// Floats of one slot's node buffers: depths 1 .. n_bits - 3 (widths n/2 ..
// 8, node_off order), padded to 4 more than a multiple of 32 floats so that
// slot s starts on bank 4s.
__host__ __device__ inline int scl_stride(int n) {
  const int w = n >= 16 ? n - 8 : 0;
  return w ? (w + 27) / 32 * 32 + 4 : 0;
}

// The x bit of element j of a g's left sibling (leaf i's g at width hg:
// bit i - hg + j): from the current word below 32, else from the slot's
// finished words.
__device__ __forceinline__ unsigned xbit(int i, int hg, int j, unsigned xcur,
                                         const unsigned* own_x) {
  const int pos = i - hg + j;
  return hg < 32 ? (xcur >> (pos & 31)) & 1u
                 : (own_x[pos >> 5] >> (j & 31)) & 1u;
}

// One level of the walk from memory to memory (h >= 8): the width-h node's
// elements j = q, q + 4, .. (h/4 of them, the same count on every lane)
// from its parent's elements j and j + h in src (the channel, or a depth in
// shared memory), by g (kGOp) or f, into dst. Loads run up to four
// elements ahead of the arithmetic; a batch's elements lie in one 16-bit
// half of an x word, read once.
template <bool kGOp>
__device__ __forceinline__ void walk_level(const float* __restrict__ src,
                                           float* __restrict__ dst, int h,
                                           int q, int i, unsigned xcur,
                                           const unsigned* own_x) {
  const int step = h >= 16 ? 4 : 2;  // elements a lane takes at once
  for (int j0 = q; j0 < h; j0 += step * kG) {
    float a[4], b[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (k < step) {
        a[k] = src[j0 + k * kG];
        b[k] = src[j0 + k * kG + h];
      }
    }
    unsigned xs = 0;  // x bits of elements j0, j0 + 4, .. at 0, 4, ..
    if (kGOp)
      xs = (h < 32 ? xcur >> ((i - h) & 31)
                   : own_x[(i - h + j0) >> 5]) >> (j0 & 31);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (k < step) {
        const int j = j0 + k * kG;
        dst[j] = kGOp ? g_op(a[k], b[k], (xs >> (k * kG)) & 1u)
                      : f_op(a[k], b[k]);
      }
    }
  }
}

// shared memory of one warp (one codeword): 8 slots' node buffers, x words
// and u words
__host__ __device__ inline size_t scl_warp_bytes(int n) {
  return 4 * (static_cast<size_t>(kL) * scl_stride(n) +
              2 * static_cast<size_t>(kL) * scl_words(n));
}

// Position of the c-th (from 0, c <= 3) set bit of m, without a branch.
__device__ __forceinline__ int nth_set(unsigned m, int c) {
  const unsigned m1 = m & (m - 1), m2 = m1 & (m1 - 1), m3 = m2 & (m2 - 1);
  return __ffs(c == 0 ? m : c == 1 ? m1 : c == 2 ? m2 : m3) - 1;
}

// f, or g with the x bit of element j (leaf i's g at width h).
__device__ __forceinline__ float fg(bool g, float a, float b, int i, int h,
                                    int j, unsigned xcur,
                                    const unsigned* own_x) {
  return g ? g_op(a, b, xbit(i, h, j, xcur, own_x)) : f_op(a, b);
}

__global__ void __launch_bounds__(kSclWarps * kWarp) scl_kernel(
    const float* __restrict__ lam, long long n_cw, int n, int n_bits,
    const unsigned char* __restrict__ frozen, unsigned char* __restrict__ u_out,
    float* __restrict__ pm_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x >> 5;
  const long long cw = static_cast<long long>(blockIdx.x) * kSclWarps + warp;
  if (cw >= n_cw) return;  // no block-wide barrier below
  const int stride = scl_stride(n), nwt = scl_words(n);
  float* nodes = reinterpret_cast<float*>(smem + warp * scl_warp_bytes(n));
  unsigned* xw = reinterpret_cast<unsigned*>(nodes + kL * stride);
  unsigned* uw = xw + kL * nwt;
  const float* chan = lam + cw * n;
  const int s = lane >> 2, q = lane & (kG - 1);  // the slot, the lane in it
  float* own = nodes + s * stride;
  unsigned* own_x = xw + s * nwt;
  unsigned* own_u = uw + s * nwt;

  // the frozen mask, word w on lane w
  unsigned fz = 0;
  for (int w = 0; w * kWarp < n; ++w) {
    const int j = w * kWarp + lane;
    const unsigned b = __ballot_sync(kFull, j < n && frozen[j] != 0);
    if (lane == w) fz = b;
  }
  float pm = s ? kTwoBig : 0.f;  // the path in slot s: its metric,
  int lg = s;                    // its place in the list,
  unsigned map = 0;              // the slot of each smem depth's LLRs,
  unsigned xcur = 0, ucur = 0;   // x and u of the current word,
  float r4 = 0.f;                // the width-4 node, element q on lane q
  float r2a = 0.f, r2b = 0.f;    // the width-2 node, on every lane
  unsigned fzw = 0;              // the frozen mask's current word
  const unsigned rep = static_cast<unsigned>(s) * 0x00249249u;
  // every slot's place in the list, 3 bits a slot (the same on all lanes)
  unsigned lgs = __reduce_or_sync(kFull, q == 0 ? lg << (3 * s) : 0u);

  for (int i = 0; i < n; ++i) {
    if ((i & 31) == 0) fzw = __shfl_sync(kFull, fz, i >> 5);
    const bool is_frozen = (fzw >> (i & 31)) & 1u;
    const int d0 = i ? n_bits - (__ffs(i) - 1) : 1;  // first depth rewritten
    // leaves i .. i + 3 all frozen: decided together from the width-4 node
    const bool quad =
        n >= 8 && (i & 3) == 0 && ((fzw >> (i & 31)) & 15u) == 15u;
    float lam_leaf = 0.f;
    if (i & 1) {  // a right leaf: g from the width-2 node, x bit u[i-1]
      lam_leaf = g_op(r2a, r2b, (xcur >> ((i - 1) & 31)) & 1u);
    } else {
      // the levels of width >= 8, memory to memory (the g reads its parent
      // from the slot the map names, an f from this slot's own)
      for (int d = d0; d <= n_bits - 3; ++d) {
        const int h = n >> d;
        const bool g = i != 0 && d == d0;
        float* dst = own + node_off(n, d);
        if (d == 1) {
          if (g)
            walk_level<true>(chan, dst, h, q, i, xcur, own_x);
          else
            walk_level<false>(chan, dst, h, q, i, xcur, own_x);
        } else {
          const float* src =
              nodes + (g ? (map >> (3 * (d - 2))) & 7u : s) * stride +
              node_off(n, d - 1);
          if (g)
            walk_level<true>(src, dst, h, q, i, xcur, own_x);
          else
            walk_level<false>(src, dst, h, q, i, xcur, own_x);
        }
        __syncwarp();
      }
      // width 4 (depth n_bits - 2, n >= 8), element q on lane q: from the
      // channel (n = 8) or a width-8 node in shared memory
      if (n >= 8 && d0 <= n_bits - 2) {
        const int d = n_bits - 2;
        const bool g = i != 0 && d == d0;
        if (d == 1) {
          r4 = fg(g, chan[q], chan[q + 4], i, 4, q, xcur, own_x);
        } else {
          const float* src =
              nodes + (g ? (map >> (3 * (d - 2))) & 7u : s) * stride +
              node_off(n, d - 1);
          r4 = fg(g, src[q], src[q + 4], i, 4, q, xcur, own_x);
        }
      }
      // width 2 (depth n_bits - 1), on every lane: from the channel (n = 2,
      // 4) or the width-4 node
      if (quad) {
        // the four frozen leaves' LLRs (every x 0: each g an add), their
        // penalties added in leaf order
        const float e0 = __shfl_sync(kFull, r4, 0, kG);
        const float e1 = __shfl_sync(kFull, r4, 1, kG);
        const float e2 = __shfl_sync(kFull, r4, 2, kG);
        const float e3 = __shfl_sync(kFull, r4, 3, kG);
        const float a0 = f_op(e0, e2), a1 = f_op(e1, e3);
        const float b0 = g_op(e0, e2, 0u), b1 = g_op(e1, e3, 0u);
        pm = __fadd_rn(pm, fmaxf(-f_op(a0, a1), 0.f));
        pm = __fadd_rn(pm, fmaxf(-g_op(a0, a1, 0u), 0.f));
        pm = __fadd_rn(pm, fmaxf(-f_op(b0, b1), 0.f));
        pm = __fadd_rn(pm, fmaxf(-g_op(b0, b1, 0u), 0.f));
      } else if (n == 2) {
        r2a = chan[0];
        r2b = chan[1];
      } else {
        const bool g = i != 0 && d0 == n_bits - 1;
        const float a = n == 4 ? chan[q & 1] : r4;
        const float b =
            n == 4 ? chan[(q & 1) + 2] : __shfl_down_sync(kFull, r4, 2, kG);
        const float v = fg(g, a, b, i, 2, q & 1, xcur, own_x);
        r2a = __shfl_sync(kFull, v, 0, kG);
        r2b = __shfl_sync(kFull, v, 1, kG);
      }
      if (!quad) lam_leaf = f_op(r2a, r2b);  // the left leaf
    }
    // this slot now holds depths d0 .. n_bits - 3
    if (d0 <= n_bits - 3) {
      const unsigned low = (1u << (3 * (d0 - 1))) - 1u;
      map = (map & low) | (rep & ~low);
    }

    unsigned ubit = 0;
    if (quad) {
      i += 3;  // all decided 0; the folds of leaf i + 3 follow
    } else if (is_frozen) {
      pm = __fadd_rn(pm, fmaxf(-lam_leaf, 0.f));
      if (!(i & 1) && ((fzw >> ((i + 1) & 31)) & 1u)) {
        // its right sibling frozen too: g with x bit 0
        pm = __fadd_rn(pm, fmaxf(-g_op(r2a, r2b, 0u), 0.f));
        ++i;
      }
    } else {
      // candidate (slot s, u) on lanes 4s + 2u and 4s + 2u + 1, index
      // c = u*8 + lg; each of the two ranks it against the 8 candidates of
      // one u, by (metric, c) as lax.top_k orders them
      const int u = q >> 1;
      const float m = __fadd_rn(pm, fmaxf(u ? lam_leaf : -lam_leaf, 0.f));
      const unsigned c = u * kL + lg;
      const int half = q & 1;
      int before[kL];
#pragma unroll
      for (int k = 0; k < kL; ++k) {
        const float mk = __shfl_sync(kFull, m, 4 * k + 2 * half);
        const unsigned ck = half * kL + ((lgs >> (3 * k)) & 7u);
        before[k] = (mk < m || (mk == m && ck < c)) ? 1 : 0;
      }
      const int cnt = ((before[0] + before[1]) + (before[2] + before[3])) +
                      ((before[4] + before[5]) + (before[6] + before[7]));
      const int rank = cnt + __shfl_xor_sync(kFull, cnt, 1);
      // kept children as bits 4s of a mask (slot s's first lane)
      const unsigned kb = __ballot_sync(kFull, rank < kL);
      const unsigned k0 = kb & 0x11111111u, k1 = (kb >> 2) & 0x11111111u;
      const unsigned both = k0 & k1, none = ~(k0 | k1) & 0x11111111u;
      // the new path of slot s: its own u = 0 child where kept, else its
      // u = 1 child; a slot with neither takes the u = 1 child of the j-th
      // path with both kept, j its place among the slots with neither
      const int take = (k0 >> (kG * s)) & 1u ? 0 : 1;
      const int src =
          (none >> (kG * s)) & 1u
              ? nth_set(both, __popc(none & ((1u << (kG * s)) - 1u)))
              : kG * s;
      lg = __shfl_sync(kFull, rank, src + 2 * take);
      pm = __shfl_sync(kFull, m, src + 2 * take);
      map = __shfl_sync(kFull, map, src + q);
      xcur = __shfl_sync(kFull, xcur, src + q);
      ucur = __shfl_sync(kFull, ucur, src + q);
      r4 = __shfl_sync(kFull, r4, src + q);
      r2a = __shfl_sync(kFull, r2a, src + q);
      r2b = __shfl_sync(kFull, r2b, src + q);
      ubit = static_cast<unsigned>(take);
      lgs = __reduce_or_sync(kFull, q == 0 ? lg << (3 * s) : 0u);
      // a clone's finished words of x and u, all clones at once: clone
      // e & 3 (of at most 4), word e >> 2 of x then u
      const int nwc = i >> 5;
      if (none != 0u && nwc > 0) {
        const int nclone = __popc(none);
        for (int e = lane; e < 4 * 2 * nwc; e += kWarp) {
          const int k = e & 3, r = e >> 2;
          if (k < nclone) {
            const int to = nth_set(none, k) >> 2, fr = nth_set(both, k) >> 2;
            unsigned* base = r < nwc ? xw : uw;
            const int w = r < nwc ? r : r - nwc;
            base[to * nwt + w] = base[fr * nwt + w];
          }
        }
        __syncwarp();
      }
    }

    // decide leaf i, then fold the partial sums of every node it completes
    const int b = i & 31;
    xcur |= ubit << b;
    ucur |= ubit << b;
    for (int sf = 1; sf < kWarp && sf < n && (i & sf); sf <<= 1) {
      const int lo = (i + 1 - 2 * sf) & 31;
      xcur ^= (xcur >> sf) & (((1u << sf) - 1u) << lo);
    }
    if (b == 31 || i == n - 1) {
      if (q == 0) {
        own_x[i >> 5] = xcur;
        own_u[i >> 5] = ucur;
      }
      __syncwarp();
      for (int sf = kWarp; sf < n && (i & sf); sf <<= 1) {
        const int ws = sf >> 5, lws = __ffs(ws) - 1;
        const int lw = (i + 1 - 2 * sf) >> 5;
        for (int e = lane; e < kL * ws; e += kWarp) {
          unsigned* p = xw + (e >> lws) * nwt + lw + (e & (ws - 1));
          p[0] ^= p[ws];
        }
        __syncwarp();
      }
      xcur = 0;
      ucur = 0;
    }
  }

  // the decisions of the path in slot s, as bytes of row lg
  unsigned char* o = u_out + (cw * kL + lg) * n;
  if (n >= 16) {
    for (int p = q; p < n / 16; p += kG) {
      const unsigned bits = own_u[p >> 1] >> ((p & 1) * 16);
      reinterpret_cast<uint4*>(o)[p] =
          make_uint4(spread4(bits), spread4(bits >> 4), spread4(bits >> 8),
                     spread4(bits >> 12));
    }
  } else {
    for (int j = q; j < n; j += kG)
      o[j] = static_cast<unsigned char>((own_u[0] >> j) & 1u);
  }
  if (q == 0) pm_out[cw * kL + lg] = pm;
}

}  // namespace

extern "C" {

// lam [n_cw, n] f32 channel LLRs; plan a host pointer to the code's ScPlan
// (passed to the kernel by value) -> u_out, x_out [n_cw, n] bytes. Returns
// cudaGetLastError(), or cudaErrorInvalidValue unless n = 2^n_bits with
// 1 <= n_bits <= 10 and plan is given.
int modem_polar_sc(const float* lam, long long n_cw, int n, int n_bits,
                   const void* plan, unsigned char* u_out,
                   unsigned char* x_out, void* stream) {
  if (n_bits < 1 || n_bits > 10 || n != (1 << n_bits) || plan == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_cw == 0) return static_cast<int>(cudaSuccess);
  const long long warps = (n_cw + kL - 1) / kL;
  const long long blocks = (warps + kScWarps - 1) / kScWarps;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = kScWarps * sc_warp_bytes(n);
  const cudaError_t err = modem::allow_smem(sc_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  sc_kernel<<<static_cast<unsigned>(blocks), kScWarps * kWarp, smem,
              static_cast<cudaStream_t>(stream)>>>(
      lam, n_cw, n, n_bits, *static_cast<const ScPlan*>(plan), u_out, x_out);
  return static_cast<int>(cudaGetLastError());
}

// lam [n_cw, n] f32 channel LLRs; frozen [n] bytes -> u_out [n_cw, 8, n]
// bytes (the post-selection decisions of the 8 paths, in list order) and
// pm_out [n_cw, 8] f32 path metrics. Returns cudaGetLastError(), or
// cudaErrorInvalidValue unless n = 2^n_bits with 1 <= n_bits <= 10.
int modem_polar_scl(const float* lam, long long n_cw, int n, int n_bits,
                    const unsigned char* frozen, unsigned char* u_out,
                    float* pm_out, void* stream) {
  if (n_bits < 1 || n_bits > 10 || n != (1 << n_bits))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_cw == 0) return static_cast<int>(cudaSuccess);
  const long long blocks = (n_cw + kSclWarps - 1) / kSclWarps;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = kSclWarps * scl_warp_bytes(n);
  cudaError_t err = modem::allow_smem(scl_kernel, smem);
  // as many codewords an SM as shared memory holds
  if (err == cudaSuccess) err = modem::prefer_shared(scl_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  scl_kernel<<<static_cast<unsigned>(blocks), kSclWarps * kWarp, smem,
               static_cast<cudaStream_t>(stream)>>>(lam, n_cw, n, n_bits,
                                                    frozen, u_out, pm_out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
