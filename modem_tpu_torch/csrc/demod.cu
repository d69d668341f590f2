// The reference receiver's product detector: replaces
// modem_tpu/ops/pallas_demod.py::_demod_kernel (K5), the hot loop of
// `demodulator.rs:44-56`. Per passband sample at position p of the stream
// e = hist ++ x (hist: the previous block's last samples, read in place),
//
//   u     = ((p mod sr + off) mod sr * hz) mod sr        exact, int32
//   total = f32(u) * w + phi[c],  w = f32(2*pi/sr)
//   mi    = x * cos(total),  mq = -x * sin(total)
//   i[n]  = 2 * sum_{j < K} taps[j] * mi[n - j],  q likewise from mq,
//
// for the positions of x only (outputs n = h .. h+N-1 of e); positions
// before e's start read zero (the zero FIR history at a stream's start).
// off is e[0]'s carrier counter mod sr, read from the device, so a stream
// never waits on the host. hz * sr < 2^31 keeps u exact (the wrapper
// checks), and sincosf is the accurate one: no fast math.
//
// What bounds it on this card: 4 B in and 8 B out per sample against 128
// FMAs (256 FLOP), 21 FLOP/B: the FMA issue rate, a little above the 3.35
// TB/s memory floor. So every instruction that is not one of those FMAs
// costs time, and the design removes them:
//
// - the carrier phase is walked, not reckoned: u is always a multiple of
//   g = gcd(hz, sr), so the phase k = u / unit (unit = g where the P =
//   sr / g phases fit a table of kNcoTable, else 1) advances by `step`
//   units a sample, a 32-bit add and one conditional subtract. The start
//   of a block's first tile takes the 64-bit arithmetic, each later tile
//   of the channel one add, each thread a fixed offset into it.
// - where P <= kNcoTable, cos and sin come from a per-channel table of
//   sincosf(__fadd_rn(__fmul_rn(f32(k * g), w), phi[c])), the expression
//   the per-sample code computes, so its bits; rebuilt when a block's item
//   changes channel. Otherwise one sincosf a sample on the walked phase.
// - the mix fills two skewed rails in shared memory, then the FIR core of
//   common.cuh filters both (persistent blocks, the next tile's passband by
//   cp.async while this one is mixed and filtered, the history copied from
//   the tile before in shared memory, matched_fixed for 64 and 65 taps with
//   every tap a constant-bank operand, the generic form for other lengths),
//   and the outputs go out through shared memory, 16-byte pieces. A row's
//   tiles start up to 3 samples early so that its loads and stores lie on
//   16-byte boundaries whatever the row length.
//
// Each output's arithmetic depends only on its own position, never on the
// tile or on where a streaming push began, nor on whether its cos and sin
// came from the table: pushes equal one shot bit for bit.

#include "common.cuh"

namespace {

using modem::kCoreThreads;
using modem::skew;

constexpr int kMaxDemodTaps = 65;
// Outputs a thread and a tile. 8 a thread (tiles of 1024, 27 KB of shared
// memory a block, 8 blocks an SM): with 16 (54 KB, 4 blocks) the kernel
// took 5% longer on aligned rows and 13% on the reference path's rows of
// 32783 samples (NVIDIA H100, bench_demod_torch.py).
constexpr int kR = 8;
constexpr int kTile = kR * kCoreThreads;

// The carrier walk (the host's ops.demod_kernel.carrier_walk): phases in
// units of `unit`, `period` of them a carrier cycle, `step` a sample.
struct Walk {
  int hz, sr;
  int period;
  int step;
  int unit;
  float w;  // f32(2*pi/sr)
};

// Phase k advanced by d units, 0 <= d < period.
__device__ __forceinline__ int walk_add(const Walk& wk, int k, int d) {
  k += d;
  return k >= wk.period ? k - wk.period : k;
}

// The phase of d >= 0 samples on from phase k (64-bit: once a tile).
__device__ __forceinline__ int walk_skip(const Walk& wk, int k, long long d) {
  return walk_add(wk, k, static_cast<int>(d % wk.period * wk.step %
                                          wk.period));
}

// The angle the per-sample code takes the sincosf of: two roundings, as
// the plain version, no FMA contraction.
__device__ __forceinline__ float walk_angle(const Walk& wk, int k, float ph) {
  return __fadd_rn(__fmul_rn(static_cast<float>(k * wk.unit), wk.w), ph);
}

// L > 0: the instantiation for L taps; 0: the generic one (k_rt <= 65).
// kTable: the carrier's phases from the per-channel table.
template <int L, bool kTable>
__global__ void __launch_bounds__(kCoreThreads)
    demod_kernel(const float* __restrict__ hist, int h,
                 const float* __restrict__ x, long long n, long long n_tiles,
                 long long n_items, int k_rt,
                 const __grid_constant__ modem::Taps taps, Walk wk,
                 const int* __restrict__ off_ptr,
                 const float* __restrict__ phi, float* __restrict__ out_i,
                 float* __restrict__ out_q) {
  const int k = L > 0 ? L : k_rt;
  const int lb = k - 1;
  const int lead = modem::fir_lead(k);
  const int pos0 = modem::fir_pos0(k);
  const int f_len = modem::fir_buf_len(k, kTile);
  const int y_len = modem::skew_len(kTile);
  // rails [2][f_len] skewed; passband [2 buffers][kTile]; output
  // staging [2 rails][y_len] skewed; the table [period] of (cos, sin)
  extern __shared__ __align__(16) float smem[];
  float* const yi = smem;
  float* const yq = yi + f_len;
  float* const raw = yq + f_len;
  float* const oi = raw + 2 * kTile;
  float* const oq = oi + y_len;
  float2* const tab = reinterpret_cast<float2*>(oq + y_len);

  long long lo, hi;
  modem::block_items(n_items, lo, hi);

  // the phase of x[0], e's sample h: ((h + off) mod sr * hz mod sr) / unit
  const long long off = ((*off_ptr % wk.sr) + wk.sr) % wk.sr;
  const int k_x0 = static_cast<int>((h % wk.sr + off) % wk.sr * wk.hz %
                                    wk.sr) / wk.unit;
  // this thread's first sample of a tile, and a pass's stride, in phase
  const int k_thr = walk_skip(wk, 0, 4LL * threadIdx.x);
  const int k_pass = walk_skip(wk, 0, 4LL * kCoreThreads);
  const int k_tile = walk_skip(wk, 0, kTile);

  // Item it's first sample (x's index): a row's tiles start misalign(row)
  // samples early, so that x + c*n + n0 and the outputs' row at n0 lie on
  // 16-byte boundaries.
  auto origin = [&](long long it) {
    const long long c = it / n_tiles;
    return (it % n_tiles) * kTile - modem::misalign(x + c * n);
  };

  // Bring item it's passband into buffer b by cp.async; the first tile's
  // head, before x's first sample, from hist (zero before the stream).
  auto issue = [&](long long it, int b) {
    const long long c = it / n_tiles;
    const long long n0 = origin(it);
    float* dst = raw + b * kTile;
    const int first = n0 < 0 ? static_cast<int>(-n0) : 0;
    for (int i = threadIdx.x; i < first; i += kCoreThreads) {
      const long long p = h + n0 + i;  // hist's index
      if (p < 0)
        dst[i] = 0.f;
      else
        modem::cp_async4(dst + i, hist + c * h + p);
    }
    const long long left = n - n0;
    modem::load_span<false>(dst, x + c * n + n0, 0, kTile,
                            left < kTile ? static_cast<int>(left) : kTile,
                            first);
    modem::cp_async_commit();
  };

  if (lo < hi) issue(lo, 0);
  long long c_tab = -1;
  int kt = 0;  // the phase of the tile's first sample
  for (long long it = lo; it < hi; ++it) {
    const int b = static_cast<int>((it - lo) & 1);
    const long long c = it / n_tiles;
    const long long n0 = origin(it);  // >= -3
    const bool cont = it != lo && it % n_tiles != 0;
    const bool cont_next = it + 1 < hi && (it + 1) % n_tiles != 0;
    kt = cont ? walk_add(wk, kt, k_tile)
              : walk_skip(wk, k_x0, n0 + 4LL * wk.period);
    const float ph = phi[c];
    if (kTable && c != c_tab) {  // every thread is past the last mix
      for (int j = threadIdx.x; j < wk.period; j += kCoreThreads) {
        float s, co;
        sincosf(walk_angle(wk, j, ph), &s, &co);
        tab[j] = make_float2(co, s);
      }
      c_tab = c;
    }
    if (it + 1 < hi) {
      issue(it + 1, b ^ 1);
      modem::cp_async_wait<1>();
    } else {
      modem::cp_async_wait<0>();
    }
    __syncthreads();

    // mix the tile's own samples, 4 a step: rail position pos0 + i
    const float* src = raw + b * kTile;
    int kq = walk_add(wk, kt, k_thr);
    for (int q = threadIdx.x; 4 * q < kTile; q += kCoreThreads) {
      const float4 v = *reinterpret_cast<const float4*>(src + 4 * q);
      const float xv[4] = {v.x, v.y, v.z, v.w};
      float mi[4], mq[4];
      int ke = kq;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float s, co;
        if constexpr (kTable) {
          const float2 t = tab[ke];
          co = t.x;
          s = t.y;
        } else {
          sincosf(walk_angle(wk, ke, ph), &s, &co);
        }
        ke = walk_add(wk, ke, wk.step);
        mi[e] = xv[e] * co;
        mq[e] = -xv[e] * s;
      }
      const int p = skew(pos0 + 4 * q);
      *reinterpret_cast<float4*>(yi + p) = make_float4(mi[0], mi[1], mi[2],
                                                       mi[3]);
      *reinterpret_cast<float4*>(yq + p) = make_float4(mq[0], mq[1], mq[2],
                                                       mq[3]);
      kq = walk_add(wk, kq, k_pass);
    }
    if (!cont) {  // the history, read in place: x before n0, then hist
      for (int d = threadIdx.x; d < lb; d += kCoreThreads) {
        const long long i = n0 - lb + d;  // x's index; hist's is h + i
        float xv = 0.f;
        if (i >= 0) {
          xv = x[c * n + i];
        } else if (h + i >= 0) {
          xv = hist[c * h + h + i];
        }
        float s, co;
        // lb - d samples before the tile: a whole period on, less them
        const int kd = walk_skip(wk, kt, wk.period * 64LL - (lb - d));
        sincosf(walk_angle(wk, kd, ph), &s, &co);
        yi[skew(lead + d)] = xv * co;
        yq[skew(lead + d)] = -xv * s;
      }
    }
    __syncthreads();

    const long long left = n - n0;
    const int count = left < kTile ? static_cast<int>(left) : kTile;
    const int r0 = kR * static_cast<int>(threadIdx.x);
    if (r0 < count) {
      float acc[2][kR] = {};
      const float* const rails[2] = {yi, yq};
      if constexpr (L > 0)
        modem::matched_fixed<kR, 1, L, modem::fir_lead(L)>(rails, r0, taps,
                                                           acc);
      else
        modem::matched_generic<kR, 1>(rails, r0 + lead, 1, k, taps, acc);
      float* const out[2] = {oi, oq};
      modem::stage_run(out, r0, acc, 2.f);
    }
    __syncthreads();
    const int first = n0 < 0 ? static_cast<int>(-n0) : 0;
    modem::store_tile(out_i + c * n + n0, oi, first, count);
    modem::store_tile(out_q + c * n + n0, oq, first, count);
    if (cont_next) {  // the next tile's history is this tile's last lb
      for (int d = threadIdx.x; d < lb; d += kCoreThreads) {
        yi[skew(lead + d)] = yi[skew(lead + kTile + d)];
        yq[skew(lead + d)] = yq[skew(lead + kTile + d)];
      }
    }
    // the next iteration writes the rails and the staging rows after its
    // __syncthreads; its table after this iteration's last
  }
}

template <int L, bool kTable>
int launch(const float* hist, int h, const float* x, long long n_ch,
           long long n, const modem::Taps& taps, int n_taps, const Walk& wk,
           const int* off, const float* phi, float* out_i, float* out_q,
           cudaStream_t stream) {
  auto kernel = demod_kernel<L, kTable>;
  const size_t smem =
      (2 * static_cast<size_t>(modem::fir_buf_len(n_taps, kTile)) +
       2 * kTile + 2 * modem::skew_len(kTile) +
       (kTable ? 2 * wk.period : 0)) *
      sizeof(float);
  const long long n_tiles =
      modem::fir_tiles(n, modem::fir_shift(x, n), kTile);
  const long long n_items = n_ch * n_tiles;
  unsigned grid = 0;
  const cudaError_t err = modem::persistent_grid(
      kernel, kCoreThreads, smem, modem::kCoreBlocks, n_items, grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kCoreThreads, smem, stream>>>(hist, h, x, n, n_tiles,
                                               n_items, n_taps, taps, wk, off,
                                               phi, out_i, out_q);
  return static_cast<int>(cudaGetLastError());
}

template <bool kTable>
int launch_taps(const float* hist, int h, const float* x, long long n_ch,
                long long n, const modem::Taps& taps, int n_taps,
                const Walk& wk, const int* off, const float* phi,
                float* out_i, float* out_q, cudaStream_t s) {
  switch (n_taps) {
    case 64:
      return launch<64, kTable>(hist, h, x, n_ch, n, taps, n_taps, wk, off,
                                phi, out_i, out_q, s);
    case 65:
      return launch<65, kTable>(hist, h, x, n_ch, n, taps, n_taps, wk, off,
                                phi, out_i, out_q, s);
    default:
      return launch<0, kTable>(hist, h, x, n_ch, n, taps, n_taps, wk, off,
                               phi, out_i, out_q, s);
  }
}

}  // namespace

extern "C" {

// hist [n_ch, h], x [n_ch, n] f32; taps a host pointer to n_taps <= 65 taps
// in a modem::Taps (passed to the kernel by value); the carrier hz, sr,
// w = f32(2*pi/sr) and its walk (period, step, unit; table: the phases from
// a table of `period` entries, period <= 2048); off: one int32 on the device
// (hist[0]'s carrier counter); phi [n_ch] f32 -> out_i, out_q [n_ch, n].
// Returns cudaGetLastError(), or cudaErrorInvalidValue for arguments the
// kernel does not take.
int modem_demod(const float* hist, int h, const float* x, long long n_ch,
                long long n, const void* taps, int n_taps, int hz, int sr,
                float w, int period, int step, int unit, int table,
                const int* off, const float* phi, float* out_i, float* out_q,
                void* stream) {
  if (taps == nullptr || n_taps < 1 || n_taps > kMaxDemodTaps || h < 0 ||
      sr < 1 || hz < 0 || static_cast<long long>(hz) * sr >= (1LL << 31) ||
      unit < 1 || period < 1 || static_cast<long long>(period) * unit != sr ||
      step < 0 || step >= period || (table && period > modem::kNcoTable))
    return static_cast<int>(cudaErrorInvalidValue);
  const Walk wk{hz, sr, period, step, unit, w};
  const modem::Taps& t = *static_cast<const modem::Taps*>(taps);
  const auto s = static_cast<cudaStream_t>(stream);
  if (table)
    return launch_taps<true>(hist, h, x, n_ch, n, t, n_taps, wk, off, phi,
                             out_i, out_q, s);
  return launch_taps<false>(hist, h, x, n_ch, n, t, n_taps, wk, off, phi,
                            out_i, out_q, s);
}

}  // extern "C"
