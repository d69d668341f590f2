// Causal FIR with a carried history: replaces
// modem_tpu/ops/pallas_fir.py::_fir_kernel (K4).
//
//   y[c, n] = sum_{j < K} taps[j] * e[c, n + K-1 - j],  e = state ++ x,
//
// x [C, N] and y [C, N] time contiguous, state [C, K-1] the previous
// block's last K-1 inputs, read in place (null at a stream's start: zeros,
// made here): the wrapper concatenates and fills nothing. Every output is
// one fmaf chain with the taps in the order j = 0, 1, ..., K-1 from 0, on
// every route, so pushes equal one shot bit for bit.
//
// What bounds it on this card: at 64 taps it moves 8 B per output (4 in, 4
// out) and does 64 FMAs = 128 FLOP, 16 FLOP/B against the H100's 20
// (67 TFLOP/s f32 over 3.35 TB/s): memory first, the FMA issue rate close
// behind, so the loads must overlap the filter and the filter must issue
// little besides its FMAs.
//
// The short route (K <= 256, the taps by value in a Taps kernel parameter)
// runs on the FIR core of common.cuh: persistent blocks, each walking a
// contiguous range of (channel, tile of kTile outputs) items; the next
// tile's samples stream into the other of two skewed buffers by cp.async
// while the current one is filtered, and its K-1 samples of history are
// copied from this tile's tail in shared memory, not read again (a block's
// first tile of a channel reads them in place from state or x). Each thread
// runs the register-blocked matched_fixed over its kR outputs: every tap a
// constant-bank operand, 16-byte shared loads, under 0.1 load an FMA. Its
// outputs go through shared memory so that each warp's stores are whole
// 16-byte pieces of one contiguous run. A row's tiles start up to 3 samples
// early, so that they lie on 16-byte boundaries whatever the row length
// (the reference path's blocks of 32783 samples). The tap counts of the
// paths (23: the Hilbert filter, 32: the GMSK transient, 64: the
// demodulator's lowpass, 65: the RRC) are instantiated at compile time, any
// other K <= 256 takes a generic instantiation (matched_generic's SPS-1
// path: the taps in chunks of 16, each read at a run-time index from the
// parameter and fed to all of a thread's outputs, the samples in 16-byte
// loads). The history, and a row's first few samples, stream in 4 bytes at
// a time, still by cp.async.
//
// The long route (K > 256, up to about 25,000 taps): one block per
// (channel, tile) item stages its tile and K-1 samples of history in shared
// memory, filters it (fir_tile.cuh, the taps staged in shared memory) and
// writes the tile back through shared memory. K is limited only by the
// tile: (K rounded up to 4) + padded(kFirTile + K - 1) + padded(kFirTile)
// floats must fit 227 KB.

#include "common.cuh"
#include "fir_tile.cuh"

namespace {

using modem::kCoreThreads;
using modem::kFirThreads;
using modem::kFirTile;
using modem::pad8;
using modem::padded_len;
using modem::skew;

// ---- the short route ----

// Outputs a thread and a tile. 16 a thread: with 8 (tiles of 1024, twice
// the blocks an SM) the 64-tap filter took 4% longer and the generic one
// at 256 taps 60% longer (NVIDIA H100, bench_demod_torch.py).
constexpr int kR = 16;
constexpr int kTile = kR * kCoreThreads;

// L > 0: the instantiation for L taps; 0: the generic one (k_rt taps).
template <int L>
__global__ void __launch_bounds__(kCoreThreads)
    fir_core_kernel(const float* __restrict__ x,
                    const float* __restrict__ state, long long n,
                    long long n_tiles, long long n_items, int k_rt,
                    const __grid_constant__ modem::Taps taps,
                    float* __restrict__ y) {
  const int k = L > 0 ? L : k_rt;
  const int h = k - 1;
  const int lead = modem::fir_lead(k);
  const int pos0 = modem::fir_pos0(k);
  const int f_len = modem::fir_buf_len(k, kTile);
  // two filter buffers [2][f_len], then the output staging row
  extern __shared__ __align__(16) float smem[];
  float* const ys = smem + 2 * f_len;

  long long lo, hi;
  modem::block_items(n_items, lo, hi);

  // Item it's first output: a row's tiles start misalign(row) samples
  // early, so that x + c*n + o0 and y + c*n + o0 lie on 16-byte boundaries.
  auto origin = [&](long long it) {
    const long long c = it / n_tiles;
    return (it % n_tiles) * kTile - modem::misalign(x + c * n);
  };

  // Bring item `it` into buffer b by cp.async: its own samples and, unless
  // the tile before left it (cont), the history e[o0 .. o0+h-1], read in
  // place (4 bytes at a time: state's rows of K-1 floats are not aligned).
  // Samples before the stream (e < 0, only the outputs before the row's
  // first read them), and the history when state is null, are zero.
  auto copy_e = [&](float* d, long long c, long long e) {
    if (e < 0 || (state == nullptr && e < h))
      *d = 0.f;
    else
      modem::cp_async4(d, e < h ? state + c * h + e : x + c * n + e - h);
  };
  auto issue = [&](long long it, int b, bool cont) {
    const long long c = it / n_tiles;
    const long long o0 = origin(it);
    float* dst = smem + b * f_len;
    if (!cont) {
      for (int d = threadIdx.x; d < h; d += kCoreThreads)
        copy_e(dst + skew(lead + d), c, o0 + d);
    }
    // the first tile's head, before x's first sample, is history too
    const int first = o0 < 0 ? static_cast<int>(-o0) : 0;
    for (int i = threadIdx.x; i < first; i += kCoreThreads)
      copy_e(dst + skew(pos0 + i), c, o0 + h + i);
    const long long left = n - o0;
    modem::load_span<true>(dst, x + c * n + o0, pos0, kTile,
                           left < kTile ? static_cast<int>(left) : kTile,
                           first);
    modem::cp_async_commit();
  };

  if (lo < hi) issue(lo, 0, false);
  for (long long it = lo; it < hi; ++it) {
    const int b = static_cast<int>((it - lo) & 1);
    const bool cont_next = it + 1 < hi && (it + 1) % n_tiles != 0;
    if (it + 1 < hi) {
      issue(it + 1, b ^ 1, cont_next);
      modem::cp_async_wait<1>();
    } else {
      modem::cp_async_wait<0>();
    }
    __syncthreads();

    const float* cur = smem + b * f_len;
    if (cont_next) {  // the next tile's history is this tile's last h samples
      float* nxt = smem + (b ^ 1) * f_len;
      for (int d = threadIdx.x; d < h; d += kCoreThreads)
        nxt[skew(lead + d)] = cur[skew(lead + kTile + d)];
    }
    const long long c = it / n_tiles;
    const long long o0 = origin(it);
    const long long left = n - o0;
    const int count = left < kTile ? static_cast<int>(left) : kTile;
    const int r0 = kR * static_cast<int>(threadIdx.x);
    if (r0 < count) {
      float acc[1][kR] = {};
      const float* const rail[1] = {cur};
      if constexpr (L > 0)
        modem::matched_fixed<kR, 1, L, modem::fir_lead(L)>(rail, r0, taps,
                                                           acc);
      else
        modem::matched_generic<kR, 1>(rail, r0 + lead, 1, k, taps, acc);
      float* const out[1] = {ys};
      modem::stage_run(out, r0, acc, 1.f);
    }
    __syncthreads();
    // the next iteration's first write to ys or to buffer b follows its
    // __syncthreads (or, for the issue into b, this one)
    modem::store_tile(y + c * n + o0, ys, o0 < 0 ? static_cast<int>(-o0) : 0,
                      count);
  }
}

template <int L>
int launch_core(const float* x, const float* state, long long n_ch,
                long long n, const modem::Taps& taps, int n_taps, float* y,
                cudaStream_t stream) {
  auto kernel = fir_core_kernel<L>;
  const size_t smem =
      (2 * static_cast<size_t>(modem::fir_buf_len(n_taps, kTile)) +
       modem::skew_len(kTile)) * sizeof(float);
  const long long n_tiles =
      modem::fir_tiles(n, modem::fir_shift(x, n), kTile);
  const long long n_items = n_ch * n_tiles;
  unsigned grid = 0;
  const cudaError_t err = modem::persistent_grid(
      kernel, kCoreThreads, smem, modem::kCoreBlocks, n_items, grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kCoreThreads, smem, stream>>>(x, state, n, n_tiles, n_items,
                                               n_taps, taps, y);
  return static_cast<int>(cudaGetLastError());
}

// ---- the long route ----

size_t fir_smem_bytes(int k) {
  const int kt = (k + 3) & ~3;
  return (static_cast<size_t>(kt) + padded_len(kFirTile + k - 1) +
          padded_len(kFirTile)) * sizeof(float);
}

__global__ void __launch_bounds__(kFirThreads)
fir_long_kernel(const float* __restrict__ x, const float* __restrict__ state,
                long long n, long long n_tiles, const float* __restrict__ taps,
                int k, float* __restrict__ y) {
  extern __shared__ float4 smem4[];
  float* staps = reinterpret_cast<float*>(smem4);
  float* xs = staps + ((k + 3) & ~3);
  float* ys = xs + padded_len(kFirTile + k - 1);

  const long long c = blockIdx.x / n_tiles;
  const long long o0 = (blockIdx.x % n_tiles) * kFirTile;
  const int h = k - 1;
  for (int t = threadIdx.x; t < k; t += blockDim.x) staps[t] = taps[t];

  // xs[i] = e[o0 + i]: history first, then x, zero past x's end
  const float* xr = x + c * n;
  for (int i = threadIdx.x; i < kFirTile + h; i += blockDim.x) {
    const long long e = o0 + i;
    float v = 0.f;
    if (e < h) {
      if (state != nullptr) v = state[c * h + e];
    } else if (e - h < n) {
      v = xr[e - h];
    }
    xs[pad8(i)] = v;
  }
  __syncthreads();

  float acc[modem::kFirPer];
  modem::fir_outputs(xs, staps, k, modem::kFirPer * threadIdx.x + h, acc);
#pragma unroll
  for (int r = 0; r < modem::kFirPer; ++r)
    ys[pad8(modem::kFirPer * threadIdx.x + r)] = acc[r];
  __syncthreads();

  const long long left = n - o0;
  const int count = static_cast<int>(left < kFirTile ? left : kFirTile);
  float* yr = y + c * n + o0;
  for (int i = threadIdx.x; i < count; i += blockDim.x) yr[i] = ys[pad8(i)];
}

int launch_long(const float* x, const float* state, long long n_ch,
                long long n, const float* taps, int n_taps, float* y,
                cudaStream_t stream) {
  const size_t smem = fir_smem_bytes(n_taps);
  if (smem > modem::kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const long long n_tiles = (n + kFirTile - 1) / kFirTile;
  const unsigned blocks = modem::grid_blocks(n_ch, n_tiles);
  if (blocks == 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = modem::allow_smem(fir_long_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fir_long_kernel<<<blocks, kFirThreads, smem, stream>>>(x, state, n, n_tiles,
                                                         taps, n_taps, y);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x [n_ch, n], state [n_ch, n_taps-1] f32 (null: a zero history, the
// stream's start) -> y [n_ch, n]. The taps: taps a
// host pointer to them in a modem::Taps, passed to the kernel by value (the
// short route: n_taps <= 256; 23, 32, 64 and 65 compiled, any other count
// generic), or taps null and taps_dev the device array (the long route: any
// n_taps whose tile fits shared memory). Returns cudaGetLastError(), or
// cudaErrorInvalidValue for arguments the kernels do not take.
int modem_fir(const float* x, const float* state, long long n_ch, long long n,
              const void* taps, const float* taps_dev, int n_taps, float* y,
              void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (n_taps < 1 || (taps != nullptr && n_taps > modem::kMaxTaps) ||
      (taps == nullptr && taps_dev == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (taps == nullptr)
    return launch_long(x, state, n_ch, n, taps_dev, n_taps, y, s);
  const modem::Taps& t = *static_cast<const modem::Taps*>(taps);
  switch (n_taps) {
    case 23: return launch_core<23>(x, state, n_ch, n, t, n_taps, y, s);
    case 32: return launch_core<32>(x, state, n_ch, n, t, n_taps, y, s);
    case 64: return launch_core<64>(x, state, n_ch, n, t, n_taps, y, s);
    case 65: return launch_core<65>(x, state, n_ch, n, t, n_taps, y, s);
    default: return launch_core<0>(x, state, n_ch, n, t, n_taps, y, s);
  }
}

}  // extern "C"
