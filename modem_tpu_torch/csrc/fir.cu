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
// The long route (the taps read from the device: every K > 256, and any K a
// caller hands that way) runs on the long core, the same persistent walk
// with a filter of its own (fir_long_core): the taps staged in shared memory
// once a block, 32 outputs a thread, the taps in chunks of 16 read as 16-byte
// broadcasts, each chunk's samples in 16-byte loads at compile-time offsets,
// so that FFMAs are nearly all a thread issues (at K >= 257 the work is
// f32 operations: 2K FLOP an output against 8 bytes). It takes K up to
// 15,009 taps (its taps and two buffers of 4096 outputs after a lead of
// 32-63 samples and the K-1 of history in 227 KB; the outputs are staged in
// the buffer just filtered). Past that, up to 25,176 taps, the first
// version (fir_long_kernel) runs: one block per (channel, tile) item stages
// its tile and K-1 samples of history in shared memory, filters it
// (fir_tile.cuh, the taps staged in shared memory) and writes the tile back
// through shared memory; (K rounded up to 4) + padded(kFirTile + K - 1) +
// padded(kFirTile) floats must fit 227 KB. The split is by K alone;
// modem_fir_long_first runs the first version at any K.

#include "common.cuh"
#include "fir_tile.cuh"

namespace {

using modem::kCoreThreads;
using modem::kFirThreads;
using modem::kFirTile;
using modem::pad8;
using modem::padded_len;
using modem::skew;
using modem::skew_len;

// ---- the short route ----

// Outputs a thread and a tile. 16 a thread: with 8 (tiles of 1024, twice
// the blocks an SM) the 64-tap filter took 4% longer and the generic one
// at 256 taps 60% longer (NVIDIA H100, bench_demod_torch.py).
constexpr int kR = 16;
constexpr int kTile = kR * kCoreThreads;

// The persistent walk of both cores: this block's (channel, tile of
// R * kThreads outputs) items in order, buffer b holding the current tile
// while the next streams into the other, each thread's R outputs from
// filter(buffer, r0, acc), staged and stored in 16-byte pieces. Each buffer
// is f_len floats, skewed; position lead + i holds stream sample o0 - h + i
// (h = k - 1), so the tile's own samples start at pos0 = lead + h, which
// must be a multiple of 4. The outputs are staged in a row of their own
// after the two buffers, or, kInPlace, in the current buffer once every
// thread has read it (one barrier more a tile, the row's shared memory
// less); the next tile's load is then issued after the barrier that opens
// a tile, when every thread has stored the tile before from its buffer.
template <int R, int kThreads, bool kInPlace, typename Filter>
__device__ __forceinline__ void fir_walk(const float* __restrict__ x,
                                         const float* __restrict__ state,
                                         long long n, long long n_tiles,
                                         long long n_items, int k, int lead,
                                         int f_len, float* smem,
                                         float* __restrict__ y,
                                         Filter filter) {
  constexpr int kTileN = R * kThreads;
  const int h = k - 1;
  const int pos0 = lead + h;
  // two filter buffers [2][f_len], then the output staging row
  float* const ys = smem + 2 * f_len;

  long long lo, hi;
  modem::block_items(n_items, lo, hi);

  // Item it's first output: a row's tiles start misalign(row) samples
  // early, so that x + c*n + o0 and y + c*n + o0 lie on 16-byte boundaries.
  auto origin = [&](long long it) {
    const long long c = it / n_tiles;
    return (it % n_tiles) * kTileN - modem::misalign(x + c * n);
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
      for (int d = threadIdx.x; d < h; d += kThreads)
        copy_e(dst + skew(lead + d), c, o0 + d);
    }
    // the first tile's head, before x's first sample, is history too
    const int first = o0 < 0 ? static_cast<int>(-o0) : 0;
    for (int i = threadIdx.x; i < first; i += kThreads)
      copy_e(dst + skew(pos0 + i), c, o0 + h + i);
    const long long left = n - o0;
    modem::load_span<true>(dst, x + c * n + o0, pos0, kTileN,
                           left < kTileN ? static_cast<int>(left) : kTileN,
                           first);
    modem::cp_async_commit();
  };

  if (lo < hi) issue(lo, 0, false);
  for (long long it = lo; it < hi; ++it) {
    const int b = static_cast<int>((it - lo) & 1);
    const bool cont_next = it + 1 < hi && (it + 1) % n_tiles != 0;
    if constexpr (kInPlace) {
      modem::cp_async_wait<0>();
      __syncthreads();
      if (it + 1 < hi) issue(it + 1, b ^ 1, cont_next);
    } else {
      if (it + 1 < hi) {
        issue(it + 1, b ^ 1, cont_next);
        modem::cp_async_wait<1>();
      } else {
        modem::cp_async_wait<0>();
      }
      __syncthreads();
    }

    float* const cur = smem + b * f_len;
    if (cont_next) {  // the next tile's history is this tile's last h samples
      float* nxt = smem + (b ^ 1) * f_len;
      for (int d = threadIdx.x; d < h; d += kThreads)
        nxt[skew(lead + d)] = cur[skew(lead + kTileN + d)];
    }
    const long long c = it / n_tiles;
    const long long o0 = origin(it);
    const long long left = n - o0;
    const int count = left < kTileN ? static_cast<int>(left) : kTileN;
    const int r0 = R * static_cast<int>(threadIdx.x);
    float* const staged = kInPlace ? cur : ys;
    if constexpr (kInPlace) {
      float acc[1][R] = {};
      if (r0 < count) filter(cur, r0, acc);
      __syncthreads();  // every thread has read the tile
      if (r0 < count) {
        float* const out[1] = {staged};
        modem::stage_run(out, r0, acc, 1.f);
      }
    } else if (r0 < count) {
      float acc[1][R] = {};
      filter(cur, r0, acc);
      float* const out[1] = {staged};
      modem::stage_run(out, r0, acc, 1.f);
    }
    __syncthreads();
    // the next iteration's first write to ys or to buffer b follows its
    // __syncthreads (or, for the issue into b, this one)
    modem::store_tile(y + c * n + o0, staged,
                      o0 < 0 ? static_cast<int>(-o0) : 0, count);
  }
}

// L > 0: the instantiation for L taps; 0: the generic one (k_rt taps).
template <int L>
__global__ void __launch_bounds__(kCoreThreads)
    fir_core_kernel(const float* __restrict__ x,
                    const float* __restrict__ state, long long n,
                    long long n_tiles, long long n_items, int k_rt,
                    const __grid_constant__ modem::Taps taps,
                    float* __restrict__ y) {
  const int k = L > 0 ? L : k_rt;
  const int lead = modem::fir_lead(k);
  extern __shared__ __align__(16) float smem[];
  fir_walk<kR, kCoreThreads, false>(
      x, state, n, n_tiles, n_items, k, lead, modem::fir_buf_len(k, kTile),
      smem, y, [&](const float* cur, int r0, float (&acc)[1][kR]) {
        const float* const rail[1] = {cur};
        if constexpr (L > 0)
          modem::matched_fixed<kR, 1, L, modem::fir_lead(L)>(rail, r0, taps,
                                                             acc);
        else
          modem::matched_generic<kR, 1>(rail, r0 + lead, 1, k, taps, acc);
      });
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

// ---- the long core (the device-taps path up to kMaxSmem) ----
//
// Every thread owns kLR = 32 consecutive outputs and walks the taps in
// chunks of 16: a chunk's 48-sample window in 12 16-byte loads and its taps
// in 4 broadcast 16-byte loads from shared memory, then 16 x 32 FFMAs, each
// output's chain still j = 0, 1, ..., K-1. The history starts at
// long_lead(K), so that the tile's own samples start at a multiple of 32
// and every thread's run at a skew row: a chunk's window then starts 16 or
// 0 samples into a row, alternately, and both forms read at compile-time
// offsets from one pointer that steps back 36 floats every two chunks (the
// two windows of a pair share 32 samples, which nvcc loads once: 24 loads
// for 1024 FFMAs). The loop runs whole pairs of chunks with no predicate;
// an odd chunk and the K mod 16 taps of the last, partial one (taps past K
// are not read into any FFMA) follow it once. long_lead leaves 32 floats
// before the oldest history sample, so that no window's load starts before
// the buffer.
constexpr int kLR = 32;                          // outputs a thread
constexpr int kLongThreads = 128;
constexpr int kLongTile = kLR * kLongThreads;    // outputs a tile
constexpr int kChunk = 16;                       // taps a chunk

__host__ __device__ constexpr int long_lead(int k) {
  return ((1 - k) & 31) + 32;
}

// Floats of the taps' copy (a whole number of chunks) and of a buffer.
__host__ __device__ constexpr int long_taps_len(int k) {
  return (k + kChunk - 1) & ~(kChunk - 1);
}

__host__ __device__ inline int long_buf_len(int k) {
  return skew_len(long_lead(k) + k - 1 + kLongTile);
}

size_t long_core_smem(int k) {
  return (static_cast<size_t>(long_taps_len(k)) + 2 * long_buf_len(k)) *
         sizeof(float);
}

// One chunk: taps t[0 .. 15] (the first cnt where !kWhole) into acc. The
// window e[w] is the sample at logical position s + w, w < kLR + 16, with
// s = kPhase (mod 32) and p the buffer at skew(s); output q at tap m of the
// chunk reads e[16 + q - m], so the first cnt taps read e[17 - cnt ..]: a
// partial chunk loads only those pieces of the window and of the taps.
template <int kPhase, bool kWhole>
__device__ __forceinline__ void long_chunk(const float* p, const float* t,
                                           int cnt, float (&acc)[kLR]) {
  constexpr int W = kLR + kChunk;
  float e[W];
#pragma unroll
  for (int g = 0; g < W / 4; ++g) {
    if (kWhole || 4 * g + 3 >= kChunk + 1 - cnt) {
      const float4 v = *reinterpret_cast<const float4*>(
          p + 4 * g + 4 * ((kPhase + 4 * g) >> 5));
      e[4 * g] = v.x;
      e[4 * g + 1] = v.y;
      e[4 * g + 2] = v.z;
      e[4 * g + 3] = v.w;
    }
  }
  float tv[kChunk];
#pragma unroll
  for (int i = 0; i < kChunk / 4; ++i) {
    if (kWhole || 4 * i < cnt) {
      const float4 v = *reinterpret_cast<const float4*>(t + 4 * i);
      tv[4 * i] = v.x;
      tv[4 * i + 1] = v.y;
      tv[4 * i + 2] = v.z;
      tv[4 * i + 3] = v.w;
    }
  }
#pragma unroll
  for (int m = 0; m < kChunk; ++m) {
    if (kWhole || m < cnt) {
#pragma unroll
      for (int q = 0; q < kLR; ++q)
        acc[q] = fmaf(tv[m], e[kChunk + q - m], acc[q]);
    }
  }
}

// A thread's kLR outputs r0 .. r0 + kLR - 1 of the tile in buffer cur, the
// K taps in shared memory.
__device__ __forceinline__ void long_filter(const float* cur,
                                            const float* taps, int k,
                                            int pos0, int r0,
                                            float (&acc)[kLR]) {
  const int whole = k / kChunk;
  const int rem = k % kChunk;
  const float* p = cur + skew(pos0 + r0 - kChunk);  // chunk 0: s = 16 mod 32
  const float* t = taps;
  int c = 0;
  for (; c + 2 <= whole; c += 2, p -= 36, t += 2 * kChunk) {
    long_chunk<16, true>(p, t, kChunk, acc);
    long_chunk<0, true>(p - 16, t + kChunk, kChunk, acc);
  }
  if (c < whole) {
    long_chunk<16, true>(p, t, kChunk, acc);
    p -= 16;
    t += kChunk;
  }
  if (rem != 0) {
    if (whole & 1)
      long_chunk<0, false>(p, t, rem, acc);
    else
      long_chunk<16, false>(p, t, rem, acc);
  }
}

__global__ void __launch_bounds__(kLongThreads, 4)
    fir_long_core(const float* __restrict__ x,
                  const float* __restrict__ state, long long n,
                  long long n_tiles, long long n_items,
                  const float* __restrict__ taps, int k,
                  float* __restrict__ y) {
  // the taps (zero past K), then fir_walk's two buffers (the outputs staged
  // in the current one)
  extern __shared__ __align__(16) float smem[];
  const int tl = long_taps_len(k);
  for (int j = threadIdx.x; j < tl; j += kLongThreads) {
    if (j < k)
      modem::cp_async4(smem + j, taps + j);
    else
      smem[j] = 0.f;
  }
  const int lead = long_lead(k);
  const int pos0 = lead + k - 1;
  // the taps' copies join the walk's first group of cp.async, which it
  // waits for before its first __syncthreads, before any filter reads them
  fir_walk<kLR, kLongThreads, true>(
      x, state, n, n_tiles, n_items, k, lead, long_buf_len(k), smem + tl, y,
      [&](const float* cur, int r0, float (&acc)[1][kLR]) {
        long_filter(cur, smem, k, pos0, r0, acc[0]);
      });
}

int launch_long_core(const float* x, const float* state, long long n_ch,
                     long long n, const float* taps, int n_taps, float* y,
                     cudaStream_t stream) {
  const size_t smem = long_core_smem(n_taps);
  const long long n_tiles =
      modem::fir_tiles(n, modem::fir_shift(x, n), kLongTile);
  const long long n_items = n_ch * n_tiles;
  unsigned grid = 0;
  const cudaError_t err = modem::persistent_grid(
      fir_long_core, kLongThreads, smem, modem::kCoreBlocks, n_items, grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  fir_long_core<<<grid, kLongThreads, smem, stream>>>(
      x, state, n, n_tiles, n_items, taps, n_taps, y);
  return static_cast<int>(cudaGetLastError());
}

// ---- the first version of the long route ----

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
// stream's start) -> y [n_ch, n]. The taps: taps a host pointer to them in
// a modem::Taps, passed to the kernel by value (the short route: n_taps <=
// 256; 23, 32, 64 and 65 compiled, any other count generic), or taps null
// and taps_dev the device array (the long route: the long core for any
// n_taps whose buffers fit shared memory, 15,009 taps at most, the first
// version past it while its tile fits). Returns cudaGetLastError(), or
// cudaErrorInvalidValue for arguments the kernels do not take.
int modem_fir(const float* x, const float* state, long long n_ch, long long n,
              const void* taps, const float* taps_dev, int n_taps, float* y,
              void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (n_taps < 1 || (taps != nullptr && n_taps > modem::kMaxTaps) ||
      (taps == nullptr && taps_dev == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (taps == nullptr)
    return long_core_smem(n_taps) <= modem::kMaxSmem
               ? launch_long_core(x, state, n_ch, n, taps_dev, n_taps, y, s)
               : launch_long(x, state, n_ch, n, taps_dev, n_taps, y, s);
  const modem::Taps& t = *static_cast<const modem::Taps*>(taps);
  switch (n_taps) {
    case 23: return launch_core<23>(x, state, n_ch, n, t, n_taps, y, s);
    case 32: return launch_core<32>(x, state, n_ch, n, t, n_taps, y, s);
    case 64: return launch_core<64>(x, state, n_ch, n, t, n_taps, y, s);
    case 65: return launch_core<65>(x, state, n_ch, n, t, n_taps, y, s);
    default: return launch_core<0>(x, state, n_ch, n, t, n_taps, y, s);
  }
}

// The first version of the long route at any n_taps its tile fits (up to
// 25,176), the taps from the device: what modem_fir runs past the long
// core's limit, forced here so that the two can be compared at any count.
int modem_fir_long_first(const float* x, const float* state, long long n_ch,
                         long long n, const float* taps_dev, int n_taps,
                         float* y, void* stream) {
  if (n_taps < 1 || taps_dev == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_long(x, state, n_ch, n, taps_dev, n_taps, y,
                     static_cast<cudaStream_t>(stream));
}

}  // extern "C"
