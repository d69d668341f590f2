// Fused loopback of the pulse-shaped chain.
//
// Replaces modem_tpu/ops/pallas_chain.py::_chain_kernel (K1): int32 symbols
// -> constellation map (a table of up to 64 points, or algebraic square
// QAM; common.cuh) -> polyphase RRC waveform -> [passband: up-mix with the
// exact integer NCO, x = wi*cos - wq*sin] -> [AWGN] -> [passband: product
// detection with 2x gain, yi = 2x*cos, yq = -2x*sin] -> polyphase matched
// filter at the decision instants -> slice -> int32 decisions. It is the TX
// kernel followed by the RX kernel of txrx.cu with the waveform kept in
// shared memory: a block deciding cs symbols (one tile, cs = chunk_sym)
// synthesizes the (cs + span) * sps samples its matched filter reads, from
// the symbols [m0 - (kp-1), m0 + cs + span) that it loads itself, kp - 1 =
// span for the RRC (zero I/Q outside [0, K) and for negative symbols, the
// streaming sentinel).
//
// Noise. The JAX kernel's interpret path draws gauss_pair (common.cuh) per
// tile of 128 channels by cs symbols: key seed + (c / 128) * 1000003 +
// (m0 / cs) * 7919 (uint32 wrap-around), one draw per phase p (salt p), the
// counter r * 128 + c mod 128 for waveform row r of the tile. The rows of
// the span-symbol lookahead take the tile's own draw, so the same sample
// is noised differently in the two tiles that read it, as there. Baseband
// adds sigma * (g1, g2) to (wi, wq); passband sigma * g1 to x. So the card
// draws the same Gaussians as the CPU tests hold the plain version to.
//
// What bounds it on this card: device memory carries only 4 B in and 4 B
// out per symbol, so the waveform never costs bandwidth; the work is about
// (9*2 + 65*2/sps) FMAs per sample plus shared-memory traffic, all on-chip,
// and the shared-memory load instructions (about 1.5 per FMA) are the limit
// of this first version noiseless at baseband. Noise adds two hashes, a
// logf, a sqrtf, a cosf and a sinf per sample, the NCO a cos and a sin (a
// table for carriers of at most 16 phases): both move the limit to those
// operations. With cs = 256, sps = 8 and span = 8 the waveform planes take
// 2 x 8 x 265 x 4 B = 17 KB of shared memory per block, so several blocks
// share an SM. The span-symbol overlap between neighbouring tiles is
// synthesized twice (3% extra work) instead of exchanged. The kernel is
// instantiated per carrier mode and noise, so the noiseless baseband mode
// runs neither's code.

#include "common.cuh"

namespace {

template <bool kPassband, bool kNoisy>
__global__ void pulse_chain_kernel(const int* __restrict__ syms,
                                   long long k_sym, long long n_tiles, int cs,
                                   modem::Constellation map,
                                   const float* __restrict__ taps, int n_taps,
                                   int sps, int span, modem::Nco nco,
                                   float sigma, unsigned seed,
                                   int* __restrict__ out) {
  extern __shared__ float smem[];
  const int kp = (n_taps + sps - 1) / sps;  // taps per polyphase branch
  const int rows = cs + span;          // waveform symbols the filter reads
  const int stride = rows | 1;         // odd plane stride
  const int z_len = rows + kp - 1;     // and the symbols they are made of
  float* wi = smem;
  float* wq = wi + sps * stride;
  float* zi = wq + sps * stride;
  float* zq = zi + z_len;
  float* sbank = zq + z_len;
  float* staps = sbank + sps * kp;
  float* slut = staps + n_taps;
  float* tc = slut + (map.lut != nullptr ? 2 * map.n_points : 0);
  float* ts = tc + nco.n_ph;

  const long long c = blockIdx.x / n_tiles;
  const long long tile = blockIdx.x % n_tiles;
  const long long m0 = tile * cs;
  modem::stage_bank(sbank, taps, n_taps, sps, kp);
  modem::stage(staps, taps, n_taps);
  if (map.lut != nullptr) modem::stage(slut, map.lut, 2 * map.n_points);
  if (kPassband && nco.n_ph <= modem::kNcoTable) modem::stage_nco(tc, ts, nco);
  __syncthreads();

  const int* row = syms + c * k_sym;
  for (int t = threadIdx.x; t < z_len; t += blockDim.x)
    modem::map_point(row, m0 - (kp - 1) + t, k_sym, map, slut, zi[t], zq[t]);
  __syncthreads();

  const unsigned key = seed +
                       static_cast<unsigned>(c / modem::kLane) * 1000003u +
                       static_cast<unsigned>(tile) * 7919u;
  const unsigned lane = static_cast<unsigned>(c % modem::kLane);
  // waveform sample (m0 + r)*sps + p into plane p, row r
  for (int t = threadIdx.x; t < rows * sps; t += blockDim.x) {
    const int r = t / sps;
    const int p = t - r * sps;
    const float* b = sbank + p * kp;
    float ai = 0.f, aq = 0.f;
    for (int k = 0; k < kp; ++k) {
      const int zk = r + kp - 1 - k;
      ai = fmaf(b[k], zi[zk], ai);
      aq = fmaf(b[k], zq[zk], aq);
    }
    float g1 = 0.f, g2 = 0.f;
    if (kNoisy)
      modem::gauss_pair(static_cast<unsigned>(r) * modem::kLane + lane,
                        key + static_cast<unsigned>(p) * 0x9E3779B9u, g1, g2);
    if (kPassband) {
      float cs_, sn;
      modem::nco_cos_sin(nco, nco.sym_offset + m0 + r, p, tc, ts, cs_, sn);
      float x = __fsub_rn(__fmul_rn(ai, cs_), __fmul_rn(aq, sn));
      if (kNoisy) x = __fadd_rn(x, __fmul_rn(sigma, g1));
      const float x2 = 2.f * x;
      ai = __fmul_rn(x2, cs_);
      aq = __fmul_rn(-x2, sn);
    } else if (kNoisy) {
      // two roundings, as the plain version: no FMA contraction here
      ai = __fadd_rn(ai, __fmul_rn(sigma, g1));
      aq = __fadd_rn(aq, __fmul_rn(sigma, g2));
    }
    wi[p * stride + r] = ai;
    wq[p * stride + r] = aq;
  }
  __syncthreads();

  for (int ml = threadIdx.x; ml < cs; ml += blockDim.x) {
    const long long m = m0 + ml;
    if (m >= k_sym) break;
    const float ai = modem::matched_point(wi, stride, staps, n_taps, sps, span, ml);
    const float aq = modem::matched_point(wq, stride, staps, n_taps, sps, span, ml);
    out[c * k_sym + m] = modem::decide(ai, aq, map, slut);
  }
}

template <bool kPassband, bool kNoisy>
int launch_chain(const int* syms, long long n_ch, long long k_sym, int cs,
                 const modem::Constellation& map, const float* taps,
                 int n_taps, int sps, int span, const modem::Nco& nco,
                 float sigma, unsigned seed, int* out, void* stream) {
  const long long n_tiles = (k_sym + cs - 1) / cs;
  const int kp = (n_taps + sps - 1) / sps;
  const int rows = cs + span;
  const size_t smem =
      (2 * static_cast<size_t>(sps) * (rows | 1) + 2 * (rows + kp - 1) +
       sps * kp + n_taps + modem::side_floats(map, nco)) *
      sizeof(float);
  cudaError_t err =
      modem::allow_smem(pulse_chain_kernel<kPassband, kNoisy>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  pulse_chain_kernel<kPassband, kNoisy>
      <<<modem::grid_blocks(n_ch, n_tiles), modem::kThreads, smem,
         static_cast<cudaStream_t>(stream)>>>(syms, k_sym, n_tiles, cs, map,
                                              taps, n_taps, sps, span, nco,
                                              sigma, seed, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// syms [n_ch, k_sym] int32 -> out [n_ch, k_sym] int32 decisions, in tiles of
// cs symbols. The map: lut [n_points, 2] f32, or with lut null square QAM
// (cshift, ms, a, c, s); the carrier: sr == 0 baseband, else hz, sr,
// sym_offset and scale = f32(2*pi/sr); taps [span*sps+1] f32; noisy != 0
// adds sigma * N(0, 1) from the stream keyed by seed. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for arguments the kernel
// does not take.
int modem_chain(const int* syms, long long n_ch, long long k_sym, int cs,
                const float* lut, int n_points, int cshift, float ms, float a,
                float c, float s, const float* taps, int n_taps, int sps,
                int span, int hz, int sr, long long sym_offset, float scale,
                int noisy, float sigma, unsigned seed, int* out,
                void* stream) {
  // the matched filter's sample window is exactly the tile's halo
  if (n_taps != span * sps + 1 || cs < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const modem::Constellation map =
      modem::make_map(lut, n_points, cshift, ms, a, c, s);
  modem::Nco nco;
  if (!modem::make_nco(hz, sr, sps, sym_offset, scale, nco))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool passband = sr != 0;
  if (passband && noisy)
    return launch_chain<true, true>(syms, n_ch, k_sym, cs, map, taps, n_taps,
                                    sps, span, nco, sigma, seed, out, stream);
  if (passband)
    return launch_chain<true, false>(syms, n_ch, k_sym, cs, map, taps, n_taps,
                                     sps, span, nco, sigma, seed, out, stream);
  if (noisy)
    return launch_chain<false, true>(syms, n_ch, k_sym, cs, map, taps, n_taps,
                                     sps, span, nco, sigma, seed, out, stream);
  return launch_chain<false, false>(syms, n_ch, k_sym, cs, map, taps, n_taps,
                                    sps, span, nco, sigma, seed, out, stream);
}

}  // extern "C"
