// K4: the whole dsd_in / single-channel chain ("mono chain") on Hopper, and
// K5: its tail alone, for the two-kernel engine (K6 -> K5).
//
// K4 replaces sdr_pmr446_tpu/kernels/chan_tail.py::PallasMonoChain.apply
// (the TPU kernel's bodies _mono_body_pk2 / _mono_body_cs16 /
// _mono_body_ilv and the tail _tail_core); K5 replaces PallasChanTail.apply
// (_body).  What they compute is documented beside their plain PyTorch
// versions, kernels/chan_tail.py.
//
// K4 (mono_run) runs seven launches on the caller's stream, no allocation
// (the wrapper passes every scratch buffer):
//   1-3. the front end of K1 (front_end.cuh): decode, DC blocker, 25/128
//      resampler into the band planes [2][nb];
//   4. mono_state<FMT>: the carried front history, DC x/y, the last HB raw
//      band samples and (single) the mixer phase n0' = (n0 + nb) mod 32;
//   5. mono_decim<MODE>: the 16x decimator, one warp per decimated output,
//      with the taps and the block's window of [band_hist | band] in shared
//      memory; for the single chain each band sample at step-relative
//      index i is multiplied by tab[(n0 + i) mod 32] as the window is
//      loaded — once per sample and exactly, for every K;
//   6. mono_demod: discriminator (native atan2f), one thread per sample;
//   7. mono_post_dsd (96/25 polyphase upsampler, x32767 folded into the
//      taps, clip) or mono_post_fir (the composed 408-tap audio FIR), one
//      thread per output over a shared-memory window of
//      [demod_hist | demod]; both also write demod_hist'.
// Device memory between launches: the front end's, the decimated signal
// planes [2][F] and the demod [F].
//
// K5 (tail_run) reads the band planes K6 wrote and runs tail_state (4's
// band history and mixer phase alone), then launches 5-7.  What bounds it
// on the H100: at K = 16 it reads the 2.5 MB band (~0.75 us) and does ~45
// MFLOP for dsd (bytes bound) or ~84 MFLOP for single, the 838-tap
// decimator and the mixer (operations bound, ~1.3 us).  As in K4's tail,
// each decimator block loads its window (mixed once a sample for single)
// and the taps into shared memory; the decimated signal and the demod go
// through device memory.
#include "front_end.cuh"

#define DEC 16              // decimation of the channel filter
#define PHASES 32           // mixer table period (band samples)
#define MAX_DEC_TAPS 1024   // longest decimator the shared taps take
#define DEC_WARPS 8         // warps per decimator block
#define DEC_PER_WARP 8      // decimated outputs per warp
#define DEC_OUT (DEC_WARPS * DEC_PER_WARP)          // outputs per block
#define DEC_WIN (DEC * (DEC_OUT - 1) + MAX_DEC_TAPS)  // window per block
#define UP_L 96             // upsampler interpolation
#define UP_M 25             // upsampler decimation
#define UP_MAX_P 64         // longest upsampler phase
#define UP_FB 4             // upsampler frames (of 96 outputs) per block
#define UP_MAX_OFF ((UP_L - 1) * UP_M / UP_L)
#define UP_WIN (UP_M * (UP_FB - 1) + UP_MAX_P + UP_MAX_OFF)
#define FIR_THREADS 256     // audio FIR outputs per block
#define MAX_FIR_TAPS 512

enum { MODE_DSD = 0, MODE_SINGLE = 1 };

// band_hist' (the last HB of [band_hist | band]) and, when n0_out is set
// (single), the mixer phase n0' = (n0 + nb) mod 32
static __device__ __forceinline__ void tail_state_at(
    int j, const float* __restrict__ bhist_in, int HB,
    const float* __restrict__ band, long long nb, float* __restrict__ bhist_out,
    const int* __restrict__ n0_in, int* __restrict__ n0_out) {
  hist_tail(j, bhist_in, HB, band, band + nb, nb, bhist_out);
  if (j == 0 && n0_out != nullptr)
    n0_out[0] = (int)((n0_in[0] + nb % PHASES) % PHASES);
}

// 4. the front end's carried state (front_state) and the tail's
template <int FMT>
static __global__ void mono_state(const uint8_t* __restrict__ wire, long long n,
                                  float inv_cu8,
                                  const float* __restrict__ ylocal,
                                  const float* __restrict__ carry,
                                  const float* __restrict__ pj, int chunks,
                                  const float* __restrict__ fhist_in, int H,
                                  float* __restrict__ fhist_out,
                                  const float* __restrict__ bhist_in, int HB,
                                  const float* __restrict__ band, long long nb,
                                  float* __restrict__ bhist_out,
                                  float* __restrict__ dc_x_out,
                                  float* __restrict__ dc_y_out,
                                  const int* __restrict__ n0_in,
                                  int* __restrict__ n0_out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  front_state<FMT>(j, wire, n, inv_cu8, ylocal, carry, pj, chunks, fhist_in,
                   H, fhist_out, dc_x_out, dc_y_out);
  tail_state_at(j, bhist_in, HB, band, nb, bhist_out, n0_in, n0_out);
}

// K5's state launch: the tail's carried state alone
static __global__ void tail_state(const float* __restrict__ bhist_in, int HB,
                                  const float* __restrict__ band, long long nb,
                                  float* __restrict__ bhist_out,
                                  const int* __restrict__ n0_in,
                                  int* __restrict__ n0_out) {
  tail_state_at(blockIdx.x * blockDim.x + threadIdx.x, bhist_in, HB, band, nb,
                bhist_out, n0_in, n0_out);
}

// 5. sig[f] = sum_w kd[w] * m(be[HB - (P - 1) + 16 f + w]),
//    be = [band_hist (HB) | band], m = the mixer (single: the sample at
//    step-relative index i = e - HB times tab[(n0 + i) mod 32]) or identity
//    (dsd); each block mixes its window once, into shared memory
template <int MODE>
static __global__ void mono_decim(const float* __restrict__ bhist, int HB,
                                  const float* __restrict__ band, long long nb,
                                  const float* __restrict__ kd, int P,
                                  const float* __restrict__ tab,
                                  const int* __restrict__ n0,
                                  float* __restrict__ sig, int F) {
  __shared__ float sk[MAX_DEC_TAPS];
  __shared__ float2 win[DEC_WIN];
  for (int i = threadIdx.x; i < P; i += blockDim.x) sk[i] = kd[i];
  const int f0 = blockIdx.x * DEC_OUT;
  const long long base = (long long)HB - (P - 1) + (long long)DEC * f0;
  // the mixer phase of be[e] is (ph0 + e) mod 32; e >= 0 as HB >= P - 1
  const int ph0 =
      MODE == MODE_SINGLE ? ((n0[0] - HB) % PHASES + PHASES) % PHASES : 0;
  for (int j = threadIdx.x; j < DEC * (DEC_OUT - 1) + P; j += blockDim.x) {
    const long long e = base + j;
    float2 v = make_float2(0.f, 0.f);
    if (e < HB) {
      v = make_float2(bhist[2 * e], bhist[2 * e + 1]);
    } else if (e - HB < nb) {
      v = make_float2(band[e - HB], band[nb + e - HB]);
    }
    if (MODE == MODE_SINGLE) {
      const int ph = (int)((ph0 + e) & (PHASES - 1));
      const float tr = __ldg(tab + 2 * ph), ti = __ldg(tab + 2 * ph + 1);
      v = make_float2(v.x * tr - v.y * ti, v.x * ti + v.y * tr);
    }
    win[j] = v;
  }
  __syncthreads();
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int r = 0; r < DEC_PER_WARP; ++r) {
    const int fl = warp * DEC_PER_WARP + r;
    const int f = f0 + fl;
    if (f >= F) return;
    float ar = 0.f, ai = 0.f;
    for (int w = lane; w < P; w += 32) {
      const float2 v = win[DEC * fl + w];
      ar += sk[w] * v.x;
      ai += sk[w] * v.y;
    }
    for (int o = 16; o > 0; o >>= 1) {
      ar += __shfl_down_sync(0xffffffffu, ar, o);
      ai += __shfl_down_sync(0xffffffffu, ai, o);
    }
    if (lane == 0) {
      sig[f] = ar;
      sig[F + f] = ai;
    }
  }
}

// 6. dem[f] = atan2(Im, Re)(sig[f] conj(sig[f-1])) * dscale, sig[-1] carried
static __global__ void mono_demod(const float* __restrict__ sig, int F,
                                  const float* __restrict__ prev_in,
                                  float dscale, float* __restrict__ dem,
                                  float* __restrict__ prev_out) {
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= F) return;
  const float xr = sig[f], xi = sig[F + f];
  const float pr = f == 0 ? prev_in[0] : sig[f - 1];
  const float pi = f == 0 ? prev_in[1] : sig[F + f - 1];
  dem[f] = atan2f(xi * pr - xr * pi, xr * pr + xi * pi) * dscale;
  if (f == F - 1) {
    prev_out[0] = xr;
    prev_out[1] = xi;
  }
}

// sample e of de = [demod_hist (DH) | dem (F)]
static __device__ __forceinline__ float de_sample(
    const float* __restrict__ dhist, int DH, const float* __restrict__ dem,
    int F, long long e) {
  if (e < DH) return dhist[e];
  return e - DH < F ? dem[e - DH] : 0.f;
}

// demod_hist' = the last DH samples of de (grid-strided)
static __device__ __forceinline__ void demod_tail(
    const float* __restrict__ dhist, int DH, const float* __restrict__ dem,
    int F, float* __restrict__ dhist_out) {
  for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < DH;
       j += gridDim.x * blockDim.x)
    dhist_out[j] = de_sample(dhist, DH, dem, F, (long long)F + j);
}

// 7a. out[96 g + p] = clip(sum_i ku[p][i] de[DH - (Pu - 1) + 25 g + o_p + i]),
//     o_p = (25 p) / 96; ku carries the x32767
static __global__ void mono_post_dsd(const float* __restrict__ dhist, int DH,
                                     const float* __restrict__ dem, int F,
                                     const float* __restrict__ ku, int Pu,
                                     float* __restrict__ out, int G,
                                     float* __restrict__ dhist_out) {
  __shared__ float win[UP_WIN];
  const int g0 = blockIdx.x * UP_FB;
  const long long base = (long long)DH - (Pu - 1) + (long long)UP_M * g0;
  for (int j = threadIdx.x; j < UP_WIN; j += blockDim.x)
    win[j] = de_sample(dhist, DH, dem, F, base + j);
  __syncthreads();
  demod_tail(dhist, DH, dem, F, dhist_out);
  const int gl = threadIdx.x / UP_L;
  const int p = threadIdx.x % UP_L;
  const int g = g0 + gl;
  if (gl >= UP_FB || g >= G) return;
  const int off = UP_M * gl + (p * UP_M) / UP_L;
  const float* k = ku + p * Pu;
  float acc = 0.f;
  for (int i = 0; i < Pu; ++i) acc += __ldg(k + i) * win[off + i];
  out[(long long)g * UP_L + p] = fminf(fmaxf(acc, -32768.f), 32767.f);
}

// 7b. out[n] = sum_k h[k] de[DH + n - k]  (h: composed FIR x gain)
static __global__ void mono_post_fir(const float* __restrict__ dhist, int DH,
                                     const float* __restrict__ dem, int F,
                                     const float* __restrict__ h, int NT,
                                     float* __restrict__ out,
                                     float* __restrict__ dhist_out) {
  __shared__ float sh[MAX_FIR_TAPS];
  __shared__ float win[FIR_THREADS + MAX_FIR_TAPS - 1];
  const int n0 = blockIdx.x * FIR_THREADS;
  const long long base = (long long)DH + n0 - (NT - 1);
  for (int i = threadIdx.x; i < NT; i += blockDim.x) sh[i] = h[i];
  for (int j = threadIdx.x; j < FIR_THREADS + NT - 1; j += blockDim.x)
    win[j] = de_sample(dhist, DH, dem, F, base + j);
  __syncthreads();
  demod_tail(dhist, DH, dem, F, dhist_out);
  const int nl = threadIdx.x;
  if (n0 + nl >= F) return;
  float acc = 0.f;
  for (int k = 0; k < NT; ++k) acc += sh[k] * win[nl + NT - 1 - k];
  out[n0 + nl] = acc;
}

// Launches 5-7 on the band planes [2][nb]: decimator, discriminator,
// post-FIR (the tail shared by K4 and K5); sig and dem are scratch.
static int tail_launch(int mode, const float* band, long long nb,
                       const float* bhist, int HB, const float* sig_prev,
                       const float* dhist, int DH, const int* n0,
                       const float* kd, int P, const float* tab,
                       const float* kpost, int post_taps, float dscale,
                       float* sig, float* dem, float* sig_prev_out,
                       float* dhist_out, float* out, cudaStream_t s) {
  const int F = (int)(nb / DEC);
  const int dec_blocks = (F + DEC_OUT - 1) / DEC_OUT;
  if (mode == MODE_SINGLE)
    mono_decim<MODE_SINGLE><<<dec_blocks, 32 * DEC_WARPS, 0, s>>>(
        bhist, HB, band, nb, kd, P, tab, n0, sig, F);
  else
    mono_decim<MODE_DSD><<<dec_blocks, 32 * DEC_WARPS, 0, s>>>(
        bhist, HB, band, nb, kd, P, nullptr, nullptr, sig, F);
  SDR_CHECK_LAUNCH();
  mono_demod<<<(F + 255) / 256, 256, 0, s>>>(sig, F, sig_prev, dscale, dem,
                                             sig_prev_out);
  SDR_CHECK_LAUNCH();
  if (mode == MODE_SINGLE) {
    mono_post_fir<<<(F + FIR_THREADS - 1) / FIR_THREADS, FIR_THREADS, 0, s>>>(
        dhist, DH, dem, F, kpost, post_taps, out, dhist_out);
  } else {
    const int G = F / UP_M;
    mono_post_dsd<<<(G + UP_FB - 1) / UP_FB, UP_L * UP_FB, 0, s>>>(
        dhist, DH, dem, F, kpost, post_taps, out, G, dhist_out);
  }
  SDR_CHECK_LAUNCH();
  return 0;
}

// The tail's arguments that K4 and K5 check alike
static bool tail_args_ok(int mode, int HB, int DH, const void* n0,
                         const void* tab, const void* n0_out, int P,
                         int post_taps) {
  const bool single = mode == MODE_SINGLE;
  return P >= 1 && P <= MAX_DEC_TAPS && HB >= P - 1 &&
         (mode == MODE_DSD || single) &&
         (!single || (n0 != nullptr && tab != nullptr && n0_out != nullptr &&
                      post_taps <= MAX_FIR_TAPS)) &&
         (single || post_taps <= UP_MAX_P) && DH >= post_taps - 1 &&
         post_taps >= 1;
}

template <int FMT>
static int mono_launch(int mode, const uint8_t* wire, long long n,
                       const float* dc_x, const float* dc_y, const float* fhist,
                       int H, const float* bhist, int HB, const float* sig_prev,
                       const float* dhist, int DH, const int* n0,
                       const float* kt, const float* pj, double p, double g,
                       double pL, float inv_cu8,
                       const float* kd, int P, const float* tab,
                       const float* kpost, int post_taps, float dscale,
                       float* ylocal, float* yend, float* carry, float* band,
                       float* sig, float* dem, float* dc_x_out,
                       float* dc_y_out, float* fhist_out, float* bhist_out,
                       float* sig_prev_out, float* dhist_out, int* n0_out,
                       float* out, cudaStream_t s) {
  const int chunks = (int)((n + DC_L - 1) / DC_L);
  const long long nb = n / RES_M * RES_L;
  const int fe = front_end_launch<FMT>(wire, n, dc_x, dc_y, fhist, H, kt, pj,
                                       p, g, pL, inv_cu8, ylocal, yend,
                                       carry, band, s);
  if (fe != 0) return fe;
  const int tail = H > HB ? H : HB;
  mono_state<FMT><<<(tail + 255) / 256, 256, 0, s>>>(
      wire, n, inv_cu8, ylocal, carry, pj, chunks, fhist, H, fhist_out, bhist,
      HB, band, nb, bhist_out, dc_x_out, dc_y_out, n0,
      mode == MODE_SINGLE ? n0_out : nullptr);
  SDR_CHECK_LAUNCH();
  return tail_launch(mode, band, nb, bhist, HB, sig_prev, dhist, DH, n0, kd,
                     P, tab, kpost, post_taps, dscale, sig, dem, sig_prev_out,
                     dhist_out, out, s);
}

extern "C" int mono_run(int fmt, int mode, const void* wire, long long n,
                        const void* dc_x, const void* dc_y, const void* fhist,
                        int H, const void* bhist, int HB, const void* sig_prev,
                        const void* dhist, int DH, const void* n0,
                        const void* kt, const void* pj, double p, double g,
                        double pL, float inv_cu8,
                        const void* kd, int P, const void* tab,
                        const void* kpost, int post_taps, float dscale,
                        void* ylocal, void* yend, void* carry, void* band,
                        void* sig, void* dem, void* dc_x_out, void* dc_y_out,
                        void* fhist_out, void* bhist_out, void* sig_prev_out,
                        void* dhist_out, void* n0_out, void* out,
                        void* stream) {
  if (n <= 0 || n % (RES_M * DEC) != 0 || H < RS_P - 1 ||
      !tail_args_ok(mode, HB, DH, n0, tab, n0_out, P, post_taps))
    return (int)cudaErrorInvalidValue;
#define SDR_MONO_ARGS                                                        \
  mode, (const uint8_t*)wire, n, (const float*)dc_x, (const float*)dc_y,     \
      (const float*)fhist, H, (const float*)bhist, HB,                       \
      (const float*)sig_prev, (const float*)dhist, DH, (const int*)n0,       \
      (const float*)kt, (const float*)pj, p, g, pL, inv_cu8,                 \
      (const float*)kd, P, (const float*)tab, (const float*)kpost,           \
      post_taps, dscale, (float*)ylocal, (float*)yend, (float*)carry,        \
      (float*)band, (float*)sig, (float*)dem, (float*)dc_x_out,              \
      (float*)dc_y_out, (float*)fhist_out, (float*)bhist_out,                \
      (float*)sig_prev_out, (float*)dhist_out, (int*)n0_out, (float*)out,    \
      (cudaStream_t)stream
  switch (fmt) {
    case FMT_CU8: return mono_launch<FMT_CU8>(SDR_MONO_ARGS);
    case FMT_CS8: return mono_launch<FMT_CS8>(SDR_MONO_ARGS);
    case FMT_CS16: return mono_launch<FMT_CS16>(SDR_MONO_ARGS);
    case FMT_CF32: return mono_launch<FMT_CF32>(SDR_MONO_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef SDR_MONO_ARGS
}

// K5: the tail alone, on band planes [2][nb] written by K6 (nb a whole
// number of 400-sample group rows).  One state launch, then the tail's.
extern "C" int tail_run(int mode, const void* band, long long nb,
                        const void* bhist, int HB, const void* sig_prev,
                        const void* dhist, int DH, const void* n0,
                        const void* kd, int P, const void* tab,
                        const void* kpost, int post_taps, float dscale,
                        void* sig, void* dem, void* bhist_out,
                        void* sig_prev_out, void* dhist_out, void* n0_out,
                        void* out, void* stream) {
  if (nb <= 0 || nb % (UP_M * DEC) != 0 ||
      !tail_args_ok(mode, HB, DH, n0, tab, n0_out, P, post_taps))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  tail_state<<<(HB + 255) / 256, 256, 0, s>>>(
      (const float*)bhist, HB, (const float*)band, nb, (float*)bhist_out,
      (const int*)n0, mode == MODE_SINGLE ? (int*)n0_out : nullptr);
  SDR_CHECK_LAUNCH();
  return tail_launch(mode, (const float*)band, nb, (const float*)bhist, HB,
                     (const float*)sig_prev, (const float*)dhist, DH,
                     (const int*)n0, (const float*)kd, P, (const float*)tab,
                     (const float*)kpost, post_taps, dscale, (float*)sig,
                     (float*)dem, (float*)sig_prev_out, (float*)dhist_out,
                     (float*)out, s);
}
