// The front end shared by K1 (csrc/duo.cu), K4 (csrc/chan_tail.cu) and K6
// (csrc/front_end.cu): wire decode, the IQ DC blocker and the 25/128
// polyphase resampler to the 200 kHz band.  What it computes is documented
// beside its plain PyTorch version, kernels/front_end.py::FrontEnd.
//
// Three launches (the caller issues them, see front_end_launch):
//   1. fe_dc_local<FMT>: wire decode + zero-state DC response per chunk;
//   2. dc_carry_kernel: chunk carries (sdr_common.cuh);
//   3. fe_resample: 25/128 polyphase resampler, one thread per band output,
//      the DC fix-up fused into its shared-memory window load.
// Device memory between launches: the chunk-local DC response [2][n] and
// the band planes [2][nb].  front_state gives the carried state (front
// history, DC x[-1] and y[-1]); each kernel that runs the front end calls it
// from its own state launch.  resample_frames is the resampler's arithmetic
// on a loaded window, shared with K9 (csrc/resample_kernel.cu).
#pragma once

#include "sdr_common.cuh"

#define RES_L 25          // resampler interpolation
#define RES_M 128         // resampler decimation
#define RS_P 346          // taps per polyphase row
#define RS_W 468          // polyphase window (RS_P + max row offset)
#define RS_FB 16          // band frames (of 25 outputs) per block
#define RS_WIN (RES_M * (RS_FB - 1) + RS_W)

enum { FMT_CU8 = 0, FMT_CS8 = 1, FMT_CS16 = 2, FMT_CF32 = 3 };

// Sample n of the wire, decoded exactly as ops/decode.py (bit-exact).
template <int FMT>
static __device__ __forceinline__ float2 load_iq(const uint8_t* __restrict__ w,
                                                 long long n, float inv_cu8) {
  if (FMT == FMT_CU8) {
    const uchar2 b = reinterpret_cast<const uchar2*>(w)[n];
    return make_float2(((float)b.x - 127.5f) * inv_cu8,
                       ((float)b.y - 127.5f) * inv_cu8);
  } else if (FMT == FMT_CS8) {
    const char2 b = reinterpret_cast<const char2*>(w)[n];
    return make_float2((float)b.x * (1.0f / 128.0f),
                       (float)b.y * (1.0f / 128.0f));
  } else if (FMT == FMT_CS16) {
    const short2 s = reinterpret_cast<const short2*>(w)[n];
    return make_float2((float)s.x * (1.0f / 32768.0f),
                       (float)s.y * (1.0f / 32768.0f));
  } else {
    return reinterpret_cast<const float2*>(w)[n];
  }
}

// 1. one thread per DC_L-sample chunk, both planes
template <int FMT>
static __global__ void fe_dc_local(const uint8_t* __restrict__ wire,
                                   long long n, const float* __restrict__ dc_x,
                                   float inv_cu8, double p, double g,
                                   float* __restrict__ ylocal,
                                   float* __restrict__ yend, int chunks) {
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= chunks) return;
  const long long n0 = c * DC_L;
  const long long n1 = min(n0 + DC_L, n);
  float2 xp = (n0 == 0) ? make_float2(dc_x[0], dc_x[1])
                        : load_iq<FMT>(wire, n0 - 1, inv_cu8);
  double yr = 0.0, yi = 0.0;
  for (long long i = n0; i < n1; ++i) {
    const float2 x = load_iq<FMT>(wire, i, inv_cu8);
    yr = p * yr + g * ((double)x.x - (double)xp.x);
    yi = p * yi + g * ((double)x.y - (double)xp.y);
    ylocal[i] = (float)yr;
    ylocal[n + i] = (float)yi;
    xp = x;
  }
  yend[c] = (float)yr;
  yend[chunks + c] = (float)yi;
}

// y-space sample e of [front_hist (H) | y (n)], plane-wise
static __device__ __forceinline__ float2 ye_sample(
    const float* __restrict__ fhist, int H, const float* __restrict__ ylocal,
    const float* __restrict__ carry, const float* __restrict__ pj, long long n,
    int chunks, long long e) {
  if (e < H) return make_float2(fhist[2 * e], fhist[2 * e + 1]);
  const long long m = e - H;
  if (m >= n) return make_float2(0.f, 0.f);
  return make_float2(dc_fix(ylocal, carry, pj, m),
                     dc_fix(ylocal + n, carry + chunks, pj, m));
}

// band[25 f + q] = sum_i kc[q][i] * win[128 (f - f0) + o_q + i] for the
// RS_FB frames from f0 of one block, from its loaded window planes
static __device__ __forceinline__ void resample_frames(
    const float* wr, const float* wi, const float* __restrict__ kc,
    float* __restrict__ band, long long nb, int f0, int frames) {
  const int fl = threadIdx.x / RES_L;
  const int q = threadIdx.x % RES_L;
  const int f = f0 + fl;
  if (fl >= RS_FB || f >= frames) return;
  const int off = RES_M * fl + (q * RES_M) / RES_L;
  const float* k = kc + q * RS_P;
  float ar = 0.f, ai = 0.f;
  for (int i = 0; i < RS_P; ++i) {
    const float kv = __ldg(k + i);
    ar += kv * wr[off + i];
    ai += kv * wi[off + i];
  }
  band[(long long)f * RES_L + q] = ar;
  band[nb + (long long)f * RES_L + q] = ai;
}

// 3. band[25 f + q] = sum_i kc[q][i] * ye[H - 345 + 128 f + o_q + i]
static __global__ void fe_resample(const float* __restrict__ ylocal,
                                   const float* __restrict__ carry,
                                   const float* __restrict__ pj,
                                   const float* __restrict__ fhist, int H,
                                   long long n, int chunks,
                                   const float* __restrict__ kc,
                                   float* __restrict__ band, long long nb,
                                   int frames) {
  __shared__ float wr[RS_WIN];
  __shared__ float wi[RS_WIN];
  const int f0 = blockIdx.x * RS_FB;
  const long long base = (long long)H - (RS_P - 1) + (long long)RES_M * f0;
  for (int j = threadIdx.x; j < RS_WIN; j += blockDim.x) {
    const float2 v = ye_sample(fhist, H, ylocal, carry, pj, n, chunks,
                               base + j);
    wr[j] = v.x;
    wi[j] = v.y;
  }
  __syncthreads();
  resample_frames(wr, wi, kc, band, nb, f0, frames);
}

// Entry j of the front end's carried state: front_hist' (the last H of
// [front_hist | y]) for j < H; DC blocker x[-1] and y[-1] for j == 0.
template <int FMT>
static __device__ __forceinline__ void front_state(
    int j, const uint8_t* __restrict__ wire, long long n, float inv_cu8,
    const float* __restrict__ ylocal, const float* __restrict__ carry,
    const float* __restrict__ pj, int chunks,
    const float* __restrict__ fhist_in, int H, float* __restrict__ fhist_out,
    float* __restrict__ dc_x_out, float* __restrict__ dc_y_out) {
  if (j < H) {
    const float2 v = ye_sample(fhist_in, H, ylocal, carry, pj, n, chunks,
                               n + j);
    fhist_out[2 * j] = v.x;
    fhist_out[2 * j + 1] = v.y;
  }
  if (j == 0) {
    const float2 y = ye_sample(fhist_in, H, ylocal, carry, pj, n, chunks,
                               H + n - 1);
    dc_y_out[0] = y.x;
    dc_y_out[1] = y.y;
    const float2 x = load_iq<FMT>(wire, n - 1, inv_cu8);
    dc_x_out[0] = x.x;
    dc_x_out[1] = x.y;
  }
}

// Launches 1-3 for n input samples: ylocal/yend/carry are scratch, band the
// output planes [2][nb] with nb = 25 n / 128.
template <int FMT>
static int front_end_launch(const uint8_t* wire, long long n,
                            const float* dc_x, const float* dc_y,
                            const float* fhist, int H, const float* kc,
                            const float* pj, double p, double g, double pL,
                            double pSeg, int seg, float inv_cu8,
                            float* ylocal, float* yend, float* carry,
                            float* band, cudaStream_t s) {
  const int chunks = (int)((n + DC_L - 1) / DC_L);
  const int res_frames = (int)(n / RES_M);
  const long long nb = (long long)res_frames * RES_L;
  fe_dc_local<FMT><<<(chunks + 255) / 256, 256, 0, s>>>(
      wire, n, dc_x, inv_cu8, p, g, ylocal, yend, chunks);
  SDR_CHECK_LAUNCH();
  dc_carry_kernel<<<2, CARRY_THREADS, 0, s>>>(yend, carry, dc_y, chunks, pL,
                                              pSeg, seg);
  SDR_CHECK_LAUNCH();
  fe_resample<<<(res_frames + RS_FB - 1) / RS_FB, RES_L * RS_FB, 0, s>>>(
      ylocal, carry, pj, fhist, H, n, chunks, kc, band, nb, res_frames);
  SDR_CHECK_LAUNCH();
  return 0;
}
