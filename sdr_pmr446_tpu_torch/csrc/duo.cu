// K1: the scanner front end + channelizer on Hopper.
//
// Replaces sdr_pmr446_tpu/kernels/duo.py::PallasScannerDuo.apply (the TPU
// kernel's bodies _duo_body_pk2 / _duo_body_cs16 / _duo_body_ilv and the
// packed PFB core kernels/pfb_demod.py::_pfb_group_core).  What it computes
// is documented beside its plain PyTorch version, kernels/duo.py.
//
// Six launches on the caller's stream, no allocation (the wrapper passes
// every scratch buffer):
//   1-3. the front end (front_end.cuh, shared with K4): fe_dc_local<FMT>,
//      dc_carry_kernel and fe_resample — decode, DC blocker, 25/128
//      resampler;
//   4. duo_tail<FMT>: the carried state (front history, PFB history, DC x/y);
//   5. duo_pfb: 416-tap complex PFB, one thread per (frame, channel), then the
//      (-1)^(parity + frame) mixer flip;
//   6. duo_demod_mag: discriminator (native atan2f) and the per-(sub-chunk,
//      channel) |y| sums as a deterministic block reduction.
// Device memory between launches: the chunk-local DC response [2][n], the
// band planes [2][nb] and the channel planes [2][16][F].
#include "front_end.cuh"

#define PFB_TAPS 416
#define PFB_HIST 400
#define PFB_FB 16         // channel frames per block
#define PFB_WIN (NCH * (PFB_FB - 1) + PFB_TAPS)

// 4. new front history (last H of [front_hist | y]), new PFB history (last
// 400 of [pfb_hist | band]), DC blocker x[-1] and y[-1]
template <int FMT>
static __global__ void duo_tail(const uint8_t* __restrict__ wire, long long n,
                                float inv_cu8, const float* __restrict__ ylocal,
                                const float* __restrict__ carry,
                                const float* __restrict__ pj, int chunks,
                                const float* __restrict__ fhist_in, int H,
                                float* __restrict__ fhist_out,
                                const float* __restrict__ phist_in,
                                const float* __restrict__ band, long long nb,
                                float* __restrict__ phist_out,
                                float* __restrict__ dc_x_out,
                                float* __restrict__ dc_y_out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j < H) {
    const float2 v = ye_sample(fhist_in, H, ylocal, carry, pj, n, chunks,
                               n + j);
    fhist_out[2 * j] = v.x;
    fhist_out[2 * j + 1] = v.y;
  }
  if (j < PFB_HIST) {
    const long long e = nb + j;
    float vr, vi;
    if (e < PFB_HIST) {
      vr = phist_in[2 * e];
      vi = phist_in[2 * e + 1];
    } else {
      vr = band[e - PFB_HIST];
      vi = band[nb + e - PFB_HIST];
    }
    phist_out[2 * j] = vr;
    phist_out[2 * j + 1] = vi;
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

// 5. chan[k][f] = (-1)^(parity + f) sum_t CK[t][k] xe[16 f + t],
//    xe = [pfb_hist (400) | band]
static __global__ void duo_pfb(const float* __restrict__ band, long long nb,
                               const float* __restrict__ phist,
                               const float* __restrict__ ck_re,
                               const float* __restrict__ ck_im,
                               const int* __restrict__ parity,
                               float* __restrict__ chan, int frames) {
  __shared__ float xr[PFB_WIN];
  __shared__ float xi[PFB_WIN];
  const int f0 = blockIdx.x * PFB_FB;
  for (int j = threadIdx.x; j < PFB_WIN; j += blockDim.x) {
    const long long e = (long long)NCH * f0 + j;
    float vr = 0.f, vi = 0.f;
    if (e < PFB_HIST) {
      vr = phist[2 * e];
      vi = phist[2 * e + 1];
    } else if (e - PFB_HIST < nb) {
      vr = band[e - PFB_HIST];
      vi = band[nb + e - PFB_HIST];
    }
    xr[j] = vr;
    xi[j] = vi;
  }
  __syncthreads();
  const int fl = threadIdx.x / NCH;
  const int k = threadIdx.x % NCH;
  const int f = f0 + fl;
  if (fl >= PFB_FB || f >= frames) return;
  float ar = 0.f, ai = 0.f;
  for (int t = 0; t < PFB_TAPS; ++t) {
    const float cr = __ldg(ck_re + t * NCH + k);
    const float ci = __ldg(ck_im + t * NCH + k);
    const float vr = xr[NCH * fl + t];
    const float vi = xi[NCH * fl + t];
    ar += cr * vr - ci * vi;
    ai += cr * vi + ci * vr;
  }
  const float sgn = ((f + parity[0]) & 1) ? -1.f : 1.f;
  chan[(long long)k * frames + f] = sgn * ar;
  chan[(long long)(NCH + k) * frames + f] = sgn * ai;
}

// 6. one block per (sub-chunk, channel): demod and sum |y|
static __global__ void duo_demod_mag(const float* __restrict__ chan,
                                     int frames, int ns,
                                     const float* __restrict__ prev_in,
                                     float dscale, float* __restrict__ demod,
                                     float* __restrict__ mag,
                                     float* __restrict__ prev_out) {
  __shared__ float sh[RED_THREADS];
  const int kk = blockIdx.x;
  const int c = blockIdx.y;
  const float* cr = chan + (long long)c * frames;
  const float* ci = chan + (long long)(NCH + c) * frames;
  float acc = 0.f;
  for (int i = threadIdx.x; i < ns; i += blockDim.x) {
    const int n = kk * ns + i;
    const float xr = cr[n], xi = ci[n];
    float pr, pi;
    if (n == 0) {
      pr = prev_in[2 * c];
      pi = prev_in[2 * c + 1];
    } else {
      pr = cr[n - 1];
      pi = ci[n - 1];
    }
    const float dr = xr * pr + xi * pi;
    const float di = xi * pr - xr * pi;
    demod[(long long)c * frames + n] = atan2f(di, dr) * dscale;
    acc += hypotf(xr, xi);
    if (n == frames - 1) {
      prev_out[2 * c] = xr;
      prev_out[2 * c + 1] = xi;
    }
  }
  const float s = block_sum(acc, sh);
  if (threadIdx.x == 0) mag[kk * NCH + c] = s;
}

template <int FMT>
static int duo_launch(const uint8_t* wire, long long n, const float* dc_x,
                      const float* dc_y, const float* fhist, int H,
                      const float* phist, const int* parity, const float* prev,
                      const float* kc, const float* ck_re, const float* ck_im,
                      const float* pj, double p, double g, double pL,
                      double pSeg, int seg, float inv_cu8, float dscale, int K, int ns,
                      float* ylocal, float* yend, float* carry, float* band,
                      float* chan, float* dc_x_out, float* dc_y_out,
                      float* fhist_out, float* phist_out, float* demod,
                      float* mag, float* prev_out, cudaStream_t s) {
  const int chunks = (int)((n + DC_L - 1) / DC_L);
  const int res_frames = (int)(n / RES_M);
  const long long nb = (long long)res_frames * RES_L;
  const int frames = (int)(nb / NCH);
  const int fe = front_end_launch<FMT>(wire, n, dc_x, dc_y, fhist, H, kc, pj,
                                      p, g, pL, pSeg, seg, inv_cu8, ylocal,
                                      yend, carry, band, s);
  if (fe != 0) return fe;
  const int tail = H > PFB_HIST ? H : PFB_HIST;
  duo_tail<FMT><<<(tail + 255) / 256, 256, 0, s>>>(
      wire, n, inv_cu8, ylocal, carry, pj, chunks, fhist, H, fhist_out, phist,
      band, nb, phist_out, dc_x_out, dc_y_out);
  SDR_CHECK_LAUNCH();
  duo_pfb<<<(frames + PFB_FB - 1) / PFB_FB, NCH * PFB_FB, 0, s>>>(
      band, nb, phist, ck_re, ck_im, parity, chan, frames);
  SDR_CHECK_LAUNCH();
  duo_demod_mag<<<dim3(K, NCH), RED_THREADS, 0, s>>>(chan, frames, ns, prev,
                                                    dscale, demod, mag,
                                                    prev_out);
  SDR_CHECK_LAUNCH();
  return 0;
}

extern "C" int duo_run(int fmt, const void* wire, long long n,
                       const void* dc_x, const void* dc_y, const void* fhist,
                       int H, const void* phist, const void* parity,
                       const void* prev, const void* kc, const void* ck_re,
                       const void* ck_im, const void* pj, double p, double g,
                       double pL, double pSeg, int seg, float inv_cu8,
                       float dscale, int K, int ns, void* ylocal, void* yend,
                       void* carry, void* band, void* chan, void* dc_x_out,
                       void* dc_y_out, void* fhist_out, void* phist_out,
                       void* demod, void* mag, void* prev_out, void* stream) {
  if (n <= 0 || n % (RES_M * NCH) != 0 || H < RS_P - 1 || K <= 0 ||
      (long long)K * ns * NCH * RES_M != n * RES_L)
    return (int)cudaErrorInvalidValue;
#define SDR_DUO_ARGS                                                        \
  (const uint8_t*)wire, n, (const float*)dc_x, (const float*)dc_y,          \
      (const float*)fhist, H, (const float*)phist, (const int*)parity,      \
      (const float*)prev, (const float*)kc, (const float*)ck_re,            \
      (const float*)ck_im, (const float*)pj, p, g, pL, pSeg, seg, inv_cu8,  \
      dscale, K, ns, (float*)ylocal, (float*)yend, (float*)carry,           \
      (float*)band, (float*)chan, (float*)dc_x_out, (float*)dc_y_out,       \
      (float*)fhist_out, (float*)phist_out, (float*)demod, (float*)mag,     \
      (float*)prev_out, (cudaStream_t)stream
  switch (fmt) {
    case FMT_CU8: return duo_launch<FMT_CU8>(SDR_DUO_ARGS);
    case FMT_CS8: return duo_launch<FMT_CS8>(SDR_DUO_ARGS);
    case FMT_CS16: return duo_launch<FMT_CS16>(SDR_DUO_ARGS);
    case FMT_CF32: return duo_launch<FMT_CF32>(SDR_DUO_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef SDR_DUO_ARGS
}

extern "C" const char* sdr_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
