// The 16-channel PFB and the discriminator, shared by K1 (csrc/duo.cu) and
// K7 (csrc/pfb_demod.cu).  What they compute is documented beside K7's
// plain PyTorch version, kernels/pfb_demod.py::PfbDemod.
//   pfb_filter: 416-tap complex PFB, one thread per (frame, channel), over a
//     shared-memory window of [pfb_hist | band], then the (-1)^(parity +
//     frame) mixer flip -> the channel planes [2][16][F];
//   pfb_demod_mag: discriminator (native atan2f) and the per-(sub-chunk,
//     channel) |y| sums as a deterministic block reduction;
//   pfb_demod_plane: discriminator and the |y| plane, one thread a sample;
//   pfb_state: pfb_hist', the last 400 samples of [pfb_hist | band].
#pragma once

#include "sdr_common.cuh"

#define PFB_TAPS 416
#define PFB_HIST 400
#define PFB_FB 16         // channel frames per block
#define PFB_WIN (NCH * (PFB_FB - 1) + PFB_TAPS)

// chan[k][f] = (-1)^(parity + f) sum_t CK[t][k] xe[16 f + t],
//    xe = [pfb_hist (400) | band]
static __global__ void pfb_filter(const float* __restrict__ band, long long nb,
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

// Sample n of channel c: demod[c][n] = atan2(x[n] conj(x[n-1])) * dscale
// (x[-1] the carried prev), prev_out[c] = x[F-1]; returns |x[n]|.
static __device__ __forceinline__ float pfb_demod_at(
    const float* __restrict__ chan, int frames, int c, int n,
    const float* __restrict__ prev_in, float dscale,
    float* __restrict__ demod, float* __restrict__ prev_out) {
  const float* cr = chan + (long long)c * frames;
  const float* ci = chan + (long long)(NCH + c) * frames;
  const float xr = cr[n], xi = ci[n];
  const float pr = n == 0 ? prev_in[2 * c] : cr[n - 1];
  const float pi = n == 0 ? prev_in[2 * c + 1] : ci[n - 1];
  demod[(long long)c * frames + n] =
      atan2f(xi * pr - xr * pi, xr * pr + xi * pi) * dscale;
  if (n == frames - 1) {
    prev_out[2 * c] = xr;
    prev_out[2 * c + 1] = xi;
  }
  return hypotf(xr, xi);
}

// one block per (sub-chunk, channel): demod and the sum of |y|
static __global__ void pfb_demod_mag(const float* __restrict__ chan,
                                     int frames, int ns,
                                     const float* __restrict__ prev_in,
                                     float dscale, float* __restrict__ demod,
                                     float* __restrict__ mag,
                                     float* __restrict__ prev_out) {
  __shared__ float sh[RED_THREADS];
  const int kk = blockIdx.x;
  const int c = blockIdx.y;
  float acc = 0.f;
  for (int i = threadIdx.x; i < ns; i += blockDim.x)
    acc += pfb_demod_at(chan, frames, c, kk * ns + i, prev_in, dscale, demod,
                        prev_out);
  const float s = block_sum(acc, sh);
  if (threadIdx.x == 0) mag[kk * NCH + c] = s;
}

// one thread per (channel, sample): demod and the |y| plane [16][F]
static __global__ void pfb_demod_plane(const float* __restrict__ chan,
                                       int frames,
                                       const float* __restrict__ prev_in,
                                       float dscale, float* __restrict__ demod,
                                       float* __restrict__ mag,
                                       float* __restrict__ prev_out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)NCH * frames) return;
  const int c = (int)(i / frames);
  const int n = (int)(i % frames);
  mag[i] = pfb_demod_at(chan, frames, c, n, prev_in, dscale, demod, prev_out);
}

// pfb_hist' = the last 400 samples of [pfb_hist | band]
static __global__ void pfb_state(const float* __restrict__ phist_in,
                                 const float* __restrict__ band, long long nb,
                                 float* __restrict__ phist_out) {
  hist_tail(blockIdx.x * blockDim.x + threadIdx.x, phist_in, PFB_HIST, band,
            band + nb, nb, phist_out);
}

// The PFB and the discriminator for nb band samples (frames = nb / 16):
// K sub-chunks of ns frames give mag [K][16] sums, or with K == 0 the |y|
// plane mag [16][F].  chan is scratch [2][16][F].
static int pfb_demod_launch(const float* band, long long nb,
                            const float* phist, const int* parity,
                            const float* prev, const float* ck_re,
                            const float* ck_im, float dscale, int K, int ns,
                            float* chan, float* demod, float* mag,
                            float* prev_out, cudaStream_t s) {
  const int frames = (int)(nb / NCH);
  pfb_filter<<<(frames + PFB_FB - 1) / PFB_FB, NCH * PFB_FB, 0, s>>>(
      band, nb, phist, ck_re, ck_im, parity, chan, frames);
  SDR_CHECK_LAUNCH();
  if (K > 0)
    pfb_demod_mag<<<dim3(K, NCH), RED_THREADS, 0, s>>>(
        chan, frames, ns, prev, dscale, demod, mag, prev_out);
  else
    pfb_demod_plane<<<(NCH * frames + 255) / 256, 256, 0, s>>>(
        chan, frames, prev, dscale, demod, mag, prev_out);
  SDR_CHECK_LAUNCH();
  return 0;
}
