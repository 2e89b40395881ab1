// The 16-channel PFB and the discriminator, shared by K1 (csrc/duo.cu) and
// K7 (csrc/pfb_demod.cu).  What they compute is documented beside K7's
// plain PyTorch version, kernels/pfb_demod.py::PfbDemod.
//   pfb_filter: the 416-tap complex PFB in its factored form (below) over a
//     shared-memory window of [pfb_hist | band], then the (-1)^(parity +
//     frame) mixer flip -> the channel planes [2][16][F];
//   pfb_demod_mag: discriminator (native atan2f) and the per-(sub-chunk,
//     channel) |y| sums as a deterministic block reduction;
//   pfb_demod_plane: discriminator and the |y| plane, one thread a sample;
//   pfb_state: pfb_hist', the last 400 samples of [pfb_hist | band].
//
// The fused kernel CK[t][k] = h[415 - t] e^{j w (t - 400)} W16^{k t} (w the
// mixer, 16 w = 15 pi) factors at t = 16 m + r into g[m][r] c_r W16^{k r}:
// g[m][r] = h[415 - 16 m - r] (-1)^m real [26][16], c_r = e^{j w (r - 400)}
// (kernels/pfb_demod.py::pfb_factors, float64 on the host, f32 here).  So a
// frame is 16 branch sums of 26 real taps on complex samples, a twiddle c_r
// each, and one 16-point DFT: ~2,100 operations where CK takes 53,000.
// Thread (frame group, branch r) keeps its 26 taps in registers and runs
// PFB_FT frames f, f + 2, ... (the two half-warps take neighbouring
// frames): the frames share 24 of their 26 window rows, so a frame costs
// ~8 shared loads per plane and branch.  The DFT is a radix-2 decimation in
// frequency across the 16 lanes of a frame (shuffles; lane r ends with bin
// bitrev(r)); the bins go out through shared memory in coalesced rows.  A
// fixed order throughout, no atomics: a call is bit-equal to itself.
#pragma once

#include "sdr_common.cuh"

#define PFB_TAPS 416
#define PFB_HIST 400
#define PFB_M (PFB_TAPS / NCH)   // taps per branch (26)
#define PFB_FT 4                 // frames per thread
#define PFB_THREADS 256
#define PFB_FB (PFB_THREADS / NCH * PFB_FT)  // frames per block (64)
#define PFB_WIN (NCH * (PFB_FB - 1) + PFB_TAPS)
#define PFB_ROW (PFB_FB + 2)     // staged bin row: the two half-warps' stores
//                                  fall on distinct banks

// chan[k][f] = (-1)^(parity + f) sum_t CK[t][k] xe[16 f + t],
//    xe = [pfb_hist (400) | band]; pg [26][16] the branch taps, pc [16] the
//    branch twiddles c_r and pw [16] the roots W16^e = e^{-2 pi j e / 16}
//    (complex as float2)
static __global__ void __launch_bounds__(PFB_THREADS)
pfb_filter(const float* __restrict__ band, long long nb,
           const float* __restrict__ phist, const float* __restrict__ pg,
           const float2* __restrict__ pc, const float2* __restrict__ pw,
           const int* __restrict__ parity, float* __restrict__ chan,
           int frames) {
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
  const int r = threadIdx.x % NCH;
  // local frames fb + 2 t: a warp's two halves take fb and fb + 1
  const int fb = (threadIdx.x / (2 * NCH)) * (2 * PFB_FT) +
                 (threadIdx.x / NCH) % 2;
  float g[PFB_M];
#pragma unroll
  for (int m = 0; m < PFB_M; ++m) g[m] = __ldg(pg + m * NCH + r);
  const float2 c = __ldg(pc + r);
  // the butterflies' twiddles: stage span hs, upper lanes W16^((r % hs) 8/hs)
  float2 tw[3];
#pragma unroll
  for (int st = 0; st < 3; ++st) {
    const int hs = 8 >> st;
    tw[st] = (r & hs) ? __ldg(pw + (r & (hs - 1)) * (8 / hs))
                      : make_float2(1.f, 0.f);
  }
  __syncthreads();
  float ur[PFB_FT], ui[PFB_FT];
#pragma unroll
  for (int t = 0; t < PFB_FT; ++t) ur[t] = ui[t] = 0.f;
#pragma unroll
  for (int mm = 0; mm < PFB_M + 2 * (PFB_FT - 1); ++mm) {
    const float vr = xr[NCH * (fb + mm) + r];
    const float vi = xi[NCH * (fb + mm) + r];
#pragma unroll
    for (int t = 0; t < PFB_FT; ++t) {
      const int m = mm - 2 * t;
      if (m >= 0 && m < PFB_M) {
        ur[t] = fmaf(g[m], vr, ur[t]);
        ui[t] = fmaf(g[m], vi, ui[t]);
      }
    }
  }
  // branch twiddle, then the DFT over the 16 lanes of each frame
#pragma unroll
  for (int t = 0; t < PFB_FT; ++t) {
    const float a = ur[t] * c.x - ui[t] * c.y;
    const float b = ur[t] * c.y + ui[t] * c.x;
    ur[t] = a;
    ui[t] = b;
  }
#pragma unroll
  for (int st = 0; st < 4; ++st) {
    const int hs = 8 >> st;
    const bool upper = (r & hs) != 0;
#pragma unroll
    for (int t = 0; t < PFB_FT; ++t) {
      const float pr = __shfl_xor_sync(0xffffffffu, ur[t], hs);
      const float pi = __shfl_xor_sync(0xffffffffu, ui[t], hs);
      if (upper) {
        const float dr = pr - ur[t], di = pi - ui[t];
        if (st < 3) {
          ur[t] = dr * tw[st].x - di * tw[st].y;
          ui[t] = dr * tw[st].y + di * tw[st].x;
        } else {
          ur[t] = dr;
          ui[t] = di;
        }
      } else {
        ur[t] += pr;
        ui[t] += pi;
      }
    }
  }
  __syncthreads();  // every warp is done with the window: stage the bins
  const int k = ((r & 1) << 3) | ((r & 2) << 1) | ((r & 4) >> 1) | (r >> 3);
  const int sp = parity[0];
#pragma unroll
  for (int t = 0; t < PFB_FT; ++t) {
    const int fl = fb + 2 * t;
    const float sgn = ((f0 + fl + sp) & 1) ? -1.f : 1.f;
    xr[k * PFB_ROW + fl] = sgn * ur[t];
    xi[k * PFB_ROW + fl] = sgn * ui[t];
  }
  __syncthreads();
  const int nf = min(PFB_FB, frames - f0);
  for (int i = threadIdx.x; i < 2 * NCH * PFB_FB; i += blockDim.x) {
    const int p = i / (NCH * PFB_FB);
    const int kk = (i / PFB_FB) % NCH;
    const int fl = i % PFB_FB;
    if (fl >= nf) continue;
    chan[(long long)(p * NCH + kk) * frames + f0 + fl] =
        (p ? xi : xr)[kk * PFB_ROW + fl];
  }
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
                            const float* prev, const float* pg,
                            const float* pc, const float* pw, float dscale,
                            int K, int ns,
                            float* chan, float* demod, float* mag,
                            float* prev_out, cudaStream_t s) {
  const int frames = (int)(nb / NCH);
  pfb_filter<<<(frames + PFB_FB - 1) / PFB_FB, PFB_THREADS, 0, s>>>(
      band, nb, phist, pg, reinterpret_cast<const float2*>(pc),
      reinterpret_cast<const float2*>(pw), parity, chan, frames);
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
