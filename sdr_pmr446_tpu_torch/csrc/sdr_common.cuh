// Shared device code of the port's kernels (csrc/*.cu).
//
// The one-pole DC blocker y[n] = p*y[n-1] + g*(x[n] - x[n-1]) runs as a
// chunked parallel scan, the replacement for the TPU kernels' triangular
// carry matmuls (kernels/front_end.py _ylocal/_plane_dc):
//   1. each thread runs the zero-state recurrence over one DC_L-sample chunk
//      and stores the chunk-local response and its end value;
//   2. dc_carry_kernel turns the chunk ends into the carry INTO each chunk
//      (one block per row: per-thread segment scans, one sequential pass over
//      the segment ends, a second per-thread pass writing the carries);
//   3. consumers fix up y[n] = ylocal[n] + carry[n / DC_L] * p^(n % DC_L + 1)
//      while loading (dc_fix).
// The recurrences accumulate in double: an f32 one-pole with p = 0.9995
// feeds each step's rounding back for ~2000 samples, which costs ~10 dB of
// SNR in the channels next to DC; in double only the stores round.  The pole
// and decay constants come from the host in double; the fix-up table
// p^(j+1) is computed in double on the host and rounded once to f32.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define DC_L 64             // samples per scan chunk (kernels/duo.py DC_L)
#define CARRY_THREADS 1024  // threads of the carry block (kernels/duo.py)
#define RED_THREADS 256     // block size of the deterministic reductions
#define NCH 16

// Carry into every chunk of row blockIdx.x: carry[c] = y just before chunk c.
//   yend  [rows][chunks]  zero-state chunk end values
//   y0    [rows]          the row's y[-1]
//   pL = p^DC_L, pSeg = pL^seg, seg = chunks per thread (ceil(chunks/1024))
static __global__ void dc_carry_kernel(const float* __restrict__ yend,
                                       float* __restrict__ carry,
                                       const float* __restrict__ y0,
                                       int chunks, double pL, double pSeg,
                                       int seg) {
  __shared__ double s_end[CARRY_THREADS];
  const int r = blockIdx.x;
  const int t = threadIdx.x;
  const float* e = yend + (size_t)r * chunks;
  float* out = carry + (size_t)r * chunks;
  const int c0 = t * seg;
  const int c1 = min(c0 + seg, chunks);
  double s = 0.0;
  for (int c = c0; c < c1; ++c) s = pL * s + e[c];
  s_end[t] = s;
  __syncthreads();
  if (t == 0) {
    // only the last non-empty segment can be short, and nothing after it
    // reads the carry its decay would produce
    double y = y0[r];
    for (int i = 0; i < CARRY_THREADS; ++i) {
      const double v = s_end[i];
      s_end[i] = y;
      y = pSeg * y + v;
    }
  }
  __syncthreads();
  double y = s_end[t];
  for (int c = c0; c < c1; ++c) {
    out[c] = (float)y;
    y = pL * y + e[c];
  }
}

// y[n] of one row from its chunk-local response and the chunk carries.
static __device__ __forceinline__ float dc_fix(const float* __restrict__ ylocal,
                                               const float* __restrict__ carry,
                                               const float* __restrict__ pj,
                                               long long n) {
  return ylocal[n] + carry[n / DC_L] * pj[n % DC_L];
}

// Entry j < HB of a carried history: the last HB samples of [hist (HB
// complex, interleaved) | x (nb samples, planes xr and xi)].
static __device__ __forceinline__ void hist_tail(int j,
                                                 const float* __restrict__ hist,
                                                 int HB,
                                                 const float* __restrict__ xr,
                                                 const float* __restrict__ xi,
                                                 long long nb,
                                                 float* __restrict__ hist_out) {
  if (j >= HB) return;
  const long long e = nb + j;
  float vr, vi;
  if (e < HB) {
    vr = hist[2 * e];
    vi = hist[2 * e + 1];
  } else {
    vr = xr[e - HB];
    vi = xi[e - HB];
  }
  hist_out[2 * j] = vr;
  hist_out[2 * j + 1] = vi;
}

// Deterministic sum over a RED_THREADS block (fixed tree order, no atomics).
static __device__ __forceinline__ float block_sum(float v, float* sh) {
  const int t = threadIdx.x;
  sh[t] = v;
  __syncthreads();
  for (int s = RED_THREADS / 2; s > 0; s >>= 1) {
    if (t < s) sh[t] += sh[t + s];
    __syncthreads();
  }
  const float r = sh[0];
  __syncthreads();
  return r;
}

#define SDR_CHECK_LAUNCH()                      \
  do {                                          \
    cudaError_t e_ = cudaGetLastError();        \
    if (e_ != cudaSuccess) return (int)e_;      \
  } while (0)
