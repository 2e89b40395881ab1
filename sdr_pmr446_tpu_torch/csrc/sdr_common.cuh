// Shared device code of the port's kernels (csrc/*.cu).
//
// The one-pole DC blocker y[n] = p*y[n-1] + g*(x[n] - x[n-1]) runs as a
// chunked parallel scan, the replacement for the TPU kernels' triangular
// carry matmuls (kernels/front_end.py _ylocal/_plane_dc):
//   1. each thread runs the zero-state recurrence over one DC_L-sample chunk
//      and stores the chunk-local response and its end value;
//   2. dc_carry_kernel turns the chunk ends into the carry INTO each chunk
//      (one block per row: each chunk an affine map, composed by warp
//      shuffle scans over tiles of 32 x CARRY_G chunks, coalesced);
//   3. consumers fix up y[n] = ylocal[n] + carry[n / DC_L] * p^(n % DC_L + 1)
//      while loading (dc_fix).
// The recurrences accumulate in double: an f32 one-pole with p = 0.9995
// feeds each step's rounding back for ~2000 samples, which costs ~10 dB of
// SNR in the channels next to DC; in double only the stores round.  The pole
// and its power pL = p^DC_L come from the host in double; the fix-up table
// p^(j+1) is computed in double on the host and rounded once to f32.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define DC_L 64             // samples per scan chunk (kernels/duo.py DC_L)
#define CARRY_THREADS 1024  // threads of the carry block
#define RED_THREADS 256     // block size of the deterministic reductions
#define NCH 16

// Carry into every chunk of row blockIdx.x: carry[c] = y just before chunk c,
// with carry[c + 1] = pL carry[c] + yend[c] and carry[0] = y0.
//   yend  [rows][chunks]  zero-state chunk end values
//   y0    [rows]          the row's y[-1]
//   pL = p^DC_L
// k chunks compose to a map y -> pL^k y + b.  Each warp takes a contiguous
// range of chunks in tiles of 32 x CARRY_G, each lane CARRY_G consecutive
// chunks (the next tile's loads in flight while one is scanned): a lane
// composes its own chunks in registers, a shuffle scan over the lanes
// gives each lane the b of the lanes below it (the multipliers pL^(G 2^i)
// are known, so only b moves; lanes past the range sit above every valid
// one).  Pass 1 composes the warp's range, one thread chains the ranges
// from y0, pass 2 runs each lane's chunks from its carry-in and writes the
// carries.  All in double.
#define CARRY_G 4

static __global__ void __launch_bounds__(CARRY_THREADS)
dc_carry_kernel(const float* __restrict__ yend, float* __restrict__ carry,
                const float* __restrict__ y0, int chunks, double pL) {
  constexpr int WARPS = CARRY_THREADS / 32;
  constexpr int TILE = 32 * CARRY_G;
  __shared__ double s_a[WARPS], s_b[WARPS], s_in[WARPS];
  const int r = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const float* e = yend + (size_t)r * chunks;
  float* out = carry + (size_t)r * chunks;
  const int per = (chunks + TILE * WARPS - 1) / (TILE * WARPS) * TILE;
  const int c0 = min(w * per, chunks);
  const int c1 = min(c0 + per, chunks);
  double pw[8];  // pL^(2^i)
  pw[0] = pL;
#pragma unroll
  for (int i = 1; i < 8; ++i) pw[i] = pw[i - 1] * pw[i - 1];
  auto power = [&](int k) {  // pL^k, 0 <= k < 256
    double x = 1.0;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (k & (1 << i)) x *= pw[i];
    return x;
  };
  auto load = [&](float (&v)[CARRY_G], int t) {
    const int c = t + CARRY_G * lane;
#pragma unroll
    for (int k = 0; k < CARRY_G; ++k) v[k] = c + k < c1 ? e[c + k] : 0.f;
  };
  // every tile of the warp's range: body(tile start, this lane's values,
  // their count, their b, the b of the lanes below, the last valid lane)
  auto tiles = [&](auto body) {
    float v[CARRY_G], vn[CARRY_G];
    if (c0 < c1) load(v, c0);
    for (int t = c0; t < c1; t += TILE) {
      if (t + TILE < c1) load(vn, t + TILE);
      const int cnt = max(0, min(CARRY_G, c1 - t - CARRY_G * lane));
      double b = 0.0;
#pragma unroll
      for (int k = 0; k < CARRY_G; ++k)
        if (k < cnt) b = fma(pL, b, (double)v[k]);
      double incl = b;
      static_assert(CARRY_G == 4, "lane multipliers pw[i + 2] = pL^(4 2^i)");
#pragma unroll
      for (int i = 0; i < 5; ++i) {
        const double up = __shfl_up_sync(0xffffffffu, incl, 1 << i);
        if (lane >= (1 << i)) incl = fma(pw[i + 2], up, incl);
      }
      double below = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) below = 0.0;
      body(t, v, cnt, b, below, min(31, (c1 - t - 1) / CARRY_G));
#pragma unroll
      for (int k = 0; k < CARRY_G; ++k) v[k] = vn[k];
    }
  };
  double a = 1.0, bw = 0.0;
  tiles([&](int, const float(&)[CARRY_G], int cnt, double b, double below,
            int last) {
    const double tb =
        __shfl_sync(0xffffffffu, fma(power(cnt), below, b), last);
    const double ta =
        power(CARRY_G * last + __shfl_sync(0xffffffffu, cnt, last));
    bw = fma(ta, bw, tb);
    a *= ta;
  });
  if (lane == 0) {
    s_a[w] = a;
    s_b[w] = bw;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double y = y0[r];
    for (int i = 0; i < WARPS; ++i) {
      s_in[i] = y;
      y = fma(s_a[i], y, s_b[i]);
    }
  }
  __syncthreads();
  double y = s_in[w];
  const double p_lane = power(CARRY_G * lane);
  tiles([&](int t, const float (&v)[CARRY_G], int cnt, double, double below,
            int last) {
    double yl = fma(p_lane, y, below);  // y before this lane's chunks
    const int c = t + CARRY_G * lane;
#pragma unroll
    for (int k = 0; k < CARRY_G; ++k)
      if (k < cnt) {
        out[c + k] = (float)yl;
        yl = fma(pL, yl, (double)v[k]);
      }
    y = __shfl_sync(0xffffffffu, yl, last);
  });
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

// Asynchronous copy of B (4, 8 or 16) bytes from device to shared memory;
// with valid false the B bytes are zero-filled and nothing is read.
template <int B>
static __device__ __forceinline__ void cp_async(void* dst, const void* src,
                                                bool valid = true) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
               "l"(src), "n"(B), "r"(valid ? B : 0)
               : "memory");
}

// Wait for this thread's asynchronous copies (then __syncthreads for the
// block's).
static __device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// A shared-memory pointer's 32-bit shared address.
static __device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Raises a kernel's dynamic shared-memory limit when it needs more than
// the default 48 KB.
template <class Kernel>
static cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

#define SDR_CHECK_LAUNCH()                      \
  do {                                          \
    cudaError_t e_ = cudaGetLastError();        \
    if (e_ != cudaSuccess) return (int)e_;      \
  } while (0)
