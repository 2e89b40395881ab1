// K12b: the f32 contraction-precision probe on Hopper — out = a @ b for
// a f32 [M, K] and b f32 [K, N] (both row-major), at one of three
// contraction precisions:
//   mode 0, ffma:   one thread per output, fmaf over k in order on the CUDA
//                   cores (true f32; the TPU's Precision.HIGHEST result);
//   mode 1, tf32:   one tensor-core pass, mma.sync m16n8k8 .tf32 on inputs
//                   rounded by cvt.rna.tf32.f32 (10 mantissa bits, nearest,
//                   ties away) — the counterpart of the TPU's default
//                   one-pass bf16 contraction;
//   mode 2, 3xtf32: each input split into hi = tf32(x) and lo = tf32(x -
//                   hi), three mma a k-step (lo*hi, hi*lo, hi*hi) into one
//                   f32 accumulator — the counterpart of HIGHEST's
//                   multi-pass product, and the way a tensor-core redesign
//                   of the FIR and resampler loops keeps true-f32 accuracy.
//
// Replaces tools/probe_precision.py::_probe_one's Pallas body (a
// dot_general at default or HIGHEST precision, its pallas_call at :58).
// What it computes is documented beside its plain PyTorch versions,
// kernels/probe_precision.py.
//
// The tensor-core modes give one warp a 16 x 8 output tile and read their
// fragments straight from device memory (the probe's [128, 256] x [256,
// 128] fits in L2); no shared memory, no wgmma, no TMA.  What bounds it on
// the H100: the probe is 8.4 MFLOP over 320 KB, so bytes for the tensor-core
// modes and f32 operations for ffma; at this size every mode is launch
// bound.  It is a probe of the arithmetic, not a GEMM.
#include <cuda_runtime.h>
#include <stdint.h>

#include "sdr_common.cuh"

#define PD_FFMA 0
#define PD_TF32 1
#define PD_3XTF32 2
#define PD_WARPS 4           // 16 x 8 tiles (warps) per block of the mma modes

static __device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// d += a (16 x 8, row) * b (8 x 8, col), f32 accumulate
static __device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a,
                                                const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

static __global__ void probe_ffma(const float* __restrict__ a,
                                  const float* __restrict__ b,
                                  float* __restrict__ out, int M, int N,
                                  int K) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  const int m = blockIdx.y;
  if (n >= N) return;
  const float* ar = a + (size_t)m * K;
  float acc = 0.f;
  for (int k = 0; k < K; ++k) acc = fmaf(ar[k], b[(size_t)k * N + n], acc);
  out[(size_t)m * N + n] = acc;
}

// One warp per 16 x 8 tile.  Fragment layouts of m16n8k8 .tf32 (PTX ISA):
// g = lane / 4, t = lane % 4;
//   a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4);
//   b0 (t, g), b1 (t + 4, g);
//   d0 (g, 2t), d1 (g, 2t + 1), d2 (g + 8, 2t), d3 (g + 8, 2t + 1).
template <bool THREE>
static __global__ void probe_mma(const float* __restrict__ a,
                                 const float* __restrict__ b,
                                 float* __restrict__ out, int M, int N,
                                 int K) {
  const int warp = blockIdx.x * PD_WARPS + (threadIdx.x >> 5);
  const int tiles_n = N / 8;
  if (warp >= (M / 16) * tiles_n) return;  // whole warps only: mma is warp-wide
  const int m0 = (warp / tiles_n) * 16;
  const int n0 = (warp % tiles_n) * 8;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k0 = 0; k0 < K; k0 += 8) {
    const float av[4] = {a[(size_t)(m0 + g) * K + k0 + t],
                         a[(size_t)(m0 + g + 8) * K + k0 + t],
                         a[(size_t)(m0 + g) * K + k0 + t + 4],
                         a[(size_t)(m0 + g + 8) * K + k0 + t + 4]};
    const float bv[2] = {b[(size_t)(k0 + t) * N + n0 + g],
                         b[(size_t)(k0 + t + 4) * N + n0 + g]};
    uint32_t ah[4], bh[2];
#pragma unroll
    for (int i = 0; i < 4; ++i) ah[i] = to_tf32(av[i]);
#pragma unroll
    for (int i = 0; i < 2; ++i) bh[i] = to_tf32(bv[i]);
    if (THREE) {
      uint32_t al[4], bl[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) al[i] = to_tf32(av[i] - __uint_as_float(ah[i]));
#pragma unroll
      for (int i = 0; i < 2; ++i) bl[i] = to_tf32(bv[i] - __uint_as_float(bh[i]));
      mma_tf32(d, al, bh);
      mma_tf32(d, ah, bl);
    }
    mma_tf32(d, ah, bh);
  }
  out[(size_t)(m0 + g) * N + n0 + 2 * t] = d[0];
  out[(size_t)(m0 + g) * N + n0 + 2 * t + 1] = d[1];
  out[(size_t)(m0 + g + 8) * N + n0 + 2 * t] = d[2];
  out[(size_t)(m0 + g + 8) * N + n0 + 2 * t + 1] = d[3];
}

// a [M][K], b [K][N], out [M][N]; the mma modes need M % 16 == 0,
// N % 8 == 0 and K % 8 == 0 (checked again by the wrapper)
extern "C" int probe_dot_run(const float* a, const float* b, float* out,
                             int M, int N, int K, int mode, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (mode == PD_FFMA) {
    if (M > 65535) return (int)cudaErrorInvalidValue;
    probe_ffma<<<dim3((N + 127) / 128, M), 128, 0, s>>>(a, b, out, M, N, K);
  } else if (mode == PD_TF32 || mode == PD_3XTF32) {
    if (M % 16 || N % 8 || K % 8) return (int)cudaErrorInvalidValue;
    const int tiles = (M / 16) * (N / 8);
    const int blocks = (tiles + PD_WARPS - 1) / PD_WARPS;
    if (mode == PD_TF32)
      probe_mma<false><<<blocks, 32 * PD_WARPS, 0, s>>>(a, b, out, M, N, K);
    else
      probe_mma<true><<<blocks, 32 * PD_WARPS, 0, s>>>(a, b, out, M, N, K);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  SDR_CHECK_LAUNCH();
  return 0;
}
