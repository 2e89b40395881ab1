// K12a: the layout probes on Hopper — eight data moves that a fused
// front-end -> PFB kernel needs, each run on real values:
//   0 scratch_store_off16  x [8, 256] -> [8, 128]: s = x, s[:, 16:32] =
//                          x[:, 0:16], out = s[:, 0:128]
//   1 scratch_read_off16   x [8, 256] -> s[:, 16:144] [8, 128]
//   2 scratch_read_narrow  x [8, 256] -> s[:, 16:32] [8, 16]
//   3 value_lane_off16     x [8, 256] -> x[:, 16:144] [8, 128], from
//                          registers (warp shuffles, no shared memory)
//   4 value_stride_sub     x [128, 256] -> x[0::16, :] [8, 256]
//   5 reshape_rows_wide    x [128, 128] -> reshape [8, 2048]
//   6 reshape_25_16        x [128, 25] -> reshape [200, 16]
//   7 transpose_16         x [128, 16] -> x.T [16, 128]
//
// Replaces tools/probe_layout.py::_call's Pallas kernels (the bodies in its
// main(), pallas_call at :50), which only compile on zeros.  What each move
// computes is documented beside its plain PyTorch version,
// kernels/probe_layout.py.
//
// One block of 256 threads per move.  Every move but 3 stages its input in
// shared memory (the counterpart of the VMEM scratch: on Hopper the
// in-kernel reshapes, strided rows and lane offsets are index arithmetic
// on shared memory, no relayout), then writes the output with neighbouring
// threads on neighbouring output addresses.  The transpose's tile has rows
// of 17 words, so the column reads fall in 17 different banks.  Inputs
// above 48 KB (moves 4 and 5: 128 and 64 KB) take dynamic shared memory
// after cudaFuncSetAttribute.  What bounds it on the H100: a few KB to
// 128 KB a move, read once and written once — launch bound; the bytes
// would take under 0.1 us.
#include <cuda_runtime.h>
#include <stdint.h>

#include "sdr_common.cuh"

#define PL_THREADS 256
#define PL_MOVES 8

struct PlShape {
  int rows_in, cols_in, ld, rows_out, cols_out;
};

// input [rows_in, cols_in], its shared-memory row stride, output shape
static __host__ __device__ PlShape pl_shape(int move) {
  switch (move) {
    case 0: return {8, 256, 256, 8, 128};
    case 1: return {8, 256, 256, 8, 128};
    case 2: return {8, 256, 256, 8, 16};
    case 3: return {8, 256, 256, 8, 128};
    case 4: return {128, 256, 256, 8, 256};
    case 5: return {128, 128, 128, 8, 2048};
    case 6: return {128, 25, 25, 200, 16};
    default: return {128, 16, 17, 16, 128};
  }
}

static __device__ __forceinline__ void lane_off16(const float* __restrict__ x,
                                                  float* __restrict__ out) {
  // warp r holds row r: lane l has x[r, l + 32 j], j < 8; out[r, l + 32 j]
  // = x[r, l + 32 j + 16] lives in lane l ^ 16, register j (l < 16) or
  // j + 1 (l >= 16)
  const int lane = threadIdx.x & 31;
  const int r = threadIdx.x >> 5;
  float v[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = x[r * 256 + lane + 32 * j];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float lo = __shfl_sync(0xffffffffu, v[j], lane ^ 16);
    const float hi = __shfl_sync(0xffffffffu, v[j + 1], lane ^ 16);
    out[r * 128 + lane + 32 * j] = lane < 16 ? lo : hi;
  }
}

static __global__ void layout_probe(int move, const float* __restrict__ x,
                                    float* __restrict__ out) {
  extern __shared__ float s[];
  if (move == 3) {
    lane_off16(x, out);
    return;
  }
  const PlShape sh = pl_shape(move);
  const int n_in = sh.rows_in * sh.cols_in;
  for (int i = threadIdx.x; i < n_in; i += PL_THREADS)
    s[(i / sh.cols_in) * sh.ld + i % sh.cols_in] = x[i];
  __syncthreads();
  if (move == 0) {
    for (int i = threadIdx.x; i < 8 * 16; i += PL_THREADS)
      s[(i / 16) * sh.ld + 16 + i % 16] = x[(i / 16) * 256 + i % 16];
    __syncthreads();
  }
  const int n_out = sh.rows_out * sh.cols_out;
  for (int i = threadIdx.x; i < n_out; i += PL_THREADS) {
    const int r = i / sh.cols_out, c = i % sh.cols_out;
    float v;
    switch (move) {
      case 0: v = s[r * sh.ld + c]; break;
      case 1:
      case 2: v = s[r * sh.ld + 16 + c]; break;
      case 4: v = s[16 * r * sh.ld + c]; break;
      case 7: v = s[c * sh.ld + r]; break;
      default:  // 5, 6: a row-major reshape keeps the flat index
        v = s[(i / sh.cols_in) * sh.ld + i % sh.cols_in];
    }
    out[i] = v;
  }
}

// x and out hold move's input and output shapes, contiguous f32
extern "C" int probe_layout_run(int move, const float* x, float* out,
                                void* stream) {
  if (move < 0 || move >= PL_MOVES) return (int)cudaErrorInvalidValue;
  const PlShape sh = pl_shape(move);
  const size_t smem =
      move == 3 ? 0 : (size_t)sh.rows_in * sh.ld * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        layout_probe, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  layout_probe<<<1, PL_THREADS, smem, (cudaStream_t)stream>>>(move, x, out);
  SDR_CHECK_LAUNCH();
  return 0;
}
