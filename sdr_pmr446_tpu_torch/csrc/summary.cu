// K10: the read-only zero-state DC summary of the time-sharded pre-pass on
// Hopper — per 128-sample row of the wire, both planes:
//   w[r]  = sum_j v[j] * x[r*128 + j]   (v = fused_halo.dc_row_weights)
//   xl[r] = x[r*128 + 127]
//
// Replaces sdr_pmr446_tpu/kernels/summary.py::zero_summary_wire (bodies
// _body_ilv, _body_cs16, _body_pk2 and their selector matrices, _consts).
// What it computes is documented beside its plain PyTorch version,
// kernels/summary.py.
//
// One launch for the whole step (every stream and time shard: a row never
// straddles a shard, t_local = K_local * 784 * 128).  One warp per row:
// lane l decodes samples l, l + 32, l + 64 and l + 96 with load_iq
// (front_end.cuh, so the decode is bit-equal to K1's and K4's; neighbouring
// lanes read neighbouring samples), multiplies by v from shared memory,
// and a warp-shuffle tree sums each plane; lane 31 holds sample 127 and
// writes xl.  What bounds it on the H100: bytes — the wire is read once
// (2-8 B a sample) and 16 B leave per 128 samples; ~4 operations a sample.
// The TPU kernel's MXU selector matmuls (no lane slices at odd offsets)
// have no counterpart.
#include "front_end.cuh"

#define ZS_ROW 128
#define ZS_WARPS 8          // rows per block

template <int FMT>
static __global__ void zs_rows(const uint8_t* __restrict__ wire,
                               long long rows, const float* __restrict__ v,
                               float inv_cu8, float* __restrict__ w,
                               float* __restrict__ xl) {
  __shared__ float sv[ZS_ROW];
  for (int i = threadIdx.x; i < ZS_ROW; i += blockDim.x) sv[i] = v[i];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long long r = (long long)blockIdx.x * ZS_WARPS + (threadIdx.x >> 5);
  if (r >= rows) return;
  const long long n0 = r * ZS_ROW;
  float sr = 0.f, si = 0.f;
  float2 x = make_float2(0.f, 0.f);
#pragma unroll
  for (int k = 0; k < ZS_ROW / 32; ++k) {
    const int j = lane + 32 * k;
    x = load_iq<FMT>(wire, n0 + j, inv_cu8);
    sr = fmaf(sv[j], x.x, sr);
    si = fmaf(sv[j], x.y, si);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    sr += __shfl_down_sync(0xffffffffu, sr, off);
    si += __shfl_down_sync(0xffffffffu, si, off);
  }
  if (lane == 0) {
    w[r] = sr;
    w[rows + r] = si;
  }
  if (lane == 31) {  // its last sample is 96 + 31 = 127
    xl[r] = x.x;
    xl[rows + r] = x.y;
  }
}

template <int FMT>
static int zs_launch(const uint8_t* wire, long long rows, const float* v,
                     float inv_cu8, float* w, float* xl, cudaStream_t s) {
  const long long blocks = (rows + ZS_WARPS - 1) / ZS_WARPS;
  zs_rows<FMT><<<(unsigned)blocks, 32 * ZS_WARPS, 0, s>>>(wire, rows, v,
                                                          inv_cu8, w, xl);
  SDR_CHECK_LAUNCH();
  return 0;
}

// wire: n samples of format fmt; w, xl: [2][n / 128] f32 (re plane, then im)
extern "C" int zero_summary_run(int fmt, const void* wire, long long n,
                                const void* v, float inv_cu8, void* w,
                                void* xl, void* stream) {
  if (n <= 0 || n % ZS_ROW != 0 || n / ZS_ROW / ZS_WARPS >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const long long rows = n / ZS_ROW;
#define SDR_ZS_ARGS                                                     \
  (const uint8_t*)wire, rows, (const float*)v, inv_cu8, (float*)w,     \
      (float*)xl, (cudaStream_t)stream
  switch (fmt) {
    case FMT_CU8: return zs_launch<FMT_CU8>(SDR_ZS_ARGS);
    case FMT_CS8: return zs_launch<FMT_CS8>(SDR_ZS_ARGS);
    case FMT_CS16: return zs_launch<FMT_CS16>(SDR_ZS_ARGS);
    case FMT_CF32: return zs_launch<FMT_CF32>(SDR_ZS_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef SDR_ZS_ARGS
}
