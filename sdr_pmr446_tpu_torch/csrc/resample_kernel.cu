// K9: the 25/128 polyphase resampler on re/im planes on Hopper.
//
// Replaces sdr_pmr446_tpu/kernels/resample_kernel.py::PallasResampler
// .apply_planes.  What it computes is documented beside its plain PyTorch
// version, kernels/resample_kernel.py.
//
// Two launches on the caller's stream, no allocation:
//   1. rs_resample: each block loads its window of xe = [hist (P - 1 = 345)
//      | x] planes and the staged taps into shared memory, then runs
//      front_end.cuh's resample_tile on them (the arithmetic K1, K4 and K6
//      run on their DC-fixed window);
//   2. rs_state: hist' = the last 345 samples of xe.
// What bounds it on the H100: 346 taps on two planes for each band sample,
// ~270 f32 operations an input sample — ~1.1 GFLOP at K = 40, ~16 us at the
// card's f32 rate, against an 8-byte plane read and a 1.6-byte band write
// an input sample.  Operations bound.  The design is a register-tiled
// product (front_end.cuh): each thread keeps 2 frames x 13 phases x 2
// planes of sums in registers, fed 52 FFMAs a row from 2 window loads and
// 4 broadcast tap loads out of shared memory; a block reads its 64 frames'
// window from device memory once (1.04x the 8,192 samples it consumes).
// The padded rows cost 1.23x the 8,650 multiply-adds a frame and plane.
#include "front_end.cuh"

static __global__ void __launch_bounds__(RS_THREADS)
rs_resample(const float* __restrict__ hist, int P1,
            const float* __restrict__ xr, const float* __restrict__ xi,
            long long n, const float4* __restrict__ kt,
            float* __restrict__ band, long long nb, int frames) {
  extern __shared__ float4 rs_smem[];
  float2* win = reinterpret_cast<float2*>(rs_smem + RS_TAP_F4);
  const int f0 = blockIdx.x * RS_FB;
  const long long base = (long long)RES_M * f0;
  rs_fetch(kt, rs_smem, win, hist, P1, xr, xi, n, base);
  cp_async_wait_all();
  __syncthreads();
  resample_tile(rs_smem, win, band, nb, f0, frames);
}

static __global__ void rs_state(const float* __restrict__ hist, int P1,
                                const float* __restrict__ xr,
                                const float* __restrict__ xi, long long n,
                                float* __restrict__ hist_out) {
  hist_tail(blockIdx.x * blockDim.x + threadIdx.x, hist, P1, xr, xi, n,
            hist_out);
}

extern "C" int resample_run(const void* hist, int P1, const void* xr,
                            const void* xi, long long n, const void* kt,
                            void* band, void* hist_out, void* stream) {
  if (n <= 0 || n % RES_M != 0 || P1 != RS_P - 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int frames = (int)(n / RES_M);
  const long long nb = (long long)frames * RES_L;
  const cudaError_t opened = rs_open(rs_resample);
  if (opened != cudaSuccess) return (int)opened;
  rs_resample<<<(frames + RS_FB - 1) / RS_FB, RS_THREADS, RS_SMEM, s>>>(
      (const float*)hist, P1, (const float*)xr, (const float*)xi, n,
      (const float4*)kt, (float*)band, nb, frames);
  SDR_CHECK_LAUNCH();
  rs_state<<<(P1 + 255) / 256, 256, 0, s>>>(
      (const float*)hist, P1, (const float*)xr, (const float*)xi, n,
      (float*)hist_out);
  SDR_CHECK_LAUNCH();
  return 0;
}
