// K9: the 25/128 polyphase resampler on re/im planes on Hopper.
//
// Replaces sdr_pmr446_tpu/kernels/resample_kernel.py::PallasResampler
// .apply_planes.  What it computes is documented beside its plain PyTorch
// version, kernels/resample_kernel.py.
//
// Two launches on the caller's stream, no allocation:
//   1. rs_resample: one thread per band output; each block loads its window
//      of xe = [hist (P - 1 = 345) | x] planes into shared memory, then runs
//      front_end.cuh's resample_frames on it (the arithmetic K1, K4 and K6
//      run on their DC-fixed window);
//   2. rs_state: hist' = the last 345 samples of xe.
// What bounds it on the H100: 346 taps on two planes for each band sample,
// ~270 f32 operations an input sample — ~1.1 GFLOP at K = 40, ~16 us at the
// card's f32 rate, against an 8-byte plane read and a 1.6-byte band write
// an input sample.  Operations bound; the design reads each input sample
// from device memory ~1.17 times (the blocks' overlapping 2,388-sample
// windows) and every tap from shared memory.
#include "front_end.cuh"

static __global__ void rs_resample(const float* __restrict__ hist, int P1,
                                   const float* __restrict__ xr,
                                   const float* __restrict__ xi, long long n,
                                   const float* __restrict__ kc,
                                   float* __restrict__ band, long long nb,
                                   int frames) {
  __shared__ float wr[RS_WIN];
  __shared__ float wi[RS_WIN];
  const int f0 = blockIdx.x * RS_FB;
  const long long base = (long long)RES_M * f0;
  for (int j = threadIdx.x; j < RS_WIN; j += blockDim.x) {
    const long long e = base + j;
    float vr = 0.f, vi = 0.f;
    if (e < P1) {
      vr = hist[2 * e];
      vi = hist[2 * e + 1];
    } else if (e - P1 < n) {
      vr = xr[e - P1];
      vi = xi[e - P1];
    }
    wr[j] = vr;
    wi[j] = vi;
  }
  __syncthreads();
  resample_frames(wr, wi, kc, band, nb, f0, frames);
}

static __global__ void rs_state(const float* __restrict__ hist, int P1,
                                const float* __restrict__ xr,
                                const float* __restrict__ xi, long long n,
                                float* __restrict__ hist_out) {
  hist_tail(blockIdx.x * blockDim.x + threadIdx.x, hist, P1, xr, xi, n,
            hist_out);
}

extern "C" int resample_run(const void* hist, int P1, const void* xr,
                            const void* xi, long long n, const void* kc,
                            void* band, void* hist_out, void* stream) {
  if (n <= 0 || n % RES_M != 0 || P1 != RS_P - 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int frames = (int)(n / RES_M);
  const long long nb = (long long)frames * RES_L;
  rs_resample<<<(frames + RS_FB - 1) / RS_FB, RES_L * RS_FB, 0, s>>>(
      (const float*)hist, P1, (const float*)xr, (const float*)xi, n,
      (const float*)kc, (float*)band, nb, frames);
  SDR_CHECK_LAUNCH();
  rs_state<<<(P1 + 255) / 256, 256, 0, s>>>(
      (const float*)hist, P1, (const float*)xr, (const float*)xi, n,
      (float*)hist_out);
  SDR_CHECK_LAUNCH();
  return 0;
}
