// K6: the scanner front end alone on Hopper — wire decode, IQ DC blocker,
// 25/128 resampler to the 200 kHz band.
//
// Replaces sdr_pmr446_tpu/kernels/front_end.py::PallasFrontEnd (_call,
// _call_group and _call_wide, behind apply_packed2 / apply_packed /
// apply_interleaved / apply_iq / apply_planes).  What it computes is
// documented beside its plain PyTorch version, kernels/front_end.py.
//
// Four launches on the caller's stream, no allocation: the three of
// front_end_launch (front_end.cuh, shared with K1 and K4) and fe_state for
// the carried state.  The band planes [2][nb] are the output; the JAX row
// layout [T/128, 25] and group layout [G, 400] are both views of them.
// What bounds it on the H100: ~280 f32 operations an input sample (the
// 346-tap resampler on two planes, 25 outputs per 128 inputs, and the DC
// blocker) against a 2-8 byte read and a 1.6 byte band write — operations
// bound, ~17 us at K = 40 cu8.  The design keeps the resampler's inputs in
// shared memory: each block loads its 8,538-sample window once (1.04x the
// 8,192 samples it consumes) and the staged taps, and runs the resampler
// as a register-tiled product over them (front_end.cuh).  The chunk-local
// DC response still goes through device memory between launches; fusing
// them is later work.
#include "front_end.cuh"

// 4. front_hist', dc_x', dc_y'
template <int FMT>
static __global__ void fe_state(const uint8_t* __restrict__ wire, long long n,
                                float inv_cu8, const float* __restrict__ ylocal,
                                const float* __restrict__ carry,
                                const float* __restrict__ pj, int chunks,
                                const float* __restrict__ fhist_in, int H,
                                float* __restrict__ fhist_out,
                                float* __restrict__ dc_x_out,
                                float* __restrict__ dc_y_out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  front_state<FMT>(j, wire, n, inv_cu8, ylocal, carry, pj, chunks, fhist_in,
                   H, fhist_out, dc_x_out, dc_y_out);
}

template <int FMT>
static int fe_launch(const uint8_t* wire, long long n, const float* dc_x,
                     const float* dc_y, const float* fhist, int H,
                     const float* kt, const float* pj, double p, double g,
                     double pL, float inv_cu8, float* ylocal, float* yend,
                     float* carry, float* band,
                     float* dc_x_out, float* dc_y_out, float* fhist_out,
                     cudaStream_t s) {
  const int chunks = (int)((n + DC_L - 1) / DC_L);
  const int fe = front_end_launch<FMT>(wire, n, dc_x, dc_y, fhist, H, kt, pj,
                                       p, g, pL, inv_cu8, ylocal, yend,
                                       carry, band, s);
  if (fe != 0) return fe;
  fe_state<FMT><<<(H + 255) / 256, 256, 0, s>>>(
      wire, n, inv_cu8, ylocal, carry, pj, chunks, fhist, H, fhist_out,
      dc_x_out, dc_y_out);
  SDR_CHECK_LAUNCH();
  return 0;
}

extern "C" int fe_run(int fmt, const void* wire, long long n, const void* dc_x,
                      const void* dc_y, const void* fhist, int H,
                      const void* kt, const void* pj, double p, double g,
                      double pL, float inv_cu8, void* ylocal, void* yend,
                      void* carry, void* band,
                      void* dc_x_out, void* dc_y_out, void* fhist_out,
                      void* stream) {
  if (n <= 0 || n % RES_M != 0 || H < RS_P - 1)
    return (int)cudaErrorInvalidValue;
#define SDR_FE_ARGS                                                          \
  (const uint8_t*)wire, n, (const float*)dc_x, (const float*)dc_y,          \
      (const float*)fhist, H, (const float*)kt, (const float*)pj, p, g, pL, \
      inv_cu8, (float*)ylocal, (float*)yend, (float*)carry,                 \
      (float*)band, (float*)dc_x_out, (float*)dc_y_out, (float*)fhist_out,  \
      (cudaStream_t)stream
  switch (fmt) {
    case FMT_CU8: return fe_launch<FMT_CU8>(SDR_FE_ARGS);
    case FMT_CS8: return fe_launch<FMT_CS8>(SDR_FE_ARGS);
    case FMT_CS16: return fe_launch<FMT_CS16>(SDR_FE_ARGS);
    case FMT_CF32: return fe_launch<FMT_CF32>(SDR_FE_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef SDR_FE_ARGS
}
