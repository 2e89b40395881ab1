// K1: the scanner front end + channelizer on Hopper.
//
// Replaces sdr_pmr446_tpu/kernels/duo.py::PallasScannerDuo.apply (the TPU
// kernel's bodies _duo_body_pk2 / _duo_body_cs16 / _duo_body_ilv and the
// packed PFB core kernels/pfb_demod.py::_pfb_group_core).  What it computes
// is documented beside its plain PyTorch version, kernels/duo.py.
//
// Six launches on the caller's stream, no allocation (the wrapper passes
// every scratch buffer):
//   1-3. the front end (front_end.cuh, shared with K4 and K6):
//      fe_dc_local<FMT>, dc_carry_kernel and fe_resample — decode, DC
//      blocker, 25/128 resampler;
//   4. duo_tail<FMT>: the carried state (front history, PFB history, DC x/y);
//   5. pfb_filter: the 416-tap complex PFB as 26-tap branch sums, a twiddle
//      and a 16-point DFT, then the (-1)^(parity + frame) mixer flip
//      (pfb_demod.cuh, shared with K7);
//   6. pfb_demod_mag: discriminator (native atan2f) and the per-(sub-chunk,
//      channel) |y| sums as a deterministic block reduction.
// Device memory between launches: the chunk-local DC response [2][n], the
// band planes [2][nb] and the channel planes [2][16][F].
#include "front_end.cuh"
#include "pfb_demod.cuh"

// 4. the front end's carried state (front history, DC x/y) and the new PFB
// history (last 400 of [pfb_hist | band]) in one launch
template <int FMT>
static __global__ void duo_tail(const uint8_t* __restrict__ wire, long long n,
                                float inv_cu8, const float* __restrict__ ylocal,
                                const float* __restrict__ carry,
                                const float* __restrict__ pj, int chunks,
                                const float* __restrict__ fhist_in, int H,
                                float* __restrict__ fhist_out,
                                const float* __restrict__ phist_in,
                                const float* __restrict__ band, long long nb,
                                float* __restrict__ phist_out,
                                float* __restrict__ dc_x_out,
                                float* __restrict__ dc_y_out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  front_state<FMT>(j, wire, n, inv_cu8, ylocal, carry, pj, chunks, fhist_in,
                   H, fhist_out, dc_x_out, dc_y_out);
  hist_tail(j, phist_in, PFB_HIST, band, band + nb, nb, phist_out);
}

template <int FMT>
static int duo_launch(const uint8_t* wire, long long n, const float* dc_x,
                      const float* dc_y, const float* fhist, int H,
                      const float* phist, const int* parity, const float* prev,
                      const float* kt, const float* pg, const float* pc,
                      const float* pw, const float* pj, double p, double g,
                      double pL, float inv_cu8, float dscale, int K, int ns,
                      float* ylocal, float* yend, float* carry, float* band,
                      float* chan, float* dc_x_out, float* dc_y_out,
                      float* fhist_out, float* phist_out, float* demod,
                      float* mag, float* prev_out, cudaStream_t s) {
  const int chunks = (int)((n + DC_L - 1) / DC_L);
  const int res_frames = (int)(n / RES_M);
  const long long nb = (long long)res_frames * RES_L;
  const int fe = front_end_launch<FMT>(wire, n, dc_x, dc_y, fhist, H, kt, pj,
                                      p, g, pL, inv_cu8, ylocal, yend, carry,
                                      band, s);
  if (fe != 0) return fe;
  const int tail = H > PFB_HIST ? H : PFB_HIST;
  duo_tail<FMT><<<(tail + 255) / 256, 256, 0, s>>>(
      wire, n, inv_cu8, ylocal, carry, pj, chunks, fhist, H, fhist_out, phist,
      band, nb, phist_out, dc_x_out, dc_y_out);
  SDR_CHECK_LAUNCH();
  return pfb_demod_launch(band, nb, phist, parity, prev, pg, pc, pw, dscale,
                          K, ns, chan, demod, mag, prev_out, s);
}

extern "C" int duo_run(int fmt, const void* wire, long long n,
                       const void* dc_x, const void* dc_y, const void* fhist,
                       int H, const void* phist, const void* parity,
                       const void* prev, const void* kt, const void* pg,
                       const void* pc, const void* pw, const void* pj,
                       double p, double g, double pL, float inv_cu8,
                       float dscale, int K, int ns,
                       void* ylocal, void* yend, void* carry, void* band,
                       void* chan, void* dc_x_out, void* dc_y_out,
                       void* fhist_out, void* phist_out, void* demod,
                       void* mag, void* prev_out, void* stream) {
  if (n <= 0 || n % (RES_M * NCH) != 0 || H < RS_P - 1 || K <= 0 ||
      (long long)K * ns * NCH * RES_M != n * RES_L)
    return (int)cudaErrorInvalidValue;
#define SDR_DUO_ARGS                                                        \
  (const uint8_t*)wire, n, (const float*)dc_x, (const float*)dc_y,          \
      (const float*)fhist, H, (const float*)phist, (const int*)parity,      \
      (const float*)prev, (const float*)kt, (const float*)pg,               \
      (const float*)pc, (const float*)pw, (const float*)pj, p, g, pL,       \
      inv_cu8, dscale, K, ns, (float*)ylocal, (float*)yend,                 \
      (float*)carry, (float*)band, (float*)chan, (float*)dc_x_out,          \
      (float*)dc_y_out, (float*)fhist_out, (float*)phist_out,               \
      (float*)demod, (float*)mag, (float*)prev_out, (cudaStream_t)stream
  switch (fmt) {
    case FMT_CU8: return duo_launch<FMT_CU8>(SDR_DUO_ARGS);
    case FMT_CS8: return duo_launch<FMT_CS8>(SDR_DUO_ARGS);
    case FMT_CS16: return duo_launch<FMT_CS16>(SDR_DUO_ARGS);
    case FMT_CF32: return duo_launch<FMT_CF32>(SDR_DUO_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef SDR_DUO_ARGS
}

extern "C" const char* sdr_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
