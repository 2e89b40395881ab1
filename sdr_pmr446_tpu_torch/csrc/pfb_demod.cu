// K7: the 16-channel PFB + NBFM discriminator alone on Hopper.
//
// Replaces sdr_pmr446_tpu/kernels/pfb_demod.py::PallasPfbDemod (call_planes,
// call_planes_rssi, call_group and _call_group_packed).  What it computes
// is documented beside its plain PyTorch version, kernels/pfb_demod.py.
//
// Three launches on the caller's stream, no allocation: pfb_state (the
// carried band history), pfb_filter (the PFB into the channel planes) and
// pfb_demod_mag (|y| sums a sub-chunk) or pfb_demod_plane (the |y| plane),
// all in pfb_demod.cuh, shared with K1.  What bounds it on the H100: per
// frame the filterbank counted as 416 complex taps plus a 16-point FFT and
// the mixer (~2,100 f32 operations) and per channel sample an atan2 and
// |y| — ~0.14 GFLOP at K = 40, against a 6.3 MB band read and a 3.1 MB
// demod write: bytes bound at ~3 us.  The design loads each block's window
// of 16 frames (656 band samples for 256 new ones) into shared memory once
// and reads the taps through the read-only cache; the channel planes go
// through device memory between launches.
#include "pfb_demod.cuh"

extern "C" int pfb_demod_run(const void* band, long long nb, const void* phist,
                             const void* parity, const void* prev,
                             const void* ck_re, const void* ck_im,
                             float dscale, int K, int ns, void* chan,
                             void* phist_out, void* demod, void* mag,
                             void* prev_out, void* stream) {
  if (nb <= 0 || nb % NCH != 0 || K < 0 ||
      (K > 0 && (long long)K * ns * NCH != nb))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  pfb_state<<<(PFB_HIST + 255) / 256, 256, 0, s>>>(
      (const float*)phist, (const float*)band, nb, (float*)phist_out);
  SDR_CHECK_LAUNCH();
  return pfb_demod_launch((const float*)band, nb, (const float*)phist,
                          (const int*)parity, (const float*)prev,
                          (const float*)ck_re, (const float*)ck_im, dscale, K,
                          ns, (float*)chan, (float*)demod, (float*)mag,
                          (float*)prev_out, s);
}
