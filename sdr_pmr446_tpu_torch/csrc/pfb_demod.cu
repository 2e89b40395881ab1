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
// frame the filterbank as 16 branch sums of 26 real taps, the 16 branch
// twiddles and a 16-point FFT (~2,100 f32 operations) and per channel
// sample an atan2 and |y| — ~0.14 GFLOP at K = 40, against a 6.3 MB band
// read and a 3.1 MB demod write: bytes bound at ~3 us.  The design runs the
// filterbank in that factored form (pfb_demod.cuh): each block loads its
// window of 64 frames (1,424 band samples for 1,024 new ones) into shared
// memory once, each thread holds its branch's 26 taps in registers and
// slides them over 4 frames, the DFT runs in shuffles, and the channel
// planes go out in coalesced rows and through device memory between
// launches.
#include "pfb_demod.cuh"

extern "C" int pfb_demod_run(const void* band, long long nb, const void* phist,
                             const void* parity, const void* prev,
                             const void* pg, const void* pc, const void* pw,
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
                          (const float*)pg, (const float*)pc,
                          (const float*)pw, dscale, K,
                          ns, (float*)chan, (float*)demod, (float*)mag,
                          (float*)prev_out, s);
}
