// K3: the waterfall's hop-PSD spectrogram on Hopper.
//
// Replaces sdr_pmr446_tpu/kernels/duo.py::_wf_epilogue (the in-kernel hop
// PSD of PallasScannerDuo.apply, waterfall_w > 0) and, for the widths and K
// the JAX duo cannot serve in-kernel, the XLA asgram_rows_any_p it falls
// back to.  What it computes is documented beside its plain PyTorch version,
// ops/spectrogram.py::asgram_rows_any_p: hop i fires at band sample
// u_i = (w/4 - cnt) + i*w/4 (1-based) while u_i <= nb; its window is the
// w/2 samples of xe = [hist | band] that end at u_i; |S|^2 of the windowed,
// zero-padded w-point DFT is summed into row (u_i - 1) / sub; each row is the
// dB average over its hops, fftshifted.
//
// Two launches on the caller's stream, no atomics (deterministic run to
// run), no allocation:
//   1. wf_partials: one block per (slab of consecutive hops, row).  Each
//      thread owns one frequency bin of one hop group (bins across threads,
//      hops strided by the group count) and accumulates |S|^2 of its hops in
//      a register as a direct DFT: the windows are read straight from the
//      history and the band planes through the read-only cache, the
//      window x DFT table [w/2][w] (float64 on the host, rounded once) with
//      __ldg.  Each hop's w/2-term DFT sums and the |S|^2 sum over hops
//      accumulate in double: in f32 the rounding of 4096 sequential terms
//      (w = 8192) swamped the weakest bins past the 2e-3 dB gate, while an
//      f32 product is exact in double and the card's double rate is half
//      its f32 rate, far above what the table reads allow.  The groups'
//      sums are added in a fixed order and written as partials
//      [rows][slabs][w].
//   2. wf_rows: one block per row adds its slabs in order, divides by the
//      row's hop count (computed from cnt, like the hop positions), takes
//      10*log10(max(p, 1e-30)) and writes the row fftshifted.  Block 0 also
//      writes the new history (the last w/2 of [hist | band]) and the new
//      counter (cnt + nb) mod (w/4).
// The counter is read on the device, so a step makes no host read; every
// width validate_width accepts runs at every K (no shared-memory span, so
// no width needs a tiled variant) as far as the w*w*4-byte table fits in
// device memory.
//
// What bounds it on the H100: the function needs the band read once (8 B a
// sample) and, as an FFT, 5 w log2(w) operations a hop: bytes first.  The
// direct DFT does (w/2)*w complex multiply-adds a hop, ~10x an FFT's work at
// w = 80, so this first version is bound by its own operations; an FFT in
// shared memory and fusing into K1's PFB launch are later work.
#include "sdr_common.cuh"

#define WF_THREADS 256  // block size of both launches (kernels/waterfall.py)
#define WF_HOPS 16      // hops per thread and slab (kernels/waterfall.py)

// The first hop's band sample u0 = delay - cnt, in [1, delay]: the counter is
// carried state (a loaded checkpoint included), taken modulo the hop so that
// no value of it reads outside [hist | band].
static __device__ __forceinline__ long long first_fire(const int* cnt,
                                                       int delay) {
  return delay - ((cnt[0] % delay) + delay) % delay;
}

// First and last hop (inclusive) that fire inside row r: u in [r*sub + 1,
// (r + 1)*sub], u = u0 + i*delay, 1 <= u0 <= delay.
static __device__ __forceinline__ void row_hops(long long r, long long sub,
                                                long long u0, long long delay,
                                                long long* lo, long long* hi) {
  const long long first = r * sub + 1 - u0;
  *lo = first <= 0 ? 0 : (first + delay - 1) / delay;
  *hi = ((r + 1) * sub - u0) / delay;
}

// 1. partial |S|^2 sums of one slab of one row's hops
static __global__ void wf_partials(const float* __restrict__ band,
                                   long long nb,
                                   const float2* __restrict__ hist,
                                   int hist_len, const int* __restrict__ cnt,
                                   const float2* __restrict__ tab, int w,
                                   int sub, int groups, int slab_hops,
                                   float* __restrict__ part) {
  extern __shared__ float red[];  // [groups][w], used when groups > 1
  const int wl = w / 2, delay = w / 4;
  const int row = blockIdx.y, slab = blockIdx.x;
  const long long u0 = first_fire(cnt, delay);
  long long lo, hi;
  row_hops(row, sub, u0, delay, &lo, &hi);
  const long long a = lo + (long long)slab * slab_hops;
  const long long b = min(a + slab_hops, hi + 1);
  const int nh = b > a ? (int)(b - a) : 0;
  const float2* hs = hist + (hist_len - wl);  // xe[e] = hs[e] for e < wl
  const float* br = band;                     // xe[e] = band[e - wl] else
  const float* bi = band + nb;
  float* out = part + ((long long)row * gridDim.x + slab) * w;
  for (int item = threadIdx.x; item < groups * w; item += blockDim.x) {
    const int g = item / w;
    const int f = item - g * w;
    double acc = 0.0;
    for (int h = g; h < nh; h += groups) {
      const long long u = u0 + (a + h) * delay;  // window xe[u, u + wl)
      const int jh = u >= wl ? 0 : (int)(wl - u);
      double sr = 0.0, si = 0.0;
      for (int j = 0; j < jh; ++j) {
        const float2 x = hs[u + j];
        const float2 t = __ldg(tab + (long long)j * w + f);
        sr += (double)x.x * t.x - (double)x.y * t.y;
        si += (double)x.x * t.y + (double)x.y * t.x;
      }
      const long long e0 = u - wl;
      for (int j = jh; j < wl; ++j) {
        const double xr = __ldg(br + e0 + j);
        const double xi = __ldg(bi + e0 + j);
        const float2 t = __ldg(tab + (long long)j * w + f);
        sr += xr * t.x - xi * t.y;
        si += xr * t.y + xi * t.x;
      }
      acc += sr * sr + si * si;
    }
    if (groups == 1)
      out[f] = (float)acc;
    else
      red[item] = (float)acc;
  }
  if (groups > 1) {
    __syncthreads();
    for (int f = threadIdx.x; f < w; f += blockDim.x) {
      float s = 0.f;
      for (int g = 0; g < groups; ++g) s += red[g * w + f];
      out[f] = s;
    }
  }
}

// 2. rows in dB, fftshifted; block 0 writes the carried state
static __global__ void wf_rows(const float* __restrict__ part, int slabs,
                               const float* __restrict__ band, long long nb,
                               const float2* __restrict__ hist, int hist_len,
                               const int* __restrict__ cnt, int w, int sub,
                               float* __restrict__ rows,
                               float2* __restrict__ hist_out,
                               int* __restrict__ cnt_out) {
  const int wl = w / 2, delay = w / 4;
  const int row = blockIdx.x;
  const long long u0 = first_fire(cnt, delay);
  long long lo, hi;
  row_hops(row, sub, u0, delay, &lo, &hi);
  const float n_row = (float)(hi - lo + 1);
  const float* p = part + (long long)row * slabs * w;
  for (int f = threadIdx.x; f < w; f += blockDim.x) {
    float s = 0.f;
    for (int sl = 0; sl < slabs; ++sl) s += p[(long long)sl * w + f];
    const float avg = s / n_row;
    rows[(long long)row * w + (f + wl) % w] = 10.f * log10f(fmaxf(avg, 1e-30f));
  }
  if (row != 0) return;
  const float2* hs = hist + (hist_len - wl);
  for (int m = threadIdx.x; m < wl; m += blockDim.x) {
    const long long e = nb + m;  // index into xe = [hist (wl) | band (nb)]
    hist_out[m] = e < wl ? hs[e]
                         : make_float2(band[e - wl], band[nb + e - wl]);
  }
  if (threadIdx.x == 0) cnt_out[0] = (int)((delay - u0 + nb) % delay);
}

extern "C" int wf_run(const void* band, long long nb, const void* hist,
                      int hist_len, const void* cnt, const void* tab, int w,
                      int K, int sub, int slab_hops, int slabs, void* part,
                      void* rows, void* hist_out, void* cnt_out,
                      void* stream) {
  const int groups = w < WF_THREADS ? WF_THREADS / w : 1;
  if (w < 8 || w % 4 != 0 || w / 4 > sub || K <= 0 || nb != (long long)K * sub ||
      hist_len < w / 2 || slab_hops != groups * WF_HOPS || slabs <= 0 ||
      (long long)slabs * slab_hops < sub / (w / 4) + 1 || K > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = groups > 1 ? (size_t)groups * w * sizeof(float) : 0;
  wf_partials<<<dim3(slabs, K), WF_THREADS, smem, s>>>(
      (const float*)band, nb, (const float2*)hist, hist_len, (const int*)cnt,
      (const float2*)tab, w, sub, groups, slab_hops, (float*)part);
  SDR_CHECK_LAUNCH();
  wf_rows<<<K, WF_THREADS, 0, s>>>(
      (const float*)part, slabs, (const float*)band, nb, (const float2*)hist,
      hist_len, (const int*)cnt, w, sub, (float*)rows, (float2*)hist_out,
      (int*)cnt_out);
  SDR_CHECK_LAUNCH();
  return 0;
}
