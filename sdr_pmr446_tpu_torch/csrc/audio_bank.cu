// K2 and K8: the audio filter bank, the lp DC blocker and the CTCSS DFT on
// Hopper.
//
// K2 replaces sdr_pmr446_tpu/kernels/audio_bank.py::PallasAudioBank.
// apply_dc_ctcss (TPU body _body_dc_ctcss, tables _ctcss_dft_consts /
// _kernel_matrix); K8 replaces PallasAudioBank.apply (body _body) and
// apply_dc (body _body_dc), the same bank without the CTCSS epilogue.  What
// they compute is documented beside their plain PyTorch versions,
// kernels/audio_bank.py.
//
// The launches, all on the caller's stream, none allocating:
//   1. ab_fir: the composed audio and lp FIRs, one thread per (channel,
//      sample) over a shared-memory window of [hist | demod]; the gain is
//      read on the device;
//   2. ab_dc_local: zero-state lp DC response per chunk, 16 rows;
//   3. dc_carry_kernel: chunk carries (sdr_common.cuh);
//   4. ab_ctcss (K2): one block per (sub-chunk k, tone t) over channel
//      sel[k], the DC fix-up fused into the load; the tone phase is reduced
//      exactly in integers (10 f_t p mod 125000) and evaluated with
//      sincospif, so no f32 argument of thousands of radians ever reaches a
//      sine;
//      ab_dc_plane (K8 apply_dc): the DC-blocked lp plane, the fix-up of
//      every sample;
//   5. ab_tail: the new demod history and the lp DC blocker carries.
// Entry points: audio_bank_run (K2: 1-5), audio_bank_apply (K8 apply: 1
// and the history part of 5) and audio_bank_apply_dc (K8 apply_dc: 1-3,
// ab_dc_plane, 5).  Device memory between launches: lp and its chunk-local
// DC response.
#include "sdr_common.cuh"

#define AB_TILE 256            // output samples per FIR block
#define MAX_TAPS 640           // longest composed FIR (kernels/audio_bank.py)
#define NTONES 38
#define PHASE_PERIOD 125000    // 10 * audio rate: tone phase period in 0.1 Hz

// 1. audio[c][n] = gain * sum_m ta[m] xe[c][n + H - m]; lp likewise with tl
static __global__ void ab_fir(const float* __restrict__ demod, int F,
                              const float* __restrict__ hist, int H,
                              const float* __restrict__ ta, int La,
                              const float* __restrict__ tl, int Ll,
                              const float* __restrict__ gain,
                              float* __restrict__ audio,
                              float* __restrict__ lp) {
  __shared__ float win[AB_TILE + MAX_TAPS - 1];
  __shared__ float sa[MAX_TAPS];
  __shared__ float sl[MAX_TAPS];
  const int c = blockIdx.y;
  const int n0 = blockIdx.x * AB_TILE;
  const int lw = La > Ll ? La : Ll;
  const long long s0 = (long long)n0 + H - (lw - 1);
  const float* hrow = hist + (long long)c * H;
  const float* drow = demod + (long long)c * F;
  for (int j = threadIdx.x; j < AB_TILE + lw - 1; j += blockDim.x) {
    const long long e = s0 + j;
    float v = 0.f;
    if (e < H)
      v = hrow[e];
    else if (e - H < F)
      v = drow[e - H];
    win[j] = v;
  }
  for (int j = threadIdx.x; j < La; j += blockDim.x) sa[j] = ta[j];
  for (int j = threadIdx.x; j < Ll; j += blockDim.x) sl[j] = tl[j];
  __syncthreads();
  const int n = n0 + threadIdx.x;
  if (n >= F) return;
  const int b = threadIdx.x + lw - 1;
  float a = 0.f, l = 0.f;
  for (int m = 0; m < La; ++m) a += sa[m] * win[b - m];
  for (int m = 0; m < Ll; ++m) l += sl[m] * win[b - m];
  audio[(long long)c * F + n] = a * gain[0];
  lp[(long long)c * F + n] = l;
}

// 2. one thread per (DC_L chunk, channel row)
static __global__ void ab_dc_local(const float* __restrict__ lp, int F,
                                   const float* __restrict__ dc_x, double p,
                                   double g, float* __restrict__ lplocal,
                                   float* __restrict__ yend, int chunks) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y;
  if (c >= chunks) return;
  const float* x = lp + (long long)r * F;
  float* out = lplocal + (long long)r * F;
  const int n0 = c * DC_L;
  const int n1 = min(n0 + DC_L, F);
  float xp = (n0 == 0) ? dc_x[r] : x[n0 - 1];
  double y = 0.0;
  for (int i = n0; i < n1; ++i) {
    const float xv = x[i];
    y = p * y + g * ((double)xv - (double)xp);
    out[i] = (float)y;
    xp = xv;
  }
  yend[(long long)r * chunks + c] = (float)y;
}

// 4. raw_mem[k][t] = sum_{i<ns} lpdc[sel k][k ns + i] e^{-j w_t (k ns + i)};
//    raw_pre the same over i <= b[k]; complex64 outputs [K][38]
static __global__ void ab_ctcss(const float* __restrict__ lplocal,
                                const float* __restrict__ carry,
                                const float* __restrict__ pj, int F,
                                int chunks, int ns,
                                const int* __restrict__ b_arr,
                                const int* __restrict__ sel,
                                const int* __restrict__ f10,
                                float* __restrict__ raw_pre,
                                float* __restrict__ raw_mem) {
  __shared__ float sh[RED_THREADS];
  const int kk = blockIdx.x;
  const int t = blockIdx.y;
  const int c = min(max(sel[kk], 0), NCH - 1);
  const int b = b_arr[kk];
  const long long ft = f10[t];
  const float* yl = lplocal + (long long)c * F;
  const float* cr = carry + (long long)c * chunks;
  float pr = 0.f, pi = 0.f, mr = 0.f, mi = 0.f;
  for (int i = threadIdx.x; i < ns; i += blockDim.x) {
    const long long n = (long long)kk * ns + i;
    const float v = dc_fix(yl, cr, pj, n);
    const int r = (int)((ft * n) % PHASE_PERIOD);
    float sv, cv;
    sincospif((float)r / (0.5f * PHASE_PERIOD), &sv, &cv);
    const float er = v * cv;
    const float ei = -v * sv;
    mr += er;
    mi += ei;
    if (i <= b) {
      pr += er;
      pi += ei;
    }
  }
  pr = block_sum(pr, sh);
  pi = block_sum(pi, sh);
  mr = block_sum(mr, sh);
  mi = block_sum(mi, sh);
  if (threadIdx.x == 0) {
    const int o = 2 * (kk * NTONES + t);
    raw_pre[o] = pr;
    raw_pre[o + 1] = pi;
    raw_mem[o] = mr;
    raw_mem[o + 1] = mi;
  }
}

// 4'. lp_dcb[c][n] = the DC-blocked lp, one thread per (channel, sample)
static __global__ void ab_dc_plane(const float* __restrict__ lplocal,
                                   const float* __restrict__ carry,
                                   const float* __restrict__ pj, int F,
                                   int chunks, float* __restrict__ lp_dcb) {
  const int c = blockIdx.y;
  const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= F) return;
  lp_dcb[(long long)c * F + n] = dc_fix(lplocal + (long long)c * F,
                                        carry + (long long)c * chunks, pj, n);
}

// 5. new history = last H of [hist | demod]; lp DC blocker x[-1], y[-1]
//    unless dc_x_out is null (K8 apply, which has no DC blocker)
static __global__ void ab_tail(const float* __restrict__ hist, int H,
                               const float* __restrict__ demod, int F,
                               const float* __restrict__ lp,
                               const float* __restrict__ lplocal,
                               const float* __restrict__ carry,
                               const float* __restrict__ pj, int chunks,
                               float* __restrict__ hist_out,
                               float* __restrict__ dc_x_out,
                               float* __restrict__ dc_y_out) {
  const int c = blockIdx.x;
  for (int j = threadIdx.x; j < H; j += blockDim.x) {
    const long long e = (long long)F + j;
    hist_out[(long long)c * H + j] =
        e < H ? hist[(long long)c * H + e] : demod[(long long)c * F + e - H];
  }
  if (threadIdx.x == 0 && dc_x_out != nullptr) {
    const long long m = F - 1;
    dc_x_out[c] = lp[(long long)c * F + m];
    dc_y_out[c] = dc_fix(lplocal + (long long)c * F,
                         carry + (long long)c * chunks, pj, m);
  }
}

static bool ab_bad_args(int F, int H, int La, int Ll) {
  return F <= 0 || La <= 0 || Ll <= 0 || La > MAX_TAPS || Ll > MAX_TAPS ||
         La > H || Ll > H;
}

// Launches 1-3: audio, lp, lp's chunk-local DC response and chunk carries.
static int ab_fir_dc(const void* demod, int F, const void* hist, int H,
                     const void* dc_x, const void* dc_y, const void* gain,
                     const void* ta, int La, const void* tl, int Ll, double p,
                     double g, double pL, void* lp, void* lplocal, void* yend,
                     void* carry, void* audio, cudaStream_t s) {
  const int chunks = (F + DC_L - 1) / DC_L;
  ab_fir<<<dim3((F + AB_TILE - 1) / AB_TILE, NCH), AB_TILE, 0, s>>>(
      (const float*)demod, F, (const float*)hist, H, (const float*)ta, La,
      (const float*)tl, Ll, (const float*)gain, (float*)audio, (float*)lp);
  SDR_CHECK_LAUNCH();
  ab_dc_local<<<dim3((chunks + 255) / 256, NCH), 256, 0, s>>>(
      (const float*)lp, F, (const float*)dc_x, p, g, (float*)lplocal,
      (float*)yend, chunks);
  SDR_CHECK_LAUNCH();
  dc_carry_kernel<<<NCH, CARRY_THREADS, 0, s>>>(
      (const float*)yend, (float*)carry, (const float*)dc_y, chunks, pL);
  SDR_CHECK_LAUNCH();
  return 0;
}

extern "C" int audio_bank_run(const void* demod, int F, const void* hist,
                              int H, const void* dc_x, const void* dc_y,
                              const void* gain, const void* b_arr,
                              const void* sel, int K, int ns, const void* ta,
                              int La, const void* tl, int Ll, const void* pj,
                              double p, double g, double pL,
                              const void* f10, void* lp, void* lplocal,
                              void* yend, void* carry, void* audio,
                              void* hist_out, void* dc_x_out, void* dc_y_out,
                              void* raw_pre, void* raw_mem, void* stream) {
  if (ab_bad_args(F, H, La, Ll) || K <= 0 || (long long)K * ns != F)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int chunks = (F + DC_L - 1) / DC_L;
  const int e = ab_fir_dc(demod, F, hist, H, dc_x, dc_y, gain, ta, La, tl, Ll,
                          p, g, pL, lp, lplocal, yend, carry, audio, s);
  if (e != 0) return e;
  ab_ctcss<<<dim3(K, NTONES), RED_THREADS, 0, s>>>(
      (const float*)lplocal, (const float*)carry, (const float*)pj, F, chunks,
      ns, (const int*)b_arr, (const int*)sel, (const int*)f10,
      (float*)raw_pre, (float*)raw_mem);
  SDR_CHECK_LAUNCH();
  ab_tail<<<NCH, 256, 0, s>>>((const float*)hist, H, (const float*)demod, F,
                              (const float*)lp, (const float*)lplocal,
                              (const float*)carry, (const float*)pj, chunks,
                              (float*)hist_out, (float*)dc_x_out,
                              (float*)dc_y_out);
  SDR_CHECK_LAUNCH();
  return 0;
}

// K8 apply: audio and the lp branch (no DC blocker), the new history.
extern "C" int audio_bank_apply(const void* demod, int F, const void* hist,
                                int H, const void* gain, const void* ta,
                                int La, const void* tl, int Ll, void* lp,
                                void* audio, void* hist_out, void* stream) {
  if (ab_bad_args(F, H, La, Ll)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  ab_fir<<<dim3((F + AB_TILE - 1) / AB_TILE, NCH), AB_TILE, 0, s>>>(
      (const float*)demod, F, (const float*)hist, H, (const float*)ta, La,
      (const float*)tl, Ll, (const float*)gain, (float*)audio, (float*)lp);
  SDR_CHECK_LAUNCH();
  ab_tail<<<NCH, 256, 0, s>>>((const float*)hist, H, (const float*)demod, F,
                              nullptr, nullptr, nullptr, nullptr, 0,
                              (float*)hist_out, nullptr, nullptr);
  SDR_CHECK_LAUNCH();
  return 0;
}

// K8 apply_dc: audio, the DC-blocked lp plane, the history and carries.
extern "C" int audio_bank_apply_dc(const void* demod, int F, const void* hist,
                                   int H, const void* dc_x, const void* dc_y,
                                   const void* gain, const void* ta, int La,
                                   const void* tl, int Ll, const void* pj,
                                   double p, double g, double pL, void* lp,
                                   void* lplocal, void* yend, void* carry,
                                   void* audio,
                                   void* hist_out, void* dc_x_out,
                                   void* dc_y_out, void* lp_dcb,
                                   void* stream) {
  if (ab_bad_args(F, H, La, Ll)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int chunks = (F + DC_L - 1) / DC_L;
  const int e = ab_fir_dc(demod, F, hist, H, dc_x, dc_y, gain, ta, La, tl, Ll,
                          p, g, pL, lp, lplocal, yend, carry, audio, s);
  if (e != 0) return e;
  ab_dc_plane<<<dim3((F + 255) / 256, NCH), 256, 0, s>>>(
      (const float*)lplocal, (const float*)carry, (const float*)pj, F, chunks,
      (float*)lp_dcb);
  SDR_CHECK_LAUNCH();
  ab_tail<<<NCH, 256, 0, s>>>((const float*)hist, H, (const float*)demod, F,
                              (const float*)lp, (const float*)lplocal,
                              (const float*)carry, (const float*)pj, chunks,
                              (float*)hist_out, (float*)dc_x_out,
                              (float*)dc_y_out);
  SDR_CHECK_LAUNCH();
  return 0;
}
