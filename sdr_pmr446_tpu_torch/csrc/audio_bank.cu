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
//   1. ab_fir<DC>: the composed audio and lp FIRs over one shared-memory
//      window of [hist | demod] (the gain read on the device); with DC, its
//      epilogue runs the lp DC blocker's zero-state response per DC_L chunk
//      of its tile and writes that (lplocal), the chunk ends and lp[F - 1],
//      never the lp plane; without (K8 apply) it writes the lp plane;
//   2. dc_carry_kernel: chunk carries (sdr_common.cuh);
//   3. ab_ctcss (K2): one block per (sub-chunk k, 4 tones) over channel
//      sel[k], the DC-fixed samples staged once in shared memory, 4 warps
//      a tone; the tone phase is exact in integers ((10 f_t p) mod 125000,
//      stepped by a 32-bit add) and evaluated with sincospif on a
//      fraction of pi below 1 in magnitude, so no f32 argument of
//      thousands of radians ever reaches a sine;
//      ab_dc_plane (K8 apply_dc): the DC-blocked lp plane, the fix-up of
//      every sample;
//   4. ab_tail: the new demod history and the lp DC blocker carries.
// Entry points: audio_bank_run (K2: 1-4), audio_bank_apply (K8 apply: 1
// and the history part of 4) and audio_bank_apply_dc (K8 apply_dc: 1, 2,
// ab_dc_plane, 4).  Device memory between launches: the chunk-local lp DC
// response (or K8 apply's lp plane), its chunk ends, lp[F - 1].
//
// What bounds it: the FIRs, ~800 multiply-adds per channel sample (0.63 G
// at K = 40, 0.0188 ms at the f32 peak); everything else moves ~10 bytes a
// channel sample.  ab_fir is a register-tiled product: a block takes one
// channel row and AB_TILE outputs, a thread AB_R consecutive ones, and
// keeps AB_R audio and AB_R lp sums and a sliding window of 16 samples in
// registers.  The taps are staged reversed and zero-padded
// (kernels/audio_bank.py::staged_taps): region A, the PA audio taps beyond
// the lp FIR's reach, then region B, PB taps of both FIRs interleaved four
// and four; PA and PB are multiples of AB_G = 16 (four groups of 4 taps, the
// window's register rotation).  Per group of 4 taps a thread makes one
// float4 window load and one (region A) or two (B) broadcast float4 tap
// loads for 4 AB_R (A) or 8 AB_R (B) FFMAs: 16 or 21 FFMAs per shared load.
// The window is rows of AB_R samples padded to AB_ROW words, so the float4
// loads of 8 threads a quarter-warp fall on 32 distinct banks.  Each
// output's sums run over the taps in one fixed order, so a call is
// bit-equal to itself, and K8's audio to K2's (one device function).  True
// f32 FFMA: no TF32, no tensor cores.
#include "sdr_common.cuh"

#define AB_R 8            // consecutive outputs a thread
#define AB_THREADS 128    // threads of an ab_fir block
#define AB_TILE 1024      // outputs a block: AB_R x AB_THREADS, 16 DC_L chunks
#define AB_G 16           // staged tap regions padded to whole AB_G
#define AB_ROW 12         // shared words of a row of AB_R window samples
#define MAX_TAPS 640      // longest composed audio FIR (kernels/audio_bank.py)
#define AB_QMAX 672       // longest padded span PA + PB (MAX_TAPS + 2 AB_G)
#define AB_TAB 1344       // staged table floats: PA + 2 PB <= 2 AB_QMAX
#define AB_WIN_ROWS 213   // window rows: AB_TILE + AB_QMAX + 4 samples
#define AB_OUT_WORDS 1536 // an output tile: AB_THREADS rows of AB_ROW words
#define NTONES 38
#define CT_TONES 4        // tones an ab_ctcss block
#define CT_SPLIT 4        // warps a tone, each on every CT_SPLIT-th 32 samples
#define CT_THREADS (CT_TONES * CT_SPLIT * 32)
#define CT_NS_MAX 2048    // longest sub-chunk ab_ctcss stages
#define PHASE_PERIOD 125000  // 10 * audio rate: tone phase period in 0.1 Hz

static_assert(AB_TILE == AB_R * AB_THREADS && AB_TILE % DC_L == 0,
              "a tile is whole threads and whole DC chunks");
static_assert(AB_R == 8 && AB_ROW % 4 == 0, "float4 rows of 8 samples");
static_assert(AB_QMAX >= MAX_TAPS + 2 * AB_G && AB_TAB >= 2 * AB_QMAX,
              "the padded spans fit");
static_assert(AB_WIN_ROWS * AB_R >= AB_TILE + AB_QMAX + 4, "window rows");
static_assert(AB_OUT_WORDS == AB_THREADS * AB_ROW &&
                  AB_OUT_WORDS <= AB_WIN_ROWS * AB_ROW,
              "an output tile fits in the window's memory");

// Padded region length: n taps to whole AB_G.
static __host__ __device__ __forceinline__ int ab_pad(int n) {
  return (n + AB_G - 1) / AB_G * AB_G;
}

// Shared slot of window (or tile) sample i: rows of AB_R padded to AB_ROW.
static __device__ __forceinline__ int ab_slot(int i) {
  return (i / AB_R) * AB_ROW + i % AB_R;
}

// One group of 4 taps for the thread's AB_R outputs.  x holds window
// samples q .. q + 11 (q the group's first tap) in rotation S: logical
// sample j at x[(4 S + j) % 16].  The group first loads samples q + 12 ..
// q + 15 into logical 12-15 (the slots the previous group freed), then
// runs its FFMAs, tap by tap in order; the next group reads rotation S + 1.
template <int S, bool LP>
static __device__ __forceinline__ void ab_group(float (&x)[16],
                                                float (&a)[AB_R],
                                                float (&l)[AB_R],
                                                const float* wb, int q,
                                                float4 ta, float4 tl) {
  const float4 v = *reinterpret_cast<const float4*>(wb + ab_slot(q + 12));
  constexpr int P = (4 * S + 12) % 16;
  x[P] = v.x;
  x[P + 1] = v.y;
  x[P + 2] = v.z;
  x[P + 3] = v.w;
  const float ka[4] = {ta.x, ta.y, ta.z, ta.w};
  const float kl[4] = {tl.x, tl.y, tl.z, tl.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int r = 0; r < AB_R; ++r) {
      const float w = x[(4 * S + r + i) % 16];
      a[r] = fmaf(ka[i], w, a[r]);
      if (LP) l[r] = fmaf(kl[i], w, l[r]);
    }
}

// 1. audio[c][n] = gain * sum_m ta[m] xe[c][n + H - m]; lp likewise with tl
//    (xe = [hist | demod]).  In staged terms, window sample j of the block
//    is xe[n0 + H - (PA + Ll - 1) + j] and output t of the tile sums
//    TA[q] win[t + q] over q < PA + PB (TL over region B).  With DC the lp
//    tile never leaves the block: its chunk-local DC response goes to
//    ``lp`` (lplocal), chunk ends to yend, lp[F - 1] to lp_last; the first
//    chunk's x[n0 - 1] is dc_x (tile 0) or the lp output n0 - 1, summed
//    here by warp 0 over region B from the same window.
template <bool DC>
static __global__ void __launch_bounds__(AB_THREADS)
ab_fir(const float* __restrict__ demod, int F, const float* __restrict__ hist,
       int H, const float4* __restrict__ tab, int La, int Ll,
       const float* __restrict__ gain, float* __restrict__ audio,
       float* __restrict__ lp, const float* __restrict__ dc_x, double p,
       double g, float* __restrict__ yend, int chunks,
       float* __restrict__ lp_last) {
  __shared__ float4 s_tab[AB_TAB / 4];
  __shared__ __align__(16) float s_win[AB_WIN_ROWS * AB_ROW];
  __shared__ __align__(16) float s_lp[AB_OUT_WORDS];
  __shared__ float s_last[AB_THREADS];
  __shared__ float s_xprev;
  const int c = blockIdx.y;
  const int n0 = blockIdx.x * AB_TILE;
  const int PA = ab_pad(La - Ll), PB = ab_pad(Ll);
  const long long s0 = (long long)n0 + H - (PA + Ll - 1);
  const float* hrow = hist + (long long)c * H;
  const float* drow = demod + (long long)c * F;
  for (int i = threadIdx.x; i < (PA + 2 * PB) / 4; i += AB_THREADS)
    cp_async<16>(s_tab + i, tab + i);
  for (int j = threadIdx.x; j < AB_TILE + PA + PB + 4; j += AB_THREADS) {
    const long long e = s0 + j;
    const float* src = hrow;
    bool in = true;
    if (e >= 0 && e < H)
      src = hrow + e;
    else if (e >= H && e - H < F)
      src = drow + (e - H);
    else
      in = false;  // zero: padding taps, or past the block's end
    cp_async<4>(s_win + ab_slot(j), src, in);
  }
  cp_async_wait_all();
  __syncthreads();

  const int t0 = threadIdx.x * AB_R;
  const float* wb = s_win + threadIdx.x * AB_ROW;  // window sample t0
  float a[AB_R], l[AB_R], x[16];
#pragma unroll
  for (int r = 0; r < AB_R; ++r) a[r] = l[r] = 0.f;
#pragma unroll
  for (int j = 0; j < 12; j += 4) {
    const float4 v = *reinterpret_cast<const float4*>(wb + ab_slot(j));
    x[j] = v.x;
    x[j + 1] = v.y;
    x[j + 2] = v.z;
    x[j + 3] = v.w;
  }
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  int q = 0;
  for (; q < PA; q += AB_G) {  // region A: the audio FIR alone
    const float4* t = s_tab + q / 4;
    ab_group<0, false>(x, a, l, wb, q, t[0], zero);
    ab_group<1, false>(x, a, l, wb, q + 4, t[1], zero);
    ab_group<2, false>(x, a, l, wb, q + 8, t[2], zero);
    ab_group<3, false>(x, a, l, wb, q + 12, t[3], zero);
  }
  for (; q < PA + PB; q += AB_G) {  // region B: both, (audio, lp) a group
    const float4* t = s_tab + PA / 4 + 2 * (q - PA) / 4;
    ab_group<0, true>(x, a, l, wb, q, t[0], t[1]);
    ab_group<1, true>(x, a, l, wb, q + 4, t[2], t[3]);
    ab_group<2, true>(x, a, l, wb, q + 8, t[4], t[5]);
    ab_group<3, true>(x, a, l, wb, q + 12, t[6], t[7]);
  }
  if (DC && threadIdx.x < 32) {  // lp output n0 - 1: window q - 1, region B
    float v = 0.f;
    if (n0 > 0) {
      const float4* tb = s_tab + PA / 4;
      for (int gi = threadIdx.x; gi < PB / 4; gi += 32) {
        const float4 k = tb[2 * gi + 1];
        const int w = PA + 4 * gi - 1;
        v = fmaf(k.x, s_win[ab_slot(w)], v);
        v = fmaf(k.y, s_win[ab_slot(w + 1)], v);
        v = fmaf(k.z, s_win[ab_slot(w + 2)], v);
        v = fmaf(k.w, s_win[ab_slot(w + 3)], v);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, o);
    }
    if (threadIdx.x == 0) s_xprev = n0 > 0 ? v : dc_x[c];
  }
  if (DC) s_last[threadIdx.x] = l[AB_R - 1];
  __syncthreads();  // every thread is done with the window

  // the tiles: audio in the window's memory, lp (or its DC response) in
  // s_lp, a thread's AB_R outputs as two float4 in one row
  float* s_a = s_win;
  const float gn = gain[0];
  const int o = ab_slot(t0);
  reinterpret_cast<float4*>(s_a + o)[0] =
      make_float4(a[0] * gn, a[1] * gn, a[2] * gn, a[3] * gn);
  reinterpret_cast<float4*>(s_a + o)[1] =
      make_float4(a[4] * gn, a[5] * gn, a[6] * gn, a[7] * gn);
  const int nv = min(AB_TILE, F - n0);
  if (DC) {
    // The DC blocker's zero-state response per DC_L chunk, as 8 threads a
    // chunk: each runs its AB_R samples from zero state in double (x[-1]
    // the previous thread's last lp, or x[n0 - 1] for the tile's first),
    // then y = own + p^(j+1) Y, Y the chunk's response just before the
    // thread, from a shuffle scan of the threads' ends over the chunk's 8
    // lanes (multipliers p^(8 d)).
    static_assert(AB_R * 8 == DC_L, "8 threads a DC chunk");
    float xp = threadIdx.x == 0 ? s_xprev : s_last[threadIdx.x - 1];
    double pw[AB_R];  // p^(j+1)
    pw[0] = p;
#pragma unroll
    for (int r = 1; r < AB_R; ++r) pw[r] = pw[r - 1] * p;
    double yl[AB_R], y = 0.0;
#pragma unroll
    for (int r = 0; r < AB_R; ++r) {
      y = p * y + g * ((double)l[r] - (double)xp);
      yl[r] = y;
      xp = l[r];
      if (n0 + t0 + r == F - 1) lp_last[c] = l[r];
    }
    const int u = threadIdx.x % 8;  // the thread's place in its chunk
    double incl = y, m = pw[AB_R - 1];  // p^8, then p^16, p^32
#pragma unroll
    for (int d = 1; d < 8; d <<= 1) {
      const double up = __shfl_up_sync(0xffffffffu, incl, d, 8);
      if (u >= d) incl = fma(m, up, incl);
      m *= m;
    }
    double yin = __shfl_up_sync(0xffffffffu, incl, 1, 8);
    if (u == 0) yin = 0.0;
    float out[AB_R];
#pragma unroll
    for (int r = 0; r < AB_R; ++r) {
      const double v = fma(pw[r], yin, yl[r]);
      out[r] = (float)v;
      // the chunk's end: its last sample, or the block's last
      if (t0 + r < nv && ((t0 + r) % DC_L == DC_L - 1 || t0 + r == nv - 1))
        yend[(long long)c * chunks + (n0 + t0 + r) / DC_L] = out[r];
    }
    reinterpret_cast<float4*>(s_lp + o)[0] =
        make_float4(out[0], out[1], out[2], out[3]);
    reinterpret_cast<float4*>(s_lp + o)[1] =
        make_float4(out[4], out[5], out[6], out[7]);
  } else {
    reinterpret_cast<float4*>(s_lp + o)[0] =
        make_float4(l[0], l[1], l[2], l[3]);
    reinterpret_cast<float4*>(s_lp + o)[1] =
        make_float4(l[4], l[5], l[6], l[7]);
  }
  __syncthreads();
  float* arow = audio + (long long)c * F + n0;
  float* lrow = lp + (long long)c * F + n0;
  for (int i = threadIdx.x; i < nv; i += AB_THREADS) {
    arow[i] = s_a[ab_slot(i)];
    lrow[i] = s_lp[ab_slot(i)];
  }
}

// 3. raw_mem[k][t] = sum_{i<ns} lpdc[sel k][k ns + i] e^{-j w_t (k ns + i)};
//    raw_pre the same over i <= b[k]; complex64 outputs [K][38].  Block
//    (k, tone group): the ns DC-fixed samples of sel[k] staged once (every
//    load of a thread in flight before its first store), then CT_SPLIT
//    warps a tone, warp s of a tone on samples 32 (s + CT_SPLIT j) + lane;
//    a lane's phase 10 f_t n mod PHASE_PERIOD starts exact in 64 bits and
//    steps by (32 CT_SPLIT 10 f_t) mod PHASE_PERIOD in 32.  Sums per lane
//    in sample order, a fixed shuffle tree per warp, the warps of a tone
//    added in order: a call is bit-equal to itself.
static __global__ void __launch_bounds__(CT_THREADS)
ab_ctcss(const float* __restrict__ lplocal, const float* __restrict__ carry,
         const float* __restrict__ pj, int F, int chunks, int ns,
         const int* __restrict__ b_arr, const int* __restrict__ sel,
         const int* __restrict__ f10, float* __restrict__ raw_pre,
         float* __restrict__ raw_mem) {
  constexpr int PER = (CT_NS_MAX + CT_THREADS - 1) / CT_THREADS;
  __shared__ float s_x[CT_NS_MAX];
  __shared__ float s_part[CT_TONES][CT_SPLIT][4];
  const int kk = blockIdx.x;
  const int c = min(max(sel[kk], 0), NCH - 1);
  const long long base = (long long)kk * ns;
  const float* yl = lplocal + (long long)c * F;
  const float* cr = carry + (long long)c * chunks;
  float v[PER];
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int i = u * CT_THREADS + threadIdx.x;
    v[u] = i < ns ? dc_fix(yl, cr, pj, base + i) : 0.f;
  }
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int i = u * CT_THREADS + threadIdx.x;
    if (i < ns) s_x[i] = v[u];
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int tt = warp / CT_SPLIT, sp = warp % CT_SPLIT;
  const int t = blockIdx.y * CT_TONES + tt;
  float pr = 0.f, pi = 0.f, mr = 0.f, mi = 0.f;
  if (t < NTONES) {
    const int b = b_arr[kk];
    const long long ft = f10[t];
    const int step = (int)((32 * CT_SPLIT * ft) % PHASE_PERIOD);
    const int i0 = 32 * sp + lane;
    int r = (int)((ft * (base + i0)) % PHASE_PERIOD);
#pragma unroll 4
    for (int i = i0; i < ns; i += 32 * CT_SPLIT) {
      const float x = s_x[i];
      // the phase in [-P/2, P/2), as a fraction of pi: |arg| < 1, and a
      // product, not a division
      const int rs = r < PHASE_PERIOD / 2 ? r : r - PHASE_PERIOD;
      float sv, cv;
      sincospif((float)rs * (2.0f / PHASE_PERIOD), &sv, &cv);
      const float er = x * cv;
      const float ei = -x * sv;
      mr += er;
      mi += ei;
      if (i <= b) {
        pr += er;
        pi += ei;
      }
      r += step;
      if (r >= PHASE_PERIOD) r -= PHASE_PERIOD;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      pr += __shfl_xor_sync(0xffffffffu, pr, o);
      pi += __shfl_xor_sync(0xffffffffu, pi, o);
      mr += __shfl_xor_sync(0xffffffffu, mr, o);
      mi += __shfl_xor_sync(0xffffffffu, mi, o);
    }
    if (lane == 0) {
      s_part[tt][sp][0] = pr;
      s_part[tt][sp][1] = pi;
      s_part[tt][sp][2] = mr;
      s_part[tt][sp][3] = mi;
    }
  }
  __syncthreads();
  if (threadIdx.x < CT_TONES * 4) {
    const int q = threadIdx.x % 4;
    const int tq = threadIdx.x / 4;
    const int t2 = blockIdx.y * CT_TONES + tq;
    if (t2 < NTONES) {
      float sum = s_part[tq][0][q];
#pragma unroll
      for (int s2 = 1; s2 < CT_SPLIT; ++s2) sum += s_part[tq][s2][q];
      const int o = 2 * (kk * NTONES + t2) + (q & 1);
      (q < 2 ? raw_pre : raw_mem)[o] = sum;
    }
  }
}

// 3'. lp_dcb[c][n] = the DC-blocked lp, one thread per (channel, sample)
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

// 4. new history = last H of [hist | demod]; lp DC blocker x[-1], y[-1]
//    unless dc_x_out is null (K8 apply, which has no DC blocker)
static __global__ void ab_tail(const float* __restrict__ hist, int H,
                               const float* __restrict__ demod, int F,
                               const float* __restrict__ lp_last,
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
    dc_x_out[c] = lp_last[c];
    dc_y_out[c] = dc_fix(lplocal + (long long)c * F,
                         carry + (long long)c * chunks, pj, F - 1);
  }
}

static bool ab_bad_args(int F, int H, int La, int Ll) {
  return F <= 0 || Ll <= 0 || La <= Ll || La > MAX_TAPS || La > H;
}

// Launches 1-2: audio, lp's chunk-local DC response, its chunk ends and
// lp[F - 1], the chunk carries.
static int ab_fir_dc(const void* demod, int F, const void* hist, int H,
                     const void* dc_x, const void* dc_y, const void* gain,
                     const void* tab, int La, int Ll, double p, double g,
                     double pL, void* lp_last, void* lplocal, void* yend,
                     void* carry, void* audio, cudaStream_t s) {
  const int chunks = (F + DC_L - 1) / DC_L;
  ab_fir<true><<<dim3((F + AB_TILE - 1) / AB_TILE, NCH), AB_THREADS, 0, s>>>(
      (const float*)demod, F, (const float*)hist, H, (const float4*)tab, La,
      Ll, (const float*)gain, (float*)audio, (float*)lplocal,
      (const float*)dc_x, p, g, (float*)yend, chunks, (float*)lp_last);
  SDR_CHECK_LAUNCH();
  dc_carry_kernel<<<NCH, CARRY_THREADS, 0, s>>>(
      (const float*)yend, (float*)carry, (const float*)dc_y, chunks, pL);
  SDR_CHECK_LAUNCH();
  return 0;
}

extern "C" int audio_bank_run(const void* demod, int F, const void* hist,
                              int H, const void* dc_x, const void* dc_y,
                              const void* gain, const void* b_arr,
                              const void* sel, int K, int ns, const void* tab,
                              int La, int Ll, const void* pj, double p,
                              double g, double pL, const void* f10,
                              void* lp_last, void* lplocal, void* yend,
                              void* carry, void* audio, void* hist_out,
                              void* dc_x_out, void* dc_y_out, void* raw_pre,
                              void* raw_mem, void* stream) {
  if (ab_bad_args(F, H, La, Ll) || K <= 0 || ns > CT_NS_MAX ||
      (long long)K * ns != F)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int chunks = (F + DC_L - 1) / DC_L;
  const int e = ab_fir_dc(demod, F, hist, H, dc_x, dc_y, gain, tab, La, Ll, p,
                          g, pL, lp_last, lplocal, yend, carry, audio, s);
  if (e != 0) return e;
  ab_ctcss<<<dim3(K, (NTONES + CT_TONES - 1) / CT_TONES), CT_THREADS, 0,
             s>>>((const float*)lplocal, (const float*)carry,
                  (const float*)pj, F, chunks, ns, (const int*)b_arr,
                  (const int*)sel, (const int*)f10, (float*)raw_pre,
                  (float*)raw_mem);
  SDR_CHECK_LAUNCH();
  ab_tail<<<NCH, 256, 0, s>>>((const float*)hist, H, (const float*)demod, F,
                              (const float*)lp_last, (const float*)lplocal,
                              (const float*)carry, (const float*)pj, chunks,
                              (float*)hist_out, (float*)dc_x_out,
                              (float*)dc_y_out);
  SDR_CHECK_LAUNCH();
  return 0;
}

// K8 apply: audio and the lp branch (no DC blocker), the new history.
extern "C" int audio_bank_apply(const void* demod, int F, const void* hist,
                                int H, const void* gain, const void* tab,
                                int La, int Ll, void* lp, void* audio,
                                void* hist_out, void* stream) {
  if (ab_bad_args(F, H, La, Ll)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  ab_fir<false><<<dim3((F + AB_TILE - 1) / AB_TILE, NCH), AB_THREADS, 0, s>>>(
      (const float*)demod, F, (const float*)hist, H, (const float4*)tab, La,
      Ll, (const float*)gain, (float*)audio, (float*)lp, nullptr, 0.0, 0.0,
      nullptr, 0, nullptr);
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
                                   const void* gain, const void* tab, int La,
                                   int Ll, const void* pj, double p, double g,
                                   double pL, void* lp_last, void* lplocal,
                                   void* yend, void* carry, void* audio,
                                   void* hist_out, void* dc_x_out,
                                   void* dc_y_out, void* lp_dcb,
                                   void* stream) {
  if (ab_bad_args(F, H, La, Ll)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int chunks = (F + DC_L - 1) / DC_L;
  const int e = ab_fir_dc(demod, F, hist, H, dc_x, dc_y, gain, tab, La, Ll, p,
                          g, pL, lp_last, lplocal, yend, carry, audio, s);
  if (e != 0) return e;
  ab_dc_plane<<<dim3((F + 255) / 256, NCH), 256, 0, s>>>(
      (const float*)lplocal, (const float*)carry, (const float*)pj, F, chunks,
      (float*)lp_dcb);
  SDR_CHECK_LAUNCH();
  ab_tail<<<NCH, 256, 0, s>>>((const float*)hist, H, (const float*)demod, F,
                              (const float*)lp_last, (const float*)lplocal,
                              (const float*)carry, (const float*)pj, chunks,
                              (float*)hist_out, (float*)dc_x_out,
                              (float*)dc_y_out);
  SDR_CHECK_LAUNCH();
  return 0;
}
