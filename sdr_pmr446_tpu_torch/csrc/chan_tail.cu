// K4: the whole dsd_in / single-channel chain ("mono chain") on Hopper, and
// K5: its tail alone, for the two-kernel engine (K6 -> K5).
//
// K4 replaces sdr_pmr446_tpu/kernels/chan_tail.py::PallasMonoChain.apply
// (the TPU kernel's bodies _mono_body_pk2 / _mono_body_cs16 /
// _mono_body_ilv and the tail _tail_core); K5 replaces PallasChanTail.apply
// (_body).  What they compute is documented beside their plain PyTorch
// versions, kernels/chan_tail.py.
//
// K4 (mono_run) runs five launches on the caller's stream, K5 (tail_run)
// the last two on K6's band planes; none allocates (the wrapper passes the
// demod scratch):
//   1-3. (K4) the front end of K1 (front_end.cuh): decode, DC blocker,
//      25/128 resampler into the band planes [2][nb];
//   A. tail_decim<MODE, FMT>: the carried state (band_hist', the mixer
//      phase n0' and, in K4, front_state's front_hist', dc_x', dc_y'),
//      grid-strided while the window lands; the mixer (single); the 16x
//      decimator; the discriminator in its epilogue.  Only the demod [F]
//      and sig_prev' reach device memory;
//   B. tail_post<MODE>: the 96/25 polyphase upsampler (dsd, x32767 folded
//      into the taps, clip) or the composed 408-tap audio FIR (single), and
//      demod_hist'.
// K4 and K5 launch the same two kernels (K5 with FMT_NONE: no front
// state), so K4's outputs equal K6 -> K5's bit for bit.
//
// What bounds the tail on the H100: at K = 16 it reads the 2.5 MB band
// (~0.75 us at 3.35 TB/s) and does ~45 MFLOP for dsd (bytes bound) or ~84
// MFLOP for single, the 838-tap decimator on two planes and the mixer
// (operations bound, ~1.3 us at 67 TFLOP/s); the post filters are 3-16
// MFLOP.  So the design keeps the decimator's FFMAs fed from registers:
//   - the decimator is a polyphase product.  With P' = 16 J taps (front-
//     padded with zeros, J a whole TILE_G) y[f] = sum_p sum_j K[p][j]
//     s_p[f + j], s_p[m] = x[HB - (P' - 1) + 16 m + p]: for each phase p a
//     J-tap FIR over every 16th band sample.  The wrapper stages the taps
//     by phase, [16][J] (kernels/chan_tail.py::staged_decim_taps).  A block
//     of 16 warps takes DEC_TILE outputs, warp p phase p, each lane TILE_R
//     consecutive outputs of both planes (fir_tile: a ring of 8 window
//     samples a plane in registers, rotated at compile time; per 8 taps 2
//     broadcast float4 tap loads and 4 float4 window loads feed 64 FFMAs,
//     no shuffle reduction).  The 16 phases' partial sums meet in shared
//     memory and are added in phase order;
//   - the window (by phase: row p holds s_p, DEC_ROW floats, 4 x odd, so
//     the transposing copies meet at most 2-way bank conflicts) and the
//     taps land by cp.async, every copy in flight; single then mixes each
//     sample in place, once, by its exact band index (one table entry a
//     thread, DEC_THREADS being a multiple of 32), for every K;
//   - blocks overlap by one output: a block computes outputs fs .. fs +
//     DEC_TILE - 1 (fs = 127 b - 1) and demodulates fs + 1 onward, so
//     sig[f - 1] never crosses blocks through device memory; F = 19,600 at
//     K = 16 gives 155 blocks for the 132 SMs.  The window's halo of
//     16 (J - 1) samples is 20-30 % of a block's window: the price of
//     enough blocks;
//   - the audio FIR (single) is the same fir_tile, one plane: 4 warps a
//     block take a quarter of the 416 staged taps (reversed, front-padded:
//     staged_fir_taps) each for the block's 128 outputs, summed in segment
//     order; the upsampler (dsd) stages its [96][43] phase table once a
//     block, each thread 4 frames of one phase.
// Every sum runs in one fixed order, no atomics: a call is bit-equal to the
// last.  True f32 FFMA (no TF32), native atan2f.  On an H100 (700 W) at
// K = 16, A takes ~5 us (dsd) / ~7 us (single) and B ~2.6 us on the device
// (kernel_times.py), 4-6x A's bound: its 155 blocks put two on 23 of the
// 132 SMs, which likely set its time (PERF.md, open questions).
#include "front_end.cuh"

#define DEC 16              // decimation of the channel filter: its phases
#define PHASES 32           // mixer table period (band samples)
#define TILE_R 4            // consecutive outputs a thread (fir_tile)
#define TILE_G 8            // staged taps of a FIR row padded to whole TILE_G
#define DEC_TILE 128        // decimated outputs a block computes: 32 TILE_R
#define DEC_THREADS 512     // a warp per phase
#define DEC_JMAX 56         // most staged taps a phase (P <= 896)
#define DEC_ROW 188         // floats of a phase row: >= DEC_TILE + DEC_JMAX
#define FIR_SPLIT 4         // tap segments (one a warp) of the audio FIR
#define FIR_TILE 128        // audio FIR outputs a block: 32 TILE_R
#define FIR_THREADS 128     // 32 FIR_SPLIT
#define MAX_FIR_TAPS 512    // longest staged audio FIR
#define UP_L 96             // upsampler interpolation
#define UP_M 25             // upsampler decimation
#define UP_MAX_P 64         // longest upsampler phase
#define UP_FT 4             // upsampler frames (of 96 outputs) a thread
#define UP_TG 2             // thread groups of UP_L a block
#define UP_THREADS 192      // UP_L UP_TG
#define UP_MAX_OFF ((UP_L - 1) * UP_M / UP_L)
#define UP_FB (UP_FT * UP_TG)  // frames a block
#define UP_WIN (UP_M * (UP_FB - 1) + UP_MAX_OFF + UP_MAX_P)

static_assert(DEC_TILE == 32 * TILE_R && FIR_TILE == 32 * TILE_R,
              "a warp covers a tile");
static_assert(DEC_THREADS == 32 * DEC && DEC_THREADS % PHASES == 0,
              "a warp a phase; one phase and mixer entry a thread");
static_assert(DEC_ROW >= DEC_TILE + DEC_JMAX && DEC_ROW % 8 == 4,
              "phase rows: long enough, float4 rows, 2-way copies");
static_assert(DEC_JMAX % TILE_G == 0 && TILE_G == 2 * TILE_R,
              "fir_tile runs two groups of 4 taps a step");
static_assert(FIR_THREADS == 32 * FIR_SPLIT && UP_THREADS == UP_L * UP_TG,
              "block shapes");
static_assert(2 * DEC * DEC_TILE <= 2 * DEC * DEC_ROW &&
                  FIR_SPLIT * FIR_TILE <= FIR_TILE + MAX_FIR_TAPS,
              "the partial sums fit in the window's memory");

enum { MODE_DSD = 0, MODE_SINGLE = 1 };
enum { FMT_NONE = -1 };  // K5: no front state

// The tail's inputs, tables and outputs (K4 and K5 alike).
struct TailArgs {
  const float* band;     // band planes [2][nb]
  long long nb;
  const float* bhist;    // band_hist: HB complex, interleaved
  int HB;
  const float* sig_prev;  // c64
  const float* dhist;    // demod_hist [DH]
  int DH;
  const int* n0;         // single: the mixer phase
  const float* kd;       // staged decimator taps [DEC][J]
  int J;
  const float* tab;      // single: mixer table, c64 [PHASES]
  const float* kpost;    // dsd: [UP_L][Pu] phases; single: staged FIR [NTP]
  int post_taps;         // Pu / NTP
  float dscale;
  float* dem;            // scratch [F]
  float* bhist_out;
  float* sig_prev_out;
  float* dhist_out;
  int* n0_out;
  float* out;
};

// K4's front-end state, which launch A writes (front_state).
struct FrontCarry {
  const uint8_t* wire;
  long long n;
  float inv_cu8;
  const float* ylocal;
  const float* carry;
  const float* pj;
  int chunks;
  const float* fhist_in;
  int H;
  float* fhist_out;
  float* dc_x_out;
  float* dc_y_out;
};

// acc[c][r] += sum_{q < n} t[q] w[c][q + r] for r < TILE_R, each plane c:
// the sums run over q in order.  n is a whole TILE_G; t and every w[c] are
// 16-byte aligned in shared memory, w[c] readable for n + 4 floats.  The
// window sits in a ring of 8 registers a plane (logical sample i at x[(4 S
// + i) % 8] in rotation S): each group of 4 taps loads the next 4 samples
// (one float4) into the slots the last group freed.
template <int NPL>
static __device__ __forceinline__ void fir_tile(
    const float* t, const float* const (&w)[NPL], int n,
    float (&acc)[NPL][TILE_R]) {
  float x[NPL][8];
#pragma unroll
  for (int c = 0; c < NPL; ++c) {
    const float4 v = *reinterpret_cast<const float4*>(w[c]);
    x[c][0] = v.x;
    x[c][1] = v.y;
    x[c][2] = v.z;
    x[c][3] = v.w;
  }
  for (int q = 0; q < n; q += TILE_G) {
    const float4 ta = *reinterpret_cast<const float4*>(t + q);
    const float4 tb = *reinterpret_cast<const float4*>(t + q + 4);
#pragma unroll
    for (int c = 0; c < NPL; ++c) {
      const float4 v = *reinterpret_cast<const float4*>(w[c] + q + 4);
      x[c][4] = v.x;
      x[c][5] = v.y;
      x[c][6] = v.z;
      x[c][7] = v.w;
    }
    const float ka[4] = {ta.x, ta.y, ta.z, ta.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < NPL; ++c)
#pragma unroll
        for (int r = 0; r < TILE_R; ++r)
          acc[c][r] = fmaf(ka[i], x[c][r + i], acc[c][r]);
#pragma unroll
    for (int c = 0; c < NPL; ++c) {
      const float4 v = *reinterpret_cast<const float4*>(w[c] + q + 8);
      x[c][0] = v.x;
      x[c][1] = v.y;
      x[c][2] = v.z;
      x[c][3] = v.w;
    }
    const float kb[4] = {tb.x, tb.y, tb.z, tb.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < NPL; ++c)
#pragma unroll
        for (int r = 0; r < TILE_R; ++r)
          acc[c][r] = fmaf(kb[i], x[c][(4 + r + i) % 8], acc[c][r]);
  }
}

// A. The carried state; then, for outputs f = fs .. fs + DEC_TILE - 1
// (fs = (DEC_TILE - 1) b - 1), sig[f] = sum_w kd'[w] m(be[HB - (16 J - 1)
// + 16 f + w]) with be = [band_hist (HB) | band], m the mixer (single: the
// sample at step-relative index i = e - HB times tab[(n0 + i) mod 32]) or
// identity (dsd); and dem[f] = atan2(Im, Re)(sig[f] conj(sig[f - 1])) *
// dscale for f = fs + 1 .. (sig[-1] = sig_prev).
template <int MODE, int FMT>
static __global__ void __launch_bounds__(DEC_THREADS, 2)
tail_decim(TailArgs a, FrontCarry fc) {
  __shared__ __align__(16) float s_win[2 * DEC * DEC_ROW];
  __shared__ __align__(16) float s_tap[DEC * DEC_JMAX];
  __shared__ float s_sig[2][DEC_TILE];
  const int F = (int)(a.nb / DEC);
  const int nb = (int)a.nb, HB = a.HB, J = a.J;
  const int fs = blockIdx.x * (DEC_TILE - 1) - 1;
  const int base = HB - (DEC * J - 1) + DEC * fs;
  const int nwin = DEC * (DEC_TILE + J);
  for (int i = threadIdx.x; i < DEC * J / 4; i += DEC_THREADS)
    cp_async<16>(s_tap + 4 * i, a.kd + 4 * i);
  // thread t copies window samples j = t (mod DEC_THREADS): all of phase
  // t % DEC, to row t % DEC, columns t / DEC + (DEC_THREADS / DEC) k
  float* const slot0 =
      s_win + (threadIdx.x % DEC) * DEC_ROW + threadIdx.x / DEC;
  constexpr int COL_STEP = DEC_THREADS / DEC;
  {
    float* slot = slot0;
    for (int j = threadIdx.x; j < nwin; j += DEC_THREADS, slot += COL_STEP) {
      const int e = base + j;  // sample e of be
      const float* src = a.band;
      int im = 0;  // offset of the imaginary part from src
      bool in = true;
      if (e >= 0 && e < HB) {
        src = a.bhist + 2 * e;
        im = 1;
      } else if (e >= HB && e - HB < nb) {
        src = a.band + (e - HB);
        im = nb;
      } else {
        in = false;  // zero: before the history or past the band
      }
      cp_async<4>(slot, src, in);
      cp_async<4>(slot + DEC * DEC_ROW, src + im, in);
    }
  }
  // the carried state, grid-strided, while the copies land
  const int nstate = FMT == FMT_NONE ? HB : max(HB, fc.H);
  for (int j = blockIdx.x * DEC_THREADS + threadIdx.x; j < nstate;
       j += gridDim.x * DEC_THREADS) {
    hist_tail(j, a.bhist, HB, a.band, a.band + a.nb, a.nb, a.bhist_out);
    if constexpr (FMT != FMT_NONE)
      front_state<FMT>(j, fc.wire, fc.n, fc.inv_cu8, fc.ylocal, fc.carry,
                       fc.pj, fc.chunks, fc.fhist_in, fc.H, fc.fhist_out,
                       fc.dc_x_out, fc.dc_y_out);
  }
  if (MODE == MODE_SINGLE && blockIdx.x == 0 && threadIdx.x == 0)
    a.n0_out[0] = (int)((a.n0[0] + a.nb % PHASES) % PHASES);
  cp_async_wait_all();
  if (MODE == MODE_SINGLE) {
    // be[e] has mixer phase (ph0 + e) mod 32; this thread's samples are
    // e = base + threadIdx.x (mod DEC_THREADS), so all share one entry
    const int ph0 = ((a.n0[0] - HB) % PHASES + PHASES) % PHASES;
    const int ph = (ph0 + base + (int)threadIdx.x) & (PHASES - 1);
    const float tr = __ldg(a.tab + 2 * ph), ti = __ldg(a.tab + 2 * ph + 1);
    float* slot = slot0;
    for (int j = threadIdx.x; j < nwin; j += DEC_THREADS, slot += COL_STEP) {
      const float vr = slot[0], vi = slot[DEC * DEC_ROW];
      slot[0] = vr * tr - vi * ti;
      slot[DEC * DEC_ROW] = vr * ti + vi * tr;
    }
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int p = threadIdx.x >> 5;
  float acc[2][TILE_R];
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int r = 0; r < TILE_R; ++r) acc[c][r] = 0.f;
  const float* const w[2] = {s_win + p * DEC_ROW + TILE_R * lane,
                             s_win + (DEC + p) * DEC_ROW + TILE_R * lane};
  fir_tile<2>(s_tap + p * J, w, J, acc);
  __syncthreads();  // every warp is done with the window
  float* part = s_win;  // partial sums [plane][phase][DEC_TILE]
#pragma unroll
  for (int c = 0; c < 2; ++c)
    *reinterpret_cast<float4*>(part + (c * DEC + p) * DEC_TILE +
                               TILE_R * lane) =
        make_float4(acc[c][0], acc[c][1], acc[c][2], acc[c][3]);
  __syncthreads();
  if (threadIdx.x < 2 * DEC_TILE) {
    const int c = threadIdx.x / DEC_TILE, o = threadIdx.x % DEC_TILE;
    float v = part[c * DEC * DEC_TILE + o];
#pragma unroll
    for (int q = 1; q < DEC; ++q) v += part[(c * DEC + q) * DEC_TILE + o];
    s_sig[c][o] = v;
  }
  __syncthreads();
  const int o = threadIdx.x, f = fs + o;
  if (o >= 1 && o < DEC_TILE && f < F) {
    const float xr = s_sig[0][o], xi = s_sig[1][o];
    const float pr = f == 0 ? a.sig_prev[0] : s_sig[0][o - 1];
    const float pi = f == 0 ? a.sig_prev[1] : s_sig[1][o - 1];
    a.dem[f] = atan2f(xi * pr - xr * pi, xr * pr + xi * pi) * a.dscale;
    if (f == F - 1) {
      a.sig_prev_out[0] = xr;
      a.sig_prev_out[1] = xi;
    }
  }
}

// sample e of de = [demod_hist (DH) | dem (F)], zero outside
static __device__ __forceinline__ const float* de_src(const TailArgs& a,
                                                      int F, long long e,
                                                      bool& in) {
  in = true;
  if (e >= 0 && e < a.DH) return a.dhist + e;
  if (e >= a.DH && e - a.DH < F) return a.dem + (e - a.DH);
  in = false;
  return a.dhist;
}

// demod_hist' = the last DH samples of de (grid-strided)
static __device__ __forceinline__ void demod_tail(const TailArgs& a, int F) {
  for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < a.DH;
       j += gridDim.x * blockDim.x) {
    bool in;
    const float* src = de_src(a, F, (long long)F + j, in);
    a.dhist_out[j] = in ? *src : 0.f;
  }
}

// B, single: out[n] = sum_q hs[q] de[DH - (NTP - 1) + n + q] (hs the FIR x
// gain, reversed and front-padded to NTP taps), FIR_TILE outputs a block,
// warp s on taps [s NTP / 4, (s + 1) NTP / 4).
static __device__ __forceinline__ void post_fir(const TailArgs& a, int F,
                                                float* smem) {
  float* s_h = smem;
  float* s_w = smem + MAX_FIR_TAPS;
  const int ntp = a.post_taps, seg = ntp / FIR_SPLIT;
  const int n0 = blockIdx.x * FIR_TILE;
  const long long base = (long long)a.DH - (ntp - 1) + n0;
  for (int i = threadIdx.x; i < ntp / 4; i += FIR_THREADS)
    cp_async<16>(s_h + 4 * i, a.kpost + 4 * i);
  for (int j = threadIdx.x; j < FIR_TILE + ntp; j += FIR_THREADS) {
    bool in;
    const float* src = de_src(a, F, base + j, in);
    cp_async<4>(s_w + j, src, in);
  }
  demod_tail(a, F);
  cp_async_wait_all();
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int s = threadIdx.x >> 5;
  float acc[1][TILE_R] = {{0.f, 0.f, 0.f, 0.f}};
  const float* const w[1] = {s_w + TILE_R * lane + s * seg};
  fir_tile<1>(s_h + s * seg, w, seg, acc);
  __syncthreads();  // every warp is done with the window
  float* part = s_w;  // [FIR_SPLIT][FIR_TILE]
  *reinterpret_cast<float4*>(part + s * FIR_TILE + TILE_R * lane) =
      make_float4(acc[0][0], acc[0][1], acc[0][2], acc[0][3]);
  __syncthreads();
  const int o = threadIdx.x;
  if (n0 + o < F) {
    float v = part[o];
#pragma unroll
    for (int q = 1; q < FIR_SPLIT; ++q) v += part[q * FIR_TILE + o];
    a.out[n0 + o] = v;
  }
}

// B, dsd: out[96 g + p] = clip(sum_i ku[p][i] de[DH - (Pu - 1) + 25 g + o_p
// + i]), o_p = (25 p) / 96 (ku carries the x32767); the [96][Pu] table
// staged once a block, thread (p, group) on UP_FT consecutive frames.
static __device__ __forceinline__ void post_dsd(const TailArgs& a, int F,
                                                float* smem) {
  float* s_k = smem;
  float* s_w = smem + UP_L * UP_MAX_P;
  const int pu = a.post_taps;
  const int G = F / UP_M;
  const int g0 = blockIdx.x * UP_FB;
  const long long base = (long long)a.DH - (pu - 1) + (long long)UP_M * g0;
  for (int i = threadIdx.x; i < UP_L * pu / 4; i += UP_THREADS)
    cp_async<16>(s_k + 4 * i, a.kpost + 4 * i);
  for (int j = threadIdx.x; j < UP_M * (UP_FB - 1) + UP_MAX_OFF + pu;
       j += UP_THREADS) {
    bool in;
    const float* src = de_src(a, F, base + j, in);
    cp_async<4>(s_w + j, src, in);
  }
  demod_tail(a, F);
  cp_async_wait_all();
  __syncthreads();
  const int p = threadIdx.x % UP_L;
  const int gl = threadIdx.x / UP_L;
  const float* k = s_k + p * pu;
  const float* x = s_w + UP_M * UP_FT * gl + (p * UP_M) / UP_L;
  float acc[UP_FT];
#pragma unroll
  for (int r = 0; r < UP_FT; ++r) acc[r] = 0.f;
  for (int i = 0; i < pu; ++i) {
    const float kv = k[i];
#pragma unroll
    for (int r = 0; r < UP_FT; ++r) acc[r] = fmaf(kv, x[UP_M * r + i], acc[r]);
  }
#pragma unroll
  for (int r = 0; r < UP_FT; ++r) {
    const int g = g0 + UP_FT * gl + r;
    if (g < G)
      a.out[(long long)g * UP_L + p] = fminf(fmaxf(acc[r], -32768.f), 32767.f);
  }
}

// B. the post filter and demod_hist'
template <int MODE>
static __global__ void __launch_bounds__(MODE == MODE_SINGLE ? FIR_THREADS
                                                             : UP_THREADS)
tail_post(TailArgs a) {
  constexpr int SMEM = MODE == MODE_SINGLE
                           ? 2 * MAX_FIR_TAPS + FIR_TILE
                           : UP_L * UP_MAX_P + UP_WIN;
  __shared__ __align__(16) float smem[SMEM];
  const int F = (int)(a.nb / DEC);
  if constexpr (MODE == MODE_SINGLE)
    post_fir(a, F, smem);
  else
    post_dsd(a, F, smem);
}

// Launches A and B (the tail shared by K4 and K5).
template <int MODE, int FMT>
static int tail_launch_mode(const TailArgs& a, const FrontCarry& fc,
                            cudaStream_t s) {
  const int F = (int)(a.nb / DEC);
  tail_decim<MODE, FMT>
      <<<(F + DEC_TILE - 2) / (DEC_TILE - 1), DEC_THREADS, 0, s>>>(a, fc);
  SDR_CHECK_LAUNCH();
  if (MODE == MODE_SINGLE)
    tail_post<MODE><<<(F + FIR_TILE - 1) / FIR_TILE, FIR_THREADS, 0, s>>>(a);
  else
    tail_post<MODE><<<(F / UP_M + UP_FB - 1) / UP_FB, UP_THREADS, 0, s>>>(a);
  SDR_CHECK_LAUNCH();
  return 0;
}

template <int FMT>
static int tail_launch(int mode, const TailArgs& a, const FrontCarry& fc,
                       cudaStream_t s) {
  return mode == MODE_SINGLE ? tail_launch_mode<MODE_SINGLE, FMT>(a, fc, s)
                             : tail_launch_mode<MODE_DSD, FMT>(a, fc, s);
}

// The tail's arguments that K4 and K5 check alike
static bool tail_args_ok(int mode, const TailArgs& a) {
  const bool single = mode == MODE_SINGLE;
  const bool post_ok =
      single ? a.post_taps <= MAX_FIR_TAPS &&
                   a.post_taps % (FIR_SPLIT * TILE_G) == 0
             : a.post_taps <= UP_MAX_P;
  return (mode == MODE_DSD || single) && a.nb < (1LL << 30) &&
         a.HB < (1 << 20) && a.J >= TILE_G && a.J <= DEC_JMAX &&
         a.J % TILE_G == 0 && a.HB >= DEC * a.J - 1 &&
         (!single || (a.n0 != nullptr && a.tab != nullptr &&
                      a.n0_out != nullptr)) &&
         post_ok && a.post_taps >= 1 && a.DH >= a.post_taps - 1;
}

static TailArgs tail_args(const void* band, long long nb, const void* bhist,
                          int HB, const void* sig_prev, const void* dhist,
                          int DH, const void* n0, const void* kd, int J,
                          const void* tab, const void* kpost, int post_taps,
                          float dscale, void* dem, void* bhist_out,
                          void* sig_prev_out, void* dhist_out, void* n0_out,
                          void* out) {
  return TailArgs{(const float*)band, nb, (const float*)bhist, HB,
                  (const float*)sig_prev, (const float*)dhist, DH,
                  (const int*)n0, (const float*)kd, J, (const float*)tab,
                  (const float*)kpost, post_taps, dscale, (float*)dem,
                  (float*)bhist_out, (float*)sig_prev_out, (float*)dhist_out,
                  (int*)n0_out, (float*)out};
}

template <int FMT>
static int mono_launch(int mode, const TailArgs& a, const FrontCarry& fc,
                       const float* dc_x, const float* dc_y, const float* kt,
                       double p, double g, double pL, float* ylocal,
                       float* yend, float* carry, float* band,
                       cudaStream_t s) {
  const int fe = front_end_launch<FMT>(fc.wire, fc.n, dc_x, dc_y, fc.fhist_in,
                                       fc.H, kt, fc.pj, p, g, pL, fc.inv_cu8,
                                       ylocal, yend, carry, band, s);
  if (fe != 0) return fe;
  return tail_launch<FMT>(mode, a, fc, s);
}

extern "C" int mono_run(int fmt, int mode, const void* wire, long long n,
                        const void* dc_x, const void* dc_y, const void* fhist,
                        int H, const void* bhist, int HB, const void* sig_prev,
                        const void* dhist, int DH, const void* n0,
                        const void* kt, const void* pj, double p, double g,
                        double pL, float inv_cu8,
                        const void* kd, int J, const void* tab,
                        const void* kpost, int post_taps, float dscale,
                        void* ylocal, void* yend, void* carry, void* band,
                        void* dem, void* dc_x_out, void* dc_y_out,
                        void* fhist_out, void* bhist_out, void* sig_prev_out,
                        void* dhist_out, void* n0_out, void* out,
                        void* stream) {
  const TailArgs a = tail_args(band, n / RES_M * RES_L, bhist, HB, sig_prev,
                               dhist, DH, n0, kd, J, tab, kpost, post_taps,
                               dscale, dem, bhist_out, sig_prev_out,
                               dhist_out, n0_out, out);
  if (n <= 0 || n % (RES_M * DEC) != 0 || H < RS_P - 1 ||
      !tail_args_ok(mode, a))
    return (int)cudaErrorInvalidValue;
  const FrontCarry fc{(const uint8_t*)wire, n, inv_cu8, (const float*)ylocal,
                      (const float*)carry, (const float*)pj,
                      (int)((n + DC_L - 1) / DC_L), (const float*)fhist, H,
                      (float*)fhist_out, (float*)dc_x_out, (float*)dc_y_out};
#define SDR_MONO_ARGS                                                     \
  mode, a, fc, (const float*)dc_x, (const float*)dc_y, (const float*)kt, \
      p, g, pL, (float*)ylocal, (float*)yend, (float*)carry, (float*)band, \
      (cudaStream_t)stream
  switch (fmt) {
    case FMT_CU8: return mono_launch<FMT_CU8>(SDR_MONO_ARGS);
    case FMT_CS8: return mono_launch<FMT_CS8>(SDR_MONO_ARGS);
    case FMT_CS16: return mono_launch<FMT_CS16>(SDR_MONO_ARGS);
    case FMT_CF32: return mono_launch<FMT_CF32>(SDR_MONO_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef SDR_MONO_ARGS
}

// K5: the tail alone, on band planes [2][nb] written by K6 (nb a whole
// number of 400-sample group rows): launches A and B.
extern "C" int tail_run(int mode, const void* band, long long nb,
                        const void* bhist, int HB, const void* sig_prev,
                        const void* dhist, int DH, const void* n0,
                        const void* kd, int J, const void* tab,
                        const void* kpost, int post_taps, float dscale,
                        void* dem, void* bhist_out, void* sig_prev_out,
                        void* dhist_out, void* n0_out, void* out,
                        void* stream) {
  const TailArgs a = tail_args(band, nb, bhist, HB, sig_prev, dhist, DH, n0,
                               kd, J, tab, kpost, post_taps, dscale, dem,
                               bhist_out, sig_prev_out, dhist_out, n0_out,
                               out);
  if (nb <= 0 || nb % (UP_M * DEC) != 0 || !tail_args_ok(mode, a))
    return (int)cudaErrorInvalidValue;
  return tail_launch<FMT_NONE>(mode, a, FrontCarry{}, (cudaStream_t)stream);
}
