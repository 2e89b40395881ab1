// The front end shared by K1 (csrc/duo.cu), K4 (csrc/chan_tail.cu) and K6
// (csrc/front_end.cu): wire decode, the IQ DC blocker and the 25/128
// polyphase resampler to the 200 kHz band.  What it computes is documented
// beside its plain PyTorch version, kernels/front_end.py::FrontEnd.
//
// Three launches (the caller issues them, see front_end_launch):
//   1. fe_dc_local<FMT>: wire decode + zero-state DC response per chunk
//      (the wire and the response staged through shared memory);
//   2. dc_carry_kernel: chunk carries (sdr_common.cuh);
//   3. fe_resample: the 25/128 resampler over RS_FB band frames a block, the
//      DC fix-up fused into its shared-memory window load (resample_tile).
// Device memory between launches: the chunk-local DC response [2][n] and
// the band planes [2][nb].  front_state gives the carried state (front
// history, DC x[-1] and y[-1]); each kernel that runs the front end calls it
// from its own state launch.  resample_tile is the resampler's arithmetic
// on a loaded window, shared with K9 (csrc/resample_kernel.cu).
//
// The resampler is a product: band[f][q] = sum_j win[128 f + j] B[j][q],
// B[j][q] = kc[q][j - o_q], o_q = (128 q) / 25.  The 25 phases go in two
// halves of RS_Q (the second padded with a zero phase); the wrapper stages
// each half's B from the half's first offset o_(13 h) as [RS_ROWS][RS_QP]
// rows, zero outside the taps (kernels/front_end.py::staged_taps).  A block
// holds that table (52 KB) and its window of RS_FB frames (69 KB, as
// float2 (re, im) with one pad slot every 128 samples, so the 32 lanes of a
// warp, on 32 frames, read 32 distinct bank pairs) in dynamic shared memory;
// both land by cp.async, so no register holds a sample in flight (one block
// of 8 warps fills an SM), and fe_resample adds the DC fix-up in place.
// Thread (half h, segment s, lane) accumulates frames lane + 32 r (r <
// RS_FT) x the half's RS_Q phases x both planes over the RS_SEG rows of
// segment s: per row 2 window loads (8 bytes) and 4 tap loads (16 bytes, a
// broadcast) feed 52 FFMAs.  The RS_SPLIT segments' partial sums meet in
// shared memory and are added in segment order, so a call is bit-equal to
// itself, and the band goes out in coalesced rows.  True f32 FFMA
// throughout: no TF32, no tensor cores.
#pragma once

#include "sdr_common.cuh"

#define RES_L 25          // resampler interpolation
#define RES_M 128         // resampler decimation
#define RS_P 346          // taps per polyphase row
#define RS_FB 64          // band frames per block
#define RS_FT 2           // frames per thread (lane + 32 r)
#define RS_Q 13           // phases per thread: a half of the 25
#define RS_QP 16          // staged tap row (RS_Q padded to whole float4)
#define RS_SPLIT 4        // row segments of a half (the K split)
#define RS_SEG 102        // rows per segment
#define RS_ROWS (RS_SPLIT * RS_SEG)  // staged rows of a half
#define RS_OFF1 66        // o_13: the second half's first window offset
#define RS_THREADS (2 * RS_SPLIT * 32)
#define RS_WIN (RES_M * (RS_FB - 1) + RS_OFF1 + RS_ROWS)
// float2 slots of the window: sample j at j + j / 128
#define RS_WIN_SLOTS (RS_WIN + RS_WIN / RES_M + 1)
#define RS_TAP_F4 (2 * RS_ROWS * RS_QP / 4)
#define RS_SMEM (RS_TAP_F4 * 16 + RS_WIN_SLOTS * 8)

enum { FMT_CU8 = 0, FMT_CS8 = 1, FMT_CS16 = 2, FMT_CF32 = 3 };

// One wire component decoded exactly as ops/decode.py (bit-exact), from the
// component's integer value as a float: the one float expression of each
// format, shared by load_iq and K10's 16-byte unpacking (csrc/summary.cu).
static __device__ __forceinline__ float dec_cu8(float b, float inv_cu8) {
  return (b - 127.5f) * inv_cu8;
}
static __device__ __forceinline__ float dec_cs8(float b) {
  return b * (1.0f / 128.0f);
}
static __device__ __forceinline__ float dec_cs16(float s) {
  return s * (1.0f / 32768.0f);
}

// Sample n of the wire, decoded exactly as ops/decode.py (bit-exact).
template <int FMT>
static __device__ __forceinline__ float2 load_iq(const uint8_t* __restrict__ w,
                                                 long long n, float inv_cu8) {
  if (FMT == FMT_CU8) {
    const uchar2 b = reinterpret_cast<const uchar2*>(w)[n];
    return make_float2(dec_cu8((float)b.x, inv_cu8),
                       dec_cu8((float)b.y, inv_cu8));
  } else if (FMT == FMT_CS8) {
    const char2 b = reinterpret_cast<const char2*>(w)[n];
    return make_float2(dec_cs8((float)b.x), dec_cs8((float)b.y));
  } else if (FMT == FMT_CS16) {
    const short2 s = reinterpret_cast<const short2*>(w)[n];
    return make_float2(dec_cs16((float)s.x), dec_cs16((float)s.y));
  } else {
    return reinterpret_cast<const float2*>(w)[n];
  }
}

// 1. one thread per DC_L-sample chunk, both planes, DCL_THREADS chunks a
// block.  The wire goes in and ylocal out through shared memory, a
// DCL_TILE-sample piece of every chunk a round, so that the block reads and
// writes runs of DCL_TILE consecutive samples; each thread keeps its
// chunk's recurrence (in double) in registers across the rounds.
#define DCL_THREADS 256
#define DCL_TILE 16
#define DCL_ROW (DCL_TILE + 1)  // a chunk's row of float2: the 16 lanes of
//                                 a half-warp fall on distinct banks
template <int FMT>
static __global__ void __launch_bounds__(DCL_THREADS, 2)
fe_dc_local(const uint8_t* __restrict__ wire, long long n,
            const float* __restrict__ dc_x, float inv_cu8, double p, double g,
            float* __restrict__ ylocal, float* __restrict__ yend,
            int chunks) {
  __shared__ float2 xs[DCL_THREADS * DCL_ROW];
  const long long cb = (long long)blockIdx.x * DCL_THREADS;
  const long long c = cb + threadIdx.x;
  const long long n0 = c * DC_L;
  float2 xp = make_float2(0.f, 0.f);
  if (c < chunks)
    xp = (n0 == 0) ? make_float2(dc_x[0], dc_x[1])
                   : load_iq<FMT>(wire, n0 - 1, inv_cu8);
  double yr = 0.0, yi = 0.0;
  for (int ro = 0; ro < DC_L / DCL_TILE; ++ro) {
    // element i of a round: sample i % DCL_TILE of the piece of chunk
    // cb + i / DCL_TILE; each thread loads DCL_TILE of them, then stores
    float2 v[DCL_TILE];
#pragma unroll
    for (int u = 0; u < DCL_TILE; ++u) {
      const int i = u * DCL_THREADS + threadIdx.x;
      const long long sm = (cb + i / DCL_TILE) * DC_L + ro * DCL_TILE +
                           i % DCL_TILE;
      v[u] = sm < n ? load_iq<FMT>(wire, sm, inv_cu8) : make_float2(0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < DCL_TILE; ++u) {
      const int i = u * DCL_THREADS + threadIdx.x;
      xs[(i / DCL_TILE) * DCL_ROW + i % DCL_TILE] = v[u];
    }
    __syncthreads();
    float2* row = xs + threadIdx.x * DCL_ROW;
#pragma unroll
    for (int j = 0; j < DCL_TILE; ++j) {
      if (n0 + ro * DCL_TILE + j < n) {
        const float2 x = row[j];
        yr = p * yr + g * ((double)x.x - (double)xp.x);
        yi = p * yi + g * ((double)x.y - (double)xp.y);
        row[j] = make_float2((float)yr, (float)yi);
        xp = x;
      }
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < DCL_TILE; ++u) {
      const int i = u * DCL_THREADS + threadIdx.x;
      const long long sm = (cb + i / DCL_TILE) * DC_L + ro * DCL_TILE +
                           i % DCL_TILE;
      if (sm < n) {
        const float2 y = xs[(i / DCL_TILE) * DCL_ROW + i % DCL_TILE];
        ylocal[sm] = y.x;
        ylocal[n + sm] = y.y;
      }
    }
    __syncthreads();
  }
  if (c < chunks) {
    yend[c] = (float)yr;
    yend[chunks + c] = (float)yi;
  }
}

// y-space sample e of [front_hist (H) | y (n)], plane-wise
static __device__ __forceinline__ float2 ye_sample(
    const float* __restrict__ fhist, int H, const float* __restrict__ ylocal,
    const float* __restrict__ carry, const float* __restrict__ pj, long long n,
    int chunks, long long e) {
  if (e < H) return make_float2(fhist[2 * e], fhist[2 * e + 1]);
  const long long m = e - H;
  if (m >= n) return make_float2(0.f, 0.f);
  return make_float2(dc_fix(ylocal, carry, pj, m),
                     dc_fix(ylocal + n, carry + chunks, pj, m));
}

// Slot of window sample j (the pad every 128 samples).
static __device__ __forceinline__ int rs_slot(int j) { return j + (j >> 7); }

// The staged taps and the window into shared memory by cp.async (no
// register holds a sample in flight): window sample j < RS_WIN is xe[e0 +
// j] of xe = [hist (P complex, interleaved) | planes (pr, pi) of n samples],
// zero past the end.  Thread t copies the samples j = t (mod RS_THREADS).
static __device__ __forceinline__ void rs_fetch(
    const float4* __restrict__ kt, float4* taps, float2* win,
    const float* __restrict__ hist, int P, const float* __restrict__ pr,
    const float* __restrict__ pi, long long n, long long e0) {
  for (int i = threadIdx.x; i < RS_TAP_F4; i += RS_THREADS)
    cp_async<16>(taps + i, kt + i);
  for (int j = threadIdx.x; j < RS_WIN; j += RS_THREADS) {
    float2* slot = win + rs_slot(j);
    const long long e = e0 + j;
    if (e < P) {
      cp_async<8>(slot, hist + 2 * e);
    } else {
      const long long i = e - P;
      const bool in = i < n;
      cp_async<4>(&slot->x, in ? pr + i : pr, in);
      cp_async<4>(&slot->y, in ? pi + i : pi, in);
    }
  }
}

// band[25 f + q] for the RS_FB frames from f0 of one block, from its staged
// taps and loaded window (RS_THREADS threads; the window's memory is reused
// for the partial sums).
static __device__ __forceinline__ void resample_tile(
    const float4* taps, float2* win, float* __restrict__ band, long long nb,
    int f0, int frames) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int h = warp / RS_SPLIT;
  const int s = warp % RS_SPLIT;
  const int c0 = h * RS_OFF1 + s * RS_SEG;
  const float4* tp = taps + (h * RS_ROWS + s * RS_SEG) * (RS_QP / 4);
  const float2* wl = win + (RES_M + 1) * lane;
  float ar[RS_FT][RS_Q], ai[RS_FT][RS_Q];
#pragma unroll
  for (int r = 0; r < RS_FT; ++r)
#pragma unroll
    for (int q = 0; q < RS_Q; ++q) ar[r][q] = ai[r][q] = 0.f;
#pragma unroll 3
  for (int jj = 0; jj < RS_SEG; ++jj) {
    const int t = rs_slot(c0 + jj);
    float2 x[RS_FT];
#pragma unroll
    for (int r = 0; r < RS_FT; ++r) x[r] = wl[(RES_M + 1) * 32 * r + t];
    float k[RS_QP];
#pragma unroll
    for (int i = 0; i < RS_QP / 4; ++i) {
      const float4 v = tp[jj * (RS_QP / 4) + i];
      k[4 * i] = v.x;
      k[4 * i + 1] = v.y;
      k[4 * i + 2] = v.z;
      k[4 * i + 3] = v.w;
    }
#pragma unroll
    for (int r = 0; r < RS_FT; ++r)
#pragma unroll
      for (int q = 0; q < RS_Q; ++q) {
        ar[r][q] = fmaf(k[q], x[r].x, ar[r][q]);
        ai[r][q] = fmaf(k[q], x[r].y, ai[r][q]);
      }
  }
  __syncthreads();  // every warp is done with the window
  // partials [segment][plane][frame][phase]
  float* part = reinterpret_cast<float*>(win);
#pragma unroll
  for (int r = 0; r < RS_FT; ++r)
#pragma unroll
    for (int q = 0; q < RS_Q; ++q) {
      const int qq = RS_Q * h + q;
      if (qq < RES_L) {
        const int o = (lane + 32 * r) * RES_L + qq;
        part[(2 * s) * RS_FB * RES_L + o] = ar[r][q];
        part[(2 * s + 1) * RS_FB * RES_L + o] = ai[r][q];
      }
    }
  __syncthreads();
  const int nout = min(RS_FB, frames - f0) * RES_L;
  for (int i = threadIdx.x; i < 2 * RS_FB * RES_L; i += blockDim.x) {
    const int p = i / (RS_FB * RES_L);
    const int o = i % (RS_FB * RES_L);
    if (o >= nout) continue;
    float v = part[p * RS_FB * RES_L + o];
#pragma unroll
    for (int sg = 1; sg < RS_SPLIT; ++sg)
      v += part[(2 * sg + p) * RS_FB * RES_L + o];
    band[p * nb + (long long)f0 * RES_L + o] = v;
  }
}

// 3. band[25 f + q] = sum_i kc[q][i] * ye[H - 345 + 128 f + o_q + i]
static __global__ void __launch_bounds__(RS_THREADS)
fe_resample(const float* __restrict__ ylocal, const float* __restrict__ carry,
            const float* __restrict__ pj, const float* __restrict__ fhist,
            int H, long long n, int chunks, const float4* __restrict__ kt,
            float* __restrict__ band, long long nb, int frames) {
  extern __shared__ float4 rs_smem[];
  float2* win = reinterpret_cast<float2*>(rs_smem + RS_TAP_F4);
  const int f0 = blockIdx.x * RS_FB;
  const long long base = (long long)H - (RS_P - 1) + (long long)RES_M * f0;
  // the window holds y - carry p^(m % DC_L + 1) for y-space sample m: the
  // chunk carries it needs go to shared memory while it lands, then each
  // thread fixes its own samples j = t (mod RS_THREADS) — one fix-up power
  // a thread, RS_THREADS being a multiple of DC_L
  static_assert(RS_THREADS % DC_L == 0, "one fix-up power a thread");
  constexpr int NC = RS_WIN / DC_L + 2;
  __shared__ float s_carry[2][NC];
  rs_fetch(kt, rs_smem, win, fhist, H, ylocal, ylocal + n, n, base);
  const long long m0 = base - H;
  const long long c0 = m0 > 0 ? m0 / DC_L : 0;
  for (int i = threadIdx.x; i < 2 * NC; i += RS_THREADS) {
    const long long c = c0 + i % NC;
    s_carry[i / NC][i % NC] = c < chunks ? carry[(i / NC) * chunks + c] : 0.f;
  }
  const float pt = pj[((m0 + threadIdx.x) % DC_L + DC_L) % DC_L];
  cp_async_wait_all();
  __syncthreads();
  for (int j = threadIdx.x; j < RS_WIN; j += RS_THREADS) {
    const long long m = m0 + j;
    if (m >= 0 && m < n) {
      const int c = (int)(m / DC_L - c0);
      float2& v = win[rs_slot(j)];
      v.x = fmaf(s_carry[0][c], pt, v.x);
      v.y = fmaf(s_carry[1][c], pt, v.y);
    }
  }
  __syncthreads();
  resample_tile(rs_smem, win, band, nb, f0, frames);
}

// Launch geometry of the resampler kernels: RS_FB frames a block, RS_SMEM
// bytes of dynamic shared memory (above the 48 KB static limit, so the
// kernel is opened to it first; a refusal is returned, never worked round).
template <typename Kernel>
static cudaError_t rs_open(Kernel kernel) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              RS_SMEM);
}

// Entry j of the front end's carried state: front_hist' (the last H of
// [front_hist | y]) for j < H; DC blocker x[-1] and y[-1] for j == 0.
template <int FMT>
static __device__ __forceinline__ void front_state(
    int j, const uint8_t* __restrict__ wire, long long n, float inv_cu8,
    const float* __restrict__ ylocal, const float* __restrict__ carry,
    const float* __restrict__ pj, int chunks,
    const float* __restrict__ fhist_in, int H, float* __restrict__ fhist_out,
    float* __restrict__ dc_x_out, float* __restrict__ dc_y_out) {
  if (j < H) {
    const float2 v = ye_sample(fhist_in, H, ylocal, carry, pj, n, chunks,
                               n + j);
    fhist_out[2 * j] = v.x;
    fhist_out[2 * j + 1] = v.y;
  }
  if (j == 0) {
    const float2 y = ye_sample(fhist_in, H, ylocal, carry, pj, n, chunks,
                               H + n - 1);
    dc_y_out[0] = y.x;
    dc_y_out[1] = y.y;
    const float2 x = load_iq<FMT>(wire, n - 1, inv_cu8);
    dc_x_out[0] = x.x;
    dc_x_out[1] = x.y;
  }
}

// Launches 1-3 for n input samples: ylocal/yend/carry are scratch, band the
// output planes [2][nb] with nb = 25 n / 128; kt the staged taps.
template <int FMT>
static int front_end_launch(const uint8_t* wire, long long n,
                            const float* dc_x, const float* dc_y,
                            const float* fhist, int H, const float* kt,
                            const float* pj, double p, double g, double pL,
                            float inv_cu8, float* ylocal, float* yend,
                            float* carry, float* band, cudaStream_t s) {
  const int chunks = (int)((n + DC_L - 1) / DC_L);
  const int res_frames = (int)(n / RES_M);
  const long long nb = (long long)res_frames * RES_L;
  const cudaError_t opened = rs_open(fe_resample);
  if (opened != cudaSuccess) return (int)opened;
  fe_dc_local<FMT><<<(chunks + DCL_THREADS - 1) / DCL_THREADS, DCL_THREADS,
                     0, s>>>(
      wire, n, dc_x, inv_cu8, p, g, ylocal, yend, chunks);
  SDR_CHECK_LAUNCH();
  dc_carry_kernel<<<2, CARRY_THREADS, 0, s>>>(yend, carry, dc_y, chunks, pL);
  SDR_CHECK_LAUNCH();
  fe_resample<<<(res_frames + RS_FB - 1) / RS_FB, RS_THREADS, RS_SMEM, s>>>(
      ylocal, carry, pj, fhist, H, n, chunks,
      reinterpret_cast<const float4*>(kt), band, nb, res_frames);
  SDR_CHECK_LAUNCH();
  return 0;
}
