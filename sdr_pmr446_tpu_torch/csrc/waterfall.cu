// K3: the waterfall's hop-PSD spectrogram on Hopper, as FFTs in shared
// memory.
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
// The plan (kernels/waterfall.py::make_plan, built in float64 on the host,
// O(M) tables on the device):
//   * every transform has a length M = 2^a 3^b 5^c 7^d, run as a Stockham
//     FFT (fft_block): a radix-2, 4 or 8 stage first when 2^a is not a
//     power of 16, then radix-16 stages, then radix 3, 5 and 7, a thread
//     taking up to 16 points of butterflies a stage (in registers: a 4 x 4
//     DFT for radix 16, the symmetric form for the odd radices).  The
//     first stage reads its points straight from their source (the
//     windowed band, or a four-step scratch row), the rest run between two
//     shared-memory buffers; the stage twiddles come from a table laid out
//     stage by stage, consecutive for neighbouring butterflies;
//   * a w that is a power of two, or a product of 2, 3, 5 and 7 up to
//     WF_CAP (80, 120, 200, 840), is one forward FFT of length M = w of the
//     windowed w/2 samples (the rest zero);
//   * any other w goes through Bluestein's chirp-z on M = the power of two
//     >= w/2 + w - 1: a = x * window * c (c_n = exp(-pi i n^2 / w)),
//     FFT(a) times the transformed chirp filter (divided by M), conjugated
//     (both in the FFT's last stage), and a second forward FFT gives
//     conj(S_f / c_f), so |S_f|^2 is its |.|^2 for f < w;
//   * M <= WF_CAP (4096 points): one block of max(M, WF_BATCH) / 16 threads
//     holds whole transforms (wf_hops).  It runs nt = max(1, WF_BATCH / M)
//     hops' FFTs at once and adds |S|^2 of a slab of consecutive hops of
//     one row in a fixed order, in shared memory, then writes its partial
//     [rows][slabs][w] (slabs sized to fill the card's resident blocks:
//     kernels/waterfall.py::slab_geometry);
//   * M > WF_CAP: the four-step split M = M1 * M2 (M1 = 2^floor(log2 M / 2))
//     through a device scratch of [hops][M] double2 a buffer: wf_cols runs
//     the M1-point column FFTs straight from the band and applies
//     W_M^(n2 k1); wf_rowfft runs the M2-point row FFTs.  For Bluestein the
//     first transform's row pass multiplies by the filter, conjugates and
//     runs the second transform's columns in the same block (its split is
//     M2 x M1), so Bluestein takes three launches and a direct transform two.
//     The last pass writes |S|^2 of each hop to its own partial row.
// Precision: samples are f32; the window (float64, not rounded to f32),
// the chirp, the filter, the twiddles and every FFT stage are double (an
// f32 direct DFT was 0.0146 dB from the float64 oracle at w = 8192, and at
// w = 78400, one hop a row reaching 136 dB below its peak, the f32-rounded
// window alone moves the oracle's rows by 0.0285 dB).
//
// wf_rows then adds a row's partials in order, divides by the row's hop
// count (computed from cnt, like the hop positions), takes
// 10*log10(max(p, 1e-30)) and writes the row fftshifted; its row-0 blocks
// also write the new history (the last w/2 of [hist | band]) and the new
// counter (cnt + nb) mod (w/4).  All launches are on the caller's stream,
// with no atomics (a call is bit-equal to itself), no allocation and no
// host read (the counter is read on the device).
//
// Shared memory a block: two buffers of nt*M double2 and the slab's w sums
// in wf_hops (64 KB + 8w up to M = 2048, 128 KB + 8w at 4096), two buffers
// of WF_BATCH points (64 KB) in the four-step passes, every index swizzled
// (sw) against bank conflicts.
// What bounds it on the H100: the function needs the band read once (8 B a
// sample) and 5 w log2(w) operations a hop; the kernel moves each point of
// each stage through shared memory (16 B each way) and does its butterflies
// in double (some 14 operations a point and radix-16 stage), so it is bound
// by shared-memory traffic, the double rate and its stage barriers, far
// above the function's bound; Bluestein widths pay for two transforms of
// M >= 1.5 w points.
#include "sdr_common.cuh"

#define WF_CAP 4096    // most points one block's transforms hold
#define WF_BATCH 2048  // points a block transforms at once below WF_CAP
#define WF_MID 1       // wf_rowfft modes
#define WF_FINAL 2

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

static __device__ __forceinline__ double2 cmul(double2 a, double2 b) {
  return make_double2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

static __device__ __forceinline__ double2 conj2(double2 a) {
  return make_double2(a.x, -a.y);
}

// Window point n of the hop whose window starts at xe[u]: pre[n] * xe[u + n]
// for n < w/2 (pre: the window, times the chirp for Bluestein), 0 beyond.
static __device__ __forceinline__ double2 window_point(
    const float* __restrict__ band, long long nb,
    const float2* __restrict__ hs, const double2* __restrict__ pre, int wl,
    long long u, int n) {
  if (n >= wl) return make_double2(0.0, 0.0);
  const long long e = u + n;
  double2 x;
  if (e < wl) {
    const float2 v = hs[e];
    x = make_double2(v.x, v.y);
  } else {
    x = make_double2(__ldg(band + e - wl), __ldg(band + nb + e - wl));
  }
  return cmul(__ldg(pre + n), x);
}

// Where point i of a shared-memory buffer is stored: its low three bits
// (the 16-byte bank group) XOR-ed with bits 3, 4 and 7, so that every
// stage's reads and writes, and the four-step passes' column accesses up to
// 128-point columns, hit the eight bank groups evenly (a permutation within
// each aligned group of eight points).
static __device__ __forceinline__ int sw(int i) {
  return i ^ (((i >> 3) ^ (i >> 4) ^ (i >> 7)) & 7);
}

// exp(-2 pi i k / 16); k is a constant wherever it is called (unrolled
// loops), so the switch folds away
static __device__ __forceinline__ double2 w16(int k) {
  const double c = 0.92387953251128674, d = 0.38268343236508978,
               h = 0.70710678118654752;
  switch (k & 15) {
    case 0: return make_double2(1, 0);
    case 1: return make_double2(c, -d);
    case 2: return make_double2(h, -h);
    case 3: return make_double2(d, -c);
    case 4: return make_double2(0, -1);
    case 5: return make_double2(-d, -c);
    case 6: return make_double2(-h, -h);
    case 7: return make_double2(-c, -d);
    case 8: return make_double2(-1, 0);
    case 9: return make_double2(-c, d);
    case 10: return make_double2(-h, h);
    case 11: return make_double2(-d, c);
    case 12: return make_double2(0, 1);
    case 13: return make_double2(d, c);
    case 14: return make_double2(h, h);
    default: return make_double2(c, d);
  }
}

// a0..a3 <- their 4-point DFT, y_s = sum_r a_r (-i)^(r s)
static __device__ __forceinline__ void dft4(double2& a0, double2& a1,
                                            double2& a2, double2& a3) {
  const double2 s02 = make_double2(a0.x + a2.x, a0.y + a2.y);
  const double2 d02 = make_double2(a0.x - a2.x, a0.y - a2.y);
  const double2 s13 = make_double2(a1.x + a3.x, a1.y + a3.y);
  const double2 d13 = make_double2(a1.x - a3.x, a1.y - a3.y);
  a0 = make_double2(s02.x + s13.x, s02.y + s13.y);
  a1 = make_double2(d02.x + d13.y, d02.y - d13.x);  // d02 - i d13
  a2 = make_double2(s02.x - s13.x, s02.y - s13.y);
  a3 = make_double2(d02.x - d13.y, d02.y + d13.x);  // d02 + i d13
}

// cos and sin of 2 pi m / R for the odd radices (m a constant wherever it
// is called, so the switches fold away)
template <int R>
static __device__ __forceinline__ double2 cis_odd(int m) {
  const int h = m <= R / 2 ? m : R - m;  // cos is even, sin odd in m
  double c, s;
  if (R == 3) {
    c = -0.5;
    s = 0.86602540378443864676;
  } else if (R == 5) {
    c = h == 1 ? 0.30901699437494742410 : -0.80901699437494742410;
    s = h == 1 ? 0.95105651629515357212 : 0.58778525229247312917;
  } else {
    c = h == 1 ? 0.62348980185873353053
      : h == 2 ? -0.22252093395631440429 : -0.90096886790241912624;
    s = h == 1 ? 0.78183148246802980871
      : h == 2 ? 0.97492791218182360702 : 0.43388373911755812048;
  }
  return make_double2(c, m <= R / 2 ? s : -s);
}

// Where dft<R> leaves output s: y_(s1 + 4 s2) in v[P s1 + s2], P = R / 4,
// for R = 4, 8, 16; in v[s] for R = 2, 3, 5, 7.
template <int R>
static __device__ __forceinline__ constexpr int dft_pos(int s) {
  return R % 4 != 0 ? s : (R / 4) * (s & 3) + (s >> 2);
}

// v <- its R-point DFT in registers (R = 2, 3, 4, 5, 7, 8, 16), in place.
// R = 4P: with r = r1 + P r2 and s = s1 + 4 s2, y_s = sum_r1 W_P^(r1 s2)
// W_R^(r1 s1) sum_r2 v_(r1 + P r2) W_4^(r2 s1).  Odd R: with
// a_r = v_r + v_(R-r) and b_r = v_r - v_(R-r), y_s = c_s - i d_s and
// y_(R-s) = c_s + i d_s, c_s = v_0 + sum_r a_r cos(2 pi r s / R),
// d_s = sum_r b_r sin(2 pi r s / R), r and s in [1, R/2].
template <int R>
static __device__ __forceinline__ void dft(double2* v) {
  if constexpr (R % 2 == 1) {
    constexpr int H = R / 2;
    double2 a[H], b[H], y0 = v[0];
#pragma unroll
    for (int r = 1; r <= H; ++r) {
      a[r - 1] = make_double2(v[r].x + v[R - r].x, v[r].y + v[R - r].y);
      b[r - 1] = make_double2(v[r].x - v[R - r].x, v[r].y - v[R - r].y);
      y0 = make_double2(y0.x + a[r - 1].x, y0.y + a[r - 1].y);
    }
    const double2 x0 = v[0];
#pragma unroll
    for (int q = 1; q <= H; ++q) {
      double2 c = x0, d = make_double2(0.0, 0.0);
#pragma unroll
      for (int r = 1; r <= H; ++r) {
        const double2 w = cis_odd<R>(r * q % R);
        c = make_double2(c.x + a[r - 1].x * w.x, c.y + a[r - 1].y * w.x);
        d = make_double2(d.x + b[r - 1].x * w.y, d.y + b[r - 1].y * w.y);
      }
      v[q] = make_double2(c.x + d.y, c.y - d.x);      // c - i d
      v[R - q] = make_double2(c.x - d.y, c.y + d.x);  // c + i d
    }
    v[0] = y0;
  } else if constexpr (R == 2) {
    const double2 a = v[0], b = v[1];
    v[0] = make_double2(a.x + b.x, a.y + b.y);
    v[1] = make_double2(a.x - b.x, a.y - b.y);
  } else {
    constexpr int P = R / 4;
    // columns: 4-point DFTs over r2, a_s1 into v[r1 + P s1], then turned
    // by W_R^(r1 s1)
#pragma unroll
    for (int r1 = 0; r1 < P; ++r1) {
      dft4(v[r1], v[r1 + P], v[r1 + 2 * P], v[r1 + 3 * P]);
#pragma unroll
      for (int s1 = 1; s1 < 4; ++s1)
        if (r1 != 0)
          v[r1 + P * s1] = cmul(v[r1 + P * s1], w16(r1 * s1 * (16 / R)));
    }
    // rows: P-point DFTs over r1 of v[P s1 .. P s1 + P)
#pragma unroll
    for (int s1 = 0; s1 < 4; ++s1) {
      if constexpr (P == 2) {
        const double2 a = v[2 * s1], b = v[2 * s1 + 1];
        v[2 * s1] = make_double2(a.x + b.x, a.y + b.y);
        v[2 * s1 + 1] = make_double2(a.x - b.x, a.y - b.y);
      } else if constexpr (P == 4) {
        dft4(v[4 * s1], v[4 * s1 + 1], v[4 * s1 + 2], v[4 * s1 + 3]);
      }
    }
  }
}

// Bluestein's pointwise step fused into the last stage of the first
// transform: output i of transform t becomes conj(y * filt[f0 + ft*t +
// fs*i]) (filt = nullptr: none).
struct Epilogue {
  const double2* filt;
  int f0, ft, fs;
};

// Where a stage reads point i of transform t: a shared-memory buffer of
// transforms ld points apart ...
struct SmemSrc {
  const double2* p;
  int ld;
  __device__ __forceinline__ double2 operator()(int t, int i) const {
    return p[sw(t * ld + i)];
  }
};

// ... the windowed band of the hop whose window starts at xe[u0 + t*delay]
// (wf_hops: transform t is that hop; point i is window point i) ...
struct HopSrc {
  const float* band;
  long long nb;
  const float2* hs;
  const double2* pre;
  int wl, delay;
  long long u0;
  __device__ __forceinline__ double2 operator()(int t, int i) const {
    return window_point(band, nb, hs, pre, wl, u0 + (long long)t * delay, i);
  }
};

// ... the windowed band of one hop read as columns (wf_cols: point i of
// column c0 + t is window point i*M2 + c0 + t) ...
struct ColSrc {
  const float* band;
  long long nb;
  const float2* hs;
  const double2* pre;
  int wl, M2, c0;
  long long u;
  __device__ __forceinline__ double2 operator()(int t, int i) const {
    return window_point(band, nb, hs, pre, wl, u, i * M2 + c0 + t);
  }
};

// ... or rows of a device scratch (wf_rowfft).
struct RowSrc {
  const double2* p;
  int L;
  __device__ __forceinline__ double2 operator()(int t, int i) const {
    return __ldg(p + t * L + i);
  }
};

// One Stockham stage of radix R over nt transforms of length L, by a block
// of CAP / 16 threads, from src into the shared-memory buffer dst (transform
// t at t*ld, addressed through sw); Ns = the product of the earlier radices.
// Butterfly j of a transform reads points j + r*L/R, turns point r by
// W_(Ns R)^(r (j mod Ns)) = stw[(r - 1)*Ns + j mod Ns] (the stage's slice
// of the plan's stage twiddles, consecutive in j; all 1 when Ns = 1),
// takes their R-point DFT in registers and writes output r to
// (j - j mod Ns)*R + j mod Ns + r*Ns, through the epilogue ep when it has a
// filter.  Ends with a barrier.
template <int R, int CAP, class Src>
static __device__ __forceinline__ void fft_stage(
    const Src& src, double2* __restrict__ dst, int L, int nt, int ld, int Ns,
    const double2* __restrict__ stw, Epilogue ep) {
  constexpr int T = CAP / 16, IT = (16 + R - 1) / R;
  const int q = L / R, n = nt * q;
#pragma unroll
  for (int it = 0; it < IT; ++it) {
    const int idx = threadIdx.x + it * T;
    if (idx < n) {
      const int t = idx / q, j = idx - t * q, k = j % Ns;
      double2 v[R];
#pragma unroll
      for (int r = 0; r < R; ++r) v[r] = src(t, j + r * q);
      if (Ns > 1) {
#pragma unroll
        for (int r = 1; r < R; ++r)
          v[r] = cmul(v[r], __ldg(stw + (r - 1) * Ns + k));
      }
      dft<R>(v);
      const int i0 = (j - k) * R + k;  // output 0's place in transform t
#pragma unroll
      for (int r = 0; r < R; ++r) {
        double2 y = v[dft_pos<R>(r)];
        if (ep.filt != nullptr)
          y = conj2(cmul(
              y, __ldg(ep.filt + ep.f0 + ep.ft * t + ep.fs * (i0 + r * Ns))));
        dst[sw(t * ld + i0 + r * Ns)] = y;
      }
    }
  }
  __syncthreads();
}

// The next radix of a transform whose length still holds 2^e2 and odd (a
// product of 3, 5 and 7): 2^(e2 mod 4) first unless that is 1, then 16s,
// then 3s, 5s and 7s (kernels/waterfall.py::radices).
static __device__ __forceinline__ int next_radix(int& e2, int& odd) {
  if (e2 % 4 != 0) {
    const int r = 1 << (e2 % 4);
    e2 -= e2 % 4;
    return r;
  }
  if (e2 > 0) {
    e2 -= 4;
    return 16;
  }
  const int r = odd % 3 == 0 ? 3 : odd % 5 == 0 ? 5 : 7;
  odd /= r;
  return r;
}

template <int CAP, class Src>
static __device__ __forceinline__ void run_stage(
    int R, const Src& src, double2* dst, int L, int nt, int ld, int Ns,
    const double2* stw, Epilogue ep) {
  switch (R) {
    case 2: fft_stage<2, CAP>(src, dst, L, nt, ld, Ns, stw, ep); break;
    case 3: fft_stage<3, CAP>(src, dst, L, nt, ld, Ns, stw, ep); break;
    case 4: fft_stage<4, CAP>(src, dst, L, nt, ld, Ns, stw, ep); break;
    case 5: fft_stage<5, CAP>(src, dst, L, nt, ld, Ns, stw, ep); break;
    case 7: fft_stage<7, CAP>(src, dst, L, nt, ld, Ns, stw, ep); break;
    case 8: fft_stage<8, CAP>(src, dst, L, nt, ld, Ns, stw, ep); break;
    default: fft_stage<16, CAP>(src, dst, L, nt, ld, Ns, stw, ep); break;
  }
}

// nt forward FFTs of length L (2^a 3^b 5^c 7^d >= 8, nt*L <= CAP) by CAP /
// 16 threads, natural order in and out: the first stage reads src, the
// rest run between the shared-memory buffers a and b (transforms ld points
// apart), radices in next_radix's order.  stw: the L - 1 stage twiddles of
// length L (kernels/waterfall.py::stage_twiddles), stage after stage; ep:
// applied by the last stage.  Returns the buffer that holds the result;
// ends with a barrier.
template <int CAP, class Src>
static __device__ __forceinline__ double2* fft_block(
    const Src& src, double2* a, double2* b, int L, int nt, int ld,
    const double2* __restrict__ stw, Epilogue ep = {nullptr, 0, 0, 0}) {
  const Epilogue none = {nullptr, 0, 0, 0};
  int e2 = __ffs(L) - 1, odd = L >> e2;
  int R = next_radix(e2, odd);
  run_stage<CAP>(R, src, a, L, nt, ld, 1, stw, R == L ? ep : none);
  stw += R - 1;
  for (int Ns = R; Ns < L; Ns *= R) {
    R = next_radix(e2, odd);
    run_stage<CAP>(R, SmemSrc{a, ld}, b, L, nt, ld, Ns, stw,
                   Ns * R == L ? ep : none);
    stw += (R - 1) * Ns;
    double2* c = a;
    a = b;
    b = c;
  }
  return a;
}

// M <= WF_CAP: one block of CAP / 16 threads per (slab of consecutive
// hops, row), nt hops at a time (nt*M <= CAP = max(M, WF_BATCH)); |S|^2
// summed over the slab's hops in order into its partial row.
template <int CAP>
static __global__ void __launch_bounds__(CAP / 16, CAP == WF_BATCH ? 3 : 1)
    wf_hops(const float* __restrict__ band, long long nb,
            const float2* __restrict__ hist, int hist_len,
            const int* __restrict__ cnt, const double2* __restrict__ pre,
            const double2* __restrict__ filt, const double2* __restrict__ tw,
            int w, int M, int sub, int nt, int slab_hops,
            double* __restrict__ part) {
  extern __shared__ double2 smem[];  // two buffers of [nt][M], then acc
  constexpr int T = CAP / 16;
  const int wl = w / 2, delay = w / 4;
  const int row = blockIdx.y, slab = blockIdx.x;
  const long long u0 = first_fire(cnt, delay);
  long long lo, hi;
  row_hops(row, sub, u0, delay, &lo, &hi);
  const long long a = lo + (long long)slab * slab_hops;
  const long long b = min(a + slab_hops, hi + 1);
  if (b <= a) return;  // a slab past the row's hops: never read
  const int nh = (int)(b - a);
  const int span = (nt * M + 7) & ~7;  // a buffer, whole groups of sw
  double2* const buf0 = smem;
  double2* const buf1 = smem + span;
  double* const acc = (double*)(smem + 2 * span);  // [w] the slab's sums
  for (int h0 = 0; h0 < nh; h0 += nt) {
    const int m = min(nt, nh - h0);
    const HopSrc src{band, nb, hist + (hist_len - wl), pre, wl, delay,
                     u0 + (a + h0) * delay};
    // Bluestein: FFT, times the filter and conjugated, FFT again
    double2* y = fft_block<CAP>(src, buf0, buf1, M, m, M, tw,
                                {filt, 0, 0, 1});
    if (filt != nullptr)
      y = fft_block<CAP>(SmemSrc{y, M}, y == buf0 ? buf1 : buf0,
                         y, M, m, M, tw);
    for (int f = threadIdx.x; f < w; f += T) {
      double s = 0.0;
      for (int t = 0; t < m; ++t) {
        const double2 v = y[sw(t * M + f)];
        s += v.x * v.x + v.y * v.y;
      }
      acc[f] = h0 == 0 ? s : acc[f] + s;
    }
    __syncthreads();
  }
  double* out = part + ((long long)row * gridDim.x + slab) * w;
  for (int f = threadIdx.x; f < w; f += T) out[f] = acc[f];
}

// Four-step pass over columns: for hop blockIdx.y, columns n2 in
// [c0, c0 + nt) of x[M2*n1 + n2] (the windowed band), M1-point FFTs along
// n1, times W_M^(n2 k1), stored as rows T[k1][n2].
static __global__ void __launch_bounds__(WF_BATCH / 16)
    wf_cols(const float* __restrict__ band, long long nb,
            const float2* __restrict__ hist, int hist_len,
            const int* __restrict__ cnt, const double2* __restrict__ pre,
            const double2* __restrict__ tw, int w, int M, int M1, int nt,
            double2* __restrict__ T) {
  extern __shared__ double2 smem[];  // two buffers of [nt][M1]
  const int wl = w / 2, delay = w / 4, M2 = M / M1;
  const long long u = first_fire(cnt, delay) + (long long)blockIdx.y * delay;
  if (u > nb) return;  // no such hop in this block
  const int c0 = blockIdx.x * nt, m = min(nt, M2 - c0);
  const ColSrc src{band, nb, hist + (hist_len - wl), pre, wl, M2, c0, u};
  const double2* y =
      fft_block<WF_BATCH>(src, smem, smem + nt * M1, M1, m, M1, tw);
  const double2* wm = tw + (M1 - 1) + (M2 - 1);  // W_M^t
  double2* dst = T + (long long)blockIdx.y * M;
  for (int idx = threadIdx.x; idx < m * M1; idx += WF_BATCH / 16) {
    const int k1 = idx / m, t = idx - k1 * m, c = c0 + t;
    dst[k1 * M2 + c] = cmul(y[sw(t * M1 + k1)], __ldg(wm + c * k1));
  }
}

// Four-step pass over rows: for hop blockIdx.y, rows rho in [r0, r0 + nt)
// of U [Rn][L], L-point FFTs along each row; output point i of row rho is
// index rho + Rn*i of the whole transform.
//   WF_MID (Bluestein, U = the first transform's T, Rn = M1, L = M2): times
//     the filter, conjugated (in the FFT's last stage); these are the
//     second transform's columns (split M2 x M1), so a second L-point FFT,
//     times W_M^(rho i), stored as rows U2[i][rho] of length Rn.
//   WF_FINAL: |.|^2 of point f = rho + Rn*i < w into the hop's partial row.
static __global__ void __launch_bounds__(WF_BATCH / 16)
    wf_rowfft(const double2* __restrict__ U, double2* __restrict__ U2,
              const double2* __restrict__ filt,
              const double2* __restrict__ tw, long long nb,
              const int* __restrict__ cnt, int w, int M, int M1, int Rn,
              int nt, int sub, int slabs, int mode,
              double* __restrict__ part) {
  extern __shared__ double2 smem[];  // two buffers of [nt][L]
  const int delay = w / 4, L = M / Rn;
  const double2* stw = L == M1 ? tw : tw + (M1 - 1);
  const double2* wm = tw + (M1 - 1) + (M / M1 - 1);  // W_M^t
  const long long u0 = first_fire(cnt, delay);
  const long long u = u0 + (long long)blockIdx.y * delay;
  if (u > nb) return;
  const int r0 = blockIdx.x * nt, m = min(nt, Rn - r0);
  const RowSrc src{U + (long long)blockIdx.y * M + (long long)r0 * L, L};
  double2* const buf0 = smem;
  double2* const buf1 = smem + nt * L;
  const Epilogue ep = {mode == WF_MID ? filt : nullptr, r0, 1, Rn};
  double2* y = fft_block<WF_BATCH>(src, buf0, buf1, L, m, L, stw, ep);
  if (mode == WF_MID) {
    y = fft_block<WF_BATCH>(SmemSrc{y, L}, y == buf0 ? buf1 : buf0, y, L, m,
                            L, stw);
    double2* dst = U2 + (long long)blockIdx.y * M;
    for (int idx = threadIdx.x; idx < m * L; idx += WF_BATCH / 16) {
      const int i = idx / m, t = idx - i * m, rho = r0 + t;
      dst[i * Rn + rho] = cmul(y[sw(t * L + i)], __ldg(wm + rho * i));
    }
    return;
  }
  const long long row = (u - 1) / sub;
  long long lo, hi;
  row_hops(row, sub, u0, delay, &lo, &hi);
  double* out = part + (row * slabs + ((long long)blockIdx.y - lo)) * w;
  for (int idx = threadIdx.x; idx < m * L; idx += WF_BATCH / 16) {
    const int i = idx / m, t = idx - i * m, f = r0 + t + Rn * i;
    if (f < w) {
      const double2 v = y[sw(t * L + i)];
      out[f] = v.x * v.x + v.y * v.y;
    }
  }
}

// Rows in dB, fftshifted, from the partials of the row's slabs with hops:
// block (x, row) writes bins [x*256, x*256 + 256) of the row; the blocks of
// row 0 also write the carried state.
static __global__ void wf_rows(const double* __restrict__ part, int slabs,
                               int slab_hops, const float* __restrict__ band,
                               long long nb, const float2* __restrict__ hist,
                               int hist_len, const int* __restrict__ cnt,
                               int w, int sub, float* __restrict__ rows,
                               float2* __restrict__ hist_out,
                               int* __restrict__ cnt_out) {
  const int wl = w / 2, delay = w / 4;
  const int row = blockIdx.y;
  const long long u0 = first_fire(cnt, delay);
  long long lo, hi;
  row_hops(row, sub, u0, delay, &lo, &hi);
  const long long n_row = hi - lo + 1;
  const int used = (int)((n_row + slab_hops - 1) / slab_hops);
  const double* p = part + (long long)row * slabs * w;
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  if (f < w) {
    double s = 0.0;
    for (int sl = 0; sl < used; ++sl) s += p[(long long)sl * w + f];
    const double avg = s / (double)n_row;
    rows[(long long)row * w + (f + wl) % w] =
        (float)(10.0 * log10(fmax(avg, 1e-30)));
  }
  if (row != 0) return;
  const float2* hs = hist + (hist_len - wl);
  for (int m = f; m < wl; m += gridDim.x * blockDim.x) {
    const long long e = nb + m;  // index into xe = [hist (wl) | band (nb)]
    hist_out[m] = e < wl ? hs[e]
                         : make_float2(band[e - wl], band[nb + e - wl]);
  }
  if (f == 0) cnt_out[0] = (int)((delay - u0 + nb) % delay);
}

static bool pow2(long long x) { return x > 0 && (x & (x - 1)) == 0; }

// A product of 2, 3, 5 and 7 only: a length fft_block runs directly.
static bool smooth(long long x) {
  const int primes[4] = {2, 3, 5, 7};
  for (int p : primes)
    while (x > 1 && x % p == 0) x /= p;
  return x == 1;
}

// Transforms of length L a four-step block runs at once.
static int batch(int L) { return L >= WF_BATCH ? 1 : WF_BATCH / L; }

typedef void (*HopsKernel)(const float*, long long, const float2*, int,
                           const int*, const double2*, const double2*,
                           const double2*, int, int, int, int, int, double*);

// The wf_hops instance for M-point transforms and its block size.
static HopsKernel hops_kernel(int M, int* threads) {
  if (M <= WF_BATCH) {
    *threads = WF_BATCH / 16;
    return wf_hops<WF_BATCH>;
  }
  *threads = WF_CAP / 16;
  return wf_hops<WF_CAP>;
}

// wf_hops' shared memory: two buffers of nt*M points (rounded up to whole
// groups of eight, which sw permutes) and the slab's sums.
static size_t hops_smem(int M, int nt, int w) {
  return 2 * (((size_t)nt * M + 7) & ~(size_t)7) * sizeof(double2) +
         (size_t)w * sizeof(double);
}

static bool hops_args_ok(int M, int nt) {
  return smooth(M) && M >= 8 && M <= WF_CAP && nt > 0 &&
         (long long)nt * M <= (M > WF_BATCH ? M : WF_BATCH);
}

// Blocks of the wf_hops launch for M-point transforms, nt at a time, that
// one SM holds at once (kernels/waterfall.py::slab_geometry).
extern "C" int wf_blocks_per_sm(int w, int M, int nt, int* blocks) {
  if (!hops_args_ok(M, nt) || w <= 0 || w > M)
    return (int)cudaErrorInvalidValue;
  int threads;
  const HopsKernel kernel = hops_kernel(M, &threads);
  const size_t smem = hops_smem(M, nt, w);
  cudaError_t e = allow_smem(kernel, smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                      threads, smem);
  return (int)e;
}

// M: the transform length; M1 = 0 for wf_hops, else the four-step split;
// filt = nullptr when M == w (no Bluestein); nt, slab_hops, slabs: the
// partials' geometry (kernels/waterfall.py::slab_geometry); scratch: one
// (two for Bluestein) [nb / (w/4) + 1][M] double2 buffers for the four-step
// split.
extern "C" int wf_run(const void* band, long long nb, const void* hist,
                      int hist_len, const void* cnt, const void* pre,
                      const void* filt, const void* tw, int w, int K, int sub,
                      int M, int M1, int nt, int slab_hops, int slabs,
                      void* scratch, void* part, void* rows, void* hist_out,
                      void* cnt_out, void* stream) {
  const int wl = w / 2, delay = w / 4;
  const long long max_row_hops = sub / delay + 1;
  const bool blue = filt != nullptr;
  if (w < 8 || w % 4 != 0 || delay > sub || K <= 0 || K > 65535 ||
      nb != (long long)K * sub || hist_len < wl ||
      (blue ? !pow2(M) || M < w + wl - 1 : M != w) || slab_hops <= 0 ||
      (long long)slabs * slab_hops < max_row_hops)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const double2* tw2 = (const double2*)tw;
  if (M1 == 0) {
    if (!hops_args_ok(M, nt)) return (int)cudaErrorInvalidValue;
    int threads;
    const HopsKernel kernel = hops_kernel(M, &threads);
    const size_t smem = hops_smem(M, nt, w);
    const cudaError_t e = allow_smem(kernel, smem);
    if (e != cudaSuccess) return (int)e;
    kernel<<<dim3(slabs, K), threads, smem, s>>>(
        (const float*)band, nb, (const float2*)hist, hist_len,
        (const int*)cnt, (const double2*)pre, (const double2*)filt, tw2, w,
        M, sub, nt, slab_hops, (double*)part);
    SDR_CHECK_LAUNCH();
  } else {
    const int M2 = M / M1;
    const long long hops = nb / delay + 1;
    if (M <= WF_CAP || !pow2(M) || !pow2(M1) || M1 > WF_BATCH ||
        M2 > WF_BATCH ||
        M2 < M1 || slab_hops != 1 || hops > 65535)
      return (int)cudaErrorInvalidValue;
    double2* T = (double2*)scratch;
    double2* T2 = T + hops * M;
    const int nc = batch(M1), nr = batch(M2);
    const size_t smem_c = 2 * (size_t)nc * M1 * sizeof(double2);
    const size_t smem_r = 2 * (size_t)nr * M2 * sizeof(double2);
    cudaError_t e = allow_smem(wf_cols, smem_c);
    if (e == cudaSuccess)
      e = allow_smem(wf_rowfft, smem_c > smem_r ? smem_c : smem_r);
    if (e != cudaSuccess) return (int)e;
    wf_cols<<<dim3((M2 + nc - 1) / nc, hops), WF_BATCH / 16, smem_c, s>>>(
        (const float*)band, nb, (const float2*)hist, hist_len,
        (const int*)cnt, (const double2*)pre, tw2, w, M, M1, nc, T);
    SDR_CHECK_LAUNCH();
    // rows of T: M1 rows of M2 points
    wf_rowfft<<<dim3((M1 + nr - 1) / nr, hops), WF_BATCH / 16, smem_r, s>>>(
        T, T2, (const double2*)filt, tw2, nb, (const int*)cnt, w, M, M1, M1,
        nr, sub, slabs, blue ? WF_MID : WF_FINAL, (double*)part);
    SDR_CHECK_LAUNCH();
    if (blue) {
      // rows of T2: M2 rows of M1 points
      wf_rowfft<<<dim3((M2 + nc - 1) / nc, hops), WF_BATCH / 16, smem_c,
                  s>>>(T2, nullptr, nullptr, tw2, nb, (const int*)cnt, w, M,
                       M1, M2, nc, sub, slabs, WF_FINAL, (double*)part);
      SDR_CHECK_LAUNCH();
    }
  }
  wf_rows<<<dim3((w + 255) / 256, K), 256, 0, s>>>(
      (const double*)part, slabs, slab_hops, (const float*)band, nb,
      (const float2*)hist, hist_len, (const int*)cnt, w, sub, (float*)rows,
      (float2*)hist_out, (int*)cnt_out);
  SDR_CHECK_LAUNCH();
  return 0;
}
