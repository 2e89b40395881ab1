// K10: the read-only zero-state DC summary of the time-sharded pre-pass on
// Hopper — per 128-sample row of the wire, both planes:
//   w[r]  = sum_j v[j] * x[r*128 + j]   (v = fused_halo.dc_row_weights)
//   xl[r] = x[r*128 + 127]
//
// Replaces sdr_pmr446_tpu/kernels/summary.py::zero_summary_wire (bodies
// _body_ilv, _body_cs16, _body_pk2 and their selector matrices, _consts).
// What it computes is documented beside its plain PyTorch version,
// kernels/summary.py.
//
// What bounds it on the H100: bytes.  The wire is read once (2-8 B a
// sample), 16 B leave per 128 samples, ~4 operations a sample: one
// config-5 step (4 streams x 40 sub-chunks, cu8) is 32.1 MB in, 2.0 MB
// out, 0.0102 ms at 3.35 TB/s.  So the kernel streams the wire:
//   - one launch for the whole step (every stream and time shard: a row
//     never straddles a shard), a persistent grid of (SMs x resident
//     blocks) that strides over groups of rows (a block a group took
//     0.0152 against 0.0145 ms);
//   - each lane reads 16 B at a time with a streaming load (__ldcs), its
//     lanes on consecutive 16-B pieces of a row: cu8 / cs8 16 lanes a row
//     (8 samples a lane, a warp on two rows), cs16 32 lanes (4 samples),
//     cf32 32 lanes with two loads (samples 2l, 2l + 1 and 64 + 2l,
//     65 + 2l); a lane takes ZS_LOADS pieces of a group of rows (ZS_LOADS
//     / pieces-a-row rows), and the next group's pieces load while one
//     group is summed (two register buffers: 2 x ZS_LOADS loads in
//     flight; right after the wire's upload, with part of it in L2, this
//     took 0.0126 against 0.0137 ms);
//   - a lane covers the same positions of every row, so its weights v[.]
//     sit in registers for the kernel's life: no shared copy of v, no
//     barrier before the first load;
//   - the decode is front_end.cuh's dec_* (load_iq's expressions) on each
//     byte or short's exact float value, built by __byte_perm under the
//     exponent of 2^23 (an integer-to-float conversion issues at a quarter
//     of the FP32 rate: the 32 M of a step would keep that pipe ~8 us of a
//     ~14 us pass; with them the pass took 0.0146-0.0147 against
//     0.0142-0.0143 ms), so xl is bit-equal to the plain version and to
//     K1's and K4's decode;
//   - a block gathers its group's w and xl (4 floats a row) in shared
//     memory (double-buffered: one barrier a group) and writes each plane
//     as one coalesced run.
// (Times: kernel_times.py, one config-5 step's cu8 wire, on an H100 80GB
// HBM3 at 700 W.)
// The summation order is fixed, so every call is bit-equal to the last:
// each lane runs fmaf over its samples in ascending order from 0 (both
// planes), then a shuffle-down tree over the row's lanes (offsets
// lanes/2, ..., 1; the row's first lane keeps the sum); no atomics.  The
// TPU kernel's MXU selector matmuls (no lane slices at odd offsets) have
// no counterpart.
//
// The wire must start on a 16-byte boundary (the entry point returns
// cudaErrorInvalidValue otherwise; rows are 256-1024 B, so every row then
// does).  kernels/summary.py checks it first; its caller,
// parallel/fused_halo.py::front_zero_summary_wire, passes the step's whole
// wire, an allocation of its own.
#include "front_end.cuh"

#define ZS_ROW 128
#define ZS_THREADS 256
#define ZS_LOADS 4          // 16-byte loads of a lane in flight a group

// Row geometry of a format.
template <int FMT>
struct ZsGeom {
  static constexpr int BPS = FMT == FMT_CF32 ? 8 : FMT == FMT_CS16 ? 4 : 2;
  static constexpr int ROW_BYTES = ZS_ROW * BPS;
  static constexpr int SPL = 16 / BPS;                   // samples a load
  static constexpr int LPR = ROW_BYTES / 16 < 32 ? ROW_BYTES / 16 : 32;
  static constexpr int LDS = ROW_BYTES / 16 / LPR;       // loads a row
  static constexpr int RPI = 32 / LPR;                   // rows a warp load
  static constexpr int U = ZS_LOADS / LDS;               // row steps a group
  static constexpr int RPW = RPI * U;                    // rows a warp
  static constexpr int RPB = ZS_THREADS / 32 * RPW;      // rows a block
};

// The integer in the bytes of w that selector sel (__byte_perm) puts under
// the exponent of 2^23, as a float: exact (it is below 2^23), and three
// full-rate operations where an integer-to-float conversion is a
// quarter-rate one.  ``bias`` is 2^23 plus the offset a sign flip added.
static __device__ __forceinline__ float int_bits_as_float(unsigned w,
                                                          unsigned sel,
                                                          float bias) {
  return __uint_as_float(__byte_perm(w, 0x4B000000u, sel)) - bias;
}

// The SPL samples of one 16-byte piece, decoded: each byte or short's
// integer value as an exact float (int_bits_as_float), then front_end.cuh's
// dec_*, load_iq's expressions.
template <int FMT>
static __device__ __forceinline__ void zs_decode(
    uint4 d, float inv_cu8, float2 (&x)[ZsGeom<FMT>::SPL]) {
  const unsigned wd[4] = {d.x, d.y, d.z, d.w};
  constexpr float U8 = 8388608.0f;           // 2^23
  constexpr float S8 = 8388608.0f + 128.0f;  // after b ^ 0x80
  constexpr float S16 = 8388608.0f + 32768.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    // selector 0x744k: byte k of the word, then 0, 0, 0x4B; 0x7410 /
    // 0x7432: the low / high short, then 0, 0x4B
    if constexpr (FMT == FMT_CU8) {  // bytes I, Q, I, Q
      const unsigned u = wd[k];
      x[2 * k] = make_float2(dec_cu8(int_bits_as_float(u, 0x7440, U8), inv_cu8),
                             dec_cu8(int_bits_as_float(u, 0x7441, U8), inv_cu8));
      x[2 * k + 1] =
          make_float2(dec_cu8(int_bits_as_float(u, 0x7442, U8), inv_cu8),
                      dec_cu8(int_bits_as_float(u, 0x7443, U8), inv_cu8));
    } else if constexpr (FMT == FMT_CS8) {  // the same bytes, signed
      const unsigned u = wd[k] ^ 0x80808080u;
      x[2 * k] = make_float2(dec_cs8(int_bits_as_float(u, 0x7440, S8)),
                             dec_cs8(int_bits_as_float(u, 0x7441, S8)));
      x[2 * k + 1] = make_float2(dec_cs8(int_bits_as_float(u, 0x7442, S8)),
                                 dec_cs8(int_bits_as_float(u, 0x7443, S8)));
    } else if constexpr (FMT == FMT_CS16) {  // shorts I, Q: a sample a word
      const unsigned u = wd[k] ^ 0x80008000u;
      x[k] = make_float2(dec_cs16(int_bits_as_float(u, 0x7410, S16)),
                         dec_cs16(int_bits_as_float(u, 0x7432, S16)));
    } else {  // cf32: two samples a piece
      if (k < 2)
        x[k] = make_float2(__uint_as_float(wd[2 * k]),
                           __uint_as_float(wd[2 * k + 1]));
    }
  }
}

template <int FMT>
static __global__ void __launch_bounds__(ZS_THREADS)
zs_rows(const uint8_t* __restrict__ wire, long long rows,
        const float* __restrict__ v, float inv_cu8, float* __restrict__ w,
        float* __restrict__ xl) {
  using G = ZsGeom<FMT>;
  __shared__ float sm[2][4][G::RPB];  // w re, w im, xl re, xl im
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int li = lane % G::LPR;       // lane within its row
  const int h = lane / G::LPR;        // which row of a warp load
  // piece j of a row, lane li: samples (j * LPR + li) * SPL + k
  float wv[G::LDS][G::SPL];
#pragma unroll
  for (int j = 0; j < G::LDS; ++j)
#pragma unroll
    for (int k = 0; k < G::SPL; ++k)
      wv[j][k] = v[(j * G::LPR + li) * G::SPL + k];
  const long long groups = (rows + G::RPB - 1) / G::RPB;
  const int lr0 = warp * G::RPW + h;  // this lane's first row in a group
  // this lane's pieces of group g (zeros past the last row)
  auto load = [&](uint4 (&d)[G::U][G::LDS], long long g) {
#pragma unroll
    for (int u = 0; u < G::U; ++u) {
      const long long r = g * G::RPB + lr0 + u * G::RPI;
      const uint4* row =
          reinterpret_cast<const uint4*>(wire + r * G::ROW_BYTES);
#pragma unroll
      for (int j = 0; j < G::LDS; ++j)
        d[u][j] = r < rows ? __ldcs(row + j * G::LPR + li)
                           : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  // group g's rows from its pieces d: the lanes' sums and the tree into
  // shared buffer b, then the group's w and xl out as four runs
  auto emit = [&](const uint4 (&d)[G::U][G::LDS], long long g, int b) {
#pragma unroll
    for (int u = 0; u < G::U; ++u) {
      float sr = 0.f, si = 0.f;
      float2 x[G::SPL];
#pragma unroll
      for (int j = 0; j < G::LDS; ++j) {
        zs_decode<FMT>(d[u][j], inv_cu8, x);
#pragma unroll
        for (int k = 0; k < G::SPL; ++k) {
          sr = fmaf(wv[j][k], x[k].x, sr);
          si = fmaf(wv[j][k], x[k].y, si);
        }
      }
#pragma unroll
      for (int off = G::LPR / 2; off > 0; off >>= 1) {
        sr += __shfl_down_sync(0xffffffffu, sr, off, G::LPR);
        si += __shfl_down_sync(0xffffffffu, si, off, G::LPR);
      }
      const int lr = lr0 + u * G::RPI;
      if (li == 0) {
        sm[b][0][lr] = sr;
        sm[b][1][lr] = si;
      }
      if (li == G::LPR - 1) {  // its last sample is 127
        sm[b][2][lr] = x[G::SPL - 1].x;
        sm[b][3][lr] = x[G::SPL - 1].y;
      }
    }
    __syncthreads();  // (the other buffer's readers are past it too)
    const long long base = g * G::RPB;
    for (int i = threadIdx.x; i < 4 * G::RPB; i += ZS_THREADS) {
      const int q = i / G::RPB, lr = i % G::RPB;
      if (base + lr < rows)
        (q < 2 ? w : xl)[(q & 1) * rows + base + lr] = sm[b][q][lr];
    }
  };
  // two groups in flight: the next one's pieces load while one is summed
  const long long step = gridDim.x;
  uint4 da[G::U][G::LDS], db[G::U][G::LDS];
  load(da, blockIdx.x);
  for (long long g = blockIdx.x; g < groups; g += 2 * step) {
    load(db, g + step);
    emit(da, g, 0);
    if (g + step >= groups) break;
    load(da, g + 2 * step);
    emit(db, g + step, 1);
  }
}

template <int FMT>
static int zs_launch(const uint8_t* wire, long long rows, const float* v,
                     float inv_cu8, float* w, float* xl, cudaStream_t s) {
  using G = ZsGeom<FMT>;
  static int resident = 0, resident_dev = -1;  // blocks the card holds
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev != resident_dev) {
    int sms, per_sm;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, zs_rows<FMT>,
                                                        ZS_THREADS, 0);
    if (e != cudaSuccess) return (int)e;
    resident = sms * per_sm;
    resident_dev = dev;
  }
  const long long groups = (rows + G::RPB - 1) / G::RPB;
  const int grid = (int)(groups < resident ? groups : resident);
  zs_rows<FMT><<<grid, ZS_THREADS, 0, s>>>(wire, rows, v, inv_cu8, w, xl);
  SDR_CHECK_LAUNCH();
  return 0;
}

// wire: n samples of format fmt, 16-byte aligned; w, xl: [2][n / 128] f32
// (re plane, then im)
extern "C" int zero_summary_run(int fmt, const void* wire, long long n,
                                const void* v, float inv_cu8, void* w,
                                void* xl, void* stream) {
  if (n <= 0 || n % ZS_ROW != 0 || ((uintptr_t)wire & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const long long rows = n / ZS_ROW;
#define SDR_ZS_ARGS                                                     \
  (const uint8_t*)wire, rows, (const float*)v, inv_cu8, (float*)w,     \
      (float*)xl, (cudaStream_t)stream
  switch (fmt) {
    case FMT_CU8: return zs_launch<FMT_CU8>(SDR_ZS_ARGS);
    case FMT_CS8: return zs_launch<FMT_CS8>(SDR_ZS_ARGS);
    case FMT_CS16: return zs_launch<FMT_CS16>(SDR_ZS_ARGS);
    case FMT_CF32: return zs_launch<FMT_CF32>(SDR_ZS_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef SDR_ZS_ARGS
}
