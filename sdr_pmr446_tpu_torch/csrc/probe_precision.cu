// K12b: the f32 contraction-precision probe on Hopper — out = a @ b for
// a f32 [M, K] and b f32 [K, N] (both row-major), at one of three
// contraction precisions:
//   mode 0, ffma:   fmaf over k in order for each output, on the CUDA cores
//                   (true f32; the TPU's Precision.HIGHEST result);
//   mode 1, tf32:   one tensor-core pass, wgmma m64n16k8 .tf32 on inputs
//                   rounded by cvt.rna.tf32.f32 (10 mantissa bits, nearest,
//                   ties away) — the counterpart of the TPU's default
//                   one-pass bf16 contraction;
//   mode 2, 3xtf32: each input split into hi = tf32(x) and lo = tf32(x -
//                   hi), three wgmma a k-step (lo*hi, hi*lo, hi*hi) into
//                   one f32 accumulator — the counterpart of HIGHEST's
//                   multi-pass product, and the way a tensor-core redesign
//                   of the FIR and resampler loops keeps true-f32 accuracy.
//
// Replaces tools/probe_precision.py::_probe_one's Pallas body (a
// dot_general at default or HIGHEST precision, its pallas_call at :58).
// What it computes is documented beside its plain PyTorch versions,
// kernels/probe_precision.py.
//
// What bounds it on the H100: the probe is 8.4 MFLOP over 320 KB, under
// 0.13 us of either, so every mode is launch and latency bound: a block's
// time is its operands' trip into shared memory plus its chain of
// dependent products.  The design keeps both short:
//   - tensor-core modes (probe_wgmma): a cluster of TC_SPLIT blocks owns a
//     64 x TC_N output tile (64 blocks for [128, 128]); block r of the
//     cluster takes the r-th K / TC_SPLIT slice of the depth, so each
//     stages 16 KB of A and 4 KB of B, not 80 KB, and chains K / 8 /
//     TC_SPLIT k-steps.  A's slice goes in by 16-byte cp.async into padded
//     rows (A_LD: the fragment loads hit 32 distinct banks).  B is N-major
//     in device memory, and .tf32 wgmma reads only K-major operands from
//     shared memory (no transpose immediate for 32-bit types), so one pass
//     loads B's columns, rounds them (and splits hi / lo) and stores them
//     transposed in the 128-byte-swizzled K-major layout that b_desc names
//     (b_swz), while A's copies land.  A comes from registers (wgmma's
//     register-A form): each thread loads its fragment from the staged rows
//     and rounds (splits) it with cvt.rna — the tensor cores read a .tf32
//     operand's top 19 bits and do not round the rest as cvt.rna does, so
//     no operand reaches them unrounded.  Blocks 1.. of the cluster write
//     their partial tiles into block 0's shared memory (distributed shared
//     memory), which adds them in rank order: a fixed order, no atomics.
//     (One block a tile over the whole depth, its A rows by cp.async or by
//     bulk copies, ran 1.5-3.4x slower on the H100: PERF.md, K12b.)
//   - ffma (probe_ffma): a 16 x 16 output tile a block (64 blocks for
//     [128, 128]), 2 x 2 outputs a thread from float4 / float2 shared
//     loads, its A rows and B columns staged by 16-byte cp.async in
//     PD_KS-deep groups; every output's sum runs over the whole depth in
//     k's order (no split-K, no atomics).
// The entry point refuses shapes the tiles do not divide and operands not
// on 16 bytes (cudaErrorInvalidValue; the wrapper raises first).
#include <cuda_runtime.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include "sdr_common.cuh"

#define PD_FFMA 0
#define PD_TF32 1
#define PD_3XTF32 2
#define PD_KS 64              // ffma: depth of a cp.async group; wgmma:
                              //   k-steps (PD_KS / 8) a wgmma group
#define PD_KMAX 512           // deepest contraction (staged whole)
#define A_LD(K) ((K) + 4)     // floats of a staged A row (4 of padding)
#define TC_M 64               // output rows of a wgmma tile (one warpgroup)
#define TC_N 16               // output columns of a wgmma tile
#define TC_THREADS 128
#define TC_SPLIT 4            // blocks of a wgmma cluster: depth slices
#define PD_KMULT (TC_SPLIT * 32)  // K's multiple (whole swizzle rows a slice)
#define FM_BM 16              // ffma block tile: FM_BM x FM_BN outputs,
#define FM_BN 16              //   2 x 2 a thread
#define FM_THREADS ((FM_BM / 2) * (FM_BN / 2))

static_assert(TC_N == 16, "b_stage_q: 4 float4 columns a B row");
static_assert(PD_KMULT % PD_KS == 0, "ffma: whole cp.async groups");

static __device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// ------------------------------------------------------ tensor-core modes

// Byte offset of B's element (n, k) in the staged, transposed tile: 32-k
// blocks of TC_N rows x 128 B, rows of 8 a 1 KB swizzle atom; the 16-byte
// piece of a row XORed with the row within its atom (the 128-byte swizzle,
// which the hardware applies to address bits 4-6 from bits 7-9).
static __host__ __device__ __forceinline__ int b_swz(int n, int k) {
  return (k / 32) * (TC_N * 128) + (n / 8) * 1024 + (n % 8) * 128 +
         (((k % 32) / 4) ^ (n % 8)) * 16 + (k % 4) * 4;
}

// The staging pass: thread tid loads B row k0 + b_stage_k(tid), columns
// 4 b_stage_q(tid) .. + 3, of each 32-row block k0.  A half-warp takes 16
// rows of one float4 column, so a warp's 128 stores fall in 32 banks.
static __device__ __forceinline__ int b_stage_k(int tid) {
  return (tid % 16) + 16 * (tid / 64);
}
static __device__ __forceinline__ int b_stage_q(int tid) {
  return (tid / 16) % 4;
}

// The shared-memory matrix descriptor of B at shared address addr:
// start >> 4 (bits 0-13), leading offset 1 (unused by a swizzled K-major
// operand, bits 16-29), stride 1024 B >> 4 between 8-row groups (bits
// 32-45), base offset 0 (the tile starts on 1 KB), 128-byte swizzle
// (layout 1, bits 62-63).
static __device__ __forceinline__ uint64_t b_desc(unsigned addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// Byte offset of k-step ks (8 k, 32 B) from the tile's start: its 32-k
// block, then 32 B a step inside the 128-byte swizzle row.
static __device__ __forceinline__ int b_kstep_off(int ks) {
  return (ks / 4) * (TC_N * 128) + (ks % 4) * 32;
}

// Register A of wgmma m64nNk8 .tf32: warp w, lane (g = lane / 4, t =
// lane % 4) holds elements i = 0..3 of the k-step at row 16 w + g + 8 (i %
// 2), column t + 4 (i / 2).
static __device__ __forceinline__ int a_frag_row(int warp, int lane, int i) {
  return 16 * warp + lane / 4 + 8 * (i % 2);
}
static __device__ __forceinline__ int a_frag_col(int lane, int i) {
  return lane % 4 + 4 * (i / 2);
}

// The m64nN f32 accumulator: element i of warp w, lane (g, t) is output
// row 16 w + g + 8 ((i / 2) % 2), column 8 (i / 4) + 2 t + i % 2.
static __device__ __forceinline__ int acc_row(int warp, int lane, int i) {
  return 16 * warp + lane / 4 + 8 * ((i / 2) % 2);
}
static __device__ __forceinline__ int acc_col(int lane, int i) {
  return 8 * (i / 4) + 2 * (lane % 4) + i % 2;
}

// d (64 x 16, f32) += a (64 x 8, registers) * b (8 x 16, shared, K-major)
static __device__ __forceinline__ void wgmma_tf32(float (&d)[TC_N / 2],
                                                  const uint32_t (&a)[4],
                                                  uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// Dynamic shared bytes of a tensor-core block for a depth slice of ks: B
// hi (and lo), A's padded rows, the partial tiles of the cluster's other
// blocks (read by block 0), and 1 KB to align the swizzled B tiles.
static __host__ __device__ constexpr int tc_smem(int three, int ks) {
  return 1024 + (1 + three) * ks * TC_N * 4 + TC_M * A_LD(ks) * 4 +
         (TC_SPLIT - 1) * TC_THREADS * (TC_N / 2) * 4;
}

// Thread tid's accumulator element i in the partial tile of cluster block r
// (1 ..) in block 0's shared memory: coalesced, a float a thread.
static __device__ __forceinline__ int red_slot(int r, int i, int tid) {
  return ((r - 1) * (TC_N / 2) + i) * TC_THREADS + tid;
}

template <bool THREE>
static __global__ void __launch_bounds__(TC_THREADS)
probe_wgmma(const float* __restrict__ a, const float* __restrict__ b,
            float* __restrict__ out, int N, int K) {
  namespace cg = cooperative_groups;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const int ks = K / TC_SPLIT;  // this block's depth slice
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* b_hi = base;
  uint8_t* b_lo = base + ks * TC_N * 4;  // 3xtf32 only
  float* sa = reinterpret_cast<float*>(base + (THREE ? 2 : 1) * ks * TC_N * 4);
  float* red = sa + TC_M * A_LD(ks);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int m0 = blockIdx.y * TC_M, n0 = (blockIdx.x / TC_SPLIT) * TC_N;
  const int k0 = rank * ks;
  // every block of the cluster running before any writes another's memory
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  // A's slice by the load-store unit's async copies
  for (int c = tid; c < TC_M * ks / 4; c += TC_THREADS) {
    const int r = c / (ks / 4), k = 4 * (c % (ks / 4));
    cp_async<16>(sa + r * A_LD(ks) + k, a + (size_t)(m0 + r) * K + k0 + k);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  // B's slice: every load in flight, then rounded (split) and stored
  // transposed
  float4 v[PD_KMAX / TC_SPLIT / 32];
#pragma unroll
  for (int j = 0; j < PD_KMAX / TC_SPLIT / 32; ++j)
    if (j < ks / 32)
      v[j] = __ldg(reinterpret_cast<const float4*>(
          b + (size_t)(k0 + 32 * j + b_stage_k(tid)) * N + n0 +
          4 * b_stage_q(tid)));
#pragma unroll
  for (int j = 0; j < PD_KMAX / TC_SPLIT / 32; ++j) {
    if (j < ks / 32) {
      const int k = 32 * j + b_stage_k(tid);
      const float x[4] = {v[j].x, v[j].y, v[j].z, v[j].w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int off = b_swz(4 * b_stage_q(tid) + e, k);
        const uint32_t hi = to_tf32(x[e]);
        *reinterpret_cast<uint32_t*>(b_hi + off) = hi;
        if (THREE)
          *reinterpret_cast<uint32_t*>(b_lo + off) =
              to_tf32(x[e] - __uint_as_float(hi));
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  // the generic-proxy stores made visible to wgmma's (async-proxy) reads
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  const unsigned bh = smem_u32(b_hi), bl = smem_u32(b_lo);
  float d[TC_N / 2];
#pragma unroll
  for (int i = 0; i < TC_N / 2; ++i) d[i] = 0.f;
  for (int s0 = 0; s0 < ks / 8; s0 += PD_KS / 8) {  // k-steps s0 ..
    uint32_t ah[PD_KS / 8][4], al[PD_KS / 8][4];
#pragma unroll
    for (int j = 0; j < PD_KS / 8; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float x = s0 + j < ks / 8
                            ? sa[a_frag_row(warp, lane, i) * A_LD(ks) +
                                 8 * (s0 + j) + a_frag_col(lane, i)]
                            : 0.f;
        ah[j][i] = to_tf32(x);
        if (THREE) al[j][i] = to_tf32(x - __uint_as_float(ah[j][i]));
      }
    }
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int j = 0; j < PD_KS / 8; ++j) {
      if (s0 + j < ks / 8) {
        const int off = b_kstep_off(s0 + j);
        if (THREE) {
          wgmma_tf32(d, al[j], b_desc(bh + off));
          wgmma_tf32(d, ah[j], b_desc(bl + off));
        }
        wgmma_tf32(d, ah[j], b_desc(bh + off));
      }
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  }
  // the partial tiles into block 0, added there in rank order
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  if (rank > 0) {
    float* dst = cluster.map_shared_rank(red, 0);
#pragma unroll
    for (int i = 0; i < TC_N / 2; ++i) dst[red_slot(rank, i, tid)] = d[i];
  }
  cluster.sync();
  if (rank > 0) return;
  for (int r = 1; r < TC_SPLIT; ++r)
#pragma unroll
    for (int i = 0; i < TC_N / 2; ++i) d[i] += red[red_slot(r, i, tid)];
#pragma unroll
  for (int i = 0; i < TC_N / 2; i += 2)
    *reinterpret_cast<float2*>(
        out + (size_t)(m0 + acc_row(warp, lane, i)) * N + n0 +
        acc_col(lane, i)) = make_float2(d[i], d[i + 1]);
}

// One launch of probe_wgmma<THREE>: clusters of TC_SPLIT blocks along x.
template <bool THREE>
static cudaError_t launch_wgmma(const float* a, const float* b, float* out,
                                int M, int N, int K, cudaStream_t s) {
  const int smem = tc_smem(THREE, K / TC_SPLIT);
  cudaError_t e = allow_smem(probe_wgmma<THREE>, tc_smem(THREE,
                                                         PD_KMAX / TC_SPLIT));
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = TC_SPLIT;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(TC_SPLIT * (N / TC_N), M / TC_M);
  cfg.blockDim = dim3(TC_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, probe_wgmma<THREE>, a, b, out, N, K);
}

// ------------------------------------------------------------------ ffma

// Wait until at most n of this thread's cp.async groups are in flight.
static __device__ __forceinline__ void cp_async_wait_pending(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::: "memory"); break;
  }
}

// Dynamic shared bytes of an ffma block at depth K: A's padded rows, B's
// columns.
static __host__ __device__ constexpr int fm_smem(int K) {
  return (FM_BM * A_LD(K) + K * FM_BN) * 4;
}

// Thread tid's 2 x 2 outputs: rows fm_row(tid) + 0..1, columns
// fm_col(tid) + 0..1 of the block's tile.
static __device__ __forceinline__ int fm_row(int tid) {
  return 2 * (tid / (FM_BN / 2));
}
static __device__ __forceinline__ int fm_col(int tid) {
  return 2 * (tid % (FM_BN / 2));
}

static __global__ void __launch_bounds__(FM_THREADS)
probe_ffma(const float* __restrict__ a, const float* __restrict__ b,
           float* __restrict__ out, int N, int K) {
  extern __shared__ __align__(16) float sm[];
  float* sa = sm;                      // [FM_BM][A_LD(K)]
  float* sb = sm + FM_BM * A_LD(K);    // [K][FM_BN]
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * FM_BM, n0 = blockIdx.x * FM_BN;
  const int stages = K / PD_KS;
  for (int s = 0; s < stages; ++s) {
    for (int c = tid; c < FM_BM * PD_KS / 4; c += FM_THREADS) {
      const int r = c / (PD_KS / 4), k = s * PD_KS + 4 * (c % (PD_KS / 4));
      cp_async<16>(sa + r * A_LD(K) + k, a + (size_t)(m0 + r) * K + k);
    }
    for (int c = tid; c < PD_KS * FM_BN / 4; c += FM_THREADS) {
      const int k = s * PD_KS + c / (FM_BN / 4), q = c % (FM_BN / 4);
      cp_async<16>(sb + k * FM_BN + 4 * q, b + (size_t)k * N + n0 + 4 * q);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  const int r0 = fm_row(tid), c0 = fm_col(tid);
  float acc[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  for (int s = 0; s < stages; ++s) {
    cp_async_wait_pending(stages - 1 - s);
    __syncthreads();
#pragma unroll 4
    for (int k = s * PD_KS; k < (s + 1) * PD_KS; k += 4) {
      const float4 x0 =
          *reinterpret_cast<const float4*>(sa + r0 * A_LD(K) + k);
      const float4 x1 =
          *reinterpret_cast<const float4*>(sa + (r0 + 1) * A_LD(K) + k);
      const float xa[2][4] = {{x0.x, x0.y, x0.z, x0.w},
                              {x1.x, x1.y, x1.z, x1.w}};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 y =
            *reinterpret_cast<const float2*>(sb + (k + j) * FM_BN + c0);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          acc[i][0] = fmaf(xa[i][j], y.x, acc[i][0]);
          acc[i][1] = fmaf(xa[i][j], y.y, acc[i][1]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
    *reinterpret_cast<float2*>(out + (size_t)(m0 + r0 + i) * N + n0 + c0) =
        make_float2(acc[i][0], acc[i][1]);
}

// a [M][K], b [K][N], out [M][N], each on 16 bytes; every mode needs
// N % 16 == 0 and K % PD_KMULT == 0, K <= PD_KMAX; ffma M % FM_BM == 0, the
// tensor-core modes M % TC_M == 0 (checked again by the wrapper)
extern "C" int probe_dot_run(const float* a, const float* b, float* out,
                             int M, int N, int K, int mode, void* stream) {
  const int bm = mode == PD_FFMA ? FM_BM : TC_M;
  if (mode < PD_FFMA || mode > PD_3XTF32 || M <= 0 || N <= 0 || K <= 0 ||
      M % bm || N % 16 || K % PD_KMULT || K > PD_KMAX || M / bm > 65535 ||
      (((uintptr_t)a | (uintptr_t)b | (uintptr_t)out) & 15))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  if (mode == PD_FFMA) {
    e = allow_smem(probe_ffma, fm_smem(PD_KMAX));
    if (e != cudaSuccess) return (int)e;
    probe_ffma<<<dim3(N / FM_BN, M / FM_BM), FM_THREADS, fm_smem(K), s>>>(
        a, b, out, N, K);
  } else {
    e = mode == PD_TF32 ? launch_wgmma<false>(a, b, out, M, N, K, s)
                        : launch_wgmma<true>(a, b, out, M, N, K, s);
    if (e != cudaSuccess) return (int)e;
  }
  SDR_CHECK_LAUNCH();
  return 0;
}
