// K12a: the layout probes on Hopper — eight data moves that a fused
// front-end -> PFB kernel needs, each run on real values:
//   0 scratch_store_off16  x [8, 256] -> [8, 128]: s = x, s[:, 16:32] =
//                          x[:, 0:16], out = s[:, 0:128]
//   1 scratch_read_off16   x [8, 256] -> s[:, 16:144] [8, 128]
//   2 scratch_read_narrow  x [8, 256] -> s[:, 16:32] [8, 16]
//   3 value_lane_off16     x [8, 256] -> x[:, 16:144] [8, 128], from
//                          registers (warp shuffles, no shared memory)
//   4 value_stride_sub     x [128, 256] -> x[0::16, :] [8, 256]
//   5 reshape_rows_wide    x [128, 128] -> reshape [8, 2048]
//   6 reshape_25_16        x [128, 25] -> reshape [200, 16]
//   7 transpose_16         x [128, 16] -> x.T [16, 128]
//
// Replaces tools/probe_layout.py::_call's Pallas kernels (the bodies in its
// main(), pallas_call at :50), which only compile on zeros.  What each move
// computes is documented beside its plain PyTorch version,
// kernels/probe_layout.py.
//
// Every move but 3 puts its data into shared memory (the counterpart of
// the VMEM scratch: on Hopper the in-kernel reshapes, strided rows and lane
// offsets are index arithmetic on shared memory, no relayout) and emits it
// from there; 3 slices in registers, its 16-column offset a 4-lane shuffle
// of float4s.  What bounds it on the H100: 8-128 KB in and 0.5-12.8 KB out a
// move, under 0.05 us of bytes — launch and latency bound.  So a
// move moves only what its output reads, by the copy engine, in as few
// dependent steps as it can:
//   - staging: contiguous runs that start on 16 B and are whole 16 B go in
//     by one-dimensional bulk copies (cp.async.bulk), issued by one thread,
//     the block waiting on one mbarrier that expects their byte sum:
//       0  the 8 rows' columns 0:128 (8 x 512 B), then the block stores
//          x[:, 0:16] at columns 16:32 (after the wait: the async writes
//          land first);
//       1  columns 16:144 (8 x 512 B) at their own columns of a 144-column
//          scratch, read back at offset 16;
//       2  columns 16:32 (8 x 64 B) at their own columns of a 32-column
//          scratch;
//       4  8 blocks, block b row 16 b (1 KB): 8 of the 128 KB;
//       5  8 blocks, block b its output row's 8 KB slab;
//       6  the whole 12.8 KB (its 100-B rows start off 16 B one by one);
//   - 7 has padded (swizzled) rows, which a bulk copy cannot write: its 512
//     16-B row pieces go in by per-thread cp.async, piece q of row r at
//     slot tr_slot(r, q).  Thread (c4, q) reads rows 4q..4q+3, piece c4, as
//     four float4 and writes the 4 x 4 block transposed (four float4 of
//     output rows 4 c4..4 c4+3); the swizzle puts a quarter-warp's eight
//     16-B reads in eight distinct bank groups (plain 16-word rows would
//     put all eight in one);
//   - emitting: float4 stores, neighbouring threads on neighbouring 16 B.
// Each call is one launch; no move holds more than 12.8 KB of shared
// memory.  Every bulk copy traps unless its source, destination and size
// are whole 16 B, and the entry point refuses an x or out that does not
// start on 16 B (cudaErrorInvalidValue).
#include <cuda_runtime.h>
#include <stdint.h>

#include "sdr_common.cuh"

#define PL_THREADS 256

// ------------------------------------------------ the async copy engine

static __device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile(
      "mbarrier.init.shared::cta.b64 [%0], 1;\n"
      "fence.mbarrier_init.release.cluster;\n" ::"r"(smem_u32(bar))
      : "memory");
}

// One arrival that also expects ``bytes`` of asynchronous writes.
static __device__ __forceinline__ void mbar_expect(uint64_t* bar,
                                                   unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the barrier's phase ``parity`` completes.
static __device__ __forceinline__ void mbar_wait(uint64_t* bar,
                                                 unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// bytes from device to shared memory by the copy engine, completing on bar
// (a launch without a cluster is a cluster of one)
static __device__ __forceinline__ void bulk_g2s(void* dst, const void* src,
                                                unsigned bytes,
                                                uint64_t* bar) {
  if (((uintptr_t)src | smem_u32(dst) | bytes) & 15u) __trap();
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// ------------------------------------------------------------ the moves

// Shared floats of a move's block (move 3: none).
static __host__ __device__ constexpr int pl_smem_floats(int move) {
  return move == 0 ? 8 * 128
         : move == 1 ? 8 * 144
         : move == 2 ? 8 * 32
         : move == 4 ? 256
         : move == 5 ? 2048
         : move == 6 ? 128 * 25
         : move == 7 ? 128 * 16
                     : 0;
}

// Blocks of a move's launch: one output row each where rows do not share
// input (4, 5), else one.
static __host__ __device__ constexpr int pl_blocks(int move) {
  return move == 4 || move == 5 ? 8 : 1;
}

// The 16-B slot of row r's piece q (4 a row) in the transpose's tile: rows
// 2L and 2L + 1 share the 128 B of line L, in halves swapped by bit 2 of
// r; the pieces are XORed with bits 3-4 of r.
static __device__ __forceinline__ int tr_slot(int r, int q) {
  return (r >> 1) * 8 + 4 * ((r & 1) ^ ((r >> 2) & 1)) + (q ^ ((r >> 3) & 3));
}

// Move 3: warp r holds row r, lane l its float4s l and 32 + l; output
// float4 l is input float4 l + 4, held by lane (l + 4) % 32.
static __device__ __forceinline__ void lane_off16(const float4* __restrict__ x,
                                                  float4* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int r = threadIdx.x >> 5;
  const float4 a = x[r * 64 + lane], b = x[r * 64 + 32 + lane];
  const int src = (lane + 4) & 31;
  float4 lo, hi;
  lo.x = __shfl_sync(0xffffffffu, a.x, src);
  lo.y = __shfl_sync(0xffffffffu, a.y, src);
  lo.z = __shfl_sync(0xffffffffu, a.z, src);
  lo.w = __shfl_sync(0xffffffffu, a.w, src);
  hi.x = __shfl_sync(0xffffffffu, b.x, src);
  hi.y = __shfl_sync(0xffffffffu, b.y, src);
  hi.z = __shfl_sync(0xffffffffu, b.z, src);
  hi.w = __shfl_sync(0xffffffffu, b.w, src);
  out[r * 32 + lane] = lane < 28 ? lo : hi;
}

template <int MOVE>
static __global__ void __launch_bounds__(PL_THREADS)
layout_probe(const float* __restrict__ x, float* __restrict__ out) {
  extern __shared__ __align__(16) float s[];
  const int t = threadIdx.x;
  const float4* s4 = reinterpret_cast<const float4*>(s);
  float4* out4 = reinterpret_cast<float4*>(out);
  if constexpr (MOVE == 3) {
    lane_off16(reinterpret_cast<const float4*>(x), out4);
  } else if constexpr (MOVE == 7) {
    for (int c = t; c < 128 * 4; c += PL_THREADS)
      cp_async<16>(s + 4 * tr_slot(c >> 2, c & 3), x + 4 * c);
    cp_async_wait_all();
    __syncthreads();
    if (t < 128) {
      const int c4 = t >> 5, q = t & 31;
      float4 a[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) a[m] = s4[tr_slot(4 * q + m, c4)];
      out4[(4 * c4 + 0) * 32 + q] = make_float4(a[0].x, a[1].x, a[2].x, a[3].x);
      out4[(4 * c4 + 1) * 32 + q] = make_float4(a[0].y, a[1].y, a[2].y, a[3].y);
      out4[(4 * c4 + 2) * 32 + q] = make_float4(a[0].z, a[1].z, a[2].z, a[3].z);
      out4[(4 * c4 + 3) * 32 + q] = make_float4(a[0].w, a[1].w, a[2].w, a[3].w);
    }
  } else {
    __shared__ uint64_t bar;
    const int b = blockIdx.x;
    if (t == 0) mbar_init(&bar);
    __syncthreads();  // the barrier initialised before anyone waits on it
    if (t == 0) {
      if constexpr (MOVE == 0 || MOVE == 1 || MOVE == 2) {
        const int ld = MOVE == 0 ? 128 : MOVE == 1 ? 144 : 32;
        const int c0 = MOVE == 0 ? 0 : 16;       // first column staged
        const int n = MOVE == 2 ? 16 : 128;      // columns staged a row
        mbar_expect(&bar, 8 * n * 4);
        for (int r = 0; r < 8; ++r)
          bulk_g2s(s + r * ld + c0, x + r * 256 + c0, n * 4, &bar);
      } else if constexpr (MOVE == 4) {
        mbar_expect(&bar, 256 * 4);
        bulk_g2s(s, x + 16 * b * 256, 256 * 4, &bar);
      } else if constexpr (MOVE == 5) {
        mbar_expect(&bar, 2048 * 4);
        bulk_g2s(s, x + b * 2048, 2048 * 4, &bar);
      } else {  // 6
        mbar_expect(&bar, 128 * 25 * 4);
        bulk_g2s(s, x, 128 * 25 * 4, &bar);
      }
    }
    float v0 = 0.f;
    if (MOVE == 0 && t < 128) v0 = x[(t >> 4) * 256 + (t & 15)];
    mbar_wait(&bar, 0);  // every thread: the staged bytes have landed
    if constexpr (MOVE == 0) {
      if (t < 128) s[(t >> 4) * 128 + 16 + (t & 15)] = v0;  // the store
      __syncthreads();
      out4[t] = s4[t];  // s[:, 0:128], 32 float4 a row
    } else if constexpr (MOVE == 1) {
      out4[t] = s4[(t >> 5) * 36 + 4 + (t & 31)];  // s[r, 16 + 4 c4]
    } else if constexpr (MOVE == 2) {
      if (t < 32) out4[t] = s4[(t >> 2) * 8 + 4 + (t & 3)];
    } else if constexpr (MOVE == 4) {
      if (t < 64) out4[b * 64 + t] = s4[t];
    } else if constexpr (MOVE == 5) {
      out4[b * 512 + t] = s4[t];
      out4[b * 512 + 256 + t] = s4[256 + t];
    } else {  // 6: a row-major reshape keeps the flat index
      for (int i = t; i < 128 * 25 / 4; i += PL_THREADS) out4[i] = s4[i];
    }
  }
}

template <int MOVE>
static int pl_launch(const float* x, float* out, cudaStream_t s) {
  layout_probe<MOVE><<<pl_blocks(MOVE), PL_THREADS,
                       pl_smem_floats(MOVE) * sizeof(float), s>>>(x, out);
  SDR_CHECK_LAUNCH();
  return 0;
}

// x and out hold move's input and output shapes, contiguous f32, each
// starting on 16 B
extern "C" int probe_layout_run(int move, const float* x, float* out,
                                void* stream) {
  if (((uintptr_t)x | (uintptr_t)out) & 15) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (move) {
    case 0: return pl_launch<0>(x, out, s);
    case 1: return pl_launch<1>(x, out, s);
    case 2: return pl_launch<2>(x, out, s);
    case 3: return pl_launch<3>(x, out, s);
    case 4: return pl_launch<4>(x, out, s);
    case 5: return pl_launch<5>(x, out, s);
    case 6: return pl_launch<6>(x, out, s);
    case 7: return pl_launch<7>(x, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
