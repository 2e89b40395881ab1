// K11: the halo exchange along the time axis on Hopper — every time shard
// receives its left neighbour's tail.  Two entry points:
//   ring_shift_run:        dst[s][d] = src[s][(d - 1) mod D], any bytes;
//   shard_hist_planes_run: the whole halo of a time shard from the f32
//     re / im planes of its signal, in one launch: with tail[s][d] the
//     last h samples of shard d as complex,
//       hist[s][0] = carried[s], hist[s][d] = tail[s][d - 1] (d >= 1),
//       new_carried[s] = tail[s][D - 1].
//
// Replaces sdr_pmr446_tpu/kernels/halo_dma.py::ring_shift_right (body
// _ring_shift_kernel: a remote DMA to the right neighbour behind a
// neighbour barrier) and, with the planes, the rest of its caller
// shard_hist_dma (the tail, the shift, where(d == 0, carried, received)).
// What it computes is documented beside its plain PyTorch versions,
// kernels/halo_dma.py.
//
// On one card every shard lives in device memory, so the exchange is a
// copy: one block per (shard, stream), each moving one shard's bytes with
// the widest vector that its addresses allow.  shard_hist_planes_run's
// grid has D + 1 blocks a stream: block d reads shard d - 1's re and im
// tails (float2 pairs where both start on 8 bytes and the history on 16,
// after peeling one sample if that aligns all three; else one sample a
// thread) and writes them interleaved to hist[s][d], or to new_carried[s]
// for d = D; block 0 copies carried[s].  Sources and destinations are raw
// pointers with per-stream and per-shard strides in bytes, so a multi-card
// build can point a destination at a peer card's buffer.  What bounds it
// on the H100: a few KB a call (the resampler and PFB halos are 2.8 and
// 3.2 KB a shard), so it is launch bound; its bytes would take well under
// a microsecond.  So each halo is one launch, with no separate complex
// tail, copy or shift around it.
#include <cuda_runtime.h>
#include <stdint.h>

#include "sdr_common.cuh"

#define RS_THREADS 256

template <typename V>
static __device__ __forceinline__ void copy_as(const uint8_t* __restrict__ a,
                                               uint8_t* __restrict__ b,
                                               long long nbytes) {
  const long long nv = nbytes / (long long)sizeof(V);
  const V* av = reinterpret_cast<const V*>(a);
  V* bv = reinterpret_cast<V*>(b);
  for (long long i = threadIdx.x; i < nv; i += blockDim.x) bv[i] = av[i];
  for (long long i = nv * (long long)sizeof(V) + threadIdx.x; i < nbytes;
       i += blockDim.x)
    b[i] = a[i];
}

static __global__ void ring_shift_kernel(const uint8_t* __restrict__ src,
                                         uint8_t* __restrict__ dst,
                                         int n_time, long long nbytes,
                                         long long src_ss, long long src_ds,
                                         long long dst_ss, long long dst_ds) {
  const int d = blockIdx.x;
  const long long s = blockIdx.y;
  const int from = (d + n_time - 1) % n_time;
  const uint8_t* a = src + s * src_ss + (long long)from * src_ds;
  uint8_t* b = dst + s * dst_ss + (long long)d * dst_ds;
  const uintptr_t align = (uintptr_t)a | (uintptr_t)b;
  if ((align & 15) == 0)
    copy_as<uint4>(a, b, nbytes);
  else if ((align & 7) == 0)
    copy_as<uint2>(a, b, nbytes);
  else if ((align & 3) == 0)
    copy_as<uint32_t>(a, b, nbytes);
  else
    copy_as<uint8_t>(a, b, nbytes);
}

// h complex samples from the re / im planes to dst, interleaved.
static __device__ __forceinline__ void interleave(const float* __restrict__ re,
                                                  const float* __restrict__ im,
                                                  float2* __restrict__ dst,
                                                  int h) {
  const uintptr_t ar = (uintptr_t)re, ai = (uintptr_t)im, ad = (uintptr_t)dst;
  const int p = ((ar & 7) == 4 && (ai & 7) == 4 && (ad & 15) == 8) ? 1 : 0;
  if ((((ar | ai) + 4 * p) & 7) != 0 || ((ad + 8 * p) & 15) != 0) {
    for (int j = threadIdx.x; j < h; j += blockDim.x)
      dst[j] = make_float2(re[j], im[j]);
    return;
  }
  const int pairs = (h - p) / 2;
  const float2* r2 = reinterpret_cast<const float2*>(re + p);
  const float2* i2 = reinterpret_cast<const float2*>(im + p);
  float4* d4 = reinterpret_cast<float4*>(dst + p);
  for (int j = threadIdx.x; j < pairs; j += blockDim.x) {
    const float2 x = r2[j], y = i2[j];
    d4[j] = make_float4(x.x, y.x, x.y, y.y);
  }
  if (threadIdx.x == 0) {
    if (p) dst[0] = make_float2(re[0], im[0]);
    if ((h - p) & 1) dst[h - 1] = make_float2(re[h - 1], im[h - 1]);
  }
}

static __global__ void shard_hist_planes_kernel(
    const uint8_t* __restrict__ re, long long im_off, long long p_ss,
    long long p_ds, const uint8_t* __restrict__ carried, long long c_ss,
    uint8_t* __restrict__ hist, long long h_ss, long long h_ds,
    uint8_t* __restrict__ new_carried, long long n_ss, int n_time, int h) {
  const int d = blockIdx.x;
  const long long s = blockIdx.y;
  uint8_t* dst = d < n_time ? hist + s * h_ss + (long long)d * h_ds
                            : new_carried + s * n_ss;
  if (d == 0) {
    const uint8_t* c = carried + s * c_ss;
    const long long nbytes = 8LL * h;
    if ((((uintptr_t)c | (uintptr_t)dst) & 15) == 0)
      copy_as<uint4>(c, dst, nbytes);
    else
      copy_as<uint2>(c, dst, nbytes);
    return;
  }
  const uint8_t* r = re + s * p_ss + (long long)(d - 1) * p_ds;
  interleave(reinterpret_cast<const float*>(r),
             reinterpret_cast<const float*>(r + im_off),
             reinterpret_cast<float2*>(dst), h);
}

// src, dst: [n_stream][n_time] shards of nbytes each, at the given strides
extern "C" int ring_shift_run(const void* src, void* dst, int n_stream,
                              int n_time, long long nbytes, long long src_ss,
                              long long src_ds, long long dst_ss,
                              long long dst_ds, void* stream) {
  if (n_stream <= 0 || n_time <= 0 || nbytes <= 0 || n_stream > 65535)
    return (int)cudaErrorInvalidValue;
  ring_shift_kernel<<<dim3(n_time, n_stream), RS_THREADS, 0,
                      (cudaStream_t)stream>>>(
      (const uint8_t*)src, (uint8_t*)dst, n_time, nbytes, src_ss, src_ds,
      dst_ss, dst_ds);
  SDR_CHECK_LAUNCH();
  return 0;
}

// re: shard (0, 0)'s re tail (h f32), im at im_off bytes from it, shards at
// p_ss / p_ds bytes; carried [n_stream] x h c64 at c_ss; hist [n_stream]
// [n_time] x h c64 at h_ss / h_ds; new_carried [n_stream] x h c64 at n_ss.
// Planes on 4 bytes, complex rows on 8.
extern "C" int shard_hist_planes_run(const void* re, long long im_off,
                                     long long p_ss, long long p_ds,
                                     const void* carried, long long c_ss,
                                     void* hist, long long h_ss,
                                     long long h_ds, void* new_carried,
                                     long long n_ss, int n_stream, int n_time,
                                     int h, void* stream) {
  if (n_stream <= 0 || n_time <= 0 || h <= 0 || n_stream > 65535 ||
      (((uintptr_t)re | im_off | p_ss | p_ds) & 3) ||
      (((uintptr_t)carried | (uintptr_t)hist | (uintptr_t)new_carried |
        c_ss | h_ss | h_ds | n_ss) & 7))
    return (int)cudaErrorInvalidValue;
  shard_hist_planes_kernel<<<dim3(n_time + 1, n_stream), RS_THREADS, 0,
                             (cudaStream_t)stream>>>(
      (const uint8_t*)re, im_off, p_ss, p_ds, (const uint8_t*)carried, c_ss,
      (uint8_t*)hist, h_ss, h_ds, (uint8_t*)new_carried, n_ss, n_time, h);
  SDR_CHECK_LAUNCH();
  return 0;
}
