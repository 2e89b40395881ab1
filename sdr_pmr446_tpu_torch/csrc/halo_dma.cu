// K11: the ring shift of the halo exchange along the time axis on Hopper —
// every time shard receives its left neighbour's tail:
//   dst[s][d] = src[s][(d - 1) mod D]
//
// Replaces sdr_pmr446_tpu/kernels/halo_dma.py::ring_shift_right (body
// _ring_shift_kernel: a remote DMA to the right neighbour behind a
// neighbour barrier).  What it computes is documented beside its plain
// PyTorch version, kernels/halo_dma.py.
//
// On one card every shard lives in device memory, so the exchange is a
// copy: one block per (shard, stream), each moving one shard's bytes with
// the widest vector (16, 8 or 4 bytes) that both its addresses allow, the
// rest byte by byte.  Source and destination are raw pointers with
// per-stream and per-shard strides in bytes, so a multi-card build can point
// the destination at a peer card's buffer.  What bounds it on the H100: a
// few KB a call (the resampler and PFB halos are 2.8 and 3.2 KB a shard),
// so it is launch bound; its bytes would take well under a microsecond.
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
