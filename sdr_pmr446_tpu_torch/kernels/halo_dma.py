"""K11: the halo exchange along the time axis, CUDA kernel and plain versions.

Replaces the TPU kernel sdr_pmr446_tpu/kernels/halo_dma.py::ring_shift_right
(body ``_ring_shift_kernel``, a remote DMA to the right neighbour), the
transport of the scanner's two front-end halos with ``halo_dma=True``
(JAX's ``shard_hist_dma``: the tail, the ring shift, and shard 0 taking the
carried history).  Two entry points:

  - ``shard_hist_planes(carried [S, h] c64, planes [S, D, 2, T] f32, h) ->
    (hist [S, D, h] c64, new_carried [S, h] c64)``: JAX's
    ``shard_hist_dma`` on ``tail = complex(planes[..., 0, -h:], planes[...,
    1, -h:])``: hist[:, 0] = carried, hist[:, d] = tail[:, d - 1], and
    new_carried = tail[:, D - 1].  The plane path's two halos
    (parallel/halo.py::shard_hist_planes with ``dma``).  Its plain version
    is the collective composition: ``torch.complex`` of the tails, then
    the shift (parallel/halo.py::shard_hist without ``dma``); the kernel is
    one launch that reads the strided re and im tails and writes the
    interleaved history and the carry, with no complex tail, copy or roll.
    ``planes`` may be a slice of longer planes (any stream, shard and
    plane strides; the samples contiguous);
  - ``ring_shift_right(tail [S, D, ...]) -> out`` with out[:, d] = tail[:,
    (d - 1) mod D], each [s, d] block of ``tail`` contiguous, the stream
    and shard strides anything; complex tensors move as their re/im
    planes.  Its plain version is ``torch.roll(tail, 1, dims=1)``.

The CUDA version (csrc/halo_dma.cu) is one launch a call of one block per
shard, raw pointers with per-stream and per-shard strides in bytes, so that
a multi-card transport can aim a destination at a peer card.  It moves a
few KB a call: launch bound.
"""

from __future__ import annotations

import torch

from sdr_pmr446_tpu_torch.kernels import build

#: kernel launches of the CUDA version (one per call of either entry); the
#: plain versions never count
LAUNCHES = 0


def _planes(tail: torch.Tensor) -> torch.Tensor:
    if tail.dim() < 2:
        raise ValueError(f"tail must be [S, D, ...], got {tuple(tail.shape)}")
    return torch.view_as_real(tail) if tail.is_complex() else tail


def ring_shift_right(tail: torch.Tensor) -> torch.Tensor:
    """K11: the CUDA kernel for a CUDA tensor, the plain version for a CPU
    tensor."""
    if tail.device.type == "cuda":
        return ring_shift_kernel(tail)
    if tail.device.type == "cpu":
        return ring_shift_plain(tail)
    raise ValueError(f"no ring shift for device {tail.device}")


def ring_shift_plain(tail: torch.Tensor) -> torch.Tensor:
    """The same function in plain PyTorch ops (any device)."""
    _planes(tail)
    return torch.roll(tail, 1, dims=1)


def ring_shift_kernel(tail: torch.Tensor) -> torch.Tensor:
    """Launch csrc/halo_dma.cu on the current stream (raises on any
    fault)."""
    global LAUNCHES
    src = _planes(tail)
    if not src[0, 0].is_contiguous():
        raise ValueError("ring_shift_right: each [s, d] block of the tail "
                         "must be contiguous")
    out = torch.empty_like(tail, memory_format=torch.contiguous_format)
    dst = _planes(out)
    s, d = src.shape[:2]
    nbytes = src[0, 0].numel() * src.element_size()
    es = src.element_size()
    code = build.library().ring_shift_run(
        src.data_ptr(), dst.data_ptr(), s, d, nbytes,
        src.stride(0) * es, src.stride(1) * es,
        dst.stride(0) * es, dst.stride(1) * es,
        torch.cuda.current_stream(tail.device).cuda_stream)
    build.check(code, "ring_shift_run")
    LAUNCHES += 1
    return out


def _check_planes(carried: torch.Tensor, planes: torch.Tensor,
                  h: int) -> None:
    if planes.dtype != torch.float32 or planes.dim() != 4 \
            or planes.shape[2] != 2 or not 0 < h <= planes.shape[3]:
        raise ValueError(f"shard_hist_planes: planes must be f32 [S, D, 2, "
                         f"T] with 0 < h <= T, got {planes.dtype} "
                         f"{tuple(planes.shape)}, h = {h}")
    if carried.dtype != torch.complex64 \
            or tuple(carried.shape) != (planes.shape[0], h):
        raise ValueError(f"shard_hist_planes: carried must be c64 "
                         f"[{planes.shape[0]}, {h}], got {carried.dtype} "
                         f"{tuple(carried.shape)}")


def shard_hist_planes(carried: torch.Tensor, planes: torch.Tensor,
                      h: int):
    """K11's halo from the planes: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if planes.device.type == "cuda":
        return shard_hist_planes_kernel(carried, planes, h)
    if planes.device.type == "cpu":
        return shard_hist_planes_plain(carried, planes, h)
    raise ValueError(f"no halo for device {planes.device}")


def shard_hist_planes_plain(carried: torch.Tensor, planes: torch.Tensor,
                            h: int):
    """The same function in plain PyTorch ops (any device): the complex
    tails, then the collective's shift (parallel/halo.py::shift_right)."""
    _check_planes(carried, planes, h)
    t = planes.shape[3]
    tail = torch.complex(planes[..., 0, t - h:], planes[..., 1, t - h:])
    return torch.cat([carried.unsqueeze(1), tail[:, :-1]], dim=1), tail[:, -1]


def shard_hist_planes_kernel(carried: torch.Tensor, planes: torch.Tensor,
                             h: int):
    """Launch csrc/halo_dma.cu's shard_hist_planes_run on the current stream
    (raises on any fault)."""
    global LAUNCHES
    _check_planes(carried, planes, h)
    if carried.device != planes.device:
        raise ValueError(f"shard_hist_planes: carried on {carried.device}, "
                         f"planes on {planes.device}")
    if planes.stride(3) != 1 or carried.stride(1) != 1:
        raise ValueError("shard_hist_planes: the samples of a plane and of "
                         "the carried history must be contiguous")
    s, d, _, t = planes.shape
    hist = torch.empty((s, d, h), dtype=torch.complex64, device=planes.device)
    new_c = torch.empty((s, h), dtype=torch.complex64, device=planes.device)
    es = planes.element_size()
    code = build.library().shard_hist_planes_run(
        planes[0, 0, 0, t - h:].data_ptr(), planes.stride(2) * es,
        planes.stride(0) * es, planes.stride(1) * es,
        carried.data_ptr(), carried.stride(0) * 8,
        hist.data_ptr(), hist.stride(0) * 8, hist.stride(1) * 8,
        new_c.data_ptr(), new_c.stride(0) * 8, s, d, h,
        torch.cuda.current_stream(planes.device).cuda_stream)
    build.check(code, "shard_hist_planes_run")
    LAUNCHES += 1
    return hist, new_c
