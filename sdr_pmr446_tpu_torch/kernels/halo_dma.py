"""K11: the halo exchange's ring shift along the time axis, CUDA kernel and plain version.

Replaces the TPU kernel sdr_pmr446_tpu/kernels/halo_dma.py::ring_shift_right
(body ``_ring_shift_kernel``, a remote DMA to the right neighbour), the
transport of the scanner's two front-end halos with ``halo_dma=True``
(parallel/halo.py::shard_hist with ``dma``, JAX's ``shard_hist_dma``).

``ring_shift_right(tail [S, D, ...]) -> out`` with out[:, d] = tail[:, (d -
1) mod D]: every time shard receives its left neighbour's tail (the one-card
mesh's layout, parallel/halo.py).  Each [s, d] block of ``tail`` must be
contiguous; the stream and shard strides may be anything (a slice of a
longer plane passes as it is).  Complex tensors move as their re/im planes
(``view_as_real``), in the same single launch.

The plain version is ``torch.roll(tail, 1, dims=1)``, also the kernel's
library yardstick in chip_smoke.py; the port never calls it on the card.
The CUDA version (csrc/halo_dma.cu) is one launch of one block per shard,
raw pointers with per-stream and per-shard strides in bytes, so that a
multi-card transport can aim the destination at a peer card.  It moves a
few KB a call: launch bound.
"""

from __future__ import annotations

import torch

from sdr_pmr446_tpu_torch.kernels import build

#: kernel launches of the CUDA version (one per call); the plain version
#: never counts
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

