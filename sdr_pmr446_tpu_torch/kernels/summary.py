"""K10: the read-only zero-state DC summary of the wire, CUDA kernel and plain version.

Replaces the TPU kernel sdr_pmr446_tpu/kernels/summary.py::zero_summary_wire
(bodies ``_body_ilv`` / ``_body_cs16`` / ``_body_pk2``, selector matrices
``_consts``).  The time-sharded duo and mono engines' exact-state pre-pass
(parallel/fused_halo.py) needs, per 128-sample row r of the wire and per
I/Q plane, the zero-state DC blocker's end-of-row response and the row's
last sample:

    w[r]  = sum_j v[j] x[128 r + j],  v = fused_halo.dc_row_weights()
    xl[r] = x[128 r + 127]

``zero_summary_wire(wire uint8 [n * bytes a sample], fmt) -> (w [2, R],
xl [2, R])`` f32, R = n / 128, row 0 of each the re plane.  The port's
wire is the raw capture bytes (cu8, cs8, cs16, cf32; JAX's ``cf32w`` is
cf32 here), so the JAX kernel's transport-word layouts and their per-format
column selectors have no counterpart, and the wire of every stream and
time shard of a step goes through one call: a row never straddles a shard.

The plain version decodes to planes (ops/decode.py) and takes one
[R, 128] @ v product per plane and the column 127.  The CUDA version
(csrc/summary.cu) is one launch of a persistent grid that streams the wire
in 16-byte loads (16 or 32 lanes a row, the weights in registers), decodes
with K1's expressions and sums in a fixed order (each lane's samples in
turn, then a shuffle tree over the row's lanes), so a call is bit-equal to
the last; it never writes the decoded planes.  Bytes bound on the H100:
the wire read once, 16 B written per 128 samples (0.0102 ms for the 32.1
MB of 4 streams at K = 40 cu8); see the source.  The wire must start on 16
bytes (``build.check_aligned``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from sdr_pmr446_tpu_torch.kernels import build
from sdr_pmr446_tpu_torch.kernels.front_end import FMT_CODE
from sdr_pmr446_tpu_torch.ops import decode

ROW = 128

#: kernel launches of the CUDA version (one per call); the plain version
#: never counts
LAUNCHES = 0


@functools.lru_cache(maxsize=None)
def _weights(device: str) -> torch.Tensor:
    from sdr_pmr446_tpu_torch.parallel.fused_halo import dc_row_weights
    return torch.as_tensor(dc_row_weights(), device=device)


def rows(wire: torch.Tensor, fmt: str) -> int:
    """128-sample rows in ``wire`` (raises unless it holds whole rows)."""
    bps = decode.BYTES_PER_SAMPLE[decode.wire_format(fmt)]
    if wire.dim() != 1 or wire.numel() % (ROW * bps):
        raise ValueError(f"wire must be 1-D whole {ROW}-sample rows of "
                         f"{fmt}, got {tuple(wire.shape)}")
    return wire.numel() // (ROW * bps)


def zero_summary_wire(wire: torch.Tensor, fmt: str):
    """K10: the CUDA kernel for a CUDA tensor, the plain version for a CPU
    tensor."""
    if wire.device.type == "cuda":
        return zero_summary_kernel(wire, fmt)
    if wire.device.type == "cpu":
        return zero_summary_plain(wire, fmt)
    raise ValueError(f"no zero-summary implementation for device "
                     f"{wire.device}")


def zero_summary_plain(wire: torch.Tensor, fmt: str):
    """The same function in plain PyTorch ops (any device)."""
    r = rows(wire, fmt)
    xr, xi = decode.decode_planes(wire, decode.wire_format(fmt))
    x = torch.stack([xr, xi]).reshape(2, r, ROW)
    w = torch.matmul(x, _weights(str(wire.device)))
    return w, x[..., ROW - 1].contiguous()


def zero_summary_kernel(wire: torch.Tensor, fmt: str):
    """Launch csrc/summary.cu on the current stream (raises on any fault)."""
    global LAUNCHES
    fmt = decode.wire_format(fmt)
    r = rows(wire, fmt)
    dev = wire.device
    build.require(wire, "wire", torch.uint8, (wire.numel(),), dev)
    build.check_aligned(wire.data_ptr(), "wire")
    v = _weights(str(dev))
    build.require(v, "v", torch.float32, (ROW,), dev)
    w, xl = torch.empty((2, 2, r), dtype=torch.float32, device=dev)
    code = build.library().zero_summary_run(
        FMT_CODE[fmt], wire.data_ptr(), r * ROW, v.data_ptr(),
        float(np.float32(1.0 / 127.5)), w.data_ptr(), xl.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(code, "zero_summary_run")
    LAUNCHES += 1
    return w, xl
