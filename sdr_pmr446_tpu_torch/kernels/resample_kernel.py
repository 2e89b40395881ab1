"""K9: the 25/128 polyphase resampler on re/im planes, CUDA kernel and plain version.

Replaces the TPU kernel
sdr_pmr446_tpu/kernels/resample_kernel.py::PallasResampler.apply_planes:
the scanner's ``fuse_dc=False`` path, where the IQ DC blocker runs as
plain ops before it.  ``Resampler(device=)(hist c64 [P - 1], xr, xi) ->
(hist', band f32 [2, nb])`` for xr/xi f32 [T], T % 128 == 0, nb = T * 25 /
128.  The history is the last P - 1 = 345 input samples (``hist_len``, the
JAX kernel's ``len(resampler_taps) // 25 - 1``).

The plain version is ops/resample.PolyResampler: one strided
``F.conv1d``, which is also the kernel's library yardstick.  The CUDA
version (csrc/resample_kernel.cu) runs two launches: the resampler, each
block over a shared-memory window of [hist | x] and the staged taps
(``front_end.staged_taps``) with the arithmetic of the front end's
resampler (csrc/front_end.cuh, a register-tiled product), and the new
history.
Operations bound on the H100 (~16 us at K = 40); see the source.
"""

from __future__ import annotations

import torch
from torch import nn

from sdr_pmr446_tpu_torch import config as C
from sdr_pmr446_tpu_torch.kernels import build
from sdr_pmr446_tpu_torch.kernels.front_end import (compact_phases,
                                                   staged_taps)
from sdr_pmr446_tpu_torch.ops.resample import PolyResampler
from sdr_pmr446_tpu_torch.taps import design as D

#: kernel launches of the CUDA version (one per call); the plain version
#: never counts
LAUNCHES = 0


class Resampler(nn.Module):
    """K9: the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors."""

    def __init__(self, *, device):
        super().__init__()
        taps = D.resampler_taps()
        self.op = PolyResampler(taps, C.RESAMP_L, C.RESAMP_M, device)
        self.hist_len = self.op.hist_len
        self.register_buffer("kt", torch.as_tensor(staged_taps(
            compact_phases(taps, C.RESAMP_L, C.RESAMP_M)), device=device))

    def samples(self, xr: torch.Tensor, xi: torch.Tensor) -> int:
        if xr.dim() != 1 or xr.shape != xi.shape:
            raise ValueError("xr and xi must be 1-D planes of one length")
        n = xr.shape[0]
        if n == 0 or n % C.RESAMP_M:
            raise ValueError(f"{n} samples is not a multiple of {C.RESAMP_M}")
        return n

    def forward(self, hist, xr, xi):
        if xr.device.type == "cuda":
            return self.kernel(hist, xr, xi)
        if xr.device.type == "cpu":
            return self.plain(hist, xr, xi)
        raise ValueError(f"no resampler implementation for device "
                         f"{xr.device}")

    def plain(self, hist, xr, xi):
        """The same function in plain PyTorch ops (any device)."""
        self.samples(xr, xi)
        if hist.shape != (self.hist_len,):
            raise ValueError(f"hist has shape {tuple(hist.shape)}, expected "
                             f"({self.hist_len},)")
        new_h, band = self.op(torch.view_as_real(hist).T, torch.stack([xr, xi]))
        return torch.complex(new_h[0], new_h[1]).contiguous(), band

    def kernel(self, hist, xr, xi):
        """Launch csrc/resample_kernel.cu on the current stream (raises on
        any fault)."""
        global LAUNCHES
        n = self.samples(xr, xi)
        dev = xr.device
        build.require(hist, "hist", torch.complex64, (self.hist_len,), dev)
        build.require(xr, "xr", torch.float32, (n,), dev)
        build.require(xi, "xi", torch.float32, (n,), dev)
        build.require(self.kt, "kt", torch.float32, None, dev)
        band = torch.empty((2, n * C.RESAMP_L // C.RESAMP_M),
                           dtype=torch.float32, device=dev)
        new_h = torch.empty(self.hist_len, dtype=torch.complex64, device=dev)
        code = build.library().resample_run(
            hist.data_ptr(), self.hist_len, xr.data_ptr(), xi.data_ptr(), n,
            self.kt.data_ptr(), band.data_ptr(), new_h.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
        build.check(code, "resample_run")
        LAUNCHES += 1
        return new_h, band
