"""K7: the 16-channel PFB + NBFM discriminator, CUDA kernel and plain version.

Replaces the TPU kernel sdr_pmr446_tpu/kernels/pfb_demod.py::PallasPfbDemod
(``call_planes``, ``call_planes_rssi``, ``call_group`` and
``_call_group_packed``).  On the band planes of K6 (kernels/front_end.py)
or K9 (kernels/resample_kernel.py) it computes

  1. the 16-channel PFB: 416-tap prototype x DFT16 x the -93.75 kHz mixer
     folded into one [416, 16] complex kernel, with the (-1)^(parity +
     frame) flip (ops/pfb.py);
  2. the NBFM discriminator (kf = 0.5) against the carried previous frame;
  3. |y|: per-sub-chunk sums [K, 16] (``mag="sums"``, call_planes_rssi and
     call_group) or the plane [16, F] (``mag="plane"``, call_planes).

``PfbDemod(device=)(band [2, nb], pfb_hist, parity, prev, ns, mag) ->
PfbOut(demod [16, F], mag, pfb_hist', parity', prev')``.  The demod is
exactly [16, F]: the JAX kernel's padded tiles, pre-sliced history rows,
phase-packed body and selector einsums are Mosaic workarounds and have no
counterpart.  Carried state as in the JAX kernel: pfb_hist (c64 [400], the
last band samples), parity (i32, the frame count mod 2), prev (c64 [16]).

The CUDA version (csrc/pfb_demod.cu, on csrc/pfb_demod.cuh, which K1
shares) runs three launches: the band history, the PFB into channel
planes, and the discriminator with the |y| sums or plane.  Bytes bound on
the H100 (~3 us at K = 40); see the source.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from sdr_pmr446_tpu_torch import config as C
from sdr_pmr446_tpu_torch.kernels import build
from sdr_pmr446_tpu_torch.ops import fm
from sdr_pmr446_tpu_torch.ops.pfb import PFBChannelizer, make_pfb_kernel
from sdr_pmr446_tpu_torch.taps import design as D

NCH = C.NUM_CHANNELS
MAG_FORMS = ("sums", "plane")
#: 1 / (2 pi kf) in f32: the discriminator's output scale
DEMOD_SCALE = float(np.float32(1.0 / (2.0 * math.pi * C.FM_KF)))

#: kernel launches of the CUDA version (one per call); the plain version
#: never counts
LAUNCHES = 0


@functools.lru_cache(maxsize=None)
def _kernel_planes(device: str):
    """(re, im) f32 [416, 16] of the fused PFB kernel on ``device``."""
    ck = make_pfb_kernel(D.pfb_prototype())
    return (torch.as_tensor(ck.real.astype(np.float32), device=device),
            torch.as_tensor(ck.imag.astype(np.float32), device=device))


def last_frame_output(tail_r: torch.Tensor, tail_i: torch.Tensor,
                      sign: torch.Tensor) -> torch.Tensor:
    """The 16 channel outputs of the final PFB frame, c64 [..., 16], from
    the last 416 band samples (planes tail_r, tail_i [..., 416]); ``sign``
    [...] = (-1)^(global index of that frame).  The discriminator's
    previous-sample halo of the time-sharded chains (parallel/): each shard
    computes its own last frame with one 416-tap dot and passes it right.
    Counterpart of the JAX kernels/pfb_demod.py::last_frame_output (plain
    ops outside any kernel, there as here)."""
    kr, ki = _kernel_planes(str(tail_r.device))
    lwr, lwi = tail_r[..., :, None], tail_i[..., :, None]
    y = torch.complex((lwr * kr - lwi * ki).sum(-2),
                      (lwr * ki + lwi * kr).sum(-2))
    return (y * sign[..., None]).to(torch.complex64)


class PfbOut(NamedTuple):
    demod: torch.Tensor       # f32 [16, F]
    mag: torch.Tensor         # f32 [K, 16] sums ("sums") / [16, F] ("plane")
    pfb_hist: torch.Tensor    # c64 [400]
    parity: torch.Tensor      # i32 []
    prev: torch.Tensor        # c64 [16]


class PfbDemod(nn.Module):
    """K7: the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors.  K1 (kernels/duo.py) runs ``plain`` after its front end."""

    def __init__(self, *, device):
        super().__init__()
        self.pfb = PFBChannelizer(D.pfb_prototype(), device=device)
        self.hist_len = self.pfb.hist_len
        ck = make_pfb_kernel(D.pfb_prototype())
        self.register_buffer("ck_re", torch.as_tensor(
            ck.real.astype(np.float32), device=device))
        self.register_buffer("ck_im", torch.as_tensor(
            ck.imag.astype(np.float32), device=device))

    def geometry(self, band: torch.Tensor, ns: int, mag: str):
        """(band samples nb, frames F, sub-chunks K; K = 0 for the plane)."""
        if mag not in MAG_FORMS:
            raise ValueError(f"mag must be one of {MAG_FORMS}, got {mag!r}")
        if band.dim() != 2 or band.shape[0] != 2:
            raise ValueError(f"band must be planes [2, nb], got "
                             f"{tuple(band.shape)}")
        nb = band.shape[1]
        if nb == 0 or nb % NCH:
            raise ValueError(f"{nb} band samples is not whole frames of {NCH}")
        f = nb // NCH
        if mag == "plane":
            return nb, f, 0
        if f % ns:
            raise ValueError(f"{f} frames is not whole sub-chunks of {ns}")
        return nb, f, f // ns

    def forward(self, band, pfb_hist, parity, prev,
                ns: int = C.SUBCHUNK_AUDIO, mag: str = "sums") -> PfbOut:
        if band.device.type == "cuda":
            return self.kernel(band, pfb_hist, parity, prev, ns, mag)
        if band.device.type == "cpu":
            return self.plain(band, pfb_hist, parity, prev, ns, mag)
        raise ValueError(f"no PFB-demod implementation for device "
                         f"{band.device}")

    def plain(self, band, pfb_hist, parity, prev,
              ns: int = C.SUBCHUNK_AUDIO, mag: str = "sums") -> PfbOut:
        """The same function in plain PyTorch ops (any device)."""
        _, _, k = self.geometry(band, ns, mag)
        (new_ph, new_parity), chan = self.pfb(
            (pfb_hist, parity), torch.complex(band[0], band[1]))
        new_prev, demod = fm.fm_demod(prev, chan)
        m = torch.abs(chan)
        if mag == "sums":
            m = m.reshape(NCH, k, ns).sum(-1).T
        return PfbOut(demod, m.contiguous(), new_ph.contiguous(), new_parity,
                      new_prev.contiguous())

    def check_state(self, pfb_hist, parity, prev, dev) -> None:
        """Raise unless the carried state and the taps suit the kernels."""
        build.require(pfb_hist, "pfb_hist", torch.complex64,
                      (self.hist_len,), dev)
        build.require(parity, "parity", torch.int32, (), dev)
        build.require(prev, "prev", torch.complex64, (NCH,), dev)
        for name in ("ck_re", "ck_im"):
            build.require(getattr(self, name), name, torch.float32, None, dev)

    def kernel(self, band, pfb_hist, parity, prev,
               ns: int = C.SUBCHUNK_AUDIO, mag: str = "sums") -> PfbOut:
        """Launch csrc/pfb_demod.cu on the current stream (raises on any
        fault)."""
        global LAUNCHES
        nb, f, k = self.geometry(band, ns, mag)
        dev = band.device
        build.require(band, "band", torch.float32, (2, nb), dev)
        self.check_state(pfb_hist, parity, prev, dev)
        f32 = dict(dtype=torch.float32, device=dev)
        c64 = dict(dtype=torch.complex64, device=dev)
        chan = torch.empty(2 * NCH * f, **f32)
        out = PfbOut(torch.empty((NCH, f), **f32),
                     torch.empty((k, NCH) if k else (NCH, f), **f32),
                     torch.empty(self.hist_len, **c64),
                     ((parity + f) % 2).to(torch.int32),
                     torch.empty(NCH, **c64))
        code = build.library().pfb_demod_run(
            band.data_ptr(), nb, pfb_hist.data_ptr(), parity.data_ptr(),
            prev.data_ptr(), self.ck_re.data_ptr(), self.ck_im.data_ptr(),
            DEMOD_SCALE, k, ns, chan.data_ptr(), out.pfb_hist.data_ptr(),
            out.demod.data_ptr(), out.mag.data_ptr(), out.prev.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
        build.check(code, "pfb_demod_run")
        LAUNCHES += 1
        return out
