"""K7: the 16-channel PFB + NBFM discriminator, CUDA kernel and plain version.

Replaces the TPU kernel sdr_pmr446_tpu/kernels/pfb_demod.py::PallasPfbDemod
(``call_planes``, ``call_planes_rssi``, ``call_group`` and
``_call_group_packed``).  On the band planes of K6 (kernels/front_end.py)
or K9 (kernels/resample_kernel.py) it computes

  1. the 16-channel PFB: 416-tap prototype x DFT16 x the -93.75 kHz mixer
     folded into one [416, 16] complex kernel, with the (-1)^(parity +
     frame) flip (ops/pfb.py); the CUDA version runs it factored
     (``pfb_factors``): 16 branch sums of 26 real taps, a twiddle each and
     one 16-point DFT a frame;
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
#: carried band samples: the 2 * 16 * 13 = 416-tap prototype less a frame
HIST_LEN = 2 * NCH * C.PFB_SEMILENGTH - NCH
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


def pfb_factors(prototype: np.ndarray, num_channels: int = NCH,
                mix_omega: float = C.MIX_OMEGA):
    """The factors of ``make_pfb_kernel``'s CK, float64: (g [P / M, M] real,
    c [M], w [M]) with CK[M m + r, k] = g[m, r] c[r] w[(k r) % M].

    t = M m + r splits CK[t, k] = h[P-1-t] e^{j(-2 pi k t / M + w_mix (t -
    (P - M)))} into h[P-1-M m-r] e^{j M w_mix m} (real: M w_mix is an odd
    multiple of pi, so e^{j M w_mix m} = (-1)^m), c[r] = e^{j w_mix (r -
    (P - M))} and the DFT roots w[e] = e^{-2 pi j e / M}."""
    h = np.asarray(prototype, dtype=np.float64)
    n = h.shape[0]
    turns = num_channels * mix_omega / np.pi
    if n % num_channels or abs(turns - round(turns)) > 1e-9 \
            or round(turns) % 2 != 1:
        raise ValueError("the PFB factors need whole branches and an odd "
                         "multiple of pi for M * mix_omega")
    t = np.arange(n).reshape(-1, num_channels)              # t = M m + r
    m = np.arange(t.shape[0])[:, None]
    g = h[n - 1 - t] * (1.0 - 2.0 * (m % 2))
    r = np.arange(num_channels)
    c = np.exp(1j * mix_omega * (r - (n - num_channels)))
    w = np.exp(-2j * np.pi * r / num_channels)
    return g, c, w


def last_frame_output(tail_r: torch.Tensor, tail_i: torch.Tensor,
                      sign: torch.Tensor) -> torch.Tensor:
    """The 16 channel outputs of the final PFB frame, c64 [..., 16], from
    the last 416 band samples (planes tail_r, tail_i [..., 416]); ``sign``
    [...] = (-1)^(global index of that frame).  The discriminator's
    previous-sample halo of the time-sharded chains (parallel/): each shard
    computes its own last frame with one 416-tap dot and passes it right.
    Counterpart of the JAX kernels/pfb_demod.py::last_frame_output (plain
    ops outside any kernel, there as here).  Its kernel planes are cached
    per device at first use, for the sharded chains, which no export
    reaches: under ``torch.export`` it raises."""
    if torch.compiler.is_exporting():
        raise RuntimeError("an exported step reaches last_frame_output, "
                           "whose tables are built at first use")
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
        g, c, w = pfb_factors(D.pfb_prototype())
        # the CUDA filterbank's tables: branch taps, twiddles, DFT roots
        self.register_buffer("pfb_g", torch.as_tensor(g.astype(np.float32),
                                                      device=device))
        self.register_buffer("pfb_c", torch.as_tensor(c.astype(np.complex64),
                                                      device=device))
        self.register_buffer("pfb_w", torch.as_tensor(w.astype(np.complex64),
                                                      device=device))

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
        build.require(self.pfb_g, "pfb_g", torch.float32, None, dev)
        for name in ("pfb_c", "pfb_w"):
            build.require(getattr(self, name), name, torch.complex64, (NCH,),
                          dev)

    def factor_ptrs(self):
        """The C arguments (pg, pc, pw) of the factored filterbank."""
        return (self.pfb_g.data_ptr(), self.pfb_c.data_ptr(),
                self.pfb_w.data_ptr())

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
            prev.data_ptr(), *self.factor_ptrs(), DEMOD_SCALE, k, ns, chan.data_ptr(), out.pfb_hist.data_ptr(),
            out.demod.data_ptr(), out.mag.data_ptr(), out.prev.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
        build.check(code, "pfb_demod_run")
        LAUNCHES += 1
        return out
