"""K1: the scanner front end + channelizer ("duo"), CUDA kernel and plain version.

Replaces the TPU kernel sdr_pmr446_tpu/kernels/duo.py::PallasScannerDuo.apply
(bodies ``_duo_body_pk2`` / ``_duo_body_cs16`` / ``_duo_body_ilv`` and
``_pfb_tail`` -> kernels/pfb_demod.py::_pfb_group_core).  For one block of
wire bytes it computes

  1. wire decode (cu8, cs8, cs16, cf32);
  2. the IQ DC blocker y[n] = p*y[n-1] + g*(x[n] - x[n-1]), alpha = 5e-4;
  3. the 25/128 polyphase resampler to the 200 kHz band;
  4. the 16-channel PFB with the (-1)^(parity + frame) mixer flip;
  5. the NBFM discriminator (kf = 0.5) against the carried previous frame;
  6. per-sub-chunk sums of |y| per channel (the RSSI input).

Carried state, identical in meaning and shape to the JAX duo's, so a JAX
state loads into the port unchanged: dc_x, dc_y (c64), front_hist (c64
[512] for cu8/cs8, [384] otherwise — the last DC-blocked samples, in y
space), pfb_hist (c64 [400] band samples), parity (i32), prev (c64 [16]).

It is K6 (kernels/front_end.py) followed by K7 (kernels/pfb_demod.py), and
its plain version is theirs, one after the other.  The CUDA version
(csrc/duo.cu, on the headers K6 and K7 share) runs six launches on the
current stream: decode + chunk-local DC response, the chunk-carry scan,
resampler (with the DC fix-up fused into its shared-memory window load),
state tail, PFB, and discriminator + |y| sums.  Intermediates that reach
device memory: the chunk-local DC response (8 B/input sample), the band
planes and the channel planes (~1.6 B/input sample each).  The band planes
are also an output (``DuoOut.band``), the waterfall's input (K3,
kernels/waterfall.py).  What bounds it on the H100: the resampler (346
MACs x 2 planes per band sample, ~135 FLOP per input sample), a
register-tiled product over shared-memory taps, is compute at ~1.1 GFLOP
per K = 40 block; the PFB, as 26-tap branch sums and a 16-point DFT
(~2,100 FLOP a frame), and the 2-8 B/sample input read are small beside
it.  Fusing the six launches is later work.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from sdr_pmr446_tpu_torch import config as C
from sdr_pmr446_tpu_torch.kernels import build
from sdr_pmr446_tpu_torch.kernels.front_end import FMT_CODE, FrontEnd
from sdr_pmr446_tpu_torch.kernels.pfb_demod import DEMOD_SCALE, PfbDemod

NCH = C.NUM_CHANNELS

#: kernel launches of the CUDA version (one per duo call); the plain
#: version never counts
LAUNCHES = 0


class DuoOut(NamedTuple):
    dc_x: torch.Tensor        # c64 []
    dc_y: torch.Tensor        # c64 []
    front_hist: torch.Tensor  # c64 [H]
    demod: torch.Tensor       # f32 [16, F]
    mag_sums: torch.Tensor    # f32 [K, 16]  sum of |y| per sub-chunk
    pfb_hist: torch.Tensor    # c64 [400]
    parity: torch.Tensor      # i32 []
    prev: torch.Tensor        # c64 [16]
    band: torch.Tensor        # f32 [2, nb]  band planes (K3's input)


class ScannerDuo(nn.Module):
    """K1 for one wire format.  ``module(wire, dc_x, dc_y, front_hist,
    pfb_hist, parity, prev, ns)`` -> DuoOut: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""

    def __init__(self, fmt: str, device):
        super().__init__()
        self.front = FrontEnd(fmt, device=device)
        self.fmt = self.front.fmt
        self.front_hist_len = self.front.hist_len
        self.pfb = PfbDemod(device=device)

    def geometry(self, wire: torch.Tensor, ns: int):
        """(n input samples, band samples, frames F, sub-chunks K)."""
        n = self.front.samples(wire)
        nb = n * C.RESAMP_L // C.RESAMP_M
        f = nb // NCH
        if f % ns:
            raise ValueError(f"{f} frames is not whole sub-chunks of {ns}")
        return n, nb, f, f // ns

    def forward(self, wire, dc_x, dc_y, front_hist, pfb_hist, parity, prev,
                ns: int = C.SUBCHUNK_AUDIO) -> DuoOut:
        if wire.device.type == "cuda":
            return self.kernel(wire, dc_x, dc_y, front_hist, pfb_hist, parity,
                             prev, ns)
        if wire.device.type == "cpu":
            return self.plain(wire, dc_x, dc_y, front_hist, pfb_hist, parity,
                              prev, ns)
        raise ValueError(f"no duo implementation for device {wire.device}")

    # ------------------------------------------------------------ plain
    def plain(self, wire, dc_x, dc_y, front_hist, pfb_hist, parity, prev,
              ns: int = C.SUBCHUNK_AUDIO) -> DuoOut:
        """The same function in plain PyTorch ops (any device)."""
        self.geometry(wire, ns)
        fe = self.front.plain(wire, dc_x, dc_y, front_hist)
        p = self.pfb.plain(fe.band, pfb_hist, parity, prev, ns)
        return DuoOut(fe.dc_x, fe.dc_y, fe.front_hist, p.demod, p.mag,
                      p.pfb_hist, p.parity, p.prev, fe.band)

    # ------------------------------------------------------------- cuda
    def kernel(self, wire, dc_x, dc_y, front_hist, pfb_hist, parity, prev,
             ns: int = C.SUBCHUNK_AUDIO) -> DuoOut:
        """Launch csrc/duo.cu on the current stream (raises on any fault)."""
        global LAUNCHES
        n, nb, f, k = self.geometry(wire, ns)
        dev = wire.device
        h = self.front_hist_len
        self.front.check_state(wire, dc_x, dc_y, front_hist)
        self.pfb.check_state(pfb_hist, parity, prev, dev)
        (ylocal, yend, carry), fe_args = self.front.kernel_args(n, dev)
        f32 = dict(dtype=torch.float32, device=dev)
        c64 = dict(dtype=torch.complex64, device=dev)
        band = torch.empty((2, nb), **f32)
        chan = torch.empty(2 * NCH * f, **f32)
        out = DuoOut(torch.empty((), **c64), torch.empty((), **c64),
                     torch.empty(h, **c64), torch.empty((NCH, f), **f32),
                     torch.empty((k, NCH), **f32),
                     torch.empty(self.pfb.hist_len, **c64),
                     ((parity + f) % 2).to(torch.int32),
                     torch.empty(NCH, **c64), band)
        lib = build.library()
        kt, pj, p, g, p_l, inv_cu8 = fe_args
        code = lib.duo_run(
            FMT_CODE[self.fmt], wire.data_ptr(), n,
            dc_x.data_ptr(), dc_y.data_ptr(), front_hist.data_ptr(), h,
            pfb_hist.data_ptr(), parity.data_ptr(), prev.data_ptr(),
            kt, *self.pfb.factor_ptrs(), pj,
            p, g, p_l, inv_cu8,
            DEMOD_SCALE, k, ns,
            ylocal.data_ptr(), yend.data_ptr(), carry.data_ptr(),
            band.data_ptr(), chan.data_ptr(),
            out.dc_x.data_ptr(), out.dc_y.data_ptr(),
            out.front_hist.data_ptr(), out.pfb_hist.data_ptr(),
            out.demod.data_ptr(), out.mag_sums.data_ptr(),
            out.prev.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
        build.check(code, "duo_run")
        LAUNCHES += 1
        return out
