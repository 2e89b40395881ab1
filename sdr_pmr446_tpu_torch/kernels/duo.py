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

Both versions run behind one ``torch.library`` custom op,
``sdr_pmr446::duo``: its CUDA implementation is the launch (registered
for "cuda" alone), its CPU implementation the plain version (for "cpu"
alone), and no other device has one.  The live chains and an exported
step (apps/export_chain.py) call the same op, whose fake implementation
gives torch.export the outputs' shapes; the tables reach it as tensor
arguments, and ``LAUNCHES`` counts in the CUDA implementation, so an
exported program's launches count too.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
from torch import nn

from sdr_pmr446_tpu_torch import config as C
from sdr_pmr446_tpu_torch.kernels import build
from sdr_pmr446_tpu_torch.kernels import front_end as fe
from sdr_pmr446_tpu_torch.kernels.front_end import FMT_CODE, FrontEnd
from sdr_pmr446_tpu_torch.kernels.pfb_demod import (DEMOD_SCALE, HIST_LEN,
                                                    PfbDemod)

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


def geometry(wire: torch.Tensor, fmt: str, ns: int):
    """(n input samples, band samples, frames F, sub-chunks K)."""
    n = fe.wire_samples(wire, fmt)
    nb = n * C.RESAMP_L // C.RESAMP_M
    f = nb // NCH
    if f % ns:
        raise ValueError(f"{f} frames is not whole sub-chunks of {ns}")
    return n, nb, f, f // ns


# ------------------------------------------------------ the custom op
# (dc_x', dc_y', front_hist', demod, mag_sums, pfb_hist', prev', band):
# DuoOut without the parity, which the wrapper forms outside the op

@functools.lru_cache(maxsize=None)
def _plain_module(fmt: str) -> "ScannerDuo":
    """The CPU module whose plain version the op's CPU implementation runs
    (its tables depend on nothing but the wire format)."""
    return ScannerDuo(fmt, device="cpu")


@torch.library.custom_op("sdr_pmr446::duo", mutates_args=(),
                         device_types="cpu")
def duo_op(wire: torch.Tensor, dc_x: torch.Tensor, dc_y: torch.Tensor,
           front_hist: torch.Tensor, pfb_hist: torch.Tensor,
           parity: torch.Tensor, prev: torch.Tensor, kt: torch.Tensor,
           pj: torch.Tensor, pfb_g: torch.Tensor, pfb_c: torch.Tensor,
           pfb_w: torch.Tensor, fmt: str, ns: int
           ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                      torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1 on CPU tensors: the plain version."""
    o = _plain_module(fmt).plain(wire, dc_x, dc_y, front_hist, pfb_hist,
                                 parity, prev, ns)
    return tuple(build.owned(t) for t in o[:6] + o[7:])


@duo_op.register_kernel("cuda")
def _duo_cuda(wire, dc_x, dc_y, front_hist, pfb_hist, parity, prev, kt, pj,
              pfb_g, pfb_c, pfb_w, fmt, ns):
    """K1 on CUDA tensors: csrc/duo.cu on the current stream (raises on any
    fault)."""
    global LAUNCHES
    n, nb, f, k = geometry(wire, fmt, ns)
    dev = wire.device
    h = front_hist.shape[0]
    fe.check_state(fmt, wire, dc_x, dc_y, front_hist)
    build.require(pfb_hist, "pfb_hist", torch.complex64, (HIST_LEN,), dev)
    build.require(parity, "parity", torch.int32, (), dev)
    build.require(prev, "prev", torch.complex64, (NCH,), dev)
    build.require(pfb_g, "pfb_g", torch.float32, None, dev)
    for name, t in (("pfb_c", pfb_c), ("pfb_w", pfb_w)):
        build.require(t, name, torch.complex64, (NCH,), dev)
    (ylocal, yend, carry), fe_args = fe.kernel_args(kt, pj, n, dev)
    f32 = dict(dtype=torch.float32, device=dev)
    c64 = dict(dtype=torch.complex64, device=dev)
    chan = torch.empty(2 * NCH * f, **f32)
    out = (torch.empty((), **c64), torch.empty((), **c64),
           torch.empty(h, **c64), torch.empty((NCH, f), **f32),
           torch.empty((k, NCH), **f32),
           torch.empty(pfb_hist.shape[0], **c64), torch.empty(NCH, **c64),
           torch.empty((2, nb), **f32))
    o_dcx, o_dcy, o_fh, o_demod, o_mag, o_ph, o_prev, band = out
    kt_p, pj_p, p, g, p_l, inv_cu8 = fe_args
    code = build.library().duo_run(
        FMT_CODE[fmt], wire.data_ptr(), n,
        dc_x.data_ptr(), dc_y.data_ptr(), front_hist.data_ptr(), h,
        pfb_hist.data_ptr(), parity.data_ptr(), prev.data_ptr(),
        kt_p, pfb_g.data_ptr(), pfb_c.data_ptr(), pfb_w.data_ptr(), pj_p,
        p, g, p_l, inv_cu8,
        DEMOD_SCALE, k, ns,
        ylocal.data_ptr(), yend.data_ptr(), carry.data_ptr(),
        band.data_ptr(), chan.data_ptr(),
        o_dcx.data_ptr(), o_dcy.data_ptr(), o_fh.data_ptr(),
        o_ph.data_ptr(), o_demod.data_ptr(), o_mag.data_ptr(),
        o_prev.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(code, "duo_run")
    LAUNCHES += 1
    return out


@duo_op.register_fake
def _duo_fake(wire, dc_x, dc_y, front_hist, pfb_hist, parity, prev, kt, pj,
              pfb_g, pfb_c, pfb_w, fmt, ns):
    _, nb, f, k = geometry(wire, fmt, ns)
    c64 = dict(dtype=torch.complex64)
    return (dc_x.new_empty((), **c64), dc_y.new_empty((), **c64),
            front_hist.new_empty(front_hist.shape, **c64),
            wire.new_empty((NCH, f), dtype=torch.float32),
            wire.new_empty((k, NCH), dtype=torch.float32),
            pfb_hist.new_empty(pfb_hist.shape, **c64),
            prev.new_empty((NCH,), **c64),
            wire.new_empty((2, nb), dtype=torch.float32))


class ScannerDuo(nn.Module):
    """K1 for one wire format.  ``module(wire, dc_x, dc_y, front_hist,
    pfb_hist, parity, prev, ns)`` -> DuoOut through ``sdr_pmr446::duo``:
    the CUDA kernel for CUDA tensors, the plain version for CPU tensors."""

    def __init__(self, fmt: str, device):
        super().__init__()
        self.front = FrontEnd(fmt, device=device)
        self.fmt = self.front.fmt
        self.front_hist_len = self.front.hist_len
        self.pfb = PfbDemod(device=device)

    def geometry(self, wire: torch.Tensor, ns: int):
        """(n input samples, band samples, frames F, sub-chunks K)."""
        return geometry(wire, self.fmt, ns)

    def forward(self, wire, dc_x, dc_y, front_hist, pfb_hist, parity, prev,
                ns: int = C.SUBCHUNK_AUDIO) -> DuoOut:
        if wire.device.type not in ("cuda", "cpu"):
            raise ValueError(f"no duo implementation for device "
                             f"{wire.device}")
        _, _, f, _ = self.geometry(wire, ns)
        o = duo_op(wire, dc_x, dc_y, front_hist, pfb_hist, parity, prev,
                   self.front.kt, self.front.pj, self.pfb.pfb_g,
                   self.pfb.pfb_c, self.pfb.pfb_w, self.fmt, ns)
        return DuoOut(*o[:6], ((parity + f) % 2).to(torch.int32), *o[6:])

    # ------------------------------------------------------------ plain
    def plain(self, wire, dc_x, dc_y, front_hist, pfb_hist, parity, prev,
              ns: int = C.SUBCHUNK_AUDIO) -> DuoOut:
        """The same function in plain PyTorch ops (any device)."""
        self.geometry(wire, ns)
        fe_out = self.front.plain(wire, dc_x, dc_y, front_hist)
        p = self.pfb.plain(fe_out.band, pfb_hist, parity, prev, ns)
        return DuoOut(fe_out.dc_x, fe_out.dc_y, fe_out.front_hist, p.demod,
                      p.mag, p.pfb_hist, p.parity, p.prev, fe_out.band)

    # ------------------------------------------------------------- cuda
    def kernel(self, wire, dc_x, dc_y, front_hist, pfb_hist, parity, prev,
               ns: int = C.SUBCHUNK_AUDIO) -> DuoOut:
        """The op on CUDA tensors: csrc/duo.cu on the current stream."""
        if wire.device.type != "cuda":
            raise ValueError(f"the duo kernel takes CUDA tensors, got "
                             f"{wire.device}")
        return self(wire, dc_x, dc_y, front_hist, pfb_hist, parity, prev, ns)
