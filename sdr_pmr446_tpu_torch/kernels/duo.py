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

The CUDA version (csrc/duo.cu) runs six launches on the current stream:
decode + chunk-local DC response, the chunk-carry scan, resampler (with
the DC fix-up fused into its shared-memory window load), state tail, PFB,
and discriminator + |y| sums.  Intermediates that reach device memory:
the chunk-local DC response (8 B/input sample), the band planes and the
channel planes (~1.6 B/input sample each).  The band planes are also an
output (``DuoOut.band``), the waterfall's input (K3, kernels/waterfall.py).
What bounds it on the H100:
the resampler (346 MACs x 2 planes per band sample, ~135 FLOP per input
sample) and the PFB (416 complex MACs per channel sample, ~130 FLOP per
input sample) are compute at ~0.3 GFLOP per K=40 block, tiny against the
card; the input read is 2-8 B/sample.  A first version is latency and
launch bound; fusing the six launches is later work.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from sdr_pmr446_tpu_torch import config as C
from sdr_pmr446_tpu_torch.taps import design as D
from sdr_pmr446_tpu_torch.kernels import build
from sdr_pmr446_tpu_torch.ops import decode, fm, iir
from sdr_pmr446_tpu_torch.ops.pfb import PFBChannelizer, make_pfb_kernel
from sdr_pmr446_tpu_torch.ops.resample import PolyResampler, _kernel_matrix

NCH = C.NUM_CHANNELS
#: samples per chunk of the CUDA DC-blocker scan (csrc/sdr_common.cuh DC_L)
DC_L = 64
#: threads of the chunk-carry scan block (csrc/sdr_common.cuh CARRY_THREADS)
CARRY_THREADS = 1024
_P = 1.0 - C.DC_BLOCK_ALPHA
_G = (1.0 + _P) / 2.0
FMT_CODE = {"cu8": 0, "cs8": 1, "cs16": 2, "cf32": 3}

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


def front_hist_len(fmt: str) -> int:
    """Carried DC-blocked history: 512 for the 2-byte formats, else 384
    (the JAX duo's wide-row / narrow-row geometries)."""
    return 512 if fmt in ("cu8", "cs8") else 384


def scan_constants(chunks: int):
    """(pL, pSeg, seg) float64 host constants of the chunk-carry scan:
    pL = p^DC_L, seg = chunks per carry thread, pSeg = pL^seg."""
    seg = max(1, math.ceil(chunks / CARRY_THREADS))
    p_l = _P ** DC_L
    return p_l, p_l ** seg, seg


def dc_powers() -> np.ndarray:
    """p^(j+1) for j < DC_L, float64 rounded once to f32."""
    return (_P ** (np.arange(DC_L, dtype=np.float64) + 1.0)).astype(np.float32)


def compact_phases(taps, L: int, M: int) -> np.ndarray:
    """f32 [L, P]: the rows of the polyphase kernel matrix without their zero
    padding, row p starting at its offset (p * M) // L — the resampler
    tables of the CUDA kernels (csrc/front_end.cuh, csrc/chan_tail.cu)."""
    kmat = _kernel_matrix(tuple(np.asarray(taps, np.float64).tolist()), L, M)
    p_taps = kmat.shape[1] - (L - 1) * M // L
    return np.stack([kmat[p, (p * M) // L:(p * M) // L + p_taps]
                     for p in range(L)]).astype(np.float32)


class FrontEnd(nn.Module):
    """The front end K1 shares with K4 (kernels/chan_tail.py): wire decode,
    the IQ DC blocker and the 25/128 resampler to the 200 kHz band.

    ``plain`` is its plain PyTorch version; the CUDA kernels read ``kc``
    (compact resampler phases) and ``pj`` (DC fix-up powers)."""

    def __init__(self, fmt: str, *, device):
        super().__init__()
        self.fmt = decode.wire_format(fmt)
        self.hist_len = front_hist_len(self.fmt)
        taps = D.resampler_taps()
        self.resampler = PolyResampler(taps, C.RESAMP_L, C.RESAMP_M, device)
        self.register_buffer("kc", torch.as_tensor(
            compact_phases(taps, C.RESAMP_L, C.RESAMP_M), device=device))
        self.register_buffer("pj", torch.as_tensor(dc_powers(), device=device))

    def samples(self, wire: torch.Tensor) -> int:
        """Input samples in ``wire`` (a multiple of INPUT_GRANULE)."""
        bps = decode.BYTES_PER_SAMPLE[self.fmt]
        if wire.dim() != 1 or wire.numel() % bps:
            raise ValueError(f"wire must be 1-D whole {self.fmt} samples")
        n = wire.numel() // bps
        if n % C.INPUT_GRANULE:
            raise ValueError(f"{n} samples is not a multiple of "
                             f"{C.INPUT_GRANULE}")
        return n

    def plain(self, wire, dc_x, dc_y, front_hist):
        """-> (dc_x', dc_y', front_hist', band planes f32 [2, nb])."""
        xr, xi = decode.decode_planes(wire, self.fmt)
        (ndx, ndy), y = iir.dc_blocker_apply(
            (torch.view_as_real(dc_x), torch.view_as_real(dc_y)),
            torch.stack([xr, xi]), C.DC_BLOCK_ALPHA)
        fh = torch.view_as_real(front_hist).T                    # [2, H]
        new_fh, band = self.resampler(fh, y)
        return (torch.complex(ndx[0], ndx[1]), torch.complex(ndy[0], ndy[1]),
                torch.complex(new_fh[0], new_fh[1]).contiguous(), band)

    def kernel_args(self, n: int, dev):
        """The front-end launches' scratch (ylocal, yend, carry) for ``n``
        input samples, and their C arguments (kc, pj, p, g, pL, pSeg, seg,
        inv_cu8) as the entry points duo_run and mono_run take them."""
        chunks = -(-n // DC_L)
        p_l, p_seg, seg = scan_constants(chunks)
        f32 = dict(dtype=torch.float32, device=dev)
        scratch = (torch.empty(2 * n, **f32), torch.empty(2 * chunks, **f32),
                   torch.empty(2 * chunks, **f32))
        for name in ("kc", "pj"):
            build.require(getattr(self, name), name, torch.float32, None, dev)
        return scratch, (self.kc.data_ptr(), self.pj.data_ptr(), _P, _G, p_l,
                         p_seg, seg, float(np.float32(1.0 / 127.5)))


class ScannerDuo(nn.Module):
    """K1 for one wire format.  ``module(wire, dc_x, dc_y, front_hist,
    pfb_hist, parity, prev, ns)`` -> DuoOut: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""

    def __init__(self, fmt: str, device):
        super().__init__()
        self.front = FrontEnd(fmt, device=device)
        self.fmt = self.front.fmt
        self.front_hist_len = self.front.hist_len
        self.pfb = PFBChannelizer(D.pfb_prototype(), device=device)
        ck = make_pfb_kernel(D.pfb_prototype())
        self.register_buffer("ck_re", torch.as_tensor(
            ck.real.astype(np.float32), device=device))
        self.register_buffer("ck_im", torch.as_tensor(
            ck.imag.astype(np.float32), device=device))

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
        _, _, f, k = self.geometry(wire, ns)
        ndx, ndy, new_fh, band = self.front.plain(wire, dc_x, dc_y,
                                                  front_hist)
        (new_ph, new_parity), chan = self.pfb(
            (pfb_hist, parity), torch.complex(band[0], band[1]))
        new_prev, demod = fm.fm_demod(prev, chan)
        mag = torch.abs(chan).reshape(NCH, k, ns).sum(-1).T
        return DuoOut(ndx, ndy, new_fh, demod, mag.contiguous(),
                      new_ph.contiguous(), new_parity, new_prev.contiguous(),
                      band)

    # ------------------------------------------------------------- cuda
    def kernel(self, wire, dc_x, dc_y, front_hist, pfb_hist, parity, prev,
             ns: int = C.SUBCHUNK_AUDIO) -> DuoOut:
        """Launch csrc/duo.cu on the current stream (raises on any fault)."""
        global LAUNCHES
        n, nb, f, k = self.geometry(wire, ns)
        dev = wire.device
        h = self.front_hist_len
        build.require(wire, "wire", torch.uint8, (wire.numel(),), dev)
        build.require(dc_x, "dc_x", torch.complex64, (), dev)
        build.require(dc_y, "dc_y", torch.complex64, (), dev)
        build.require(front_hist, "front_hist", torch.complex64, (h,), dev)
        build.require(pfb_hist, "pfb_hist", torch.complex64,
                      (self.pfb.hist_len,), dev)
        build.require(parity, "parity", torch.int32, (), dev)
        build.require(prev, "prev", torch.complex64, (NCH,), dev)
        for name in ("ck_re", "ck_im"):
            build.require(getattr(self, name), name, torch.float32, None, dev)
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
        kc, pj, p, g, p_l, p_seg, seg, inv_cu8 = fe_args
        code = lib.duo_run(
            FMT_CODE[self.fmt], wire.data_ptr(), n,
            dc_x.data_ptr(), dc_y.data_ptr(), front_hist.data_ptr(), h,
            pfb_hist.data_ptr(), parity.data_ptr(), prev.data_ptr(),
            kc, self.ck_re.data_ptr(), self.ck_im.data_ptr(), pj,
            p, g, p_l, p_seg, seg, inv_cu8,
            float(np.float32(1.0 / (2.0 * math.pi * C.FM_KF))), k, ns,
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
