"""K6: the scanner front end alone, CUDA kernel and plain version.

Replaces the TPU kernel sdr_pmr446_tpu/kernels/front_end.py::PallasFrontEnd
(``_call``, ``_call_group`` and ``_call_wide``, behind ``apply_packed2``
(cu8/cs8), ``apply_packed`` (cs16), ``apply_interleaved`` / ``apply_iq``
(cf32) and ``apply_planes``).  For one block of wire bytes it computes

  1. wire decode (cu8, cs8, cs16, cf32);
  2. the IQ DC blocker y[n] = p*y[n-1] + g*(x[n] - x[n-1]), alpha = 5e-4;
  3. the 25/128 polyphase resampler to the 200 kHz band.

``FrontEnd(fmt)(wire, dc_x, dc_y, front_hist) -> FrontOut(dc_x', dc_y',
front_hist', band f32 [2, nb])``.  Carried state as in the JAX kernel:
dc_x, dc_y (c64) and front_hist (c64 [512] for cu8/cs8, [384] otherwise:
the last DC-blocked samples, in y space).  The JAX kernel's row layout
[T/128, 25] and group layout [G, 400] are both free views of the band
planes (``band.view(2, -1, 25)``, ``band.view(2, -1, 400)``), so
``group_out`` has no counterpart, and every K is served (the JAX group
output needs K % 8 == 0).  JAX's ``apply_planes`` computes the same
function from decoded f32 planes: here the cf32 wire carries them.

The same front end runs inside K1 (kernels/duo.py) and K4
(kernels/chan_tail.py).  The CUDA version (csrc/front_end.cu, on
csrc/front_end.cuh) runs four launches: decode + chunk-local DC response,
the chunk-carry scan, the resampler (the DC fix-up fused into its
shared-memory window load; a register-tiled product over the staged taps,
``staged_taps``) and the carried state.  What bounds it on the H100 is
operations, ~280 f32 operations an input sample, most of them the 346-tap
resampler on two planes (~17 us at K = 40 cu8); see the source.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from sdr_pmr446_tpu_torch import config as C
from sdr_pmr446_tpu_torch.kernels import build
from sdr_pmr446_tpu_torch.ops import decode, iir
from sdr_pmr446_tpu_torch.ops.resample import PolyResampler, _kernel_matrix
from sdr_pmr446_tpu_torch.taps import design as D

#: samples per chunk of the CUDA DC-blocker scan (csrc/sdr_common.cuh DC_L)
DC_L = 64
_P = 1.0 - C.DC_BLOCK_ALPHA
_G = (1.0 + _P) / 2.0
#: p^DC_L in float64: the chunk-carry scan's multiplier (dc_carry_kernel)
P_L = _P ** DC_L
FMT_CODE = {"cu8": 0, "cs8": 1, "cs16": 2, "cf32": 3}

#: kernel launches of the CUDA version (one per call); the plain version
#: never counts
LAUNCHES = 0


class FrontOut(NamedTuple):
    dc_x: torch.Tensor        # c64 []
    dc_y: torch.Tensor        # c64 []
    front_hist: torch.Tensor  # c64 [H]
    band: torch.Tensor        # f32 [2, nb]  band planes


def front_hist_len(fmt: str) -> int:
    """Carried DC-blocked history: 512 for the 2-byte formats, else 384
    (the JAX front end's wide-row / narrow-row geometries)."""
    return 512 if fmt in ("cu8", "cs8") else 384


def dc_powers() -> np.ndarray:
    """p^(j+1) for j < DC_L, float64 rounded once to f32."""
    return (_P ** (np.arange(DC_L, dtype=np.float64) + 1.0)).astype(np.float32)


def compact_phases(taps, L: int, M: int) -> np.ndarray:
    """f32 [L, P]: the rows of the polyphase kernel matrix without their zero
    padding, row p starting at its offset (p * M) // L — the upsampler
    table of csrc/chan_tail.cu, and what ``staged_taps`` stages."""
    kmat = _kernel_matrix(tuple(np.asarray(taps, np.float64).tolist()), L, M)
    p_taps = kmat.shape[1] - (L - 1) * M // L
    return np.stack([kmat[p, (p * M) // L:(p * M) // L + p_taps]
                     for p in range(L)]).astype(np.float32)


#: the CUDA resampler's tile (csrc/front_end.cuh RS_Q, RS_QP, RS_SPLIT,
#: RS_SEG, RS_OFF1): phases a thread, the staged row, row segments of a
#: half, rows a segment, and the second half's first window offset
RS_Q, RS_QP, RS_SPLIT, RS_SEG, RS_OFF1 = 13, 16, 4, 102, 66


def staged_taps(kc: np.ndarray, M: int = C.RESAMP_M) -> np.ndarray:
    """f32 [2, RS_SPLIT * RS_SEG, RS_QP]: the CUDA resampler's shared-memory
    tap table from the compact phases ``kc`` [L, P].  The band is the product
    band[f, q] = sum_j win[M f + j] B[j, q] with B[j, q] = kc[q, j - o_q],
    o_q = (M q) // L; half h holds phases RS_Q h .. RS_Q h + RS_Q - 1 (a zero
    column past the last), row i of it B[o_(RS_Q h) + i, :], zero outside
    the taps.  The same f32 values as ``kc``, moved."""
    L, P = kc.shape
    offs = [(q * M) // L for q in range(L)]
    if offs[RS_Q] != RS_OFF1:
        raise ValueError(f"phase {RS_Q} starts at {offs[RS_Q]}, the kernel "
                         f"expects {RS_OFF1}")
    out = np.zeros((2, RS_SPLIT * RS_SEG, RS_QP), np.float32)
    for q in range(L):
        h, qq = divmod(q, RS_Q)
        row = offs[q] - offs[RS_Q * h]
        if row + P > out.shape[1]:
            raise ValueError(f"phase {q} overruns the staged rows")
        out[h, row:row + P, qq] = kc[q]
    return out


def kernel_args(kt: torch.Tensor, pj: torch.Tensor, n: int, dev):
    """The front-end launches' scratch (ylocal, yend, carry) for ``n`` input
    samples on ``dev``, and their C arguments (kt, pj, p, g, pL, inv_cu8)
    from the staged taps ``kt`` and the DC fix-up powers ``pj``."""
    chunks = -(-n // DC_L)
    f32 = dict(dtype=torch.float32, device=dev)
    scratch = (torch.empty(2 * n, **f32), torch.empty(2 * chunks, **f32),
               torch.empty(2 * chunks, **f32))
    build.require(kt, "kt", torch.float32, None, dev)
    build.require(pj, "pj", torch.float32, (DC_L,), dev)
    return scratch, (kt.data_ptr(), pj.data_ptr(), _P, _G, P_L,
                     float(np.float32(1.0 / 127.5)))


def check_state(fmt: str, wire, dc_x, dc_y, front_hist) -> None:
    """Raise unless the wire and the carried state suit the kernels."""
    dev = wire.device
    build.require(wire, "wire", torch.uint8, (wire.numel(),), dev)
    build.require(dc_x, "dc_x", torch.complex64, (), dev)
    build.require(dc_y, "dc_y", torch.complex64, (), dev)
    build.require(front_hist, "front_hist", torch.complex64,
                  (front_hist_len(fmt),), dev)


def wire_samples(wire: torch.Tensor, fmt: str) -> int:
    """Input samples in ``wire`` of format ``fmt`` (a multiple of
    INPUT_GRANULE)."""
    bps = decode.BYTES_PER_SAMPLE[fmt]
    if wire.dim() != 1 or wire.numel() % bps:
        raise ValueError(f"wire must be 1-D whole {fmt} samples")
    n = wire.numel() // bps
    if n % C.INPUT_GRANULE:
        raise ValueError(f"{n} samples is not a multiple of "
                         f"{C.INPUT_GRANULE}")
    return n


class FrontEnd(nn.Module):
    """K6 for one wire format: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors.  K1 and K4 run ``plain`` and read ``kt``
    (the staged resampler taps) and ``pj`` (DC fix-up powers) too."""

    def __init__(self, fmt: str, *, device):
        super().__init__()
        self.fmt = decode.wire_format(fmt)
        self.hist_len = front_hist_len(self.fmt)
        taps = D.resampler_taps()
        self.resampler = PolyResampler(taps, C.RESAMP_L, C.RESAMP_M, device)
        self.register_buffer("kt", torch.as_tensor(staged_taps(
            compact_phases(taps, C.RESAMP_L, C.RESAMP_M)), device=device))
        self.register_buffer("pj", torch.as_tensor(dc_powers(), device=device))

    def samples(self, wire: torch.Tensor) -> int:
        """Input samples in ``wire`` (a multiple of INPUT_GRANULE)."""
        return wire_samples(wire, self.fmt)

    def forward(self, wire, dc_x, dc_y, front_hist) -> FrontOut:
        if wire.device.type == "cuda":
            return self.kernel(wire, dc_x, dc_y, front_hist)
        if wire.device.type == "cpu":
            return self.plain(wire, dc_x, dc_y, front_hist)
        raise ValueError(f"no front-end implementation for device "
                         f"{wire.device}")

    def plain(self, wire, dc_x, dc_y, front_hist) -> FrontOut:
        """The same function in plain PyTorch ops (any device)."""
        self.samples(wire)
        xr, xi = decode.decode_planes(wire, self.fmt)
        (ndx, ndy), y = iir.dc_blocker_apply(
            (torch.view_as_real(dc_x), torch.view_as_real(dc_y)),
            torch.stack([xr, xi]), C.DC_BLOCK_ALPHA)
        fh = torch.view_as_real(front_hist).T                    # [2, H]
        new_fh, band = self.resampler(fh, y)
        return FrontOut(torch.complex(ndx[0], ndx[1]),
                        torch.complex(ndy[0], ndy[1]),
                        torch.complex(new_fh[0], new_fh[1]).contiguous(),
                        band)

    def kernel_args(self, n: int, dev):
        """The front-end launches' scratch (ylocal, yend, carry) for ``n``
        input samples, and their C arguments (kt, pj, p, g, pL, inv_cu8) as
        the entry points fe_run, duo_run and mono_run take them."""
        return kernel_args(self.kt, self.pj, n, dev)

    def check_state(self, wire, dc_x, dc_y, front_hist) -> None:
        """Raise unless the wire and the carried state suit the kernels."""
        check_state(self.fmt, wire, dc_x, dc_y, front_hist)

    def kernel(self, wire, dc_x, dc_y, front_hist) -> FrontOut:
        """Launch csrc/front_end.cu on the current stream (raises on any
        fault)."""
        global LAUNCHES
        n = self.samples(wire)
        dev = wire.device
        self.check_state(wire, dc_x, dc_y, front_hist)
        (ylocal, yend, carry), fe_args = self.kernel_args(n, dev)
        c64 = dict(dtype=torch.complex64, device=dev)
        out = FrontOut(torch.empty((), **c64), torch.empty((), **c64),
                       torch.empty(self.hist_len, **c64),
                       torch.empty((2, n * C.RESAMP_L // C.RESAMP_M),
                                   dtype=torch.float32, device=dev))
        code = build.library().fe_run(
            FMT_CODE[self.fmt], wire.data_ptr(), n, dc_x.data_ptr(),
            dc_y.data_ptr(), front_hist.data_ptr(), self.hist_len, *fe_args,
            ylocal.data_ptr(), yend.data_ptr(), carry.data_ptr(),
            out.band.data_ptr(), out.dc_x.data_ptr(), out.dc_y.data_ptr(),
            out.front_hist.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
        build.check(code, "fe_run")
        LAUNCHES += 1
        return out
