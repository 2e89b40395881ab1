"""K3: the waterfall's hop-PSD spectrogram, CUDA kernel and plain version.

Replaces the TPU kernel sdr_pmr446_tpu/kernels/duo.py::_wf_epilogue (the
hop-PSD epilogue inside PallasScannerDuo.apply when ``waterfall_w > 0``)
together with the XLA ``asgram_rows(_any)_p`` tap the JAX chain takes at
the widths and K that epilogue cannot serve.  For one block of band planes
it computes the waterfall rows of ops/spectrogram.py: ``w/2``-sample
Hamming windows at a stride of ``w/4``, ``|S|^2`` of each zero-padded
``w``-point DFT summed per sub-chunk, each row the dB average fftshifted.

``module(band, hist, cnt)`` -> WfOut: ``band`` f32 [2, K*19600] (K1's band
planes), ``hist`` c64 whose last ``w/2`` samples precede the block, ``cnt``
i32 [] the carried in-hop counter.  The CUDA version (csrc/waterfall.cu) is
two launches on the current stream, deterministic, with no host read: the
counter is read on the device.  The plain version is
ops/spectrogram.py::asgram_rows_any_p.  What bounds it on the H100 is
written in the CUDA source: bytes for the function, its own direct-DFT
operations for this first version.

Size: the window x DFT table lives on the device, w*w*4 bytes (25.6 KB at
w = 80, 2.8 MB at 840, 67 MB at 4096, 268 MB at 8192; the widest width
validate_width accepts, 78400, would need 24.6 GB), and the direct DFT does
w*w/2 complex multiply-adds a hop, summed in double (f32 sums of 4096
terms missed the 2e-3 dB gate at w = 8192).  Every accepted width runs at
every K as far as the table fits on the device; chip_smoke.py checks widths
64 to 8192 against the plain version.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from sdr_pmr446_tpu_torch import config as C
from sdr_pmr446_tpu_torch.kernels import build
from sdr_pmr446_tpu_torch.ops import spectrogram

#: threads of each block (csrc/waterfall.cu WF_THREADS)
THREADS = 256
#: hops per thread and slab (csrc/waterfall.cu WF_HOPS)
HOPS_PER_THREAD = 16

#: kernel launches of the CUDA version (one per call); the plain version
#: never counts
LAUNCHES = 0


class WfOut(NamedTuple):
    hist: torch.Tensor   # c64 [w/2]  the last w/2 samples of [hist | band]
    cnt: torch.Tensor    # i32 []     (cnt + K*19600) mod (w/4)
    rows: torch.Tensor   # f32 [K, w] dB, fftshifted


def dft_table(w: int) -> np.ndarray:
    """f32 [w/2, w, 2]: the complex window x DFT table, entry (j, f) =
    win[j] * exp(-2 pi i j f / w) — the content of
    ops/spectrogram._dft_win_packed(w), computed the same way in float64 and
    rounded once, but built a slab of rows at a time so that the host holds
    little more than the table itself (w*w*4 bytes, as on the card)."""
    wl = w // 2
    win = spectrogram._window(w).astype(np.float64)
    k = np.arange(w)[None, :]
    tab = np.empty((wl, w, 2), np.float32)
    step = max(1, (1 << 22) // w)
    for j0 in range(0, wl, step):
        j = np.arange(j0, min(wl, j0 + step))[:, None]
        th = 2.0 * np.pi * j * k / w
        wj = win[j0:j0 + j.shape[0], None]
        tab[j0:j0 + j.shape[0], :, 0] = np.cos(th) * wj
        tab[j0:j0 + j.shape[0], :, 1] = -(np.sin(th) * wj)
    return tab


def slab_geometry(w: int):
    """(hops per slab, slabs per row) of the partials launch: a slab gives
    each thread HOPS_PER_THREAD hops, and the slabs cover the most hops a
    row can hold."""
    groups = max(1, THREADS // w)
    slab_hops = groups * HOPS_PER_THREAD
    max_row_hops = C.SUBCHUNK_RESAMP // (w // 4) + 1
    return slab_hops, -(-max_row_hops // slab_hops)


class Waterfall(nn.Module):
    """K3 for one width ``w``: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""

    def __init__(self, w: int, device):
        super().__init__()
        spectrogram.validate_width(w)
        if w <= 0:
            raise ValueError(f"waterfall width {w}: the waterfall is off")
        self.w = w
        self.wl = spectrogram.hist_len(w)
        self.register_buffer("tab", torch.as_tensor(dft_table(w),
                                                    device=device))

    def rows_in(self, band: torch.Tensor) -> int:
        """Sub-chunks K in ``band`` [2, K*19600]."""
        sub = C.SUBCHUNK_RESAMP
        if band.dim() != 2 or band.shape[0] != 2 or band.shape[1] % sub:
            raise ValueError(f"band must be [2, K*{sub}] planes, "
                             f"got {tuple(band.shape)}")
        return band.shape[1] // sub

    def forward(self, band, hist, cnt) -> WfOut:
        if band.device.type == "cuda":
            return self.kernel(band, hist, cnt)
        if band.device.type == "cpu":
            return self.plain(band, hist, cnt)
        raise ValueError(f"no waterfall implementation for device "
                         f"{band.device}")

    def plain(self, band, hist, cnt) -> WfOut:
        """The same function in plain PyTorch ops (any device)."""
        k = self.rows_in(band)
        if hist.dim() != 1 or hist.shape[0] < self.wl:
            raise ValueError(f"hist needs >= {self.wl} samples")
        return WfOut(*spectrogram.asgram_rows_any_p(
            hist[hist.shape[0] - self.wl:], cnt, band[0], band[1], k, self.w))

    def kernel(self, band, hist, cnt) -> WfOut:
        """Launch csrc/waterfall.cu on the current stream (raises on any
        fault)."""
        global LAUNCHES
        k = self.rows_in(band)
        dev = band.device
        nb = band.shape[1]
        build.require(band, "band", torch.float32, (2, nb), dev)
        build.require(hist, "hist", torch.complex64, None, dev)
        if hist.dim() != 1 or hist.shape[0] < self.wl:
            raise ValueError(f"hist needs >= {self.wl} samples")
        build.require(cnt, "cnt", torch.int32, (), dev)
        build.require(self.tab, "tab", torch.float32, (self.wl, self.w, 2),
                      dev)
        slab_hops, slabs = slab_geometry(self.w)
        part = torch.empty((k, slabs, self.w), dtype=torch.float32,
                           device=dev)
        out = WfOut(torch.empty(self.wl, dtype=torch.complex64, device=dev),
                    torch.empty((), dtype=torch.int32, device=dev),
                    torch.empty((k, self.w), dtype=torch.float32, device=dev))
        code = build.library().wf_run(
            band.data_ptr(), nb, hist.data_ptr(), hist.shape[0],
            cnt.data_ptr(), self.tab.data_ptr(), self.w, k, C.SUBCHUNK_RESAMP,
            slab_hops, slabs, part.data_ptr(), out.rows.data_ptr(),
            out.hist.data_ptr(), out.cnt.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
        build.check(code, "wf_run")
        LAUNCHES += 1
        return out
