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
two to four launches on the current stream, deterministic, with no host
read: the counter is read on the device.  The plain version is
ops/spectrogram.py::asgram_rows_any_p, the direct DFT in double.

The kernel runs FFTs in shared memory, in double, on the float64 window
(``window64``; the plain version keeps the JAX package's f32 constants), by
the plan that ``make_plan`` builds in float64 on the host (O(w) tables on
the device; ``Waterfall(78400)``, the widest width, holds 4.8 MB):

- the transform length M is w when w is a power of two, or a product of
  2, 3, 5 and 7 up to CAP (80, 120, 200, 840: one mixed-radix transform);
  else Bluestein's chirp-z on the smallest power of two M >= w/2 + w - 1
  (w = 132: 256; w = 78400: 131072), with the windowed chirp ``pre`` and
  the transformed chirp filter ``filt``;
- each FFT is Stockham, its first stage read straight from its source and
  the rest between two shared-memory buffers: a radix-2, 4 or 8 stage
  first when the power of two in M is not a power of 16, radix-16 stages,
  then radix 3, 5 and 7 (``radices``), its twiddles laid out stage by stage
  so that neighbouring butterflies read neighbouring entries
  (``stage_twiddles``);
- M <= CAP (4096 points) runs whole transforms in one block, ``nt`` =
  max(1, BATCH / M) hops at once, a slab of a row's hops a block
  (``slab_geometry``, sized from the launch's occupancy); above it the
  four-step split M = m1 * (M/m1), m1 = 2^floor(log2 M / 2), through a
  [hops, M] c128 scratch (two for Bluestein), one partial row a hop.

Shared memory a block is 2*nt*M*16 + 8w bytes (64 KB + 8w to M = 2048,
128 KB + 8w at 4096) or 64 KB in the four-step passes; the kernel is bound
by its shared-memory traffic and its double arithmetic (the CUDA source
says more).

K3 runs behind the ``torch.library`` custom op ``sdr_pmr446::waterfall``:
the launch is its CUDA implementation (registered for "cuda" alone), the
plain version its CPU implementation ("cpu" alone), the plan's tables
tensor arguments and its sizes ints; the live chains and an exported step
(apps/export_chain.py) call the op, and ``LAUNCHES`` counts in its CUDA
implementation.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from sdr_pmr446_tpu_torch import config as C
from sdr_pmr446_tpu_torch.kernels import build
from sdr_pmr446_tpu_torch.ops import spectrogram

#: most points one block's transforms hold (csrc/waterfall.cu WF_CAP)
CAP = 4096
#: points a block transforms at once below CAP (csrc/waterfall.cu WF_BATCH)
BATCH = 2048
#: most rounds of ``nt`` hops a one-block launch's block runs
MAX_ROUNDS = 8

#: kernel launches of the CUDA version (one per call); the plain version
#: never counts
LAUNCHES = 0


class WfOut(NamedTuple):
    hist: torch.Tensor   # c64 [w/2]  the last w/2 samples of [hist | band]
    cnt: torch.Tensor    # i32 []     (cnt + K*19600) mod (w/4)
    rows: torch.Tensor   # f32 [K, w] dB, fftshifted


class Plan(NamedTuple):
    """K3's FFT plan for one width (every table float64, O(m))."""
    w: int
    m: int                   # transform length, 2^a 3^b 5^c 7^d
    m1: int                  # four-step split m = m1 * (m // m1); 0: none
    nt: int                  # transforms a one-block launch runs at once
    pre: np.ndarray          # c128 [w/2] window (times the chirp: Bluestein)
    filt: np.ndarray | None  # c128 [m] FFT of the chirp filter / m, or None
    tw: np.ndarray           # c128 twiddles: stage_twiddles(m) [m - 1], or
    #                          for the four-step split stage_twiddles(m1),
    #                          stage_twiddles(m // m1), exp(-2 pi i t / m)


def radices(n: int) -> list[int]:
    """The kernel's radix sequence for an n-point FFT, n = 2^a 3^b 5^c 7^d:
    2^(a mod 4) first unless that is 1, then 16s, then 3s, 5s and 7s
    (csrc/waterfall.cu next_radix)."""
    a = (n & -n).bit_length() - 1
    out = [1 << a % 4] * (a % 4 > 0) + [16] * (a // 4)
    n >>= a
    for p in (3, 5, 7):
        while n % p == 0:
            out.append(p)
            n //= p
    if n != 1:
        raise ValueError("the kernel's FFT takes lengths 2^a 3^b 5^c 7^d")
    return out


def smooth(n: int) -> bool:
    """True for the lengths the kernel transforms directly."""
    for p in (2, 3, 5, 7):
        while n % p == 0:
            n //= p
    return n == 1


def stage_twiddles(n: int) -> np.ndarray:
    """c128 [n - 1]: the twiddles of an n-point FFT, stage after stage; the
    stage of radix R after radices of product Ns holds
    W_(Ns R)^(r k) at (r - 1)*Ns + k, r in [1, R), k in [0, Ns), so that
    neighbouring butterflies read neighbouring entries."""
    parts, ns = [], 1
    for r_ in radices(n):
        k = np.arange(ns)
        parts += [np.exp(-2j * np.pi * r * k / (ns * r_))
                  for r in range(1, r_)]
        ns *= r_
    return np.concatenate(parts)


def window64(w: int) -> np.ndarray:
    """The periodic Hamming window of ops/spectrogram._window in float64,
    not rounded to f32: at w = 78400, where one hop makes a row reaching
    136 dB below its peak, the f32 window alone moves the float64 asgramcf
    oracle's rows by 0.0285 dB (chip_smoke.py phase 10 logs it)."""
    win = np.hamming(w // 2 + 1)[:w // 2]
    return win / np.sum(win)


def chirp(w: int, n: np.ndarray) -> np.ndarray:
    """c_n = exp(-pi i n^2 / w), with n^2 reduced mod 2w first (exact)."""
    n = np.asarray(n, np.int64)
    return np.exp(-1j * np.pi * ((n * n) % (2 * w)) / w)


def make_plan(w: int) -> Plan:
    """The transform length, the four-step split and the tables of width
    ``w``.  A power of two, or a product of 2, 3, 5 and 7 up to CAP, is one
    FFT of the windowed samples; any other width is S_f = c_f (a * b)_f
    with a_j = x_j win_j c_j and
    b_n = conj(c_n), the linear convolution taken as a circular one of
    length m >= w/2 + w - 1, so the kernel's second FFT of
    conj(FFT(a) * filt) is conj(S_f / c_f)."""
    wl = w // 2
    win = window64(w)
    if w & (w - 1) == 0 or (smooth(w) and w <= CAP):
        m, pre, filt = w, win.astype(np.complex128), None
    else:
        m = 1 << (w + wl - 2).bit_length()
        c = chirp(w, np.arange(w))
        pre = win * c[:wl]
        b = np.zeros(m, np.complex128)
        b[:w] = np.conj(c)
        b[m - wl + 1:] = np.conj(c[1:wl])[::-1]
        filt = np.fft.fft(b) / m
    m1 = 0 if m <= CAP else 1 << ((m.bit_length() - 1) // 2)
    tw = (np.concatenate([stage_twiddles(m1), stage_twiddles(m // m1),
                          np.exp(-2j * np.pi * np.arange(m) / m)])
          if m1 else stage_twiddles(m))
    nt = 0 if m1 else max(1, BATCH // m)
    return Plan(w, m, m1, nt, pre, filt, tw)


def slab_geometry(plan: Plan, k: int, slots: int):
    """(hops per slab, slabs per row) of the partials [k, slabs, w]: one
    hop a slab on the four-step path; else whole rounds of ``nt`` hops, as
    many (up to MAX_ROUNDS) as take the fewest rounds in all when the
    blocks run ``slots`` at a time (waves x rounds; ties to more rounds,
    fewer partials), the slabs covering the most hops a row can hold."""
    max_row_hops = C.SUBCHUNK_RESAMP // (plan.w // 4) + 1
    if plan.m1:
        return 1, max_row_hops

    def slabs(rounds):
        return -(-max_row_hops // (plan.nt * rounds))

    rounds = min(range(1, MAX_ROUNDS + 1), key=lambda r: (
        -(-k * slabs(r) // slots) * r, -r))
    return plan.nt * rounds, slabs(rounds)


@functools.lru_cache(maxsize=None)
def hop_slots(device_index: int, w: int, m: int, nt: int) -> int:
    """Blocks of the one-block launch that the card holds at once: its
    occupancy a SM (csrc/waterfall.cu wf_blocks_per_sm) times its SMs."""
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        build.check(build.library().wf_blocks_per_sm(w, m, nt,
                                                     ctypes.byref(blocks)),
                    "wf_blocks_per_sm")
        sms = torch.cuda.get_device_properties(
            device_index).multi_processor_count
    return max(1, blocks.value) * sms


def rows_in(band: torch.Tensor) -> int:
    """Sub-chunks K in ``band`` [2, K*19600]."""
    sub = C.SUBCHUNK_RESAMP
    if band.dim() != 2 or band.shape[0] != 2 or band.shape[1] % sub:
        raise ValueError(f"band must be [2, K*{sub}] planes, "
                         f"got {tuple(band.shape)}")
    return band.shape[1] // sub


def check_hist(hist: torch.Tensor, w: int) -> None:
    if hist.dim() != 1 or hist.shape[0] < spectrogram.hist_len(w):
        raise ValueError(f"hist needs >= {spectrogram.hist_len(w)} samples")


@functools.lru_cache(maxsize=None)
def _slabs(w: int, m: int, m1: int, nt: int, k: int, device_index: int):
    """slab_geometry of the plan (w, m, m1, nt) at K on the card."""
    plan = Plan(w, m, m1, nt, None, None, None)
    slots = 0 if m1 else hop_slots(device_index, w, m, nt)
    return slab_geometry(plan, k, slots)


def waterfall_plain(band, hist, cnt, w: int) -> WfOut:
    """K3 in plain PyTorch ops (ops/spectrogram.py; any device)."""
    k = rows_in(band)
    check_hist(hist, w)
    wl = spectrogram.hist_len(w)
    return WfOut(*spectrogram.asgram_rows_any_p(
        hist[hist.shape[0] - wl:], cnt, band[0], band[1], k, w))


# ------------------------------------------------------ the custom op
# (hist', cnt', rows), WfOut's fields

@torch.library.custom_op("sdr_pmr446::waterfall", mutates_args=(),
                         device_types="cpu")
def waterfall_op(band: torch.Tensor, hist: torch.Tensor, cnt: torch.Tensor,
                 pre: torch.Tensor, filt: torch.Tensor | None,
                 tw: torch.Tensor, w: int, m: int, m1: int, nt: int
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K3 on CPU tensors: the plain version."""
    return tuple(build.owned(t) for t in waterfall_plain(band, hist, cnt, w))


@waterfall_op.register_kernel("cuda")
def _waterfall_cuda(band, hist, cnt, pre, filt, tw, w, m, m1, nt):
    """K3 on CUDA tensors: csrc/waterfall.cu on the current stream (raises
    on any fault)."""
    global LAUNCHES
    k = rows_in(band)
    dev = band.device
    nb = band.shape[1]
    build.require(band, "band", torch.float32, (2, nb), dev)
    build.require(hist, "hist", torch.complex64, None, dev)
    check_hist(hist, w)
    build.require(cnt, "cnt", torch.int32, (), dev)
    build.require(pre, "pre", torch.complex128, (w // 2,), dev)
    build.require(tw, "tw", torch.complex128, None, dev)
    if filt is not None:
        build.require(filt, "filt", torch.complex128, (m,), dev)
    slab_hops, slabs = _slabs(w, m, m1, nt, k, dev.index)
    part = torch.empty((k, slabs, w), dtype=torch.float64, device=dev)
    scratch = None
    if m1:
        scratch = torch.empty((1 + (filt is not None), nb // (w // 4) + 1, m),
                              dtype=torch.complex128, device=dev)
    out = WfOut(torch.empty(w // 2, dtype=torch.complex64, device=dev),
                torch.empty((), dtype=torch.int32, device=dev),
                torch.empty((k, w), dtype=torch.float32, device=dev))
    code = build.library().wf_run(
        band.data_ptr(), nb, hist.data_ptr(), hist.shape[0],
        cnt.data_ptr(), pre.data_ptr(),
        None if filt is None else filt.data_ptr(),
        tw.data_ptr(), w, k, C.SUBCHUNK_RESAMP, m, m1,
        nt, slab_hops, slabs, None if scratch is None else
        scratch.data_ptr(),
        part.data_ptr(), out.rows.data_ptr(), out.hist.data_ptr(),
        out.cnt.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    build.check(code, "wf_run")
    LAUNCHES += 1
    return tuple(out)


@waterfall_op.register_fake
def _waterfall_fake(band, hist, cnt, pre, filt, tw, w, m, m1, nt):
    k = rows_in(band)
    check_hist(hist, w)
    return (hist.new_empty((w // 2,)), cnt.new_empty(()),
            band.new_empty((k, w)))


class Waterfall(nn.Module):
    """K3 for one width ``w`` through ``sdr_pmr446::waterfall``: the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors."""

    def __init__(self, w: int, device):
        super().__init__()
        spectrogram.validate_width(w)
        if w <= 0:
            raise ValueError(f"waterfall width {w}: the waterfall is off")
        self.w = w
        self.wl = spectrogram.hist_len(w)
        self.plan = make_plan(w)
        as_dev = lambda a: None if a is None else torch.as_tensor(
            a, device=device)
        self.register_buffer("pre", as_dev(self.plan.pre))
        self.register_buffer("filt", as_dev(self.plan.filt))
        self.register_buffer("tw", as_dev(self.plan.tw))

    def forward(self, band, hist, cnt) -> WfOut:
        if band.device.type not in ("cuda", "cpu"):
            raise ValueError(f"no waterfall implementation for device "
                             f"{band.device}")
        p = self.plan
        return WfOut(*waterfall_op(band, hist, cnt, self.pre, self.filt,
                                   self.tw, p.w, p.m, p.m1, p.nt))

    def plain(self, band, hist, cnt) -> WfOut:
        """The same function in plain PyTorch ops (any device)."""
        return waterfall_plain(band, hist, cnt, self.w)

    def kernel(self, band, hist, cnt) -> WfOut:
        """The op on CUDA tensors: csrc/waterfall.cu on the current
        stream."""
        if band.device.type != "cuda":
            raise ValueError(f"the waterfall kernel takes CUDA tensors, got "
                             f"{band.device}")
        if self.tw.device != band.device:
            raise ValueError(f"the plan's tables are on {self.tw.device}, "
                             f"the band on {band.device}")
        return self(band, hist, cnt)
