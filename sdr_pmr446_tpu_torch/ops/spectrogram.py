"""Sliding windowed periodogram (the waterfall) — liquid asgramcf semantics.

Counterpart of sdr_pmr446_tpu/ops/spectrogram.py.  The reference's
waterfall feeds every resampled band sample into a liquid ``asgramcf``
(src/sdr_pmr446.c:473-477, 910-919): with FFT size ``w`` (the ``-w`` flag) a
``w/2``-sample window slides in hops of ``w/4``; each hop's windowed segment
is zero-padded to ``w`` and its ``|S|^2`` accumulated; the displayed row is
the dB average of the hops since the previous row, fftshifted.  The window
is a periodic Hamming window normalised to coherent gain (a unit complex
exponential reads ~0 dB), as in the JAX package.

A hop fires after every ``w/4``-th band sample and belongs to the sub-chunk
that holds that sample.  The carried state is the last ``w/2`` band samples
(``wf_hist``) and the in-hop sample counter (``wf_cnt``); widths whose hop
divides the sub-chunk keep the counter at 0.

The NumPy constants (``_window``, ``_dft_win_packed``, ``wf_row_counts``)
are re-derived here, since the JAX module imports jax at the top;
tests/test_torch_waterfall.py holds them bit-equal to the JAX ones.

``kernel_wf_supported`` has no counterpart: the JAX duo kernel computes the
waterfall in-kernel only at the widths and K its Mosaic selectors allow,
while the port's K3 (kernels/waterfall.py, csrc/waterfall.cu, FFTs in
shared memory with O(w) tables) serves every width that ``validate_width``
accepts, at every K.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from sdr_pmr446_tpu_torch import config as C


def validate_width(w: int, subchunk: int = C.SUBCHUNK_RESAMP) -> None:
    if w <= 0:
        return
    if w % 4 != 0 or w < 8:
        raise ValueError(f"waterfall width must be a multiple of 4, >= 8 "
                         f"(got {w})")
    if w // 4 > subchunk:
        raise ValueError(
            f"waterfall width {w}: hop {w // 4} exceeds the sub-chunk "
            f"band length {subchunk} (some rows would have no transform)")


def uses_fast_path(w: int, subchunk: int = C.SUBCHUNK_RESAMP) -> bool:
    """True when the hop divides the sub-chunk: the hop counter stays 0."""
    return w > 0 and subchunk % (w // 4) == 0


def hist_len(w: int) -> int:
    return w // 2


@functools.lru_cache(maxsize=None)
def _window(w: int) -> np.ndarray:
    wl = w // 2
    win = np.hamming(wl + 1)[:wl]          # periodic Hamming, length w/2
    return (win / np.sum(win)).astype(np.float32)   # coherent normalization


@functools.lru_cache(maxsize=None)
def _dft_win_packed(w: int) -> np.ndarray:
    """[w, 2w] f32 window+DFT matrix over packed hop rows [wr | wi]: column
    f < w gives Re S_f, column w + f gives Im S_f.  Built in float64,
    rounded once to f32."""
    wl = w // 2
    win = _window(w).astype(np.float64)
    j = np.arange(wl)[:, None]
    k = np.arange(w)[None, :]
    th = 2.0 * np.pi * j * k / w
    cm = np.cos(th) * win[:, None]
    sm = np.sin(th) * win[:, None]
    k4 = np.zeros((w, 2 * w), np.float64)
    k4[:wl, :w] = cm                      # wr -> Re
    k4[wl:, :w] = sm                      # wi -> Re
    k4[:wl, w:] = -sm                     # wr -> Im
    k4[wl:, w:] = cm                      # wi -> Im
    return k4.astype(np.float32)


def wf_row_counts(w: int, k: int,
                  subchunk: int = C.SUBCHUNK_RESAMP) -> np.ndarray:
    """Hops per sub-chunk row for a step of k sub-chunks at hop phase 0."""
    delay = w // 4
    ends = np.arange(delay, k * subchunk + 1, delay)
    return np.bincount((ends - 1) // subchunk,
                       minlength=k).astype(np.float32)


def rows_from_psd_sums(sums: torch.Tensor, w: int,
                       subchunk: int = C.SUBCHUNK_RESAMP,
                       counts: torch.Tensor | None = None) -> torch.Tensor:
    """dB rows [k, w] from per-row |S|^2 sums [k, w]: the average over the
    row's hops (``counts`` [k]; None means the uniform subchunk/(w/4)),
    10*log10(max(p, 1e-30)), fftshifted."""
    if counts is None:
        p_avg = sums * (1.0 / (subchunk // (w // 4)))
    else:
        p_avg = sums / counts.to(sums.dtype)[:, None]
    rows = 10.0 * torch.log10(torch.clamp(p_avg, min=1e-30))
    return torch.fft.fftshift(rows, dim=-1)


def asgram_rows_any_p(hist: torch.Tensor, cnt: torch.Tensor, br: torch.Tensor,
                      bi: torch.Tensor, k: int, w: int,
                      subchunk: int = C.SUBCHUNK_RESAMP):
    """hist c64 [w/2], cnt i32 [] (samples since the last hop, in
    [0, w/4)), band planes br/bi f32 [k*subchunk] ->
    (hist' c64 [w/2], cnt' i32 [], rows f32 [k, w]).

    Hop i fires at band sample u_i = (w/4 - cnt) + i*w/4 (1-based) while
    u_i <= k*subchunk; its window is the w/2 samples of [hist | band] that
    end at u_i, and it belongs to row (u_i - 1) // subchunk.  The counter is
    taken modulo the hop (a loaded state may hold any value).  The DFT
    products and sums are taken in double, as K3's FFTs (csrc/waterfall.cu),
    by the direct definition: the [w, 2w] table grows as w^2 (4.3 GB in
    double at w = 16384), so this version serves tests and checks, not
    the widest widths.
    Every index is computed on the tensors' device: no host read."""
    wl, delay = w // 2, w // 4
    ks = k * subchunk
    dev = br.device
    cnt = cnt.to(torch.int64) % delay
    xr = torch.cat([hist.real.to(torch.float32), br])
    xi = torch.cat([hist.imag.to(torch.float32), bi])
    n_max = ks // delay + 1
    u = (delay - cnt) + delay * torch.arange(
        n_max, device=dev)                                    # [n_max]
    # window of hop i: xe[u_i .. u_i + wl) (xe = [hist | band]); hops past
    # the step read clamped indices and fall off the row selector below
    idx = torch.clamp(u[:, None] + torch.arange(wl, device=dev)[None, :],
                      max=xr.shape[0] - 1)
    wcat = torch.cat([xr[idx], xi[idx]], dim=-1)              # [n_max, w]
    # the f32 samples and table, multiplied and summed in double: an f32
    # product of w terms misses the weakest bins by 0.015 dB at w = 8192
    table = torch.as_tensor(_dft_win_packed(w), device=dev)
    sq = (wcat.double() @ table.double()) ** 2                # [n_max, 2w]
    row = (u - 1) // subchunk
    sel = (row[:, None] == torch.arange(k, device=dev)[None, :]).to(
        torch.float64)                                        # [n_max, k]
    m2 = sel.T @ sq                                           # [k, 2w]
    counts = torch.clamp(sel.sum(0), min=1.0)
    rows = rows_from_psd_sums(m2[:, :w] + m2[:, w:], w, subchunk, counts)
    new_hist = torch.complex(xr[xr.shape[0] - wl:], xi[xi.shape[0] - wl:])
    new_cnt = ((cnt + ks) % delay).to(torch.int32)
    return new_hist, new_cnt, rows.to(torch.float32)


def asgram_rows_p(hist: torch.Tensor, br: torch.Tensor, bi: torch.Tensor,
                  k: int, w: int, subchunk: int = C.SUBCHUNK_RESAMP):
    """The uniform-width case (the hop divides the sub-chunk, the counter
    stays 0): -> (hist', rows)."""
    if not uses_fast_path(w, subchunk):
        raise ValueError(f"hop {w // 4} does not divide the sub-chunk "
                         f"{subchunk}: use asgram_rows_any_p")
    zero = torch.zeros((), dtype=torch.int32, device=br.device)
    new_hist, _, rows = asgram_rows_any_p(hist, zero, br, bi, k, w, subchunk)
    return new_hist, rows
