"""25/128 polyphase rational resampler (plain PyTorch).

Counterpart of sdr_pmr446_tpu/ops/resample.py.  The exact L/M polyphase
decimation

    y[j] = sum_{i<P} x[q - i] * h[i*L + r],  q = floor(j*M/L) + o_f,  r = (j*M) mod L

is one strided convolution with an [L, W] kernel matrix over frames of M
input samples (L outputs per frame).  ``_kernel_matrix`` re-derives the JAX
package's NumPy builder (bit-equal, test-enforced) because that module
imports jax.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn


@functools.lru_cache(maxsize=None)
def _kernel_matrix(taps_key, L: int, M: int) -> np.ndarray:
    """[L, W] float64 per-phase kernel matrix from prototype taps.

    K[p, w] = h[(o_p + P - 1 - w)*L + r_p] for w in [o_p, o_p + P - 1],
    else 0, with o_p = floor(p*M/L), r_p = (p*M) mod L, W = P + max o_p.
    """
    h = np.asarray(taps_key, dtype=np.float64)
    assert h.shape[0] % L == 0
    P = h.shape[0] // L
    offsets = [(p * M) // L for p in range(L)]
    W = P + max(offsets)
    K = np.zeros((L, W), dtype=np.float64)
    for p in range(L):
        r = (p * M) % L
        o = offsets[p]
        for w in range(o, o + P):
            K[p, w] = h[(o + P - 1 - w) * L + r]
    return K


class PolyResampler(nn.Module):
    """Rational L/M resampler on real planes; ``module(hist, x)`` with
    ``x.shape[-1] % M == 0``.  The carried history is the last ``len(hist)``
    input samples; the filter reads its last ``P - 1`` (``hist_len``), so a
    longer history (the kernel engine's 384/512-sample one) works too."""

    def __init__(self, taps: np.ndarray, L: int, M: int, device):
        super().__init__()
        taps = np.asarray(taps, dtype=np.float64)
        self.L, self.M = L, M
        self.P = taps.shape[0] // L
        self.hist_len = self.P - 1
        kmat = _kernel_matrix(tuple(taps.tolist()), L, M).astype(np.float32)
        self.W = kmat.shape[1]
        self.register_buffer(
            "weight", torch.as_tensor(kmat, device=device)[:, None, :])

    def forward(self, hist: torch.Tensor, x: torch.Tensor):
        """hist [..., H >= P-1], x [..., T] real -> (new_hist, y [..., T*L/M])."""
        t = x.shape[-1]
        if t % self.M:
            raise ValueError(f"block length {t} is not a multiple of {self.M}")
        if hist.shape[-1] < self.hist_len:
            raise ValueError(f"history {hist.shape[-1]} < {self.hist_len}")
        xe = torch.cat([hist, x], dim=-1)
        start = hist.shape[-1] - self.hist_len
        frames = t // self.M
        need = (frames - 1) * self.M + self.W
        lead = xe.shape[:-1]
        lhs = xe[..., start:start + need].reshape(-1, 1, need)
        out = torch.nn.functional.conv1d(lhs, self.weight, stride=self.M)
        y = out.transpose(1, 2).reshape(lead + (frames * self.L,))
        return xe[..., xe.shape[-1] - hist.shape[-1]:], y


def planes(z: torch.Tensor) -> torch.Tensor:
    """c64 [..., T] -> its re / im planes f32 [..., 2, T] (the resampler
    filters a complex signal as two real ones, as JAX's does)."""
    return torch.view_as_real(z).transpose(-1, -2)


def complex_of(p: torch.Tensor) -> torch.Tensor:
    """Planes f32 [..., 2, T] -> c64 [..., T]."""
    return torch.complex(p[..., 0, :], p[..., 1, :])
