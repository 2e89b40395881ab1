"""NBFM quadrature discriminator (freqdem, kf = 0.5).

Counterpart of sdr_pmr446_tpu/ops/fm.py:

    y[n] = atan2(Im d, Re d) / (2*pi*kf),  d = x[n] * conj(x[n-1])

with the previous complex sample per stream carried across blocks.
"""

from __future__ import annotations

import math

import torch

from sdr_pmr446_tpu_torch import config as C


def fm_demod(prev: torch.Tensor, x: torch.Tensor, kf: float = C.FM_KF):
    """x [..., T] complex, prev [...] complex -> (new_prev, y [..., T] f32)."""
    xp = torch.cat([prev[..., None], x[..., :-1]], dim=-1)
    d = x * torch.conj(xp)
    y = torch.atan2(d.imag, d.real) * (1.0 / (2.0 * math.pi * kf))
    return x[..., -1], y.to(torch.float32)
