"""Block-streaming FIR filtering (overlap-save) as plain functions.

Counterpart of sdr_pmr446_tpu/ops/fir.py: each op is
``(history, block) -> (new_history, block)``, the history being the last
``len(taps) - 1`` input samples.  Used by the audio bank's plain version
and faithful mode (scanner/faithful.py).
"""

from __future__ import annotations

import torch


def fir_init(taps_len: int, channels: int | None = None,
             dtype=torch.float32, device="cpu") -> torch.Tensor:
    """Zero history for a causal FIR with ``taps_len`` taps."""
    h = taps_len - 1
    shape = (h,) if channels is None else (channels, h)
    return torch.zeros(shape, dtype=dtype, device=device)


def fir_apply(hist: torch.Tensor, x: torch.Tensor, taps: torch.Tensor):
    """Causal FIR y[n] = sum_m taps[m] x[n-m] along the last axis (real).

    hist [..., len(taps)-1]; returns (new_hist, y) with y shaped like x."""
    ntaps = taps.shape[0]
    xe = torch.cat([hist, x], dim=-1)
    y = _correlate_valid(xe, torch.flip(taps, dims=[0]))
    return xe[..., xe.shape[-1] - (ntaps - 1):], y


def _correlate_valid(xe: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """'valid' correlation of real [..., T+L-1] with [L] -> [..., T]:
    y[t] = sum_l xe[t + l] kernel[l], one F.conv1d (true f32 under the
    port's TF32-off policy, precision.py)."""
    lead = xe.shape[:-1]
    w = kernel.to(xe.dtype).reshape(1, 1, -1)
    y = torch.nn.functional.conv1d(xe.reshape(-1, 1, xe.shape[-1]), w)
    return y.reshape(lead + (xe.shape[-1] - kernel.shape[0] + 1,))


def delay_init(n: int, channels: int | None = None,
               dtype=torch.float32, device="cpu") -> torch.Tensor:
    """Zero history of an ``n``-sample delay line."""
    shape = (n,) if channels is None else (channels, n)
    return torch.zeros(shape, dtype=dtype, device=device)


def delay_apply(hist: torch.Tensor, x: torch.Tensor):
    """Pure n-sample delay line: y[t] = x[t - n], n = hist.shape[-1]."""
    n = hist.shape[-1]
    xe = torch.cat([hist, x], dim=-1)
    t = x.shape[-1]
    return xe[..., t:t + n], xe[..., :t]
