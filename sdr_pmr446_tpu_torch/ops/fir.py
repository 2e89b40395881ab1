"""Block-streaming FIR filtering (overlap-save) as plain functions.

Counterpart of sdr_pmr446_tpu/ops/fir.py: each op is
``(history, block) -> (new_history, block)``, the history being the last
``len(taps) - 1`` input samples.  Used by the audio bank's plain version.
"""

from __future__ import annotations

import torch


def fir_apply(hist: torch.Tensor, x: torch.Tensor, taps: torch.Tensor):
    """Causal FIR y[n] = sum_m taps[m] x[n-m] along the last axis (real).

    hist [..., len(taps)-1]; returns (new_hist, y) with y shaped like x."""
    ntaps = taps.shape[0]
    xe = torch.cat([hist, x], dim=-1)
    lead = xe.shape[:-1]
    w = torch.flip(taps.to(xe.dtype), dims=[0]).reshape(1, 1, -1)
    y = torch.nn.functional.conv1d(xe.reshape(-1, 1, xe.shape[-1]), w)
    y = y.reshape(lead + (x.shape[-1],))
    return xe[..., xe.shape[-1] - (ntaps - 1):], y


def delay_apply(hist: torch.Tensor, x: torch.Tensor):
    """Pure n-sample delay line: y[t] = x[t - n], n = hist.shape[-1]."""
    n = hist.shape[-1]
    xe = torch.cat([hist, x], dim=-1)
    t = x.shape[-1]
    return xe[..., t:t + n], xe[..., :t]
