"""First-order IIR sections as chunked parallel scans.

Counterpart of sdr_pmr446_tpu/ops/iir.py.  The one-pole recurrence

    y[n] = p*y[n-1] + z[n],   y[-1] = y0

is computed exactly (the same fixed point as the sequential form, up to
f32 rounding) as a chunked two-level scan, never a per-sample Python loop:

  1. reshape z into [C, L] chunks; the zero-state response inside every
     chunk is one matmul with the upper-triangular U[m, j] = p^(j-m);
  2. the chunk-end values form the same recurrence with pole p^L over C
     steps — solved by recursing into this function;
  3. y[c, j] = ylocal[c, j] + carry_in[c] * p^(j+1).

The pole powers are computed in float64 on the host and rounded once.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

CHUNK = 128


@functools.lru_cache(maxsize=None)
def _tables(p: float, length: int):
    """(U [L, L], pj [L]) float64: U[m, j] = p^(j-m) for j >= m, pj = p^(j+1)."""
    j = np.arange(length, dtype=np.float64)
    diff = j[None, :] - j[:, None]
    u = np.where(diff >= 0, p ** np.maximum(diff, 0.0), 0.0)
    return u, p ** (j + 1.0)


@functools.lru_cache(maxsize=None)
def _device_tables(p: float, length: int, dtype, device):
    """_tables as tensors of ``dtype`` on ``device``, made once: a step on
    the card then copies nothing from the host."""
    u, pj = _tables(p, length)
    return (torch.as_tensor(u, dtype=dtype, device=device),
            torch.as_tensor(pj, dtype=dtype, device=device))


def first_order_scan(z: torch.Tensor, p: float, y0: torch.Tensor,
                     chunk: int = CHUNK) -> torch.Tensor:
    """Solve y[n] = p*y[n-1] + z[n] along the last axis of real ``z``.

    z: [..., T] f32; y0: [...] the value before n = 0.  Returns y [..., T].
    """
    t = z.shape[-1]
    length = min(chunk, t)
    u, pj = _device_tables(float(p), length, z.dtype, z.device)
    y0 = y0.to(z.dtype)
    if t <= length:
        return z @ u + y0[..., None] * pj
    pad = (-t) % length
    if pad:
        z = torch.nn.functional.pad(z, (0, pad))
    c = (t + pad) // length
    zc = z.reshape(z.shape[:-1] + (c, length))
    ylocal = zc @ u                                    # [..., C, L]
    # chunk-end recurrence Y[c] = p^L Y[c-1] + yend[c] with Y[-1] = y0
    y_end = first_order_scan(ylocal[..., -1], float(p) ** length, y0, chunk)
    carry_in = torch.cat([y0[..., None], y_end[..., :-1]], dim=-1)
    y = ylocal + carry_in[..., None] * pj
    y = y.reshape(z.shape)
    return y[..., :t] if pad else y


def dc_blocker_apply(state, x: torch.Tensor, alpha: float = 0.0005,
                     chunk: int = CHUNK):
    """One-pole DC blocker y[n] = p*y[n-1] + g*(x[n] - x[n-1]).

    state = (x_prev, y_prev), each [...]; x is [..., T] real.  Returns
    ((x[..., -1], y[..., -1]), y) — exact streaming across blocks.
    ``chunk`` is the scan's chunk length L; it changes only f32 rounding.
    """
    x_prev, y_prev = state
    p = 1.0 - alpha
    g = (1.0 + p) / 2.0
    x1 = torch.cat([x_prev[..., None].to(x.dtype), x[..., :-1]], dim=-1)
    z = g * x + (-g) * x1
    y = first_order_scan(z, p, y_prev, chunk)
    return (x[..., -1], y[..., -1]), y
