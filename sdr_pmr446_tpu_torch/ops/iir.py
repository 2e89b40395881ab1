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

The device tables of a pole (``ScanTables``: U and p^(j+1) at every level
of the recursion) are built when the module that runs the scan is built,
so a step reaches only tables that already exist and an exported step
(apps/export_chain.py) holds them as constants.  A call without
``tables`` takes them from a per-device cache built at its first use: the
eager paths that no export reaches (the time-sharded chains, faithful
mode, the tests) do so, and under ``torch.export`` it raises.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn

CHUNK = 128


@functools.lru_cache(maxsize=None)
def _tables(p: float, length: int):
    """(U [L, L], pj [L]) float64: U[m, j] = p^(j-m) for j >= m, pj = p^(j+1)."""
    j = np.arange(length, dtype=np.float64)
    diff = j[None, :] - j[:, None]
    u = np.where(diff >= 0, p ** np.maximum(diff, 0.0), 0.0)
    return u, p ** (j + 1.0)


#: recursion levels a ScanTables holds: scans up to CHUNK^LEVELS samples
LEVELS = 4


class ScanTables(nn.Module):
    """The device tables of ``first_order_scan`` for pole ``p``, chunk
    length ``chunk`` and ``dtype`` on ``device``: at level i of the chunk
    recursion (pole p^(chunk^i), in float64 as the recursion forms it)
    ``u{i}`` [chunk, chunk] and ``pj{i}`` [chunk]; a level shorter than
    ``chunk`` reads their leading [t, t] and [t], which hold the same
    values as that length's own tables."""

    def __init__(self, p: float, device, dtype=torch.float32,
                 chunk: int = CHUNK, levels: int = LEVELS):
        super().__init__()
        self.p, self.chunk, self.levels = float(p), chunk, levels
        pole = self.p
        for i in range(levels):
            u, pj = _tables(pole, chunk)
            self.register_buffer(f"u{i}", torch.as_tensor(u, dtype=dtype,
                                                          device=device))
            self.register_buffer(f"pj{i}", torch.as_tensor(pj, dtype=dtype,
                                                           device=device))
            pole = pole ** chunk

    def level(self, i: int, length: int):
        """(U [length, length], pj [length]) of level ``i``."""
        if i >= self.levels:
            raise ValueError(f"a scan this long needs more than "
                             f"{self.levels} levels of {self.chunk}")
        u, pj = getattr(self, f"u{i}"), getattr(self, f"pj{i}")
        if length == self.chunk:
            return u, pj
        return u[:length, :length], pj[:length]


@functools.lru_cache(maxsize=None)
def _cached_tables(p: float, chunk: int, dtype, device: str) -> ScanTables:
    return ScanTables(p, device, dtype, chunk)


def shared_tables(p: float, chunk: int, dtype, device) -> ScanTables:
    """The per-device ScanTables of the eager callers that hold none of
    their own, built at first use; raises under ``torch.export``, where a
    table built during the trace would be a fake tensor left in the cache
    for the next eager call."""
    if torch.compiler.is_exporting():
        raise RuntimeError("an exported step reaches a first-order scan "
                           "without its ScanTables: build them with the "
                           "module that runs the scan")
    return _cached_tables(float(p), chunk, dtype, str(torch.device(device)))


def first_order_scan(z: torch.Tensor, p: float, y0: torch.Tensor,
                     chunk: int = CHUNK, tables: ScanTables | None = None,
                     level: int = 0) -> torch.Tensor:
    """Solve y[n] = p*y[n-1] + z[n] along the last axis of real ``z``.

    z: [..., T] f32; y0: [...] the value before n = 0.  Returns y [..., T].
    ``tables`` (for this p, chunk, z's dtype and device) default to the
    shared ones; ``level`` is the recursion's own.
    """
    if tables is None:
        tables = shared_tables(p, chunk, z.dtype, z.device)
    elif (tables.p, tables.chunk) != (float(p), chunk) and level == 0:
        raise ValueError(f"tables of pole {tables.p}, chunk {tables.chunk} "
                         f"for a scan of pole {p}, chunk {chunk}")
    t = z.shape[-1]
    length = min(chunk, t)
    u, pj = tables.level(level, length)
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
    y_end = first_order_scan(ylocal[..., -1], float(p) ** length, y0, chunk,
                             tables, level + 1)
    carry_in = torch.cat([y0[..., None], y_end[..., :-1]], dim=-1)
    y = ylocal + carry_in[..., None] * pj
    y = y.reshape(z.shape)
    return y[..., :t] if pad else y


def dc_blocker_apply(state, x: torch.Tensor, alpha: float = 0.0005,
                     chunk: int = CHUNK, tables: ScanTables | None = None):
    """One-pole DC blocker y[n] = p*y[n-1] + g*(x[n] - x[n-1]).

    state = (x_prev, y_prev), each [...]; x is [..., T] real.  Returns
    ((x[..., -1], y[..., -1]), y) — exact streaming across blocks.
    ``chunk`` is the scan's chunk length L; it changes only f32 rounding.
    ``tables``: the scan's, for p = 1 - alpha (``dc_tables``).
    """
    x_prev, y_prev = state
    p = 1.0 - alpha
    g = (1.0 + p) / 2.0
    x1 = torch.cat([x_prev[..., None].to(x.dtype), x[..., :-1]], dim=-1)
    z = g * x + (-g) * x1
    y = first_order_scan(z, p, y_prev, chunk, tables)
    return (x[..., -1], y[..., -1]), y


def dc_tables(device, alpha: float = 0.0005) -> ScanTables:
    """The ScanTables of ``dc_blocker_apply``'s pole 1 - alpha."""
    return ScanTables(1.0 - alpha, device)
