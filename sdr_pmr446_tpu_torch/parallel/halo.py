"""The collectives of a one-card (stream x time) mesh.

Counterpart of sdr_pmr446_tpu/parallel/halo.py.  The JAX package runs a
time-sharded stream under ``shard_map``: each device holds one shard, and
every causal filter receives the last ``hist_len`` samples of its LEFT
neighbour's shard by ``ppermute``.  Here all S x D shards of a mesh
(parallel/scanner_sharded.py::Mesh) live on one card, in one tensor:

  - a per-shard value has leading dims [S, D] (stream, time shard); a
    carried value (the state between blocks, replicated over the time
    axis in JAX) has the leading dim [S];
  - ``ppermute`` to the right is a shift by one along D, shard 0 taking
    the carried value (``shift_right``); ``all_gather`` is the tensor
    itself; ``psum`` of the last shard's value is index D - 1;
    ``axis_index`` is ``arange(D)``.

Nothing indexes dynamically or reads the host, so a step stays
asynchronous.  The names and carried-state meanings are JAX's, and every
collective of the port's sharded chains is in this module; K11
(kernels/halo_dma.py) is the transport of ``shard_hist`` and
``shard_hist_planes`` with ``dma``, so a multi-card transport replaces
these alone.

One-pole IIRs cannot use a finite halo: ``shard_biquad1`` solves the
recurrence from zero state per shard and composes the carries over the
gathered per-shard endpoints, exactly (src/sdr_pmr446.c:422,450 keeps the
single y[-1] that this reconstructs).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from sdr_pmr446_tpu_torch.kernels import halo_dma
from sdr_pmr446_tpu_torch.ops import iir


def shift_right(carried: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """``ppermute`` to the right along the time axis: shard d receives
    shard d - 1's ``val`` [S, D, ...], shard 0 the ``carried`` [S, ...]."""
    return torch.cat([carried.unsqueeze(1).to(val.dtype), val[:, :-1]], dim=1)


def shard_hist(carried_hist: torch.Tensor, x_shard: torch.Tensor,
               hist_len: int, dma: bool = False):
    """History for every shard: its left neighbour's tail (the carried
    history for shard 0).  x_shard [S, D, ..., T].  Returns (hist [S, D,
    ..., hist_len], new_carried [S, ..., hist_len] = the LAST shard's
    tail, the carried state of the next block).  ``dma`` moves the tails
    by K11's ring shift (JAX's ``shard_hist_dma``, the same values bit for
    bit), which launches nothing with one time shard."""
    tail = x_shard[..., x_shard.shape[-1] - hist_len:]
    if not dma or tail.shape[1] == 1:
        return shift_right(carried_hist, tail), tail[:, -1]
    hist = halo_dma.ring_shift_right(tail)
    hist[:, 0] = carried_hist
    return hist, tail[:, -1]


def shard_hist_planes(carried_hist: torch.Tensor, planes: torch.Tensor,
                      hist_len: int, dma: bool = False):
    """``shard_hist`` of the complex signal whose re and im planes are
    ``planes`` [S, D, 2, T] f32: (hist [S, D, hist_len] c64, new_carried
    [S, hist_len]).  Without ``dma`` the tails are made complex and
    shifted by the collective; with ``dma``, K11 reads them from the
    planes and writes the history and the carry in one launch (JAX's
    ``shard_hist_dma``, the same values bit for bit), which launches
    nothing with one time shard."""
    if not dma or planes.shape[1] == 1:
        t = planes.shape[-1]
        return shard_hist(carried_hist, torch.complex(
            planes[..., 0, t - hist_len:], planes[..., 1, t - hist_len:]),
            hist_len)
    return halo_dma.shard_hist_planes(carried_hist, planes, hist_len)


def shard_hist_reach(carried_hist: torch.Tensor, planes: torch.Tensor,
                     hist_len: int):
    """``shard_hist_planes`` for any ``hist_len``, also one longer than a
    shard's T samples: shard d's history is the ``hist_len`` samples of
    [carried | shard 0 | ... | shard D-1] before its first, which reach
    back over ceil(hist_len / T) left neighbours (JAX's ``shard_hist``
    takes one neighbour's tail and fails there).  ``carried_hist`` c64 [S,
    hist_len], ``planes`` f32 [S, D, 2, T].  Returns (hist [S, D,
    hist_len] c64, each [s, d] row contiguous, new_carried [S,
    hist_len])."""
    n_s, n_t, _, t = planes.shape
    seq = torch.cat([carried_hist, torch.complex(
        planes[:, :, 0], planes[:, :, 1]).reshape(n_s, n_t * t)], dim=-1)
    return seq.unfold(-1, hist_len, t)[:, :n_t], seq[:, n_t * t:]


def frame_parities(parity: torch.Tensor, n_time: int, f_local: int):
    """(each shard's incoming PFB frame parity [S, D], the sign of each
    shard's last frame [S, D] f32, the next block's parity [S])."""
    d = torch.arange(n_time, dtype=torch.int32, device=parity.device)
    par = ((parity[:, None] + d * f_local) % 2).to(torch.int32)
    lsign = (1.0 - 2.0 * ((par + f_local - 1) % 2)).to(torch.float32)
    return par, lsign, ((parity + n_time * f_local) % 2).to(torch.int32)


def shard_scalar_prev(carried_prev: torch.Tensor, x_shard: torch.Tensor):
    """1-sample halo (the discriminator's previous sample): (prev [S, D,
    ...], new_carried [S, ...])."""
    last = x_shard[..., -1]
    return shift_right(carried_prev, last), last[:, -1]


@functools.lru_cache(maxsize=None)
def _pole_powers(p: float, ts: int, device: str) -> torch.Tensor:
    """p^(n+1) for n < ts, float64 on the host rounded once to f32."""
    return torch.as_tensor((p ** (np.arange(ts, dtype=np.float64) + 1.0))
                           .astype(np.float32), device=device)


def shard_biquad1(state, x_shard: torch.Tensor, b0: float, b1: float,
                  a1: float):
    """First-order section y[n] = b0 x[n] + b1 x[n-1] - a1 y[n-1] over time
    shards.  ``state`` = (x_prev, y_prev) [S, ...] carried across blocks;
    x_shard [S, D, ..., T] real.  Exact: local scans from zero state, the
    shards' incoming y composed in order from the gathered end values
    (c_0 = y_prev, c_(d+1) = p^T c_d + y_end[d]), then y += c_d p^(n+1).
    Returns ((x_prev', y_prev') [S, ...], y [S, D, ..., T])."""
    x_prev_c, y_prev_c = state
    num, ts = x_shard.shape[1], x_shard.shape[-1]
    p = -a1
    last = x_shard[..., -1]
    x_prev = shift_right(x_prev_c, last)
    x1 = torch.cat([x_prev[..., None], x_shard[..., :-1]], dim=-1)
    z = b0 * x_shard + b1 * x1
    if num == 1:
        y = iir.first_order_scan(z, p, y_prev_c.unsqueeze(1))
        return (last[:, -1], y[:, -1, ..., -1]), y
    y_local = iir.first_order_scan(z, p, torch.zeros_like(last))
    y_end = y_local[..., -1]
    p_t = float(np.float32(np.float64(p) ** ts))
    carry = [y_prev_c.to(y_local.dtype)]
    for d in range(num - 1):
        carry.append(p_t * carry[-1] + y_end[:, d])
    carry_in = torch.stack(carry, dim=1)                       # [S, D, ...]
    y = y_local + carry_in[..., None] * _pole_powers(p, ts, str(z.device))
    return (last[:, -1], y[:, -1, ..., -1]), y


def shard_dc_blocker(state, x_shard: torch.Tensor, alpha: float):
    """The one-pole DC blocker y[n] = p y[n-1] + g (x[n] - x[n-1]) over
    time shards (shard_biquad1 with b0 = g, b1 = -g, a1 = -p)."""
    p = 1.0 - alpha
    g = (1.0 + p) / 2.0
    return shard_biquad1(state, x_shard, g, -g, -p)
