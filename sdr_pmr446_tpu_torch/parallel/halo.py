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
``shard_hist_planes`` with ``dma`` within a card.

Over several processes (parallel/distributed.py) a rank holds D_loc of a
stream's D time shards, and the ranks that share the stream form its time
group (``TimeGroup``).  Every function here takes the group as ``tg``
(by default ``LOCAL``: the one-card mesh, bit for bit as above) and
crosses the rank boundary with two primitives on the group's host-staged
transport:

  - ``TimeGroup.pass_right``: local shard 0 receives the left rank's last
    shard value in place of the carried one, and every rank gets the LAST
    shard's value of the whole group (the next block's carry): the
    shift-type halos run locally with it;
  - ``TimeGroup.gather`` / ``local``: every shard's value over the group,
    and the rank's slice of it: the compose-type halos gather the small
    per-shard end values, run the one-card arithmetic on all D and keep
    their own shards, so sums run in the one-card order and the results
    equal the one-card mesh's bit for bit.

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
from sdr_pmr446_tpu_torch.parallel import distributed


class TimeGroup:
    """The ranks that share a rank's streams, in time order: ``size``
    ranks, this one at ``index``, each holding D_loc consecutive time
    shards (D = size * D_loc).  ``TimeGroup()`` is the one-card mesh: one
    rank holds every shard and nothing crosses a process."""

    def __init__(self, group=None, size: int = 1, index: int = 0):
        self.group, self.size, self.index = group, size, index

    @classmethod
    def of(cls, mesh) -> "TimeGroup":
        """The time group of a mesh (a one-card Mesh: ``TimeGroup()``)."""
        if getattr(mesh, "group", None) is None:
            return cls()
        return cls(mesh.group, len(mesh.group_ranks),
                   mesh.time0 // mesh.n_time)

    def total(self, n_local: int) -> int:
        """D, the group's time shards, from the rank's D_loc."""
        return n_local * self.size

    def shard_index(self, n_local: int, device) -> torch.Tensor:
        """The global time index of each of the rank's shards, i32 [D_loc]."""
        lo = self.index * n_local
        return torch.arange(lo, lo + n_local, dtype=torch.int32,
                            device=device)

    def gather(self, *xs):
        """Each of ``xs`` [S, D_loc, ...] over the group, [S, D, ...] (one
        collective for all of them); one tensor in, one out."""
        if self.size > 1:
            parts = distributed.all_gather(list(xs), self.group)
            xs = tuple(torch.cat([p[i] for p in parts], dim=1)
                       for i in range(len(xs)))
        return xs[0] if len(xs) == 1 else xs

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """The rank's shards of a gathered [S, D, ...]."""
        if self.size == 1:
            return x
        n = x.shape[1] // self.size
        return x[:, self.index * n:(self.index + 1) * n]

    def pass_right(self, *pairs):
        """``ppermute`` to the right over the group for each (carried [S,
        ...], val [S, D_loc, ...]) pair: (received [S, D_loc, ...] — shard
        d gets shard d - 1's val, the group's shard 0 the carried —, the
        group's last shard's val [S, ...]), one collective for all pairs;
        one pair in, one result out."""
        if self.size == 1:
            res = [(shift_right(c, v), v[:, -1]) for c, v in pairs]
        else:
            edges = self.gather(*(v[:, -1:] for _, v in pairs))
            edges = edges if len(pairs) > 1 else (edges,)
            res = []
            for (c, v), e in zip(pairs, edges):
                left = c if self.index == 0 else e[:, self.index - 1]
                res.append((shift_right(left, v), e[:, -1]))
        return res[0] if len(res) == 1 else res

    def last(self, *vals):
        """The group's last shard's value of each of ``vals`` [S, D_loc,
        ...] -> [S, ...] (one collective for all); one in, one out."""
        if self.size == 1:
            res = tuple(v[:, -1] for v in vals)
        else:
            got = self.gather(*(v[:, -1:] for v in vals))
            res = tuple(g[:, -1] for g in (got if len(vals) > 1 else (got,)))
        return res[0] if len(res) == 1 else res


LOCAL = TimeGroup()


def shift_right(carried: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """``ppermute`` to the right along the time axis: shard d receives
    shard d - 1's ``val`` [S, D, ...], shard 0 the ``carried`` [S, ...]."""
    return torch.cat([carried.unsqueeze(1).to(val.dtype), val[:, :-1]], dim=1)


def shard_hist(carried_hist: torch.Tensor, x_shard: torch.Tensor,
               hist_len: int, dma: bool = False, tg: TimeGroup = LOCAL):
    """History for every shard: its left neighbour's tail (the carried
    history for shard 0).  x_shard [S, D, ..., T].  Returns (hist [S, D,
    ..., hist_len], new_carried [S, ..., hist_len] = the LAST shard's
    tail, the carried state of the next block).  ``dma`` moves the tails
    by K11's ring shift (JAX's ``shard_hist_dma``, the same values bit for
    bit), which launches nothing with one time shard; over a time group
    K11 moves the rank's own tails and the left rank's comes by
    ``pass_right``."""
    tail = x_shard[..., x_shard.shape[-1] - hist_len:]
    if not dma or tail.shape[1] == 1:
        return tg.pass_right((carried_hist, tail))
    hist = halo_dma.ring_shift_right(tail)
    if tg.size == 1:
        hist[:, 0] = carried_hist
        return hist, tail[:, -1]
    received, new_carried = tg.pass_right((carried_hist, tail))
    hist[:, 0] = received[:, 0]
    return hist, new_carried


def shard_hist_planes(carried_hist: torch.Tensor, planes: torch.Tensor,
                      hist_len: int, dma: bool = False, tg: TimeGroup = LOCAL):
    """``shard_hist`` of the complex signal whose re and im planes are
    ``planes`` [S, D, 2, T] f32: (hist [S, D, hist_len] c64, new_carried
    [S, hist_len]).  Without ``dma`` the tails are made complex and
    shifted by the collective; with ``dma``, K11 reads them from the
    planes and writes the history and the carry in one launch (JAX's
    ``shard_hist_dma``, the same values bit for bit), which launches
    nothing with one time shard.  Over a time group K11 still moves the
    rank's own tails in one launch, its shard 0 taking the left rank's
    tail (``pass_right``) in place of the carried history."""
    t = planes.shape[-1]
    if not dma or planes.shape[1] == 1:
        return shard_hist(carried_hist, torch.complex(
            planes[..., 0, t - hist_len:], planes[..., 1, t - hist_len:]),
            hist_len, tg=tg)
    if tg.size == 1:
        return halo_dma.shard_hist_planes(carried_hist, planes, hist_len)
    last = planes[:, -1:, :, t - hist_len:]
    received, new_carried = tg.pass_right(
        (carried_hist, torch.complex(last[:, :, 0], last[:, :, 1])))
    hist, _ = halo_dma.shard_hist_planes(received[:, 0].contiguous(),
                                         planes, hist_len)
    return hist, new_carried


def shard_hist_reach(carried_hist: torch.Tensor, planes: torch.Tensor,
                     hist_len: int, tg: TimeGroup = LOCAL):
    """``shard_hist_planes`` for any ``hist_len``, also one longer than a
    shard's T samples: shard d's history is the ``hist_len`` samples of
    [carried | shard 0 | ... | shard D-1] before its first, which reach
    back over ceil(hist_len / T) left neighbours (JAX's ``shard_hist``
    takes one neighbour's tail and fails there).  ``carried_hist`` c64 [S,
    hist_len], ``planes`` f32 [S, D, 2, T].  Returns (hist [S, D,
    hist_len] c64, each [s, d] row contiguous, new_carried [S,
    hist_len]).  Over a time group the planes are gathered (they are
    tails: ``planes`` holds at most hist_len samples a shard)."""
    planes = tg.gather(planes)
    n_s, n_t, _, t = planes.shape
    seq = torch.cat([carried_hist, torch.complex(
        planes[:, :, 0], planes[:, :, 1]).reshape(n_s, n_t * t)], dim=-1)
    return tg.local(seq.unfold(-1, hist_len, t)[:, :n_t]), seq[:, n_t * t:]


def frame_parities(parity: torch.Tensor, n_time: int, f_local: int,
                   tg: TimeGroup = LOCAL):
    """(each shard's incoming PFB frame parity [S, D], the sign of each
    shard's last frame [S, D] f32, the next block's parity [S]); ``n_time``
    the rank's shards, their index global over a time group."""
    d = tg.shard_index(n_time, parity.device)
    par = ((parity[:, None] + d * f_local) % 2).to(torch.int32)
    lsign = (1.0 - 2.0 * ((par + f_local - 1) % 2)).to(torch.float32)
    return par, lsign, ((parity + tg.total(n_time) * f_local) % 2).to(
        torch.int32)


def shard_scalar_prev(carried_prev: torch.Tensor, x_shard: torch.Tensor,
                      tg: TimeGroup = LOCAL):
    """1-sample halo (the discriminator's previous sample): (prev [S, D,
    ...], new_carried [S, ...])."""
    return tg.pass_right((carried_prev, x_shard[..., -1]))


@functools.lru_cache(maxsize=None)
def _pole_powers(p: float, ts: int, device: str) -> torch.Tensor:
    """p^(n+1) for n < ts, float64 on the host rounded once to f32."""
    return torch.as_tensor((p ** (np.arange(ts, dtype=np.float64) + 1.0))
                           .astype(np.float32), device=device)


def shard_biquad1(state, x_shard: torch.Tensor, b0: float, b1: float,
                  a1: float, tg: TimeGroup = LOCAL):
    """First-order section y[n] = b0 x[n] + b1 x[n-1] - a1 y[n-1] over time
    shards.  ``state`` = (x_prev, y_prev) [S, ...] carried across blocks;
    x_shard [S, D, ..., T] real.  Exact: local scans from zero state, the
    shards' incoming y composed in order from the gathered end values
    (c_0 = y_prev, c_(d+1) = p^T c_d + y_end[d]), then y += c_d p^(n+1).
    Over a time group the end values are gathered and every rank composes
    all D in that order.  Returns ((x_prev', y_prev') [S, ...], y [S, D,
    ..., T])."""
    x_prev_c, y_prev_c = state
    ts = x_shard.shape[-1]
    num = tg.total(x_shard.shape[1])
    p = -a1
    last = x_shard[..., -1]
    x_prev, x_carry = tg.pass_right((x_prev_c, last))
    x1 = torch.cat([x_prev[..., None], x_shard[..., :-1]], dim=-1)
    z = b0 * x_shard + b1 * x1
    if num == 1:
        y = iir.first_order_scan(z, p, y_prev_c.unsqueeze(1))
        return (x_carry, y[:, -1, ..., -1]), y
    y_local = iir.first_order_scan(z, p, torch.zeros_like(last))
    y_end = tg.gather(y_local[..., -1])
    p_t = float(np.float32(np.float64(p) ** ts))
    carry = [y_prev_c.to(y_local.dtype)]
    for d in range(num - 1):
        carry.append(p_t * carry[-1] + y_end[:, d])
    carry_in = tg.local(torch.stack(carry, dim=1))             # [S, D, ...]
    y = y_local + carry_in[..., None] * _pole_powers(p, ts, str(z.device))
    return (x_carry, tg.last(y[..., -1])), y


def shard_dc_blocker(state, x_shard: torch.Tensor, alpha: float,
                     tg: TimeGroup = LOCAL):
    """The one-pole DC blocker y[n] = p y[n-1] + g (x[n] - x[n-1]) over
    time shards (shard_biquad1 with b0 = g, b1 = -g, a1 = -p)."""
    p = 1.0 - alpha
    g = (1.0 + p) / 2.0
    return shard_biquad1(state, x_shard, g, -g, -p, tg)
