"""The scanner's front end as plain ops: DC blocker, resampler, PFB.

Steps 1-3 of the JAX op engine (sdr_pmr446_tpu/scanner/chain.py:442-453,
``use_pallas=False``) and of faithful mode (scanner/faithful.py), which
share this one copy: the IQ DC blocker on the re / im planes
(ops/iir.py), the 25/128 polyphase resampler (ops/resample.py) and the
16-channel PFB (ops/pfb.py), each carrying its state across blocks.
``OpResample`` is steps 1-2 alone, the front of the dsd_in and
single-channel op chains (JAX dsd_in.py:187-189, single.py:155-160).

Each stage also runs over the time shards of a (stream x time) mesh
(``shards``): the DC blocker over shards (parallel/halo.py
``shard_dc_blocker``), the resampler and the PFB each with its history
halo (``shard_hist_planes``), and the PFB once over every [S, D] row with
each shard's own frame parity (``frame_parities``), as the sharded op
chains in parallel/ run them (JAX scanner_sharded.py:668-690,
dsd_sharded.py:182-190, single_sharded.py:163-170); ``tg`` (a
halo.TimeGroup) carries the halos across the ranks of a time group.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from sdr_pmr446_tpu_torch import config as C
from sdr_pmr446_tpu_torch.ops import decode, iir
from sdr_pmr446_tpu_torch.ops.pfb import PFBChannelizer
from sdr_pmr446_tpu_torch.ops.resample import PolyResampler, complex_of, planes
from sdr_pmr446_tpu_torch.parallel import halo
from sdr_pmr446_tpu_torch.taps import design as D


class FrontOut(NamedTuple):
    dc_x: torch.Tensor          # c64 [] ([S] over shards)
    dc_y: torch.Tensor          # c64 []
    resamp_hist: torch.Tensor   # c64 [345] raw-input history
    pfb_hist: torch.Tensor      # c64 [400]
    parity: torch.Tensor        # i32 []
    band: torch.Tensor          # f32 [2, T * 25 / 128] band planes
    #                             ([S, D, 2, nb] over shards)
    chan: torch.Tensor          # c64 [16, T / 128] channel-major
    #                             ([S, D, 16, F] over shards)


def shard_planes(wire3: torch.Tensor, fmt: str) -> torch.Tensor:
    """Wire bytes uint8 [S, D, bytes] of format ``fmt`` -> the decoded
    re / im planes f32 [S, D, 2, T] of each time shard."""
    n_s, n_t = wire3.shape[:2]
    xr, xi = decode.decode_planes(wire3.reshape(-1), fmt)
    return torch.stack([xr.reshape(n_s, n_t, -1), xi.reshape(n_s, n_t, -1)],
                       dim=2)


def _complex(v: torch.Tensor) -> torch.Tensor:
    """A DC blocker's (re, im) carry [..., 2] -> c64 [...]."""
    return torch.complex(v[..., 0], v[..., 1])


class OpResample(nn.Module):
    """Steps 1-2: the IQ DC blocker and the 25/128 resampler, carrying
    (dc_x, dc_y, the resampler's raw-input history)."""

    def __init__(self, device):
        super().__init__()
        self.resampler = PolyResampler(D.resampler_taps(), C.RESAMP_L,
                                       C.RESAMP_M, device=device)
        self.dc_tables = iir.dc_tables(device, C.DC_BLOCK_ALPHA)

    def resample(self, dc_x, dc_y, hist, x: torch.Tensor):
        """dc_x, dc_y c64 [], hist c64 [345], x planes f32 [2, T] ->
        (dc_x', dc_y', hist', band planes f32 [2, T * 25 / 128])."""
        (dx, dy), y = iir.dc_blocker_apply(
            (torch.view_as_real(dc_x), torch.view_as_real(dc_y)), x,
            C.DC_BLOCK_ALPHA, tables=self.dc_tables)
        rhist, band = self.resampler(planes(hist), y)
        return _complex(dx), _complex(dy), complex_of(rhist), band

    def resample_shards(self, dc_x, dc_y, hist, x: torch.Tensor,
                        tg: halo.TimeGroup = halo.LOCAL):
        """``resample`` over time shards: dc_x, dc_y c64 [S], hist c64 [S,
        345], x planes f32 [S, D, 2, T] -> (dc_x' [S], dc_y' [S], hist' [S,
        345], band planes f32 [S, D, 2, nb])."""
        (dx, dy), y = halo.shard_dc_blocker(
            (torch.view_as_real(dc_x), torch.view_as_real(dc_y)), x,
            C.DC_BLOCK_ALPHA, tg)
        rhist, carry = halo.shard_hist_planes(hist, y,
                                              self.resampler.hist_len, tg=tg)
        _, band = self.resampler(planes(rhist), y)
        return _complex(dx), _complex(dy), carry, band


class OpFrontEnd(OpResample):
    """(DC state, resampler and PFB histories, parity, planes [2, T]) ->
    FrontOut; ``resampler`` and ``pfb`` are the plain modules."""

    def __init__(self, device):
        super().__init__(device)
        self.pfb = PFBChannelizer(D.pfb_prototype(), device=device)

    def forward(self, dc_x, dc_y, resamp_hist, pfb_hist, parity,
                x: torch.Tensor) -> FrontOut:
        dx, dy, rhist, band = self.resample(dc_x, dc_y, resamp_hist, x)
        (phist, parity), chan = self.pfb((pfb_hist, parity),
                                         complex_of(band))
        return FrontOut(dx, dy, rhist, phist, parity, band, chan)

    def shards(self, dc_x, dc_y, resamp_hist, pfb_hist, parity,
               x: torch.Tensor, tg: halo.TimeGroup = halo.LOCAL) -> FrontOut:
        """``forward`` over time shards: the carried state [S, ...] and x
        planes f32 [S, D, 2, T] -> FrontOut with the next block's state
        [S, ...], band [S, D, 2, nb] and chan [S, D, 16, F]."""
        dx, dy, r_carry, band = self.resample_shards(dc_x, dc_y,
                                                     resamp_hist, x, tg)
        phist, p_carry = halo.shard_hist_planes(pfb_hist, band,
                                                self.pfb.hist_len, tg=tg)
        par, _, new_par = halo.frame_parities(
            parity, band.shape[1], band.shape[-1] // C.NUM_CHANNELS, tg)
        _, chan = self.pfb((phist, par), complex_of(band))
        return FrontOut(dx, dy, r_carry, p_carry, new_par, band, chan)
