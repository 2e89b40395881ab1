"""Per-channel RSSI: 20*log10(mean |x|) per sub-chunk.

Counterpart of sdr_pmr446_tpu/ops/rssi.py (the reference's average_power
is the mean of the magnitude, not of the energy).
"""

from __future__ import annotations

import torch


def average_power_db(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """20*log10(max(mean(|x|), 1e-30)) along ``dim``."""
    a = torch.mean(torch.abs(x), dim=dim)
    return 20.0 * torch.log10(torch.clamp(a, min=1e-30))


def subchunk_rssi(chan: torch.Tensor, num_subchunks: int) -> torch.Tensor:
    """chan [16, K*ns] -> rssi [K, 16] dB."""
    c, t = chan.shape
    blocks = chan.reshape(c, num_subchunks, t // num_subchunks)
    return average_power_db(blocks, dim=-1).transpose(0, 1)


def rssi_from_sums(mag_sums: torch.Tensor, ns: int) -> torch.Tensor:
    """Per-sub-chunk |y| sums [K, 16] -> dB, as scanner/chain.py:362-363."""
    return 20.0 * torch.log10(torch.clamp(mag_sums * (1.0 / ns), min=1e-30))
