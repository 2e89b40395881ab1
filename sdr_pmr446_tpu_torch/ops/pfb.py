"""Fused NCO mixer + 16-channel polyphase filterbank (plain PyTorch).

Counterpart of sdr_pmr446_tpu/ops/pfb.py: one strided complex convolution
with a static [416, 16] kernel folding the Kaiser prototype, the 16-point
DFT across polyphase branches and the -93.75 kHz re-centering mixer:

  y[n, k] = e^{-j w_k s_n} * sum_m h[m] e^{j w_k m} x~[s_n - m],
  x~[t] = x[t] e^{j w_mix t},  s_n = 16 n + 15,  w_k = 2 pi k / 16.

Because 16 * w_mix = pi (mod 2 pi), the mixer leaves only a static
in-frame phase plus a global (-1)^frame flip, so the carried mixer state is
the frame-count parity.  Carried state: the last 400 band samples + parity.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from sdr_pmr446_tpu_torch import config as C


def make_pfb_kernel(prototype: np.ndarray,
                    num_channels: int = C.NUM_CHANNELS,
                    mix_omega: float = C.MIX_OMEGA) -> np.ndarray:
    """Complex128 [n_taps, num_channels] fused kernel CK[t, k].

    CK[t, k] = h[n_taps-1-t] * exp(j*(-2*pi*k*t/M + mix_omega*(t - (n_taps-M)))).
    Re-derived from the JAX package (bit-equal, test-enforced)."""
    h = np.asarray(prototype, dtype=np.float64)
    n = h.shape[0]
    assert n % num_channels == 0
    hist = n - num_channels
    t = np.arange(n)
    k = np.arange(num_channels)
    phase = (-2.0 * np.pi * np.outer(t, k) / num_channels
             + mix_omega * (t - hist)[:, None])
    return h[::-1, None] * np.exp(1j * phase)


def frame_signs(parity: torch.Tensor, frames: int) -> torch.Tensor:
    """(-1)^(parity + n) for n < frames: f32 [..., frames] for ``parity``
    [...], on parity's device."""
    f_sign = 1.0 - 2.0 * (torch.arange(frames, device=parity.device) % 2)
    p_sign = 1.0 - 2.0 * (parity % 2)
    return (f_sign * p_sign[..., None]).to(torch.float32)


class PFBChannelizer(nn.Module):
    def __init__(self, prototype: np.ndarray,
                 num_channels: int = C.NUM_CHANNELS,
                 mix_omega: float = C.MIX_OMEGA, *, device):
        super().__init__()
        self.M = num_channels
        self.n_taps = int(np.asarray(prototype).shape[0])
        self.hist_len = self.n_taps - num_channels
        ck = make_pfb_kernel(prototype, num_channels, mix_omega)
        # real conv weight [2M, 2, n_taps]: out[2k] = Re y_k, out[2k+1] = Im y_k
        w = np.zeros((2 * num_channels, 2, self.n_taps), dtype=np.float32)
        w[0::2, 0] = ck.real.T
        w[0::2, 1] = -ck.imag.T
        w[1::2, 0] = ck.imag.T
        w[1::2, 1] = ck.real.T
        self.register_buffer("weight", torch.as_tensor(w, device=device))

    def forward(self, state, x: torch.Tensor):
        """state = (hist c64 [..., 400], parity i32 [...]); x c64 [..., T],
        T % 16 == 0, each leading index a stream of its own.  Returns
        ((hist', parity'), chan c64 [..., 16, T/16]) channel-major."""
        hist, parity = state
        t = x.shape[-1]
        if t % self.M:
            raise ValueError(f"band length {t} is not a multiple of {self.M}")
        frames = t // self.M
        xe = torch.cat([hist, x], dim=-1)
        lead = xe.shape[:-1]
        lhs = torch.stack([xe.real, xe.imag], dim=-2).reshape(
            -1, 2, xe.shape[-1])                                # [B, 2, T+400]
        out = torch.nn.functional.conv1d(lhs, self.weight, stride=self.M)
        y = torch.complex(out[:, 0::2], out[:, 1::2]).reshape(
            lead + (self.M, frames))                            # [..., 16, F]
        y = y * frame_signs(parity, frames)[..., None, :]
        new_parity = ((parity + frames) % 2).to(torch.int32)
        return (xe[..., xe.shape[-1] - self.hist_len:], new_parity), y
