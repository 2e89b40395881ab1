"""Single-channel NBFM monitor chain (BASELINE.json config 1), PyTorch.

Counterpart of sdr_pmr446_tpu/scanner/single.py on its kernel engines
(``SingleChannelChain(use_pallas=True)``): fixed-tune demodulation of ONE
PMR channel from the 1.024 Msps band capture — resample to 200 kHz, mix
the channel to baseband (a 32-entry phase table indexed by the band
sample's global index mod 32), 16x decimating channel filter, NBFM
discriminator, then the CTCSS-removal highpass, audio gain and de-emphasis
composed into one FIR.

``mono=True`` (the default, the JAX MONO one-kernel chain): one launch of
K4 (kernels/chan_tail.py::MonoChain, mode "single").  ``mono=False``, the
JAX two-kernel engine: K6 (kernels/front_end.py::FrontEnd) writes the band
planes and K5 (kernels/chan_tail.py::ChanTail) runs the rest.  Both carry
the same state (SingleState, JAX's PallasSingleState), so a state passes
between the engines and the packages.  The mixer phase is carried in
``n0``, so every K is served, including an odd number of 400-sample group
rows per step (odd K), which the JAX kernels' (-1)^(g+u) alternation
cannot take.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from sdr_pmr446_tpu_torch import config as C
from sdr_pmr446_tpu_torch import device as devices
from sdr_pmr446_tpu_torch import precision
from sdr_pmr446_tpu_torch.ops import decode
from sdr_pmr446_tpu_torch.runtime import fuse
from sdr_pmr446_tpu_torch.taps import design as D


@functools.lru_cache(maxsize=None)
def channel_filter_taps() -> tuple:
    """16x decimating channel-select lowpass at 200 kHz (6.25 kHz half-band,
    80 dB; 838 taps)."""
    h = D.resampler_taps(L=1, M=16, att_db=80.0,
                         fs_in=float(C.SDR_RESAMPLERATE),
                         passband_hz=5600.0, stopband_hz=6900.0)
    return tuple(h.tolist())


class SingleState(NamedTuple):
    """The layout of the JAX mono engine's PallasSingleState."""
    dc_x: torch.Tensor          # c64 []
    dc_y: torch.Tensor          # c64 []
    front_hist: torch.Tensor    # c64 [512 cu8/cs8 | 384]
    band_hist: torch.Tensor     # c64 [3*400] raw (unmixed) band
    sig_prev: torch.Tensor      # c64 []  (TRUE, mixed space)
    demod_hist: torch.Tensor    # f32 [17*25]
    n0: torch.Tensor            # i32 []  band index mod 32 (mixer phase)


class SingleChannelChain:
    """Block step ``(state, wire uint8 [step_arg_len]) -> (state', audio f32
    [T*25/2048])`` for one fixed channel (1..16)."""

    def __init__(self, channel: int, subchunks_per_step: int = 10,
                 audio_gain: float = C.SDR_DEFAULT_AUDIO_GAIN,
                 input_format: str = "cf32", device=devices.DEFAULT,
                 mono: bool = True):
        from sdr_pmr446_tpu_torch.kernels.chan_tail import (MonoChain,
                                                            TwoKernelChain)
        precision.check()
        self.device = devices.resolve(device)
        self.channel = channel
        self.audio_gain = audio_gain
        self.input_format = decode.wire_format(input_format)
        self.input_len = subchunks_per_step * C.SUBCHUNK_IN
        self.output_len = self.input_len * 25 // 2048
        self.mono = mono
        self.engine = (MonoChain if mono else TwoKernelChain)(
            "single", self.input_format, channel=channel,
            audio_gain=audio_gain, device=self.device)
        self.megastep = fuse.fused_steps(self.step)

    @property
    def step_arg_len(self) -> int:
        """Wire bytes per step."""
        return self.input_len * decode.BYTES_PER_SAMPLE[self.input_format]

    def init_state(self) -> SingleState:
        return SingleState(*self.engine.init_state(self.device),
                           torch.zeros((), dtype=torch.int32,
                                       device=self.device))

    def step(self, state: SingleState, wire: torch.Tensor):
        if wire.shape != (self.step_arg_len,):
            raise ValueError(f"wire has shape {tuple(wire.shape)}, expected "
                             f"({self.step_arg_len},)")
        o = self.engine(wire, *state[:-1], n0=state.n0)
        return (SingleState(o.dc_x, o.dc_y, o.front_hist, o.band_hist,
                            o.sig_prev, o.demod_hist, o.n0), o.out)

    def multi_step(self, state: SingleState, wires: torch.Tensor):
        """S blocks in one dispatch (runtime/fuse.py): ``wires`` uint8 [S,
        step_arg_len]; the audio comes back [S * output_len], equal to S
        step() calls bit for bit."""
        return self.megastep(state, wires)
