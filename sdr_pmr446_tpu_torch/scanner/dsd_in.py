"""dsd_in: the wideband-FM front end for external digital-voice decoders (PyTorch).

Counterpart of sdr_pmr446_tpu/scanner/dsd_in.py on its kernel engines
(``DsdInChain(use_pallas=True)``):

    wire bytes @1.024 Msps -> DC block -> 25/128 resample to 200 kHz
    -> 16x decimating lowpass to 12.5 kHz -> freqdem(0.5)
    -> 96/25 upsample to 48 kHz -> x32767, clip -> int16 (truncated)

``mono=True`` (the default, the JAX MONO one-kernel chain): one launch of
K4 (kernels/chan_tail.py::MonoChain, mode "dsd").  ``mono=False``, the JAX
two-kernel engine: K6 (kernels/front_end.py::FrontEnd) writes the band
planes and K5 (kernels/chan_tail.py::ChanTail) runs the rest.  Both carry
the same state (DsdState, JAX's PallasDsdState), so a state passes between
the engines and the packages.  The JAX kernel engines need K % 8 == 0; the
port serves every K, including the app's default K = 10.
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

DSD_AUDIO_RATE = 48_000
DSD_SIG_RATE = 12_500


@functools.lru_cache(maxsize=None)
def stage2_taps() -> tuple:
    """16x decimating lowpass at 200 kHz: pass 5.2 kHz, stop 6.9 kHz, 60 dB
    (477 taps)."""
    h = D.resampler_taps(L=1, M=16, att_db=60.0,
                         fs_in=float(C.SDR_RESAMPLERATE),
                         passband_hz=5200.0, stopband_hz=6900.0)
    return tuple(h.tolist())


@functools.lru_cache(maxsize=None)
def up_taps() -> tuple:
    """96/25 audio upsampler taps (12.5 kHz -> 48 kHz, 60 dB; 4128 taps)."""
    h = D.resampler_taps(L=96, M=25, att_db=60.0, fs_in=float(DSD_SIG_RATE),
                         passband_hz=5000.0, stopband_hz=6200.0)
    return tuple(h.tolist())


class DsdState(NamedTuple):
    """The layout of the JAX mono engine's PallasDsdState."""
    dc_x: torch.Tensor          # c64 []
    dc_y: torch.Tensor          # c64 []
    front_hist: torch.Tensor    # c64 [512 cu8/cs8 | 384]
    band_hist: torch.Tensor     # c64 [2*400]
    sig_prev: torch.Tensor      # c64 []
    demod_hist: torch.Tensor    # f32 [2*25]


class DsdInChain:
    """Block step ``(state, wire uint8 [step_arg_len]) -> (state', pcm int16
    [T*3/64])`` for T = subchunks_per_step * SUBCHUNK_IN input samples of
    raw cu8, cs8, cs16 or cf32 bytes."""

    def __init__(self, subchunks_per_step: int = 10,
                 input_format: str = "cf32", device=devices.DEFAULT,
                 mono: bool = True):
        from sdr_pmr446_tpu_torch.kernels.chan_tail import (MonoChain,
                                                            TwoKernelChain)
        precision.check()
        self.device = devices.resolve(device)
        self.input_format = decode.wire_format(input_format)
        self.input_len = subchunks_per_step * C.SUBCHUNK_IN
        self.output_len = self.input_len * 3 // 64
        self.mono = mono
        self.engine = (MonoChain if mono else TwoKernelChain)(
            "dsd", self.input_format, device=self.device)
        self.megastep = fuse.fused_steps(self.step)

    @property
    def step_arg_len(self) -> int:
        """Wire bytes per step."""
        return self.input_len * decode.BYTES_PER_SAMPLE[self.input_format]

    def init_state(self) -> DsdState:
        return DsdState(*self.engine.init_state(self.device))

    def step(self, state: DsdState, wire: torch.Tensor):
        if wire.shape != (self.step_arg_len,):
            raise ValueError(f"wire has shape {tuple(wire.shape)}, expected "
                             f"({self.step_arg_len},)")
        o = self.engine(wire, *state)
        # clipped in the kernel; the int16 cast truncates toward zero, as
        # the JAX chain's astype(jnp.int16) does
        return (DsdState(o.dc_x, o.dc_y, o.front_hist, o.band_hist,
                         o.sig_prev, o.demod_hist), o.out.to(torch.int16))

    def multi_step(self, state: DsdState, wires: torch.Tensor):
        """S blocks in one dispatch (runtime/fuse.py): ``wires`` uint8 [S,
        step_arg_len]; the pcm comes back [S * output_len], equal to S
        step() calls bit for bit."""
        return self.megastep(state, wires)
