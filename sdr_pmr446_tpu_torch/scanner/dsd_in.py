"""dsd_in: the wideband-FM front end for external digital-voice decoders (PyTorch).

Counterpart of sdr_pmr446_tpu/scanner/dsd_in.py:

    wire bytes @1.024 Msps -> DC block -> 25/128 resample to 200 kHz
    -> 16x decimating lowpass to 12.5 kHz -> freqdem(0.5)
    -> 96/25 upsample to 48 kHz -> x32767, clip -> int16 (truncated)

``engine="kernel"`` (the default, JAX ``use_pallas=True``): with
``mono=True`` (the default, the JAX MONO one-kernel chain) one launch of
K4 (kernels/chan_tail.py::MonoChain, mode "dsd"); with ``mono=False``, the
JAX two-kernel engine, K6 (kernels/front_end.py::FrontEnd) writes the band
planes and K5 (kernels/chan_tail.py::ChanTail) runs the rest.  Both carry
the same state (DsdState, JAX's PallasDsdState), so a state passes between
the engines and the packages.  The JAX kernel engines need K % 8 == 0; the
port serves every K, including the app's default K = 10.

``engine="op"`` (JAX ``use_pallas=False``, JAX dsd_in.py:187-200): the
same stages as plain ops (ops/iir.py, ops/resample.py, ops/fm.py) on the
decoded wire, every wire format and every K, carrying DsdOpState (JAX's
DsdState); ``mono`` does not apply.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

import numpy as np

from sdr_pmr446_tpu_torch import config as C
from sdr_pmr446_tpu_torch import device as devices
from sdr_pmr446_tpu_torch import engine as engines
from sdr_pmr446_tpu_torch import precision
from sdr_pmr446_tpu_torch.ops import decode, fm
from sdr_pmr446_tpu_torch.ops.resample import (PolyResampler, complex_of,
                                               planes)
from sdr_pmr446_tpu_torch.runtime import fuse
from sdr_pmr446_tpu_torch.scanner.op_front import OpResample
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


class DsdOpState(NamedTuple):
    """The layout of the JAX op engine's DsdState (use_pallas=False)."""
    dc_x: torch.Tensor          # c64 []
    dc_y: torch.Tensor          # c64 []
    res1_hist: torch.Tensor     # c64 [345]  25/128 resampler input
    res2_hist: torch.Tensor     # c64 [476]  16x decimator input
    fm_prev: torch.Tensor       # c64 []
    up_hist: torch.Tensor       # f32 [42]   96/25 upsampler input


class OpResamplers(OpResample):
    """dsd_in's plain ops: the DC blocker and the 25/128 resampler
    (OpResample; JAX DsdInChain's res1), then res2 and up."""

    def __init__(self, device):
        super().__init__(device)
        self.res2 = PolyResampler(np.asarray(stage2_taps()), 1, 16,
                                  device=device)
        self.up = PolyResampler(np.asarray(up_taps()), 96, 25, device=device)


def to_pcm(out48: torch.Tensor) -> torch.Tensor:
    """x32767, clipped, cast to int16 truncating toward zero (the JAX
    chain's ``astype(jnp.int16)``)."""
    return torch.clamp(out48 * 32767.0, -32768.0, 32767.0).to(torch.int16)


class DsdInChain:
    """Block step ``(state, wire uint8 [step_arg_len]) -> (state', pcm int16
    [T*3/64])`` for T = subchunks_per_step * SUBCHUNK_IN input samples of
    raw cu8, cs8, cs16 or cf32 bytes, on ``engine`` (module docstring)."""

    def __init__(self, subchunks_per_step: int = 10,
                 input_format: str = "cf32", device=devices.DEFAULT,
                 mono: bool = True, engine: str = engines.KERNEL):
        from sdr_pmr446_tpu_torch.kernels.chan_tail import (MonoChain,
                                                            TwoKernelChain)
        precision.check()
        self.device = devices.resolve(device)
        self.engine = engines.resolve(engine)
        self.input_format = decode.wire_format(input_format)
        self.input_len = subchunks_per_step * C.SUBCHUNK_IN
        self.output_len = self.input_len * 3 // 64
        self.op = self.engine == engines.OP
        self.mono = mono and not self.op
        if self.op:
            self.ops = OpResamplers(self.device)
        else:
            self.kernels = (MonoChain if mono else TwoKernelChain)(
                "dsd", self.input_format, device=self.device)
        self.megastep = fuse.fused_steps(self.step)

    @property
    def step_arg_len(self) -> int:
        """Wire bytes per step."""
        return self.input_len * decode.BYTES_PER_SAMPLE[self.input_format]

    def init_state(self):
        """DsdState (kernel engine) or DsdOpState (op engine), zero."""
        if not self.op:
            return DsdState(*self.kernels.init_state(self.device))
        c64 = dict(dtype=torch.complex64, device=self.device)
        return DsdOpState(
            dc_x=torch.zeros((), **c64), dc_y=torch.zeros((), **c64),
            res1_hist=torch.zeros(self.ops.resampler.hist_len, **c64),
            res2_hist=torch.zeros(self.ops.res2.hist_len, **c64),
            fm_prev=torch.zeros((), **c64),
            up_hist=torch.zeros(self.ops.up.hist_len, dtype=torch.float32,
                                device=self.device))

    def step(self, state, wire: torch.Tensor):
        if wire.shape != (self.step_arg_len,):
            raise ValueError(f"wire has shape {tuple(wire.shape)}, expected "
                             f"({self.step_arg_len},)")
        if self.op:
            return self._op_step(state, wire)
        o = self.kernels(wire, *state)
        # clipped in the kernel; the int16 cast truncates toward zero, as
        # the JAX chain's astype(jnp.int16) does
        return (DsdState(o.dc_x, o.dc_y, o.front_hist, o.band_hist,
                         o.sig_prev, o.demod_hist), o.out.to(torch.int16))

    def _op_step(self, st: DsdOpState, wire: torch.Tensor):
        """JAX dsd_in.py:187-200 on plain ops."""
        xr, xi = decode.decode_planes(wire, self.input_format)
        dx, dy, r1, band = self.ops.resample(                  # 200 kHz
            st.dc_x, st.dc_y, st.res1_hist, torch.stack([xr, xi]))
        r2, sig = self.ops.res2(planes(st.res2_hist), band)    # 12.5 kHz
        fm_prev, audio = fm.fm_demod(st.fm_prev, complex_of(sig))
        uh, out48 = self.ops.up(st.up_hist, audio)             # 48 kHz
        return (DsdOpState(dx, dy, r1, complex_of(r2), fm_prev, uh),
                to_pcm(out48))

    def multi_step(self, state, wires: torch.Tensor):
        """S blocks in one dispatch (runtime/fuse.py): ``wires`` uint8 [S,
        step_arg_len]; the pcm comes back [S * output_len], equal to S
        step() calls bit for bit."""
        return self.megastep(state, wires)
