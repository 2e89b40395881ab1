"""Single-channel NBFM monitor chain (BASELINE.json config 1), PyTorch.

Counterpart of sdr_pmr446_tpu/scanner/single.py: fixed-tune demodulation
of ONE PMR channel from the 1.024 Msps band capture — resample to 200 kHz,
mix the channel to baseband (a 32-entry phase table indexed by the band
sample's global index mod 32), 16x decimating channel filter, NBFM
discriminator, then the CTCSS-removal highpass, audio gain and
de-emphasis.

``engine="kernel"`` (the default, JAX ``use_pallas=True``), the three
audio stages composed into one FIR: with ``mono=True`` (the default, the
JAX MONO one-kernel chain) one launch of K4 (kernels/chan_tail.py::
MonoChain, mode "single"); with ``mono=False``, the JAX two-kernel engine,
K6 (kernels/front_end.py::FrontEnd) writes the band planes and K5
(kernels/chan_tail.py::ChanTail) runs the rest.  Both carry the same state
(SingleState, JAX's PallasSingleState), so a state passes between the
engines and the packages.  The mixer phase is carried in ``n0``, so every
K is served, including an odd number of 400-sample group rows per step
(odd K), which the JAX kernels' (-1)^(g+u) alternation cannot take.

``engine="op"`` (JAX ``use_pallas=False``, JAX single.py:155-178): the
stages as plain ops, the highpass and the de-emphasis as two FIRs,
carrying SingleOpState (JAX's SingleState); it takes the cf32 wire only,
as JAX's op engine takes complex64 only (JAX single.py:80-81), and
``mono`` does not apply.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from sdr_pmr446_tpu_torch import config as C
from sdr_pmr446_tpu_torch import device as devices
from sdr_pmr446_tpu_torch import engine as engines
from sdr_pmr446_tpu_torch import precision
from sdr_pmr446_tpu_torch.ops import decode, fir, fm
from sdr_pmr446_tpu_torch.ops.resample import (PolyResampler, complex_of,
                                               planes)
from sdr_pmr446_tpu_torch.runtime import fuse
from sdr_pmr446_tpu_torch.scanner.op_front import OpResample
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


class SingleOpState(NamedTuple):
    """The layout of the JAX op engine's SingleState (use_pallas=False)."""
    dc_x: torch.Tensor          # c64 []
    dc_y: torch.Tensor          # c64 []
    res_hist: torch.Tensor      # c64 [345]  25/128 resampler input
    ch_hist: torch.Tensor       # c64 [837]  channel filter input (mixed)
    fm_prev: torch.Tensor       # c64 []
    hp_hist: torch.Tensor       # f32 [376]
    deemph_hist: torch.Tensor   # f32 [deemph taps - 1]
    n0: torch.Tensor            # i32 []  band index mod 32 (mixer phase)


class SingleOps(OpResample):
    """The op engine's filters: the DC blocker and the 25/128 resampler
    (OpResample; JAX SingleChannelChain's res), then chf, hp_taps,
    deemph_taps, and the channel's 32-entry mixer table."""

    def __init__(self, channel: int, device):
        from sdr_pmr446_tpu_torch.kernels.chan_tail import mixer_table
        super().__init__(device)
        self.chf = PolyResampler(np.asarray(channel_filter_taps()), 1,
                                 C.NUM_CHANNELS, device=device)
        f32 = lambda taps: torch.as_tensor(  # noqa: E731
            np.asarray(taps, np.float32), device=device)
        self.register_buffer("hp_taps", f32(D.ctcss_hp_taps()))
        self.register_buffer("deemph_taps", f32(D.deemph_fir_equiv()))
        self.register_buffer("tab", torch.as_tensor(mixer_table(channel),
                                                    device=device))

    def mix(self, band: torch.Tensor, n0: torch.Tensor) -> torch.Tensor:
        """band c64 [..., T] times e^{-j w (n0 + n)}: the table at (n +
        n0) mod 32, ``n0`` [...] each row's first global band index."""
        n = torch.arange(band.shape[-1], device=band.device)
        period = self.tab.shape[0]
        return band * self.tab[(n + n0[..., None].long()) % period]


class SingleChannelChain:
    """Block step ``(state, wire uint8 [step_arg_len]) -> (state', audio f32
    [T*25/2048])`` for one fixed channel (1..16), on ``engine`` (module
    docstring)."""

    def __init__(self, channel: int, subchunks_per_step: int = 10,
                 audio_gain: float = C.SDR_DEFAULT_AUDIO_GAIN,
                 input_format: str = "cf32", device=devices.DEFAULT,
                 mono: bool = True, engine: str = engines.KERNEL):
        from sdr_pmr446_tpu_torch.kernels.chan_tail import (MonoChain,
                                                            TwoKernelChain)
        precision.check()
        self.device = devices.resolve(device)
        self.engine = engines.resolve(engine)
        self.op = self.engine == engines.OP
        self.channel = channel
        self.audio_gain = audio_gain
        self.input_format = decode.wire_format(input_format)
        if self.op and self.input_format != "cf32":
            raise ValueError(f"the single-channel op engine takes the cf32 "
                             f"wire only (got {self.input_format!r}), as the "
                             f"JAX op engine takes complex64 only; the "
                             f"kernel engine decodes every format")
        self.input_len = subchunks_per_step * C.SUBCHUNK_IN
        self.output_len = self.input_len * 25 // 2048
        self.mono = mono and not self.op
        if self.op:
            self.ops = SingleOps(channel, self.device)
        else:
            self.kernels = (MonoChain if mono else TwoKernelChain)(
                "single", self.input_format, channel=channel,
                audio_gain=audio_gain, device=self.device)
        self.megastep = fuse.fused_steps(self.step)

    @property
    def step_arg_len(self) -> int:
        """Wire bytes per step."""
        return self.input_len * decode.BYTES_PER_SAMPLE[self.input_format]

    def init_state(self):
        """SingleState (kernel engine) or SingleOpState (op engine), zero."""
        i32 = dict(dtype=torch.int32, device=self.device)
        if not self.op:
            return SingleState(*self.kernels.init_state(self.device),
                               torch.zeros((), **i32))
        c64 = dict(dtype=torch.complex64, device=self.device)
        return SingleOpState(
            dc_x=torch.zeros((), **c64), dc_y=torch.zeros((), **c64),
            res_hist=torch.zeros(self.ops.resampler.hist_len, **c64),
            ch_hist=torch.zeros(self.ops.chf.hist_len, **c64),
            fm_prev=torch.zeros((), **c64),
            hp_hist=fir.fir_init(C.HP_AUDIO_FILT_TAPS, device=self.device),
            deemph_hist=fir.fir_init(self.ops.deemph_taps.shape[0],
                                     device=self.device),
            n0=torch.zeros((), **i32))

    def step(self, state, wire: torch.Tensor):
        if wire.shape != (self.step_arg_len,):
            raise ValueError(f"wire has shape {tuple(wire.shape)}, expected "
                             f"({self.step_arg_len},)")
        if self.op:
            return self._op_step(state, wire)
        o = self.kernels(wire, *state[:-1], n0=state.n0)
        return (SingleState(o.dc_x, o.dc_y, o.front_hist, o.band_hist,
                            o.sig_prev, o.demod_hist, o.n0), o.out)

    def _op_step(self, st: SingleOpState, wire: torch.Tensor):
        """JAX single.py:155-178 on plain ops."""
        ops = self.ops
        xr, xi = decode.decode_planes(wire, self.input_format)
        dx, dy, rh, band = ops.resample(st.dc_x, st.dc_y, st.res_hist,
                                        torch.stack([xr, xi]))
        mixed = ops.mix(complex_of(band), st.n0)
        ch_h, sig = ops.chf(planes(st.ch_hist), planes(mixed))
        fm_prev, audio = fm.fm_demod(st.fm_prev, complex_of(sig))
        hp_h, audio = fir.fir_apply(st.hp_hist, audio, ops.hp_taps)
        de_h, audio = fir.fir_apply(st.deemph_hist, audio * self.audio_gain,
                                    ops.deemph_taps)
        n0 = ((st.n0 + band.shape[-1]) % ops.tab.shape[0]).to(torch.int32)
        return (SingleOpState(dx, dy, rh, complex_of(ch_h), fm_prev, hp_h,
                              de_h, n0), audio)

    def multi_step(self, state, wires: torch.Tensor):
        """S blocks in one dispatch (runtime/fuse.py): ``wires`` uint8 [S,
        step_arg_len]; the audio comes back [S * output_len], equal to S
        step() calls bit for bit."""
        return self.megastep(state, wires)
