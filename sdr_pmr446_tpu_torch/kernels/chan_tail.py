"""K4 (the dsd_in / single-channel "mono chain") and K5 (its tail), in CUDA.

Each is a CUDA kernel with its plain PyTorch version beside it.

K4 replaces the TPU kernel
sdr_pmr446_tpu/kernels/chan_tail.py::PallasMonoChain.apply (bodies
``_mono_body_pk2`` / ``_mono_body_cs16`` / ``_mono_body_ilv`` and the tail
``_tail_core``); K5 replaces PallasChanTail.apply (``_body``), steps 2-4
alone on the band planes that K6 (kernels/front_end.py) writes: the
two-kernel engine, ``mono=False``.  For one block of wire bytes K4 computes

  1. K6's front end (kernels/front_end.py::FrontEnd): wire decode, the IQ
     DC blocker and the 25/128 resampler to the 200 kHz band;
  2. a 16x decimating lowpass to 12.5 kHz: the 477-tap 60 dB filter of
     scanner/dsd_in.stage2_taps (mode "dsd"), or, after the channel mixer
     band[i] * e^{-j w (n0 + i)}, the 838-tap 80 dB channel filter of
     scanner/single.channel_filter_taps (mode "single");
  3. the NBFM discriminator (kf = 0.5) against the carried previous sample;
  4. "dsd": the 96/25 polyphase upsampler to 48 kHz, x32767, clipped to
     [-32768, 32767] (the caller truncates to int16); "single": the 408-tap
     composed CTCSS-highpass * de-emphasis FIR x audio gain.

Carried state, the JAX mono engine's layout (PallasDsdState /
PallasSingleState), so a JAX state loads into the port unchanged: dc_x,
dc_y (c64), front_hist (c64 [512] cu8/cs8, [384] otherwise), band_hist (c64
[hb * 400]: the last raw band samples, hb = 2 dsd / 3 single), sig_prev
(c64, the last decimated sample in true, mixed space), demod_hist (f32
[dh * 25], dh = 2 / 17) and, for "single", n0 (i32, the band index of the
block's first sample mod 32: the mixer phase).

``ChanTail(mode, channel, audio_gain, device=)(band [2, nb], band_hist,
sig_prev, demod_hist, n0=None) -> TailOut(band_hist', sig_prev',
demod_hist', n0', out)`` is K5, and K4's plain version is K6's followed by
K5's.  The JAX kernels fold the mixer into complex decimator taps plus a
(-1)^(g + u) alternation that is right only when a step has an even number
of 400-sample group rows (K % 8 == 0), and K5 takes the rotation ``rot``
where the port carries ``n0``.  Here the mixer is applied exactly, by
index, so every K is served.

The CUDA version (csrc/chan_tail.cu) runs five launches on the current
stream: the three front-end launches of K1 (csrc/front_end.cuh), then the
tail in two.  Launch A (``tail_decim``) writes the carried state, stages
its window of [band_hist | band] and the decimator taps by ``cp.async``,
mixes each sample once (single), and runs the 16x decimator as a
register-tiled polyphase product (a warp a phase, a lane 4 consecutive
outputs of both planes, the taps staged by phase: ``staged_decim_taps``)
with the discriminator in its epilogue; only the demod reaches device
memory.  Launch B (``tail_post``) runs the upsampler (dsd, its [96][43]
table staged once a block) or the audio FIR (single, the same tiled FIR
over ``staged_fir_taps``, 4 tap segments a block).  What bounds K4 on the
H100: at K = 16 it does ~0.49 GFLOP (dsd) or ~0.53 GFLOP (single), most
of it the front end's resampler, against a 3.2 MB cu8 read — operations
bound, ~7-8 us at the card's f32 rate (chip_smoke.py counts it).  The
tail alone reads the 2.5 MB band and does 45-84 MFLOP: ~1 us.  Small
launches are most of its time, so it has two.

K5's CUDA version (``tail_run`` in csrc/chan_tail.cu) runs launches A and
B on K6's band; K4 runs the same two kernels, so its outputs equal K6 ->
K5's bit for bit.  See the source for the design.

K4 runs behind the ``torch.library`` custom op ``sdr_pmr446::mono``: the
launch is its CUDA implementation (registered for "cuda" alone), the plain
version its CPU implementation ("cpu" alone), the tables tensor arguments;
the live chains and an exported step (apps/export_chain.py) call the op,
and ``LAUNCHES`` counts in its CUDA implementation.  K5, which no exported
step reaches, stays a direct launch.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from sdr_pmr446_tpu_torch import config as C
from sdr_pmr446_tpu_torch.kernels import build
from sdr_pmr446_tpu_torch.kernels import front_end as fe
from sdr_pmr446_tpu_torch.kernels.front_end import (FMT_CODE, FrontEnd,
                                                    compact_phases)
from sdr_pmr446_tpu_torch.kernels.pfb_demod import DEMOD_SCALE
from sdr_pmr446_tpu_torch.ops import fm
from sdr_pmr446_tpu_torch.ops.resample import PolyResampler, _kernel_matrix
from sdr_pmr446_tpu_torch.taps import design as D

GL = 400                      # band samples per JAX group row
DPS = 25                      # decimated samples per group row
DEC = 16                      # decimation of the channel filter
PHASE_PERIOD = 32             # mixer period in band samples (fs / 6.25 kHz)
MODES = ("dsd", "single")
#: mode codes of the C entry points (csrc/chan_tail.cu MODE_*)
MODE_CODE = {"dsd": 0, "single": 1}
#: (history group rows hb, demod history rows dh, outputs per group row)
GEOMETRY = {"dsd": (2, 2, 96), "single": (3, 17, 25)}
#: the CUDA tail's tiles (csrc/chan_tail.cu TILE_R, TILE_G, DEC_TILE,
#: DEC_JMAX, FIR_SPLIT, FIR_TILE, MAX_FIR_TAPS): outputs a thread, staged
#: taps padded to whole TILE_G, decimated outputs a block, most staged taps
#: a phase, the audio FIR's tap segments, outputs a block and longest
#: staged FIR
TILE_R, TILE_G, DEC_TILE, DEC_JMAX = 4, 8, 128, 56
FIR_SPLIT, FIR_TILE, MAX_FIR_TAPS = 4, 128, 512

#: kernel launches of K4's CUDA version (one per chain step); the plain
#: version never counts
LAUNCHES = 0
#: kernel launches of K5's CUDA version (one per chain step), likewise
TAIL_LAUNCHES = 0


class MonoOut(NamedTuple):
    dc_x: torch.Tensor        # c64 []
    dc_y: torch.Tensor        # c64 []
    front_hist: torch.Tensor  # c64 [H]
    band_hist: torch.Tensor   # c64 [hb * 400]
    sig_prev: torch.Tensor    # c64 []
    demod_hist: torch.Tensor  # f32 [dh * 25]
    n0: Optional[torch.Tensor]  # i32 [] ("single"), None ("dsd")
    out: torch.Tensor         # f32 [G * 96] ("dsd") / [G * 25] ("single")


class TailOut(NamedTuple):
    band_hist: torch.Tensor   # c64 [hb * 400]
    sig_prev: torch.Tensor    # c64 []
    demod_hist: torch.Tensor  # f32 [dh * 25]
    n0: Optional[torch.Tensor]  # i32 [] ("single"), None ("dsd")
    out: torch.Tensor         # f32 [G * 96] ("dsd") / [G * 25] ("single")


def mixer_table(channel: int) -> np.ndarray:
    """c64 [32]: e^{-j w n} for the channel's offset from the band centre
    (a multiple of fs/32, so the ramp has period 32: exact by table)."""
    f_off = (channel - 1) * C.CHANNEL_WIDTH_HZ - 93_750.0
    omega = 2.0 * np.pi * f_off / C.SDR_RESAMPLERATE
    return np.exp(-1j * omega * np.arange(PHASE_PERIOD)).astype(np.complex64)


def audio_fir_taps(audio_gain: float) -> np.ndarray:
    """f32 [408]: conv(CTCSS highpass, de-emphasis) x gain, composed in
    float64 (the JAX kernel's _fir_matrix taps)."""
    comp = np.convolve(D.ctcss_hp_taps(), D.deemph_fir_equiv())
    return (np.asarray(comp, np.float64) * float(audio_gain)).astype(
        np.float32)


def _whole(n: int, m: int) -> int:
    return -(-n // m) * m


def staged_decim_taps(kd: np.ndarray) -> np.ndarray:
    """f32 [DEC, J]: the CUDA decimator's taps by phase.  ``kd`` [P] is the
    decimator as applied (y[f] = sum_w kd[w] x[16 f + w - (P - 1)], the
    PolyResampler weight); front-padded with zeros to P' = 16 J taps (J =
    ceil(P / 16) to a whole TILE_G), row p holds kd'[16 j + p] over j.  The
    same f32 values, moved."""
    kd = np.asarray(kd, np.float32).reshape(-1)
    j = _whole(-(-kd.shape[0] // DEC), TILE_G)
    if j > DEC_JMAX:
        raise ValueError(f"{kd.shape[0]} decimator taps exceed the kernel's "
                         f"{DEC * DEC_JMAX}")
    kp = np.zeros(DEC * j, np.float32)
    kp[DEC * j - kd.shape[0]:] = kd
    return np.ascontiguousarray(kp.reshape(j, DEC).T)


def staged_fir_taps(h: np.ndarray) -> np.ndarray:
    """f32 [NTP]: the CUDA audio FIR's taps, reversed and front-padded with
    zeros to NTP = FIR_SPLIT segments of a whole TILE_G: out[n] = sum_q
    hs[q] de[DH - (NTP - 1) + n + q] is the FIR out[n] = sum_k h[k] de[DH +
    n - k]."""
    h = np.asarray(h, np.float32)
    ntp = FIR_SPLIT * _whole(-(-h.shape[0] // FIR_SPLIT), TILE_G)
    if ntp > MAX_FIR_TAPS:
        raise ValueError(f"{h.shape[0]} FIR taps exceed the kernel's "
                         f"{MAX_FIR_TAPS}")
    out = np.zeros(ntp, np.float32)
    out[ntp - h.shape[0]:] = h[::-1]
    return out


class ChanTail(nn.Module):
    """K5 for one mode.  ``module(band, band_hist, sig_prev, demod_hist,
    n0)`` -> TailOut: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors.  K4 (MonoChain) runs it after its front end."""

    def __init__(self, mode: str, channel: int | None = None,
                 audio_gain: float = 1.0, *, device):
        super().__init__()
        if mode not in MODES:
            raise ValueError(f"unknown mode {mode!r}")
        self.mode = mode
        self.hb, self.dh, self.out_w = GEOMETRY[mode]
        if mode == "dsd":
            from sdr_pmr446_tpu_torch.scanner.dsd_in import stage2_taps, up_taps
            dec_taps = np.asarray(stage2_taps())
            up = np.asarray(up_taps(), np.float64) * 32767.0
            self.up = PolyResampler(up, 96, DPS, device)
            self.register_buffer("post_taps", torch.as_tensor(
                compact_phases(up, 96, DPS), device=device))
        else:
            from sdr_pmr446_tpu_torch.scanner.single import channel_filter_taps
            if channel is None or not 1 <= channel <= C.NUM_CHANNELS:
                raise ValueError(f"channel must be 1..{C.NUM_CHANNELS}")
            dec_taps = np.asarray(channel_filter_taps())
            self.register_buffer("tab", torch.as_tensor(
                mixer_table(channel), device=device))
            self.register_buffer("post_taps", torch.as_tensor(
                audio_fir_taps(audio_gain), device=device))
        self.decim = PolyResampler(dec_taps, 1, DEC, device)
        if self.hb * GL < self.decim.hist_len:
            raise ValueError("band history shorter than the decimator")
        # the CUDA kernels' staged tables (the same f32 values, moved)
        kd = _kernel_matrix(tuple(np.asarray(dec_taps, np.float64).tolist()),
                            1, DEC).astype(np.float32)[0]
        self.register_buffer("kd_staged", torch.as_tensor(
            staged_decim_taps(kd), device=device))
        self.register_buffer("post_staged", self.post_taps if mode == "dsd"
                             else torch.as_tensor(staged_fir_taps(
                                 audio_fir_taps(audio_gain)), device=device))

    def init_state(self, device) -> tuple:
        """Zero (band_hist, sig_prev, demod_hist)."""
        c64 = dict(dtype=torch.complex64, device=device)
        return (torch.zeros(self.hb * GL, **c64), torch.zeros((), **c64),
                torch.zeros(self.dh * DPS, dtype=torch.float32,
                            device=device))

    def geometry(self, band: torch.Tensor):
        """(band samples nb, decimated samples F, group rows G)."""
        if band.dim() != 2 or band.shape[0] != 2:
            raise ValueError(f"band must be planes [2, nb], got "
                             f"{tuple(band.shape)}")
        nb = band.shape[1]
        if nb == 0 or nb % GL:
            raise ValueError(f"{nb} band samples is not whole group rows of "
                             f"{GL}")
        return nb, nb // DEC, nb // GL

    def check_n0(self, n0) -> None:
        if (n0 is None) != (self.mode == "dsd"):
            raise ValueError("n0 is the single chain's mixer phase: pass it "
                             "for mode 'single' only")

    def forward(self, band, band_hist, sig_prev, demod_hist,
                n0=None) -> TailOut:
        if band.device.type == "cuda":
            return self.kernel(band, band_hist, sig_prev, demod_hist, n0)
        if band.device.type == "cpu":
            return self.plain(band, band_hist, sig_prev, demod_hist, n0)
        raise ValueError(f"no channel-tail implementation for device "
                         f"{band.device}")

    # ------------------------------------------------------------ plain
    def plain(self, band, band_hist, sig_prev, demod_hist,
              n0=None) -> TailOut:
        """The same function in plain PyTorch ops, step by step as the JAX
        op path runs it (any device)."""
        self.check_n0(n0)
        nb, _, _ = self.geometry(band)
        hb = self.hb * GL
        be = torch.cat([torch.view_as_real(band_hist).T, band], dim=-1)
        new_bh = torch.complex(be[0, nb:], be[1, nb:])
        new_n0 = None
        if self.mode == "single":
            i = torch.arange(-hb, nb, device=be.device)
            mixed = (torch.complex(be[0], be[1])
                     * self.tab[torch.remainder(i + n0, PHASE_PERIOD)])
            be = torch.view_as_real(mixed).T
            new_n0 = torch.remainder(n0 + nb, PHASE_PERIOD).to(torch.int32)
        _, y = self.decim(be[:, :hb], be[:, hb:])
        new_prev, dem = fm.fm_demod(sig_prev, torch.complex(y[0], y[1]))
        if self.mode == "dsd":
            new_dh, out = self.up(demod_hist, dem)
            out = torch.clamp(out, -32768.0, 32767.0)
        else:
            de = torch.cat([demod_hist, dem])
            nt = self.post_taps.shape[0]
            out = torch.nn.functional.conv1d(
                de[de.shape[0] - dem.shape[0] - (nt - 1):].reshape(1, 1, -1),
                torch.flip(self.post_taps, dims=[0]).reshape(1, 1, -1))
            out = out.reshape(-1)
            new_dh = de[dem.shape[0]:]
        return TailOut(new_bh.contiguous(), new_prev, new_dh.contiguous(),
                       new_n0, out.contiguous())

    # ------------------------------------------------------------- cuda
    def check_state(self, band_hist, sig_prev, demod_hist, n0, dev) -> None:
        """Raise unless the carried state and the taps suit the kernels."""
        build.require(band_hist, "band_hist", torch.complex64,
                      (self.hb * GL,), dev)
        build.require(sig_prev, "sig_prev", torch.complex64, (), dev)
        build.require(demod_hist, "demod_hist", torch.float32,
                      (self.dh * DPS,), dev)
        build.require(self.kd_staged, "decimator taps", torch.float32,
                      None, dev)
        build.require(self.post_staged, "post taps", torch.float32, None,
                      dev)
        if self.mode == "single":
            build.require(n0, "n0", torch.int32, (), dev)
            build.require(self.tab, "mixer table", torch.complex64,
                          (PHASE_PERIOD,), dev)

    def c_args(self) -> tuple:
        """(staged decimator taps, J, tab, post table, its width, scale) as
        tail_run and mono_run take them."""
        single = self.mode == "single"
        return (self.kd_staged.data_ptr(), self.kd_staged.shape[1],
                self.tab.data_ptr() if single else None,
                self.post_staged.data_ptr(), self.post_staged.shape[-1],
                DEMOD_SCALE)

    def outputs(self, g: int, dev) -> TailOut:
        """Empty outputs for ``g`` group rows."""
        c64 = dict(dtype=torch.complex64, device=dev)
        return TailOut(torch.empty(self.hb * GL, **c64),
                       torch.empty((), **c64),
                       torch.empty(self.dh * DPS, dtype=torch.float32,
                                   device=dev),
                       torch.empty((), dtype=torch.int32, device=dev)
                       if self.mode == "single" else None,
                       torch.empty(g * self.out_w, dtype=torch.float32,
                                   device=dev))

    def kernel(self, band, band_hist, sig_prev, demod_hist,
               n0=None) -> TailOut:
        """Launch tail_run (csrc/chan_tail.cu) on the current stream
        (raises on any fault)."""
        global TAIL_LAUNCHES
        self.check_n0(n0)
        nb, f, g = self.geometry(band)
        dev = band.device
        build.require(band, "band", torch.float32, (2, nb), dev)
        self.check_state(band_hist, sig_prev, demod_hist, n0, dev)
        dem = torch.empty(f, dtype=torch.float32, device=dev)
        out = self.outputs(g, dev)
        code = build.library().tail_run(
            MODE_CODE[self.mode], band.data_ptr(), nb, band_hist.data_ptr(),
            self.hb * GL, sig_prev.data_ptr(), demod_hist.data_ptr(),
            self.dh * DPS, _ptr(n0), *self.c_args(),
            dem.data_ptr(), out.band_hist.data_ptr(), out.sig_prev.data_ptr(),
            out.demod_hist.data_ptr(), _ptr(out.n0), out.out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
        build.check(code, "tail_run")
        TAIL_LAUNCHES += 1
        return out


def _ptr(t):
    return t.data_ptr() if t is not None else None


def mono_geometry(wire: torch.Tensor, fmt: str):
    """(n input samples, band samples nb, decimated samples F, group rows
    G) of one block of K4."""
    n = fe.wire_samples(wire, fmt)
    nb = n * C.RESAMP_L // C.RESAMP_M
    if nb % GL:
        raise ValueError(f"{nb} band samples is not whole group rows of "
                         f"{GL}")
    return n, nb, nb // DEC, nb // GL


def check_mode(mode: str, n0) -> None:
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    if (n0 is None) != (mode == "dsd"):
        raise ValueError("n0 is the single chain's mixer phase: pass it "
                         "for mode 'single' only")


# ------------------------------------------------------ the custom op
# (dc_x', dc_y', front_hist', band_hist', sig_prev', demod_hist', n0',
# out): MonoOut's fields, n0' a zero i32 [] for mode "dsd"

@functools.lru_cache(maxsize=None)
def _plain_module(mode: str, fmt: str, channel: int,
                  audio_gain: float) -> "MonoChain":
    """The CPU module whose plain version the op's CPU implementation runs
    (channel 0: none, mode "dsd")."""
    return MonoChain(mode, fmt, channel or None, audio_gain, device="cpu")


@torch.library.custom_op("sdr_pmr446::mono", mutates_args=(),
                         device_types="cpu")
def mono_op(wire: torch.Tensor, dc_x: torch.Tensor, dc_y: torch.Tensor,
            front_hist: torch.Tensor, band_hist: torch.Tensor,
            sig_prev: torch.Tensor, demod_hist: torch.Tensor,
            n0: torch.Tensor | None, kt: torch.Tensor, pj: torch.Tensor,
            kd: torch.Tensor, tab: torch.Tensor | None, post: torch.Tensor,
            fmt: str, mode: str, channel: int, audio_gain: float
            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                       torch.Tensor, torch.Tensor, torch.Tensor,
                       torch.Tensor, torch.Tensor]:
    """K4 on CPU tensors: the plain version."""
    o = _plain_module(mode, fmt, channel, audio_gain).plain(
        wire, dc_x, dc_y, front_hist, band_hist, sig_prev, demod_hist, n0)
    n0_out = (o.n0 if o.n0 is not None
              else torch.zeros((), dtype=torch.int32))
    return tuple(build.owned(t) for t in o[:6] + (n0_out, o.out))


@mono_op.register_kernel("cuda")
def _mono_cuda(wire, dc_x, dc_y, front_hist, band_hist, sig_prev, demod_hist,
               n0, kt, pj, kd, tab, post, fmt, mode, channel, audio_gain):
    """K4 on CUDA tensors: mono_run (csrc/chan_tail.cu) on the current
    stream (raises on any fault)."""
    global LAUNCHES
    check_mode(mode, n0)
    n, nb, f, g = mono_geometry(wire, fmt)
    dev = wire.device
    h = front_hist.shape[0]
    hb, dh, out_w = GEOMETRY[mode]
    fe.check_state(fmt, wire, dc_x, dc_y, front_hist)
    build.require(band_hist, "band_hist", torch.complex64, (hb * GL,), dev)
    build.require(sig_prev, "sig_prev", torch.complex64, (), dev)
    build.require(demod_hist, "demod_hist", torch.float32, (dh * DPS,), dev)
    build.require(kd, "decimator taps", torch.float32, None, dev)
    build.require(post, "post taps", torch.float32, None, dev)
    if mode == "single":
        build.require(n0, "n0", torch.int32, (), dev)
        build.require(tab, "mixer table", torch.complex64, (PHASE_PERIOD,),
                      dev)
    (ylocal, yend, carry), fe_args = fe.kernel_args(kt, pj, n, dev)
    f32 = dict(dtype=torch.float32, device=dev)
    c64 = dict(dtype=torch.complex64, device=dev)
    band, dem = torch.empty(2 * nb, **f32), torch.empty(f, **f32)
    i32 = dict(dtype=torch.int32, device=dev)
    out = (torch.empty((), **c64), torch.empty((), **c64),
           torch.empty(h, **c64), torch.empty(hb * GL, **c64),
           torch.empty((), **c64), torch.empty(dh * DPS, **f32),
           torch.empty((), **i32) if mode == "single"
           else torch.zeros((), **i32),
           torch.empty(g * out_w, **f32))
    o_dcx, o_dcy, o_fh, o_bh, o_sp, o_dh, o_n0, o_out = out
    single = mode == "single"
    code = build.library().mono_run(
        FMT_CODE[fmt], MODE_CODE[mode], wire.data_ptr(), n,
        dc_x.data_ptr(), dc_y.data_ptr(), front_hist.data_ptr(), h,
        band_hist.data_ptr(), hb * GL, sig_prev.data_ptr(),
        demod_hist.data_ptr(), dh * DPS, _ptr(n0), *fe_args,
        kd.data_ptr(), kd.shape[1], tab.data_ptr() if single else None,
        post.data_ptr(), post.shape[-1], DEMOD_SCALE,
        ylocal.data_ptr(), yend.data_ptr(), carry.data_ptr(),
        band.data_ptr(), dem.data_ptr(),
        o_dcx.data_ptr(), o_dcy.data_ptr(), o_fh.data_ptr(),
        o_bh.data_ptr(), o_sp.data_ptr(), o_dh.data_ptr(),
        o_n0.data_ptr() if single else None, o_out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(code, "mono_run")
    LAUNCHES += 1
    return out


@mono_op.register_fake
def _mono_fake(wire, dc_x, dc_y, front_hist, band_hist, sig_prev, demod_hist,
               n0, kt, pj, kd, tab, post, fmt, mode, channel, audio_gain):
    check_mode(mode, n0)
    _, _, _, g = mono_geometry(wire, fmt)
    hb, dh, out_w = GEOMETRY[mode]
    c64 = dict(dtype=torch.complex64)
    f32 = dict(dtype=torch.float32)
    return (dc_x.new_empty((), **c64), dc_y.new_empty((), **c64),
            front_hist.new_empty(front_hist.shape, **c64),
            band_hist.new_empty((hb * GL,), **c64),
            sig_prev.new_empty((), **c64),
            demod_hist.new_empty((dh * DPS,), **f32),
            wire.new_empty((), dtype=torch.int32),
            wire.new_empty((g * out_w,), **f32))


class MonoChain(nn.Module):
    """K4 for one mode and wire format.  ``module(wire, dc_x, dc_y,
    front_hist, band_hist, sig_prev, demod_hist, n0)`` -> MonoOut through
    ``sdr_pmr446::mono``: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""

    def __init__(self, mode: str, fmt: str, channel: int | None = None,
                 audio_gain: float = 1.0, *, device):
        super().__init__()
        self.tail = ChanTail(mode, channel, audio_gain, device=device)
        self.front = FrontEnd(fmt, device=device)
        self.fmt = self.front.fmt
        self.mode = mode
        self.channel = channel
        self.audio_gain = float(audio_gain)
        self.hb, self.dh, self.out_w = GEOMETRY[mode]

    def init_state(self, device) -> tuple:
        """Zero (dc_x, dc_y, front_hist, band_hist, sig_prev, demod_hist)."""
        c64 = dict(dtype=torch.complex64, device=device)
        return (torch.zeros((), **c64), torch.zeros((), **c64),
                torch.zeros(self.front.hist_len, **c64),
                *self.tail.init_state(device))

    def forward(self, wire, dc_x, dc_y, front_hist, band_hist, sig_prev,
                demod_hist, n0=None) -> MonoOut:
        if wire.device.type not in ("cuda", "cpu"):
            raise ValueError(f"no mono-chain implementation for device "
                             f"{wire.device}")
        t = self.tail
        o = mono_op(wire, dc_x, dc_y, front_hist, band_hist, sig_prev,
                    demod_hist, n0, self.front.kt, self.front.pj,
                    t.kd_staged, t.tab if self.mode == "single" else None,
                    t.post_staged, self.fmt, self.mode, self.channel or 0,
                    self.audio_gain)
        return MonoOut(*o[:6], o[6] if self.mode == "single" else None, o[7])

    # ------------------------------------------------------------ plain
    def plain(self, wire, dc_x, dc_y, front_hist, band_hist, sig_prev,
              demod_hist, n0=None) -> MonoOut:
        """The same function in plain PyTorch ops: K6's plain version, then
        K5's (any device)."""
        self.tail.check_n0(n0)
        fe_out = self.front.plain(wire, dc_x, dc_y, front_hist)
        t = self.tail.plain(fe_out.band, band_hist, sig_prev, demod_hist, n0)
        return MonoOut(fe_out.dc_x, fe_out.dc_y, fe_out.front_hist, *t)

    # ------------------------------------------------------------- cuda
    def kernel(self, wire, dc_x, dc_y, front_hist, band_hist, sig_prev,
               demod_hist, n0=None) -> MonoOut:
        """The op on CUDA tensors: mono_run (csrc/chan_tail.cu) on the
        current stream."""
        if wire.device.type != "cuda":
            raise ValueError(f"the mono-chain kernel takes CUDA tensors, got "
                             f"{wire.device}")
        return self(wire, dc_x, dc_y, front_hist, band_hist, sig_prev,
                    demod_hist, n0)


class TwoKernelChain(MonoChain):
    """The two-kernel engine (JAX ``mono=False``): K6 writes the band
    planes, then K5 runs the tail on them.  K4's interface, state and plain
    version; on CUDA tensors ``forward`` launches K6 and K5."""

    def forward(self, wire, dc_x, dc_y, front_hist, band_hist, sig_prev,
                demod_hist, n0=None) -> MonoOut:
        self.tail.check_n0(n0)
        fe = self.front(wire, dc_x, dc_y, front_hist)
        t = self.tail(fe.band, band_hist, sig_prev, demod_hist, n0)
        return MonoOut(fe.dc_x, fe.dc_y, fe.front_hist, *t)
