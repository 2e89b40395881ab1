"""The 16-channel PMR446 scanner block step (PyTorch).

Counterpart of sdr_pmr446_tpu/scanner/chain.py::ScannerChain._step_impl on
its kernel engines (``engine="kernel"``, the default; JAX
``use_pallas=True``) and on its op engine (``engine="op"``, JAX
``use_pallas=False``; below):

    (state, wire bytes [K * SUBCHUNK_IN samples], params) -> (state', StepOutputs)

  1. wire in (raw capture bytes, torch.uint8);
  2. decode, DC blocker, resampler, PFB, discriminator, per-sub-chunk |y|
     sums -> RSSI, on one of three engines, as in JAX:
     - ``fuse_band=True`` (the default, the JAX duo): K1
       (kernels/duo.py);
     - ``fuse_band=False``, the JAX "trio": K6 (kernels/front_end.py) ->
       K7 (kernels/pfb_demod.py);
     - ``fuse_dc=False``: the wire decoded to planes and the DC blocker as
       plain ops (ops/decode.py, ops/iir.py, XLA ops in JAX too) -> K9
       (kernels/resample_kernel.py) -> K7; it implies the trio, as in JAX,
       and carries the resampler's 345-sample history in ``resamp_hist``;
  3. FSM phase A: the squelch schedule from RSSI alone;
  4. K2 (kernels/audio_bank.py): audio FIR bank, lp DC blocker and the
     selected channel's CTCSS tone sums;
  5. FSM phase C: CTCSS detection and events;
  6. per-sub-chunk selection of the active channel's audio;
  7. with the waterfall on (``waterfall=w``): K3 (kernels/waterfall.py) on
     the engine's band planes -> one dB row of w bins per sub-chunk.

Three op-path switches, with the JAX names, defaults and implications
(JAX chain.py:123-152, 376-429, 487-501), replace steps 3-5 by the audio
bank without its CTCSS epilogue (K8) and the FSM's three-phase scan
(scanner/fsm.fsm_ctcss_scan_v3 on the channel-major lp plane):

  - ``fuse_ctcss=False``: K8 ``apply_dc`` (FIR bank + lp DC blocker);
  - ``fuse_lp_dc=False``: K8 ``apply`` (FIR bank), then the lp DC blocker
    as plain ops (ops/iir.py, an XLA op in JAX too);
  - ``fuse_rssi=False``: K7 emits the |y| plane and the RSSI is its
    per-sub-chunk mean in dB (ops/rssi.subchunk_rssi), then K8 ``apply_dc``
    (or ``apply`` with ``fuse_lp_dc=False``).

``fuse_ctcss`` needs ``fuse_lp_dc`` and ``fuse_rssi``, and the duo needs
``fuse_ctcss``, so any switch off runs the trio's K6 -> K7 (or, with
``fuse_dc=False``, the plain DC blocker -> K9 -> K7).  The JAX
``fuse_group`` has no counterpart: every engine serves every K.  The state
layout is the trio's, so states pass between the engines and packages.

Every stage runs over all 16 channels; nothing reads the device from the
host, so a step is asynchronous end to end.  The JAX group path (the duo
and the group trio) needs K % 8 == 0 (chain.py:136-138), its row trio
serves the rest, and its in-kernel waterfall only some widths and K
(spectrogram.kernel_wf_supported); every engine of the port serves every K
and every width that spectrogram.validate_width accepts.

The op engine (JAX chain.py:442-475, 491-501) runs no kernel but K3: the
wire decoded to planes, then the shared plain front end
(scanner/op_front.py: DC blocker, resampler, PFB), the per-sub-chunk RSSI
and the discriminator on all 16 channels, the HP FIR and the 188-sample
delay line, the lp branch ``delayed - hp_out`` and its DC blocker, then
``audio * gain``, the de-emphasis FIR and, with ``lowpass``, the lowpass
FIR, every filter carrying its history in the state (the JAX op layout:
runtime/state.py); then ``fsm_ctcss_scan_v3`` on the channel-major lp
plane and the audio select.  It ignores the ``fuse_*`` switches, as JAX's
``fuse_* and use_pallas`` does, and serves every wire format and every K.

The waterfall's window history is the w/2 band samples before the block.
For w <= 800 it is read from the tail of the incoming ``pfb_hist`` (the
last 400 band samples), which every JAX engine carries exactly, while the
JAX in-kernel engine leaves ``wf_hist`` stale; wider windows read the
carried ``wf_hist``.  Every step writes ``wf_hist`` and ``wf_cnt``, so a
JAX XLA-path engine resumes from a port state exactly.  K3 runs on the
band planes of every engine, the op engine's included.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from sdr_pmr446_tpu_torch import config as C
from sdr_pmr446_tpu_torch.taps import design as D
from sdr_pmr446_tpu_torch import device as devices
from sdr_pmr446_tpu_torch import engine as engines
from sdr_pmr446_tpu_torch import precision
from sdr_pmr446_tpu_torch.kernels.audio_bank import AudioBank
from sdr_pmr446_tpu_torch.kernels.duo import DuoOut, ScannerDuo
from sdr_pmr446_tpu_torch.kernels.front_end import FrontEnd
from sdr_pmr446_tpu_torch.kernels.pfb_demod import PfbDemod
from sdr_pmr446_tpu_torch.kernels.resample_kernel import Resampler
from sdr_pmr446_tpu_torch.kernels.waterfall import Waterfall
from sdr_pmr446_tpu_torch.ops import decode, fir, fm, iir, spectrogram
from sdr_pmr446_tpu_torch.ops.rssi import rssi_from_sums, subchunk_rssi
from sdr_pmr446_tpu_torch.runtime import fuse
from sdr_pmr446_tpu_torch.runtime.state import ScannerState, init_scanner_state
from sdr_pmr446_tpu_torch.scanner.fsm import (CtcssTables, FsmCarry,
                                              fsm_ctcss_scan_v3, fsm_phase_a,
                                              fsm_phase_c, raw_sums_to_ctcss)
from sdr_pmr446_tpu_torch.scanner.op_front import OpFrontEnd

NCH = C.NUM_CHANNELS
#: the op engine's unused audio-bank history length (JAX chain.py:204)
OP_AUDIO_HIST = 4 * 128


class RuntimeParams(NamedTuple):
    """Runtime knobs, as tensors on the chain's device."""
    squelch_level: torch.Tensor   # f32 []
    audio_gain: torch.Tensor      # f32 []
    channel_mask: torch.Tensor    # bool [16]
    lock_max: torch.Tensor        # bool []


def make_runtime_params(args: C.ScannerArgs, device) -> RuntimeParams:
    mask = [bool((args.channel_mask >> i) & 1) for i in range(NCH)]
    return RuntimeParams(
        squelch_level=torch.tensor(args.squelch_level, dtype=torch.float32,
                                   device=device),
        audio_gain=torch.tensor(args.audio_gain, dtype=torch.float32,
                                device=device),
        channel_mask=torch.tensor(mask, dtype=torch.bool, device=device),
        lock_max=torch.tensor(args.lock_mode == "max", device=device),
    )


class StepOutputs(NamedTuple):
    audio: torch.Tensor          # f32 [K, ns] active channel audio
    audio_valid: torch.Tensor    # bool [K]
    active_chan: torch.Tensor    # i32 [K]
    rel_rssi: torch.Tensor       # f32 [K]
    rssi_db: torch.Tensor        # f32 [K, 16]
    ev_tuned: torch.Tensor       # bool [K]
    ev_detuned: torch.Tensor     # bool [K]
    ev_changed: torch.Tensor     # bool [K]
    ev_prev_chan: torch.Tensor   # i32 [K]
    ev_new_chan: torch.Tensor    # i32 [K]
    ct_detected: torch.Tensor    # bool [K]
    ct_max_idx: torch.Tensor     # i32 [K]
    ct_freq: torch.Tensor        # f32 [K]
    ev_ct_acquired: torch.Tensor  # bool [K]
    ev_ct_changed: torch.Tensor   # bool [K]
    ev_ct_lost: torch.Tensor      # bool [K]
    waterfall: torch.Tensor      # f32 [K, W] dB rows, W = 0 when off


class ScannerChain(nn.Module):
    """The scanner block step for one geometry, wire format, device and
    engine.

    The kernels run for CUDA devices (the default); on the CPU, which the
    caller asks for with ``device="cpu"``, every kernel wrapper takes its
    plain PyTorch version.  ``engine`` chooses the kernel engine (the
    default) or the op engine (module docstring).  On the kernel engine
    ``fuse_band`` and ``fuse_dc`` choose the engine of steps 1-2,
    ``fuse_rssi``, ``fuse_lp_dc`` and ``fuse_ctcss`` the op path of steps
    3-5, by the JAX names and defaults; the op engine ignores them."""

    def __init__(self, block: C.BlockConfig | None = None,
                 lowpass: bool = False, fir_deemph: bool = False,
                 input_format: str = "cu8", device="cuda",
                 waterfall: int = 0, fuse_band: bool = True,
                 fuse_dc: bool = True, fuse_rssi: bool = True,
                 fuse_lp_dc: bool = True, fuse_ctcss: bool = True,
                 engine: str = engines.KERNEL):
        super().__init__()
        precision.check()
        spectrogram.validate_width(waterfall)
        self.block = block or C.BlockConfig()
        self.input_format = decode.wire_format(input_format)
        self.device = devices.resolve(device)
        self.engine = engines.resolve(engine)
        self.op = self.engine == engines.OP
        self.lowpass = lowpass
        self.waterfall = max(waterfall, 0)
        kernel = not self.op
        self.fuse_dc = fuse_dc and kernel
        self.fuse_rssi = fuse_rssi and kernel
        self.fuse_lp_dc = fuse_lp_dc and kernel
        self.fuse_ctcss = fuse_ctcss and self.fuse_lp_dc and self.fuse_rssi
        self.fuse_band = fuse_band and self.fuse_dc and self.fuse_ctcss
        deemph = D.deemph_fir_taps() if fir_deemph else D.deemph_fir_equiv()
        self.deemph_hist_len = deemph.shape[0] - 1
        self.wf = (Waterfall(self.waterfall, device=self.device)
                   if self.waterfall else None)
        self.megastep = fuse.fused_steps(self.step)
        # the constant tables every step reads, built here: a step then
        # looks nothing up, and an exported step holds them as constants
        self.ctcss = CtcssTables(C.SUBCHUNK_AUDIO, self.device,
                                 k=self.block.subchunks_per_step)
        if self.op or not (fuse_dc and fuse_lp_dc):
            self.dc_tables = iir.dc_tables(self.device, C.DC_BLOCK_ALPHA)
        if self.op:
            self.front = OpFrontEnd(self.device)
            self.resamp_hist_len = self.front.resampler.hist_len
            self.pfb_hist_len = self.front.pfb.hist_len
            self.audio_hist_len = OP_AUDIO_HIST
            f32 = lambda taps: torch.as_tensor(  # noqa: E731
                np.asarray(taps, np.float32), device=self.device)
            self.register_buffer("hp_taps", f32(D.ctcss_hp_taps()))
            self.register_buffer("deemph_taps", f32(deemph))
            self.register_buffer("lp_taps", f32(D.audio_lp_taps()))
            return
        if self.fuse_band:
            self.duo = ScannerDuo(self.input_format, device=self.device)
            self.resamp_hist_len = self.duo.front_hist_len
        else:
            if fuse_dc:
                self.front = FrontEnd(self.input_format, device=self.device)
                self.resamp_hist_len = self.front.hist_len
            else:
                self.resampler = Resampler(device=self.device)
                self.resamp_hist_len = self.resampler.hist_len
            self.pfb = PfbDemod(device=self.device)
        self.pfb_hist_len = (self.duo.pfb if self.fuse_band
                             else self.pfb).hist_len
        self.audio_bank = AudioBank(lowpass, fir_deemph, device=self.device)
        self.audio_hist_len = self.audio_bank.hist

    def init_state(self) -> ScannerState:
        return init_scanner_state(self.resamp_hist_len, self.pfb_hist_len,
                                  self.deemph_hist_len, self.audio_hist_len,
                                  self.device, waterfall=self.waterfall)

    @property
    def step_arg_len(self) -> int:
        """Wire bytes per step."""
        return self.block.input_len * decode.BYTES_PER_SAMPLE[
            self.input_format]

    def _band_and_demod(self, state: ScannerState, wire: torch.Tensor,
                        ns: int) -> DuoOut:
        """Steps 1-2 on the chain's engine, as K1's outputs (the front
        history field holds the resampler's on the fuse_dc=False path, the
        |y| field K7's plane [16, F] when fuse_rssi=False)."""
        if self.fuse_band:
            return self.duo(wire, state.dc_x, state.dc_y, state.resamp_hist,
                            state.pfb_hist, state.frame_parity,
                            state.demod_prev, ns)
        if self.fuse_dc:
            dc_x, dc_y, hist, band = self.front(
                wire, state.dc_x, state.dc_y, state.resamp_hist)
        else:
            xr, xi = decode.decode_planes(wire, self.input_format)
            (ndx, ndy), y = iir.dc_blocker_apply(
                (torch.view_as_real(state.dc_x),
                 torch.view_as_real(state.dc_y)),
                torch.stack([xr, xi]), C.DC_BLOCK_ALPHA,
                tables=self.dc_tables)
            dc_x = torch.complex(ndx[0], ndx[1])
            dc_y = torch.complex(ndy[0], ndy[1])
            hist, band = self.resampler(state.resamp_hist, y[0], y[1])
        p = self.pfb(band, state.pfb_hist, state.frame_parity,
                     state.demod_prev, ns,
                     mag="sums" if self.fuse_rssi else "plane")
        return DuoOut(dc_x, dc_y, hist, p.demod, p.mag, p.pfb_hist, p.parity,
                      p.prev, band)

    def step(self, state: ScannerState, wire: torch.Tensor,
             params: RuntimeParams):
        """One block step; ``wire`` is uint8 [step_arg_len] on the device."""
        k = self.block.subchunks_per_step
        ns = C.SUBCHUNK_AUDIO
        if wire.shape != (self.step_arg_len,):
            raise ValueError(f"wire has shape {tuple(wire.shape)}, expected "
                             f"({self.step_arg_len},)")
        carry_in = FsmCarry(state.fsm_state, state.active_chan, state.rssi,
                            state.ct_count, state.ct_carry, state.ct_detected,
                            state.ct_max_idx, state.ct_freq)
        if self.op:
            return self._op_step(state, wire, params, carry_in)
        d = self._band_and_demod(state, wire, ns)
        rssi_db = (rssi_from_sums(d.mag_sums, ns) if self.fuse_rssi
                   else subchunk_rssi(d.mag_sums, k))

        if self.fuse_ctcss:
            sched = fsm_phase_a(carry_in, rssi_db, params.channel_mask,
                                params.squelch_level, params.lock_max, ns)
            sel_k = torch.clamp(sched.act2, 0, NCH - 1).to(torch.int32)
            a = self.audio_bank(state.audio_hist, state.lp_dc_x,
                                state.lp_dc_y, d.demod, params.audio_gain,
                                sched.b_arr, sel_k, ns)
            s_pre, s_suf = raw_sums_to_ctcss(sched, a.raw_pre, a.raw_mem, ns,
                                             tables=self.ctcss)
            carry_out, fo = fsm_phase_c(carry_in, sched, s_pre, s_suf,
                                        self.ctcss)
            audio_hist, lp_dc_x, lp_dc_y = a.hist, a.dc_x, a.dc_y
            audio = a.audio
        else:
            if self.fuse_lp_dc:
                audio_hist, lp_dc_x, lp_dc_y, audio, lp_dcb = \
                    self.audio_bank.apply_dc(
                        state.audio_hist, state.lp_dc_x, state.lp_dc_y,
                        d.demod, params.audio_gain)
            else:
                audio_hist, audio, lp = self.audio_bank.apply(
                    state.audio_hist, d.demod, params.audio_gain)
                (lp_dc_x, lp_dc_y), lp_dcb = iir.dc_blocker_apply(
                    (state.lp_dc_x, state.lp_dc_y), lp, C.DC_BLOCK_ALPHA,
                    tables=self.dc_tables)
            carry_out, fo = fsm_ctcss_scan_v3(
                carry_in, rssi_db, None, params.channel_mask,
                params.squelch_level, params.lock_max,
                lp_cm=lp_dcb.reshape(NCH, k, ns), tables=self.ctcss)

        return self._finish(
            state, d.band, audio, rssi_db, carry_out, fo,
            dc_x=d.dc_x, dc_y=d.dc_y, resamp_hist=d.front_hist,
            pfb_hist=d.pfb_hist, frame_parity=d.parity, demod_prev=d.prev,
            lp_dc_x=lp_dc_x, lp_dc_y=lp_dc_y, audio_hist=audio_hist)

    def _op_step(self, state: ScannerState, wire: torch.Tensor,
                 params: RuntimeParams, carry_in: FsmCarry):
        """The op engine's step (JAX chain.py:442-475, 491-501)."""
        k, ns = self.block.subchunks_per_step, C.SUBCHUNK_AUDIO
        xr, xi = decode.decode_planes(wire, self.input_format)
        fr = self.front(state.dc_x, state.dc_y, state.resamp_hist,
                        state.pfb_hist, state.frame_parity,
                        torch.stack([xr, xi]))
        rssi_db = subchunk_rssi(fr.chan, k)                 # [K, 16]
        demod_prev, demod = fm.fm_demod(state.demod_prev, fr.chan)
        # the audio path on all channels: HP, the complementary lp branch
        # delay - HP and its DC blocker, gain, de-emphasis (, lowpass)
        hp_hist, hp_out = fir.fir_apply(state.hp_hist, demod, self.hp_taps)
        delay_hist, delayed = fir.delay_apply(state.delay_hist, demod)
        (lp_dc_x, lp_dc_y), lp_dcb = iir.dc_blocker_apply(
            (state.lp_dc_x, state.lp_dc_y), delayed - hp_out,
            C.DC_BLOCK_ALPHA, tables=self.dc_tables)
        deemph_hist, audio = fir.fir_apply(
            state.deemph_hist, hp_out * params.audio_gain, self.deemph_taps)
        audio_lp_hist = state.audio_lp_hist
        if self.lowpass:
            audio_lp_hist, audio = fir.fir_apply(state.audio_lp_hist, audio,
                                                 self.lp_taps)
        carry_out, fo = fsm_ctcss_scan_v3(
            carry_in, rssi_db, None, params.channel_mask,
            params.squelch_level, params.lock_max,
            lp_cm=lp_dcb.reshape(NCH, k, ns), tables=self.ctcss)
        return self._finish(
            state, fr.band, audio, rssi_db, carry_out, fo, dc_x=fr.dc_x,
            dc_y=fr.dc_y, resamp_hist=fr.resamp_hist, pfb_hist=fr.pfb_hist,
            frame_parity=fr.parity, demod_prev=demod_prev, hp_hist=hp_hist,
            delay_hist=delay_hist, lp_dc_x=lp_dc_x, lp_dc_y=lp_dc_y,
            deemph_hist=deemph_hist, audio_lp_hist=audio_lp_hist)

    def _finish(self, state: ScannerState, band: torch.Tensor,
                audio: torch.Tensor, rssi_db: torch.Tensor,
                carry_out: FsmCarry, fo, **fields):
        """Steps 6-7 of every engine: the active channel's audio of each
        sub-chunk from ``audio`` [16, K * ns], the waterfall rows from the
        band planes ``band`` [2, nb]; returns (the state with ``fields``
        and the FSM's carry, StepOutputs)."""
        k, ns = self.block.subchunks_per_step, C.SUBCHUNK_AUDIO
        sel = torch.clamp(fo.active_chan, 0, NCH - 1).long()
        audio_sel = audio.reshape(NCH, k, ns)[
            sel, torch.arange(k, device=sel.device)]

        # 7. waterfall rows from the engine's band planes
        wf_hist, wf_cnt = state.wf_hist, state.wf_cnt
        if self.wf is not None:
            hist = (state.pfb_hist if self.wf.wl <= state.pfb_hist.shape[0]
                    else state.wf_hist)
            wf_hist, wf_cnt, wf = self.wf(band, hist, state.wf_cnt)
        else:
            wf = torch.zeros((k, 0), dtype=torch.float32,
                             device=rssi_db.device)
        new_state = state._replace(
            **fields, fsm_state=carry_out.fsm_state,
            active_chan=carry_out.active_chan, rssi=carry_out.rssi,
            ct_count=carry_out.ct_count, ct_carry=carry_out.ct_carry,
            ct_detected=carry_out.ct_detected,
            ct_max_idx=carry_out.ct_max_idx, ct_freq=carry_out.ct_freq,
            wf_hist=wf_hist, wf_cnt=wf_cnt)
        outputs = StepOutputs(
            audio=audio_sel, audio_valid=fo.active_chan >= 0,
            active_chan=fo.active_chan, rel_rssi=fo.rel_rssi,
            rssi_db=rssi_db, ev_tuned=fo.ev_tuned, ev_detuned=fo.ev_detuned,
            ev_changed=fo.ev_changed, ev_prev_chan=fo.ev_prev_chan,
            ev_new_chan=fo.ev_new_chan, ct_detected=fo.ct_detected,
            ct_max_idx=fo.ct_max_idx, ct_freq=fo.ct_freq,
            ev_ct_acquired=fo.ev_ct_acquired,
            ev_ct_changed=fo.ev_ct_changed, ev_ct_lost=fo.ev_ct_lost,
            waterfall=wf)
        return new_state, outputs

    def multi_step(self, state: ScannerState, wires: torch.Tensor,
                   params: RuntimeParams):
        """S blocks in one dispatch (runtime/fuse.py): ``wires`` uint8 [S,
        step_arg_len] on the device.  Returns (state', StepOutputs) with
        every output leaf [S*K, ...], in order equal to S step() calls
        (bit for bit: a CUDA graph of those steps, on the CPU the loop)."""
        return self.megastep(state, wires, params)


def outputs_to_numpy(out: StepOutputs) -> dict:
    """Every output field as a numpy array, copied to the host (this waits
    for the step that produced them)."""
    return {f: np.asarray(v.detach().cpu()) for f, v in zip(out._fields, out)}
