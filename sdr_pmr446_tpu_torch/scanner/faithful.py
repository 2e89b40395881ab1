"""Faithful-mode scanner: the reference's exact audio-path semantics.

Counterpart of sdr_pmr446_tpu/scanner/faithful.py (FaithfulState,
FaithfulOutputs, FaithfulScannerChain, faithful_scan).  The fast chain
(scanner/chain.py) runs the discriminator and audio filters on all 16
channels and selects afterwards, which differs from the reference during
tune / detune / change transients.  Faithful mode is the validation mode
with none of that difference: one loop over the K sub-chunks of a block
that mirrors the reference's main loop (src/sdr_pmr446.c:827-908):

  - the squelch FSM decides first;
  - the discriminator's state is one carried sample, reset on detune
    (:866) and carried across lock_mode max channel switches;
  - ONE set of audio filters (HP, delay, DC blocker, de-emphasis, LP)
    processes only the active channel's sub-chunk and keeps its state
    while scanning, stale-history transients after a switch included;
  - the CTCSS detector reads the gated, DC-blocked LP branch.

The front end (DC blocker, resampler, PFB) is continuous, as in the
reference, and runs as plain ops (scanner/op_front.py, shared with the op
engine of scanner/chain.py);
the detector shares scanner/fsm.py's ``ctcss_tables``,
``ctcss_subchunk_sums`` and ``ctcss_detect``.  The JAX package runs no
TPU kernel here either, so faithful mode has no CUDA kernel: on a card the
same ops run on the device.  JAX's ``lax.scan`` over the sub-chunks is a
Python loop over K whose carry stays on the step's device: a step reads
nothing back to the host.  Input: complex64 IQ [K * SUBCHUNK_IN].
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from sdr_pmr446_tpu_torch import config as C
from sdr_pmr446_tpu_torch import device as devices
from sdr_pmr446_tpu_torch import precision
from sdr_pmr446_tpu_torch.ops import fir, fm, iir
from sdr_pmr446_tpu_torch.ops.rssi import subchunk_rssi
from sdr_pmr446_tpu_torch.runtime import fuse
from sdr_pmr446_tpu_torch.scanner.chain import RuntimeParams
from sdr_pmr446_tpu_torch.scanner.fsm import (_pick, ctcss_detect,
                                              ctcss_subchunk_sums,
                                              ctcss_tables)
from sdr_pmr446_tpu_torch.scanner.op_front import OpFrontEnd
from sdr_pmr446_tpu_torch.taps import design as D

#: chunk length of the gated DC blocker's and de-emphasis scans (JAX
#: faithful.py:234, 239)
SCAN_CHUNK = 256


class FaithfulState(NamedTuple):
    # front end (shared with the fast chain)
    dc_x: torch.Tensor          # c64 []
    dc_y: torch.Tensor          # c64 []
    resamp_hist: torch.Tensor   # c64 [345]
    pfb_hist: torch.Tensor      # c64 [400]
    frame_parity: torch.Tensor  # i32 []
    # gated single-stream audio path (the reference's shared filters)
    fm_prev: torch.Tensor       # c64 []  discriminator state (reset on detune)
    hp_hist: torch.Tensor       # f32 [376]
    delay_hist: torch.Tensor    # f32 [188]
    dc2_x: torch.Tensor         # f32 []  CTCSS-branch DC blocker
    dc2_y: torch.Tensor         # f32 []
    deemph_x: torch.Tensor      # f32 []  de-emphasis IIR x[-1], y[-1]
    deemph_y: torch.Tensor      # f32 []
    lp_hist: torch.Tensor       # f32 [102]
    # control + detector
    fsm_state: torch.Tensor     # i32 []
    active_chan: torch.Tensor   # i32 []
    rssi: torch.Tensor          # f32 []
    ct_count: torch.Tensor      # i32 []
    ct_carry: torch.Tensor      # c64 [38]
    ct_detected: torch.Tensor   # bool []
    ct_max_idx: torch.Tensor    # i32 []
    ct_freq: torch.Tensor       # f32 []


class FaithfulOutputs(NamedTuple):
    audio: torch.Tensor          # f32 [K, ns]
    audio_valid: torch.Tensor    # bool [K]
    active_chan: torch.Tensor    # i32 [K]
    rel_rssi: torch.Tensor       # f32 [K]
    ct_detected: torch.Tensor    # bool [K]
    ct_max_idx: torch.Tensor     # i32 [K]


class FaithfulScannerChain(nn.Module):
    """(state, iq c64 [K * SUBCHUNK_IN], params) -> (state, FaithfulOutputs),
    the exact semantics; ``device`` defaults to the card, as every entry
    point of the port."""

    def __init__(self, subchunks_per_step: int = 5, lowpass: bool = False,
                 device="cuda"):
        super().__init__()
        precision.check()
        self.K = subchunks_per_step
        self.lowpass = lowpass
        self.device = devices.resolve(device)
        self.front = OpFrontEnd(self.device)
        flip = lambda taps: torch.as_tensor(
            np.asarray(taps, np.float32)[::-1].copy(), device=self.device)
        self.register_buffer("hp_flip", flip(D.ctcss_hp_taps()))
        self.register_buffer("lp_flip", flip(D.audio_lp_taps()))
        b, a = D.deemph_iir_coeffs()
        self.de_coeffs = (float(b[0]), float(b[1]), float(a[1]))
        self.megastep = fuse.fused_steps(self.step)

    @property
    def input_len(self) -> int:
        return self.K * C.SUBCHUNK_IN

    def init_state(self) -> FaithfulState:
        dev = self.device
        c64 = dict(dtype=torch.complex64, device=dev)
        f32 = dict(dtype=torch.float32, device=dev)
        i32 = dict(dtype=torch.int32, device=dev)
        return FaithfulState(
            dc_x=torch.zeros((), **c64), dc_y=torch.zeros((), **c64),
            resamp_hist=torch.zeros(self.front.resampler.hist_len, **c64),
            pfb_hist=torch.zeros(self.front.pfb.hist_len, **c64),
            frame_parity=torch.zeros((), **i32),
            fm_prev=torch.zeros((), **c64),
            hp_hist=fir.fir_init(C.HP_AUDIO_FILT_TAPS, device=dev),
            delay_hist=fir.delay_init(C.CTCSS_DELAY, device=dev),
            dc2_x=torch.zeros((), **f32), dc2_y=torch.zeros((), **f32),
            deemph_x=torch.zeros((), **f32), deemph_y=torch.zeros((), **f32),
            lp_hist=fir.fir_init(C.LP_AUDIO_FILT_TAPS, device=dev),
            fsm_state=torch.zeros((), **i32),
            active_chan=torch.full((), -1, **i32),
            rssi=torch.zeros((), **f32),
            ct_count=torch.zeros((), **i32),
            ct_carry=torch.zeros(C.CTCSS_NUM_FREQS, **c64),
            ct_detected=torch.zeros((), dtype=torch.bool, device=dev),
            ct_max_idx=torch.zeros((), **i32),
            ct_freq=torch.full((), -1.0, **f32),
        )

    def step(self, state: FaithfulState, iq: torch.Tensor,
             params: RuntimeParams):
        """One block; ``iq`` is complex64 [input_len] on the device."""
        k, ns = self.K, C.SUBCHUNK_AUDIO
        if iq.shape != (self.input_len,) or iq.dtype != torch.complex64:
            raise ValueError(f"iq must be complex64 ({self.input_len},), got "
                             f"{iq.dtype} {tuple(iq.shape)}")
        # the shared front end, continuous as in the reference
        fr = self.front(state.dc_x, state.dc_y, state.resamp_hist,
                        state.pfb_hist, state.frame_parity,
                        torch.stack([iq.real, iq.imag]))
        chan_blocks = fr.chan.reshape(C.NUM_CHANNELS, k, ns).transpose(0, 1)
        rssi_k = subchunk_rssi(fr.chan, k)                  # [K, 16]

        carry, outs = faithful_scan(state, rssi_k, chan_blocks, params,
                                    self.hp_flip, self.lp_flip,
                                    self.de_coeffs, self.lowpass)
        new_state = FaithfulState(
            dc_x=fr.dc_x, dc_y=fr.dc_y, resamp_hist=fr.resamp_hist,
            pfb_hist=fr.pfb_hist, frame_parity=fr.parity,
            rssi=outs.rel_rssi[-1], **carry)
        return new_state, outs

    def multi_step(self, state: FaithfulState, iqs: torch.Tensor,
                   params: RuntimeParams):
        """S blocks in one dispatch (runtime/fuse.py): ``iqs`` complex64
        [S, input_len]; outputs [S*K, ...], equal to S step() calls bit
        for bit (a CUDA graph of the steps' many small ops, on the CPU the
        loop)."""
        return self.megastep(state, iqs, params)


def faithful_scan(state: FaithfulState, rssi_k: torch.Tensor,
                  chan_blocks: torch.Tensor, params: RuntimeParams,
                  hp_flip: torch.Tensor, lp_flip: torch.Tensor,
                  de_coeffs, lowpass: bool):
    """The gated audio path + FSM + CTCSS detector over [K, 16, ns]
    sub-chunk matrices (JAX faithful.py:171-283), one sub-chunk at a time.
    ``hp_flip`` / ``lp_flip`` are the FIR taps reversed (correlation
    kernels).  Returns (the carried fields of FaithfulState but the front
    end's and ``rssi``, as a dict; FaithfulOutputs)."""
    k_sub, nch, ns = chan_blocks.shape
    n_win = C.CTCSS_BLOCK_SIZE
    de_b0, de_b1, de_a1 = de_coeffs
    mask = params.channel_mask
    nch_en = torch.clamp(mask.to(torch.int32).sum(), min=1)
    tables = ctcss_tables(ns, chan_blocks.device)
    freqs = tables[3]
    zero_c = torch.zeros_like(state.ct_carry)

    fm_prev, hp_h, dl_h = state.fm_prev, state.hp_hist, state.delay_hist
    d2x, d2y, dex, dey = (state.dc2_x, state.dc2_y, state.deemph_x,
                          state.deemph_y)
    lp_h, st, act = state.lp_hist, state.fsm_state, state.active_chan
    cnt, cc, det, tidx, tfreq = (state.ct_count, state.ct_carry,
                                 state.ct_detected, state.ct_max_idx,
                                 state.ct_freq)
    rows = []
    for k in range(k_sub):
        rssi_c, chan_c = rssi_k[k], chan_blocks[k]       # [16], [16, ns]

        # --- FSM (src/sdr_pmr446.c:827-874) ---
        rm = torch.where(mask, rssi_c, torch.full_like(rssi_c, -math.inf))
        max_ch = torch.argmax(rm).to(torch.int32)
        avg = (torch.where(mask, rssi_c, torch.zeros_like(rssi_c)).sum()
               / nch_en.to(torch.float32))
        rel = _pick(rm, max_ch) - avg
        scanning = st == 0
        tune = scanning & (rel > params.squelch_level)
        in_tuned = ~scanning
        do_change = in_tuned & params.lock_max & (act != max_ch)
        act1 = torch.where(tune | do_change, max_ch, act)
        detune = in_tuned & (rel < params.squelch_level
                             - C.SQUELCH_HYSTERESIS_DB)
        act2 = torch.where(detune, -1, act1).to(torch.int32)
        st = torch.where(tune, 1, torch.where(detune, 0, st)).to(torch.int32)
        # detune resets the discriminator and the detector (:866-867)
        fm_prev = torch.where(detune, torch.zeros_like(fm_prev), fm_prev)
        cnt = torch.where(detune, 0, cnt).to(torch.int32)
        cc = torch.where(detune, zero_c, cc)
        det_r = det & ~detune
        tidx_r = torch.where(detune, 0, tidx).to(torch.int32)
        tfreq = torch.where(detune, 0.0, tfreq)
        is_active = act2 >= 0

        # --- the gated audio path (:876-908) ---
        xc = _pick(chan_c, torch.clamp(act2, 0, nch - 1))   # [ns] c64
        last, tmp1 = fm.fm_demod(fm_prev, xc)
        hp_in = torch.cat([hp_h, tmp1])
        tmp2 = fir._correlate_valid(hp_in, hp_flip)
        dl_in = torch.cat([dl_h, tmp1])
        lp_branch = dl_in[:ns] - tmp2
        # the CTCSS branch's DC blocker (gated, shared: :606)
        (n_d2x, n_d2y), lp_dcb = iir.dc_blocker_apply(
            (d2x, d2y), lp_branch, C.DC_BLOCK_ALPHA, chunk=SCAN_CHUNK)
        audio = tmp2 * params.audio_gain
        # the de-emphasis one-pole (gated, shared: :898)
        x1 = torch.cat([dex[None], audio[:-1]])
        z = de_b0 * audio + de_b1 * x1
        audio_de = iir.first_order_scan(z, -de_a1, dey, chunk=SCAN_CHUNK)
        if lowpass:
            lp_in = torch.cat([lp_h, audio_de])
            audio_out = fir._correlate_valid(lp_in, lp_flip)
            lp_h = torch.where(is_active, lp_in[ns:], lp_h)
        else:
            audio_out = audio_de

        # --- the CTCSS detector on the gated stream (:610) ---
        s_pre, s_suf, has_b = ctcss_subchunk_sums(lp_dcb, cnt, tables)
        y = cc + s_pre
        newdet, pidx = ctcss_detect(y.real * y.real + y.imag * y.imag)
        upd = is_active & has_b
        det = torch.where(upd, newdet, det_r)
        tidx = torch.where(upd, pidx, tidx_r)
        cc = torch.where(is_active, torch.where(has_b, s_suf, y), cc)
        cnt = torch.where(is_active, (cnt + ns) % n_win, cnt).to(torch.int32)
        tfreq = torch.where(is_active, _pick(freqs, tidx), tfreq)

        # the audio state freezes unless active (the filters never ran)
        fm_prev = torch.where(is_active, last, fm_prev)
        hp_h = torch.where(is_active, hp_in[ns:], hp_h)
        dl_h = torch.where(is_active, dl_in[ns:], dl_h)
        d2x = torch.where(is_active, n_d2x, d2x)
        d2y = torch.where(is_active, n_d2y, d2y)
        dex = torch.where(is_active, audio[-1], dex)
        dey = torch.where(is_active, audio_de[-1], dey)
        act = act2
        rows.append((torch.where(is_active, audio_out,
                                 torch.zeros_like(audio_out)),
                     is_active, act2, rel, det, tidx))
    carry = dict(fm_prev=fm_prev, hp_hist=hp_h, delay_hist=dl_h, dc2_x=d2x,
                 dc2_y=d2y, deemph_x=dex, deemph_y=dey, lp_hist=lp_h,
                 fsm_state=st, active_chan=act, ct_count=cnt, ct_carry=cc,
                 ct_detected=det, ct_max_idx=tidx, ct_freq=tfreq)
    return carry, FaithfulOutputs(*(torch.stack(c) for c in zip(*rows)))
