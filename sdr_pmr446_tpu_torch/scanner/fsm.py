"""Squelch FSM + CTCSS detector over sub-chunk summaries (PyTorch).

Counterpart of sdr_pmr446_tpu/scanner/fsm.py, phases A and C of its v3
formulation, which the kernel engine runs around the audio-bank kernel:

  A. ``fsm_phase_a``: the squelch FSM and the detector's in-window count
     schedule — a pure function of the per-sub-chunk RSSI, so the tone
     sums inside the audio-bank kernel can be driven by it;
  (B. the windowed-DFT tone sums: inside K2, kernels/audio_bank.py;)
  C. ``fsm_phase_c``: the Goertzel-carry chain and the detection state.

The JAX package runs A and C as associative scans.  Here both are a loop
over the K sub-chunks (K <= 160) of small tensor ops on the step's device,
with no host reads, so the step stays asynchronous.  The recurrences are
keep-or-set maps and affine maps with coefficients in {0, 1}, whose chains
of non-zero terms are at most two long (the 2441-sample window spans at
most two 1225-sample sub-chunks), so the sequential form computes the same
values as the associative one and the decisions are equal.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from sdr_pmr446_tpu_torch import config as C


class FsmCarry(NamedTuple):
    fsm_state: torch.Tensor     # i32 []
    active_chan: torch.Tensor   # i32 []
    rssi: torch.Tensor          # f32 []
    ct_count: torch.Tensor      # i32 []
    ct_carry: torch.Tensor      # c64 [38]
    ct_detected: torch.Tensor   # bool []
    ct_max_idx: torch.Tensor    # i32 []
    ct_freq: torch.Tensor       # f32 []


class FsmOutputs(NamedTuple):
    """Per-sub-chunk outputs (leading axis K)."""
    active_chan: torch.Tensor   # i32 [K]
    rel_rssi: torch.Tensor      # f32 [K]
    ev_tuned: torch.Tensor      # bool [K]
    ev_detuned: torch.Tensor    # bool [K]
    ev_changed: torch.Tensor    # bool [K]
    ev_prev_chan: torch.Tensor  # i32 [K]
    ev_new_chan: torch.Tensor   # i32 [K]
    ct_detected: torch.Tensor   # bool [K]
    ct_max_idx: torch.Tensor    # i32 [K]
    ct_freq: torch.Tensor       # f32 [K]
    ev_ct_acquired: torch.Tensor  # bool [K]
    ev_ct_changed: torch.Tensor   # bool [K]
    ev_ct_lost: torch.Tensor      # bool [K]


class FsmSchedule(NamedTuple):
    """Phase-A outputs: the FSM/detector schedule, a function of RSSI only."""
    act2: torch.Tensor       # i32 [K] post-step active channel (-1 = none)
    rel: torch.Tensor        # f32 [K]
    tune: torch.Tensor       # bool [K]
    detune: torch.Tensor     # bool [K]
    do_change: torch.Tensor  # bool [K]
    act_prev: torch.Tensor   # i32 [K]
    act1: torch.Tensor       # i32 [K]
    is_active: torch.Tensor  # bool [K]
    cnt_r: torch.Tensor      # i32 [K] in-window count after detune reset
    b_arr: torch.Tensor      # i32 [K] boundary sample index (n_win-1 - cnt_r)
    has_b: torch.Tensor      # bool [K] window completes inside the sub-chunk
    upd: torch.Tensor        # bool [K] detection state updates
    st_arr: torch.Tensor     # i32 [K] post-step FSM state
    cnt_arr: torch.Tensor    # i32 [K] post-step in-window count


def _tone_omegas() -> np.ndarray:
    return 2.0 * np.pi * np.asarray(C.CTCSS_FREQS) / C.AUDIO_SAMPLERATE


@functools.lru_cache(maxsize=None)
def _count_phasor_table() -> np.ndarray:
    """U[t, c] = exp(-j w_t c), c < CTCSS_BLOCK_SIZE, complex64 (host f64)."""
    c = np.arange(C.CTCSS_BLOCK_SIZE)
    return np.exp(-1j * np.outer(_tone_omegas(), c)).astype(np.complex64)


@functools.lru_cache(maxsize=None)
def _window_corr_table(k: int, ns: int) -> np.ndarray:
    """corr[k, t] = e^{+j w_t ns k}: undoes the kernel sums' global phase."""
    idx = np.arange(k)
    return np.exp(1j * np.outer(idx * float(ns), _tone_omegas())
                  ).astype(np.complex64)


@functools.lru_cache(maxsize=None)
def _wrap_table() -> np.ndarray:
    """e^{+j w_t N} for the 2441-sample window N, complex64 (host f64)."""
    return np.exp(1j * _tone_omegas() * C.CTCSS_BLOCK_SIZE
                  ).astype(np.complex64)


@functools.lru_cache(maxsize=None)
def _device_table(name: str, device: str, *key) -> torch.Tensor:
    """The named constant table as a tensor on ``device`` (built once)."""
    tables = {
        "u_t": lambda: np.ascontiguousarray(_count_phasor_table().T),
        "corr": lambda: _window_corr_table(*key),
        "wrap": _wrap_table,
        "freqs": lambda: np.asarray(C.CTCSS_FREQS, np.float32),
    }
    return torch.as_tensor(tables[name](), device=device)


def fsm_phase_a(carry_in: FsmCarry, rssi_k: torch.Tensor, mask: torch.Tensor,
                squelch: torch.Tensor, lock_max: torch.Tensor,
                ns: int) -> FsmSchedule:
    """Squelch FSM transitions + detector count schedule over K sub-chunks."""
    k_sub = rssi_k.shape[0]
    n_win = C.CTCSS_BLOCK_SIZE
    nch_en = torch.clamp(mask.to(torch.int32).sum(), min=1)

    # batched RSSI reductions (no recurrence)
    neg_inf = torch.full_like(rssi_k, -float("inf"))
    rm = torch.where(mask[None, :], rssi_k, neg_inf)
    max_ch = torch.argmax(rm, dim=-1).to(torch.int32)
    avg = (torch.where(mask[None, :], rssi_k, torch.zeros_like(rssi_k))
           .sum(-1) / nch_en.to(torch.float32))
    rel = torch.gather(rm, 1, max_ch[:, None].long())[:, 0] - avg
    tune_b = rel > squelch
    detune_b = rel < squelch - C.SQUELCH_HYSTERESIS_DB

    st = carry_in.fsm_state
    act = carry_in.active_chan
    cnt = carry_in.ct_count
    rows = []
    for k in range(k_sub):
        scanning = st == 0
        tune = scanning & tune_b[k]
        in_tuned = ~scanning
        do_change = in_tuned & lock_max & (act != max_ch[k])
        act1 = torch.where(tune | do_change, max_ch[k], act)
        detune = in_tuned & detune_b[k]
        act2 = torch.where(detune, -1, act1)
        act_prev = act
        st = torch.where(tune, 1, torch.where(detune, 0, st))
        cnt_r = torch.where(detune, 0, cnt)
        cnt = torch.where(act2 >= 0, (cnt_r + ns) % n_win, cnt_r)
        act = act2
        rows.append((act2, tune, detune, do_change, act_prev, act1, cnt_r,
                     st, cnt))
    cols = [torch.stack(c) for c in zip(*rows)]
    act2, tune, detune, do_change, act_prev, act1, cnt_r, st_arr, cnt_arr = \
        cols
    is_active = act2 >= 0
    b_arr = ((n_win - 1) - cnt_r).to(torch.int32)
    has_b = is_active & (b_arr < ns)
    return FsmSchedule(act2, rel, tune, detune, do_change, act_prev, act1,
                       is_active, cnt_r, b_arr, has_b, is_active & has_b,
                       st_arr, cnt_arr)


def raw_sums_to_ctcss(sched: FsmSchedule, raw_pre: torch.Tensor,
                      raw_mem: torch.Tensor, ns: int):
    """(s_pre, s_suf) [K, 38] c64 from the audio-bank kernel's global-phase
    sums: applies the sub-chunk window phase (corr), the carried in-window
    phase (u) and the window wrap factor."""
    k = raw_pre.shape[0]
    dev = str(raw_pre.device)
    corr = _device_table("corr", dev, k, ns)
    u_t = _device_table("u_t", dev)
    wrap = _device_table("wrap", dev)
    cu = corr * u_t[sched.cnt_r.long()]
    s_pre = raw_pre * cu
    s_suf = (raw_mem - raw_pre) * (cu * wrap[None, :])
    return s_pre, s_suf


def fsm_phase_c(carry_in: FsmCarry, sched: FsmSchedule, s_pre: torch.Tensor,
                s_suf: torch.Tensor):
    """Goertzel-carry chain + detection state from the tone sums ([K, 38]
    c64).  Returns (carry_out, FsmOutputs)."""
    k_sub = sched.act2.shape[0]
    freqs = _device_table("freqs", str(s_pre.device))
    cc = carry_in.ct_carry
    det = carry_in.ct_detected
    tidx = carry_in.ct_max_idx
    tfreq = carry_in.ct_freq
    zero_c = torch.zeros_like(cc)
    rows = []
    for k in range(k_sub):
        dt = sched.detune[k]
        act_k = sched.is_active[k]
        upd = sched.upd[k]
        cc_in = torch.where(dt, zero_c, cc)
        det_r = det & ~dt
        tidx_r = torch.where(dt, 0, tidx)
        tfreq_r = torch.where(dt, 0.0, tfreq)
        y = cc_in + s_pre[k]
        power = y.real * y.real + y.imag * y.imag
        avgp = power.mean()
        pidx = torch.argmax(power).to(torch.int32)
        maxp = power.amax()
        newdet = ((avgp > C.CTCSS_AVG_POWER_THRESH)
                  & (maxp / torch.clamp(avgp, min=1e-30)
                     > C.CTCSS_MAX_AVG_RATIO_THRESH))
        det = torch.where(upd, newdet, det_r)
        tidx = torch.where(upd, pidx, tidx_r)
        cc = torch.where(act_k, torch.where(sched.has_b[k], s_suf[k], y),
                         cc_in)
        # index_select, not freqs[tidx]: a 0-d index tensor is read on the host
        tfreq = torch.where(act_k, freqs.index_select(0, tidx.long()[None])[0],
                            tfreq_r)
        acq = act_k & det & ~det_r
        chg = act_k & det & det_r & (tidx != tidx_r)
        lost = act_k & ~det & det_r
        rows.append((det, tidx, tfreq, acq, chg, lost))
    det_o, tidx_o, tfreq_o, acq_o, chg_o, lost_o = [torch.stack(c)
                                                    for c in zip(*rows)]
    carry_out = FsmCarry(
        sched.st_arr[-1].to(torch.int32), sched.act2[-1], sched.rel[-1],
        sched.cnt_arr[-1], cc, det, tidx, tfreq)
    outs = FsmOutputs(sched.act2, sched.rel, sched.tune, sched.detune,
                      sched.do_change, sched.act_prev, sched.act1, det_o,
                      tidx_o, tfreq_o, acq_o, chg_o, lost_o)
    return carry_out, outs
