"""Squelch FSM + CTCSS detector over sub-chunk summaries (PyTorch).

Counterpart of sdr_pmr446_tpu/scanner/fsm.py:

  - ``fsm_ctcss_scan`` (v1): the per-sub-chunk scan, each step a handful
    of [16] RSSI ops and the [38, ns] windowed-DFT tone sums of the active
    channel (``ctcss_tables``, ``ctcss_subchunk_sums``, ``ctcss_detect``);
    the test oracle of the other two;
  - ``fsm_ctcss_scan_v2`` / ``fsm_ctcss_scan_v3``: the same decisions in
    three phases, which the scanner's op-path switches run
    (scanner/chain.py):
      A. ``fsm_phase_a``: the squelch FSM and the detector's in-window
         count schedule — a pure function of the per-sub-chunk RSSI;
      B. ``fsm_tone_sums``: the tone sums of every sub-chunk's selected
         channel as two complex [K, ns] x [ns, 38] products (on the default
         engine they come from K2 instead, kernels/audio_bank.py, through
         ``raw_sums_to_ctcss``);
      C. ``fsm_phase_c``: the Goertzel-carry chain and the detection state.

The JAX package runs v2's A and C as sequential scans and v3's as
associative scans.  Here A and C are a loop over the K sub-chunks (K <=
160) of small tensor ops on the step's device, with no host reads, so the
step stays asynchronous.  The recurrences are keep-or-set maps and affine
maps with coefficients in {0, 1}, whose chains of non-zero terms are at
most two long (the 2441-sample window spans at most two 1225-sample
sub-chunks), so the sequential form computes the same values as the
associative one and the decisions are equal; v2 and v3 are therefore one
function here.  The phasor tables are built once on the host in float64;
their device copies (``CtcssTables``) are built with the chain that runs
the detector, or shared per device for the callers that hold none.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

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
def _phasor_table(ns: int) -> np.ndarray:
    """E0[t, i] = exp(-j w_t i), i < ns, complex64 (host f64)."""
    return np.exp(-1j * np.outer(_tone_omegas(), np.arange(ns))
                  ).astype(np.complex64)


@functools.lru_cache(maxsize=None)
def _count_phasor_table() -> np.ndarray:
    """U[t, c] = exp(-j w_t c), c < CTCSS_BLOCK_SIZE, complex64 (host f64)."""
    c = np.arange(C.CTCSS_BLOCK_SIZE)
    return np.exp(-1j * np.outer(_tone_omegas(), c)).astype(np.complex64)


@functools.lru_cache(maxsize=None)
def _window_corr_table(k: int, ns: int, period: int | None = None
                       ) -> np.ndarray:
    """corr[k, t] = e^{+j w_t ns (k mod period)}: undoes the kernel sums'
    global phase.  ``period`` covers time-sharded kernel sums, whose sample
    index restarts at 0 every K_local sub-chunks (parallel/)."""
    idx = np.arange(k) if period is None else np.arange(k) % period
    return np.exp(1j * np.outer(idx * float(ns), _tone_omegas())
                  ).astype(np.complex64)


@functools.lru_cache(maxsize=None)
def _wrap_table() -> np.ndarray:
    """e^{+j w_t N} for the 2441-sample window N, complex64 (host f64)."""
    return np.exp(1j * _tone_omegas() * C.CTCSS_BLOCK_SIZE
                  ).astype(np.complex64)


class CtcssTables(nn.Module):
    """The detector's constant tables on one device, built with the chain
    that runs the detector (so a step reaches only tables that exist, and
    an exported step holds them as constants): e0 c64 [38, ns], u_t c64
    [2441, 38] (the count phasors, ``u`` transposed), wrap c64 [38], freqs
    f32 [38], idx i32 [ns], and with ``k`` the window-phase correction
    corr c64 [k, 38] of ``raw_sums_to_ctcss`` (``period``: K_local of a
    time-sharded step)."""

    def __init__(self, ns: int, device, k: int | None = None,
                 period: int | None = None):
        super().__init__()
        self.ns, self.k, self.period = ns, k, period
        as_dev = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
        self.register_buffer("e0", as_dev(_phasor_table(ns)))
        self.register_buffer("u_t", as_dev(np.ascontiguousarray(
            _count_phasor_table().T)))
        self.register_buffer("wrap", as_dev(_wrap_table()))
        self.register_buffer("freqs", as_dev(np.asarray(C.CTCSS_FREQS,
                                                        np.float32)))
        self.register_buffer("idx", as_dev(np.arange(ns, dtype=np.int32)))
        self.register_buffer("corr", None if k is None else as_dev(
            _window_corr_table(k, ns, period)))

    def check(self, ns: int, k: int | None = None,
              period: int | None = None) -> None:
        """Raise unless these are the tables of (ns[, k, period])."""
        want = (ns,) if k is None else (ns, k, period)
        have = ((self.ns,) if k is None else (self.ns, self.k, self.period))
        if have != want:
            raise ValueError(f"CTCSS tables of (ns, k, period) {have}, the "
                             f"step needs {want}")


@functools.lru_cache(maxsize=None)
def _cached_tables(ns: int, device: str, k, period) -> CtcssTables:
    return CtcssTables(ns, device, k, period)


def shared_tables(ns: int, device, k: int | None = None,
                  period: int | None = None) -> CtcssTables:
    """The per-device CtcssTables of the eager callers that hold none of
    their own (the time-sharded chains, faithful mode, the tests), built
    at first use; raises under ``torch.export``, where a table built
    during the trace would be a fake tensor left in the cache."""
    if torch.compiler.is_exporting():
        raise RuntimeError("an exported step reaches the CTCSS detector "
                           "without its CtcssTables: build them with the "
                           "chain")
    return _cached_tables(ns, str(torch.device(device)), k, period)


def ctcss_tables(ns: int, device="cpu"):
    """(e0 c64 [38, ns], u_table c64 [38, 2441], wrap c64 [38], freqs f32
    [38], idx_i i32 [ns]) on ``device``: the static tables of the
    windowed-DFT CTCSS update, as JAX fsm.ctcss_tables(ns)."""
    t = shared_tables(ns, device)
    return t.e0, t.u_t.T, t.wrap, t.freqs, t.idx


def _pick(t: torch.Tensor, i: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """t[i] along ``dim`` for a 0-d index tensor, on the device: indexing
    with a 0-d tensor would read it on the host."""
    return t.index_select(dim, i.long().reshape(1)).squeeze(dim)


def ctcss_subchunk_sums(x: torch.Tensor, cnt: torch.Tensor, tables):
    """Pre/post-boundary windowed-DFT sums for one [ns] sub-chunk.

    x: [ns] f32 (the DC-blocked lp branch); cnt: i32 [] samples already in
    the current 2441-window.  Returns (s_pre, s_suf, has_b), s_pre/s_suf
    [38] c64: the power of a completed window is |carry + s_pre|^2."""
    e0, u_table, wrap, _, idx_i = tables
    ns = e0.shape[1]
    cnt = torch.as_tensor(cnt, device=x.device)
    u = _pick(u_table, cnt, dim=1)
    z = e0 * x[None, :] * u[:, None]
    b = (C.CTCSS_BLOCK_SIZE - 1) - cnt
    pre = (idx_i <= b)[None, :]
    zero = torch.zeros_like(z)
    s_pre = torch.where(pre, z, zero).sum(-1)
    s_suf = torch.where(pre, zero, z * wrap[:, None]).sum(-1)
    return s_pre, s_suf, b < ns


def ctcss_detect(power: torch.Tensor):
    """(detected, argmax) of the 38 tone powers (src/sdr_pmr446.c:391-405)."""
    avgp = power.mean()
    pidx = torch.argmax(power).to(torch.int32)
    maxp = power.amax()
    det = ((avgp > C.CTCSS_AVG_POWER_THRESH)
           & (maxp / torch.clamp(avgp, min=1e-30)
              > C.CTCSS_MAX_AVG_RATIO_THRESH))
    return det, pidx


def fsm_ctcss_scan(carry_in: FsmCarry, rssi_k: torch.Tensor, lp: torch.Tensor,
                   mask: torch.Tensor, squelch: torch.Tensor,
                   lock_max: torch.Tensor):
    """The FSM + CTCSS scan over K sub-chunks, one sub-chunk a step (v1).

    rssi_k [K, 16] dB; lp [K, 16, ns] the DC-blocked lp branch of every
    channel; mask bool [16]; squelch f32 [] dB; lock_max bool [].
    Returns (carry_out, FsmOutputs with leading K axis)."""
    k_sub, nch, ns = lp.shape
    n_win = C.CTCSS_BLOCK_SIZE
    tables = ctcss_tables(ns, lp.device)
    freqs = tables[3]
    nch_en = torch.clamp(mask.to(torch.int32).sum(), min=1)
    st, act, rel, cnt, cc, det, tidx, tfreq = carry_in
    zero_c = torch.zeros_like(cc)
    rows = []
    for k in range(k_sub):
        rssi_c = rssi_k[k]
        # find_max_rssi_channel (src/sdr_pmr446.c:668-700)
        rm = torch.where(mask, rssi_c, torch.full_like(rssi_c, -float("inf")))
        max_ch = torch.argmax(rm).to(torch.int32)
        avg = (torch.where(mask, rssi_c, torch.zeros_like(rssi_c)).sum()
               / nch_en.to(torch.float32))
        rel = _pick(rm, max_ch) - avg
        # squelch FSM (src/sdr_pmr446.c:827-874)
        scanning = st == 0
        tune = scanning & (rel > squelch)
        in_tuned = ~scanning
        do_change = in_tuned & lock_max & (act != max_ch)
        prev_chan = act
        act1 = torch.where(tune | do_change, max_ch, act)
        detune = in_tuned & (rel < squelch - C.SQUELCH_HYSTERESIS_DB)
        act2 = torch.where(detune, -1, act1)
        st = torch.where(tune, 1, torch.where(detune, 0, st)).to(torch.int32)
        # detune resets the detector (ctcss_detector_reset + freq = 0)
        cnt = torch.where(detune, 0, cnt)
        cc = torch.where(detune, zero_c, cc)
        det_r = det & ~detune
        tidx_r = torch.where(detune, 0, tidx)
        tfreq = torch.where(detune, 0.0, tfreq)
        # CTCSS analysis of the active channel (ctcss_execute)
        is_active = act2 >= 0
        x = _pick(lp[k], torch.clamp(act2, 0, nch - 1))
        s_pre, s_suf, has_b = ctcss_subchunk_sums(x, cnt, tables)
        y = cc + s_pre
        newdet, pidx = ctcss_detect(y.real * y.real + y.imag * y.imag)
        upd = is_active & has_b
        det = torch.where(upd, newdet, det_r)
        tidx = torch.where(upd, pidx, tidx_r)
        cc = torch.where(is_active, torch.where(has_b, s_suf, y), cc)
        cnt = torch.where(is_active, (cnt + ns) % n_win, cnt)
        tfreq = torch.where(is_active, _pick(freqs, tidx), tfreq)
        # CTCSS events compare pre/post per call (src/sdr_pmr446.c:607-626)
        acq = is_active & det & ~det_r
        chg = is_active & det & det_r & (tidx != tidx_r)
        lost = is_active & ~det & det_r
        act = act2
        rows.append((act2, rel, tune, detune, do_change, prev_chan, act1,
                     det, tidx, tfreq, acq, chg, lost))
    outs = FsmOutputs(*(torch.stack(c) for c in zip(*rows)))
    return FsmCarry(st, act, rel, cnt, cc, det, tidx, tfreq), outs


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


def fsm_tone_sums(sched: FsmSchedule, lp: torch.Tensor | None,
                  lp_cm: torch.Tensor | None, ns: int,
                  tables: CtcssTables | None = None):
    """Phase B: the windowed-DFT sums of the schedule's selected channel,
    (s_pre, s_suf) [K, 38] c64, from ``lp`` [K, 16, ns] or its
    channel-major form ``lp_cm`` [16, K, ns] (the layout the audio bank
    emits: only the selected rows are read).  ``tables``: the chain's
    (default: the shared ones)."""
    k = sched.act2.shape[0]
    src = lp_cm if lp_cm is not None else lp
    tables = tables if tables is not None else shared_tables(ns, src.device)
    tables.check(ns)
    e0, wrap, idx_i = tables.e0, tables.wrap, tables.idx
    sel = torch.clamp(sched.act2, 0, C.NUM_CHANNELS - 1).long()
    ks = torch.arange(k, device=src.device)
    lp_sel = lp_cm[sel, ks] if lp_cm is not None else lp[ks, sel]  # [K, ns]
    pre = (idx_i[None, :] <= sched.b_arr[:, None]).to(torch.float32)
    xp = lp_sel * pre
    xs = lp_sel * (1.0 - pre)
    e0t = e0.T                                                  # [ns, 38]
    u = tables.u_t[sched.cnt_r.long()]                          # [K, 38]
    s_pre = (xp.to(torch.complex64) @ e0t) * u
    s_suf = (xs.to(torch.complex64) @ e0t) * (u * wrap[None, :])
    return s_pre, s_suf


def raw_sums_to_ctcss(sched: FsmSchedule, raw_pre: torch.Tensor,
                      raw_mem: torch.Tensor, ns: int,
                      period: int | None = None,
                      tables: CtcssTables | None = None):
    """(s_pre, s_suf) [K, 38] c64 from the audio-bank kernel's global-phase
    sums: applies the sub-chunk window phase (corr), the carried in-window
    phase (u) and the window wrap factor.  ``period`` = K_local for the
    gathered sums of a time-sharded step (each shard's kernel phase starts
    at its own sample 0).  ``tables``: the chain's, built with this k
    and period (default: the shared ones)."""
    k = raw_pre.shape[0]
    if tables is None:
        tables = shared_tables(ns, raw_pre.device, k, period)
    tables.check(ns, k, period)
    cu = tables.corr * tables.u_t[sched.cnt_r.long()]
    s_pre = raw_pre * cu
    s_suf = (raw_mem - raw_pre) * (cu * tables.wrap[None, :])
    return s_pre, s_suf


def fsm_phase_c(carry_in: FsmCarry, sched: FsmSchedule, s_pre: torch.Tensor,
                s_suf: torch.Tensor, tables: CtcssTables | None = None):
    """Goertzel-carry chain + detection state from the tone sums ([K, 38]
    c64).  Returns (carry_out, FsmOutputs).  ``tables``: the chain's
    (default: the shared ones; only ``freqs`` is read)."""
    k_sub = sched.act2.shape[0]
    if tables is None:
        tables = shared_tables(C.SUBCHUNK_AUDIO, s_pre.device)
    freqs = tables.freqs
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
        newdet, pidx = ctcss_detect(y.real * y.real + y.imag * y.imag)
        det = torch.where(upd, newdet, det_r)
        tidx = torch.where(upd, pidx, tidx_r)
        cc = torch.where(act_k, torch.where(sched.has_b[k], s_suf[k], y),
                         cc_in)
        tfreq = torch.where(act_k, _pick(freqs, tidx), tfreq_r)
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


def fsm_ctcss_scan_v3(carry_in: FsmCarry, rssi_k: torch.Tensor,
                      lp: torch.Tensor | None, mask: torch.Tensor,
                      squelch: torch.Tensor, lock_max: torch.Tensor,
                      lp_cm: torch.Tensor | None = None,
                      tables: CtcssTables | None = None):
    """fsm_ctcss_scan in three phases: fsm_phase_a -> fsm_tone_sums ->
    fsm_phase_c (the same decisions; test-enforced).  ``lp_cm``
    ([16, K, ns], channel-major) may be passed instead of ``lp``
    ([K, 16, ns]); the values are identical either way.  ``tables``: the
    chain's CtcssTables (default: the shared ones)."""
    if lp_cm is not None:
        assert lp is None
    ns = (lp_cm if lp_cm is not None else lp).shape[-1]
    sched = fsm_phase_a(carry_in, rssi_k, mask, squelch, lock_max, ns)
    s_pre, s_suf = fsm_tone_sums(sched, lp, lp_cm, ns, tables)
    return fsm_phase_c(carry_in, sched, s_pre, s_suf, tables)


def fsm_ctcss_scan_v2(carry_in: FsmCarry, rssi_k: torch.Tensor,
                      lp: torch.Tensor, mask: torch.Tensor,
                      squelch: torch.Tensor, lock_max: torch.Tensor):
    """JAX's sequential three-phase scan: in the port, where phases A and
    C are sequential loops already, the same function as v3."""
    return fsm_ctcss_scan_v3(carry_in, rssi_k, lp, mask, squelch, lock_max)
