"""Squelch FSM + CTCSS detector over sub-chunk summaries (PyTorch).

Counterpart of sdr_pmr446_tpu/scanner/fsm.py, in its three forms:

  - ``fsm_ctcss_scan`` (v1): the per-sub-chunk scan, each step a handful
    of [16] RSSI ops and the [38, ns] windowed-DFT tone sums of the active
    channel (``ctcss_tables``, ``ctcss_subchunk_sums``, ``ctcss_detect``);
    the test oracle of the other two (faithful mode, scanner/faithful.py,
    keeps its own loop of the same step);
  - ``fsm_ctcss_scan_v2``: JAX's sequential three-phase scan, its phases A
    and C a loop over the K sub-chunks (``fsm_phase_a_v2``,
    ``fsm_phase_c_v2``: each sub-chunk a few dozen small tensor ops);
  - ``fsm_ctcss_scan_v3``: JAX's associative formulation, which every
    scanner engine runs (scanner/chain.py, parallel/scanner_sharded.py):
      A. ``fsm_phase_a``: the squelch FSM and the detector's in-window
         count schedule, a pure function of the per-sub-chunk RSSI;
      B. ``fsm_tone_sums``: the tone sums of every sub-chunk's selected
         channel as two complex [K, ns] x [ns, 38] products (on the default
         engine they come from K2 instead, kernels/audio_bank.py, through
         ``raw_sums_to_ctcss``);
      C. ``fsm_phase_c``: the Goertzel-carry chain and the detection state.

In v3 every recurrence of A and C is a chain of maps from a small monoid:
the FSM's maps on (state, channel), branch-indexed by the state they start
from; the count's affine maps mod 2441 with a coefficient in {0, 1}; the
Goertzel carry's affine maps cc -> A cc + B, A in {0, 1}; the detection
state's keep-or-set maps.  Each runs as ``_associative_scan`` over K, the
recursion of jax.lax.associative_scan unrolled in Python (K is static), so
a step is ~400 tensor ops at K = 40 and ~520 at K = 160 (the loops: ~2,300
and ~9,300), none reads the host, and the step stays graph-capturable and
exportable.  Because the scan combines in JAX's order, v3 equals JAX's v3
bit for bit; it also equals v2, since a carry chain between resets holds
at most one addition (the 2441-sample window is shorter than two
1225-sample sub-chunks).  A, B and C take an optional leading stream axis
(carry fields [S], rssi_k [S, K, 16], tone sums [S, K, 38]): S streams in
one call, as JAX's vmap gives the sharded scanner.  The phasor tables are
built once on the host in float64; their device copies (``CtcssTables``)
are built with the chain that runs the detector, or shared per device for
the callers that hold none.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from sdr_pmr446_tpu_torch import config as C


class FsmCarry(NamedTuple):
    """The detector's carried state; v3 takes a leading [S] on each."""
    fsm_state: torch.Tensor     # i32 []
    active_chan: torch.Tensor   # i32 []
    rssi: torch.Tensor          # f32 []
    ct_count: torch.Tensor      # i32 []
    ct_carry: torch.Tensor      # c64 [38]
    ct_detected: torch.Tensor   # bool []
    ct_max_idx: torch.Tensor    # i32 []
    ct_freq: torch.Tensor       # f32 []


class FsmOutputs(NamedTuple):
    """Per-sub-chunk outputs (leading axis K; [S, K] for S streams)."""
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
    """Phase-A outputs: the FSM/detector schedule, a function of RSSI only
    ([S, K] for S streams)."""
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
    """(detected, argmax) of the 38 tone powers [..., 38], one pair for
    each row (src/sdr_pmr446.c:391-405)."""
    avgp = power.mean(-1)
    pidx = torch.argmax(power, -1).to(torch.int32)
    maxp = power.amax(-1)
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


# ---------------------------------------------------------------- v2: loops
def fsm_phase_a_v2(carry_in: FsmCarry, rssi_k: torch.Tensor,
                   mask: torch.Tensor, squelch: torch.Tensor,
                   lock_max: torch.Tensor, ns: int) -> FsmSchedule:
    """Phase A of v2 (JAX's step_a scan): the squelch FSM and the detector
    count schedule of one stream, a loop over the K sub-chunks."""
    max_ch, rel, tune_b, detune_b = _rssi_reductions(rssi_k, mask, squelch)
    n_win = C.CTCSS_BLOCK_SIZE
    st = carry_in.fsm_state
    act = carry_in.active_chan
    cnt = carry_in.ct_count
    rows = []
    for k in range(rssi_k.shape[0]):
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


def fsm_phase_c_v2(carry_in: FsmCarry, sched: FsmSchedule,
                   s_pre: torch.Tensor, s_suf: torch.Tensor,
                   tables: CtcssTables | None = None):
    """Phase C of v2 (JAX's step_c scan): the Goertzel-carry chain and the
    detection state of one stream, a loop over the K sub-chunks.  Returns
    (carry_out, FsmOutputs)."""
    if tables is None:
        tables = shared_tables(C.SUBCHUNK_AUDIO, s_pre.device)
    freqs = tables.freqs
    cc = carry_in.ct_carry
    det = carry_in.ct_detected
    tidx = carry_in.ct_max_idx
    tfreq = carry_in.ct_freq
    zero_c = torch.zeros_like(cc)
    rows = []
    for k in range(sched.act2.shape[0]):
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


def fsm_ctcss_scan_v2(carry_in: FsmCarry, rssi_k: torch.Tensor,
                      lp: torch.Tensor, mask: torch.Tensor,
                      squelch: torch.Tensor, lock_max: torch.Tensor):
    """JAX's sequential three-phase scan of one stream: fsm_phase_a_v2 ->
    fsm_tone_sums -> fsm_phase_c_v2 (the same decisions as v1 and v3;
    test-enforced)."""
    ns = lp.shape[-1]
    sched = fsm_phase_a_v2(carry_in, rssi_k, mask, squelch, lock_max, ns)
    s_pre, s_suf = fsm_tone_sums(sched, lp, None, ns)
    return fsm_phase_c_v2(carry_in, sched, s_pre, s_suf)


# ------------------------------------------------------ v3: associative scans
def _cut(x: torch.Tensor, dim: int, start, stop=None, step=None):
    """x[start:stop:step] along ``dim`` (a view)."""
    return x[(slice(None),) * dim + (slice(start, stop, step),)]


def _associative_scan(combine, elems: tuple, dim: int) -> tuple:
    """The inclusive scan of ``elems`` (a tuple of tensors of one length
    along ``dim``) under the associative ``combine(f, g)`` (g applied after
    f), in jax.lax.associative_scan's recursion: combine the pairs
    e[0:-1:2], e[1::2]; scan those; combine the odd results with e[2::2];
    put e[:1] first and interleave.  Each element is then the same
    expression tree as JAX's, so rounding matches it.  The length is
    static: the recursion unrolls in Python (log2 of it deep), so a CUDA
    graph or torch.export sees only tensor ops."""
    n = elems[0].shape[dim]
    if n < 2:
        return elems
    odd = _associative_scan(
        combine, combine(tuple(_cut(e, dim, 0, -1, 2) for e in elems),
                         tuple(_cut(e, dim, 1, None, 2) for e in elems)),
        dim)
    if n == 2:
        return tuple(torch.cat([_cut(e, dim, 0, 1), o], dim)
                     for e, o in zip(elems, odd))
    rest = tuple(_cut(e, dim, 2, None, 2) for e in elems)
    even = combine(odd if n % 2 else tuple(_cut(o, dim, 0, -1) for o in odd),
                   rest)
    # e[0], odd[0], even[0], odd[1], even[1], ... (odd one longer when n is
    # even)
    m = even[0].shape[dim]
    out = []
    for e, o, v in zip(elems, odd, even):
        pairs = torch.stack([_cut(o, dim, 0, m), v], dim + 1).flatten(
            dim, dim + 1)
        out.append(torch.cat([_cut(e, dim, 0, 1), pairs]
                             + ([_cut(o, dim, m)] if n % 2 == 0 else []),
                             dim))
    return tuple(out)


def _keep_const_scan(keep: torch.Tensor, val: torch.Tensor,
                     init: torch.Tensor) -> torch.Tensor:
    """The values after each step of a chain of keep-or-set maps, x -> x
    if keep else val: keep / val [S, K, ...], init [S, ...] the value before
    step 0.  (g after f) = (f.keep & g.keep, f.val if g.keep else g.val)
    is associative, so the chain runs in log2(K) depth."""
    def combine(f, g):                        # g is applied after f
        return f[0] & g[0], torch.where(g[0], f[1], g[1])

    ks, vs = _associative_scan(combine, (keep, val), 1)
    return torch.where(ks, init[:, None], vs)


def _prev(x0: torch.Tensor, arr: torch.Tensor) -> torch.Tensor:
    """The value before each step: [x0, arr[:, :-1]] along K (dim 1)."""
    return torch.cat([x0[:, None], arr[:, :-1]], 1)


def _streams(carry: FsmCarry) -> FsmCarry:
    """One stream's carry with a stream axis of 1."""
    return FsmCarry(*(v[None] for v in carry))


def _rssi_reductions(rssi_k: torch.Tensor, mask: torch.Tensor,
                     squelch: torch.Tensor):
    """find_max_rssi_channel (src/sdr_pmr446.c:668-700) of every sub-chunk
    of rssi_k [..., K, 16] dB: (max channel i32, rel dB, above the squelch,
    below it less the hysteresis), each [..., K]."""
    nch_en = torch.clamp(mask.to(torch.int32).sum(), min=1)
    rm = torch.where(mask, rssi_k, -float("inf"))
    max_ch = torch.argmax(rm, dim=-1)
    avg = torch.where(mask, rssi_k, 0.0).sum(-1) / nch_en.to(torch.float32)
    rel = torch.gather(rm, -1, max_ch[..., None])[..., 0] - avg
    return (max_ch.to(torch.int32), rel, rel > squelch,
            rel < squelch - C.SQUELCH_HYSTERESIS_DB)


def fsm_phase_a(carry_in: FsmCarry, rssi_k: torch.Tensor, mask: torch.Tensor,
                squelch: torch.Tensor, lock_max: torch.Tensor,
                ns: int) -> FsmSchedule:
    """Phase A of v3: the squelch FSM transitions and the detector count
    schedule as associative scans over the K sub-chunks (JAX
    fsm.py:360-441).  rssi_k [K, 16] with a carry of scalars, or [S, K, 16]
    with a carry of [S] (S streams at once: JAX's vmap); the schedule's
    fields are then [S, K]."""
    if rssi_k.dim() == 2:
        return FsmSchedule(*(v[0] for v in fsm_phase_a(
            _streams(carry_in), rssi_k[None], mask, squelch, lock_max, ns)))
    n_win = C.CTCSS_BLOCK_SIZE
    max_ch, rel, tune_b, detune_b = _rssi_reductions(rssi_k, mask, squelch)

    # the FSM prefix: maps on (st, act), indexed by the state they start
    # from.  st_in = 0: tune -> (1, SET mc) else (0, KEEP); st_in = 1:
    # detune -> (0, SET -1) else (1, SET mc if lock_max else KEEP) (when
    # lock_max and act == mc, SET mc is KEEP act)
    s_map = torch.stack([tune_b, ~detune_b], -1).long()          # [S, K, 2]
    keep_map = torch.stack([~tune_b, ~(detune_b | lock_max)], -1)
    val_map = torch.stack([max_ch, torch.where(detune_b, -1, max_ch)], -1)

    def fsm_combine(f, g):                    # g applied after f
        gk_f = torch.gather(g[1], -1, f[0])
        return (torch.gather(g[0], -1, f[0]), f[1] & gk_f,
                torch.where(gk_f, f[2], torch.gather(g[2], -1, f[0])))

    ss, kk, vv = _associative_scan(fsm_combine, (s_map, keep_map, val_map),
                                   1)
    st0, act0 = carry_in.fsm_state, carry_in.active_chan
    at_st0 = st0.long()[:, None, None].expand(-1, ss.shape[1], 1)
    st_arr = torch.gather(ss, -1, at_st0)[..., 0].to(torch.int32)
    act2 = torch.where(torch.gather(kk, -1, at_st0)[..., 0], act0[:, None],
                       torch.gather(vv, -1, at_st0)[..., 0])  # post-step act
    act_prev = _prev(act0, act2)

    # per-step event flags from the resolved prefixes
    scanning = _prev(st0, st_arr) == 0
    tune = scanning & tune_b
    in_tuned = ~scanning
    do_change = in_tuned & lock_max & (act_prev != max_ch)
    act1 = torch.where(tune | do_change, max_ch, act_prev)
    detune = in_tuned & detune_b
    is_active = act2 >= 0

    # the detector count prefix: cnt -> (m * cnt + d) mod n_win
    def cnt_combine(f, g):
        return f[0] * g[0], (g[0] * f[1] + g[1]) % n_win

    cm, cd = _associative_scan(cnt_combine, (torch.where(detune, 0, 1),
                                             torch.where(is_active, ns, 0)), 1)
    cnt0 = carry_in.ct_count
    cnt_arr = ((cm * cnt0[:, None] + cd) % n_win).to(torch.int32)
    cnt_r = torch.where(detune, 0, _prev(cnt0, cnt_arr))
    b_arr = (n_win - 1) - cnt_r
    has_b = is_active & (b_arr < ns)
    return FsmSchedule(act2, rel, tune, detune, do_change, act_prev, act1,
                       is_active, cnt_r, b_arr, has_b, is_active & has_b,
                       st_arr, cnt_arr)


def fsm_tone_sums(sched: FsmSchedule, lp: torch.Tensor | None,
                  lp_cm: torch.Tensor | None, ns: int,
                  tables: CtcssTables | None = None):
    """Phase B: the windowed-DFT sums of the schedule's selected channel,
    (s_pre, s_suf) [..., K, 38] c64, from ``lp`` [..., K, 16, ns] or its
    channel-major form ``lp_cm`` [..., 16, K, ns] (the layout the audio
    bank emits: only the selected rows are read); a leading stream axis
    [S] on the schedule and on lp / lp_cm, or on neither.  ``tables``: the
    chain's (default: the shared ones)."""
    src = lp_cm if lp_cm is not None else lp
    tables = tables if tables is not None else shared_tables(ns, src.device)
    tables.check(ns)
    e0, wrap, idx_i = tables.e0, tables.wrap, tables.idx
    sel = torch.clamp(sched.act2, 0, C.NUM_CHANNELS - 1).long()
    ks = torch.arange(sel.shape[-1], device=src.device)
    if sel.dim() == 2:                        # [S, K]: index the streams too
        at_s = torch.arange(sel.shape[0], device=src.device)[:, None]
        lp_sel = (lp_cm[at_s, sel, ks] if lp_cm is not None
                  else lp[at_s, ks, sel])                       # [S, K, ns]
    else:
        lp_sel = lp_cm[sel, ks] if lp_cm is not None else lp[ks, sel]
    pre = (idx_i <= sched.b_arr[..., None]).to(torch.float32)
    xp = lp_sel * pre
    xs = lp_sel * (1.0 - pre)
    e0t = e0.T                                                  # [ns, 38]
    u = tables.u_t[sched.cnt_r.long()]                          # [..., K, 38]
    s_pre = (xp.to(torch.complex64) @ e0t) * u
    s_suf = (xs.to(torch.complex64) @ e0t) * (u * wrap)
    return s_pre, s_suf


def raw_sums_to_ctcss(sched: FsmSchedule, raw_pre: torch.Tensor,
                      raw_mem: torch.Tensor, ns: int,
                      period: int | None = None,
                      tables: CtcssTables | None = None):
    """(s_pre, s_suf) [..., K, 38] c64 from the audio-bank kernel's
    global-phase sums [..., K, 38] (a leading stream axis as the
    schedule's): applies the sub-chunk window phase (corr), the carried
    in-window phase (u) and the window wrap factor.  ``period`` = K_local
    for the gathered sums of a time-sharded step (each shard's kernel
    phase starts at its own sample 0).  ``tables``: the chain's, built with
    this k and period (default: the shared ones)."""
    k = raw_pre.shape[-2]
    if tables is None:
        tables = shared_tables(ns, raw_pre.device, k, period)
    tables.check(ns, k, period)
    cu = tables.corr * tables.u_t[sched.cnt_r.long()]
    s_pre = raw_pre * cu
    s_suf = (raw_mem - raw_pre) * (cu * tables.wrap)
    return s_pre, s_suf


def fsm_phase_c(carry_in: FsmCarry, sched: FsmSchedule, s_pre: torch.Tensor,
                s_suf: torch.Tensor, tables: CtcssTables | None = None):
    """Phase C of v3: the Goertzel-carry prefix and the detection state's
    keep-or-set chains over the tone sums (JAX fsm.py:513-580), as
    associative scans over K; s_pre / s_suf [K, 38] c64, or [S, K, 38] with
    a schedule and a carry of S streams.  Returns (carry_out, FsmOutputs).
    ``tables``: the chain's (default: the shared ones; only ``freqs`` is
    read)."""
    if sched.act2.dim() == 1:
        carry, outs = fsm_phase_c(
            _streams(carry_in), FsmSchedule(*(v[None] for v in sched)),
            s_pre[None], s_suf[None], tables)
        return (FsmCarry(*(v[0] for v in carry)),
                FsmOutputs(*(v[0] for v in outs)))
    if tables is None:
        tables = shared_tables(C.SUBCHUNK_AUDIO, s_pre.device)
    (act2, rel, tune, detune, do_change, act_prev, act1, is_active,
     cnt_r, b_arr, has_b, upd, st_arr, cnt_arr) = sched

    # the Goertzel carry prefix: cc -> A * cc + B, A in {0, 1}
    a_cc = (~(detune | upd)).to(torch.complex64)                # [S, K]
    b_cc = torch.where(upd[..., None], s_suf,
                       torch.where(is_active[..., None], s_pre, 0))

    def cc_combine(f, g):
        return f[0] * g[0], g[0][..., None] * f[1] + g[1]

    ca, cb = _associative_scan(cc_combine, (a_cc, b_cc), 1)
    cc0 = carry_in.ct_carry
    cc_arr = ca[..., None] * cc0[:, None] + cb                  # post-step cc
    cc_in = torch.where(detune[..., None], 0, _prev(cc0, cc_arr))

    # the detection of every step at once
    y = cc_in + s_pre
    newdet, pidx = ctcss_detect(y.real * y.real + y.imag * y.imag)

    # the detected / tone-index / tone-frequency keep-or-set chains
    keep_dt = ~(upd | detune)                 # detune resets, upd overwrites
    det0, tidx0 = carry_in.ct_detected, carry_in.ct_max_idx
    det_o = _keep_const_scan(keep_dt, upd & newdet, det0)
    tidx_o = _keep_const_scan(keep_dt, torch.where(upd, pidx, 0), tidx0)
    det_r = _prev(det0, det_o) & ~detune
    tidx_r = torch.where(detune, 0, _prev(tidx0, tidx_o))
    tfreq_o = _keep_const_scan(~(is_active | detune),
                               torch.where(is_active, tables.freqs[tidx_o],
                                           0.0), carry_in.ct_freq)

    acq_o = is_active & det_o & ~det_r
    chg_o = is_active & det_o & det_r & (tidx_o != tidx_r)
    lost_o = is_active & ~det_o & det_r
    carry_out = FsmCarry(st_arr[:, -1], act2[:, -1], rel[:, -1],
                         cnt_arr[:, -1], cc_arr[:, -1], det_o[:, -1],
                         tidx_o[:, -1], tfreq_o[:, -1])
    outs = FsmOutputs(act2, rel, tune, detune, do_change, act_prev, act1,
                      det_o, tidx_o, tfreq_o, acq_o, chg_o, lost_o)
    return carry_out, outs


def fsm_ctcss_scan_v3(carry_in: FsmCarry, rssi_k: torch.Tensor,
                      lp: torch.Tensor | None, mask: torch.Tensor,
                      squelch: torch.Tensor, lock_max: torch.Tensor,
                      lp_cm: torch.Tensor | None = None,
                      tables: CtcssTables | None = None):
    """fsm_ctcss_scan as associative scans: fsm_phase_a -> fsm_tone_sums
    -> fsm_phase_c (the same decisions; test-enforced), of one stream or,
    with a leading stream axis on the carry, rssi_k and lp / lp_cm, of S
    at once.  ``lp_cm`` ([..., 16, K, ns], channel-major) may be passed
    instead of ``lp`` ([..., K, 16, ns]); the values are identical either
    way.  ``tables``: the chain's CtcssTables (default: the shared
    ones)."""
    if lp_cm is not None:
        assert lp is None
    ns = (lp_cm if lp_cm is not None else lp).shape[-1]
    sched = fsm_phase_a(carry_in, rssi_k, mask, squelch, lock_max, ns)
    s_pre, s_suf = fsm_tone_sums(sched, lp, lp_cm, ns, tables)
    return fsm_phase_c(carry_in, sched, s_pre, s_suf, tables)
