"""Cross-shard state of the kernel engines on a one-card mesh.

Counterpart of sdr_pmr446_tpu/parallel/fused_halo.py.  The kernel engines
run their one-pole DC blockers inside the kernels (the IQ blocker in K1,
K4 and K6, the CTCSS-branch blocker in K2), so the DC-blocked planes never
exist for parallel/halo.py's recipe to compose.  Everything downstream of
a one-pole is affine in its incoming state instead:

  1. a READ-ONLY pre-pass (K10, kernels/summary.py) reduces each shard's
     wire to per-128-sample-row zero-state DC summaries, and a [rows] fold
     gives each shard's zero-state end values (``front_zero_summary_wire``);
  2. ``compose_dc_chain`` folds the per-shard end values over the time
     axis in order and yields each shard's TRUE incoming (x[-1], y[-1]) and
     the error delta * p^n of a zero-state run;
  3. the duo and mono engines then run their kernel per shard with that
     exact state, and their outgoing halos are rebuilt from a short
     corrected DC tail (``dc_tail_exact``); the trio runs its front end
     (K6) from zero state and corrects the band planes (``correct_band``,
     the resampler applied to the ramp, ``front_end_consts``); the audio
     bank (K2) runs from zero lp-DC state and its tone sums are corrected
     by geometric-phasor sums (``correct_raw_sums``, ``ctcss_corr_consts``).

Every constant is re-derived here in float64 on the host, bit-equal to the
JAX package's (test-enforced), and applied as f32 operations.  All values
carry the mesh's leading dims ([S, D] per shard, [S] carried;
parallel/halo.py).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from sdr_pmr446_tpu_torch import config as C
from sdr_pmr446_tpu_torch.ops import decode, iir
from sdr_pmr446_tpu_torch.ops.resample import _kernel_matrix
from sdr_pmr446_tpu_torch.parallel.halo import shift_right
from sdr_pmr446_tpu_torch.taps import design as D

_P = 1.0 - C.DC_BLOCK_ALPHA
_G = (1.0 + _P) / 2.0
#: the JAX front end's row geometry (kernels/front_end.py L, M, HIST, W_PAD)
L, M = C.RESAMP_L, C.RESAMP_M
_HIST_ROWS = 3
W_PAD = (_HIST_ROWS + 1) * M


# ---------------------------------------------------------------------------
# generic shard plumbing
# ---------------------------------------------------------------------------

def shard_pass_right(carried: torch.Tensor, val: torch.Tensor):
    """Each shard receives its LEFT neighbour's ``val`` [S, D, ...] (shard 0
    the ``carried`` [S, ...]); returns (received, new_carried = the last
    shard's val)."""
    return shift_right(carried, val), last_shard(val)


def last_shard(val: torch.Tensor) -> torch.Tensor:
    """The LAST shard's ``val`` [S, D, ...] -> [S, ...]."""
    return val[:, -1]


def compose_dc_chain(y0_end, x_last, carried_y, carried_x, p_t1: float,
                     g: float):
    """Each shard's TRUE incoming one-pole state from zero-state kernel
    runs of y[n] = g (x[n] - x[n-1]) + p y[n-1].

    y0_end [S, D, ...]: each shard's zero-state final y; x_last [S, D,
    ...]: its true last input; carried_y, carried_x [S, ...] the stream's
    state entering the block; ``p_t1`` = p^(T-1) for T samples a shard;
    ``g`` the recurrence's b1 magnitude (0.0 when the kernel already had
    the true x[-1]).  A zero-state run errs by delta * p^n with delta =
    p y_in - g x_in, so y_true_end = y0_end + delta p_t1: a D-step fold in
    order, in the dtype of y0_end (complex64 or f32), as JAX's lax.scan
    (the constants stay host scalars: nothing is copied to the device).

    Returns (y_in [S, D, ...], delta [S, D, ...], new_carried_y [S, ...],
    new_carried_x [S, ...])."""
    num = y0_end.shape[1]
    x_in_seq = shift_right(carried_x, x_last)
    y = carried_y.to(y0_end.dtype)
    y_ins, deltas = [], []
    for d in range(num):
        delta = _P * y - g * x_in_seq[:, d]
        y_ins.append(y)
        deltas.append(delta)
        y = y0_end[:, d] + delta * p_t1
    return (torch.stack(y_ins, dim=1), torch.stack(deltas, dim=1), y,
            last_shard(x_last))


@functools.lru_cache(maxsize=None)
def _device_const(fn, device: str, name: str, *key) -> torch.Tensor:
    """fn(*key)[name] as a tensor on ``device``, made once per device."""
    return torch.as_tensor(fn(*key)[name], device=device)


# ---------------------------------------------------------------------------
# the trio's front end (K6 from zero state + band correction)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _k2() -> np.ndarray:
    """The JAX front end's [512, 25] f32 polyphase matrix k2
    (kernels/front_end.py::_row_consts): the resampler's kernel matrix,
    transposed and left-padded by 384 - 345 rows."""
    taps = D.resampler_taps()
    k = _kernel_matrix(tuple(taps.tolist()), L, M)            # [25, 468]
    left_pad = _HIST_ROWS * M - (len(taps) // L - 1)          # 39
    k2 = np.zeros((W_PAD, L), dtype=np.float32)
    k2[left_pad:left_pad + k.shape[1], :] = k.T
    return k2


@functools.lru_cache(maxsize=None)
def front_end_consts(t_local: int, hist_len: int) -> dict:
    """Correction constants of a zero-state front-end shard run.

    With the kernel given the true x[-1] and y[-1] = 0, its DC output is
    low by y_in p^(n+1) and its resampler windows miss the history block;
    both errors are linear, so per plane

        band += y_in * gvec  +  hist_true @ mh  (the first 75 outputs)

    gvec [G_local, 400]: the resampler applied to the ramp p^(n+1) with zero
    history; mh [hist_len, 75]: its response to the history block;
    tail_ramp [hist_len]: p^(n+1) at the tail (corrects the kernel's
    carried history); p_t = p^T; p_t1 = p^(T-1).  Float64 on the host, the
    JAX package's arithmetic (bit-equal)."""
    k2 = _k2().astype(np.float64)
    p = np.float64(_P)
    assert t_local % (16 * M) == 0
    rows = t_local // M
    g_local = rows // 16

    j = np.arange(W_PAD, dtype=np.float64)
    kappa = (k2 * (p ** j)[:, None]).sum(axis=0)           # [25]
    gv = np.zeros((rows, L), dtype=np.float64)
    for r in range(min(3, rows)):
        lo = M * (3 - r)                                   # ramp starts here
        w = p ** np.maximum(j - lo + 1.0, 0.0)
        w[j < lo] = 0.0
        gv[r] = (k2 * w[:, None]).sum(axis=0)
    if rows > 3:
        rr = np.arange(3, rows, dtype=np.float64)
        gv[3:] = (p ** (M * (rr - 3) + 1.0))[:, None] * kappa[None, :]
    gvec = gv.reshape(g_local, 16 * L).astype(np.float32)

    mh = np.zeros((hist_len, 3 * L), dtype=np.float64)
    for r in range(3):
        for h in range(hist_len):
            jj = h - hist_len + 3 * M - M * r
            if 0 <= jj < W_PAD:
                mh[h, L * r:L * (r + 1)] = k2[jj]
    n_tail = np.arange(t_local - hist_len, t_local, dtype=np.float64)
    tail_ramp = (p ** (n_tail + 1.0)).astype(np.float32)
    return dict(gvec=gvec, mh=mh.astype(np.float32), tail_ramp=tail_ramp,
                p_t=float(p ** t_local), p_t1=float(p ** (t_local - 1)))


def correct_band(bw: torch.Tensor, y_in_plane: torch.Tensor,
                 hist_plane: torch.Tensor, t_local: int,
                 hist_len: int) -> torch.Tensor:
    """bw [..., G, 400]: one plane of the zero-state kernel's band;
    y_in_plane [...] f32 (re or im of the incoming dc y); hist_plane [...,
    hist_len] f32 (the TRUE incoming front history, same plane).  Returns
    the corrected plane."""
    dev = str(bw.device)
    key = (t_local, hist_len)
    mh = _device_const(front_end_consts, dev, "mh", *key)
    gvec = _device_const(front_end_consts, dev, "gvec", *key)
    head = torch.matmul(hist_plane[..., None, :], mh)[..., 0, :]   # [..., 75]
    corr = y_in_plane[..., None, None] * gvec
    corr[..., 0, :head.shape[-1]] += head
    return bw + corr


# ---------------------------------------------------------------------------
# the duo / mono engines: the exact-state pre-pass
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def dc_row_weights() -> np.ndarray:
    """[128] f32: the end-of-row zero-state DC response to in-row samples,
    G-scaled: sum_j' p^(127-j') g (x[j'] - x[j'-1]) as weights on x[j].
    Shared by the plain pre-pass and K10 (kernels/summary.py)."""
    p = np.float64(_P)
    j = np.arange(128, dtype=np.float64)
    v = np.where(j < 127, p ** (127.0 - j) - p ** (126.0 - j), 1.0)
    return (np.float64(_G) * v).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _zero_summary_consts(t_local: int, tail_len: int) -> dict:
    """Host-float64 constants of the pre-pass (the JAX package's)."""
    p = np.float64(_P)
    rows = t_local // 128
    r = np.arange(rows, dtype=np.float64)
    pr_last = (p ** (128.0 * (rows - 1 - r)))          # fold to final y
    tail_rows = tail_len // 128
    # correction ramp at the tail positions: p^n, n = T - tail_len + j
    n_tail = np.arange(tail_len, dtype=np.float64) + (t_local - tail_len)
    return dict(v=dc_row_weights(),
                gp127=np.float32(_G * p ** 127.0),
                p128=float(p ** 128.0),
                pr_last=pr_last.astype(np.float32),
                rows=rows, tail_rows=tail_rows,
                tail_ramp=(p ** n_tail).astype(np.float32),
                p_t1=float(p ** (t_local - 1.0)))


def fold_row_summaries(w: torch.Tensor, xl_col: torch.Tensor, t_local: int,
                       tail_len: int):
    """The [rows] first-order fold of the pre-pass: w [2, ..., R] the
    per-row zero-state responses (dc_row_weights), xl_col [2, ..., R] each
    row's last sample.  Returns (y00, y_pre, x_pre, xlast), each c64 [...]:
    the zero-state final y, the zero-state y at T - tail_len - 1, x[T -
    tail_len - 1] and x[T - 1]."""
    cc = _zero_summary_consts(t_local, tail_len)
    rows, tr = cc["rows"], cc["tail_rows"]
    prev_last = torch.cat([torch.zeros_like(xl_col[..., :1]),
                           xl_col[..., :-1]], dim=-1)
    t_r = w - float(cc["gp127"]) * prev_last
    b = iir.first_order_scan(t_r, cc["p128"], torch.zeros_like(t_r[..., 0]))
    pick = lambda a, i: torch.complex(a[0, ..., i], a[1, ..., i])  # noqa: E731
    return (pick(b, rows - 1), pick(b, rows - tr - 1),
            pick(xl_col, rows - tr - 1), pick(xl_col, rows - 1))


def front_zero_summary_wire(wire: torch.Tensor, fmt: str, t_local: int,
                            tail_len: int):
    """The pre-pass straight from the wire: ``wire`` uint8 [..., t_local *
    bytes a sample], one shard a row (every stream and shard of a step in
    one tensor).  K10 (kernels/summary.py) reduces all of it in one launch
    to per-row summaries, which ``fold_row_summaries`` folds per shard; the
    RAW tail is decoded from each shard's last tail_len samples (raw bytes,
    so no whole-row rounding as in JAX).  Returns (y00, y_pre, x_pre,
    xlast, tail_x [..., tail_len] c64).  On the card K10 reads the wire in
    16-byte pieces, so ``wire`` must start on 16 bytes: the step's own
    upload does (the allocator's blocks start on 512 B); a view at another
    offset raises."""
    from sdr_pmr446_tpu_torch.kernels.summary import zero_summary_wire
    bps = decode.BYTES_PER_SAMPLE[fmt]
    lead = wire.shape[:-1]
    if wire.shape[-1] != t_local * bps:
        raise ValueError(f"a shard is {wire.shape[-1]} bytes, expected "
                         f"{t_local * bps}")
    w, xl = zero_summary_wire(wire.reshape(-1), fmt)
    rows = t_local // 128
    y00, y_pre, x_pre, xlast = fold_row_summaries(
        w.reshape((2,) + lead + (rows,)), xl.reshape((2,) + lead + (rows,)),
        t_local, tail_len)
    tail = wire[..., wire.shape[-1] - tail_len * bps:]
    xr, xi = decode.decode_planes(tail.reshape(-1), fmt)
    tail_x = torch.complex(xr, xi).reshape(lead + (tail_len,))
    return y00, y_pre, x_pre, xlast, tail_x


def dc_tail_exact(tail_x: torch.Tensor, y_pre, x_pre, delta,
                  t_local: int) -> torch.Tensor:
    """The TRUE DC-blocked input tail [..., tail_len] c64: a short scan
    from the zero-state boundary values plus the delta * p^n correction
    (delta from compose_dc_chain; an exact affine identity)."""
    tail_len = tail_x.shape[-1]
    ramp = _device_const(_zero_summary_consts, str(tail_x.device),
                         "tail_ramp", t_local, tail_len)
    xs = torch.stack([tail_x.real, tail_x.imag])
    x0 = torch.stack([x_pre.real, x_pre.imag])
    xprev = torch.cat([x0[..., None], xs[..., :-1]], dim=-1)
    z = _G * (xs - xprev)
    y0 = torch.stack([y_pre.real, y_pre.imag])
    y00_tail = iir.first_order_scan(z, _P, y0)            # [2, ..., tail]
    dcol = torch.stack([delta.real, delta.imag])[..., None]
    y_true = y00_tail + dcol * ramp
    return torch.complex(y_true[0], y_true[1])


def exact_dc_state(wire: torch.Tensor, fmt: str, t_local: int,
                   tail_len: int, carried_x: torch.Tensor,
                   carried_y: torch.Tensor):
    """The pre-pass of the duo and mono engines, for wire [S, D, bytes a
    shard] and the stream state (carried_x, carried_y) c64 [S]: each
    shard's exact incoming DC state and its true DC-blocked tail.  Returns
    (x_in [S, D], y_in [S, D], new_x [S], new_y [S], dc_tail [S, D,
    tail_len])."""
    y00, y_pre, x_pre, xlast, tail_x = front_zero_summary_wire(
        wire, fmt, t_local, tail_len)
    p_t1 = _zero_summary_consts(t_local, tail_len)["p_t1"]
    y_in, delta, new_y, new_x = compose_dc_chain(
        y00, xlast, carried_y, carried_x, p_t1, _G)
    return (shift_right(carried_x, xlast), y_in, new_x, new_y,
            dc_tail_exact(tail_x, y_pre, x_pre, delta, t_local))


#: where the halo rebuilds start in a corrected DC tail: the resampler's
#: 345-sample history fits before it (the JAX engines' 384)
REBUILD_START = 384


def resample_tail(res, x: torch.Tensor, start: int) -> torch.Tensor:
    """A plain resampler (ops/resample.PolyResampler) on the complex
    x[..., start:], with x[..., start - res.hist_len:start] as its history:
    how the pre-pass pushes a corrected tail through a chain's stages to
    rebuild their halos.  Returns c64 [..., (len - start) * L / M]."""
    planes = torch.stack([x.real, x.imag], dim=-2)
    _, y = res(planes[..., start - res.hist_len:start], planes[..., start:])
    return torch.complex(y[..., 0, :], y[..., 1, :])


# ---------------------------------------------------------------------------
# the audio bank (K2 from zero lp-DC state + tone-sum correction)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def ctcss_corr_consts(k_local: int, ns: int) -> dict:
    """Geometric-phasor sums correcting a zero-lp-DC-state shard's tone
    sums.  The lp DC error in channel ch is delta_ch p^pos (pos = local
    audio index), so the error in the DFT sums (weights e^{-j w_t pos}) is
    delta zeta^pos with zeta_t = p e^{-j w_t}:

      raw_mem[k] += delta_sel * zpow[k] * zc[ns]
      raw_pre[k] += delta_sel * zpow[k] * zc[min(b, ns-1) + 1]

    All host float64 (the JAX package's arithmetic, bit-equal)."""
    w = 2.0 * np.pi * np.asarray(C.CTCSS_FREQS, np.float64) \
        / C.AUDIO_SAMPLERATE
    zeta = _P * np.exp(-1j * w)                            # [38] c128
    zpow = zeta[None, :] ** (ns * np.arange(k_local,
                                            dtype=np.float64))[:, None]
    # zc[m, t] = sum_{j < m} zeta^j   (zc[0] = 0)
    zc = np.concatenate([np.zeros((1, w.shape[0]), np.complex128),
                         np.cumsum(zeta[None, :] **
                                   np.arange(ns,
                                             dtype=np.float64)[:, None],
                                   axis=0)], axis=0)       # [ns+1, 38]
    t_a = k_local * ns
    return dict(zpow=zpow.astype(np.complex64), zc=zc.astype(np.complex64),
                p_t1=float(_P ** (t_a - 1.0)))


def correct_raw_sums(raw_pre, raw_mem, delta_sel, b_loc, k_local: int,
                     ns: int):
    """The zero-lp-DC-state correction of local kernel tone sums:
    raw_pre/raw_mem [..., K_local, 38] c64; delta_sel [..., K_local] f32
    (the delta of each sub-chunk's SELECTED channel); b_loc [..., K_local]
    i32 window boundaries."""
    dev = str(raw_pre.device)
    zpow = _device_const(ctcss_corr_consts, dev, "zpow", k_local, ns)
    zc = _device_const(ctcss_corr_consts, dev, "zc", k_local, ns)
    b_eff = torch.clamp(b_loc, 0, ns - 1).long() + 1       # lanes j <= b
    d_c = delta_sel.to(torch.complex64)[..., None]
    pre = raw_pre + d_c * zpow * zc[b_eff]
    mem = raw_mem + d_c * zpow * zc[ns]
    return pre, mem
