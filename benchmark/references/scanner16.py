"""The plain reference of the 16-channel PMR446 scanner, and its comparison.

What the scanner computes, written out in PyTorch and NumPy from the
specification (benchlib/design.py) and nothing of the program:

  1. cu8 bytes -> IQ, (u - 127.5) / 127.5;
  2. the IQ DC blocker g (1 - z^-1) / (1 - p z^-1), p = 1 - 0.0005;
  3. the 25/128 polyphase resampler, y[j] = sum_i x[q - i] h[i L + r];
  4. the mixer exp(+j 15/16 pi t) and the 16-channel analysis PFB: frame f
     of channel k is e^{-j w_k 15} sum_m h[m] e^{j w_k m} x~[16 f + 15 - m];
  5. per 98 ms sub-chunk and channel the RSSI 20 log10(mean |y|);
  6. on every channel, continuously: the discriminator angle(y[n] y*[n-1])
     / (2 pi 0.5), the 377-tap highpass, the 188-sample delay, the lp
     branch (delayed - highpass) and its DC blocker, gain x highpass
     through the 50 us de-emphasis;
  7. per sub-chunk the squelch FSM (tune above the squelch, detune 5 dB
     below it, lock mode start or max) on the RSSI, and on the active
     channel's lp branch the 38-tone CTCSS detector over 2441-sample
     windows (the window's power |sum x[m] e^{-j w m}|^2, detected when the
     mean power > 120 and max / mean > 10), reset at each detune; the
     active channel's audio.

A check runs from a quiet gap: the traffic puts pauses of the whole band
at random points of each capture (traffic/*.json ``gap_every_s``), and in
a sub-chunk of noise alone the scanner detunes from any state, its
detector restarts, and what it carries is the reset state.  So the
reference runs the FSM from its reset state from any point before such a
sub-chunk, and agrees with the program from the sub-chunk after it; its
filters, started from zero ``WARM_SUBCHUNKS`` sub-chunks earlier, agree
too (the longest memory, the lp DC blocker's, decays by e^-0.61 a
sub-chunk).  ``run`` takes the bytes of such a run of sub-chunks and the
first one compared, and returns the outputs from there on.

``precision``: "f64" is the reference; "tf32" is its control, float32
with the operands of every matrix product and convolution rounded to TF32
(10 mantissa bits), as a tensor core would take them.
"""

from __future__ import annotations

import math

import numpy as np
import scipy.signal as sig
import torch

from benchlib import design as D

NCH = D.NUM_CHANNELS
NS = D.SUBCHUNK_AUDIO
#: discriminator samples whose reference angle lies this close to +-pi are
#: ambiguous: a float32 program may land on the other side of the cut and
#: read 2 units off (see ``_mask_after``).  A float32 angle is off by
#: ~1e-8 / |y| rad; 1e-3 rad covers |y| down to ~1e-5, 1/400 of the noise
#: floor's typical |y|, and leaves out ~1e-3 of a noise-only channel's
#: samples with what they reach
CUT_MARGIN_RAD = 1e-3
#: audio samples after an ambiguous discriminator sample that it reaches:
#: the highpass (377 taps) and 16 de-emphasis taps (0.0146^16 < 1e-29)
CUT_REACH = D.HP_TAPS + 16
#: sub-chunks the filters run from zero state before the first compared
#: one: the lp DC blocker's start decays by e^-14.7 (4e-7) over them
WARM_SUBCHUNKS = 24


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits (nearest, ties away)."""
    v = x.to(torch.float32).contiguous().view(torch.int32)
    v = (v + 0x1000) & ~0x1FFF
    return v.view(torch.float32)


class Precision:
    def __init__(self, name: str):
        if name not in ("f64", "tf32"):
            raise ValueError(f"precision {name!r}: f64 or tf32")
        self.name = name
        self.tf32 = name == "tf32"
        self.real = torch.float32 if self.tf32 else torch.float64
        self.complex = torch.complex64 if self.tf32 else torch.complex128
        self.np_real = np.float32 if self.tf32 else np.float64
        self.np_complex = np.complex64 if self.tf32 else np.complex128

    def cmatmul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Complex a @ b (real operands become complex)."""
        if not self.tf32:
            return a.to(self.complex) @ b.to(self.complex)
        ar, ai = _parts(a)
        br, bi = _parts(b)
        ar, ai, br, bi = map(_tf32, (ar, ai, br, bi))
        return torch.complex(ar @ br - ai @ bi, ar @ bi + ai @ br)

    def fir(self, x: torch.Tensor, taps: np.ndarray) -> torch.Tensor:
        """Causal FIR from zero history along the last axis of real x."""
        n, t = x.shape[-1], len(taps)
        if not self.tf32:
            size = 1 << (n + t - 1).bit_length()
            h = torch.as_tensor(taps, dtype=torch.float64, device=x.device)
            y = torch.fft.irfft(torch.fft.rfft(x, size) * torch.fft.rfft(
                h, size), size)
            return y[..., :n]
        w = _tf32(torch.as_tensor(taps[::-1].copy(), device=x.device))
        xe = torch.nn.functional.pad(_tf32(x), (t - 1, 0))
        return torch.nn.functional.conv1d(
            xe.reshape(-1, 1, n + t - 1), w.reshape(1, 1, t)).reshape(x.shape)


def _parts(z: torch.Tensor):
    if z.is_complex():
        return z.real.to(torch.float32), z.imag.to(torch.float32)
    return z.to(torch.float32), torch.zeros_like(z, dtype=torch.float32)


def _lfilter(b, a, x: torch.Tensor, prec: Precision) -> torch.Tensor:
    """A first-order section from zero state along the last axis (host)."""
    dt = prec.np_complex if x.is_complex() else prec.np_real
    y = sig.lfilter(np.asarray(b, dt), np.asarray(a, dt),
                    x.cpu().numpy().astype(dt), axis=-1)
    return torch.as_tensor(y.astype(dt), device=x.device)


def _mask_after(amb: torch.Tensor, reach: int) -> torch.Tensor:
    """amb bool [..., T] -> True at every sample within ``reach`` samples
    after (and at) a True one."""
    c = torch.cumsum(amb.to(torch.int64), -1)
    lag = torch.nn.functional.pad(c, (reach, 0))[..., :c.shape[-1]]
    return (c - lag) > 0


def front(wire: np.ndarray, prec: Precision, device) -> tuple:
    """Steps 1-6 over one run of blocks from zero state: (rssi [n_sub, 16],
    lp branch [16, T], audio before gain [16, T], ambiguous [16, T])."""
    u = torch.as_tensor(wire, device=device).to(prec.real)
    x = torch.complex((u[0::2] - 127.5) / 127.5, (u[1::2] - 127.5) / 127.5)
    b, a = D.dc_coeffs()
    x = _lfilter(b, a, x, prec)
    # resampler: frames of M input samples, L outputs a frame
    kmat = torch.as_tensor(D.resampler_matrix(), device=device)
    p_len = D.resampler_taps().shape[0] // D.RESAMP_L
    xe = torch.cat([torch.zeros(p_len - 1, dtype=x.dtype, device=device), x])
    frames = x.shape[0] // D.RESAMP_M
    need = (frames - 1) * D.RESAMP_M + kmat.shape[1]
    win = xe[:need].unfold(0, kmat.shape[1], D.RESAMP_M)
    band = prec.cmatmul(win, kmat.T).reshape(-1)
    # mixer (period 32 in t) and PFB
    t = torch.arange(band.shape[0], device=device) % 32
    mix = torch.exp(1j * D.MIX_OMEGA * t.to(torch.float64)).to(prec.complex)
    h = D.pfb_prototype()
    n_taps = h.shape[0]
    k = np.arange(NCH)
    emk = np.exp(1j * 2 * np.pi * np.outer(k, np.arange(n_taps)) / NCH)
    kern = torch.as_tensor((h * emk)[:, ::-1].copy(), device=device)
    xm = torch.cat([torch.zeros(n_taps - NCH, dtype=band.dtype,
                                device=device), band * mix])
    n_fr = band.shape[0] // NCH
    chan = prec.cmatmul(xm.unfold(0, n_taps, NCH)[:n_fr], kern.T)
    phase = torch.as_tensor(np.exp(-1j * 2 * np.pi * k * (NCH - 1) / NCH),
                            device=device).to(chan.dtype)
    chan = (chan * phase).T                                    # [16, F]
    n_sub = n_fr // NS
    mag = chan.abs().reshape(NCH, n_sub, NS).mean(-1)
    rssi = (20.0 * torch.log10(torch.clamp(mag, min=1e-30))).T
    # discriminator, highpass, delay, lp branch and its DC blocker
    prev = torch.cat([torch.zeros(NCH, 1, dtype=chan.dtype, device=device),
                      chan[:, :-1]], -1)
    d = chan * torch.conj(prev)
    ang = torch.atan2(d.imag, d.real)
    amb = ang.abs() > math.pi - CUT_MARGIN_RAD
    demod = (ang / (2.0 * math.pi * D.FM_KF)).to(prec.real)
    hp = prec.fir(demod, D.ctcss_hp_taps())
    delayed = torch.nn.functional.pad(demod, (D.CTCSS_DELAY, 0))[
        :, :demod.shape[-1]]
    b, a = D.dc_coeffs()
    lp = _lfilter(b, a, delayed - hp, prec)
    return rssi, lp, hp, _mask_after(amb, CUT_REACH)


def _tables(dt):
    w = 2.0 * np.pi * np.asarray(D.CTCSS_FREQS) / D.AUDIO_RATE
    e0 = np.exp(-1j * np.outer(w, np.arange(NS))).astype(dt)
    u = np.exp(-1j * np.outer(w, np.arange(D.CTCSS_BLOCK))).astype(dt)
    return e0, u, np.exp(1j * w * D.CTCSS_BLOCK).astype(dt)


FIELDS = ("active_chan", "rel_rssi", "ev_tuned", "ev_detuned", "ev_changed",
          "ev_prev_chan", "ev_new_chan", "ct_detected", "ct_max_idx",
          "ct_freq", "ev_ct_acquired", "ev_ct_changed", "ev_ct_lost")


def fsm(rssi: np.ndarray, lp: np.ndarray, squelch: float, lock_max: bool,
        dt) -> dict:
    """The squelch FSM and CTCSS detector from the reset state, one
    sub-chunk at a time: rssi [n_sub, 16] dB, lp [16, n_sub * NS]; every
    field of FIELDS [n_sub]."""
    e0, u_tab, wrap = _tables(np.complex64 if dt == np.float32
                              else np.complex128)
    freqs = np.asarray(D.CTCSS_FREQS, dtype=np.float32)
    st, act, cnt, det, tidx, tfreq = 0, -1, 0, False, 0, 0.0
    cc = np.zeros(len(D.CTCSS_FREQS), e0.dtype)
    rows = []
    for k in range(rssi.shape[0]):
        r = rssi[k]
        max_ch = int(np.argmax(r))
        rel = float(r[max_ch] - np.mean(r))
        scanning = st == 0
        tune = scanning and rel > squelch
        change = (not scanning) and lock_max and act != max_ch
        prev_chan = act
        act1 = max_ch if (tune or change) else act
        detune = (not scanning) and rel < squelch - D.HYSTERESIS_DB
        act2 = -1 if detune else act1
        st = 1 if tune else (0 if detune else st)
        if detune:
            cnt, cc, tidx, tfreq = 0, np.zeros_like(cc), 0, 0.0
        det_r = det and not detune
        tidx_r = tidx
        det = det_r
        active = act2 >= 0
        acq = chg = lost = False
        if active:
            x = lp[act2, k * NS:(k + 1) * NS]
            z = e0 * x[None, :] * u_tab[:, cnt][:, None]
            b = D.CTCSS_BLOCK - 1 - cnt
            pre = np.arange(NS) <= b
            y = cc + z[:, pre].sum(-1)
            if b < NS:
                power = y.real * y.real + y.imag * y.imag
                avg = float(np.mean(power))
                tidx = int(np.argmax(power))
                det = (avg > D.CTCSS_AVG_THRESH and float(power[tidx])
                       / max(avg, 1e-30) > D.CTCSS_RATIO_THRESH)
                cc = (z[:, ~pre] * wrap[:, None]).sum(-1)
            else:
                cc = y
            cnt = (cnt + NS) % D.CTCSS_BLOCK
            tfreq = float(freqs[tidx])
            acq = det and not det_r
            chg = det and det_r and tidx != tidx_r
            lost = (not det) and det_r
        act = act2
        rows.append((act2, rel, tune, detune, change, prev_chan, act1, det,
                     tidx, tfreq, acq, chg, lost))
    return {f: np.asarray(col) for f, col in zip(FIELDS, zip(*rows))}


def run(wire: np.ndarray, compare_from: int, args: dict,
        precision: str = "f64", device="cpu") -> dict:
    """The outputs of sub-chunks ``compare_from`` on of the cu8 bytes
    ``wire``, from zero state at its start: every field of FIELDS and
    ``rssi_db`` [n, 16], ``audio`` [n, NS] of the active channel,
    ``audio_valid`` [n] and ``ambiguous`` [n, NS] (audio samples within
    reach of a discriminator sample on the branch cut).  The sub-chunk
    before ``compare_from``, if there is one, has to be quiet: the relative
    RSSI under the detune level, where any state resets."""
    prec = Precision(precision)
    rssi, lp, hp, amb = front(np.asarray(wire).reshape(-1), prec, device)
    audio = _lfilter(*D.deemph_coeffs(), hp * float(args["audio_gain"]),
                     prec)
    n_sub = rssi.shape[0]
    k = int(compare_from)
    squelch = float(args["squelch_db"])
    out = fsm(rssi.cpu().numpy(), lp.cpu().numpy(), squelch,
              args["lock_mode"] == "max", prec.np_real)
    if k > 0 and not out["rel_rssi"][k - 1] < squelch - D.HYSTERESIS_DB:
        raise ValueError(f"sub-chunk {k - 1} of the check is not quiet: "
                         f"relative RSSI {out['rel_rssi'][k - 1]} dB")
    out = {f: v[k:] for f, v in out.items()}
    sel = np.clip(out["active_chan"], 0, NCH - 1)
    audio = audio.cpu().numpy().reshape(NCH, n_sub, NS)[:, k:]
    amb = amb.cpu().numpy().reshape(NCH, n_sub, NS)[:, k:]
    idx = np.arange(n_sub - k)
    out["rssi_db"] = rssi.cpu().numpy()[k:]
    out["audio"] = audio[sel, idx]
    out["ambiguous"] = amb[sel, idx]
    out["audio_valid"] = out["active_chan"] >= 0
    return out


# ------------------------------------------------------------- comparison
#: fields compared exactly on every sub-chunk (the decisions and events)
EXACT = ("active_chan", "audio_valid", "ev_tuned", "ev_detuned", "ev_changed",
         "ev_prev_chan", "ev_new_chan", "ct_detected", "ev_ct_acquired",
         "ev_ct_changed", "ev_ct_lost")
#: fields that name the detected tone, compared where a tone is detected
#: (the argmax over 38 noise powers means nothing without one, and flips
#: on rounding)
WHEN_DETECTED = ("ct_max_idx", "ct_freq")


def readings(prog: dict, ref: dict) -> dict:
    """The numbers compared for one check: ``decisions`` (sub-chunks whose
    decisions or events differ), ``rssi_gap_db`` (the widest gap of any
    channel's RSSI or of the relative RSSI) and ``audio_err`` (the
    active channel's audio error over its RMS, over the check's tuned
    sub-chunks, ambiguous samples left out; None when never tuned)."""
    bad = np.zeros(len(ref["active_chan"]), bool)
    for f in EXACT:
        bad |= np.asarray(prog[f]).astype(np.float64) != np.asarray(
            ref[f]).astype(np.float64)
    both = np.asarray(prog["ct_detected"], bool) & np.asarray(
        ref["ct_detected"], bool)
    for f in WHEN_DETECTED:
        bad |= both & (np.asarray(prog[f], np.float64)
                       != np.asarray(ref[f], np.float32).astype(np.float64))
    gap = max(float(np.max(np.abs(np.asarray(prog["rssi_db"], np.float64)
                                  - ref["rssi_db"]))),
              float(np.max(np.abs(np.asarray(prog["rel_rssi"], np.float64)
                                  - ref["rel_rssi"]))))
    valid = np.asarray(ref["audio_valid"], bool) & ~bad
    keep = valid[:, None] & ~ref["ambiguous"]
    audio_err = None
    if keep.any():
        r = np.asarray(ref["audio"], np.float64)[keep]
        e = np.asarray(prog["audio"], np.float64)[keep] - r
        audio_err = float(np.sqrt(np.sum(e * e) / max(np.sum(r * r),
                                                      1e-300)))
    return {"decisions": int(bad.sum()), "rssi_gap_db": gap,
            "audio_err": audio_err}


def worst(reads: list) -> dict:
    """The worst of each number over the checked blocks."""
    out = {}
    for name in ("decisions", "rssi_gap_db", "audio_err"):
        vals = [r[name] for r in reads if r[name] is not None]
        out[name] = max(vals) if vals else None
    return out
