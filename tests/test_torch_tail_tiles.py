"""The CUDA channel tail's tiled arithmetic (K4's tail and K5), on the CPU.

csrc/chan_tail.cu runs the tail in two launches whose tiling the plain
versions do not share: launch A (``tail_decim``) is the 16x decimator as a
polyphase product over taps staged by phase (``staged_decim_taps``), a
block computing DEC_TILE outputs of which the first is only the previous
sample of the discriminator in its epilogue; launch B (``tail_post``) is
the single chain's audio FIR over reversed, front-padded taps
(``staged_fir_taps``) in FIR_SPLIT tap segments, or the dsd upsampler over
its [96][43] phase table, a thread UP_FT frames of one phase.  The CUDA
code has no CPU mode, so these tests hold its tables and a float64 NumPy
emulation of its tiling to the plain versions:

  - the staged decimator taps rebuild ``ChanTail.decim``'s taps exactly,
    and the staged audio FIR the composed FIR;
  - launch A's tiling (blocks of DEC_TILE outputs overlapping by one, the
    window by phase, the mixer entry a thread's, the per-phase FIRs summed
    in phase order, the discriminator against the block's own previous
    output or sig_prev, a ragged last block) equals ``ChanTail.plain``'s
    decimator and ``fm.fm_demod`` at K = 1, 3 and 16, to 1e-5 of the
    demod's peak;
  - launch B's tiling equals ``plain``'s F.conv1d (single) and
    PolyResampler plus clip (dsd) to 1e-5 of the output's peak, and its
    demod_hist' exactly;
  - the source's tile constants equal the Python ones.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
from numpy.lib.stride_tricks import sliding_window_view

from sdr_pmr446_tpu_torch import config as C
from sdr_pmr446_tpu_torch.io import synth
from sdr_pmr446_tpu_torch.kernels import chan_tail as ct
from sdr_pmr446_tpu_torch.kernels.front_end import FrontEnd
from sdr_pmr446_tpu_torch.kernels.pfb_demod import DEMOD_SCALE
from sdr_pmr446_tpu_torch.ops import decode, fm

torch.set_num_threads(2)

SOURCE = Path(ct.__file__).resolve().parent.parent / "csrc" / "chan_tail.cu"
MODES = ["dsd", "single"]
DEC_THREADS = 512
UP_FT, UP_TG = 4, 2


def defines() -> dict:
    return {m[1]: int(m[2]) for m in re.finditer(
        r"^#define (\w+) (\d+)\b", SOURCE.read_text(), re.M)}


def make_tail(mode):
    return ct.ChanTail(mode, channel=5, audio_gain=2.0, device="cpu")


def tail_inputs(mode, k, seed):
    """K6's plain band of block 1 of each chain's capture (an FM tone for
    dsd, channel 5 with a tone for single), and a random carried state."""
    rng = np.random.default_rng(seed)
    n = k * C.SUBCHUNK_IN
    if mode == "dsd":
        idx = np.arange(2 * n)
        msg = 0.5 * np.sin(2 * np.pi * 1000.0 * idx / C.SDR_SAMPLERATE)
        iq = 0.9 * np.exp(2j * np.pi * (2000.0 * np.cumsum(msg) + 300.0 * idx)
                          / C.SDR_SAMPLERATE)[n:]
    else:
        iq = synth.make_scanner_iq(n, channel=5, seed=1, start_sample=n)
    fe = FrontEnd("cu8", device="cpu")
    c = lambda *s: torch.as_tensor(np.asarray(
        rng.standard_normal(s) + 1j * rng.standard_normal(s), np.complex64))
    band = fe.plain(torch.from_numpy(decode.quantize_iq(iq, "cu8")),
                    0.1 * c(), 0.01 * c(), 0.01 * c(fe.hist_len)).band
    tail = make_tail(mode)
    state = (0.1 * c(tail.hb * ct.GL), 0.5 * c(),
             torch.as_tensor(0.1 * rng.standard_normal(tail.dh * ct.DPS),
                             dtype=torch.float32))
    n0 = torch.tensor(13, dtype=torch.int32) if mode == "single" else None
    return tail, band, state, n0


def plain_demod(tail, band, band_hist, sig_prev, n0):
    """Steps 1-3 of ``ChanTail.plain`` (mixer, decimator, discriminator),
    as it runs them: (sig_prev', dem)."""
    hb, nb = band_hist.shape[0], band.shape[1]
    be = torch.cat([torch.view_as_real(band_hist).T, band], dim=-1)
    if tail.mode == "single":
        i = torch.arange(-hb, nb)
        be = torch.view_as_real(torch.complex(be[0], be[1]) * tail.tab[
            torch.remainder(i + n0, ct.PHASE_PERIOD)]).T
    _, y = tail.decim(be[:, :hb], be[:, hb:])
    return fm.fm_demod(sig_prev, torch.complex(y[0], y[1]))


def emulate_decim(tail, band, band_hist, sig_prev, n0):
    """Launch A in float64: (sig_prev', dem, blocks)."""
    kd = tail.kd_staged.numpy().astype(np.float64)          # [16, J]
    j_taps = kd.shape[1]
    hb, nb = band_hist.shape[0], band.shape[1]
    f_out = nb // ct.DEC
    be = np.concatenate([band_hist.numpy().astype(np.complex128),
                         band[0].numpy() + 1j * band[1].numpy()])
    tab = tail.tab.numpy().astype(np.complex128) if tail.mode == "single" \
        else None
    tile, rows = ct.DEC_TILE, ct.DEC_TILE + j_taps
    blocks = -(-f_out // (tile - 1))
    dem = np.full(f_out, np.nan)
    new_prev = None
    for b in range(blocks):
        fs = (tile - 1) * b - 1
        base = hb - (ct.DEC * j_taps - 1) + ct.DEC * fs
        j = np.arange(ct.DEC * rows)
        e = base + j
        inside = (e >= 0) & (e < hb + nb)
        x = np.where(inside, be[np.clip(e, 0, hb + nb - 1)], 0.0)
        if tab is not None:
            # one table entry a thread: thread t holds j = t (mod 512)
            ph0 = (int(n0) - hb) % ct.PHASE_PERIOD
            ph = (ph0 + base + j % DEC_THREADS) & (ct.PHASE_PERIOD - 1)
            np.testing.assert_array_equal(
                ph[inside], (int(n0) + e[inside] - hb) % ct.PHASE_PERIOD)
            x = x * tab[ph]
        win = x.reshape(rows, ct.DEC).T                       # [phase, m]
        acc = np.einsum("poj,pj->po",
                        sliding_window_view(win, j_taps, axis=1)[:, :tile],
                        kd)
        sig = np.zeros(tile, np.complex128)
        for p in range(ct.DEC):                               # phase order
            sig += acc[p]
        o = np.arange(1, tile)
        f = fs + o
        keep = f < f_out
        prev = np.where(f == 0, complex(sig_prev), sig[o - 1])
        dem[f[keep]] = (np.angle(sig[o] * np.conj(prev)) * DEMOD_SCALE)[keep]
        if (f == f_out - 1).any():
            new_prev = sig[f_out - 1 - fs]
    return new_prev, dem, blocks


def emulate_post(tail, demod_hist, dem):
    """Launch B in float64: (demod_hist', out)."""
    dh, f_out = demod_hist.shape[0], dem.shape[0]
    de = np.concatenate([demod_hist.numpy(), dem.numpy()]).astype(np.float64)

    def window(start, n):
        e = start + np.arange(n)
        ok = (e >= 0) & (e < de.shape[0])
        return np.where(ok, de[np.clip(e, 0, de.shape[0] - 1)], 0.0)

    if tail.mode == "single":
        hs = tail.post_staged.numpy().astype(np.float64)
        ntp = hs.shape[0]
        seg = ntp // ct.FIR_SPLIT
        out = np.empty(-(-f_out // ct.FIR_TILE) * ct.FIR_TILE)
        for n0 in range(0, f_out, ct.FIR_TILE):
            w = window(dh - (ntp - 1) + n0, ct.FIR_TILE + ntp)
            tot = np.zeros(ct.FIR_TILE)
            for s in range(ct.FIR_SPLIT):                     # segment order
                q = np.arange(s * seg, (s + 1) * seg)
                tot += (hs[q][None, :] * w[np.arange(ct.FIR_TILE)[:, None]
                                           + q[None, :]]).sum(axis=1)
            out[n0:n0 + ct.FIR_TILE] = tot
        out = out[:f_out]
    else:
        ku = tail.post_staged.numpy().astype(np.float64)     # [96, 43]
        pu = ku.shape[1]
        g_out, fb = f_out // ct.DPS, UP_FT * UP_TG
        out = np.full(g_out * 96, np.nan)
        p = np.arange(96)
        for g0 in range(0, g_out, fb):
            w = window(dh - (pu - 1) + ct.DPS * g0,
                       ct.DPS * (fb - 1) + 24 + pu)
            for gl in range(UP_TG):
                for r in range(UP_FT):
                    g = g0 + UP_FT * gl + r
                    if g >= g_out:
                        continue
                    off = ct.DPS * (UP_FT * gl + r) + (p * ct.DPS) // 96
                    v = (ku * w[off[:, None] + np.arange(pu)[None, :]]).sum(1)
                    out[g * 96 + p] = np.clip(v, -32768.0, 32767.0)
    return de[f_out:], out


# ------------------------------------------------------------ the tables

@pytest.mark.parametrize("mode", MODES)
def test_staged_decim_taps_rebuild_the_decimator(mode):
    """Row p of the staged table holds kd'[16 j + p], kd' the decimator's
    taps as applied, front-padded to 16 J: the same f32 values, moved."""
    tail = make_tail(mode)
    kd = tail.kd_staged.numpy()
    dec, j_taps = kd.shape
    assert dec == ct.DEC and j_taps % ct.TILE_G == 0
    assert j_taps <= ct.DEC_JMAX
    flat = kd.T.reshape(-1)
    want = tail.decim.weight.reshape(-1).numpy()
    pad = flat.shape[0] - want.shape[0]
    assert 0 <= pad < ct.DEC * ct.TILE_G
    np.testing.assert_array_equal(flat[pad:], want)
    assert not flat[:pad].any()


def test_staged_fir_taps_rebuild_the_audio_fir():
    """The single chain's staged FIR is the composed FIR x gain, reversed
    and front-padded to FIR_SPLIT segments of a whole TILE_G."""
    tail = make_tail("single")
    hs, h = tail.post_staged.numpy(), tail.post_taps.numpy()
    assert hs.shape[0] % (ct.FIR_SPLIT * ct.TILE_G) == 0
    assert hs.shape[0] <= ct.MAX_FIR_TAPS
    pad = hs.shape[0] - h.shape[0]
    np.testing.assert_array_equal(hs[pad:], h[::-1])
    assert not hs[:pad].any()


# --------------------------------------------------- launch A: decimator

@pytest.mark.parametrize("k", [1, 3, 16])
@pytest.mark.parametrize("mode", MODES)
def test_decim_tiling_matches_plain(mode, k):
    """Launch A's tiling on K6's band from a random state equals the plain
    decimator and discriminator: dem to 1e-5 of its peak at every sample,
    sig_prev' likewise (K = 1 and 3: 10 and 29 blocks, the last ragged)."""
    tail, band, (band_hist, sig_prev, _), n0 = tail_inputs(mode, k, k)
    want_prev, want = plain_demod(tail, band, band_hist, sig_prev, n0)
    got_prev, got, blocks = emulate_decim(tail, band, band_hist, sig_prev, n0)
    f_out = band.shape[1] // ct.DEC
    assert blocks == -(-f_out // (ct.DEC_TILE - 1))
    assert not np.isnan(got).any()
    peak = np.max(np.abs(want.numpy()))
    assert np.max(np.abs(got - want.numpy())) < 1e-5 * peak
    assert abs(got_prev - complex(want_prev)) < 1e-5 * abs(complex(want_prev))


# ------------------------------------------------ launch B: post filters

@pytest.mark.parametrize("k", [1, 3, 16])
@pytest.mark.parametrize("mode", MODES)
def test_post_tiling_matches_plain(mode, k):
    """Launch B's tiling on the plain demod equals ``plain``'s post filter
    (single: F.conv1d of the composed FIR; dsd: PolyResampler x32767 and
    the clip) to 1e-5 of the output's peak; demod_hist' exactly."""
    tail, band, (band_hist, sig_prev, demod_hist), n0 = tail_inputs(
        mode, k, 100 + k)
    _, dem = plain_demod(tail, band, band_hist, sig_prev, n0)
    ref = tail.plain(band, band_hist, sig_prev, demod_hist, n0)
    new_dh, out = emulate_post(tail, demod_hist, dem)
    np.testing.assert_array_equal(new_dh.astype(np.float32),
                                  ref.demod_hist.numpy())
    want = ref.out.numpy()
    assert out.shape == want.shape and not np.isnan(out).any()
    assert np.max(np.abs(out - want)) < 1e-5 * np.max(np.abs(want))


# ------------------------------------------------------ tile constants

@pytest.mark.parametrize("mode", MODES)
def test_source_tile_constants_match_the_tables(mode):
    """The kernels read tables the Python side builds, in tiles the source
    fixes: shapes and limits must agree (the CPU cannot compile it)."""
    got = defines()
    for name in ("DEC", "TILE_R", "TILE_G", "DEC_TILE", "DEC_JMAX",
                 "FIR_SPLIT", "FIR_TILE", "MAX_FIR_TAPS"):
        assert got[name] == getattr(ct, name), name
    assert got["PHASES"] == ct.PHASE_PERIOD
    assert got["DEC_THREADS"] == DEC_THREADS == 32 * ct.DEC
    assert DEC_THREADS % ct.PHASE_PERIOD == 0
    assert got["DEC_TILE"] == 32 * ct.TILE_R == got["FIR_TILE"]
    assert got["DEC_ROW"] >= ct.DEC_TILE + ct.DEC_JMAX
    assert got["DEC_ROW"] % 8 == 4
    assert got["FIR_THREADS"] == 32 * ct.FIR_SPLIT
    assert (got["UP_L"], got["UP_M"]) == (96, ct.DPS)
    assert (got["UP_FT"], got["UP_TG"]) == (UP_FT, UP_TG)
    assert got["UP_THREADS"] == 96 * UP_TG
    tail = make_tail(mode)
    hb, dh = tail.hb * ct.GL, tail.dh * ct.DPS
    j_taps = tail.kd_staged.shape[1]
    assert hb >= ct.DEC * j_taps - 1
    width = tail.post_staged.shape[-1]
    assert dh >= width - 1
    if mode == "dsd":
        assert tail.post_staged.shape == (96, width)
        assert width <= got["UP_MAX_P"]
    else:
        assert width <= got["MAX_FIR_TAPS"]
