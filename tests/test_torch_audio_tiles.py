"""The CUDA audio bank's tiled arithmetic (K2 / K8), held on the CPU.

csrc/audio_bank.cu computes the two composed FIRs as a register-tiled
product over a staged tap table (``audio_bank.staged_taps``) with the lp
DC blocker's chunk-local response in the FIR's epilogue, and K2's CTCSS
sums with a phase stepped in 32-bit integers.  The CUDA code has no CPU
mode, so these tests hold its tables and a plain-torch emulation of its
arithmetic to the plain versions, in all four tap configurations:

  - the staged table rebuilds the composed FIRs exactly (reversed, padded
    to whole AB_G, split at Ll into the audio-only region and the
    interleaved region of both);
  - the tiled FIR pair (tiles of AB_TILE outputs, window sample j of a
    tile = xe[n0 + H - (PA + Ll - 1) + j], each output summed over the
    table taps in order, zeros past the block) equals ``apply_plain`` at
    K = 1 and 3, whose F = 1225 and 3675 end in a partial tile: audio
    within 1e-5, lp within 1e-6;
  - the fused DC epilogue (per tile, per thread's AB_R samples from zero
    state in double, composed over the 8 threads of a DC_L chunk, the
    sample before the tile's first the lp output n0 - 1 summed from the
    same window, or dc_x on tile 0; then the chunk carries) equals
    ``iir.dc_blocker_apply`` on the plain lp;
  - the CTCSS phase stepped by (32 * 10 f) mod 125000 equals the exact
    (10 f n) mod 125000 at every sample, and the lane-strided sums equal
    ``ctcss_sums_plain``;
  - the header's tile constants equal the Python ones.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from sdr_pmr446_tpu_torch import config as C
from sdr_pmr446_tpu_torch.kernels import audio_bank as ab
from sdr_pmr446_tpu_torch.kernels.front_end import DC_L, P_L, dc_powers
from sdr_pmr446_tpu_torch.ops import iir

torch.set_num_threads(2)

NS = C.SUBCHUNK_AUDIO
NCH = C.NUM_CHANNELS
CONFIGS = [(False, False), (False, True), (True, False), (True, True)]
HEADER = Path(ab.__file__).resolve().parent.parent / "csrc" / "audio_bank.cu"


def defines() -> dict:
    return {m[1]: int(m[2]) for m in re.finditer(
        r"^#define (\w+) (\d+)\b", HEADER.read_text(), re.M)}


def inputs(bank, k, seed):
    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    return (f32(0.1 * rng.standard_normal((NCH, bank.hist))),
            f32(0.01 * rng.standard_normal(NCH)),
            f32(0.01 * rng.standard_normal(NCH)),
            f32(0.3 * rng.standard_normal((NCH, k * NS))),
            torch.tensor(4.0))


def regions(bank):
    """(TA [PA + PB], TL [PB]) from the staged table's two regions."""
    tab, pa, pb = bank.taps_staged, bank.pa, bank.pb
    b = tab[pa:].reshape(-1, 2, 4)
    return torch.cat([tab[:pa], b[:, 0].reshape(-1)]), b[:, 1].reshape(-1)


def windows(bank, hist, demod):
    """[tiles, 16, AB_TILE + PA + PB + 4] f32: each tile's window, zero
    outside [hist | demod], and each tile's first output n0."""
    f = demod.shape[1]
    ll = bank.taps_lp.shape[0]
    xe = torch.cat([hist, demod], dim=1)
    h = bank.hist
    span = ab.AB_TILE + bank.pa + bank.pb + 4
    out, starts = [], list(range(0, f, ab.AB_TILE))
    for n0 in starts:
        s0 = n0 + h - (bank.pa + ll - 1)
        idx = torch.arange(s0, s0 + span)
        ok = (idx >= 0) & (idx < h + f)
        out.append(torch.where(ok, xe[:, idx.clamp(0, h + f - 1)],
                               torch.zeros(())))
    return torch.stack(out), starts


def tiled_fir(bank, hist, demod, gain):
    """The FIR pair as ab_fir computes it: per tile, output t sums
    TA[q] win[t + q] over q in order (lp: TL over region B, from 0), f32;
    then audio = sum * gain.  Returns (audio, lp, lp before each tile)."""
    f = demod.shape[1]
    ta, tl = regions(bank)
    pa = bank.pa
    win, starts = windows(bank, hist, demod)
    t = ab.AB_TILE
    a = torch.zeros(win.shape[:2] + (t,))
    lp = torch.zeros_like(a)
    for q in range(ta.shape[0]):
        w = win[..., q:q + t]
        a = a + ta[q] * w
        if q >= pa:
            lp = lp + tl[q - pa] * w
    # the lp output n0 - 1: region B against window q - 1
    prev = torch.zeros(win.shape[:2])
    for q in range(pa, ta.shape[0]):
        prev = prev + tl[q - pa] * win[..., q - 1]
    cat = lambda v: v.permute(1, 0, 2).reshape(NCH, -1)[:, :f]
    return cat(a) * gain, cat(lp), prev, starts


@pytest.mark.parametrize("case", CONFIGS, ids=lambda c: f"lp{int(c[0])}"
                         f"de{int(c[1])}")
def test_staged_taps_rebuild_the_fir_pair(case):
    bank = ab.AudioBank(*case, device="cpu")
    la, ll = bank.taps_audio.shape[0], bank.taps_lp.shape[0]
    pa, pb = bank.pa, bank.pb
    assert pa % ab.AB_G == 0 and pb % ab.AB_G == 0
    assert pa - (la - ll) in range(ab.AB_G) and pb - ll in range(ab.AB_G)
    assert bank.taps_staged.shape == (pa + 2 * pb,)
    ta, tl = regions(bank)
    pad_a = pa - (la - ll)
    # region A's head and region B's tail are zeros; between, the FIRs
    # reversed, the same f32 values
    assert torch.equal(ta[:pad_a], torch.zeros(pad_a))
    assert torch.equal(ta[pad_a:pad_a + la], torch.flip(bank.taps_audio, [0]))
    assert torch.equal(ta[pad_a + la:], torch.zeros(pb - ll))
    assert torch.equal(tl[:ll], torch.flip(bank.taps_lp, [0]))
    assert torch.equal(tl[ll:], torch.zeros(pb - ll))


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("case", CONFIGS, ids=lambda c: f"lp{int(c[0])}"
                         f"de{int(c[1])}")
def test_tiled_fir_matches_apply_plain(case, k):
    bank = ab.AudioBank(*case, device="cpu")
    hist, _, _, demod, gain = inputs(bank, k, 30 + k)
    assert demod.shape[1] % ab.AB_TILE        # a partial last tile
    want = bank.apply_plain(hist, demod, gain)
    audio, lp, _, _ = tiled_fir(bank, hist, demod, gain)
    np.testing.assert_allclose(audio.numpy(), want.audio.numpy(), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(lp.numpy(), want.lp.numpy(), rtol=0,
                               atol=1e-6)


def dc_epilogue(bank, hist, dc_x, dc_y, demod, gain):
    """ab_fir<true>'s epilogue, the carry scan and the fix-up: lp_dcb and
    (dc_x', dc_y').  The epilogue runs 8 threads a DC_L chunk: each from
    zero state over its AB_R samples in double, x[-1] the sample before
    (dc_x before the block, the lp output n0 - 1 summed from the window
    before any other tile), then its response plus p^(j+1) times the
    chunk's response just before it, composed over the chunk's threads."""
    f = demod.shape[1]
    r_ = ab.AB_R
    p, g = 1.0 - C.DC_BLOCK_ALPHA, (2.0 - C.DC_BLOCK_ALPHA) / 2.0
    _, lp, prev, starts = tiled_fir(bank, hist, demod, gain)
    chunks = -(-f // DC_L)
    x = torch.nn.functional.pad(lp, (0, chunks * DC_L - f)).double()
    x = x.reshape(NCH, -1, r_)                      # [16, threads, AB_R]
    xp = torch.cat([torch.zeros(NCH, 1), x[:, :-1, -1]], dim=1)
    for i, n0 in enumerate(starts):
        xp[:, n0 // r_] = (dc_x if n0 == 0 else prev[i]).double()
    y = torch.zeros(NCH, x.shape[1], dtype=torch.float64)
    own = torch.zeros_like(x)
    for j in range(r_):
        y = p * y + g * (x[:, :, j] - xp)
        own[:, :, j] = y
        xp = x[:, :, j]
    ends = own[:, :, -1].reshape(NCH, chunks, DC_L // r_)
    y_in = torch.zeros_like(ends)
    for u in range(1, DC_L // r_):
        y_in[:, :, u] = p ** r_ * y_in[:, :, u - 1] + ends[:, :, u - 1]
    pw = torch.tensor([p ** (j + 1) for j in range(r_)], dtype=torch.float64)
    local = (own + y_in.reshape(NCH, -1, 1) * pw).float()
    local = local.reshape(NCH, chunks, DC_L)
    # each chunk's end: its last sample, or the block's
    last = torch.clamp(f - 1 - torch.arange(chunks) * DC_L, max=DC_L - 1)
    yend = local[:, torch.arange(chunks), last].double()
    carry = torch.zeros(NCH, chunks, dtype=torch.float64)
    c = dc_y.double()
    for i in range(chunks):
        carry[:, i] = c.float().double()
        c = P_L * c + yend[:, i]
    pj = torch.from_numpy(dc_powers())
    lp_dcb = (local + carry.float()[:, :, None] * pj).reshape(NCH, -1)[:, :f]
    return lp_dcb, lp[:, -1], lp_dcb[:, -1]


@pytest.mark.parametrize("case", CONFIGS, ids=lambda c: f"lp{int(c[0])}"
                         f"de{int(c[1])}")
def test_fused_dc_epilogue_matches_the_dc_blocker(case):
    bank = ab.AudioBank(*case, device="cpu")
    hist, dc_x, dc_y, demod, gain = inputs(bank, 3, 40)
    lp_dcb, ndx, ndy = dc_epilogue(bank, hist, dc_x, dc_y, demod, gain)
    lp = bank.apply_plain(hist, demod, gain).lp
    (wdx, wdy), want = iir.dc_blocker_apply((dc_x, dc_y), lp,
                                            C.DC_BLOCK_ALPHA)
    peak = want.abs().max().item()
    assert (lp_dcb - want).abs().max().item() < 2e-6 * peak
    assert (ndx - wdx).abs().max().item() < 2e-6 * wdx.abs().max().item()
    assert (ndy - wdy).abs().max().item() < 2e-6 * peak
    o = bank.apply_dc_plain(hist, dc_x, dc_y, demod, gain)
    assert (lp_dcb - o.lp_dcb).abs().max().item() < 2e-6 * peak


def test_ctcss_phase_steps_exactly():
    """ab_ctcss: lane l of warp s of a tone starts at (10 f (k ns + 32 s +
    l)) mod P in 64 bits and adds (32 CT_SPLIT 10 f) mod P in 32, wrapping
    once: the exact phase at every sample of every sub-chunk of a K = 40
    block, every tone."""
    period = ab.PHASE_PERIOD
    split = defines()["CT_SPLIT"]
    f10 = ab.tone_units().astype(np.int64)[:, None]
    lane = np.arange(32 * split, dtype=np.int64)[None, :]
    step = (32 * split * f10) % period
    for kk in (0, 1, 17, 39):
        base = kk * NS
        r = (f10 * (base + lane)) % period
        for i in range(0, NS, 32 * split):
            n = base + i + lane
            assert np.array_equal(r, (f10 * n) % period)
            assert r.max() < period and (r + step).max() < 2 ** 31
            r = r + step
            r = np.where(r >= period, r - period, r)


def test_ctcss_lane_sums_match_plain():
    """ab_ctcss's arithmetic: per lane of each of a tone's CT_SPLIT warps,
    samples 32 (s + CT_SPLIT j) + lane in order, the stepped phase r moved
    to [-P/2, P/2) and scaled by 2 / P in f32, through sin / cos of pi
    times that; a shuffle tree per warp, the warps added
    in order; against ctcss_sums_plain within 3e-5 of the peak
    (chip_smoke's gate)."""
    rng = np.random.default_rng(8)
    k = 3
    split = defines()["CT_SPLIT"]
    lpdc = torch.from_numpy((0.2 * rng.standard_normal((NCH, k * NS)))
                            .astype(np.float32))
    b_arr = torch.tensor([NS - 1, 0, 700], dtype=torch.int32)
    sel = torch.tensor([3, 15, 0], dtype=torch.int32)
    f10 = torch.from_numpy(ab.tone_units())
    want_pre, want_mem = ab.ctcss_sums_plain(lpdc, b_arr, sel, NS, f10)
    period = ab.PHASE_PERIOD
    lanes = torch.arange(32)
    i0 = (32 * torch.arange(split)[:, None] + lanes).reshape(-1)
    got = {"pre": [], "mem": []}
    for kk in range(k):
        x = lpdc[int(sel[kk]), kk * NS:(kk + 1) * NS]
        rows = {"pre": [], "mem": []}
        for ft in f10.long().tolist():
            r = (ft * (kk * NS + i0)) % period
            acc = {n: torch.zeros(32 * split, dtype=torch.complex64)
                   for n in rows}
            for j in range(0, NS, 32 * split):
                i = j + i0
                v = torch.where(i < NS, x[i.clamp(max=NS - 1)],
                                torch.zeros(()))
                rs = torch.where(r < period // 2, r, r - period)
                ang = (rs.float() * (2.0 / period)).double() * np.pi
                e = torch.complex(v * torch.cos(ang).float(),
                                  -v * torch.sin(ang).float())
                acc["mem"] = acc["mem"] + e
                acc["pre"] = acc["pre"] + torch.where(
                    i <= b_arr[kk], e, torch.zeros((), dtype=e.dtype))
                r = r + (32 * split * ft) % period
                r = torch.where(r >= period, r - period, r)
            for name, a in acc.items():
                a = a.reshape(split, 32)
                for o in (16, 8, 4, 2, 1):
                    a = a + a[:, lanes ^ o]
                tot = a[0, 0]
                for s_ in range(1, split):
                    tot = tot + a[s_, 0]
                rows[name].append(tot)
        for name in rows:
            got[name].append(torch.stack(rows[name]))
    peak = want_mem.abs().max().item()
    for name, want in (("pre", want_pre), ("mem", want_mem)):
        err = (torch.stack(got[name]) - want).abs().max().item()
        assert err < 3e-5 * peak, name


def test_header_tile_constants_match_the_tables():
    """The CUDA tile reads tables the Python side builds: their shapes must
    agree (the CPU cannot compile the kernel)."""
    d = defines()
    assert (d["AB_R"], d["AB_TILE"], d["AB_G"], d["MAX_TAPS"]) == (
        ab.AB_R, ab.AB_TILE, ab.AB_G, ab.MAX_TAPS)
    assert d["AB_TILE"] == d["AB_R"] * d["AB_THREADS"]
    assert d["AB_TILE"] % DC_L == 0
    assert d["NTONES"] == C.CTCSS_NUM_FREQS
    assert d["PHASE_PERIOD"] == ab.PHASE_PERIOD
    assert d["CT_NS_MAX"] >= NS
    assert d["CT_TONES"] * d["CT_SPLIT"] * 32 <= 1024
    assert d["AB_WIN_ROWS"] * d["AB_R"] >= d["AB_TILE"] + d["AB_QMAX"] + 4
    for case in CONFIGS:
        bank = ab.AudioBank(*case, device="cpu")
        assert bank.pa + bank.pb <= d["AB_QMAX"]
        assert bank.taps_staged.numel() <= d["AB_TAB"]
        assert bank.taps_audio.shape[0] <= min(d["MAX_TAPS"], bank.hist)
