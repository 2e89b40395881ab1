"""The CUDA filter banks' factored forms, held on the CPU.

The resampler (K9, and the front end of K1, K4 and K6) and the PFB (K7,
and K1) run on the card in a form the plain versions do not use: the
resampler as a product over staged tap rows (``front_end.staged_taps``,
csrc/front_end.cuh), the PFB as 26-tap branch sums, a twiddle per branch
and a 16-point DFT (``pfb_demod.pfb_factors``, csrc/pfb_demod.cuh).  The
CUDA code has no CPU mode, so these tests hold the tables it is given and
a plain-torch emulation of its arithmetic (the segment sums, the radix-2
butterflies) to the plain versions and the JAX builders:

  - the factored PFB tables rebuild the fused kernel CK of JAX's
    ``make_pfb_kernel`` (and the port's) to 1e-12 in float64;
  - the factored PFB equals ``PfbDemod.plain`` on an occupied band over two
    blocks: demod SNR > 100 dB, |y| sums rtol 1e-5;
  - the staged resampler taps rebuild the compact phases exactly and their
    segment-wise product reproduces ``Resampler.plain`` to > 100 dB;
  - the tile constants of the two CUDA headers equal the Python ones that
    build the tables;
  - the DC blocker's chunk-carry scan (csrc/sdr_common.cuh
    dc_carry_kernel: 4 chunks a lane, a shuffle scan over the lanes, tiles
    and warp ranges composed in order) equals the sequential recurrence;
  - every C entry point takes the arguments its ctypes signature passes.
"""

import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from sdr_pmr446_tpu_torch import config as C
from sdr_pmr446_tpu_torch.kernels import build, front_end, pfb_demod
from sdr_pmr446_tpu_torch.kernels.resample_kernel import Resampler
from sdr_pmr446_tpu_torch.ops import decode, fm
from sdr_pmr446_tpu_torch.ops.pfb import make_pfb_kernel
from sdr_pmr446_tpu_torch.taps import design as D

torch.set_num_threads(2)

NS = C.SUBCHUNK_AUDIO
NCH = C.NUM_CHANNELS
CSRC = Path(front_end.__file__).resolve().parent.parent / "csrc"


def snr_db(want, got):
    want = np.asarray(want, np.float64)
    err = np.asarray(got, np.float64) - want
    return 10 * np.log10(np.sum(want ** 2) / max(np.sum(err ** 2), 1e-300))


def occupied_iq(n, step):
    """NBFM on all 16 channels (no channel demodulates pure noise)."""
    from sdr_pmr446_tpu_torch.io import synth
    return sum(synth.make_scanner_iq(
        n, channel=ch, amplitude=0.6 if ch == 5 else 0.2,
        tone_hz=300.0 + 97 * ch, seed=16 * step + ch,
        start_sample=step * n) for ch in range(1, 17)) / 2


def defines(header: str) -> dict:
    text = (CSRC / header).read_text()
    return {m[1]: int(m[2]) for m in re.finditer(
        r"^#define (\w+) (\d+)\b", text, re.M)}


# ------------------------------------------------------------------ the PFB

def test_pfb_factors_rebuild_the_fused_kernel():
    """CK[16 m + r, k] = g[m, r] c[r] w[(k r) % 16], float64, to 1e-12 of
    JAX's make_pfb_kernel and the port's."""
    from sdr_pmr446_tpu.ops.pfb import make_pfb_kernel as jax_make_pfb_kernel
    proto = D.pfb_prototype()
    g, c, w = pfb_demod.pfb_factors(proto)
    assert g.shape == (len(proto) // NCH, NCH) and g.dtype == np.float64
    m, r, k = np.ogrid[:g.shape[0], :NCH, :NCH]
    ck = (g[:, :, None] * c[None, :, None] * w[(k * r) % NCH]).reshape(-1, NCH)
    for want in (jax_make_pfb_kernel(np.asarray(proto)), make_pfb_kernel(proto)):
        assert np.max(np.abs(ck - want)) < 1e-12


def factored_pfb(module, band, pfb_hist, parity):
    """The channel planes c64 [16, F] as csrc/pfb_demod.cuh computes them:
    branch sums of the f32 taps, the f32 twiddle, the radix-2 decimation
    in frequency over the 16 branches (bin bitrev(r) lands on r), the frame
    sign."""
    xe = torch.cat([pfb_hist, torch.complex(band[0], band[1])])
    f = band.shape[1] // NCH
    rows = xe.reshape(-1, NCH).unfold(0, module.pfb_g.shape[0], 1)
    g = module.pfb_g.T                                      # [16, 26]
    v = torch.complex((rows.real * g).sum(-1), (rows.imag * g).sum(-1))
    v = v * module.pfb_c                                    # [F, 16]
    r = torch.arange(NCH)
    for hs in (8, 4, 2, 1):
        upper = (r & hs) != 0
        partner = v[:, r ^ hs]
        tw = torch.where(upper, module.pfb_w[(r & (hs - 1)) * (8 // hs)],
                         torch.ones((), dtype=torch.complex64))
        v = torch.where(upper, (partner - v) * tw, v + partner)
    bitrev = torch.tensor([int(f"{i:04b}"[::-1], 2) for i in range(NCH)])
    y = torch.empty_like(v)
    y[:, bitrev] = v
    sign = 1.0 - 2.0 * ((torch.arange(f) + parity) % 2).to(torch.float32)
    return (y * sign[:, None]).T


def test_factored_pfb_matches_plain():
    """Two blocks of K = 2 from a random state: the factored form's demod
    within 100 dB of PfbDemod.plain's, |y| sums rtol 1e-5, the carried
    state the plain version's."""
    rng = np.random.default_rng(10)
    pd = pfb_demod.PfbDemod(device="cpu")
    fe = front_end.FrontEnd("cs16", device="cpu")
    k, n = 2, 2 * C.SUBCHUNK_IN
    z = torch.zeros((), dtype=torch.complex64)
    fe_state = (z, z, torch.zeros(fe.hist_len, dtype=torch.complex64))
    hist = torch.as_tensor((0.1 * (rng.standard_normal(400)
                                   + 1j * rng.standard_normal(400)))
                           .astype(np.complex64))
    prev = torch.as_tensor((0.1 * (rng.standard_normal(NCH)
                                   + 1j * rng.standard_normal(NCH)))
                           .astype(np.complex64))
    parity = torch.tensor(1, dtype=torch.int32)
    for step in range(2):
        out = fe.plain(torch.from_numpy(decode.quantize_iq(
            occupied_iq(n, step), "cs16")), *fe_state)
        fe_state = out[:3]
        ref = pd.plain(out.band, hist, parity, prev, ns=NS)
        chan = factored_pfb(pd, out.band, hist, int(parity))
        new_prev, demod = fm.fm_demod(prev, chan)
        mag = chan.abs().reshape(NCH, k, NS).sum(-1).T
        assert snr_db(ref.demod.numpy(), demod.numpy()) > 100.0
        np.testing.assert_allclose(mag.numpy(), ref.mag.numpy(), rtol=1e-5)
        assert np.max(np.abs(new_prev.numpy() - ref.prev.numpy())) < 1e-5 * (
            np.max(np.abs(ref.prev.numpy())))
        hist, parity, prev = ref.pfb_hist, ref.parity, ref.prev


# ------------------------------------------------------------ the resampler

def test_staged_taps_rebuild_the_compact_phases():
    """Each phase's 346 taps sit in its half's column from its offset, bit
    for bit; every other entry of the table is zero."""
    kc = front_end.compact_phases(D.resampler_taps(), C.RESAMP_L,
                                  C.RESAMP_M)
    kt = front_end.staged_taps(kc)
    assert kt.shape == (2, front_end.RS_SPLIT * front_end.RS_SEG,
                        front_end.RS_QP) and kt.dtype == np.float32
    offs = [(q * C.RESAMP_M) // C.RESAMP_L for q in range(C.RESAMP_L)]
    used = np.zeros(kt.shape, bool)
    for q in range(C.RESAMP_L):
        h, qq = divmod(q, front_end.RS_Q)
        row = offs[q] - offs[front_end.RS_Q * h]
        np.testing.assert_array_equal(kt[h, row:row + kc.shape[1], qq], kc[q])
        used[h, row:row + kc.shape[1], qq] = True
    assert not np.any(kt[~used])


def staged_product(kt, hist, xr, xi):
    """The band planes [2, nb] as csrc/front_end.cuh's resample_tile sums
    them: per half, per row segment a partial sum, the segments added in
    order."""
    win = torch.cat([torch.view_as_real(hist).T, torch.stack([xr, xi])], -1)
    frames = xr.shape[0] // C.RESAMP_M
    rows = kt.shape[1]
    win = torch.nn.functional.pad(win, (0, front_end.RS_OFF1 + rows))
    band = torch.empty(2, frames, C.RESAMP_L)
    for h in range(2):
        idx = (C.RESAMP_M * torch.arange(frames)[:, None]
               + front_end.RS_OFF1 * h + torch.arange(rows)[None])
        seg = win[:, idx].reshape(2, frames, front_end.RS_SPLIT, -1)
        taps = kt[h].reshape(front_end.RS_SPLIT, -1, front_end.RS_QP)
        parts = torch.einsum("pfsj,sjq->pfsq", seg, taps)
        total = parts[:, :, 0]
        for s in range(1, front_end.RS_SPLIT):
            total = total + parts[:, :, s]
        q0 = front_end.RS_Q * h
        nq = min(front_end.RS_Q, C.RESAMP_L - q0)
        band[:, :, q0:q0 + nq] = total[:, :, :nq]
    return band.reshape(2, -1)


def test_staged_product_matches_resampler_plain():
    """K = 1 of DC-blocked occupied planes from a random history: the
    staged product within 100 dB of Resampler.plain (F.conv1d)."""
    rng = np.random.default_rng(9)
    rs = Resampler(device="cpu")
    iq = occupied_iq(C.SUBCHUNK_IN, 0)
    xr = torch.as_tensor(np.real(iq).astype(np.float32))
    xi = torch.as_tensor(np.imag(iq).astype(np.float32))
    hist = torch.as_tensor((0.1 * (rng.standard_normal(rs.hist_len)
                                   + 1j * rng.standard_normal(rs.hist_len)))
                           .astype(np.complex64))
    _, want = rs.plain(hist, xr, xi)
    got = staged_product(rs.kt, hist, xr, xi)
    assert got.shape == want.shape
    assert snr_db(want.numpy(), got.numpy()) > 100.0


# ------------------------------------------------ the headers' tile constants

@pytest.mark.parametrize("header,names", [
    ("front_end.cuh", ("RS_Q", "RS_QP", "RS_SPLIT", "RS_SEG", "RS_OFF1")),
    ("pfb_demod.cuh", ("PFB_TAPS", "PFB_HIST"))])
def test_header_tile_constants_match_the_tables(header, names):
    """The CUDA tiles read tables the Python side builds: their shapes must
    agree (the CPU cannot compile the headers)."""
    got = defines(header)
    if header == "front_end.cuh":
        for name in names:
            assert got[name] == getattr(front_end, name), name
        assert got["RES_L"] == C.RESAMP_L and got["RES_M"] == C.RESAMP_M
        assert got["RS_P"] == front_end.compact_phases(
            D.resampler_taps(), C.RESAMP_L, C.RESAMP_M).shape[1]
        assert 2 * got["RS_Q"] >= C.RESAMP_L
    else:
        pd = pfb_demod.PfbDemod(device="cpu")
        assert got["PFB_TAPS"] == pd.pfb_g.numel()
        assert got["PFB_HIST"] == pd.hist_len
        assert defines("sdr_common.cuh")["NCH"] == pd.pfb_g.shape[1]


# ------------------------------------------------ the DC blocker's carry scan

def carry_scan(yend, y0, p_l, warps=32, g=4):
    """dc_carry_kernel's two passes over one row, in float64: tiles of 32
    lanes x g chunks, each lane's chunks composed in order, a shuffle scan
    of the lane offsets b (multipliers pL^(g 2^i)), tiles and warp ranges
    composed in order."""
    chunks = len(yend)
    tile = 32 * g
    per = -(-chunks // (tile * warps)) * tile
    pw = [p_l]
    for _ in range(7):
        pw.append(pw[-1] * pw[-1])

    def power(k):
        x = 1.0
        for i in range(8):
            if k & (1 << i):
                x *= pw[i]
        return x

    lane = np.arange(32)

    def tiles(w):
        c0 = min(w * per, chunks)
        c1 = min(c0 + per, chunks)
        for t in range(c0, c1, tile):
            cnt = np.clip(c1 - t - g * lane, 0, g)
            v = [[yend[t + g * l + k] if k < cnt[l] else 0.0 for k in range(g)]
                 for l in lane]
            b = np.zeros(32)
            for l in lane:
                for k in range(cnt[l]):
                    b[l] = p_l * b[l] + v[l][k]
            incl = b.copy()
            for i in range(5):
                up = np.roll(incl, 1 << i)
                incl = np.where(lane >= (1 << i), pw[i + 2] * up + incl, incl)
            below = np.roll(incl, 1)
            below[0] = 0.0
            yield t, v, cnt, b, below, min(31, (c1 - t - 1) // g)

    out = np.empty(chunks)
    maps = []
    for w in range(warps):
        a, bw = 1.0, 0.0
        for _, _, cnt, b, below, last in tiles(w):
            ta = power(g * last + cnt[last])
            a, bw = ta * a, ta * bw + (power(cnt[last]) * below[last] + b[last])
        maps.append((a, bw))
    y = y0
    for w, (a, bw) in enumerate(maps):
        y_in, y = y, a * y + bw
        for t, v, cnt, _, below, last in tiles(w):
            ends = []
            for l in lane:
                yl = power(g * l) * y_in + below[l]
                for k in range(cnt[l]):
                    out[t + g * l + k] = yl
                    yl = p_l * yl + v[l][k]
                ends.append(yl)
            y_in = ends[last]
    return out


@pytest.mark.parametrize("chunks", [1, 33, 766, 1568 * 40])
def test_carry_scan_matches_the_recurrence(chunks):
    """carry[c + 1] = pL carry[c] + yend[c] from y0, in float64: the scan
    within 1e-14 of the peak, and equal once rounded to f32 as stored (1
    chunk: a lone tile; 766: K2's rows at K = 40; 62,720: K1's at K = 40)."""
    rng = np.random.default_rng(chunks)
    yend = rng.standard_normal(chunks).astype(np.float32).astype(np.float64)
    want = np.empty(chunks)
    y = 0.3
    for c in range(chunks):
        want[c] = y
        y = front_end.P_L * y + 1e-2 * yend[c]
    got = carry_scan(1e-2 * yend, 0.3, front_end.P_L)
    assert np.max(np.abs(got - want)) < 1e-14 * np.max(np.abs(want))
    np.testing.assert_array_equal(got.astype(np.float32),
                                  want.astype(np.float32))


# ------------------------------------------------------ the C entry points

C_TYPES = {"int": build._I, "long long": build._LL, "double": build._D,
           "float": build._F}


def c_entry_points():
    src = "".join(p.read_text() for p in sorted(CSRC.glob("*.cu")))
    for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', src):
        yield m[1], [" ".join(a.split()) for a in m[2].split(",")]


@pytest.mark.parametrize("name,params", list(c_entry_points()),
                         ids=lambda v: v if isinstance(v, str) else "")
def test_c_entry_point_matches_its_signature(name, params):
    """The ctypes argument types of each entry point (kernels/build.py) are
    its C parameters' (pointers c_void_p), one for one: a wrong count or
    type would pass garbage to the card, and no compiler checks it here."""
    want = []
    for p in params:
        decl = p.rsplit(" ", 1)[0].replace("const ", "")
        if decl.endswith("*") and decl != "int*":
            want.append(build._P)
        elif decl == "int*":
            want.append(ctypes.POINTER(build._I))
        else:
            want.append(C_TYPES[decl])
    assert build.SIGNATURES[name] == want
