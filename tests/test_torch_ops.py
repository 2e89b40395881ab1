"""PyTorch port ops vs their JAX twins on the CPU (same numpy inputs).

Decode and the NumPy constant builders must be bit-equal; the filters agree
to f32 summation order: rtol 1e-5 and atol 1e-6 of the reference's peak
(rounding errors scale with the signal, not with each sample).
"""

import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sdr_pmr446_tpu import config as C
from sdr_pmr446_tpu.io import synth
from sdr_pmr446_tpu.ops import decode as jdecode
from sdr_pmr446_tpu.ops import fir as jfir
from sdr_pmr446_tpu.ops import fm as jfm
from sdr_pmr446_tpu.ops import iir as jiir
from sdr_pmr446_tpu.ops import pfb as jpfb
from sdr_pmr446_tpu.ops import resample as jresample
from sdr_pmr446_tpu.ops import rssi as jrssi
from sdr_pmr446_tpu.taps import design as D
from sdr_pmr446_tpu_torch.ops import decode, fir, fm, iir, pfb, resample, rssi

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6
#: the JAX package's name of each port wire format (cf32 is its "cf32w")
JAX_FMT = {"cu8": "cu8", "cs8": "cs8", "cs16": "cs16", "cf32": "cf32w"}


def assert_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL * max(1.0, np.max(np.abs(want))))


def cplx(rng, *shape, scale=1.0):
    return (scale * (rng.standard_normal(shape)
                     + 1j * rng.standard_normal(shape))).astype(np.complex64)


@pytest.mark.parametrize("fmt", ["cu8", "cs8", "cs16", "cf32"])
def test_decode_bit_exact(fmt):
    iq = synth.make_scanner_iq(4096, channel=3, seed=1)
    raw = decode.quantize_iq(iq, fmt)
    words = jdecode.pack_iq(iq, JAX_FMT[fmt])
    np.testing.assert_array_equal(raw, words.view(np.uint8))
    jr, ji = jdecode.decode_planes(jnp.asarray(words), JAX_FMT[fmt])
    tr, ti = decode.decode_planes(torch.from_numpy(raw.copy()), fmt)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    z = decode.decode_complex(torch.from_numpy(raw.copy()), fmt)
    np.testing.assert_array_equal(z.numpy().real, np.asarray(jr))


def test_constant_builders_bit_equal():
    from sdr_pmr446_tpu.kernels import audio_bank as jab
    from sdr_pmr446_tpu.scanner import fsm as jfsm
    from sdr_pmr446_tpu_torch.kernels import audio_bank as tab
    from sdr_pmr446_tpu_torch.scanner import fsm as tfsm
    key = tuple(D.resampler_taps().tolist())
    np.testing.assert_array_equal(resample._kernel_matrix(key, 25, 128),
                                  jresample._kernel_matrix(key, 25, 128))
    np.testing.assert_array_equal(pfb.make_pfb_kernel(D.pfb_prototype()),
                                  jpfb.make_pfb_kernel(D.pfb_prototype()))
    np.testing.assert_array_equal(
        pfb.PFBChannelizer(D.pfb_prototype(), device="cpu").weight.numpy(),
        jpfb.PFBChannelizer(D.pfb_prototype()).rhs)
    for lowpass in (False, True):
        for fd in (False, True):
            for a, b in zip(tab._kernel_columns(lowpass, fd),
                            jab._kernel_columns(lowpass, fd)):
                np.testing.assert_array_equal(a, b)
            assert (tab.hist_len(lowpass, fd)
                    == jab.PallasAudioBank(lowpass, fd).hist)
    np.testing.assert_array_equal(tfsm._count_phasor_table(),
                                  jfsm._count_phasor_table())
    np.testing.assert_array_equal(tfsm._window_corr_table(8, 1225),
                                  jfsm._window_corr_table(8, 1225))


@pytest.mark.parametrize("t", [100, 1000, 70000])
def test_dc_blocker_matches_jax(t):
    """The chunked scan vs JAX's at the same (f32-rounded) pole, and the DC
    blocker vs the exact float64 recurrence.  The port takes the pole
    powers in double as the JAX kernels do (front_end._row_consts); JAX's
    ops/iir rounds the pole to f32 first, which moves the one-pole
    response by ~2000 x 2.3e-8 relative, so the blockers themselves agree
    with each other to 1e-4 of the peak, and with the exact recurrence to
    1e-5 of it."""
    import scipy.signal
    rng = np.random.default_rng(t)
    x = rng.standard_normal((3, t)).astype(np.float32)
    xp = rng.standard_normal(3).astype(np.float32)
    yp = rng.standard_normal(3).astype(np.float32)
    p32 = float(np.float32(1.0 - C.DC_BLOCK_ALPHA))
    jy = jiir.first_order_scan(jnp.asarray(x), p32, jnp.asarray(yp))
    ty = iir.first_order_scan(torch.from_numpy(x), p32, torch.from_numpy(yp))
    assert_close(ty.numpy(), jy)

    (tx, tyl), tout = iir.dc_blocker_apply(
        (torch.from_numpy(xp), torch.from_numpy(yp)), torch.from_numpy(x),
        C.DC_BLOCK_ALPHA)
    p = 1.0 - C.DC_BLOCK_ALPHA
    g = (1.0 + p) / 2.0
    z = g * np.diff(np.concatenate([xp[:, None], x], 1).astype(np.float64), 1)
    exact = scipy.signal.lfilter([1.0], [1.0, -p], z, axis=1,
                                 zi=p * yp[:, None].astype(np.float64))[0]
    # f32 rounding fed back through the pole's ~2000-sample memory
    tol = 1e-5 * np.max(np.abs(exact))
    np.testing.assert_allclose(tout.numpy(), exact, rtol=0, atol=tol)
    np.testing.assert_array_equal(tx.numpy(), x[:, -1])
    np.testing.assert_allclose(tyl.numpy(), exact[:, -1], rtol=0, atol=tol)
    (jx, _), jout = jiir.dc_blocker_apply(
        (jnp.asarray(xp), jnp.asarray(yp)), jnp.asarray(x), C.DC_BLOCK_ALPHA)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=0,
                               atol=1e-4 * np.max(np.abs(exact)))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))


def test_resampler_matches_jax():
    rng = np.random.default_rng(2)
    jr = jresample.PolyResampler(D.resampler_taps(), 25, 128)
    tr = resample.PolyResampler(D.resampler_taps(), 25, 128, "cpu")
    hist = cplx(rng, jr.hist_len)
    x = cplx(rng, 128 * 40)
    jh, jy = jr.apply(jnp.asarray(hist), jnp.asarray(x))
    planes = lambda z: torch.from_numpy(np.stack([z.real, z.imag]).copy())
    th, ty = tr(planes(hist), planes(x))
    assert_close(ty[0].numpy(), np.asarray(jy).real)
    assert_close(ty[1].numpy(), np.asarray(jy).imag)
    np.testing.assert_array_equal(th[0].numpy(), np.asarray(jh).real)
    # a longer (kernel-engine) history reads only its last P - 1 samples
    long_hist = np.concatenate([cplx(rng, 39), hist])
    _, ty2 = tr(planes(long_hist), planes(x))
    np.testing.assert_array_equal(ty2.numpy(), ty.numpy())


def test_pfb_parity_across_steps_matches_jax():
    rng = np.random.default_rng(3)
    jp = jpfb.PFBChannelizer(D.pfb_prototype())
    tp = pfb.PFBChannelizer(D.pfb_prototype(), device="cpu")
    jst = (jnp.asarray(cplx(rng, 400)), jnp.int32(1))
    tst = (torch.from_numpy(np.array(jst[0])),
           torch.tensor(1, dtype=torch.int32))
    for t in (16 * 25, 16 * 31):             # odd frame count flips parity
        x = cplx(rng, t)
        jst, jy = jp.apply(jst, jnp.asarray(x))
        tst, ty = tp(tst, torch.from_numpy(x))
        assert_close(ty.numpy(), np.asarray(jy))
        assert int(tst[1]) == int(jst[1])
        np.testing.assert_array_equal(tst[0].numpy(), np.asarray(jst[0]))


def test_fm_and_rssi_match_jax():
    rng = np.random.default_rng(4)
    prev = cplx(rng, 16)
    x = cplx(rng, 16, 1225 * 3)
    jprev, jy = jfm.fm_demod(jnp.asarray(prev), jnp.asarray(x))
    tprev, ty = fm.fm_demod(torch.from_numpy(prev), torch.from_numpy(x))
    assert_close(ty.numpy(), np.asarray(jy))
    np.testing.assert_array_equal(tprev.numpy(), np.asarray(jprev))
    jr = jrssi.subchunk_rssi(jnp.asarray(x), 3)
    tr = rssi.subchunk_rssi(torch.from_numpy(x), 3)
    assert_close(tr.numpy(), np.asarray(jr))
    sums = np.abs(x).reshape(16, 3, 1225).sum(-1).T.astype(np.float32)
    np.testing.assert_allclose(
        rssi.rssi_from_sums(torch.from_numpy(sums), 1225).numpy(),
        np.asarray(jr), rtol=0, atol=1e-4)


def test_fir_and_delay_match_jax():
    rng = np.random.default_rng(5)
    taps = D.ctcss_hp_taps().astype(np.float32)
    hist = rng.standard_normal((16, taps.shape[0] - 1)).astype(np.float32)
    x = rng.standard_normal((16, 2000)).astype(np.float32)
    jh, jy = jfir.fir_apply(jnp.asarray(hist), jnp.asarray(x),
                            jnp.asarray(taps))
    th, ty = fir.fir_apply(torch.from_numpy(hist), torch.from_numpy(x),
                           torch.from_numpy(taps))
    assert_close(ty.numpy(), np.asarray(jy))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    dh = rng.standard_normal((16, C.CTCSS_DELAY)).astype(np.float32)
    jh, jy = jfir.delay_apply(jnp.asarray(dh), jnp.asarray(x))
    th, ty = fir.delay_apply(torch.from_numpy(dh), torch.from_numpy(x))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))


def test_port_imports_no_jax():
    code = ("import sdr_pmr446_tpu_torch.apps.sdr_pmr446, "
            "sdr_pmr446_tpu_torch.kernels.build, sys; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.')]; assert not bad, bad")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
