"""The port's K7 (PFB + discriminator) vs the JAX Pallas kernel.

On the CPU ``PfbDemod`` takes its plain PyTorch version; it is held to the
JAX kernel in interpret mode in each of its three output forms, over two
streamed steps from a non-zero state, on the band of an occupied capture
(tests/test_kernels.py:21-75, 233-257; tests/test_group_band.py:31-151):

  - ``call_planes_rssi`` at K = 10 (the row trio) and ``call_group`` at
    K = 8 (the group trio): ``mag="sums"``;
  - ``call_planes`` at K = 3: ``mag="plane"``.

Gates: demod within 1e-4 (native atan2 against the JAX kernel's kmath
polynomial), |y| sums and plane rtol 1e-5, parity exact, the other carries
within 1e-5 of their peak.  The ``cuda`` tests hold the CUDA kernel to its
plain version on the card and skip here:

    python -m pytest tests/test_torch_pfb_demod.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from sdr_pmr446_tpu_torch import config as C
from sdr_pmr446_tpu_torch.kernels import front_end, pfb_demod
from sdr_pmr446_tpu_torch.ops import decode

torch.set_num_threads(2)

NS = C.SUBCHUNK_AUDIO
#: (JAX entry point, K, the port's mag form)
CASES = {"call_planes_rssi": (10, "sums"), "call_group": (8, "sums"),
         "call_planes": (3, "plane")}


def cplx(rng, *shape, scale):
    return np.asarray(scale * (rng.standard_normal(shape)
                               + 1j * rng.standard_normal(shape)),
                      np.complex64)


def occupied_band(k, step):
    """Band planes [2, nb] of a capture with NBFM on all 16 channels (no
    channel demodulates pure noise, whose discriminator output sits on the
    atan2 branch cut), through the port's front end from a zero state."""
    from sdr_pmr446_tpu_torch.io import synth
    n = k * C.SUBCHUNK_IN
    iq = sum(synth.make_scanner_iq(
        n, channel=ch, amplitude=0.6 if ch == 5 else 0.2,
        tone_hz=300.0 + 97 * ch, seed=16 * step + ch,
        start_sample=step * n) for ch in range(1, 17)) / 2
    fe = front_end.FrontEnd("cs16", device="cpu")
    z = torch.zeros((), dtype=torch.complex64)
    out = fe.plain(torch.from_numpy(decode.quantize_iq(iq, "cs16")), z, z,
                   torch.zeros(fe.hist_len, dtype=torch.complex64))
    return out.band.numpy()


def rel_err(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


@pytest.fixture(scope="module")
def jax_pfb_runs():
    """Per entry point: the start state, the two bands and the JAX outputs
    (demod as [16, F], |y|, pfb_hist, parity, prev)."""
    import jax.numpy as jnp
    from sdr_pmr446_tpu.kernels.pfb_demod import PallasPfbDemod
    jp = PallasPfbDemod(interpret=True)
    runs = {}
    for i, (entry, (k, _)) in enumerate(CASES.items()):
        rng = np.random.default_rng(30 + i)
        state = [cplx(rng, 400, scale=0.1), np.int32(1),
                 cplx(rng, 16, scale=0.1)]
        run = dict(state=state, bands=[], out=[])
        jst = [jnp.asarray(v) for v in state]
        for step in range(2):
            band = occupied_band(k, step)
            if entry == "call_group":
                br, bi = (jnp.asarray(b.reshape(-1, 400)) for b in band)
                o = jp.call_group(br, bi, *jst, NS)
            elif entry == "call_planes_rssi":
                o = jp.call_planes_rssi(jnp.asarray(band[0]),
                                        jnp.asarray(band[1]), *jst, NS)
            else:
                o = jp.call_planes(jnp.asarray(band[0]), jnp.asarray(band[1]),
                                   *jst)
            o = [np.asarray(v) for v in o]
            o[0] = o[0].reshape(16, -1)
            run["bands"].append(band)
            run["out"].append(o)
            jst = [jnp.asarray(v) for v in o[2:]]
        runs[entry] = run
    return runs


@pytest.mark.parametrize("entry", list(CASES))
def test_pfb_demod_plain_matches_jax_kernel(jax_pfb_runs, entry):
    run = jax_pfb_runs[entry]
    k, mag = CASES[entry]
    pd = pfb_demod.PfbDemod(device="cpu")
    st = [torch.from_numpy(np.array(v)) for v in run["state"]]
    launches = pfb_demod.LAUNCHES
    for step in range(2):
        out = pd(torch.from_numpy(run["bands"][step]), *st, ns=NS, mag=mag)
        demod, m, hist, parity, prev = run["out"][step]
        assert out.demod.shape == demod.shape == (16, k * NS)
        assert out.mag.shape == m.shape
        assert np.max(np.abs(out.demod.numpy() - demod)) < 1e-4
        np.testing.assert_allclose(out.mag.numpy(), m, rtol=1e-5)
        assert int(out.parity) == int(parity)
        assert rel_err(out.pfb_hist.numpy(), hist) < 1e-5
        assert rel_err(out.prev.numpy(), prev) < 1e-5
        st = list(out[2:])
    assert pfb_demod.LAUNCHES == launches     # the plain version never counts


def test_pfb_demod_rejects_bad_geometry():
    pd = pfb_demod.PfbDemod(device="cpu")
    band = torch.zeros((2, 16 * NS + 16))
    with pytest.raises(ValueError, match="sub-chunks"):
        pd.geometry(band, NS, "sums")
    assert pd.geometry(band, NS, "plane") == (16 * NS + 16, NS + 1, 0)
    with pytest.raises(ValueError, match="mag must be"):
        pd.geometry(band, NS, "both")
    with pytest.raises(ValueError, match="whole frames"):
        pd.geometry(torch.zeros((2, 40)), NS, "plane")


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("k,mag", [(40, "sums"), (10, "sums"), (3, "plane"),
                                   (3, "sums"), (1, "sums")])
def test_pfb_demod_kernel_matches_plain_on_card(k, mag):
    """K7 vs its plain version over two blocks: demod SNR > 100 dB, |y|
    rtol 1e-5, parity exact, carries to 5e-5 of their peak."""
    dev = _cuda_or_skip()
    rng = np.random.default_rng(k)
    pd = pfb_demod.PfbDemod(device=dev)
    ref = [torch.as_tensor(v, device=dev) for v in (
        cplx(rng, 400, scale=0.1), np.int32(1), cplx(rng, 16, scale=0.1))]
    got = list(ref)
    for step in range(2):
        band = torch.as_tensor(occupied_band(k, step), device=dev)
        launches = pfb_demod.LAUNCHES
        r = pd.plain(band, *ref, ns=NS, mag=mag)
        g = pd(band, *got, ns=NS, mag=mag)
        torch.cuda.synchronize(dev)
        assert pfb_demod.LAUNCHES == launches + 1
        want = r.demod.cpu().double()
        err = (g.demod - r.demod).cpu().double()
        assert 10 * torch.log10((want ** 2).sum() / (err ** 2).sum()) > 100.0
        np.testing.assert_allclose(g.mag.cpu().numpy(), r.mag.cpu().numpy(),
                                   rtol=1e-5)
        assert int(g.parity) == int(r.parity)
        for name in ("pfb_hist", "prev"):
            assert rel_err(getattr(g, name).cpu().numpy(),
                           getattr(r, name).cpu().numpy()) < 5e-5, name
        ref, got = list(r[2:]), list(g[2:])
