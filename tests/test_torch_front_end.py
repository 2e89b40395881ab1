"""The port's K6 (front end) and K9 (resampler) vs the JAX Pallas kernels.

On the CPU the wrappers take their plain PyTorch versions; these are held to
the JAX kernels run in interpret mode on the same numpy-seeded inputs, over
two streamed K = 8 steps from a non-zero carried state
(tests/test_front_end.py:34-168, tests/test_kernels.py:120-139):

  - K6, every wire format (cu8 and cs8 through ``apply_packed2``, cs16
    through ``apply_packed``, cf32 through ``apply_interleaved``) and the
    decoded planes (``apply_planes``; the port reads them as cf32 bytes),
    against both the row [T/128, 25] and the group [G, 400] outputs: band
    SNR > 100 dB (the kernel gate, kernels/front_end.py:63-66), dc_x exact
    (the block's last decoded sample), the other carries within 1e-5 of
    their peak (f32 sums of 346 taps and a 4 M-sample recurrence, taken in
    another order);
  - K9 against ``apply_planes``: band SNR > 100 dB, history exact (it is a
    copy of the last 345 input samples).

Each wrapper refuses a ``meta`` tensor (no silent fallback).  The ``cuda``
tests hold each CUDA kernel to its plain version on the card and skip here:

    python -m pytest tests/test_torch_front_end.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from sdr_pmr446_tpu_torch import config as C
from sdr_pmr446_tpu_torch.kernels import front_end, resample_kernel
from sdr_pmr446_tpu_torch.ops import decode

torch.set_num_threads(2)

K = 8                        # the JAX group output needs K % 8 == 0
INPUTS = ("cu8", "cs8", "cs16", "cf32", "planes")


def cplx(rng, *shape, scale):
    return np.asarray(scale * (rng.standard_normal(shape)
                               + 1j * rng.standard_normal(shape)),
                      np.complex64)


def capture(n, step):
    """Channel 5 with CTCSS beside a weaker channel 9, plus a DC offset for
    the blocker to remove."""
    from sdr_pmr446_tpu_torch.io import synth
    iq = (synth.make_scanner_iq(n, channel=5, ctcss_code=12, seed=step,
                                start_sample=step * n)
          + synth.make_scanner_iq(n, channel=9, amplitude=0.2, seed=9 + step,
                                  start_sample=step * n))
    return 0.5 * iq + (0.05 - 0.03j)


def rel_err(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


def snr_db(want, got):
    want = np.asarray(want, np.float64)
    err = np.asarray(got, np.float64) - want
    return 10 * np.log10(np.sum(want ** 2) / max(np.sum(err ** 2), 1e-300))


def port_format(name):
    return "cf32" if name == "planes" else name


def wire_bytes(name, iq):
    """The port's wire bytes for ``iq`` (planes: the decoded cu8 samples as
    cf32 bytes) and the JAX kernel's call on the same data."""
    import jax.numpy as jnp
    from sdr_pmr446_tpu.ops import decode as jdecode
    if name == "planes":
        xr, xi = decode.decode_planes(torch.from_numpy(
            decode.quantize_iq(iq, "cu8")), "cu8")
        xr, xi = xr.numpy().copy(), xi.numpy().copy()
        raw = decode.quantize_iq(xr + 1j * xi, "cf32")
        return raw, lambda fe, st, g: fe.apply_planes(
            *st, jnp.asarray(xr), jnp.asarray(xi), group_out=g)
    jfmt = "cf32w" if name == "cf32" else name
    words = jdecode.pack_iq(iq, jfmt)
    raw = decode.quantize_iq(iq, name)
    np.testing.assert_array_equal(words.view(np.uint8), raw)
    w = jnp.asarray(words)
    if name == "cf32":
        return raw, lambda fe, st, g: fe.apply_interleaved(
            *st, w.reshape(-1, 256), group_out=g)
    if name == "cs16":
        return raw, lambda fe, st, g: fe.apply_packed(
            *st, w.reshape(-1, 128), group_out=g)
    return raw, lambda fe, st, g: fe.apply_packed2(
        *st, w.reshape(-1, 128), name, group_out=g)


@pytest.fixture(scope="module")
def jax_front_runs():
    """Per input: the start state, and for each step the wire bytes and the
    JAX row and group outputs (each streamed from its own previous state)."""
    import jax.numpy as jnp
    from sdr_pmr446_tpu.kernels.front_end import PallasFrontEnd
    runs = {}
    n = K * C.SUBCHUNK_IN
    for i, name in enumerate(INPUTS):
        rng = np.random.default_rng(i)
        hist_len = front_end.front_hist_len(port_format(name))
        fe = PallasFrontEnd(interpret=True, wide=hist_len == 512)
        assert fe.hist_len == hist_len
        state = [cplx(rng, scale=0.1), cplx(rng, scale=0.01),
                 cplx(rng, hist_len, scale=0.01)]
        run = dict(state=state, wires=[], row=[], group=[])
        jst = {g: [jnp.asarray(v) for v in state] for g in (False, True)}
        for step in range(2):
            raw, call = wire_bytes(name, capture(n, step))
            run["wires"].append(raw)
            for g in (False, True):
                out = [np.asarray(v) for v in call(fe, jst[g], g)]
                run["group" if g else "row"].append(out)
                jst[g] = [jnp.asarray(v) for v in out[:3]]
        runs[name] = run
    return runs


@pytest.mark.parametrize("name", INPUTS)
def test_front_end_plain_matches_jax_kernel(jax_front_runs, name):
    run = jax_front_runs[name]
    fe = front_end.FrontEnd(port_format(name), device="cpu")
    st = [torch.from_numpy(np.array(v)) for v in run["state"]]
    launches = front_end.LAUNCHES
    for step in range(2):
        out = fe(torch.from_numpy(run["wires"][step]), *st)
        band = out.band.numpy()
        for layout, rows in (("row", 25), ("group", 400)):
            jo = run[layout][step]
            assert jo[3].shape == (band.shape[1] // rows, rows)
            want = np.stack([jo[3].reshape(-1), jo[4].reshape(-1)])
            snr = snr_db(want, band)
            assert snr > 100.0, f"{name} {layout} step {step}: {snr:.1f} dB"
            np.testing.assert_array_equal(out.dc_x.numpy(), jo[0])
            assert rel_err(out.dc_y.numpy(), jo[1]) < 1e-5
            assert rel_err(out.front_hist.numpy(), jo[2]) < 1e-5
        st = list(out[:3])
    assert front_end.LAUNCHES == launches     # the plain version never counts


@pytest.fixture(scope="module")
def jax_resampler_run():
    """Two streamed K = 8 steps of the JAX K9 from a random history."""
    import jax.numpy as jnp
    from sdr_pmr446_tpu.kernels.resample_kernel import PallasResampler
    rng = np.random.default_rng(21)
    jr = PallasResampler(interpret=True)
    hist = cplx(rng, jr.hist_len, scale=0.1)
    run = dict(hist=hist, x=[], out=[])
    h = jnp.asarray(hist)
    n = K * C.SUBCHUNK_IN
    for step in range(2):
        iq = capture(n, step)
        xr = np.real(iq).astype(np.float32)
        xi = np.imag(iq).astype(np.float32)
        h, yr, yi = jr.apply_planes(h, jnp.asarray(xr), jnp.asarray(xi))
        run["x"].append((xr, xi))
        run["out"].append([np.asarray(v) for v in (h, yr, yi)])
    return run


def test_resampler_plain_matches_jax_kernel(jax_resampler_run):
    run = jax_resampler_run
    rs = resample_kernel.Resampler(device="cpu")
    assert rs.hist_len == len(run["hist"]) == 345
    h = torch.from_numpy(run["hist"])
    launches = resample_kernel.LAUNCHES
    for step in range(2):
        xr, xi = (torch.from_numpy(v) for v in run["x"][step])
        h, band = rs(h, xr, xi)
        jh, yr, yi = run["out"][step]
        np.testing.assert_array_equal(h.numpy(), jh)
        snr = snr_db(np.stack([yr.reshape(-1), yi.reshape(-1)]), band.numpy())
        assert snr > 100.0, f"step {step}: {snr:.1f} dB"
    assert resample_kernel.LAUNCHES == launches


def wrapper_calls():
    """One call of each new kernel wrapper on ``meta`` tensors."""
    from sdr_pmr446_tpu_torch.kernels import chan_tail, pfb_demod
    m = dict(device="meta")
    c64 = dict(dtype=torch.complex64, device="meta")
    band = torch.zeros((2, 19600), **m)
    return {
        "FrontEnd": lambda: front_end.FrontEnd("cu8", device="cpu")(
            torch.zeros(2 * C.SUBCHUNK_IN, dtype=torch.uint8, **m),
            torch.zeros((), **c64), torch.zeros((), **c64),
            torch.zeros(512, **c64)),
        "PfbDemod": lambda: pfb_demod.PfbDemod(device="cpu")(
            band, torch.zeros(400, **c64),
            torch.zeros((), dtype=torch.int32, **m), torch.zeros(16, **c64)),
        "Resampler": lambda: resample_kernel.Resampler(device="cpu")(
            torch.zeros(345, **c64), band[0], band[1]),
        "ChanTail": lambda: chan_tail.ChanTail("dsd", device="cpu")(
            band, torch.zeros(800, **c64), torch.zeros((), **c64),
            torch.zeros(50, **m)),
    }


@pytest.mark.parametrize("wrapper", ["FrontEnd", "PfbDemod", "Resampler",
                                     "ChanTail"])
def test_wrapper_refuses_meta_tensors(wrapper):
    """A tensor that is neither on the card nor on the CPU is refused: no
    wrapper falls back to its plain version."""
    with pytest.raises(ValueError, match="implementation for device meta"):
        wrapper_calls()[wrapper]()


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt,k", [("cu8", 40), ("cs16", 10), ("cs8", 3),
                                   ("cf32", 3)])
def test_front_end_kernel_matches_plain_on_card(fmt, k):
    """K6 vs its plain version over two blocks: band SNR > 100 dB, carries
    to 5e-5 of their peak (f32 through a 4 M-sample recurrence), dc_x
    exact."""
    dev = _cuda_or_skip()
    rng = np.random.default_rng(k)
    fe = front_end.FrontEnd(fmt, device=dev)
    ref = [torch.as_tensor(v, device=dev) for v in (
        cplx(rng, scale=0.1), cplx(rng, scale=0.01),
        cplx(rng, fe.hist_len, scale=0.01))]
    got = list(ref)
    n = k * C.SUBCHUNK_IN
    for step in range(2):
        wire = torch.as_tensor(decode.quantize_iq(capture(n, step), fmt),
                               device=dev)
        launches = front_end.LAUNCHES
        r = fe.plain(wire, *ref)
        g = fe(wire, *got)
        torch.cuda.synchronize(dev)
        assert front_end.LAUNCHES == launches + 1
        assert snr_db(r.band.cpu().numpy(), g.band.cpu().numpy()) > 100.0
        np.testing.assert_array_equal(g.dc_x.cpu().numpy(),
                                      r.dc_x.cpu().numpy())
        for name in ("dc_y", "front_hist"):
            assert rel_err(getattr(g, name).cpu().numpy(),
                           getattr(r, name).cpu().numpy()) < 5e-5, name
        ref, got = list(r[:3]), list(g[:3])


@pytest.mark.cuda
@pytest.mark.parametrize("k", [40, 10, 3, 1])
def test_resampler_kernel_matches_plain_on_card(k):
    """K9 vs its plain version (F.conv1d): band SNR > 100 dB, history
    exact, a second call bit-equal to the first (K = 3 and 1 end in a
    partial block of frames)."""
    dev = _cuda_or_skip()
    rng = np.random.default_rng(k)
    rs = resample_kernel.Resampler(device=dev)
    hist = torch.as_tensor(cplx(rng, rs.hist_len, scale=0.1), device=dev)
    iq = capture(k * C.SUBCHUNK_IN, 0)
    xr = torch.as_tensor(np.real(iq).astype(np.float32), device=dev)
    xi = torch.as_tensor(np.imag(iq).astype(np.float32), device=dev)
    launches = resample_kernel.LAUNCHES
    rh, rb = rs.plain(hist, xr, xi)
    gh, gb = rs(hist, xr, xi)
    torch.cuda.synchronize(dev)
    assert resample_kernel.LAUNCHES == launches + 1
    assert snr_db(rb.cpu().numpy(), gb.cpu().numpy()) > 100.0
    np.testing.assert_array_equal(gh.cpu().numpy(), rh.cpu().numpy())
    assert torch.equal(rs(hist, xr, xi)[1], gb)
