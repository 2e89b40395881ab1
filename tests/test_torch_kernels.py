"""The port's K1 (duo) and K2 (audio bank) vs the JAX Pallas kernels.

On the CPU the wrappers take their plain PyTorch versions; these are held to
the JAX kernels run in interpret mode on the same numpy inputs.  The
``cuda`` tests hold each CUDA kernel to its plain version on the card and
skip here.  JAX is imported inside the tests that compare with it, so the
``cuda`` tests also run where JAX is not installed:

    python -m pytest tests/test_torch_kernels.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from sdr_pmr446_tpu import config as C
from sdr_pmr446_tpu.io import synth
from sdr_pmr446_tpu_torch.kernels import audio_bank, build, duo
from sdr_pmr446_tpu_torch.ops import decode

torch.set_num_threads(2)

NS = C.SUBCHUNK_AUDIO
JAX_FMT = {"cu8": "cu8", "cs16": "cs16"}


def occupied_band(n, step):
    """All 16 channels carry NBFM, so no channel demodulates pure noise
    (whose discriminator output sits on the atan2 branch cut)."""
    return sum(synth.make_scanner_iq(
        n, channel=ch, amplitude=0.6 if ch == 5 else 0.2,
        tone_hz=300.0 + 97 * ch, ctcss_code=12 if ch == 5 else None,
        seed=16 * step + ch, start_sample=step * n) for ch in range(1, 17)) / 2


def cplx(rng, *shape, scale):
    return np.asarray(scale * (rng.standard_normal(shape)
                               + 1j * rng.standard_normal(shape)),
                      np.complex64)


def rel_err(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


@pytest.mark.parametrize("fmt", ["cu8", "cs16"])
def test_duo_plain_matches_jax_kernel(fmt):
    """Two streamed K=8 steps from a non-zero carried state: carries and
    |y| sums to f32 rounding, demod to 1e-4 (native atan2 against the JAX
    kernel's atan2 polynomial)."""
    import jax.numpy as jnp
    from sdr_pmr446_tpu.kernels.duo import PallasScannerDuo
    from sdr_pmr446_tpu.ops import decode as jdecode
    k = 8
    rng = np.random.default_rng(11)
    jd = PallasScannerDuo(JAX_FMT[fmt], interpret=True)
    td = duo.ScannerDuo(fmt, device="cpu")
    assert td.front_hist_len == jd.front_hist_len
    state = [cplx(rng, scale=0.1), cplx(rng, scale=0.01),
             cplx(rng, td.front_hist_len, scale=0.01),
             cplx(rng, 400, scale=0.1), np.int32(1), cplx(rng, 16, scale=0.1)]
    jst = [jnp.asarray(v) for v in state]
    tst = [torch.from_numpy(np.array(v)) for v in state]
    n = k * C.SUBCHUNK_IN
    launches = duo.LAUNCHES
    for step in range(2):
        words = jdecode.pack_iq(occupied_band(n, step), JAX_FMT[fmt])
        jo = [np.asarray(v) for v in jd.apply(
            *jst, jnp.asarray(words).reshape(-1, 128), NS)]
        to = td(torch.from_numpy(decode.quantize_iq(
            occupied_band(n, step), fmt).copy()), *tst, ns=NS)
        np.testing.assert_array_equal(to.dc_x.numpy(), jo[0])
        for got, want in ((to.dc_y, jo[1]), (to.front_hist, jo[2]),
                          (to.pfb_hist, jo[5]), (to.prev, jo[7])):
            assert rel_err(got.numpy(), want) < 1e-5
        assert int(to.parity) == int(jo[6])
        np.testing.assert_allclose(to.mag_sums.numpy(), jo[4], rtol=1e-5)
        assert np.max(np.abs(to.demod.numpy() - jo[3].reshape(16, -1))) < 1e-4
        jst = [jnp.asarray(jo[i]) for i in (0, 1, 2, 5, 6, 7)]
        tst = [to.dc_x, to.dc_y, to.front_hist, to.pfb_hist, to.parity,
               to.prev]
    assert duo.LAUNCHES == launches          # the plain version never counts


def test_audio_bank_plain_matches_jax_kernel():
    """Two streamed K=8 steps over the schedule edge cases of
    tests/test_kernels.py:277-279 (b = ns-1, b >= ns, b = 0, mid-window):
    audio and carries to f32 rounding, tone sums to 3e-5 of their peak."""
    import jax.numpy as jnp
    from sdr_pmr446_tpu.kernels.audio_bank import PallasAudioBank
    rng = np.random.default_rng(7)
    k = 8
    f = k * NS
    jb = PallasAudioBank(interpret=True)
    tb = audio_bank.AudioBank(device="cpu")
    assert tb.hist == jb.hist
    hist = (0.1 * rng.standard_normal((16, jb.hist))).astype(np.float32)
    dcx = (0.01 * rng.standard_normal(16)).astype(np.float32)
    dcy = (0.01 * rng.standard_normal(16)).astype(np.float32)
    jst = [jnp.asarray(v) for v in (hist, dcx, dcy)]
    tst = [torch.from_numpy(v) for v in (hist, dcx, dcy)]
    n_win = C.CTCSS_BLOCK_SIZE
    b_np = np.array([n_win - 1, NS - 1, n_win - 1 - NS, 500, 2440, 0, NS,
                     900], np.int32)
    sel_np = np.array([3, 3, 7, 0, 15, 2, 2, 9], np.int32)
    launches = audio_bank.LAUNCHES
    for step in range(2):
        demod = (0.3 * rng.standard_normal((16, f))).astype(np.float32)
        b = np.roll(b_np, step)
        sel = np.roll(sel_np, step)
        jo = [np.asarray(v) for v in jb.apply_dc_ctcss(
            *jst, jnp.asarray(demod), jnp.float32(4.0), jnp.asarray(b),
            jnp.asarray(sel), out_len=f, ns=NS)]
        to = tb(*tst, torch.from_numpy(demod), torch.tensor(4.0),
                torch.from_numpy(b), torch.from_numpy(sel), NS)
        np.testing.assert_array_equal(to.hist.numpy(), jo[0])
        # f32 rounding of ~400-tap sums taken in another order: ~10 ulp of
        # the peak (the gain-4 audio peaks near 2.4), so 1e-6 of the peak
        peak = np.max(np.abs(jo[3][:, :f]))
        np.testing.assert_allclose(to.audio.numpy(), jo[3][:, :f], rtol=0,
                                   atol=1e-6 * peak)
        np.testing.assert_allclose(to.dc_x.numpy(), jo[1], rtol=0, atol=1e-6)
        np.testing.assert_allclose(to.dc_y.numpy(), jo[2], rtol=0, atol=1e-6)
        scale = np.max(np.abs(jo[5])) + 1e-6
        for got, want in ((to.raw_pre, jo[4]), (to.raw_mem, jo[5])):
            np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                       atol=3e-5 * scale)
        jst = [jnp.asarray(v) for v in jo[:3]]
        tst = [to.hist, to.dc_x, to.dc_y]
    assert audio_bank.LAUNCHES == launches


def test_wrappers_reject_bad_inputs():
    """Checks on dtype, shape, device and contiguity run before any pointer
    reaches a kernel; an unknown device never falls back."""
    dev = torch.device("cpu")
    t = torch.zeros(4, dtype=torch.float32)
    build.require(t, "t", torch.float32, (4,), dev)
    with pytest.raises(ValueError, match="dtype"):
        build.require(t, "t", torch.int32, (4,), dev)
    with pytest.raises(ValueError, match="shape"):
        build.require(t, "t", torch.float32, (5,), dev)
    with pytest.raises(ValueError, match="contiguous"):
        build.require(torch.zeros(4, 2)[:, 0], "t", torch.float32, (4,), dev)
    with pytest.raises(ValueError, match="on meta"):
        build.require(t.to("meta"), "t", torch.float32, (4,), dev)
    d = duo.ScannerDuo("cu8", device="cpu")
    with pytest.raises(ValueError, match="multiple of 2048"):
        d.geometry(torch.zeros(2 * 1000, dtype=torch.uint8), NS)
    with pytest.raises(ValueError, match="no duo implementation"):
        d(torch.zeros(2 * C.SUBCHUNK_IN, dtype=torch.uint8, device="meta"),
          *[None] * 6)


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt,k", [("cu8", 40), ("cs16", 10), ("cs8", 3),
                                   ("cf32", 3)])
def test_duo_kernel_matches_plain_on_card(fmt, k):
    """The CUDA kernel vs its plain version: demod SNR > 100 dB (the JAX
    kernel gate), |y| sums rtol 1e-5, carries to 5e-5 of their peak; a
    second call bit-equal to the first."""
    dev = _cuda_or_skip()
    rng = np.random.default_rng(k)
    d = duo.ScannerDuo(fmt, device=dev)
    wire = torch.as_tensor(decode.quantize_iq(
        occupied_band(k * C.SUBCHUNK_IN, 0), fmt), device=dev)
    state = [torch.as_tensor(v, device=dev) for v in (
        cplx(rng, scale=0.1), cplx(rng, scale=0.01),
        cplx(rng, d.front_hist_len, scale=0.01), cplx(rng, 400, scale=0.1),
        np.int32(1), cplx(rng, 16, scale=0.1))]
    launches = duo.LAUNCHES
    ref = d.plain(wire, *state, ns=NS)
    got = d(wire, *state, ns=NS)
    torch.cuda.synchronize(dev)
    assert duo.LAUNCHES == launches + 1
    want, err = ref.demod.cpu().double(), (got.demod - ref.demod).cpu().double()
    assert 10 * torch.log10((want ** 2).sum() / (err ** 2).sum()) > 100.0
    np.testing.assert_allclose(got.mag_sums.cpu().numpy(),
                               ref.mag_sums.cpu().numpy(), rtol=1e-5)
    for name in ("dc_x", "dc_y", "front_hist", "pfb_hist", "prev"):
        assert rel_err(getattr(got, name).cpu().numpy(),
                       getattr(ref, name).cpu().numpy()) < 5e-5, name
    assert int(got.parity) == int(ref.parity)
    again = d(wire, *state, ns=NS)
    for name, t in got._asdict().items():
        assert torch.equal(getattr(again, name), t), name


#: the audio bank's four tap configurations (lowpass, fir_deemph)
TAP_CONFIGS = [(False, False), (False, True), (True, False), (True, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 3, 10, 40])
@pytest.mark.parametrize("lowpass,fir_deemph", TAP_CONFIGS)
def test_audio_bank_kernel_matches_plain_on_card(lowpass, fir_deemph, k):
    """The CUDA kernel vs its plain version: audio atol 1e-5, tone sums to
    3e-5 of their peak, history exact, DC carries to 5e-5 of their peak; a
    second call equal to the first bit for bit.  K = 1 and 3 end in a
    partial FIR tile."""
    dev = _cuda_or_skip()
    rng = np.random.default_rng(5)
    bank = audio_bank.AudioBank(lowpass, fir_deemph, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    hist = torch.as_tensor(0.1 * rng.standard_normal((16, bank.hist)), **f32)
    dcx = torch.as_tensor(0.01 * rng.standard_normal(16), **f32)
    dcy = torch.as_tensor(0.01 * rng.standard_normal(16), **f32)
    demod = torch.as_tensor(0.2 * rng.standard_normal((16, k * NS)), **f32)
    b = torch.as_tensor(np.resize([2440, NS - 1, 0, 700, 2000, NS, 1, 1300,
                                   5, 1224], k),
                        dtype=torch.int32, device=dev)
    sel = torch.as_tensor(rng.integers(0, 16, k), dtype=torch.int32,
                          device=dev)
    gain = torch.tensor(4.0, **f32)
    launches = audio_bank.LAUNCHES
    ref = bank.plain(hist, dcx, dcy, demod, gain, b, sel, NS)
    got = bank(hist, dcx, dcy, demod, gain, b, sel, NS)
    again = bank(hist, dcx, dcy, demod, gain, b, sel, NS)
    torch.cuda.synchronize(dev)
    assert audio_bank.LAUNCHES == launches + 2
    np.testing.assert_allclose(got.audio.cpu().numpy(),
                               ref.audio.cpu().numpy(), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got.hist.cpu().numpy(),
                                  ref.hist.cpu().numpy())
    scale = ref.raw_mem.abs().max().item()
    for name in ("raw_pre", "raw_mem"):
        np.testing.assert_allclose(getattr(got, name).cpu().numpy(),
                                   getattr(ref, name).cpu().numpy(), rtol=0,
                                   atol=3e-5 * scale)
    for name in ("dc_x", "dc_y"):
        assert rel_err(getattr(got, name).cpu().numpy(),
                       getattr(ref, name).cpu().numpy()) < 5e-5, name
    for name, t in got._asdict().items():
        assert torch.equal(getattr(again, name), t), name


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 3, 10, 40])
@pytest.mark.parametrize("lowpass,fir_deemph", TAP_CONFIGS)
def test_audio_bank_k8_kernels_match_plain_on_card(lowpass, fir_deemph, k):
    """K8 (``apply``, ``apply_dc``) vs its plain versions over two calls
    from a random non-zero state: history exact, audio atol 1e-5, lp and
    lp_dcb within 5e-5 of their peak, DC carries to 5e-5 of their peak;
    each call equal bit for bit to a second one, the audio equal bit for
    bit to K2's on the same input (one FIR device function), dc_x to K2's;
    one launch a call on each counter."""
    dev = _cuda_or_skip()
    rng = np.random.default_rng(6)
    bank = audio_bank.AudioBank(lowpass, fir_deemph, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    hist = torch.as_tensor(0.1 * rng.standard_normal((16, bank.hist)), **f32)
    dcx = torch.as_tensor(0.01 * rng.standard_normal(16), **f32)
    dcy = torch.as_tensor(0.01 * rng.standard_normal(16), **f32)
    gain = torch.tensor(4.0, **f32)
    b = torch.full((k,), NS - 1, dtype=torch.int32, device=dev)
    sel = torch.zeros(k, dtype=torch.int32, device=dev)
    ref_a, got_a, ref_d, got_d = hist, hist, (hist, dcx, dcy), (hist, dcx, dcy)
    for step in range(2):
        demod = torch.as_tensor(0.2 * rng.standard_normal((16, k * NS)),
                                **f32)
        counts = (audio_bank.APPLY_LAUNCHES, audio_bank.APPLY_DC_LAUNCHES)
        ra = bank.apply_plain(ref_a, demod, gain)
        ga = bank.apply(got_a, demod, gain)
        rd = bank.apply_dc_plain(*ref_d, demod, gain)
        gd = bank.apply_dc(*got_d, demod, gain)
        again = (bank.apply(got_a, demod, gain),
                 bank.apply_dc(*got_d, demod, gain))
        k2 = bank.kernel(*got_d, demod, gain, b, sel, NS)
        torch.cuda.synchronize(dev)
        assert (audio_bank.APPLY_LAUNCHES, audio_bank.APPLY_DC_LAUNCHES) == (
            counts[0] + 2, counts[1] + 2)
        for first, second in zip((ga, gd), again):
            for name, t in first._asdict().items():
                assert torch.equal(getattr(second, name), t), name
        for r, g in ((ra, ga), (rd, gd)):
            np.testing.assert_array_equal(g.hist.cpu().numpy(),
                                          r.hist.cpu().numpy())
            np.testing.assert_allclose(g.audio.cpu().numpy(),
                                       r.audio.cpu().numpy(), rtol=0,
                                       atol=1e-5)
        for name, r, g in (("lp", ra.lp, ga.lp), ("lp_dcb", rd.lp_dcb,
                                                  gd.lp_dcb),
                           ("dc_x", rd.dc_x, gd.dc_x),
                           ("dc_y", rd.dc_y, gd.dc_y)):
            assert rel_err(g.cpu().numpy(), r.cpu().numpy()) < 5e-5, name
        assert torch.equal(ga.audio, k2.audio) and torch.equal(gd.audio,
                                                               k2.audio)
        np.testing.assert_array_equal(gd.dc_x.cpu().numpy(),
                                      k2.dc_x.cpu().numpy())
        ref_a, got_a = ra.hist, ga.hist
        ref_d, got_d = rd[:3], gd[:3]


@pytest.mark.cuda
def test_chain_step_makes_no_host_reads_on_card():
    """A warmed-up chain step on the card runs under
    torch.cuda.set_sync_debug_mode("error"): no op of the step (FSM
    included) reads the device from the host, so steps queue
    asynchronously."""
    from sdr_pmr446_tpu_torch.scanner.chain import (ScannerChain,
                                                    make_runtime_params)
    dev = _cuda_or_skip()
    k = 10
    chain = ScannerChain(C.BlockConfig(k), input_format="cu8", device=dev)
    params = make_runtime_params(C.ScannerArgs(lock_mode="max"), dev)
    wires = [torch.as_tensor(decode.quantize_iq(
        occupied_band(k * C.SUBCHUNK_IN, step), "cu8"), device=dev)
        for step in range(2)]
    state, _ = chain.step(chain.init_state(), wires[0], params)
    torch.cuda.synchronize(dev)
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, out = chain.step(state, wires[1], params)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize(dev)
    assert out.active_chan.shape == (k,)


def fm_capture(n, start=0, offset_hz=300.0):
    """The dsd_in fixture of tests/test_dsd_in.py:25-30 (a 1 kHz tone at
    2 kHz deviation, 300 Hz off the tuned centre), from sample ``start``."""
    t = (start + np.arange(n)) / C.SDR_SAMPLERATE
    phase = np.cumsum(0.5 * np.sin(2 * np.pi * 1000.0 * t)) * 2000.0
    return 0.9 * np.exp(2j * np.pi * (phase + offset_hz * (start + np.arange(n)))
                        / C.SDR_SAMPLERATE)


def mono_input(mode, n, step):
    if mode == "dsd":
        return fm_capture(n, start=step * n)
    return synth.make_scanner_iq(n, channel=5, ctcss_code=12, seed=step,
                                 start_sample=step * n)


def random_mono_state(mono, rng, dev, n0):
    """A carried state with every field non-zero (and an odd mixer phase)."""
    st = [torch.as_tensor(v, device=dev) for v in (
        cplx(rng, scale=0.1), cplx(rng, scale=0.01),
        cplx(rng, mono.front.hist_len, scale=0.01),
        cplx(rng, mono.hb * 400, scale=0.1), cplx(rng, scale=0.5),
        (0.1 * rng.standard_normal(mono.dh * 25)).astype(np.float32))]
    return st, (torch.tensor(n0, dtype=torch.int32, device=dev)
                if mono.mode == "single" else None)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["dsd", "single"])
@pytest.mark.parametrize("fmt,k", [("cu8", 16), ("cs16", 15), ("cu8", 1),
                                   ("cs16", 3)])
def test_mono_kernel_matches_plain_on_card(mode, fmt, k):
    """K4 vs its plain version over two consecutive blocks (the carried
    state included; K = 15 gives an odd number of group rows, K = 1 and 3
    a partial last tile in both launches of the tail): dsd PCM within 1 LSB
    after the int16 truncation, single audio SNR > 100 dB, carries to 5e-5
    of their peak, the mixer phase exact."""
    from sdr_pmr446_tpu_torch.kernels import chan_tail
    dev = _cuda_or_skip()
    rng = np.random.default_rng(k)
    mono = chan_tail.MonoChain(mode, fmt, channel=5, audio_gain=2.0,
                               device=dev)
    ref, n0_ref = random_mono_state(mono, rng, dev, 7)
    got, n0_got = list(ref), n0_ref
    n = k * C.SUBCHUNK_IN
    for step in range(2):
        wire = torch.as_tensor(decode.quantize_iq(
            mono_input(mode, n, step), fmt), device=dev)
        launches = chan_tail.LAUNCHES
        r = mono.plain(wire, *ref, n0=n0_ref)
        g = mono(wire, *got, n0=n0_got)
        torch.cuda.synchronize(dev)
        assert chan_tail.LAUNCHES == launches + 1
        want, have = r.out.cpu().double(), g.out.cpu().double()
        if mode == "dsd":
            d = (g.out.to(torch.int16).int() - r.out.to(torch.int16).int())
            assert d.abs().max().item() <= 1
        else:
            snr = 10 * torch.log10((want ** 2).sum() / ((have - want) ** 2).sum())
            assert snr > 100.0, f"step {step}: {snr:.1f} dB"
        for name in ("dc_x", "dc_y", "front_hist", "band_hist", "sig_prev",
                     "demod_hist"):
            assert rel_err(getattr(g, name).cpu().numpy(),
                           getattr(r, name).cpu().numpy()) < 5e-5, name
        if mode == "single":
            assert int(g.n0) == int(r.n0)
        ref, n0_ref = list(r[:6]), r.n0
        got, n0_got = list(g[:6]), g.n0


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["dsd", "single"])
def test_mono_chain_step_makes_no_host_reads_on_card(mode):
    """A warmed-up DsdInChain / SingleChannelChain step on the card runs
    under torch.cuda.set_sync_debug_mode("error")."""
    from sdr_pmr446_tpu_torch.scanner.dsd_in import DsdInChain
    from sdr_pmr446_tpu_torch.scanner.single import SingleChannelChain
    dev = _cuda_or_skip()
    k = 10
    chain = (DsdInChain(k, input_format="cu8", device=dev) if mode == "dsd"
             else SingleChannelChain(5, k, input_format="cu8", device=dev))
    wires = [torch.as_tensor(decode.quantize_iq(mono_input(
        mode, k * C.SUBCHUNK_IN, step), "cu8"), device=dev)
        for step in range(2)]
    state, _ = chain.step(chain.init_state(), wires[0])
    torch.cuda.synchronize(dev)
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, out = chain.step(state, wires[1])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize(dev)
    assert out.shape == (chain.output_len,)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["dsd", "single"])
@pytest.mark.parametrize("fmt,k", [("cu8", 16), ("cs16", 15), ("cu8", 1),
                                   ("cs16", 3)])
def test_chan_tail_kernel_matches_plain_on_card(mode, fmt, k):
    """K5 vs its plain version on K6's band of two consecutive blocks (the
    carried state included; K = 15 gives an odd number of group rows, K = 1
    and 3 a partial last tile): dsd PCM within 1 LSB, single audio SNR >
    100 dB, carries to 5e-5 of their peak, the mixer phase exact."""
    from sdr_pmr446_tpu_torch.kernels import chan_tail
    dev = _cuda_or_skip()
    rng = np.random.default_rng(k)
    mono = chan_tail.MonoChain(mode, fmt, channel=5, audio_gain=2.0,
                               device=dev)
    st, n0 = random_mono_state(mono, rng, dev, 7)
    fe_st, ref, n0_ref = st[:3], st[3:], n0
    got, n0_got = list(ref), n0
    n = k * C.SUBCHUNK_IN
    for step in range(2):
        wire = torch.as_tensor(decode.quantize_iq(
            mono_input(mode, n, step), fmt), device=dev)
        fe = mono.front(wire, *fe_st)
        launches = chan_tail.TAIL_LAUNCHES
        r = mono.tail.plain(fe.band, *ref, n0=n0_ref)
        g = mono.tail(fe.band, *got, n0=n0_got)
        torch.cuda.synchronize(dev)
        assert chan_tail.TAIL_LAUNCHES == launches + 1
        if mode == "dsd":
            d = (g.out.to(torch.int16).int() - r.out.to(torch.int16).int())
            assert d.abs().max().item() <= 1
        else:
            want, have = r.out.cpu().double(), g.out.cpu().double()
            snr = 10 * torch.log10((want ** 2).sum() / ((have - want) ** 2).sum())
            assert snr > 100.0, f"step {step}: {snr:.1f} dB"
        for name in ("band_hist", "sig_prev", "demod_hist"):
            assert rel_err(getattr(g, name).cpu().numpy(),
                           getattr(r, name).cpu().numpy()) < 5e-5, name
        if mode == "single":
            assert int(g.n0) == int(r.n0)
        fe_st = list(fe[:3])
        ref, n0_ref = list(r[:3]), r.n0
        got, n0_got = list(g[:3]), g.n0


def assert_bit_equal(got, want, what):
    for name, g, w in zip(got._fields, got, want):
        if g is not None:
            assert torch.equal(g, w), f"{what}: {name}"


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["dsd", "single"])
@pytest.mark.parametrize("fmt,k", [("cu8", 16), ("cs16", 3)])
def test_tail_kernels_repeat_bit_for_bit_on_card(mode, fmt, k):
    """K4 and K5 called twice on the same inputs give the same outputs bit
    for bit (every sum in one fixed order, no atomics)."""
    from sdr_pmr446_tpu_torch.kernels import chan_tail
    dev = _cuda_or_skip()
    rng = np.random.default_rng(k + 1)
    mono = chan_tail.MonoChain(mode, fmt, channel=5, audio_gain=2.0,
                               device=dev)
    st, n0 = random_mono_state(mono, rng, dev, 11)
    wire = torch.as_tensor(decode.quantize_iq(
        mono_input(mode, k * C.SUBCHUNK_IN, 1), fmt), device=dev)
    assert_bit_equal(mono(wire, *st, n0=n0), mono(wire, *st, n0=n0), "K4")
    band = mono.front(wire, *st[:3]).band
    assert_bit_equal(mono.tail(band, *st[3:], n0=n0),
                     mono.tail(band, *st[3:], n0=n0), "K5")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["dsd", "single"])
@pytest.mark.parametrize("fmt,k", [("cu8", 16), ("cs16", 15), ("cu8", 1)])
def test_mono_equals_front_then_tail_on_card(mode, fmt, k):
    """K4's outputs equal K6 -> K5's on the same wire and state, bit for
    bit, over two consecutive blocks: both run one copy of the front end's
    and the tail's device code."""
    from sdr_pmr446_tpu_torch.kernels import chan_tail
    dev = _cuda_or_skip()
    rng = np.random.default_rng(k + 2)
    mono = chan_tail.MonoChain(mode, fmt, channel=5, audio_gain=2.0,
                               device=dev)
    two = chan_tail.TwoKernelChain(mode, fmt, channel=5, audio_gain=2.0,
                                   device=dev)
    st, n0 = random_mono_state(mono, rng, dev, 7)
    a, na, b, nb_ = list(st), n0, list(st), n0
    for step in range(2):
        wire = torch.as_tensor(decode.quantize_iq(
            mono_input(mode, k * C.SUBCHUNK_IN, step), fmt), device=dev)
        ra, rb = mono(wire, *a, n0=na), two(wire, *b, n0=nb_)
        assert_bit_equal(ra, rb, f"block {step}")
        a, na, b, nb_ = list(ra[:6]), ra.n0, list(rb[:6]), rb.n0


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["cu8", "cs8", "cs16", "cf32"])
def test_zero_summary_kernel_matches_plain_on_card(fmt):
    """K10 vs its plain version on the wire of 4 streams x 5 shards at K = 8
    a shard (one launch): w within 1e-5 of its peak (128-term f32 sums in
    another order), xl exact."""
    from sdr_pmr446_tpu_torch.kernels import summary
    dev = _cuda_or_skip()
    rng = np.random.default_rng(5)
    n = 4 * 40 * C.SUBCHUNK_IN
    x = 0.3 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    wire = torch.as_tensor(decode.quantize_iq(x, fmt), device=dev)
    launches = summary.LAUNCHES
    w, xl = summary.zero_summary_wire(wire, fmt)
    wr, xr = summary.zero_summary_plain(wire, fmt)
    torch.cuda.synchronize(dev)
    assert summary.LAUNCHES == launches + 1
    assert w.shape == xl.shape == (2, n // 128)
    assert rel_err(w.cpu().numpy(), wr.cpu().numpy()) <= 1e-5
    assert torch.equal(xl, xr)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["cu8", "cs8", "cs16", "cf32"])
def test_zero_summary_kernel_ragged_rows_repeat_on_card(fmt):
    """K10 at row counts that leave a block's group ragged (1, 7 and 784 +
    3 rows), full-scale samples included: w within 1e-5 of its peak, xl
    exact, and a second call bit-equal to the first (a fixed order)."""
    from sdr_pmr446_tpu_torch.kernels import summary
    dev = _cuda_or_skip()
    rng = np.random.default_rng(13)
    for rows in (1, 7, 784 + 3):
        n = rows * 128
        x = 0.5 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
        x[::5] = np.sign(x[::5].real) + 1j * np.sign(x[::5].imag)
        wire = torch.as_tensor(decode.quantize_iq(x, fmt), device=dev)
        w, xl = summary.zero_summary_kernel(wire, fmt)
        w2, xl2 = summary.zero_summary_kernel(wire, fmt)
        wr, xr = summary.zero_summary_plain(wire, fmt)
        torch.cuda.synchronize(dev)
        assert w.shape == xl.shape == (2, rows)
        assert rel_err(w.cpu().numpy(), wr.cpu().numpy()) <= 1e-5, rows
        assert torch.equal(xl, xr), rows
        assert torch.equal(w.view(torch.int32), w2.view(torch.int32)), rows
        assert torch.equal(xl, xl2), rows
    with pytest.raises(ValueError, match="16-byte aligned"):
        summary.zero_summary_kernel(torch.zeros(2 * 256 + 8, dtype=torch.uint8,
                                                device=dev)[8:], "cu8")


@pytest.mark.cuda
@pytest.mark.parametrize("move", ["scratch_store_off16", "scratch_read_off16",
                                  "scratch_read_narrow", "value_lane_off16",
                                  "value_stride_sub", "reshape_rows_wide",
                                  "reshape_25_16", "transpose_16"])
def test_layout_move_repeats_on_a_side_stream_on_card(move):
    """Each K12a move twice on a non-default stream: both calls equal the
    plain version bit for bit, one launch each."""
    from sdr_pmr446_tpu_torch.kernels import probe_layout as K12a
    dev = _cuda_or_skip()
    shape = K12a.MOVES[move][0]
    x = torch.as_tensor(np.random.default_rng(21).standard_normal(
        shape).astype(np.float32), device=dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    launches = K12a.LAUNCHES[move]
    with torch.cuda.stream(side):
        a = K12a.probe_move_kernel(x, move)
        b = K12a.probe_move_kernel(x, move)
    side.synchronize()
    assert K12a.LAUNCHES[move] == launches + 2
    want = K12a.probe_move_plain(x, move).view(torch.int32)
    assert torch.equal(a.view(torch.int32), want)
    assert torch.equal(b.view(torch.int32), want)


@pytest.mark.cuda
def test_ring_shift_kernel_matches_roll_on_card():
    """K11 vs torch.roll, bit for bit: complex and real tails, contiguous
    and as slices of longer planes (per-shard strides), and
    halo.shard_hist with dma == without."""
    from sdr_pmr446_tpu_torch.kernels import halo_dma
    from sdr_pmr446_tpu_torch.parallel import halo
    dev = _cuda_or_skip()
    g = torch.Generator(device=dev).manual_seed(0)
    planes = torch.randn(4, 4, 1000, dtype=torch.complex64, device=dev,
                         generator=g)
    cases = [planes[..., -345:], planes[..., -400:].contiguous(),
             torch.randn(2, 3, 17, 5, device=dev, generator=g),
             torch.randn(3, 2, 7, dtype=torch.float64, device=dev,
                         generator=g)]
    for t in cases:
        launches = halo_dma.LAUNCHES
        got = halo_dma.ring_shift_right(t)
        torch.cuda.synchronize(dev)
        assert halo_dma.LAUNCHES == launches + 1
        assert torch.equal(got, torch.roll(t, 1, dims=1)), tuple(t.shape)
    carried = torch.randn(4, 345, dtype=torch.complex64, device=dev,
                          generator=g)
    for a, b in zip(halo.shard_hist(carried, planes, 345, dma=True),
                    halo.shard_hist(carried, planes, 345)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_shard_hist_planes_kernel_matches_plain_on_card():
    """K11's one-launch halo from the planes vs its plain version
    (torch.complex of the tails, then the collective's shift), bit for
    bit: the plane path's two halos (h = 345 of long planes, 400 of [4, 4,
    2, 416] tails), planes sliced out of longer ones at even and odd
    offsets (paired loads with and without a peeled sample, one sample a
    thread), a carried history with a stream stride, one time shard; one
    launch a call; halo.shard_hist_planes with dma == without."""
    from sdr_pmr446_tpu_torch.kernels import halo_dma
    from sdr_pmr446_tpu_torch.parallel import halo
    dev = _cuda_or_skip()
    g = torch.Generator(device=dev).manual_seed(1)
    big = torch.randn(4, 4, 2, 1003, device=dev, generator=g)
    wide = torch.randn(3, 5, 3, 20, device=dev, generator=g)
    cases = [(big, 345), (big[..., :416].contiguous(), 400),
             (big[..., 3:420], 400), (big[..., 1:], 345), (big[..., :-1], 8),
             (wide[:, 1:4, 1:], 7), (big[:, :1], 9)]
    bits = lambda t: torch.view_as_real(t).view(torch.int32)  # noqa: E731
    for i, (planes, h) in enumerate(cases):
        s, d = planes.shape[:2]
        carried = torch.randn(s, d + 1, h, dtype=torch.complex64,
                              device=dev, generator=g)
        carried = carried[:, -1] if i % 2 else carried[:, -1].contiguous()
        launches = halo_dma.LAUNCHES
        got = halo_dma.shard_hist_planes(carried, planes, h)
        torch.cuda.synchronize(dev)
        assert halo_dma.LAUNCHES == launches + 1
        want = halo_dma.shard_hist_planes_plain(carried, planes, h)
        for a, b in zip(got, want):
            assert torch.equal(bits(a), bits(b)), (i, tuple(planes.shape), h)
        for a, b in zip(halo.shard_hist_planes(carried, planes, h, True),
                        halo.shard_hist_planes(carried, planes, h)):
            assert torch.equal(bits(a), bits(b)), (i, "dma")
