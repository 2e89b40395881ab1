"""The port's faithful mode (scanner/faithful.py) against JAX's and the oracle.

The same complex64 IQ goes through JAX's FaithfulScannerChain and the
port's at K = 5 (CPU, plain ops), computed once per module:

  - the busy scenario of tests/test_faithful.py (tune ch3, a stronger ch7
    takes the lock under lock_mode max, silence detunes, ch5 with CTCSS
    12): active_chan, audio_valid, ct_detected and ct_max_idx exact,
    rel_rssi within 1e-3 dB, audio SNR > 60 dB against JAX and against
    the port's float64 oracle through every transition (no sub-chunk
    excluded), the detector's final state equal to the oracle's;
  - the lowpass variant (channel 5 alone): the same gates; audio is gated
    on the active sub-chunks only, as JAX does (a noise-only sub-chunk's
    audio is f32 rounding through atan2);
  - the state's shapes, multi_step equal to its steps bit for bit (the
    loop on the CPU), and dc_blocker_apply's chunk= changes only f32
    rounding;
  - ``cuda``: on the card a step reads nothing back to the host (torch's
    sync debug mode) and the decisions equal the CPU run's;
  - the CLI's --faithful equals the chain on the same capture, and with
    --device-decode exits 1.
"""

import numpy as np
import pytest
import torch

from sdr_pmr446_tpu import config as C
from sdr_pmr446_tpu.io import iq as iq_io
from sdr_pmr446_tpu.io import synth, wav
from sdr_pmr446_tpu_torch import config as TC
from sdr_pmr446_tpu_torch.oracle.chain import ScannerOracle
from sdr_pmr446_tpu_torch.ops import iir
from sdr_pmr446_tpu_torch.scanner.chain import make_runtime_params
from sdr_pmr446_tpu_torch.scanner.faithful import FaithfulScannerChain

torch.set_num_threads(2)

K = 5
DECISIONS = ("active_chan", "audio_valid", "ct_detected", "ct_max_idx")


def busy_scenario():
    """tests/test_faithful.py::_busy_scenario, restated."""
    n1 = 15 * C.SUBCHUNK_IN
    seg1 = synth.make_scanner_iq(n1, channel=3, ctcss_code=20, seed=1)
    seg2a = synth.make_scanner_iq(n1, channel=3, amplitude=0.4,
                                  ctcss_code=20, seed=2, start_sample=n1)
    seg2b = synth.make_scanner_iq(n1, channel=7, amplitude=1.0,
                                  tone_hz=700.0, seed=3, start_sample=n1)
    rng = np.random.default_rng(4)
    seg3 = 1e-3 * (rng.standard_normal(n1) + 1j * rng.standard_normal(n1))
    seg4 = synth.make_scanner_iq(n1, channel=5, ctcss_code=12, seed=5,
                                 start_sample=3 * n1)
    return np.concatenate([seg1, seg2a + seg2b, seg3, seg4])


def run_port(iq, args):
    chain = FaithfulScannerChain(K, args.lowpass, device="cpu")
    params = make_runtime_params(args, "cpu")
    st, outs = chain.init_state(), []
    for i in range(len(iq) // chain.input_len):
        blk = iq[i * chain.input_len:(i + 1) * chain.input_len]
        st, o = chain.step(st, torch.from_numpy(blk.astype(np.complex64)),
                           params)
        outs.append(o)
    return {f: np.concatenate([getattr(o, f).numpy() for o in outs])
            for f in outs[0]._fields}


def run_jax(iq, args):
    import jax.numpy as jnp
    from sdr_pmr446_tpu.scanner.chain import make_runtime_params as jparams
    from sdr_pmr446_tpu.scanner.faithful import FaithfulScannerChain as JF
    chain = JF(subchunks_per_step=K, lowpass=args.lowpass)
    params = jparams(args)
    st, outs = chain.init_state(), []
    for i in range(len(iq) // chain.input_len):
        st, o = chain.step(st, jnp.asarray(
            iq[i * chain.input_len:(i + 1) * chain.input_len],
            jnp.complex64), params)
        outs.append(o)
    return {f: np.concatenate([np.asarray(getattr(o, f)) for o in outs])
            for f in outs[0]._fields}


@pytest.fixture(scope="module", params=["busy", "lowpass"])
def runs(request):
    """(port outputs, JAX outputs, oracle) for one scenario."""
    if request.param == "busy":
        iq = busy_scenario()
        jargs, targs = (C.ScannerArgs(lock_mode="max"),
                        TC.ScannerArgs(lock_mode="max"))
    else:
        iq = synth.make_scanner_iq(15 * C.SUBCHUNK_IN, channel=5,
                                   ctcss_code=12)
        jargs, targs = C.ScannerArgs(lowpass=True), TC.ScannerArgs(lowpass=True)
    ora = ScannerOracle(targs)
    ora.process(iq)
    return request.param, run_port(iq, targs), run_jax(iq, jargs), ora


def snr_db(ref, got):
    return 10 * np.log10(max(np.mean(ref ** 2), 1e-30)
                         / max(np.mean((got - ref) ** 2), 1e-30))


def test_faithful_matches_jax_and_oracle(runs):
    name, port, jax_out, ora = runs
    for f in DECISIONS:
        np.testing.assert_array_equal(port[f], jax_out[f], err_msg=f)
    np.testing.assert_allclose(port["rel_rssi"], jax_out["rel_rssi"],
                               rtol=0, atol=1e-3)
    np.testing.assert_array_equal(port["active_chan"],
                                  np.asarray(ora.active_trace))
    valid = port["audio_valid"]
    got = port["audio"][valid].ravel()
    assert snr_db(jax_out["audio"][valid].ravel(), got) > 60.0
    ora_audio = np.concatenate(ora.audio)
    assert got.shape == ora_audio.shape
    assert snr_db(ora_audio, got) > 60.0
    assert np.max(np.abs(got - ora_audio)) < 2e-2
    assert not port["audio"][~valid].any()
    assert bool(ora.goertzel.tone_detected) == bool(port["ct_detected"][-1])
    assert ora.goertzel.max_power_index == port["ct_max_idx"][-1]
    if name == "busy":
        kinds = [e.kind for e in ora.events]
        assert "tuned" in kinds and "changed" in kinds and "detuned" in kinds


def test_faithful_step_shapes_and_unported_multi_step():
    chain = FaithfulScannerChain(2, device="cpu")
    params = make_runtime_params(TC.ScannerArgs(), "cpu")
    iq = synth.make_scanner_iq(chain.input_len, channel=5).astype(np.complex64)
    st, out = chain.step(chain.init_state(), torch.from_numpy(iq), params)
    assert out.audio.shape == (2, TC.SUBCHUNK_AUDIO)
    assert st.hp_hist.shape == (TC.HP_AUDIO_FILT_TAPS - 1,)
    assert st.resamp_hist.shape == (345,) and st.lp_hist.shape == (102,)
    iqs = torch.from_numpy(synth.make_scanner_iq(
        2 * chain.input_len, channel=5, start_sample=chain.input_len
    ).astype(np.complex64)).reshape(2, -1)
    st_a, outs = st, []
    for x in iqs:
        st_a, o = chain.step(st_a, x, params)
        outs.append(o)
    st_b, fused = chain.multi_step(st, iqs, params)
    for f, got in zip(fused._fields, fused):
        assert torch.equal(got, torch.cat([getattr(o, f) for o in outs])), f
    assert fused.audio.shape == (4, TC.SUBCHUNK_AUDIO)
    for f, a, b in zip(st_a._fields, st_a, st_b):
        assert torch.equal(a, b), f
    with pytest.raises(ValueError, match="complex64"):
        chain.step(st, torch.from_numpy(iq[:-16]), params)


@pytest.mark.cuda
def test_faithful_on_card_reads_nothing_back_and_equals_cpu():
    """On the card: every step after the first (which puts the chain's
    constant tables on the card) under set_sync_debug_mode("error"), the
    decisions equal to the CPU run's, audio > 100 dB against it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    iq = busy_scenario()[:20 * C.SUBCHUNK_IN].astype(np.complex64)
    args = TC.ScannerArgs(lock_mode="max")
    cpu = run_port(iq, args)
    chain = FaithfulScannerChain(K, device=dev)
    params = make_runtime_params(args, dev)
    st, outs = chain.init_state(), []
    for i in range(len(iq) // chain.input_len):
        blk = torch.from_numpy(iq[i * chain.input_len:
                                  (i + 1) * chain.input_len]).to(dev)
        torch.cuda.synchronize(dev)
        torch.cuda.set_sync_debug_mode("error" if i else "default")
        try:
            st, o = chain.step(st, blk, params)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        outs.append(o)
    got = {f: np.concatenate([getattr(o, f).cpu().numpy() for o in outs])
           for f in outs[0]._fields}
    for f in DECISIONS:
        np.testing.assert_array_equal(got[f], cpu[f], err_msg=f)
    v = cpu["audio_valid"]
    assert snr_db(cpu["audio"][v].ravel(), got["audio"][v].ravel()) > 100.0


def test_dc_blocker_chunk_changes_only_rounding():
    """Faithful mode's gated DC blocker scans in chunks of 256 (JAX's
    chunk=256); with the default 128 or with 256 the output stays within
    f32 rounding (2e-6 of its peak) of the float64 recurrence."""
    xd = np.random.default_rng(0).standard_normal((2, 1225))
    x0, y0 = np.array([0.3, -0.2]), np.array([0.1, 0.05])
    p = 1.0 - TC.DC_BLOCK_ALPHA
    g = (1.0 + p) / 2.0
    want, xp, yp = np.zeros_like(xd), x0, y0
    for n in range(xd.shape[1]):
        yp = p * yp + g * (xd[:, n] - xp)
        xp, want[:, n] = xd[:, n], yp
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    for chunk in (128, 256):
        (x1, y1), y = iir.dc_blocker_apply((f32(x0), f32(y0)), f32(xd),
                                           TC.DC_BLOCK_ALPHA, chunk=chunk)
        tol = 2e-6 * np.abs(want).max()
        np.testing.assert_allclose(y.numpy(), want, rtol=0, atol=tol)
        np.testing.assert_allclose(y1.numpy(), want[:, -1], rtol=0, atol=tol)
        assert torch.equal(x1, f32(xd[:, -1]))


def test_app_faithful_matches_chain(tmp_path):
    from sdr_pmr446_tpu_torch.apps import sdr_pmr446 as app
    iq = synth.make_scanner_iq(2 * K * C.SUBCHUNK_IN + 1000, channel=5,
                               ctcss_code=12)
    path = str(tmp_path / "cap.cf32")
    iq_io.write_iq(path, iq, "cf32")
    base = ["--input", path, "--subchunks-per-step", str(K), "--device",
            "cpu", "--faithful"]
    out = str(tmp_path / "f.wav")
    assert app.main(base + ["--output", out]) == 0
    want = run_port(iq.astype(np.complex64), TC.ScannerArgs())
    got, sr = wav.read_wav(out)
    assert sr == C.AUDIO_SAMPLERATE
    np.testing.assert_array_equal(
        got, want["audio"][want["audio_valid"]].ravel())
    assert app.main(base + ["--output", str(tmp_path / "g.wav"),
                            "--device-decode"]) == 1
