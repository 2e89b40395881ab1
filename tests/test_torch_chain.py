"""The port's scanner slice on the CPU vs the JAX kernel engine and the oracle.

The JAX side runs ScannerChain(use_pallas=True, pallas_interpret=True), the
recorded default engine, on the same capture bytes; decisions and events
must be exact, rssi_db within 5e-3 dB and audio within 1e-4 (the trio/duo
gate of tests/test_scanner.py:318-337).
"""

import os
import tempfile

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sdr_pmr446_tpu import config as C
from sdr_pmr446_tpu.io import synth
from sdr_pmr446_tpu.ops import decode as jdecode
from sdr_pmr446_tpu.oracle.chain import ScannerOracle
from sdr_pmr446_tpu_torch.ops import decode
from sdr_pmr446_tpu_torch.runtime import state as tstate
from sdr_pmr446_tpu_torch.scanner.chain import (ScannerChain,
                                                make_runtime_params,
                                                outputs_to_numpy)

torch.set_num_threads(2)

K = 8
FLOAT_FIELDS = ("audio", "rel_rssi", "rssi_db", "ct_freq", "waterfall")


def assert_outputs_match(port: dict, ref: dict, what: str):
    for f, want in ref.items():
        got = port[f]
        if f in FLOAT_FIELDS:
            continue
        np.testing.assert_array_equal(got, want, err_msg=f"{what}: {f}")
    np.testing.assert_allclose(port["rssi_db"], ref["rssi_db"], rtol=0,
                               atol=5e-3)
    np.testing.assert_allclose(port["rel_rssi"], ref["rel_rssi"], rtol=0,
                               atol=5e-3)
    np.testing.assert_array_equal(port["ct_freq"], ref["ct_freq"])
    assert np.max(np.abs(port["audio"] - ref["audio"])) < 1e-4, what


@pytest.fixture(scope="module")
def jax_run():
    """Two K=8 steps of the JAX kernel engine on a cu8 capture: the wire
    bytes, each step's outputs and the state after each step."""
    from sdr_pmr446_tpu.scanner.chain import ScannerChain as JaxChain
    from sdr_pmr446_tpu.scanner.chain import make_runtime_params as jparams
    iq = synth.make_scanner_iq(16 * C.SUBCHUNK_IN, channel=5, ctcss_code=12)
    words = jdecode.pack_iq(iq, "cu8")
    chain = JaxChain(C.BlockConfig(K), use_pallas=True, pallas_interpret=True,
                     input_format="cu8")
    params = jparams(C.ScannerArgs())
    st = chain.init_state()
    states, outs, wires = [[np.asarray(v) for v in st]], [], []
    wl = chain.step_arg_len
    for i in range(2):
        w = words[i * wl:(i + 1) * wl]
        st, o = chain.step(st, jnp.asarray(w).reshape(chain.step_arg_shape),
                           params)
        outs.append({f: np.asarray(v) for f, v in zip(o._fields, o)})
        states.append([np.asarray(v) for v in st])
        wires.append(w.view(np.uint8).copy())
    return dict(wires=wires, outs=outs, states=states)


def assert_same_layout(state, reference):
    """Every state field has the reference's shape and dtype."""
    for name, cur, ref in zip(tstate.ScannerState._fields, state, reference):
        assert (cur.shape, cur.dtype) == (ref.shape, ref.dtype), name


def port_chain(**kw):
    return ScannerChain(C.BlockConfig(K), input_format="cu8", device="cpu",
                        **kw)


def test_slice_matches_jax_kernel_engine(jax_run):
    chain = port_chain()
    st = chain.init_state()
    assert_same_layout(tstate.state_from_numpy(jax_run["states"][0], "cpu"),
                       st)
    params = make_runtime_params(C.ScannerArgs(), "cpu")
    for i in range(2):
        st, o = chain.step(st, torch.from_numpy(jax_run["wires"][i]), params)
        assert_outputs_match(outputs_to_numpy(o), jax_run["outs"][i],
                             f"step {i}")
    assert int(st.active_chan) == 4 and int(st.ct_max_idx) == 11


def test_state_handoff_from_jax(jax_run):
    """The JAX state after step 1 loads into the port, and step 2 gives the
    JAX step 2 results."""
    chain = port_chain()
    st = tstate.state_from_numpy(jax_run["states"][1], "cpu")
    assert_same_layout(st, chain.init_state())
    back = tstate.state_to_numpy(st)
    for a, b in zip(back, jax_run["states"][1]):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    _, o = chain.step(st, torch.from_numpy(jax_run["wires"][1]),
                      make_runtime_params(C.ScannerArgs(), "cpu"))
    assert_outputs_match(outputs_to_numpy(o), jax_run["outs"][1], "resumed")


def test_npz_state_saved_by_jax_resumes_in_port(jax_run):
    from sdr_pmr446_tpu.runtime import state as jstate
    jst = jstate.ScannerState(*(jnp.asarray(v) for v in jax_run["states"][1]))
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "ckpt.npz")
        jstate.save_state(path, 1, jst)
        idx, st = tstate.load_state(path, "cpu")
        assert idx == 1
        # and the port's checkpoint reads back in the JAX package
        path2 = os.path.join(d, "port.npz")
        tstate.save_state(path2, 1, st)
        idx2, jback = jstate.load_state(path2)
        assert idx2 == 1
        for a, b in zip(jback, jax_run["states"][1]):
            np.testing.assert_array_equal(np.asarray(a), b)
    _, o = port_chain().step(st, torch.from_numpy(jax_run["wires"][1]),
                             make_runtime_params(C.ScannerArgs(), "cpu"))
    assert_outputs_match(outputs_to_numpy(o), jax_run["outs"][1], "npz")


def oracle_capture(variant):
    n = 30 * C.SUBCHUNK_IN
    if variant == "lock_max":
        half = n // 2
        iq = np.concatenate([
            synth.make_scanner_iq(half, channel=2, amplitude=0.5),
            synth.make_scanner_iq(half, channel=2, amplitude=0.5, seed=10,
                                  start_sample=half)
            + synth.make_scanner_iq(half, channel=7, amplitude=1.0,
                                    tone_hz=700.0, seed=9,
                                    start_sample=half)])
        return iq, C.ScannerArgs(lock_mode="max")
    args = (C.ScannerArgs(lowpass=True, fir_deemph=True)
            if variant == "lowpass_fir_deemph" else C.ScannerArgs())
    return synth.make_scanner_iq(n, channel=5, ctcss_code=12), args


@pytest.mark.parametrize("variant", ["default", "lowpass_fir_deemph",
                                     "lock_max"])
def test_slice_matches_oracle_k10(variant):
    """K = 10 — which the JAX kernel engine cannot take (its group path needs
    K % 8 == 0): the active-channel trace exactly, audio SNR > 40 dB
    (tests/test_scanner.py:61-111)."""
    iq, args = oracle_capture(variant)
    raw = decode.quantize_iq(iq, "cu8")
    host_iq = ((raw.astype(np.float64) - 127.5) / 127.5).view(np.complex128)
    ora = ScannerOracle(args)
    ora.process(host_iq)
    chain = ScannerChain(C.BlockConfig(10), lowpass=args.lowpass,
                         fir_deemph=args.fir_deemph, input_format="cu8",
                         device="cpu")
    params = make_runtime_params(args, "cpu")
    st = chain.init_state()
    outs = []
    step = chain.step_arg_len
    for i in range(len(raw) // step):
        st, o = chain.step(st, torch.from_numpy(raw[i * step:(i + 1) * step]),
                           params)
        outs.append(outputs_to_numpy(o))
    cat = lambda f: np.concatenate([o[f] for o in outs])
    np.testing.assert_array_equal(cat("active_chan"),
                                  np.asarray(ora.active_trace))
    # skip the filters' settling after each tune or channel change (the
    # chain filters every channel continuously, the reference only the
    # active one: a documented transition transient, scanner/chain.py:13-21)
    act = cat("active_chan")[cat("audio_valid")]
    settled = np.array([i >= 2 and act[i - 2] == act[i]
                        for i in range(len(act))])
    got = cat("audio")[cat("audio_valid")][settled].ravel()
    want = np.stack(ora.audio)[settled].ravel()
    snr = 10 * np.log10(np.mean(want ** 2)
                        / max(np.mean((got - want) ** 2), 1e-30))
    assert snr > 40.0, f"audio SNR vs oracle {snr:.1f} dB"
    if variant == "lock_max":
        assert cat("ev_changed").sum() >= 1 and cat("active_chan")[-1] == 6
    else:
        assert cat("ct_detected")[-1] and cat("ct_max_idx")[-1] == 11


def write_capture(path):
    """cs16 capture: channel 5 with CTCSS code 12, then silence."""
    from sdr_pmr446_tpu.io import iq as iq_io
    n1, n2 = 20 * C.SUBCHUNK_IN, 10 * C.SUBCHUNK_IN
    rng = np.random.default_rng(1)
    iq_io.write_iq(str(path), np.concatenate([
        0.7 * synth.make_scanner_iq(n1, channel=5, ctcss_code=12),
        1e-3 * (rng.standard_normal(n2) + 1j * rng.standard_normal(n2))]),
        "cs16")


@pytest.mark.parametrize("steps", ["3", "4"])
def test_app_steps_per_dispatch_writes_the_same_wav(steps, tmp_path):
    """--steps-per-dispatch S (6 blocks: two megasteps at S = 3, a megastep
    and a 2-block tail at S = 4) writes the S = 1 run's WAV byte for
    byte."""
    from sdr_pmr446_tpu_torch.apps import sdr_pmr446 as app
    path = tmp_path / "cap.cs16"
    write_capture(path)
    wavs = []
    for s in ("1", steps):
        wavs.append(tmp_path / f"s{s}.wav")
        assert app.main(["--input", str(path), "--output", str(wavs[-1]),
                         "-p", "max", "--subchunks-per-step", "5",
                         "--steps-per-dispatch", s, "--device", "cpu"]) == 0
    assert wavs[0].stat().st_size > 44
    assert wavs[0].read_bytes() == wavs[1].read_bytes()


def test_driver_event_lines_match_jax(tmp_path):
    """The port's driver and the JAX driver print the same reference-format
    lines on the same cs16 capture (tune, CTCSS, detune at the silence)."""
    from sdr_pmr446_tpu.io import iq as iq_io
    from sdr_pmr446_tpu.runtime.driver import ScannerDriver as JaxDriver
    from sdr_pmr446_tpu_torch.runtime.driver import ScannerDriver, wire_blocks
    path = tmp_path / "cap.cs16"
    write_capture(path)
    raw = np.fromfile(path, dtype=np.uint8)
    jd = JaxDriver(subchunks_per_step=5, input_format="cs16", engine="xla")
    jres = jd.run(iq_io.block_stream(jdecode.pack_bytes(
        raw.view(np.int16), "cs16"), jd.feed_len))
    td = ScannerDriver(subchunks_per_step=5, input_format="cs16",
                       device="cpu")
    tres = td.run(wire_blocks(raw, "cs16", td.feed_len))
    assert tres.events == jres.events
    assert any(e.startswith("Tuned to channel 5") for e in tres.events)
    assert any(e.startswith("Acquired CTCSS code: 12") for e in tres.events)
    assert any(e.startswith("Detuned from channel 5") for e in tres.events)
    np.testing.assert_array_equal(tres.active_trace, jres.active_trace)
    np.testing.assert_array_equal(tres.audio_subchunks, jres.audio_subchunks)
    assert np.max(np.abs(tres.audio - jres.audio)) < 1e-4


def test_app_scans_capture_on_cpu(tmp_path, caplog):
    """The CLI on the CPU: the capture's events in the log and its audio in
    the WAV (21 sub-chunks, 2.06 s at 12.5 kHz).  Under lock_mode=max the
    silence first moves the lock to its loudest noise channel, then
    detunes."""
    import logging
    from sdr_pmr446_tpu.io import wav
    from sdr_pmr446_tpu_torch.apps import sdr_pmr446 as app
    path, out = tmp_path / "cap.cs16", tmp_path / "a.wav"
    write_capture(path)
    with caplog.at_level(logging.INFO, logger="sdr_pmr446"):
        rc = app.main(["--input", str(path), "--output", str(out),
                       "-p", "max", "--subchunks-per-step", "5",
                       "--device", "cpu"])
    assert rc == 0
    lines = [r.getMessage() for r in caplog.records]
    for want in ("Tuned to channel 5", "Acquired CTCSS code: 12",
                 "Changed active channel from 5", "Detuned from channel"):
        assert any(m.startswith(want) for m in lines), want
    audio, rate = wav.read_wav(str(out))
    assert rate == C.AUDIO_SAMPLERATE
    assert len(audio) == 21 * C.SUBCHUNK_AUDIO


@pytest.mark.parametrize("argv,rc", [
    (["-w", "6"], 1),
    (["--checkpoint-backend", "orbax", "--checkpoint", "no_such_ckpt.dir",
      "--resume", "--device", "cpu"], 1),
    (["-b", "nosuch"], 1),
    (["--input", "rtl_tcp://localhost:1234", "--faithful"], 1),
    (["-m", "1-64"], 1), (["-m", "65"], 1),
    (["--device", "meta"], 1), (["--device-decode", "--device", "cpu"], 1),
    (["--resume", "--device", "cpu"], 1)])
def test_app_rejects_unported_and_bad_flags(argv, rc, tmp_path):
    """An audio API that is not compiled in, --faithful on a live rtl_tcp
    input, an empty channel mask, a channel out of range, an invalid
    waterfall width, a device that is neither cuda nor cpu,
    --device-decode without a capture file (as in JAX), --resume without
    --checkpoint and an orbax --resume of a missing directory exit 1 and
    write no WAV."""
    from sdr_pmr446_tpu_torch.apps import sdr_pmr446 as app
    out = tmp_path / "a.wav"
    assert app.main(argv + ["--seconds", "0.2", "--output", str(out)]) == rc
    assert not out.exists()
