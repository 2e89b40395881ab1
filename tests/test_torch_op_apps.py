"""``--engine op`` in the port's three CLIs, against the JAX CLIs' op engine.

  - apps/sdr_pmr446.py: the WAV of ``--engine op --device cpu`` against the
    JAX CLI's ``--engine xla`` on a cs16 capture (channel 5 with CTCSS 12,
    then silence), within 1e-4 of the peak after the 16-bit WAV rounding,
    and the same event lines; a checkpoint the JAX CLI wrote (its op
    engine's layout) resumes with ``--engine op`` equal to the JAX run's
    tail, and the kernel engine's CLI refuses it (exit 1);
  - apps/dsd_in.py: ``--engine op`` PCM within 1 LSB of the JAX CLI's
    ``--engine xla``;
  - apps/scan_batch.py: ``--engine op`` at ``--mesh 2,2`` (K_local = 2)
    against the JAX CLI's ``--engine xla`` on the virtual CPU mesh: the
    same event logs, audio SNR > 40 dB (tests/test_torch_scan_batch.py's
    gate); ``--resume`` with the other engine's checkpoint exits 1.
"""

import logging
import os

import numpy as np
import pytest
import torch

from sdr_pmr446_tpu import config as C
from sdr_pmr446_tpu.io import iq as jiq
from sdr_pmr446_tpu.io import synth
from sdr_pmr446_tpu_torch.io import wav

torch.set_num_threads(2)

K = 5


@pytest.fixture(scope="module")
def scan_capture(tmp_path_factory):
    """cs16: 10 sub-chunks of channel 5 with CTCSS 12, then 5 of silence
    (three blocks of K = 5); also its first block alone."""
    d = tmp_path_factory.mktemp("op_cli")
    rng = np.random.default_rng(2)
    n1, n2 = 10 * C.SUBCHUNK_IN, 5 * C.SUBCHUNK_IN
    iq = np.concatenate([
        0.7 * synth.make_scanner_iq(n1, channel=5, ctcss_code=12),
        1e-3 * (rng.standard_normal(n2) + 1j * rng.standard_normal(n2))])
    full, first = str(d / "cap.cs16"), str(d / "first.cs16")
    jiq.write_iq(full, iq, "cs16")
    jiq.write_iq(first, iq[:K * C.SUBCHUNK_IN], "cs16")
    return d, full, first


def run_cli(main, argv, caplog):
    caplog.clear()
    with caplog.at_level(logging.INFO):
        rc = main(argv)
    events = [r.getMessage() for r in caplog.records
              if r.getMessage().split(" ")[0] in ("Tuned", "Detuned",
                                                  "Changed", "Acquired",
                                                  "CTCSS", "Lost")]
    return rc, events


def test_scanner_cli_op_engine_matches_jax(scan_capture, caplog):
    from sdr_pmr446_tpu.apps import sdr_pmr446 as jax_app
    from sdr_pmr446_tpu_torch.apps import sdr_pmr446 as app
    d, full, first = scan_capture
    base = ["--input", full, "-p", "max", "--subchunks-per-step", str(K)]
    rc, jev = run_cli(jax_app.main, base + ["--engine", "xla", "--output",
                                            str(d / "jax.wav")], caplog)
    assert rc == 0
    rc, pev = run_cli(app.main, base + ["--engine", "op", "--device", "cpu",
                                        "--output", str(d / "port.wav")],
                      caplog)
    assert rc == 0 and pev == jev
    assert "Tuned to channel 5 (RSSI" in pev[0]
    assert any("Acquired CTCSS code: 12" in e for e in pev)
    want, _ = wav.read_wav(str(d / "jax.wav"))
    got, _ = wav.read_wav(str(d / "port.wav"))
    assert len(got) == len(want) > 0
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max() + 2**-15

    # the JAX CLI's checkpoint after the first block: the op engine resumes
    ckpt = str(d / "jax_ckpt.npz")
    assert jax_app.main(["--input", first, "-p", "max", "--subchunks-per-"
                         "step", str(K), "--engine", "xla", "--output",
                         str(d / "j1.wav"), "--checkpoint", ckpt]) == 0
    resumed = base + ["--device", "cpu", "--checkpoint", ckpt, "--resume"]
    assert app.main(resumed + ["--engine", "kernel", "--output",
                               str(d / "k.wav")]) == 1
    assert app.main(resumed + ["--engine", "op", "--output",
                               str(d / "r.wav")]) == 0
    first_audio, _ = wav.read_wav(str(d / "j1.wav"))
    tail, _ = wav.read_wav(str(d / "r.wav"))
    assert len(first_audio) + len(tail) == len(want)
    assert (np.abs(tail - want[len(first_audio):]).max()
            <= 1e-4 * np.abs(want).max() + 2**-15)


def test_dsd_cli_op_engine_matches_jax(tmp_path):
    from sdr_pmr446_tpu.apps import dsd_in as jax_app
    from sdr_pmr446_tpu_torch.apps import dsd_in as app
    n = 2 * K * C.SUBCHUNK_IN
    t = np.arange(n) / C.SDR_SAMPLERATE
    msg = 0.5 * np.sin(2 * np.pi * 1000.0 * t)
    cap = str(tmp_path / "fm.cs16")
    jiq.write_iq(cap, 0.8 * np.exp(1j * 2 * np.pi * (
        2000 * np.cumsum(msg) + 2500 * np.arange(n)) / C.SDR_SAMPLERATE),
        "cs16")
    base = ["--input", cap, "--subchunks-per-step", str(K)]
    assert jax_app.main(base + ["--engine", "xla", "--output",
                                str(tmp_path / "jax.raw")]) == 0
    assert app.main(base + ["--engine", "op", "--device", "cpu",
                            "--output", str(tmp_path / "port.raw")]) == 0
    want = np.fromfile(tmp_path / "jax.raw", "<i2").astype(np.int32)
    got = np.fromfile(tmp_path / "port.raw", "<i2").astype(np.int32)
    assert len(got) == len(want) == n * 3 // 64
    assert np.abs(got - want).max() <= 1


def test_scan_batch_op_engine_matches_jax(tmp_path):
    from sdr_pmr446_tpu.apps import scan_batch as jax_app
    from sdr_pmr446_tpu_torch.apps import scan_batch as app
    caps = []
    for s, (ch, code) in enumerate(((5, 12), (9, 20))):
        caps.append(str(tmp_path / f"cap{s}.cs16"))
        jiq.write_iq(caps[-1], 0.8 * synth.make_scanner_iq(
            8 * C.SUBCHUNK_IN, channel=ch, ctcss_code=code, seed=s), "cs16")
    base = caps + ["--subchunks-per-step", "4", "--mesh", "2,2"]
    jd, pd = str(tmp_path / "jax"), str(tmp_path / "port")
    assert jax_app.main(base + ["--engine", "xla", "--out-dir", jd]) == 0
    stats = {}
    assert app.main(base + ["--engine", "op", "--device", "cpu",
                            "--out-dir", pd], stats=stats) == 0
    assert stats["engine"] == "op"
    for s, (ch, code) in enumerate(((5, 12), (9, 20))):
        ev = [open(os.path.join(r, f"cap{s}.events.log")).read()
              for r in (jd, pd)]
        assert ev[1] == ev[0] and f"Acquired CTCSS code: {code}" in ev[1]
        want, _ = wav.read_wav(os.path.join(jd, f"cap{s}.wav"))
        got, _ = wav.read_wav(os.path.join(pd, f"cap{s}.wav"))
        assert len(got) == len(want) > 0
        err = np.mean((got.astype(np.float64) - want) ** 2)
        assert 10 * np.log10(np.mean(want.astype(np.float64) ** 2)
                             / max(err, 1e-30)) > 40.0
    # a checkpoint resumes only on its own engine
    for engine, other in (("op", "kernel"), ("kernel", "op")):
        ck = str(tmp_path / f"{engine}.npz")
        port = base + ["--device", "cpu", "--checkpoint", ck]
        assert app.main(port + ["--engine", engine, "--out-dir", pd,
                                "--stop-after", "1"]) == 0
        assert app.main(port + ["--engine", other, "--out-dir", pd,
                                "--resume"]) == 1
