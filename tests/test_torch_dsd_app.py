"""The port's dsd_in CLI vs the JAX app, and the entry points' default device.

The two apps read the same cs16 capture at K = 5 (the JAX app runs its op
path there; the port its plain PyTorch version on the CPU): the PCM files
have the same length and agree within 2 LSB, with at least 99.9 % of the
samples within 1 (tests/test_dsd_in.py:88-106 gates block-size invariance
the same way).  Every entry point defaults to the CUDA card: on this
CUDA-less host the defaults raise and the CLIs exit 1, so nothing falls
back to the CPU quietly.
"""

import numpy as np
import pytest
import torch

from sdr_pmr446_tpu import config as C
from sdr_pmr446_tpu.io import iq as iq_io

torch.set_num_threads(2)

K = 5


def write_fm_capture(path, blocks=2.5):
    """An FM tone capture 2.5 kHz off centre, 2.5 blocks long (the last
    block is padded by both apps)."""
    n = int(blocks * K * C.SUBCHUNK_IN)
    t = np.arange(n) / C.SDR_SAMPLERATE
    msg = 0.5 * np.sin(2 * np.pi * 1000.0 * t)
    iq = 0.8 * np.exp(1j * 2 * np.pi * (2000 * np.cumsum(msg)
                                        + 2500 * np.arange(n))
                      / C.SDR_SAMPLERATE)
    iq_io.write_iq(str(path), iq, "cs16")


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    path = tmp_path_factory.mktemp("dsd") / "cap.cs16"
    write_fm_capture(path)
    return path


def test_app_matches_jax_app(capture, tmp_path):
    from sdr_pmr446_tpu.apps import dsd_in as jax_app
    from sdr_pmr446_tpu_torch.apps import dsd_in as app
    o_jax, o_port = tmp_path / "jax.raw", tmp_path / "port.raw"
    base = ["--input", str(capture), "--subchunks-per-step", str(K)]
    assert jax_app.main(base + ["--output", str(o_jax)]) == 0
    assert app.main(base + ["--output", str(o_port), "--device", "cpu"]) == 0
    want = np.fromfile(o_jax, dtype="<i2").astype(np.int32)
    got = np.fromfile(o_port, dtype="<i2").astype(np.int32)
    assert len(got) == len(want) == 3 * K * C.SUBCHUNK_IN * 3 // 64
    d = np.abs(got - want)
    assert d.max() <= 2
    assert np.mean(d <= 1) >= 0.999


@pytest.mark.parametrize("steps", ["2", "3"])
def test_app_steps_per_dispatch_writes_the_same_pcm(steps, capture,
                                                    tmp_path):
    """--steps-per-dispatch S over the 3 blocks (a megastep and a 1-block
    tail at S = 2, one megastep at S = 3) writes the S = 1 run's PCM byte
    for byte."""
    from sdr_pmr446_tpu_torch.apps import dsd_in as app
    outs = []
    for s in ("1", steps):
        outs.append(tmp_path / f"s{s}.raw")
        assert app.main(["--input", str(capture), "--subchunks-per-step",
                         str(K), "--steps-per-dispatch", s, "--device",
                         "cpu", "--output", str(outs[-1])]) == 0
    assert outs[0].stat().st_size == 3 * K * C.SUBCHUNK_IN * 3 // 64 * 2
    assert outs[0].read_bytes() == outs[1].read_bytes()


def test_app_device_decode_is_accepted(capture, tmp_path):
    """--device-decode does nothing in the port (the wire is always decoded
    on the device): the output is byte-identical."""
    from sdr_pmr446_tpu_torch.apps import dsd_in as app
    o1, o2 = tmp_path / "a.raw", tmp_path / "b.raw"
    base = ["--input", str(capture), "--subchunks-per-step", str(K),
            "--device", "cpu"]
    assert app.main(base + ["--output", str(o1)]) == 0
    assert app.main(base + ["--output", str(o2), "--device-decode"]) == 0
    assert o1.read_bytes() == o2.read_bytes()


@pytest.mark.parametrize("argv,rc", [
    (["--input", "rtl_tcp://localhost:1234", "--device-decode"], 1),
    (["--device", "meta"], 1),
    ([], 1),
])
def test_app_rejects_unported_and_unavailable(argv, rc, capture, tmp_path):
    """--device-decode on a live rtl_tcp input (a file-only flag, as in
    JAX), a device the port cannot run on, and the default device on a
    host without CUDA, exit 1 with no output."""
    if not argv and torch.cuda.is_available():
        pytest.skip("the default device is available here")
    from sdr_pmr446_tpu_torch.apps import dsd_in as app
    out = tmp_path / "x.raw"
    if not any(a.startswith("rtl_tcp") for a in argv):
        argv = argv + ["--input", str(capture)]
    assert app.main(argv + ["--output", str(out)]) == rc
    assert not out.exists()


def test_scanner_cli_defaults_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("the default device is available here")
    from sdr_pmr446_tpu_torch.apps import sdr_pmr446 as app
    out = tmp_path / "a.wav"
    assert app.main(["--seconds", "0.2", "--output", str(out)]) == 1
    assert not out.exists()


@pytest.mark.parametrize("entry", ["ScannerDriver", "ScannerChain",
                                   "DsdInChain", "SingleChannelChain"])
def test_entry_points_default_to_cuda(entry):
    """With no device given, each entry point asks for the card and raises
    where there is none; device="cpu" is the only way to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("the default device is available here")
    from sdr_pmr446_tpu_torch.runtime.driver import ScannerDriver
    from sdr_pmr446_tpu_torch.scanner.chain import ScannerChain
    from sdr_pmr446_tpu_torch.scanner.dsd_in import DsdInChain
    from sdr_pmr446_tpu_torch.scanner.single import SingleChannelChain
    make = {"ScannerDriver": lambda **kw: ScannerDriver(**kw),
            "ScannerChain": lambda **kw: ScannerChain(**kw),
            "DsdInChain": lambda **kw: DsdInChain(**kw),
            "SingleChannelChain": lambda **kw: SingleChannelChain(5, **kw)}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make[entry]()
    assert make[entry](device="cpu").device == torch.device("cpu")


def test_app_exits_cleanly_on_a_closed_pipe(tmp_path):
    """dsd_in pipes into dsd / play and exits 0 when the consumer hangs up
    (the reference ignores SIGPIPE, src/sdr_pmr446.c:190-199).  20
    sub-chunks give 188 KB of PCM, more than the 64 KB pipe buffer and one
    read of `head` together, so the writer meets EPIPE whenever `head -c
    100` exits."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    cap = tmp_path / "cap.cs16"
    write_fm_capture(cap, blocks=4)              # 4 blocks of K = 5
    repo = Path(__file__).resolve().parent.parent
    env = dict(os.environ, PYTHONPATH=str(repo))
    cmd = (f"{sys.executable} -m sdr_pmr446_tpu_torch.apps.dsd_in "
           f"--input {cap} --output - --subchunks-per-step {K} "
           f"--device cpu | head -c 100 >/dev/null; exit ${{PIPESTATUS[0]}}")
    proc = subprocess.run(["/bin/bash", "-c", cmd], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "downstream pipe closed" in proc.stderr
