"""The port's scanner CLI and driver: a clean stop and --device-decode.

  - ``ScannerDriver.request_stop()`` ends ``run()`` at the next block
    boundary with the step in flight drained: the partial result is the
    leading sub-chunks of an uninterrupted run, exactly;
  - SIGTERM to the running CLI logs "Signal caught, exiting!", writes the
    partial WAV and exits 0, and with --checkpoint flushes a final
    checkpoint that restores at the block the run stopped at (the port's
    counterpart of tests/test_driver_apps.py::
    test_scanner_app_sigterm_graceful).  The child scans a 120 s capture
    (some 240 blocks), so it is still running when the signal lands even
    if the test process is descheduled for seconds;
  - ``--device-decode`` is accepted and changes nothing: the port always
    decodes the wire on the device, so the WAV is identical with and
    without it on a cs16 and a cf32 capture (the counterpart of
    test_scanner_app_device_decode_matches_host_decode); on the synthetic
    input it exits 1, as in JAX (tests/test_torch_chain.py).
"""

import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from sdr_pmr446_tpu import config as C
from sdr_pmr446_tpu.io import iq as iq_io
from sdr_pmr446_tpu.io import synth, wav

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def capture(path, fmt):
    """Channel 5 with CTCSS 12, then silence: 15 sub-chunks."""
    n1, n2 = 10 * C.SUBCHUNK_IN, 5 * C.SUBCHUNK_IN
    rng = np.random.default_rng(2)
    iq_io.write_iq(str(path), np.concatenate([
        0.7 * synth.make_scanner_iq(n1, channel=5, ctcss_code=12),
        1e-3 * (rng.standard_normal(n2) + 1j * rng.standard_normal(n2))]),
        fmt)


def test_request_stop_returns_the_leading_subchunks(tmp_path):
    """request_stop() from on_subchunk in block 1: run() finishes the step
    in flight (block 2, dispatched before block 1 was drained), drains it
    and returns sub-chunks 0-9 of the uninterrupted run, exactly."""
    from sdr_pmr446_tpu_torch.runtime.driver import ScannerDriver, wire_blocks
    path = tmp_path / "cap.cs16"
    capture(path, "cs16")
    raw = np.fromfile(path, dtype=np.uint8)
    make = lambda **kw: ScannerDriver(subchunks_per_step=5,
                                      input_format="cs16", device="cpu", **kw)
    full_drv = make()
    full = full_drv.run(wire_blocks(raw, "cs16", full_drv.feed_len))
    assert not full_drv.stopped and len(full.active_trace) == 15

    def on_subchunk(sub, o):
        if sub == 2:
            drv.request_stop()
    drv = make(on_subchunk=on_subchunk)
    part = drv.run(wire_blocks(raw, "cs16", drv.feed_len))
    assert drv.stopped and drv.block_index == 2
    n = len(part.active_trace)
    assert n == 10
    np.testing.assert_array_equal(part.active_trace, full.active_trace[:n])
    np.testing.assert_array_equal(part.rssi_trace, full.rssi_trace[:n])
    np.testing.assert_array_equal(part.audio, full.audio[:len(part.audio)])
    np.testing.assert_array_equal(part.audio_subchunks,
                                  full.audio_subchunks[
                                      :len(part.audio_subchunks)])
    assert part.events == full.events[:len(part.events)]
    assert any(e.startswith("Tuned to channel 5") for e in part.events)
    # the stop is one-shot: the next run() consumes its blocks to the end
    rest = drv.run(wire_blocks(raw, "cs16", drv.feed_len))
    assert not drv.stopped and len(rest.active_trace) == 15


@pytest.fixture(scope="module")
def long_capture(tmp_path_factory):
    """A cu8 capture of 1220 sub-chunks (119.6 s): channel 5 with CTCSS 12
    from the first sample, its 10-sub-chunk block repeated."""
    from sdr_pmr446_tpu_torch.ops import decode
    blk = decode.quantize_iq(0.7 * synth.make_scanner_iq(
        10 * C.SUBCHUNK_IN, channel=5, ctcss_code=12), "cu8").tobytes()
    path = tmp_path_factory.mktemp("long") / "cap.cu8"
    with open(path, "wb") as f:
        for _ in range(LONG_BLOCKS):
            f.write(blk)
    return str(path)


LONG_BLOCKS = 122                 # 10-sub-chunk blocks of long_capture


def sigterm_run(capture, out, *extra):
    """Run the CLI on ``capture``, send SIGTERM once it has tuned; returns
    (exit code, the stderr after the signal, all stderr)."""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "sdr_pmr446_tpu_torch.apps.sdr_pmr446",
         "--input", capture, "--subchunks-per-step", "5", "--output", out,
         "-p", "max", "--device", "cpu", *extra],
        stderr=subprocess.PIPE, text=True, env=env, cwd=REPO)
    seen = []
    try:
        # wait until the scan loop is demonstrably running, then TERM it
        tuned = False
        for line in proc.stderr:
            seen.append(line)
            if "Tuned to channel" in line:
                tuned = True
                break
        assert tuned, "scanner never tuned:\n" + "".join(seen)
        proc.send_signal(signal.SIGTERM)
        rest = proc.stderr.read()
        seen.append(rest)
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return rc, rest, "".join(seen)


def test_scanner_app_sigterm_graceful(long_capture, tmp_path):
    """A real SIGTERM to the running CLI (--device cpu) exits 0 with the
    partial WAV written."""
    out = str(tmp_path / "sig.wav")
    rc, rest, seen = sigterm_run(long_capture, out)
    assert rc == 0, seen
    assert "Signal caught, exiting!" in rest
    assert "wrote" in rest and "audio samples" in rest
    x, sr = wav.read_wav(out)
    assert sr == C.AUDIO_SAMPLERATE
    assert 0 < len(x) < LONG_BLOCKS * 10 * C.SUBCHUNK_AUDIO


def test_scanner_app_sigterm_flushes_checkpoint(long_capture, tmp_path):
    """With --checkpoint and --checkpoint-every 0 only the stop's final
    flush writes the checkpoint; it holds the block the run stopped at,
    whose sub-chunks the partial WAV covers, and restores there."""
    from sdr_pmr446_tpu_torch.runtime.driver import ScannerDriver
    out, ckpt = str(tmp_path / "sig.wav"), str(tmp_path / "sig.npz")
    rc, rest, seen = sigterm_run(long_capture, out, "--checkpoint", ckpt,
                                 "--checkpoint-every", "0")
    assert rc == 0, seen
    assert "Signal caught, exiting!" in rest
    with np.load(ckpt) as z:
        blocks = int(z["block_index"])
    assert 0 < blocks < LONG_BLOCKS * 2
    x, _ = wav.read_wav(out)
    assert len(x) == blocks * 5 * C.SUBCHUNK_AUDIO
    drv = ScannerDriver(subchunks_per_step=5, input_format="cu8",
                        device="cpu")
    assert drv.restore(ckpt) == blocks


@pytest.mark.parametrize("fmt", ["cs16", "cf32"])
def test_scanner_app_device_decode_is_a_no_op(fmt, tmp_path):
    from sdr_pmr446_tpu_torch.apps import sdr_pmr446 as app
    path = tmp_path / f"cap.{fmt}"
    capture(path, fmt)
    base = ["--input", str(path), "--subchunks-per-step", "5", "-p", "max",
            "--device", "cpu"]
    outs = []
    for extra in ([], ["--device-decode"]):
        o = str(tmp_path / f"out{len(extra)}.wav")
        assert app.main(base + ["--output", o] + extra) == 0
        outs.append(wav.read_wav(o)[0])
    assert len(outs[0]) > 0
    np.testing.assert_array_equal(outs[0], outs[1])
