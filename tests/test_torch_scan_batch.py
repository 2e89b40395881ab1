"""The port's batch server (sdr_pmr446_tpu_torch/apps/scan_batch.py) vs JAX's.

JAX's scan_batch runs once per mesh in this module (its default engine on
the CPU, the 8-device virtual mesh of tests/conftest.py); the port's runs
on the CPU (``--device cpu``: the plain versions of its kernels) over the
same captures, the sizes of tests/test_driver_apps.py:288 (two cs16
captures of 10 sub-chunks, K = 8, ``-w 64``, ``--steps-per-dispatch 2``)
on meshes 2,1 (the duo) and 2,4 (the plane path).  The gates:

  - each capture's events log equal line for line, its WAV > 40 dB against
    JAX's over its 10 sub-chunks, its waterfall log 10 lines (the
    zero-padded tail gets none);
  - the waterfall rows within 2e-3 dB of JAX's sharded chain's on the same
    blocks, read from the chains (the ASCII can flip at a level step);
  - --device-decode on cu8 captures equal to the host decode
    (tests/test_driver_apps.py:353);
  - a stop (--stop-after) and a SIGTERM, each resumed, equal to the
    uninterrupted run (:668, :723); the resume guard (:779), also on the
    capture format and --device-decode; a checkpoint never drains a group
    before the next one is dispatched;
  - exit codes: orbax 2; a missing capture, a bad mesh, a process id
    outside [0, --num-processes) and a mesh that does not split over the
    processes 1 (both refused before any process group is joined);
    --coordinator with one process writes the files of a run without it
    (the two-process runs: tests/test_torch_distributed.py).
"""

import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from sdr_pmr446_tpu import config as C
from sdr_pmr446_tpu.io import iq as jiq, synth
from sdr_pmr446_tpu_torch.apps import scan_batch
from sdr_pmr446_tpu_torch.io import wav
from sdr_pmr446_tpu_torch.runtime import state as state_io

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STREAMS = [(5, 12), (9, 20)]
BASE = ["--subchunks-per-step", "8", "--steps-per-dispatch", "2", "-w",
        "64"]
MESHES = ("2,1", "2,4")


def captures(d, n_sub=10, fmt="cs16", prefix="cap"):
    """tests/test_driver_apps.py:292's captures."""
    os.makedirs(d, exist_ok=True)
    paths = []
    for s, (ch, code) in enumerate(STREAMS):
        iq = 0.8 * synth.make_scanner_iq(n_sub * C.SUBCHUNK_IN, channel=ch,
                                         ctcss_code=code, seed=s)
        pth = os.path.join(d, f"{prefix}{s}.{fmt}")
        jiq.write_iq(pth, iq, fmt)
        paths.append(pth)
    return paths


def outputs(outd, stems=("cap0", "cap1"), waterfall=True):
    out = {}
    for st in stems:
        a, rate = wav.read_wav(os.path.join(outd, f"{st}.wav"))
        assert rate == C.AUDIO_SAMPLERATE
        ev = open(os.path.join(outd, f"{st}.events.log")).read()
        wf = (open(os.path.join(outd, f"{st}.waterfall.log")).read()
              if waterfall else "")
        out[st] = (a, ev, wf)
    return out


def port(argv) -> int:
    return scan_batch.main(argv + ["--device", "cpu"])


def snr_db(ref, got):
    err = np.mean((np.asarray(got, np.float64) - ref) ** 2)
    return 10 * np.log10(np.mean(np.asarray(ref, np.float64) ** 2)
                         / max(err, 1e-30))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX and the port's CLI on the same captures, per mesh."""
    from sdr_pmr446_tpu.apps import scan_batch as jax_app
    d = str(tmp_path_factory.mktemp("batch"))
    caps = captures(d)
    res = {"caps": caps, "dir": d}
    for mesh in MESHES:
        tag = mesh.replace(",", "x")
        jd, pd = os.path.join(d, f"jax{tag}"), os.path.join(d, f"port{tag}")
        assert jax_app.main(caps + BASE + ["--out-dir", jd, "--mesh",
                                           mesh]) == 0
        assert port(caps + BASE + ["--out-dir", pd, "--mesh", mesh]) == 0
        res[mesh] = (outputs(jd), outputs(pd))
    return res


@pytest.mark.parametrize("mesh", MESHES)
def test_events_equal_jax(runs, mesh):
    want, got = runs[mesh]
    for st, (ch, code) in zip(("cap0", "cap1"), STREAMS):
        assert got[st][1] == want[st][1], st
        assert f"Tuned to channel {ch}" in got[st][1]
        assert f"Acquired CTCSS code: {code}" in got[st][1]


@pytest.mark.parametrize("mesh", MESHES)
def test_audio_within_40_db_of_jax(runs, mesh):
    """Over the 10 sub-chunks of each capture; the block's zero-padded
    tail demodulates rounding noise until the squelch detunes, in each
    package its own (tests/test_driver_apps.py:320-323)."""
    want, got = runs[mesh]
    real = 10 * C.SUBCHUNK_AUDIO
    for st in ("cap0", "cap1"):
        assert len(got[st][0]) == len(want[st][0]) > real
        assert snr_db(want[st][0][:real], got[st][0][:real]) > 40.0, st
        assert synth.tone_snr_db(got[st][0][2 * 1225:9 * 1225],
                                 1000.0) > 25.0


@pytest.mark.parametrize("mesh", MESHES)
def test_waterfall_logs_cut_to_real_subchunks(runs, mesh):
    want, got = runs[mesh]
    for st in ("cap0", "cap1"):
        lines = got[st][2].splitlines()
        assert len(lines) == len(want[st][2].splitlines()) == 10
        assert all(ln.startswith(" > ") and "max SNR:" in ln
                   for ln in lines)


def test_waterfall_rows_match_jax_chain(runs):
    """Rows through the chains the CLIs drive, on the CLI's blocks (the
    host-converted cf32 of both captures), mesh 2,1: 2e-3 dB."""
    import jax.numpy as jnp
    from sdr_pmr446_tpu.parallel.scanner_sharded import (
        ShardedScannerChain as JaxSharded, make_mesh as jax_mesh)
    from sdr_pmr446_tpu.scanner.chain import make_runtime_params as jparams
    from sdr_pmr446_tpu_torch.io import native
    from sdr_pmr446_tpu_torch.parallel.scanner_sharded import (
        ShardedScannerChain, make_mesh)
    from sdr_pmr446_tpu_torch.scanner.chain import make_runtime_params
    k = 8
    jchain = JaxSharded(jax_mesh(2, 1), C.BlockConfig(k), waterfall=64)
    chain = ShardedScannerChain(make_mesh(2, 1, "cpu"), C.BlockConfig(k),
                                waterfall=64, input_format="cf32",
                                device="cpu")
    reader = native.BatchReader(runs["caps"], ["cs16", "cs16"])
    jst, st = jchain.init_state(2), chain.init_state()
    jp, p = jparams(C.ScannerArgs()), make_runtime_params(C.ScannerArgs(),
                                                          "cpu")
    for _ in range(2):
        blk, _ = reader.read_block(chain.block.input_len)
        jst, jo = jchain.step(jst, jnp.asarray(blk), jp)
        st, o = chain.step(st, torch.from_numpy(blk.view(np.uint8)), p)
        np.testing.assert_allclose(o.waterfall.numpy(),
                                   np.asarray(jo.waterfall), rtol=0,
                                   atol=2e-3)
    reader.close()


def test_device_decode_equals_host_decode(tmp_path):
    """tests/test_driver_apps.py:353 on cu8: the raw bytes decoded on the
    device give the host decode's events and, over the captures' 10
    sub-chunks, its WAVs exactly.  The short last block is padded in each
    reader's own way, as in JAX: the host decode with complex zeros, the
    raw cu8 wire with byte 128 (+0.0039), and that tail demodulates
    rounding noise until the squelch detunes."""
    caps = captures(str(tmp_path), fmt="cu8")
    base = caps + ["--mesh", "2,4", "--subchunks-per-step", "8"]
    d_host, d_dev = str(tmp_path / "host"), str(tmp_path / "dev")
    assert port(base + ["--out-dir", d_host]) == 0
    assert port(base + ["--out-dir", d_dev, "--device-decode"]) == 0
    host = outputs(d_host, waterfall=False)
    dev = outputs(d_dev, waterfall=False)
    real = 10 * C.SUBCHUNK_AUDIO
    for st in ("cap0", "cap1"):
        assert len(host[st][0]) == len(dev[st][0]) > real
        np.testing.assert_array_equal(host[st][0][:real], dev[st][0][:real])
        assert host[st][1] == dev[st][1]
    # mixed formats cannot share one wire
    other = str(tmp_path / "c.cf32")
    jiq.write_iq(other, 0.5 * synth.make_scanner_iq(C.SUBCHUNK_IN,
                                                    channel=3))
    assert port([caps[0], other, "--device-decode", "--out-dir",
                 d_dev]) == 1


def test_stop_and_resume_equal_uninterrupted(tmp_path):
    """tests/test_driver_apps.py:668 (npz): --stop-after 1, then
    --resume, equal to the uninterrupted run: WAVs, events, waterfall."""
    caps = captures(str(tmp_path), n_sub=12)
    base = caps + ["--mesh", "2,1", "--subchunks-per-step", "4", "-w", "64"]
    full = str(tmp_path / "full")
    assert port(base + ["--out-dir", full]) == 0
    ref = outputs(full)
    ckpt = str(tmp_path / "ck.npz")
    part = str(tmp_path / "part")
    assert port(base + ["--out-dir", part, "--checkpoint", ckpt,
                        "--stop-after", "1"]) == 0
    assert os.path.exists(ckpt) and os.path.exists(ckpt + ".accum.npz")
    assert len(outputs(part)["cap0"][0]) < len(ref["cap0"][0])
    res = str(tmp_path / "res")
    assert port(base + ["--out-dir", res, "--checkpoint", ckpt,
                        "--resume"]) == 0
    got = outputs(res)
    for st in ("cap0", "cap1"):
        np.testing.assert_array_equal(got[st][0], ref[st][0])
        assert got[st][1] == ref[st][1] and got[st][2] == ref[st][2]
    assert port(base + ["--out-dir", res, "--resume"]) == 1
    assert port(base + ["--out-dir", res, "--checkpoint",
                        str(tmp_path / "nope.npz"), "--resume"]) == 1


def test_sigterm_and_resume_equal_uninterrupted(tmp_path):
    """tests/test_driver_apps.py:723: a SIGTERM to the running CLI exits
    0 after a final checkpoint; --resume completes the batch equal to an
    uninterrupted run."""
    caps = captures(str(tmp_path), n_sub=160)
    base = caps + ["--subchunks-per-step", "4", "--device", "cpu"]
    full = str(tmp_path / "full")
    assert scan_batch.main(base + ["--out-dir", full]) == 0
    ref = outputs(full, waterfall=False)
    ckpt = str(tmp_path / "kill.npz")
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    proc = subprocess.Popen(
        [sys.executable, "-m", "sdr_pmr446_tpu_torch.apps.scan_batch"]
        + base + ["--out-dir", str(tmp_path / "killed"), "--checkpoint",
                  ckpt], stderr=subprocess.PIPE, text=True, env=env,
        cwd=ROOT)
    seen = []
    try:
        for line in proc.stderr:
            seen.append(line)
            if "checkpoint at block" in line:
                proc.send_signal(signal.SIGTERM)
                break
        seen.append(proc.stderr.read())
        rc = proc.wait(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
    text = "".join(seen)
    assert rc == 0, text
    assert "stopping after the current dispatch" in text, text
    stopped = int(np.load(ckpt)["block_index"])
    assert 0 < stopped < 40, text
    res = str(tmp_path / "resumed")
    assert scan_batch.main(base + ["--out-dir", res, "--checkpoint", ckpt,
                                   "--resume"]) == 0
    got = outputs(res, waterfall=False)
    for st in ("cap0", "cap1"):
        np.testing.assert_array_equal(got[st][0], ref[st][0])
        assert got[st][1] == ref[st][1]


def test_resume_guard(tmp_path):
    """tests/test_driver_apps.py:779, and the capture format and
    --device-decode (the raw reader seeks by the format's sample size)."""
    caps = captures(str(tmp_path), n_sub=8)
    ckpt = str(tmp_path / "g.npz")
    base = caps + ["--out-dir", str(tmp_path / "o"), "--checkpoint", ckpt]
    assert port(base + ["--subchunks-per-step", "4", "--stop-after",
                        "1"]) == 0
    assert port(base + ["--subchunks-per-step", "8", "--resume"]) == 1
    assert port([caps[0], "--out-dir", str(tmp_path / "o"), "--checkpoint",
                 ckpt, "--subchunks-per-step", "4", "--resume"]) == 1
    assert port(base + ["--subchunks-per-step", "4", "--device-decode",
                        "--resume"]) == 1
    assert port(base + ["--subchunks-per-step", "4", "--format", "cu8",
                        "--resume"]) == 1
    assert port(base + ["--subchunks-per-step", "4", "--resume"]) == 0


def test_checkpoint_waits_for_the_next_dispatch(tmp_path, monkeypatch):
    """A checkpoint every group never drains a group early: group i's
    checkpoint is written after group i + 1 is dispatched (but the last),
    and its state is group i's."""
    from sdr_pmr446_tpu_torch.parallel.scanner_sharded import (
        ShardedScannerChain)
    caps = captures(str(tmp_path), n_sub=16)
    order = []
    step, save = ShardedScannerChain.multi_step, state_io.save_state

    def multi_step(self, *a):
        order.append("dispatch")
        return step(self, *a)

    def save_state(path, block_index, st):
        order.append(f"save {block_index}")
        return save(path, block_index, st)

    monkeypatch.setattr(ShardedScannerChain, "multi_step", multi_step)
    monkeypatch.setattr(state_io, "save_state", save_state)
    ckpt = str(tmp_path / "c.npz")
    assert port(caps + ["--out-dir", str(tmp_path / "o"), "--checkpoint",
                        ckpt, "--subchunks-per-step", "2",
                        "--steps-per-dispatch", "2"]) == 0
    assert order == ["dispatch", "dispatch", "save 2", "dispatch",
                     "save 4", "dispatch", "save 6", "save 8"], order
    full = str(tmp_path / "full")
    assert port(caps + ["--out-dir", full, "--subchunks-per-step", "2",
                        "--steps-per-dispatch", "2"]) == 0
    for st, (a, ev, _) in outputs(full, waterfall=False).items():
        got = outputs(str(tmp_path / "o"), waterfall=False)[st]
        np.testing.assert_array_equal(got[0], a)
        assert got[1] == ev


@pytest.mark.parametrize("argv,rc", [
    (["--coordinator", "127.0.0.1:1", "--num-processes", "2",
      "--process-id", "2"], 1),
    (["--coordinator", "127.0.0.1:1", "--num-processes", "2", "--mesh",
      "1,1"], 1),
    (["--checkpoint-backend", "orbax"], 2),
    (["--mesh", "3,1"], 1),
    (["--mesh", "2,3"], 1),
    (["--mesh", "two"], 1),
    (["-w", "6"], 1),
    (["missing.cs16"], 1),
])
def test_exit_codes(argv, rc, tmp_path):
    caps = captures(str(tmp_path), n_sub=1)
    outd = tmp_path / "o"
    if argv == ["missing.cs16"]:
        argv = [str(tmp_path / "missing.cs16")]
    assert port(caps + argv + ["--out-dir", str(outd)]) == rc
    assert not (outd / "cap0.wav").exists()


def test_coordinator_with_one_process(tmp_path):
    """--coordinator with one process (a gloo group of one) writes the same
    files as a run without it, as JAX's does; --num-processes without
    --coordinator exits 1."""
    import socket
    caps = captures(str(tmp_path), n_sub=4)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        addr = f"127.0.0.1:{s.getsockname()[1]}"
    base = caps + ["--subchunks-per-step", "4", "--mesh", "2,2"]
    assert port(base + ["--out-dir", str(tmp_path / "a")]) == 0
    assert port(base + ["--out-dir", str(tmp_path / "b"), "--coordinator",
                        addr, "--num-processes", "1"]) == 0
    for name in sorted(os.listdir(tmp_path / "a")):
        assert (tmp_path / "a" / name).read_bytes() == \
            (tmp_path / "b" / name).read_bytes(), name
    assert port(base + ["--out-dir", str(tmp_path / "c"), "--num-processes",
                        "2"]) == 1


def test_default_device_is_the_card(tmp_path):
    """Without --device the batch server runs on the card; on a host with
    no CUDA device it exits 1 and writes nothing."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    caps = captures(str(tmp_path), n_sub=1)
    outd = tmp_path / "o"
    assert scan_batch.main(caps + ["--out-dir", str(outd)]) == 1
    assert not (outd / "cap0.wav").exists()
