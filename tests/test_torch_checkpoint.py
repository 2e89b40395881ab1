"""The port's directory checkpoint backend (runtime/state.py
``save_state_orbax`` / ``load_state_orbax`` on torch.distributed.checkpoint)
against JAX's orbax backend, on the CPU.

  - the round trip is bit-exact on a ScannerState (zero-size ``wf_hist``
    keeping its shape and dtype), on a stacked [S, ...] state and on the
    dsd_in and single states of both engines; a second save replaces the
    first;
  - ``ScannerDriver(checkpoint_backend="orbax")`` stopped after one block
    and resumed equals the uninterrupted run bit for bit, and (on the op
    engine, the JAX driver's default off a TPU) JAX's
    tests/test_driver_apps.py:404-440 run on the same samples: events equal,
    audio within 1e-4 of the peak (tests/test_torch_driver.py's gate);
  - a JAX state read by JAX's ``load_state_orbax`` and carried across with
    ``state_from_numpy`` goes through the port's save and load bit-exact;
  - a checkpoint with a shorter ``resamp_hist`` migrates through
    ``adapt_state_histories`` as JAX's does; a field the checkpoint lacks
    loads as None and is then filled;
  - a missing path, a file, a directory of something else and a directory
    JAX's orbax wrote are refused with an error naming what is there, and
    the two CLIs' ``--resume`` of the JAX directory exits 1 naming the
    format.

JAX's driver and its orbax save run once for the module.
"""

import collections
import itertools
import logging
import os

import numpy as np
import pytest
import torch

from sdr_pmr446_tpu import config as C
from sdr_pmr446_tpu.io import iq as jiq
from sdr_pmr446_tpu.io import synth
from sdr_pmr446_tpu_torch.runtime import state as tstate
from sdr_pmr446_tpu_torch.runtime.driver import ScannerDriver, wire_blocks

torch.set_num_threads(2)

K = 5
#: tests/test_driver_apps.py:404's capture: 1.5 s of channel 5, CTCSS 12
#: (three blocks of K = 5)
N = int(1.5 * C.SDR_SAMPLERATE) // (K * C.SUBCHUNK_IN) * (K * C.SUBCHUNK_IN)


def demo_iq() -> np.ndarray:
    return synth.make_scanner_iq(N, channel=5, ctcss_code=12).astype(
        np.complex64)


def port_driver(**kw) -> ScannerDriver:
    from sdr_pmr446_tpu_torch import config as TC
    return ScannerDriver(TC.ScannerArgs(lock_mode="max"), subchunks_per_step=K,
                         input_format="cf32", device="cpu", **kw)


def port_blocks(drv, iq):
    return wire_blocks(iq.view(np.uint8), "cf32", drv.feed_len)


def randomized(state, seed: int):
    """``state`` with every non-empty field random (its dtype and shape)."""
    g = torch.Generator().manual_seed(seed)
    vals = []
    for v in state:
        if v.dtype == torch.bool:
            vals.append(torch.rand(v.shape, generator=g) > 0.5)
        elif v.dtype in (torch.int32, torch.int64):
            vals.append(torch.randint(-5, 99, v.shape, generator=g,
                                      dtype=v.dtype))
        else:
            vals.append(torch.randn(v.shape, generator=g, dtype=v.dtype))
    return type(state)(*vals)


def assert_bits(got, want):
    assert type(got) is type(want)
    for f, a, b in zip(want._fields, got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert a.numpy().tobytes() == b.numpy().tobytes(), f


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """tests/test_driver_apps.py:404-440's orbax run in JAX: a driver
    stopped after its first block (an orbax checkpoint every block), then
    one restored from it; (events, audio, the checkpoint directory, its
    state as numpy)."""
    from sdr_pmr446_tpu.runtime.driver import ScannerDriver as JaxDriver
    from sdr_pmr446_tpu.runtime.state import load_state_orbax
    iq = demo_iq()
    ckpt = str(tmp_path_factory.mktemp("jax_orbax") / "ck_orbax")
    args = C.ScannerArgs(lock_mode="max")
    drv1 = JaxDriver(args, subchunks_per_step=K, checkpoint_path=ckpt,
                     checkpoint_every=1, checkpoint_backend="orbax")
    part1 = drv1.run(itertools.islice(jiq.block_stream(iq, drv1.block_len),
                                      1))
    bi, st = load_state_orbax(ckpt)
    assert bi == 1
    state = [np.asarray(v) for v in st]
    drv2 = JaxDriver(args, subchunks_per_step=K, checkpoint_path=ckpt,
                     checkpoint_backend="orbax")
    assert drv2.restore() == 1
    part2 = drv2.run(jiq.block_stream(iq, drv2.block_len))
    return (part1.events + part2.events,
            np.concatenate([part1.audio, part2.audio]), ckpt, state)


@pytest.fixture(scope="module")
def port_full():
    """The port's uninterrupted runs on each engine: engine -> (result,
    final state)."""
    iq = demo_iq()
    runs = {}
    for engine in ("kernel", "op"):
        drv = port_driver(engine=engine)
        runs[engine] = (drv.run(port_blocks(drv, iq)), drv.state)
    return runs


# ------------------------------------------------------------ round trips
def scanner_state(waterfall: int = 0):
    from sdr_pmr446_tpu_torch.scanner.chain import ScannerChain
    return ScannerChain(C.BlockConfig(K), device="cpu",
                        waterfall=waterfall).init_state()


def chain_state(kind: str):
    from sdr_pmr446_tpu_torch.scanner.dsd_in import DsdInChain
    from sdr_pmr446_tpu_torch.scanner.single import SingleChannelChain
    if kind == "scanner":
        return scanner_state()
    if kind == "scanner_w64":
        return scanner_state(64)
    if kind == "stacked":
        return tstate.stack_state(scanner_state(), 3)
    if kind.startswith("dsd"):
        return DsdInChain(8, device="cpu", engine=kind[4:] or "kernel"
                          ).init_state()
    return SingleChannelChain(5, 8, device="cpu",
                              engine=kind[7:] or "kernel").init_state()


@pytest.mark.parametrize("kind", ["scanner", "scanner_w64", "stacked", "dsd",
                                  "dsd_op", "single", "single_op"])
def test_roundtrip_bit_exact(kind, tmp_path):
    """Every field back bit for bit at its dtype and shape; the zero-size
    ``wf_hist`` of a scanner without the waterfall is stored as metadata
    (JAX's ``empties``) and comes back c64 [0]."""
    st = randomized(chain_state(kind), seed=len(kind))
    path = str(tmp_path / "ck")
    tstate.save_state_orbax(path, 7, st)
    assert os.path.isfile(os.path.join(path, ".metadata"))
    bi, got = tstate.load_state_orbax(path, "cpu", type(st))
    assert bi == 7
    assert_bits(got, st)
    if kind == "scanner":
        assert got.wf_hist.shape == (0,)
        assert got.wf_hist.dtype == torch.complex64


def test_save_replaces_the_directory(tmp_path):
    """A save over an existing checkpoint replaces it whole (JAX's
    ``force=True``), over a file too; no temporary directory is left."""
    path = str(tmp_path / "ck")
    a = randomized(scanner_state(), 1)
    b = randomized(tstate.stack_state(scanner_state(), 2), 2)
    tstate.save_state_orbax(path, 1, a)
    tstate.save_state_orbax(path, 2, b)
    bi, got = tstate.load_state_orbax(path, "cpu")
    assert bi == 2
    assert_bits(got, b)
    assert sorted(os.listdir(tmp_path)) == ["ck"]
    other = str(tmp_path / "f")
    open(other, "w").write("x")
    tstate.save_state_orbax(other, 3, a)
    assert tstate.load_state_orbax(other, "cpu")[0] == 3


# ------------------------------------------------------------ the driver
@pytest.mark.parametrize("engine", ["kernel", "op"])
def test_driver_orbax_stop_resume_bit_exact(engine, port_full, tmp_path):
    """Stopped after one block (a checkpoint every block), resumed in a new
    driver: audio, decisions, events and the final state equal the
    uninterrupted run's bit for bit."""
    iq = demo_iq()
    full, full_state = port_full[engine]
    ckpt = str(tmp_path / "ck")
    drv1 = port_driver(engine=engine, checkpoint_path=ckpt,
                       checkpoint_every=1, checkpoint_backend="orbax")
    part1 = drv1.run(itertools.islice(port_blocks(drv1, iq), 1))
    assert os.path.isdir(ckpt)
    drv2 = port_driver(engine=engine, checkpoint_path=ckpt,
                       checkpoint_backend="orbax")
    assert drv2.restore() == 1 and drv2.subchunk == K
    part2 = drv2.run(port_blocks(drv2, iq))
    for name in ("audio", "active_trace", "rssi_trace", "rel_rssi",
                 "ct_detected", "ct_max_idx", "audio_subchunks"):
        np.testing.assert_array_equal(
            np.concatenate([getattr(part1, name), getattr(part2, name)]),
            getattr(full, name), err_msg=name)
    assert part1.events + part2.events == full.events
    assert_bits(drv2.state, full_state)


def test_driver_orbax_resume_matches_jax(jax_run, tmp_path):
    """The op engine's orbax stop / resume against JAX's orbax stop /
    resume on the same samples: events equal, audio within 1e-4 of its
    peak."""
    events, audio, _, _ = jax_run
    iq = demo_iq()
    ckpt = str(tmp_path / "ck")
    drv1 = port_driver(engine="op", checkpoint_path=ckpt, checkpoint_every=1,
                       checkpoint_backend="orbax")
    part1 = drv1.run(itertools.islice(port_blocks(drv1, iq), 1))
    drv2 = port_driver(engine="op", checkpoint_path=ckpt,
                       checkpoint_backend="orbax")
    assert drv2.restore() == 1
    part2 = drv2.run(port_blocks(drv2, iq))
    assert part1.events + part2.events == events
    assert any(e.startswith("Acquired CTCSS code: 12") for e in events)
    got = np.concatenate([part1.audio, part2.audio])
    assert got.shape == audio.shape and audio.size > 0
    assert np.max(np.abs(got - audio)) < 1e-4 * np.abs(audio).max()


def test_driver_rejects_unknown_backend():
    with pytest.raises(ValueError, match="checkpoint_backend"):
        port_driver(checkpoint_backend="zarr")


# ------------------------------------------------------ across the packages
def test_jax_state_through_dcp_bit_exact(jax_run, tmp_path):
    """A state JAX's load_state_orbax read, carried across with
    state_from_numpy, saved and loaded by the port: bit for bit JAX's
    arrays, and the op driver resumes from it."""
    jax_state = jax_run[3]
    st = tstate.state_from_numpy(jax_state, "cpu")
    path = str(tmp_path / "ck")
    tstate.save_state_orbax(path, 1, st)
    bi, got = tstate.load_state_orbax(path, "cpu")
    assert bi == 1
    for f, a, b in zip(got._fields, got, jax_state):
        assert a.numpy().dtype == b.dtype and a.numpy().shape == b.shape, f
        assert a.numpy().tobytes() == b.tobytes(), f
    drv = port_driver(engine="op", checkpoint_path=path,
                      checkpoint_backend="orbax")
    assert drv.restore() == 1


def test_shorter_history_migrates_as_jax(tmp_path):
    """A checkpoint whose ``resamp_hist`` is shorter than the chain's is
    read at its own length and left-padded by adapt_state_histories,
    as JAX's migrates the same numbers."""
    from sdr_pmr446_tpu.runtime import state as jstate
    ref = scanner_state()
    st = randomized(ref, 5)
    st = st._replace(resamp_hist=st.resamp_hist[:300].clone())
    path = str(tmp_path / "ck")
    tstate.save_state_orbax(path, 2, st)
    _, got = tstate.load_state_orbax(path, "cpu")
    assert got.resamp_hist.shape == (300,)
    adapted = tstate.adapt_state_histories(got, ref)
    assert adapted.resamp_hist.shape == ref.resamp_hist.shape
    jref = [np.asarray(v) for v in jstate.adapt_state_histories(
        jstate.ScannerState(*[np.asarray(v.numpy()) for v in got]),
        jstate.ScannerState(*[np.asarray(v.numpy()) for v in ref]))]
    for f, a, b in zip(ref._fields, adapted, jref):
        np.testing.assert_array_equal(a.numpy(), b, err_msg=f)


def test_missing_field_loads_none_then_filled(port_full, tmp_path):
    """A checkpoint written before the last field existed: that field
    loads as None, restore() fills it with the chain's init value, and the
    rest is the saved state."""
    drv = port_driver()
    drv.run(itertools.islice(port_blocks(drv, demo_iq()), 1))
    fields = tstate.ScannerState._fields
    Old = collections.namedtuple("Old", fields[:-1])
    path = str(tmp_path / "old")
    tstate.save_state_orbax(path, 1, Old(*drv.state[:-1]))
    bi, loaded = tstate.load_state_orbax(path, "cpu")
    assert bi == 1 and loaded.wf_cnt is None
    drv2 = port_driver(checkpoint_backend="orbax")
    assert drv2.restore(path) == 1
    for f, a, b in zip(fields, drv2.state, drv.state):
        assert torch.equal(a, b), f


# ---------------------------------------------------------------- refusals
@pytest.mark.parametrize("what", ["missing", "file", "other", "jax"])
def test_foreign_paths_refused(what, jax_run, tmp_path):
    """No DCP checkpoint: FileNotFoundError for nothing there, ValueError
    naming what is there (never DCP's own error from deep inside)."""
    path = str(tmp_path / "x")
    if what == "file":
        np.savez(path, block_index=np.int64(1))
        path += ".npz"
    elif what == "other":
        os.makedirs(os.path.join(path, "sub"))
    elif what == "jax":
        path = jax_run[2]
    err = FileNotFoundError if what == "missing" else ValueError
    match = {"missing": "no checkpoint directory", "file": "is a file",
             "other": "no .metadata; found: sub",
             "jax": "JAX orbax checkpoint .*manifest.ocdbt"}[what]
    with pytest.raises(err, match=match):
        tstate.load_state_orbax(path, "cpu")


def test_clis_refuse_a_jax_orbax_directory(jax_run, tmp_path, caplog):
    """--resume of JAX's orbax directory exits 1 in both CLIs, the log
    naming the format; sdr_pmr446's own orbax checkpoint resumes."""
    from sdr_pmr446_tpu_torch.apps import scan_batch
    from sdr_pmr446_tpu_torch.apps import sdr_pmr446 as app
    jdir = jax_run[2]
    cap = str(tmp_path / "cap.cf32")
    jiq.write_iq(cap, demo_iq()[:K * C.SUBCHUNK_IN], "cf32")
    base = ["--input", cap, "--output", str(tmp_path / "a.wav"),
            "--subchunks-per-step", str(K), "--device", "cpu",
            "--checkpoint-backend", "orbax"]
    with caplog.at_level(logging.ERROR):
        assert app.main(base + ["--checkpoint", jdir, "--resume"]) == 1
    assert any("cannot restore checkpoint" in r.getMessage()
               and "JAX orbax" in r.getMessage() for r in caplog.records)
    own = str(tmp_path / "own")
    assert app.main(base + ["--checkpoint", own]) == 0
    caplog.clear()
    with caplog.at_level(logging.INFO):
        assert app.main(base + ["--checkpoint", own, "--resume"]) == 0
    assert any("restored checkpoint at block 1" in r.getMessage()
               for r in caplog.records)
    # scan_batch reads the state before its accumulators
    caplog.clear()
    with caplog.at_level(logging.ERROR):
        assert scan_batch.main([cap, "--out-dir", str(tmp_path / "o"),
                                "--subchunks-per-step", str(K), "--device",
                                "cpu", "--checkpoint", jdir,
                                "--resume"]) == 1
    assert any("JAX orbax" in r.getMessage() for r in caplog.records)
    assert not os.path.exists(tmp_path / "o" / "cap.wav")
