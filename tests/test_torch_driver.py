"""The port's ScannerDriver metrics, checkpoint / resume and stop flush.

Counterparts of tests/test_driver_apps.py on the CPU (plain versions):

  - the metrics JSONL: one record a sub-chunk with the JAX keys, equal to
    the JAX driver's records on the same cs16 capture (its op path) field
    for field: decisions, codes and event lines exact, RSSI within 5e-3 dB
    (the gate of tests/test_torch_chain.py) (:113);
  - a run "crashed" after its first block and resumed from the checkpoint
    file equals the uninterrupted run bit for bit (:218);
  - request_stop() flushes a final checkpoint (with checkpoint_every=0
    nothing else writes it), and resuming from it is bit-exact (:474);
  - the CLI's --checkpoint / --checkpoint-every / --resume, and its error
    exits: --resume without --checkpoint, from a missing or a corrupt file,
    or from an npz file under --checkpoint-backend orbax (1) (:208-214,
    :271; the orbax backend itself: tests/test_torch_checkpoint.py);
  - adapt_state_histories agrees with JAX's on padded and truncated
    histories and rejects a non-history mismatch naming the field;
    load_state fills a field the file lacks with the chain's init value;
    the kernel driver's restore() refuses the JAX op engine's state
    layout, the op driver (engine="op") resumes from a JAX op checkpoint
    equal to the uninterrupted JAX run (decisions exact, RSSI within 5e-3
    dB, audio within 1e-4 of its peak) and refuses a kernel-engine
    checkpoint.
"""

import itertools
import json
import logging

import numpy as np
import pytest
import torch

from sdr_pmr446_tpu import config as C
from sdr_pmr446_tpu.io import iq as iq_io
from sdr_pmr446_tpu.io import synth
from sdr_pmr446_tpu.ops import decode as jdecode
from sdr_pmr446_tpu_torch.runtime import state as tstate
from sdr_pmr446_tpu_torch.runtime.driver import ScannerDriver, wire_blocks

torch.set_num_threads(2)

K = 5
ARGS = C.ScannerArgs(lock_mode="max")


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    """cs16: channel 5 with CTCSS 12, then silence; 15 sub-chunks (3
    blocks of K = 5).  Returns (path, raw bytes)."""
    path = tmp_path_factory.mktemp("drv") / "cap.cs16"
    n1, n2 = 10 * C.SUBCHUNK_IN, 5 * C.SUBCHUNK_IN
    rng = np.random.default_rng(2)
    iq_io.write_iq(str(path), np.concatenate([
        0.7 * synth.make_scanner_iq(n1, channel=5, ctcss_code=12),
        1e-3 * (rng.standard_normal(n2) + 1j * rng.standard_normal(n2))]),
        "cs16")
    return path, np.fromfile(path, dtype=np.uint8)


def make_driver(**kw):
    from sdr_pmr446_tpu_torch import config as TC
    args = TC.ScannerArgs(lock_mode="max")
    return ScannerDriver(args, subchunks_per_step=K, input_format="cs16",
                         device="cpu", **kw)


@pytest.fixture(scope="module")
def full_run(capture, tmp_path_factory):
    """The uninterrupted port run with metrics: (result, records)."""
    path = str(tmp_path_factory.mktemp("m") / "metrics.jsonl")
    drv = make_driver(metrics_path=path)
    res = drv.run(wire_blocks(capture[1], "cs16", drv.feed_len))
    with open(path) as f:
        return res, [json.loads(line) for line in f]


def assert_same_run(parts, full):
    for name in ("audio", "active_trace", "rssi_trace", "rel_rssi",
                 "ct_detected", "ct_max_idx", "audio_subchunks"):
        np.testing.assert_array_equal(
            np.concatenate([getattr(p, name) for p in parts]),
            getattr(full, name), err_msg=name)
    assert sum((p.events for p in parts), []) == full.events


def test_driver_metrics_jsonl_matches_jax(capture, full_run, tmp_path):
    from sdr_pmr446_tpu.runtime.driver import ScannerDriver as JaxDriver
    res, recs = full_run
    path = str(tmp_path / "jax.jsonl")
    jd = JaxDriver(ARGS, subchunks_per_step=K, input_format="cs16",
                   engine="xla", metrics_path=path)
    jd.run(iq_io.block_stream(jdecode.pack_bytes(
        capture[1].view(np.int16), "cs16"), jd.feed_len))
    with open(path) as f:
        jrecs = [json.loads(line) for line in f]
    assert len(recs) == len(jrecs) == 15
    for r, j in zip(recs, jrecs):
        assert r.keys() == j.keys()
        for key in ("subchunk", "active_chan", "ctcss_detected",
                    "ctcss_code", "events"):
            assert r[key] == j[key], (key, r, j)
        assert abs(r["rel_rssi"] - j["rel_rssi"]) < 5e-3
        np.testing.assert_allclose(r["rssi_db"], j["rssi_db"], rtol=0,
                                   atol=0.01 + 5e-3)
    assert [r["subchunk"] for r in recs] == list(range(15))
    assert recs[8]["active_chan"] == 4 and recs[8]["ctcss_code"] == 12
    assert recs[8]["ctcss_detected"]
    assert sum((r["events"] for r in recs), []) == res.events


def test_driver_checkpoint_resume_equals_uninterrupted(capture, full_run,
                                                       tmp_path):
    ckpt = str(tmp_path / "state.npz")
    drv1 = make_driver(checkpoint_path=ckpt, checkpoint_every=1)
    part1 = drv1.run(itertools.islice(
        wire_blocks(capture[1], "cs16", drv1.feed_len), 1))
    drv2 = make_driver(checkpoint_path=ckpt, checkpoint_every=1)
    assert drv2.restore() == 1 and drv2.subchunk == K
    part2 = drv2.run(wire_blocks(capture[1], "cs16", drv2.feed_len))
    assert drv2.block_index == 3
    assert_same_run([part1, part2], full_run[0])
    # the skip is one-shot: a second run() consumes its whole input
    assert len(drv2.run(wire_blocks(capture[1], "cs16",
                                    drv2.feed_len)).active_trace) == 15


def test_driver_stop_request_resume_bitexact(capture, full_run, tmp_path):
    ckpt = str(tmp_path / "sig.npz")
    drv1 = make_driver(checkpoint_path=ckpt, checkpoint_every=0)

    def stopper(sub, o):
        if sub >= 2:
            drv1.request_stop()

    drv1.on_subchunk = stopper
    part1 = drv1.run(wire_blocks(capture[1], "cs16", drv1.feed_len))
    # block 1 was in flight when block 0's drain asked to stop
    assert drv1.stopped and drv1.block_index == 2
    with np.load(ckpt) as z:
        assert int(z["block_index"]) == 2
    drv2 = make_driver(checkpoint_path=ckpt)
    assert drv2.restore() == 2
    part2 = drv2.run(wire_blocks(capture[1], "cs16", drv2.feed_len))
    assert not drv2.stopped
    assert_same_run([part1, part2], full_run[0])


def test_restore_fills_missing_fields_and_refuses_op_layout(capture,
                                                            tmp_path):
    from sdr_pmr446_tpu.runtime import state as jstate
    from sdr_pmr446_tpu.scanner.chain import ScannerChain as JaxChain
    from sdr_pmr446_tpu.scanner.chain import make_runtime_params as jparams
    # a checkpoint written before the last field existed
    drv = make_driver(checkpoint_path=str(tmp_path / "a.npz"))
    drv.run(itertools.islice(wire_blocks(capture[1], "cs16",
                                         drv.feed_len), 1))
    drv.checkpoint_now()
    last = f"s{len(tstate.ScannerState._fields) - 1}"
    with np.load(tmp_path / "a.npz") as z:
        kept = {k: z[k] for k in z.files if k != last}
    np.savez(tmp_path / "old.npz", **kept)
    idx, loaded = tstate.load_state(str(tmp_path / "old.npz"), "cpu")
    assert idx == 1 and loaded.wf_cnt is None
    drv2 = make_driver()
    assert drv2.restore(str(tmp_path / "old.npz")) == 1
    for f, a, b in zip(drv.state._fields, drv2.state, drv.state):
        assert torch.equal(a, b), f
    # the JAX op engine's state: the kernel driver refuses it, the op
    # driver resumes from it equal to the uninterrupted JAX run
    jchain = JaxChain(C.BlockConfig(K), input_format="cs16")
    words = jdecode.pack_bytes(capture[1].view(np.int16), "cs16")
    wl = jchain.step_arg_len
    jst, _ = jchain.step(jchain.init_state(), words[:wl], jparams(ARGS))
    jstate.save_state(str(tmp_path / "op.npz"), 1, jst)
    with pytest.raises(ValueError, match="op engine.*--engine op"):
        make_driver().restore(str(tmp_path / "op.npz"))
    op = make_driver(engine="op")
    assert op.restore(str(tmp_path / "op.npz")) == 1
    res = op.run(wire_blocks(capture[1], "cs16", op.feed_len))
    outs = []
    for i in (1, 2):
        jst, o = jchain.step(jst, words[i * wl:(i + 1) * wl], jparams(ARGS))
        outs.append(o)
    want = lambda f: np.concatenate([np.asarray(getattr(o, f))  # noqa: E731
                                     for o in outs])
    np.testing.assert_array_equal(res.active_trace, want("active_chan"))
    np.testing.assert_array_equal(res.ct_max_idx, want("ct_max_idx"))
    np.testing.assert_allclose(res.rssi_trace, want("rssi_db"), rtol=0,
                               atol=5e-3)
    audio = want("audio")[want("audio_valid")].reshape(-1)
    assert np.max(np.abs(res.audio - audio)) < 1e-4 * np.abs(audio).max()
    # and the op driver refuses the kernel engine's checkpoint
    with pytest.raises(ValueError, match="kernel engine.*--engine kernel"):
        make_driver(engine="op").restore(str(tmp_path / "a.npz"))


def test_adapt_state_histories_matches_jax():
    import jax.numpy as jnp
    from sdr_pmr446_tpu.runtime import state as jstate
    src_j = jstate.init_scanner_state(384, 400, 100)
    src_j = src_j._replace(resamp_hist=jnp.arange(384).astype(jnp.complex64))
    src_t = tstate.state_from_numpy([np.asarray(v) for v in src_j], "cpu")
    for n in (512, 300):
        tgt_j = jstate.init_scanner_state(n, 400, 100)
        tgt_t = tstate.state_from_numpy([np.asarray(v) for v in tgt_j], "cpu")
        want = jstate.adapt_state_histories(src_j, tgt_j)
        got = tstate.adapt_state_histories(src_t, tgt_t)
        assert got.resamp_hist.shape == (n,)
        for f, a, b in zip(got._fields, got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=f)
    bad = src_t._replace(demod_prev=torch.zeros(8, dtype=torch.complex64))
    with pytest.raises(ValueError, match="demod_prev"):
        tstate.adapt_state_histories(bad, src_t)


def test_app_checkpoint_flags(capture, tmp_path, caplog):
    from sdr_pmr446_tpu_torch.apps import sdr_pmr446 as app
    base = ["--input", str(capture[0]), "--output", str(tmp_path / "a.wav"),
            "--subchunks-per-step", str(K), "--device", "cpu"]
    ckpt = str(tmp_path / "st.npz")
    assert app.main(base + ["--checkpoint", ckpt]) == 0
    with np.load(ckpt) as z:          # --checkpoint-every defaults to 1
        assert int(z["block_index"]) == 3
    with caplog.at_level(logging.INFO, logger="sdr_pmr446"):
        assert app.main(base + ["--checkpoint", ckpt, "--resume"]) == 0
    assert any("restored checkpoint at block 3" in r.getMessage()
               for r in caplog.records)
    bad = tmp_path / "bad.npz"
    bad.write_bytes(b"PK\x03\x04corrupt")
    for extra, rc in ((["--resume"], 1),
                      (["--resume", "--checkpoint",
                        str(tmp_path / "nope.npz")], 1),
                      (["--resume", "--checkpoint", str(bad)], 1),
                      (["--resume", "--checkpoint", ckpt,
                        "--checkpoint-backend", "orbax"], 1)):
        assert app.main(base + extra) == rc, extra


def test_profiling_utils_match_jax(tmp_path):
    """utils/profiling.py: log_jsonl appends one JSON line a record, as
    JAX's does, and trace() writes a Chrome trace of the profiled region
    (its spans and counters with the recorder on:
    tests/test_torch_tracing.py)."""
    from sdr_pmr446_tpu_torch.utils import profiling as tprof
    path = str(tmp_path / "m.jsonl")
    for i in range(2):
        tprof.log_jsonl(path, {"subchunk": i, "events": ["x"]})
    with open(path) as f:
        assert [json.loads(line)["subchunk"] for line in f] == [0, 1]
    with tprof.trace(str(tmp_path / "tr")) as prof:
        torch.ones(8).cumsum(0)
    assert (tmp_path / "tr" / "trace.json").stat().st_size > 0
    assert len(prof.key_averages()) > 0
