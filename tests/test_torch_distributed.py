"""The port's multi-process execution (parallel/distributed.py) on the CPU.

Counterparts of tests/test_multihost.py's three tests, plus the other
sharded chains: two worker processes (``subprocess``, one gloo rank each
over a localhost coordinator, ``torch.set_num_threads(1)``) split a mesh
between them, and

  - each sharded chain's outputs and state, gathered from both ranks
    (``distributed.process_allgather``), equal the one-process mesh's on
    the same bytes bit for bit (computed in rank 0 after the two-rank run,
    at the same thread count): the plane path at (1, 4), K = 4 (K_local =
    1), with and without K11 (``halo_dma``) and with the waterfall (w =
    120: its window reaches back over a rank boundary, and a shard's hop
    counter starts at its global index); the duo at (1, 2), K = 16
    (K_local = 8: K10's fold across the ranks); the op engine and the
    sharded faithful chain at (1, 2), K = 2 (K_local = 1: an odd number of
    PFB frames a shard, so rank 1's frame parity comes from its global
    index); the sharded dsd / single mono chains at (1, 2), K = 16;
  - the plane path and the duo within tests/test_multihost.py:66-76's gates
    (ints exact, floats atol 2e-3) of JAX's unsharded ScannerChain on the
    same samples, computed once in the test process;
  - apps/scan_batch.py with --mesh 2,2 over two processes: process 0's files
    equal a one-process run's byte for byte (rank 0 runs it after the
    two-process run), process 1 writes none, and JAX scan_batch.main's
    single-process files match (events equal, WAV atol 2e-3;
    tests/test_multihost.py:176-188); --mesh 1,4 (a time split, the
    --device-decode reader reading each process's time run);
  - --checkpoint --stop-after 1 over two processes, then --resume over two,
    equal to the uninterrupted run (tests/test_multihost.py:190-258), on
    each backend: npz (process 0 writes the file) and orbax (both ranks
    save the gathered rows in one torch.distributed.checkpoint collective),
    and the resume guard refusing another process count; a stop asked of
    process 1 alone stopping both after the same group, resumed equal to
    an uninterrupted run;
  - the rank layout (``rank_block``) for (2, 2), (1, 4) and (4, 5) over two
    processes, the refused meshes and process ids, and a missing peer
    failing within the process group's timeout.

Every worker has ``communicate(timeout=...)`` and its process group a
timeout well under it, so no failure hangs the run.
"""

import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from sdr_pmr446_tpu import config as C
from sdr_pmr446_tpu.io import iq as jiq, synth
from sdr_pmr446_tpu_torch.io import wav
from sdr_pmr446_tpu_torch.ops import decode as tdecode
from sdr_pmr446_tpu_torch.parallel import distributed

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: seconds a worker may take, and its process group's timeout
WORKER_S, GROUP_S = 300, 60
#: scenario -> (chain, mesh, K, constructor keywords); two steps each
CHAINS = {
    "plane": ("scanner", (1, 4), 4, {}),
    "plane_dma": ("scanner", (1, 4), 4, {"halo_dma": True}),
    "plane_wf": ("scanner", (1, 4), 4, {"waterfall": 120}),
    "duo": ("scanner", (1, 2), 16, {}),
    "op": ("scanner", (1, 2), 2, {"engine": "op"}),
    "dsd": ("dsd", (1, 2), 16, {}),
    "single": ("single", (1, 2), 16, {}),
    "faithful": ("faithful", (1, 2), 2, {}),
}
STEPS = 2
#: the scan_batch captures: 12 sub-chunks (3 blocks at K = 4) each
STREAMS = [(5, 12), (9, 20)]
BATCH = ["--subchunks-per-step", "4", "--device", "cpu"]


def free_address() -> str:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"127.0.0.1:{s.getsockname()[1]}"


def spawn_pair(script: str, args_of):
    """Run ``script`` as ranks 0 and 1 (``args_of(rank)`` their argv after
    the coordinator and the rank); returns their (stdout, stderr)."""
    addr = free_address()
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, "-c", script, addr, str(r)]
                              + args_of(r), env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=WORKER_S))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, (_, err)) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{err[-3000:]}"
    return logs


def scanner_iq(k: int) -> np.ndarray:
    return synth.make_scanner_iq(STEPS * k * C.SUBCHUNK_IN, channel=5,
                                 ctcss_code=12).astype(np.complex64)


_CHAIN_WORKER = r"""
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)
addr, rank, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]
chains = json.loads(sys.argv[4])
from sdr_pmr446_tpu_torch import config as C
from sdr_pmr446_tpu_torch.io import synth
from sdr_pmr446_tpu_torch.ops import decode
from sdr_pmr446_tpu_torch.parallel import distributed as dist
from sdr_pmr446_tpu_torch.parallel.dsd_sharded import ShardedDsdInChain
from sdr_pmr446_tpu_torch.parallel.faithful_sharded import (
    ShardedFaithfulChain)
from sdr_pmr446_tpu_torch.parallel.scanner_sharded import (
    ShardedScannerChain, make_mesh)
from sdr_pmr446_tpu_torch.parallel.single_sharded import ShardedSingleChain
from sdr_pmr446_tpu_torch.scanner.chain import make_runtime_params

STEPS = %d
params = make_runtime_params(C.ScannerArgs(), "cpu")


def build(kind, mesh, k, kw):
    if kind == "scanner":
        return ShardedScannerChain(mesh, C.BlockConfig(k), device="cpu", **kw)
    if kind == "dsd":
        return ShardedDsdInChain(mesh, k, device="cpu")
    if kind == "single":
        return ShardedSingleChain(mesh, 5, k, device="cpu")
    return ShardedFaithfulChain(mesh, k, device="cpu")


def blocks(kind, k):
    iq = synth.make_scanner_iq(STEPS * k * C.SUBCHUNK_IN, channel=5,
                               ctcss_code=12).astype(np.complex64)
    per = k * C.SUBCHUNK_IN
    if kind == "faithful":
        return [iq[None, i * per:(i + 1) * per] for i in range(STEPS)]
    raw = decode.quantize_iq(iq, "cu8")
    return [raw[None, 2 * i * per:2 * (i + 1) * per] for i in range(STEPS)]


def run(chain, data, to_device):
    st, outs = chain.init_state(), []
    for x in data:
        x = to_device(x)
        st, o = (chain.step(st, x) if isinstance(chain, (ShardedDsdInChain,
                                                         ShardedSingleChain))
                 else chain.step(st, x, params))
        outs.append(list(o) if isinstance(o, tuple) else [o])
    return st, outs


dist.initialize(addr, 2, rank, timeout_s=%d)
got, calls = {}, {}
for name, (kind, (n_s, n_t), k, kw) in chains.items():
    gm = dist.global_mesh(n_s, n_t, "cpu")
    chain = build(kind, gm, k, kw)
    data = blocks(kind, k)
    dist.reset_stats()
    st, outs = run(chain, data, lambda x: dist.make_global_array(
        gm, x, sharded_time=True))
    calls[name] = dist.STATS["calls"]
    got[name] = ([dist.process_allgather(o, gm, time_axis=1) for o in outs],
                 list(dist.gather_state(gm, st)))
dist.sync("done")
dist.shutdown()
if rank:
    sys.exit(0)

report, saved = {}, {}
for name, (kind, (n_s, n_t), k, kw) in chains.items():
    ref = build(kind, make_mesh(n_s, n_t, "cpu"), k, kw)
    st, outs = run(ref, blocks(kind, k), torch.from_numpy)
    errors, checked = [], 0
    g_outs, g_state = got[name]
    pairs = [(f"step{i}.{j}", a, b) for i, (go, ro) in
             enumerate(zip(g_outs, outs)) for j, (a, b) in
             enumerate(zip(go, ro))]
    pairs += [(f"state.{j}", a, b) for j, (a, b) in
              enumerate(zip(g_state, st))]
    for what, a, b in pairs:
        a, b = a.numpy(), b.numpy()
        checked += 1
        if a.shape != b.shape or a.dtype != b.dtype \
                or a.tobytes() != b.tobytes():
            errors.append(what)
    report[name] = {"checked": checked, "errors": errors,
                    "collectives": calls[name]}
    if kind == "scanner":
        for i, go in enumerate(g_outs):
            for j, a in enumerate(go):
                saved[f"{name}.{i}.{j}"] = a.numpy()
np.savez(out + ".npz", **saved)
with open(out, "w") as f:
    json.dump(report, f)
""" % (STEPS, GROUP_S)


@pytest.fixture(scope="module")
def chain_runs(tmp_path_factory):
    """Every CHAINS scenario over two ranks, checked by rank 0 against the
    one-process mesh; (report, the scanners' gathered outputs)."""
    out = str(tmp_path_factory.mktemp("dist") / "report.json")
    spawn_pair(_CHAIN_WORKER, lambda r: [out, json.dumps(CHAINS)])
    with open(out) as f, np.load(out + ".npz") as z:
        return json.load(f), {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def jax_unsharded():
    """JAX's unsharded ScannerChain (its default engine) per K on the
    samples of the port's cu8 bytes: each step's outputs."""
    import jax.numpy as jnp
    from sdr_pmr446_tpu.scanner.chain import (ScannerChain,
                                              make_runtime_params)
    outs = {}
    for k in (4, 16):
        raw = tdecode.quantize_iq(scanner_iq(k), "cu8")
        xr, xi = tdecode.decode_planes(torch.from_numpy(raw), "cu8")
        iq = (xr.numpy() + 1j * xi.numpy()).astype(np.complex64)
        chain = ScannerChain(C.BlockConfig(subchunks_per_step=k))
        params = make_runtime_params(C.ScannerArgs())
        st, per = chain.init_state(), k * C.SUBCHUNK_IN
        outs[k] = []
        for i in range(STEPS):
            st, o = chain.step(st, jnp.asarray(iq[i * per:(i + 1) * per]),
                               params)
            outs[k].append([np.asarray(v) for v in o])
    return outs


@pytest.mark.parametrize("name", sorted(CHAINS))
def test_two_ranks_equal_the_one_process_mesh(chain_runs, name):
    """Each chain's outputs and state over two ranks, gathered, equal the
    one-process mesh's bit for bit; a time split crosses the ranks by
    collectives."""
    report = chain_runs[0][name]
    assert report["checked"] > 0
    assert report["errors"] == [], report
    assert report["collectives"] > 0, report


@pytest.mark.parametrize("name,k", [("plane", 4), ("duo", 16)])
def test_two_ranks_within_the_gates_of_jax(chain_runs, jax_unsharded, name,
                                           k):
    """tests/test_multihost.py:66-76: ints exact, floats within 2e-3 of
    JAX's unsharded chain (the audio and RSSI of the zero-padded waterfall
    field aside, every StepOutputs field)."""
    saved = chain_runs[1]
    checked = 0
    for i, want in enumerate(jax_unsharded[k]):
        for j, w in enumerate(want):
            got = saved[f"{name}.{i}.{j}"][0]
            assert got.shape == w.shape, (name, i, j)
            if w.dtype.kind in "fc":
                np.testing.assert_allclose(got, w, rtol=0, atol=2e-3,
                                           err_msg=f"{name} {i} {j}")
            else:
                np.testing.assert_array_equal(got, w,
                                              err_msg=f"{name} {i} {j}")
            checked += 1
    assert checked == STEPS * 17


# ------------------------------------------------------------- scan_batch
_BATCH_WORKER = r"""
import json, os, sys
import torch
torch.set_num_threads(1)
addr, rank, outdir, ref = sys.argv[1], sys.argv[2], sys.argv[3], sys.argv[4]
argv, ref_argv = json.loads(sys.argv[5]), json.loads(sys.argv[6])
from sdr_pmr446_tpu_torch.apps import scan_batch
rc = scan_batch.main(argv + ["--out-dir", outdir, "--coordinator", addr,
                             "--num-processes", "2", "--process-id", rank])
if rc == 0 and rank == "0" and ref != "-":
    rc = scan_batch.main(ref_argv + ["--out-dir", ref])
sys.exit(rc)
"""


def batch_captures(d, n_sub=12, fmt="cs16", prefix="mcap"):
    paths = []
    for s, (ch, code) in enumerate(STREAMS):
        iq = 0.8 * synth.make_scanner_iq(n_sub * C.SUBCHUNK_IN, channel=ch,
                                         ctcss_code=code, seed=s)
        pth = os.path.join(d, f"{prefix}{s}.{fmt}")
        jiq.write_iq(pth, iq, fmt)
        paths.append(pth)
    return paths


def run_batch_pair(tmp, tag, argv, ref="-", ref_argv=None):
    """``argv`` over two processes (and, in rank 0 after it, ``ref_argv``,
    ``argv`` by default, in one process into ``ref``); their directories."""
    outs = [os.path.join(tmp, f"{tag}{r}") for r in range(2)]
    spawn_pair(_BATCH_WORKER,
               lambda r: [outs[r], ref if r == 0 else "-", json.dumps(argv),
                          json.dumps(argv if ref_argv is None else ref_argv)])
    return outs


def files(d) -> dict:
    return {n: open(os.path.join(d, n), "rb").read()
            for n in sorted(os.listdir(d))}


@pytest.fixture(scope="module")
def batch_runs(tmp_path_factory):
    """--mesh 2,2 over two processes and, in rank 0 after it, the same run
    in one process; their directories."""
    tmp = str(tmp_path_factory.mktemp("batch"))
    caps = batch_captures(tmp)
    ref = os.path.join(tmp, "ref")
    outs = run_batch_pair(tmp, "mh", caps + BATCH + ["--mesh", "2,2"], ref)
    return tmp, caps, ref, outs


def test_scan_batch_two_process(batch_runs):
    """Process 0's files equal the one-process run's byte for byte and
    JAX's single-process run's (events equal, WAV atol 2e-3); process 1
    writes none."""
    from sdr_pmr446_tpu.apps import scan_batch as jax_scan_batch
    tmp, caps, ref, (out0, out1) = batch_runs
    assert files(out0) == files(ref)
    assert os.listdir(out1) == []
    jref = os.path.join(tmp, "jax")
    assert jax_scan_batch.main(caps + ["--out-dir", jref, "--mesh", "2,2",
                                       "--subchunks-per-step", "4"]) == 0
    for s in range(len(STREAMS)):
        a_ref, _ = wav.read_wav(os.path.join(jref, f"mcap{s}.wav"))
        a_mh, _ = wav.read_wav(os.path.join(out0, f"mcap{s}.wav"))
        assert len(a_mh) == len(a_ref) > 0
        np.testing.assert_allclose(a_mh, a_ref, rtol=0, atol=2e-3)
        ev = open(os.path.join(jref, f"mcap{s}.events.log")).read()
        assert open(os.path.join(out0, f"mcap{s}.events.log")).read() == ev
        assert ev


def test_scan_batch_two_process_time_split(batch_runs):
    """--mesh 1,4 over two processes (each both captures x two time
    shards), from the --device-decode reader that reads each process's
    time run: process 0's files equal the one-process run's."""
    tmp, caps, _, _ = batch_runs
    argv = caps + BATCH + ["--mesh", "1,4", "--device-decode", "-w", "64"]
    ref = os.path.join(tmp, "ref14")
    out0, out1 = run_batch_pair(tmp, "t", argv, ref)
    assert files(out0) == files(ref)
    assert os.listdir(out1) == []


def test_scan_batch_two_process_checkpoint_resume(batch_runs):
    """tests/test_multihost.py:190-258: both processes stop after one group
    (process 0 writes the gathered state and the accumulators), two
    processes resume it, and process 0's files equal the uninterrupted
    run's; one process refuses to resume the two-process checkpoint."""
    from sdr_pmr446_tpu_torch.apps import scan_batch
    tmp, caps, ref, _ = batch_runs
    ckpt = os.path.join(tmp, "mh.npz")
    argv = caps + BATCH + ["--mesh", "2,2", "--checkpoint", ckpt,
                           "--checkpoint-backend", "npz"]
    run_batch_pair(tmp, "p", argv + ["--stop-after", "1"])
    assert os.path.exists(ckpt) and os.path.exists(ckpt + ".accum.npz")
    with np.load(ckpt) as z:
        assert int(z["block_index"]) == 1 and z["s0"].shape[0] == 2
    out0, out1 = run_batch_pair(tmp, "r", argv + ["--resume"])
    assert files(out0) == files(ref)
    assert os.listdir(out1) == []
    assert scan_batch.main(argv + ["--resume", "--out-dir",
                                   os.path.join(tmp, "one")]) == 1


def test_scan_batch_two_process_orbax_checkpoint_resume(batch_runs):
    """The same over the default backend: both processes call the
    directory save (torch.distributed.checkpoint, a collective) with the
    gathered rows, two processes resume from it, and process 0's files
    equal the uninterrupted run's; the directory holds every stream's
    rows."""
    from sdr_pmr446_tpu_torch.runtime import state as state_io
    tmp, caps, ref, _ = batch_runs
    ckpt = os.path.join(tmp, "mh_dcp")
    argv = caps + BATCH + ["--mesh", "2,2", "--checkpoint", ckpt]
    run_batch_pair(tmp, "po", argv + ["--stop-after", "1"])
    assert os.path.isfile(os.path.join(ckpt, ".metadata"))
    assert os.path.exists(ckpt + ".accum.npz")
    bi, st = state_io.load_state_orbax(ckpt, "cpu")
    assert bi == 1 and st.dc_x.shape[0] == 2
    out0, out1 = run_batch_pair(tmp, "ro", argv + ["--resume"])
    assert files(out0) == files(ref)
    assert os.listdir(out1) == []


def test_scan_batch_stop_on_one_process_stops_both(tmp_path):
    """A stop asked of process 1 alone (--stop-after 2 on its command line,
    as a signal to it would): both processes agree on it, stop after the
    same group and exit 0, process 0 writing the final checkpoint; two
    processes resume it, and process 0's files equal an uninterrupted
    one-process run's (run by rank 0 after the resumed run)."""
    tmp = str(tmp_path)
    caps = batch_captures(tmp, n_sub=24, prefix="scap")
    ckpt = os.path.join(tmp, "stop.npz")
    argv = caps + BATCH + ["--mesh", "2,2", "--checkpoint", ckpt,
                           "--checkpoint-backend", "npz"]
    logs = spawn_pair(_BATCH_WORKER, lambda r: [
        os.path.join(tmp, f"k{r}"), "-",
        json.dumps(argv + (["--stop-after", "2"] if r else [])), "[]"])
    assert int(np.load(ckpt)["block_index"]) == 2
    for _, err in logs:
        assert "stopped by signal at block 2" in err, err
    ref = os.path.join(tmp, "ref")
    out0, out1 = run_batch_pair(tmp, "r", argv + ["--resume"], ref,
                                caps + BATCH + ["--mesh", "2,2"])
    assert files(out0) == files(ref)
    assert os.listdir(out1) == []


# ----------------------------------------------------------------- layout
@pytest.mark.parametrize("shape,procs,shards,want", [
    ((2, 2), 2, None, [(0, 1, 0, 2), (1, 1, 0, 2)]),
    ((1, 4), 2, None, [(0, 1, 0, 2), (0, 1, 2, 2)]),
    ((4, 5), 2, None, [(0, 2, 0, 5), (2, 2, 0, 5)]),
    ((2, 4), 2, 1, [(0, 2, 0, 2), (0, 2, 2, 2)]),
    ((4, 2), 4, 2, [(0, 2, 0, 1), (0, 2, 1, 1), (2, 2, 0, 1),
                    (2, 2, 1, 1)]),
    ((8, 1), 1, 2, [(0, 8, 0, 1)]),
])
def test_rank_blocks(shape, procs, shards, want):
    """JAX's global_mesh order, time fastest: whole stream shards, or one
    stream shard's streams x a run of its time shards."""
    got = [tuple(distributed.rank_block(*shape, procs, r, shards))
           for r in range(procs)]
    assert got == want


@pytest.mark.parametrize("shape,procs,pid,shards", [
    ((3, 2), 2, 0, None),       # 6 shards: 3 a rank, no rectangle
    ((1, 1), 2, 0, None),       # fewer devices than processes
    ((2, 3), 4, 0, 2),          # 6 devices over 4 processes
    ((2, 2), 2, 2, None),       # the process id outside [0, 2)
    ((2, 2), 2, -1, None),
    ((3, 1), 1, 0, 2),          # 3 streams over 2 stream shards
])
def test_rank_blocks_refused(shape, procs, pid, shards):
    with pytest.raises(ValueError):
        distributed.rank_block(*shape, procs, pid, shards)


def test_missing_peer_fails_within_the_timeout():
    """Rank 0 of two alone: the rendezvous raises within the group's
    timeout instead of hanging; nothing is left joined."""
    script = (
        "import sys\n"
        "from sdr_pmr446_tpu_torch.parallel import distributed as d\n"
        "try:\n"
        "    d.initialize(sys.argv[1], 2, 0, timeout_s=3)\n"
        "except Exception as e:\n"
        "    print(type(e).__name__)\n"
        "    sys.exit(3)\n")
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-c", script, free_address()],
                         env=dict(os.environ, PYTHONPATH=ROOT),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 3, res.stderr[-2000:]
    assert time.perf_counter() - t0 < 60


def test_one_process_group_and_the_collectives():
    """A group of one (what --coordinator with one process joins): the
    initialize guard, every helper on a one-rank mesh, shutdown."""
    addr = free_address()
    assert distributed.initialize(addr, 1, 0, timeout_s=30)
    try:
        assert not distributed.initialize(addr, 1, 0)
        gm = distributed.global_mesh(2, 2, "cpu")
        assert (gm.n_stream, gm.n_time, gm.group) == (2, 2, None)
        x = torch.arange(8).reshape(2, 4)
        assert torch.equal(distributed.make_global_array(gm, x.numpy(), True),
                           x)
        assert torch.equal(distributed.process_allgather(x, gm, 1), x)
        parts = distributed.all_gather([x, x.float()])
        assert len(parts) == 1 and torch.equal(parts[0][1], x.float())
        assert distributed.agree(True) and not distributed.agree(False)
        distributed.sync("test")
    finally:
        distributed.shutdown()
    assert distributed.process_count() == 1
