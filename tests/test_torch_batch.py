"""The batch loop (sdr_pmr446_tpu_torch/runtime/batch.py BatchScanner) on
the CPU, at the sizes of tests/test_torch_scan_batch.py (two cs16 captures,
K = 8, ``-w 64``, ``--steps-per-dispatch 2``, meshes 2,1 and 2,4):

  - over an in-memory source it gives each capture the audio, event lines
    and waterfall rows that ``scan_batch.main`` writes to files for the
    same captures (the WAV byte for byte);
  - ``stop()`` ends the run after the group in flight, counting no block
    that was not dispatched; a stop before the run reads nothing;
  - ``on_group`` sees every group once, in order, with every capture's
    rows, equal to the chain stepped block by block;
  - with the recorder on, the ``batch.*`` spans once a group, with the
    group's first block, and the ``batch.groups`` / ``batch.blocks``
    counters;
  - two gloo processes (``subprocess``, one rank each, as
    tests/test_torch_distributed.py runs them) give the same ``on_group``
    arrays on both ranks, equal bit for bit to a one-process run at the
    same thread count, with the gather's spans (``batch.gather`` over
    ``gather.stage`` / ``gather.collective``, ``batch.agree``) and
    ``distributed.STATS``, as ``snapshot()`` reads it, counting one
    collective a group;
  - a rank runs no more intra-op threads than its share of its host's
    CPUs (``distributed.cpu_share``, on hosts made up here), and
    ``shutdown`` gives them back.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from sdr_pmr446_tpu_torch import config as C
from sdr_pmr446_tpu_torch.apps import scan_batch
from sdr_pmr446_tpu_torch.io import iq as iq_io
from sdr_pmr446_tpu_torch.io import native, synth, wav
from sdr_pmr446_tpu_torch.parallel import distributed
from sdr_pmr446_tpu_torch.parallel.scanner_sharded import (
    ShardedScannerChain, make_mesh)
from sdr_pmr446_tpu_torch.runtime.batch import BatchScanner
from sdr_pmr446_tpu_torch.scanner.chain import make_runtime_params
from sdr_pmr446_tpu_torch.utils import profiling as P

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STREAMS = [(5, 12), (9, 20)]
K, FUSE, W = 8, 2, 64
MESHES = ("2,1", "2,4")
#: seconds a worker may take, and its process group's timeout
WORKER_S, GROUP_S = 300, 60


def captures(d, n_sub):
    paths = []
    for s, (ch, code) in enumerate(STREAMS):
        iq = 0.8 * synth.make_scanner_iq(n_sub * C.SUBCHUNK_IN, channel=ch,
                                         ctcss_code=code, seed=s)
        pth = os.path.join(d, f"cap{s}.cs16")
        iq_io.write_iq(pth, iq, "cs16")
        paths.append(pth)
    return paths


def wire_blocks(paths, block_len: int) -> list:
    """The captures as the CLI's default reader hands them over, from
    memory: (cf32 wire uint8 [S, block_len * 8], most samples read) a
    block, the tail padded with complex zeros."""
    iq = [native.convert_iq(np.fromfile(p, np.int16), "cs16") for p in paths]
    n = max(len(x) for x in iq)
    out = []
    for a in range(0, n, block_len):
        blk = np.zeros((len(iq), block_len), np.complex64)
        for s, x in enumerate(iq):
            part = x[a:a + block_len]
            blk[s, :len(part)] = part
        out.append((blk.view(np.uint8), min(block_len, n - a)))
    return out


def scanner(mesh: str, waterfall: int = W, steps: int = FUSE, **kw):
    s_axis, t_axis = (int(v) for v in mesh.split(","))
    m = make_mesh(len(STREAMS), t_axis, "cpu")
    chain = ShardedScannerChain(m, C.BlockConfig(K), waterfall=waterfall,
                                input_format="cf32", device=m.device)
    args = C.ScannerArgs(
        audio_gain=C.SDR_DEFAULT_AUDIO_GAIN,
        squelch_level=C.SDR_DEFAULT_SQUELCH_LEVEL, lowpass=False,
        channel_mask=(1 << C.MAX_CHANNELS) - 1, lock_mode="start")
    params = make_runtime_params(args, chain.device)
    return BatchScanner(chain, params, chain.init_state(), steps,
                        waterfall=waterfall > 0, **kw)


@pytest.fixture(scope="module")
def caps(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("batch"))
    return d, captures(d, 10), captures(str(tmp_path_factory.mktemp("long")),
                                        40)


@pytest.mark.parametrize("mesh", MESHES)
def test_in_memory_source_gives_the_cli_files(caps, mesh, tmp_path):
    d, paths, _ = caps
    outd = str(tmp_path / "cli")
    assert scan_batch.main(paths + [
        "--subchunks-per-step", str(K), "--steps-per-dispatch", str(FUSE),
        "-w", str(W), "--mesh", mesh, "--device", "cpu", "--out-dir",
        outd]) == 0
    sc = scanner(mesh)
    assert sc.run(wire_blocks(paths, sc.chain.block.input_len)) is False
    assert sc.blocks_done == 2 and sc.subchunk == 2 * K
    assert sc.total_got == 10 * C.SUBCHUNK_IN
    real_sub = 10
    for s, stem in enumerate(("cap0", "cap1")):
        mine = str(tmp_path / f"{stem}.wav")
        wav.write_wav(mine, np.concatenate(sc.audio[s]), C.AUDIO_SAMPLERATE)
        with open(mine, "rb") as a, open(os.path.join(outd, f"{stem}.wav"),
                                         "rb") as b:
            assert a.read() == b.read(), stem
        ev = open(os.path.join(outd, f"{stem}.events.log")).read()
        assert ev == "\n".join(sc.events[s]) + "\n"
        assert f"Tuned to channel {STREAMS[s][0]}" in ev
        wf = open(os.path.join(outd, f"{stem}.waterfall.log")).read()
        assert wf == "\n".join(sc.wf_lines[s][:real_sub]) + "\n"


def stepped(paths, block_len: int, blocks: int) -> dict:
    """The chain stepped block by block: field -> [S, blocks * K, ...]."""
    sc = scanner("2,1")
    st, outs = sc.state, []
    for wire, _ in wire_blocks(paths, block_len)[:blocks]:
        st, o = sc.chain.step(st, torch.from_numpy(wire), sc.params)
        outs.append(o)
    return {f: np.concatenate([getattr(o, f).numpy() for o in outs], 1)
            for f in outs[0]._fields}


def test_on_group_sees_every_group_once_in_order(caps):
    """Five blocks at two a dispatch: groups of 2, 2 and a tail block,
    each once with every capture's rows, equal to single steps."""
    _, _, paths = caps
    sc = scanner("2,1")
    seen = []
    sc.run(wire_blocks(paths, sc.chain.block.input_len),
           lambda host, first, n: seen.append((first, n, host)))
    assert [(f, n) for f, n, _ in seen] == [(0, 2), (2, 2), (4, 1)]
    for _, n, host in seen:
        assert host["active_chan"].shape == (2, n * K)
        assert host["audio"].shape == (2, n * K, C.SUBCHUNK_AUDIO)
    want = stepped(paths, sc.chain.block.input_len, 5)
    for f, v in want.items():
        got = np.concatenate([h[f] for _, _, h in seen], 1)
        np.testing.assert_array_equal(got, v, err_msg=f)


def test_stop_ends_after_the_group_in_flight(caps):
    """A stop asked while group 0 is drained (group 1 dispatched): group 1
    is drained, nothing after it is dispatched or counted."""
    _, _, paths = caps
    sc = scanner("2,1", waterfall=0)
    block_len = sc.chain.block.input_len
    taken = []
    source = wire_blocks(paths, block_len)

    def blocks():
        for item in source:
            taken.append(1)
            yield item

    firsts = []

    def on_group(host, first, n):
        firsts.append(first)
        sc.stop()
    assert sc.run(blocks(), on_group) is True
    assert firsts == [0, 2]
    assert sc.blocks_done == 4 and sc.subchunk == 4 * K
    assert sc.total_got == 4 * block_len
    assert len(taken) == 4
    # a stop before the run: nothing read, nothing dispatched
    again = scanner("2,1", waterfall=0)
    again.stop()
    assert again.run(blocks()) is True
    assert again.blocks_done == 0 and again.total_got == 0


def test_recorder_holds_the_batch_spans_once_a_group(caps):
    _, _, paths = caps
    sc = scanner("2,1", waterfall=0, save=lambda *a: None,
                 checkpoint_every=1)
    before, calls = dict(P.COUNTS), distributed.STATS["calls"]
    with P.recording():
        sc.run(wire_blocks(paths, sc.chain.block.input_len))
    snap = P.snapshot()
    delta = {k: n - before[k] for k, n in P.COUNTS.items()}
    assert snap.distributed["calls"] == calls       # one process: no gather
    spans: dict = {}
    for s in snap.spans:
        spans.setdefault(s.name, []).append(s)
    for name in ("batch.dispatch", "batch.fetch", "batch.outputs"):
        assert [s.block for s in spans[name]] == [0, 2, 4], name
    # a checkpoint every full group, read back when the group is drained
    assert [s.block for s in spans["batch.checkpoint"]] == [0, 2]
    assert not set(spans) & {"batch.gather", "batch.agree", "gather.stage",
                             "gather.collective"}
    assert [s.block for s in spans["prefetch.source"]] == list(range(6))
    assert delta["batch.groups"] == 3 and delta["batch.blocks"] == 5


# ------------------------------------------------------------ two processes
_WORKER = r"""
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)
addr, rank = sys.argv[1], int(sys.argv[2])
paths, out = sys.argv[3:5], sys.argv[5]
from sdr_pmr446_tpu_torch import config as C
from sdr_pmr446_tpu_torch.io import native
from sdr_pmr446_tpu_torch.parallel import distributed
from sdr_pmr446_tpu_torch.parallel.scanner_sharded import (
    ShardedScannerChain, make_mesh)
from sdr_pmr446_tpu_torch.runtime.batch import BatchScanner
from sdr_pmr446_tpu_torch.scanner.chain import make_runtime_params
from sdr_pmr446_tpu_torch.utils import profiling as P

iq = [native.convert_iq(np.fromfile(p, np.int16), "cs16") for p in paths]


def run(mesh, rows):
    chain = ShardedScannerChain(mesh, C.BlockConfig(8), input_format="cf32",
                                device="cpu")
    params = make_runtime_params(C.ScannerArgs(), chain.device)
    sc = BatchScanner(chain, params, chain.init_state(), 2,
                      writer=rank == 0)
    n = chain.block.input_len
    blocks = [(np.stack([x[a:a + n] for x in iq])[rows].view(np.uint8), n)
              for a in range(0, len(iq[0]), n)]
    seen = {}
    sc.run(blocks, lambda host, first, k: seen.update(
        {f"{f}.{first}": v for f, v in host.items()}))
    return sc, seen

distributed.initialize(addr, 2, rank, timeout_s=60)
mesh = distributed.global_mesh(2, 1, "cpu")
distributed.reset_stats()
before = dict(P.COUNTS)
with P.recording():
    sc, seen = run(mesh, slice(rank, rank + 1))
snap = P.snapshot()
spans = {}
for s in snap.spans:
    spans.setdefault(s.name, []).append(s.block)
delta = {k: v - before[k] for k, v in P.COUNTS.items()}
distributed.shutdown()
np.savez(out + ".npz", **seen)
info = {"spans": spans, "delta": delta, "events": sc.events,
        "blocks": sc.blocks_done, "gloo": snap.distributed}
if rank == 0:
    _, one = run(make_mesh(2, 1, "cpu"), slice(None))
    np.savez(out + ".one.npz", **one)
json.dump(info, open(out + ".json", "w"))
"""


def free_address() -> str:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"127.0.0.1:{s.getsockname()[1]}"


def test_two_processes_gather_every_group_to_both(tmp_path):
    paths = captures(str(tmp_path), 24)          # 3 blocks: a group, a tail
    addr = free_address()
    outs = [str(tmp_path / f"rank{r}") for r in range(2)]
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, addr, str(r)]
                              + paths + [outs[r]], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
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
    got = [dict(np.load(o + ".npz")) for o in outs]
    one = dict(np.load(outs[0] + ".one.npz"))
    assert sorted(got[0]) == sorted(got[1]) == sorted(one)
    assert {k.split(".")[1] for k in one} == {"0", "2"}
    for k, v in one.items():
        assert v.shape[0] == 2, k
        np.testing.assert_array_equal(got[0][k], v, err_msg=k)
        np.testing.assert_array_equal(got[1][k], v, err_msg=k)
    for r, o in enumerate(outs):
        info = json.load(open(o + ".json"))
        spans, delta = info["spans"], info["delta"]
        assert info["blocks"] == 3
        for name in ("batch.dispatch", "batch.fetch", "batch.gather",
                     "batch.outputs"):
            assert spans[name] == [0, 2], (r, name)
        # one collective a group, its spans children of batch.gather
        assert spans["gather.stage"] == spans["gather.collective"] == [0, 2]
        # the stop agreed after the full group, before the tail, at the end
        assert len(spans["batch.agree"]) == 3
        assert info["gloo"]["calls"] == 2 and info["gloo"]["bytes"] > 0
        assert delta["batch.groups"] == 2 and delta["batch.blocks"] == 3
        # only the writer accumulates
        assert any(info["events"]) == (r == 0)


# -------------------------------------------------- the ranks' share of a host
@pytest.fixture
def host(monkeypatch):
    """Four ranks whose hosts ``hosts`` lists (set by the test), on hosts
    of 16 CPUs each."""
    hosts = []

    def gather(out, mine):
        out[:] = hosts
    monkeypatch.setattr(os, "sched_getaffinity", lambda pid: set(range(16)))
    monkeypatch.setattr(distributed, "_threads", None)
    monkeypatch.setattr(distributed, "process_count", lambda: 4)
    monkeypatch.setattr(distributed, "process_index", lambda: 1)
    monkeypatch.setattr(distributed.dist, "all_gather_object", gather)
    return hosts


@pytest.mark.parametrize("hosts, threads, share", [
    (["a"] * 4, 8, 4),                  # four ranks on one host
    (["a", "a", "b", "b"], 12, 8),      # two a host
    (["a"] * 4, 2, 2)])                 # never more threads than before
def test_a_rank_runs_no_more_threads_than_its_share_of_its_host(
        host, hosts, threads, share):
    host += hosts
    before = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        assert distributed.cpu_share() == share
        assert torch.get_num_threads() == share
        # taken once a process
        torch.set_num_threads(threads)
        assert distributed.cpu_share() == threads
        torch.set_num_threads(share)
    finally:
        distributed.shutdown()
        assert torch.get_num_threads() == threads
        torch.set_num_threads(before)


def test_a_process_of_its_own_keeps_its_threads(host, monkeypatch):
    monkeypatch.setattr(distributed, "process_count", lambda: 1)
    threads = torch.get_num_threads()
    assert distributed.cpu_share() == threads
    assert distributed._threads is None
