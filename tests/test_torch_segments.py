"""A time split's megastep as CUDA-graph segments around its host-staged
collectives (runtime/fuse.py ``SegmentedGraphRecorder``,
parallel/distributed.py ``Exchange``).

On the CPU, two gloo worker processes a case (as in
tests/test_torch_distributed.py), each rank one half of a time split:

  - the collective schedule of the duo at (1, 2), K = 16 and of the plane
    path with K11 at (1, 4), K = 4: the number of ``all_gather`` calls a
    step and each one's bytes, the same on both ranks and from step to
    step (what a capture relies on);
  - the static-buffer staging path: the warm-up's plan, then a capture
    emulated on the CPU (the body runs at once, and each cut runs its
    Exchange there and then, as a replay does between two segments) gives
    outputs and state bit-equal to the eager collectives, with one
    Exchange a collective; ``Exchange.agree`` passes on equal schedules
    and raises on both ranks when one rank's differs.

On the card (``cuda`` marker; ``python -m pytest
tests/test_torch_segments.py -m cuda --noconftest`` — this module imports
no JAX): both ranks on cuda:0, ``multi_step`` at S = 2 captured as
segments, bit-equal to the loop of its steps, twice (capture, then a
replay from the returned state), with one graph more than collectives.
The CPU megastep stays the loop (tests/test_torch_multistep.py).
"""

import json
import os
import socket
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: seconds a worker may take, and its process group's timeout
WORKER_S, GROUP_S = 300, 60
#: case -> (mesh, K, constructor keywords)
CASES = {"duo": ((1, 2), 16, {}), "plane_dma": ((1, 4), 4,
                                                {"halo_dma": True})}

_WORKER = r"""
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)
addr, rank, out, device = sys.argv[1], int(sys.argv[2]), sys.argv[3], \
    sys.argv[4]
cases = json.loads(sys.argv[5])
from sdr_pmr446_tpu_torch import config as C
from sdr_pmr446_tpu_torch.io import synth
from sdr_pmr446_tpu_torch.ops import decode
from sdr_pmr446_tpu_torch.parallel import distributed as dist
from sdr_pmr446_tpu_torch.parallel.scanner_sharded import ShardedScannerChain
from sdr_pmr446_tpu_torch.runtime import fuse
from sdr_pmr446_tpu_torch.scanner.chain import make_runtime_params

STEPS = 4


class CpuSegments(fuse.SegmentedGraphRecorder):
    # the recorder's protocol on the CPU: the capture runs the body at
    # once, and each cut runs its Exchange at once (a replay's order)
    def __init__(self):
        super().__init__(None)

    def cut(self):
        if len(self.cuts) >= len(self.planned):
            raise RuntimeError("more collectives than the warm-up's")
        self.cuts.append(self.planned[len(self.cuts)])
        self.cuts[-1]()
        return self.cuts[-1]

    def capture(self, fn):
        with self.active(True):
            return fn()


def blocks(k):
    iq = synth.make_scanner_iq(STEPS * k * C.SUBCHUNK_IN, channel=5,
                               ctcss_code=12).astype(np.complex64)
    raw = decode.quantize_iq(iq, "cu8")
    per = 2 * k * C.SUBCHUNK_IN
    return [raw[None, i * per:(i + 1) * per] for i in range(STEPS)]


def loop(chain, st, xs, params):
    outs = []
    for x in xs:
        st, o = chain.step(st, x, params)
        outs.append(list(o))
    return list(st), outs


def same(a, b):
    return all(x.dtype == y.dtype and x.shape == y.shape and
               x.cpu().numpy().tobytes() == y.cpu().numpy().tobytes()
               for x, y in zip(a, b))


dist.initialize(addr, 2, rank, timeout_s=%d)
eager_all_gather = dist.all_gather
report = {}
for name, ((n_s, n_t), k, kw) in cases.items():
    gm = dist.global_mesh(n_s, n_t, device)
    chain = ShardedScannerChain(gm, C.BlockConfig(k), device=gm.device, **kw)
    params = make_runtime_params(C.ScannerArgs(), gm.device)
    xs = [dist.make_global_array(gm, b, sharded_time=True)
          for b in blocks(k)]
    rep = report[name] = {}
    if device == "cpu":
        sched = []

        def recording(tensors, group=None):
            sched[-1].append(sum(t.numel() * t.element_size()
                                 for t in tensors))
            return eager_all_gather(tensors, group)

        dist.all_gather = recording
        st = chain.init_state()
        for x in xs:
            sched.append([])
            st, _ = chain.step(st, x, params)
        dist.all_gather = eager_all_gather
        rep["schedule"] = sched
        st0 = chain.init_state()
        want_st, want = loop(chain, st0, xs, params)
        rec = CpuSegments()
        with rec.active(False):
            plan_st, plan = loop(chain, st0, xs, params)
        got_st, got = rec.capture(lambda: loop(chain, st0, xs, params))
        dist.Exchange.agree(rec.cuts)
        rep["planned"] = len(rec.planned)
        rep["cuts"] = len(rec.cuts)
        rep["staged_equal"] = (same(got_st, want_st) and all(
            same(g, w) for g, w in zip(got, want)))
        rep["planned_equal"] = (same(plan_st, want_st) and all(
            same(g, w) for g, w in zip(plan, want)))
        try:
            dist.Exchange.agree(rec.cuts if rank == 0 else rec.cuts[:-1])
            rep["mismatch"] = "accepted"
        except RuntimeError as e:
            rep["mismatch"] = str(e)
    else:
        half = len(xs) // 2
        pairs = [torch.stack(xs[:half]), torch.stack(xs[half:])]
        st = chain.init_state()
        rep["equal"] = []
        for i, pair in enumerate(pairs):
            want_st, want = loop(chain, st, list(pair), params)
            torch.cuda.synchronize()
            dist.reset_stats()
            got_st, got = chain.multi_step(st, pair, params)
            torch.cuda.synchronize()
            cat = [torch.cat([w[j] for w in want], dim=1)
                   for j in range(len(want[0]))]
            rep["equal"].append(same(list(got_st), want_st)
                                and same(list(got), cat))
            rep.setdefault("collectives", []).append(dist.STATS["calls"])
            st = got_st
        (graph,) = chain.megastep.graphs.values()
        rep["graphs"] = len(graph.graph.recorder.graphs)
        rep["cuts"] = len(graph.graph.recorder.cuts)
dist.sync("done")
dist.shutdown()
with open(out + f".{rank}", "w") as f:
    json.dump(report, f)
""" % GROUP_S


def free_address() -> str:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"127.0.0.1:{s.getsockname()[1]}"


def run_pair(tmp, device: str) -> list:
    """The worker as ranks 0 and 1 on ``device``; each rank's report."""
    addr, out = free_address(), os.path.join(tmp, "report")
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, addr, str(r), out, device,
         json.dumps(CASES)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(2)]
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
    reports = []
    for r in range(2):
        with open(f"{out}.{r}") as f:
            reports.append(json.load(f))
    return reports


@pytest.fixture(scope="module")
def cpu_pair(tmp_path_factory):
    return run_pair(str(tmp_path_factory.mktemp("segments")), "cpu")


@pytest.mark.parametrize("name", sorted(CASES))
def test_collective_schedule_is_fixed(cpu_pair, name):
    """Each step makes the same collectives with the same sizes, on both
    ranks: the duo 5 a step, the plane path with K11 11."""
    scheds = [rep[name]["schedule"] for rep in cpu_pair]
    assert scheds[0] == scheds[1]
    assert all(step == scheds[0][0] for step in scheds[0])
    assert len(scheds[0][0]) == {"duo": 5, "plane_dma": 11}[name]
    assert all(n > 0 for n in scheds[0][0])


@pytest.mark.parametrize("name", sorted(CASES))
def test_staged_exchanges_equal_the_eager_collectives(cpu_pair, name):
    """The warm-up (eager collectives, planning an Exchange each) and the
    emulated capture (each collective through its Exchange's static
    buffers) both give the eager loop's outputs and state bit for bit."""
    for rep in cpu_pair:
        r = rep[name]
        steps = len(r["schedule"])
        assert r["planned"] == r["cuts"] == steps * len(r["schedule"][0])
        assert r["planned_equal"] and r["staged_equal"]


def test_schedule_agreement_refuses_a_mismatch(cpu_pair):
    """Exchange.agree with one rank's schedule short by one collective
    raises on both ranks, naming the two schedules."""
    for rep in cpu_pair:
        for name in CASES:
            assert "different collective schedules" in rep[name]["mismatch"]


@pytest.mark.cuda
def test_time_split_megastep_on_card_equals_the_loop(tmp_path):
    """Two ranks on cuda:0: a captured megastep (S = 2) and then its
    replay, each bit-equal to the loop of its steps from the same state;
    graphs = collectives + 1; each replay counts its collectives."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from sdr_pmr446_tpu_torch.kernels import build
    build.build()                    # once, before the two ranks load it
    for rep in run_pair(str(tmp_path), "cuda"):
        for name in CASES:
            r = rep[name]
            assert r["equal"] == [True, True], (name, r)
            per_step = {"duo": 5, "plane_dma": 11}[name]
            assert r["cuts"] == 2 * per_step and r["graphs"] == r["cuts"] + 1
            # the capture's call: warm-up's eager collectives, then the
            # replay; the second call: the replay's alone
            assert r["collectives"] == [2 * 2 * per_step, 2 * per_step], r
