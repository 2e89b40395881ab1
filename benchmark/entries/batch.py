"""Entry: many captures over several cards through ``BatchScanner.run``.

The path ``apps/scan_batch.py`` takes with ``--coordinator --num-processes
P --device-decode`` on cu8 captures, one rank a card: each rank joins the
program's gloo group at the coordinator (``distributed.initialize``), holds
its captures' whole streams on the global (captures x 1) mesh
(``distributed.global_mesh``) and runs the sharded chain through
``runtime/batch.py``'s ``BatchScanner``: the pinned ring, ``steps_per_
dispatch`` blocks a ``multi_step`` (a CUDA graph), each group read back
after the next is dispatched, its outputs gathered to every process,
process 0's writer loop over every capture's sub-chunks, and the stop
agreed after every group.

Capture c of rank r is the global capture ``r * per + c``: its timeline is
planned from (seed, global capture) (``traffic.plan``), and its pool of
``pool_blocks`` blocks made on the rank's card and kept in host memory,
offered in order and from its start again, with no seam.  The window opens
at the common start that ``start()`` returns, after one warm group; it
ends by the program's own agreed stop: once its deadline has passed, a rank
calls ``stop()`` from ``on_group``, and every rank stops after the same
group.  The source never ends, so no rank waits in a gather for one that
stopped before it; blocks read into the ring and never dispatched are not
part of the window.  A block is taken when the ring takes it from the
source and home when ``on_group`` sees its outputs, after the gather; a
stream-block is one capture's block.  The chain's ``multi_step`` (``step``
at one block a dispatch) is timed as entries/driver.py times it, the drain
named ``bench:drain`` in the trace.

The checks are rank 0's, taken from process 0's gathered outputs, so they
check what the deployment writes: a seeded sample of ``check_blocks`` - 1
capture-blocks spread over the ranks' captures, at least one a rank, and
one capture-block of the window's last group.  The wire of a
checked capture, wherever it ran, is made again on rank 0 from (seed,
capture, block).  A traced run turns the program's recorder on from the
window's start: the idle gaps are named by its spans, and the self time of
``batch.gather`` (with its ``gather.*`` children) and of ``batch.fetch``
over the window's untraced part goes to ``Window.counters`` in seconds
(``gather_s``, ``fetch_s``), for the readers of this cell; on the CPU (the
tests' ranks) no device is traced.

A fault of benchlib/faults.py planted on the scanner chain's step
(``faults.plant``, or a patch of ``ScannerChain.step`` by
``faults.broken_step``) is planted on the sharded chain's step too, which
does not call it: the faults act on any chain's state and outputs.

Each rank prints to stderr its intra-op threads (its share of the host's
CPUs, ``distributed.cpu_share``), its resident memory after each stage of
its set-up, and over the window its CPU seconds and ``distributed.STATS``'
staging and collective seconds: a slow window shows there as host time.
"""

from __future__ import annotations

import collections
import inspect
import itertools
import os
import resource
import sys
import time

import numpy as np
import torch
from torch.profiler import record_function

from benchlib import faults
from benchlib import spans as SP
from benchlib import spec
from benchlib import traffic as T
from benchlib import window as W
from benchlib.trace import Stretch, Tracer

#: spans whose self times sum to the gather's host time (the collectives
#: of parallel/distributed.py run inside ``batch.gather``)
GATHER = ("batch.gather", "gather.stage", "gather.collective")
FETCH = ("batch.fetch",)


def planted_fault():
    """The name of the fault of benchlib/faults.py planted on the scanner
    chain's step in this process, or None."""
    from sdr_pmr446_tpu_torch.scanner.chain import ScannerChain
    step = ScannerChain.step
    if getattr(step, "__module__", None) != faults.__name__:
        return None
    return inspect.getclosurevars(step).nonlocals["fault"].__name__


def resident() -> int:
    """This process's resident bytes now."""
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


def run_rank(rank: int, ranks: int, coordinator: str, cfg: dict, mix: dict,
             seed: int, seconds: float, trace: bool, device, t_start: float,
             start) -> W.Window:
    # first: a tree without the batch loop fails here, on every rank, at
    # once, before any rendezvous
    from sdr_pmr446_tpu_torch.runtime.batch import BatchScanner
    from sdr_pmr446_tpu_torch.parallel import distributed
    from sdr_pmr446_tpu_torch.parallel.scanner_sharded import (
        ShardedScannerChain)

    stages = W.Stages(t_start)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.cuda.init()
    stages.mark("imports and the CUDA context")
    # the fault planted on the scanner chain's step, on the sharded one's
    # too (before the chain is built: its megastep holds its step)
    sound = ShardedScannerChain.step
    fault = planted_fault()
    if fault is not None:
        ShardedScannerChain.step = faults.broken_step(sound, fault)
    distributed.initialize(coordinator, ranks, rank)
    try:
        return _run_rank(rank, ranks, cfg, mix, seed, seconds, trace, dev,
                         t_start, start, stages)
    finally:
        distributed.shutdown()
        ShardedScannerChain.step = sound


def _run_rank(rank, ranks, cfg, mix, seed, seconds, trace, dev, t_start,
              start, stages) -> W.Window:
    from sdr_pmr446_tpu_torch import config as C
    from sdr_pmr446_tpu_torch.parallel import distributed
    from sdr_pmr446_tpu_torch.parallel.scanner_sharded import (
        ShardedScannerChain)
    from sdr_pmr446_tpu_torch.runtime.batch import BatchScanner
    from sdr_pmr446_tpu_torch.scanner.chain import make_runtime_params
    from sdr_pmr446_tpu_torch.utils import profiling

    cuda = dev.type == "cuda"
    n_caps, n_fuse = mix["captures"], mix["steps_per_dispatch"]
    k, pool_blocks = cfg["subchunks_per_step"], mix["pool_blocks"]
    if n_caps % ranks:
        raise ValueError(f"{n_caps} captures do not split over {ranks} "
                         "ranks")
    per = n_caps // ranks
    mem = [("the group", resident())]
    mesh = distributed.global_mesh(n_caps, 1, dev, n_caps)
    chain = ShardedScannerChain(
        mesh, C.BlockConfig(k), lowpass=cfg["lowpass"],
        waterfall=cfg["waterfall"], input_format=cfg["wire"],
        device=mesh.device, engine=cfg["engine"])
    params = make_runtime_params(
        C.ScannerArgs(audio_gain=cfg["audio_gain"],
                      squelch_level=cfg["squelch_db"],
                      lowpass=cfg["lowpass"], lock_mode=cfg["lock_mode"]),
        chain.device)
    sc = BatchScanner(chain, params, chain.init_state(), n_fuse,
                      writer=rank == 0, waterfall=cfg["waterfall"] > 0)
    stages.mark("the group, the mesh and the chain")
    mem.append(("the chain", resident()))

    n_blk = k * C.SUBCHUNK_IN
    band = mix["band"]
    checker = rank == 0
    plans = {c: T.plan(band, seed, c, pool_blocks * n_blk)
             for c in (range(n_caps) if checker
                       else range(rank * per, (rank + 1) * per))}
    pool = np.empty((pool_blocks, per, 2 * n_blk), np.uint8)
    host_pool = torch.from_numpy(pool)
    for c in range(per):
        g = rank * per + c
        index = T.by_block(plans[g], n_blk)
        for j in range(pool_blocks):
            host_pool[j, c].copy_(T.make_block(band, plans[g], index[j], seed,
                                               g, j, n_blk, dev))
    stages.mark("the traffic pool")
    mem.append(("the pool", resident()))
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)

    period = pool_blocks * k
    quiet = {c: p.quiet_subchunks() for c, p in plans.items()}
    warm_sub = spec.module("references", cfg["reference"]).WARM_SUBCHUNKS
    rng = np.random.default_rng(np.random.SeedSequence([seed, 7]))
    left = mix["check_blocks"] - 1
    # the draws spread over the ranks' captures, at least one a rank
    samples = [W.Reservoir(max(1, left // ranks + (r < left % ranks)), rng)
               for r in range(ranks)]
    recent: collections.deque = collections.deque(maxlen=max(
        W.max_back(q, period, k) for q in quiet.values()))
    st = {"keep": False, "stretch": None, "homes": {}, "last": None,
          "last_home": 0.0, "deadline": float("inf"), "step_s": 0.0,
          "span_blocks": 0, "trace_blocks": 0, "dispatched": 0,
          "group_at": []}

    def kept(c: int, block: int) -> tuple:
        """What a check of capture c's block needs: its span and a copy of
        the capture's outputs from the first compared sub-chunk on."""
        first, cmp = W.span(block, k, quiet[c], period, warm_sub)
        rows = [(b, h, j) for b, h, j in recent if b >= cmp // k]
        if not rows or rows[0][0] != cmp // k:
            raise RuntimeError(f"block {cmp // k}'s outputs were not kept")
        outs = {f: np.concatenate([h[f][c, j * k:(j + 1) * k]
                                   for _, h, j in rows])[cmp % k:]
                for f in rows[0][1]}
        return c, block, first, cmp, outs

    def on_group(host: dict, first: int, n: int) -> None:
        now = time.perf_counter()
        if st["keep"]:
            for b in range(first, first + n):
                st["homes"][b] = now
            st["last_home"] = now
            st["group_at"].append(now)
            if now >= st["deadline"]:
                sc.stop()
        if not checker:
            return
        for j in range(n):
            b = first + j
            recent.append((b, host, j))
            if st["keep"]:
                for r, res in enumerate(samples):
                    for c in range(r * per, (r + 1) * per):
                        res.offer(lambda slot, c=c: kept(c, b))
                st["last"] = b

    # every dispatch of the window: a multi_step, or a step at one block a
    # dispatch (the source never ends, so no short group runs)
    name = "multi_step" if n_fuse > 1 else "step"
    inner = getattr(chain, name)

    def timed_step(*args):
        stretch = st["stretch"]
        t0 = time.perf_counter()
        if stretch is not None:
            stretch.at_dispatch(t0)
        with record_function("bench:dispatch"):
            out = inner(*args)
        if st["keep"]:
            st["dispatched"] += n_fuse
            if stretch is not None and stretch.on:
                st["trace_blocks"] += n_fuse * per
            elif stretch is None or stretch.began is None:
                st["step_s"] += time.perf_counter() - t0
                st["span_blocks"] += n_fuse * per
        return out

    setattr(chain, name, timed_step)
    drain = sc._drain

    def spanned_drain(*args):
        with record_function("bench:drain"):
            return drain(*args)

    sc._drain = spanned_drain

    def source(first: int, takes: list):
        for i in itertools.count(first):
            takes.append(time.perf_counter())
            yield pool[i % pool_blocks], n_blk

    warm = mix["warm_groups"] * n_fuse
    sc.run(itertools.islice(source(0, []), warm), on_group)
    stages.mark("the warm-up (the first builds the kernels)")
    stages.log()
    mem.append(("the warm-up", resident()))
    t0 = start()
    use0, stats0 = resource.getrusage(resource.RUSAGE_SELF), dict(
        distributed.STATS)
    epoch_off = time.time_ns() - time.perf_counter_ns()
    if trace:
        profiling.enable()
    takes: list = []
    st["deadline"] = t0 + seconds
    at = t0 + mix["trace_at"] * seconds
    stretch = st["stretch"] = (
        Stretch(Tracer(dev), at, at + mix["trace_s"]) if trace and cuda
        else None)
    st["keep"] = True
    sc.run(source(warm, takes), on_group)
    use1 = resource.getrusage(resource.RUSAGE_SELF)
    mem.append(("the window", resident()))
    if stretch is not None:
        stretch.finish()
    if trace:
        profiling.disable()
    distributed.sync("bench_window_end")
    memory = torch.cuda.max_memory_allocated(dev) if cuda else 0
    homes = st["homes"]
    n = len(homes)
    first_take, last_home = takes[0], st["last_home"]
    lat = [homes[warm + i] - takes[i] for i in range(n)]
    span_end = (stretch.began if stretch is not None and stretch.began
                else last_home)
    counters = {}
    out_trace = None
    if trace:
        program = SP.program_spans(profiling.snapshot())
        hi = int(span_end * 1e9) + epoch_off
        lo = int(t0 * 1e9) + epoch_off
        counters = {"gather_s": SP.self_ms(program, GATHER, lo, hi) / 1e3,
                    "fetch_s": SP.self_ms(program, FETCH, lo, hi) / 1e3}
        blocks = max(1, st["span_blocks"])
        own = {m: SP.self_ms(program, (m,), lo, hi) / blocks
               for m in sorted({p[0] for p in program})}
        print(f"rank {rank}: self ms a stream-block over the untraced part "
              f"({(span_end - first_take) * 1e3 / blocks:.4f} of wall): "
              + ", ".join(f"{m} {v:.4f}" for m, v in own.items()),
              file=sys.stderr, flush=True)
        # on the CPU no device is traced: no device event
        events = stretch.tracer.events if stretch is not None else []
        if stretch is None or stretch.began is not None:
            out_trace = SP.reduce(events, "BatchScanner.run outside its "
                                  "dispatch and drain (the ring's copy and "
                                  "upload)", program)
    checks = []
    if checker:
        items = [it for res in samples for it in res.items]
        done = {(c, b) for c, b, *_ in items}
        last = [c for c in range(n_caps) if (c, st["last"]) not in done]
        items.append(kept(last[int(rng.integers(len(last)))], st["last"]))
        checks = [_checked(it, plans, band, seed, k, pool_blocks, n_blk,
                           dev) for it in items]
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    gaps = np.diff([first_take] + st["group_at"]) * 1e3
    slow = np.argsort(gaps)[::-1][:3]
    print(f"rank {rank}: {n} blocks home of {st['dispatched']} dispatched "
          f"in the window, peak resident memory {rss} bytes; ms between "
          f"groups home: median {np.median(gaps):.1f}, the longest "
          + ", ".join(f"{gaps[i]:.1f} (group {i})" for i in slow),
          file=sys.stderr, flush=True)
    print(f"rank {rank}: {torch.get_num_threads()} intra-op threads; "
          f"resident bytes after "
          + ", ".join(f"{what} {b}" for what, b in mem)
          + f"; over the window CPU s user "
          f"{use1.ru_utime - use0.ru_utime:.2f} system "
          f"{use1.ru_stime - use0.ru_stime:.2f}, gloo staging s "
          f"{distributed.STATS['stage_s'] - stats0['stage_s']:.3f} "
          f"collective s "
          f"{distributed.STATS['collective_s'] - stats0['collective_s']:.3f}",
          file=sys.stderr, flush=True)
    out = W.Window(
        setup_s=t0 - t_start, wall_s=last_home - first_take,
        samples=n * per * n_blk, stream_blocks=st["dispatched"] * per,
        # a block's latency once for each of its captures, in block order:
        # the untraced part's first (block_latency_p95_ms)
        latencies_s=[x for x in lat for _ in range(per)],
        step_s=st["step_s"], span_wall_s=span_end - first_take,
        span_blocks=st["span_blocks"], memory_peak_bytes=memory,
        checked=checks, incomplete=(st["dispatched"] - n) * per,
        first_take_at=first_take, last_home_at=last_home, counters=counters)
    if out_trace is not None:
        out.trace = out_trace
        out.trace_window_s = (stretch.tracer.window_s if stretch is not None
                              else 0.0)
        out.trace_blocks = st["trace_blocks"]
    del sc, recent, st
    if cuda:
        torch.cuda.empty_cache()
    return out


def _checked(item: tuple, plans: dict, band: dict, seed: int, k: int,
             pool_blocks: int, n_blk: int, dev) -> W.Checked:
    """A kept capture-block with the cu8 bytes of the sub-chunks its check
    covers, made again from (seed, capture, block)."""
    c, block, first, cmp, outs = item
    end = (block + 1) * k
    b0, b1 = first // k, (end - 1) // k
    index = T.by_block(plans[c], n_blk)
    flat = np.concatenate([
        T.make_block(band, plans[c], index[j % pool_blocks], seed, c,
                     j % pool_blocks, n_blk, dev).cpu().numpy()
        for j in range(b0, b1 + 1)])
    sub = 2 * n_blk // k
    wire = flat[(first - b0 * k) * sub:(end - b0 * k) * sub]
    return W.Checked(c, block, outs, wire, cmp - first)
