"""Entry: one long capture through ``ScannerDriver.run``.

The path ``apps/sdr_pmr446.py`` takes on a capture file: the driver's
pinned ring (``device_prefetch``), ``steps_per_dispatch`` blocks a
``multi_step`` (a CUDA graph), its drain of every sub-chunk one behind the
dispatch, and its ``on_subchunk`` callback, which the harness uses to stamp
when a block's last sub-chunk is home and to keep the outputs of the
sampled blocks and of the blocks before them back to a quiet gap.  The
harness names the driver's ``_drain`` calls in the trace (``bench:drain``).
The timed window is one ``run()`` call; its source offers the capture's
blocks in order, from its start again after its end, and stops at the
first dispatch boundary past the window's end, so no tail block runs
alone.  The harness times the
chain's dispatch by wrapping the driver's chain's ``multi_step`` (``step``
at one block a dispatch).
"""

from __future__ import annotations

import collections
import time

import numpy as np
import torch
from torch.profiler import record_function

from benchlib import spec
from benchlib import traffic as T
from benchlib import window as W
from benchlib.trace import Stretch, Tracer, reduce


def run(cfg: dict, mix: dict, seed: int, seconds: float, trace: bool,
        device, t_start: float) -> W.Window:
    from sdr_pmr446_tpu_torch import config as C
    from sdr_pmr446_tpu_torch.runtime.driver import ScannerDriver

    stages = W.Stages(t_start)
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.init()
    stages.mark("imports and the CUDA context")
    n_fuse, k = mix["steps_per_dispatch"], cfg["subchunks_per_step"]
    if mix["captures"] != 1:
        raise ValueError("the driver scans one capture")
    pool, (plan,) = T.make_pool(mix["band"], seed, 1, mix["pool_blocks"], k,
                                dev)
    flat = pool.reshape(-1)
    period = mix["pool_blocks"] * k
    quiet = plan.quiet_subchunks()
    warm_sub = spec.module("references", cfg["reference"]).WARM_SUBCHUNKS
    stages.mark("the traffic pool")
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    rng = np.random.default_rng(np.random.SeedSequence([seed, 7]))
    sample = W.Reservoir(mix["check_blocks"] - 1, rng)
    st = {"cur": [], "last": None, "keep": False, "homes": {},
          "step_s": 0.0, "span_steps": 0, "trace_steps": 0, "stretch": None}
    recent: collections.deque = collections.deque(
        maxlen=W.max_back(quiet, period, k))

    def kept(block: int) -> tuple:
        """What a check of block ``block`` needs: its span and the blocks of
        ``recent`` it reaches back to (references; copied after the
        window)."""
        first, cmp = W.span(block, k, quiet, period, warm_sub)
        blocks = [(b, cur) for b, cur in recent if b >= cmp // k]
        if blocks[0][0] != cmp // k:
            raise RuntimeError(f"block {cmp // k}'s outputs were not kept")
        return block, first, cmp, blocks

    def checked(block: int, first: int, cmp: int, blocks: list) -> W.Checked:
        subs = [o for _, cur in blocks for o in cur]
        return W.Checked(0, block, stacked(subs[cmp % k:]),
                         W.wire_span(flat, first, (block + 1) * k,
                                     2 * C.SUBCHUNK_IN), cmp - first)

    def on_subchunk(sub: int, o: dict) -> None:
        st["cur"].append(o)
        if (sub + 1) % k:
            return
        block, cur = sub // k, st["cur"]
        st["cur"] = []
        recent.append((block, cur))
        if st["keep"]:
            st["homes"][block] = time.perf_counter()
            sample.offer(lambda slot: kept(block))
            st["last"] = block

    driver = ScannerDriver(
        C.ScannerArgs(audio_gain=cfg["audio_gain"],
                      squelch_level=cfg["squelch_db"],
                      lowpass=cfg["lowpass"], lock_mode=cfg["lock_mode"]),
        subchunks_per_step=k, input_format=cfg["wire"], device=dev,
        on_subchunk=on_subchunk, steps_per_dispatch=n_fuse,
        prefetch_depth=cfg["prefetch_depth"])
    stages.mark("the driver and its chain")
    name = "multi_step" if n_fuse > 1 else "step"
    inner = getattr(driver.chain, name)

    def timed_step(*args):
        stretch = st["stretch"]
        t0 = time.perf_counter()
        if stretch is not None:
            stretch.at_dispatch(t0)
        with record_function("bench:dispatch"):
            out = inner(*args)
        if stretch is not None and stretch.on:
            st["trace_steps"] += n_fuse
        elif st["keep"] and (stretch is None or stretch.began is None):
            st["step_s"] += time.perf_counter() - t0
            st["span_steps"] += n_fuse
        return out

    setattr(driver.chain, name, timed_step)
    drain = driver._drain

    def spanned_drain(*args):
        with record_function("bench:drain"):
            return drain(*args)

    driver._drain = spanned_drain

    def source(first: int, stop, takes: list):
        i = first
        while not ((i - first) % n_fuse == 0 and stop(i)):
            takes.append(time.perf_counter())
            yield pool[i % mix["pool_blocks"], 0]
            i += 1

    warm = mix["warm_groups"] * n_fuse
    driver.run(source(0, lambda i: i >= warm, []))
    t_w = stages.mark("the warm-up (the first builds the kernels)")
    stages.log()
    takes: list = []
    deadline = t_w + seconds
    at = t_w + mix["trace_at"] * seconds
    stretch = st["stretch"] = (Stretch(Tracer(dev), at, at + mix["trace_s"])
                               if trace else None)
    st["keep"] = True
    result = driver.run(source(warm, lambda i: time.perf_counter()
                               >= deadline, takes))
    if cuda:
        torch.cuda.synchronize(dev)
    if stretch is not None:
        stretch.finish()
    t_end = time.perf_counter()
    memory = torch.cuda.max_memory_allocated(dev) if cuda else 0
    n = len(takes)
    homes = st["homes"]
    lat = [homes[warm + i] - takes[i] for i in range(n) if warm + i in homes]
    checks = [checked(*c) for c in sample.items + [kept(st["last"])]]
    span_end = (stretch.began if stretch is not None and stretch.began
                else t_end)
    out = W.Window(
        setup_s=t_w - t_start, wall_s=t_end - takes[0],
        samples=n * k * C.SUBCHUNK_IN, stream_blocks=n, latencies_s=lat,
        step_s=st["step_s"], span_wall_s=span_end - takes[0],
        span_blocks=st["span_steps"], memory_peak_bytes=memory,
        checked=checks, incomplete=n - len(lat))
    if stretch is not None and stretch.tracer.events:
        out.trace = reduce(stretch.tracer.events, "driver.run outside its "
                           "dispatch and drain (the ring's copy and upload)")
        out.trace_window_s = stretch.tracer.window_s
        out.trace_blocks = st["trace_steps"]
    del driver, result, st
    if cuda:
        torch.cuda.empty_cache()
    return out


def stacked(subchunks: list) -> dict:
    """A block's per-sub-chunk output dicts as field -> [K, ...]."""
    return {f: np.stack([np.asarray(o[f]) for o in subchunks])
            for f in subchunks[0]}
