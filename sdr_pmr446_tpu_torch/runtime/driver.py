"""Host-side streaming driver: wire blocks in, audio and events out.

Counterpart of sdr_pmr446_tpu/runtime/driver.py (ScannerDriver.run /
_drain / _event_lines): feeds fixed-size blocks of raw capture bytes to the
scanner step, drains the per-sub-chunk outputs, renders the reference-format
log lines for tune/detune/change/CTCSS events (src/sdr_pmr446.c:838-862,
614-626), accumulates the active channel's audio and, with the waterfall
on, its rows.  While the waterfall is on the event lines are returned but
not logged (the terminal shows the waterfall instead), and ``on_subchunk``
is called with each sub-chunk's outputs, as in the JAX driver.

As in the JAX driver (driver.py:139-177, 189-306):

  - ``metrics_path``: one JSONL record a sub-chunk (utils/profiling.py
    ``log_jsonl``) with the JAX keys ``subchunk``, ``active_chan``,
    ``rel_rssi``, ``rssi_db`` (16 values to 0.01 dB), ``ctcss_detected``,
    ``ctcss_code`` and ``events`` (the sub-chunk's log lines);
  - ``checkpoint_path`` / ``checkpoint_every``: (block index, state) saved
    every ``checkpoint_every`` blocks (0: only ``checkpoint_now()`` and the
    final flush on a stop write it); ``restore()`` loads it, reconciles its
    history lengths (``adapt_state_histories``), refuses a layout the chain
    cannot take, and makes the next ``run()`` skip the blocks already
    processed (one-shot);
  - ``checkpoint_backend``: ``"npz"`` (the default: runtime/state.py
    ``save_state``, one file in the npz format both packages read) or
    ``"orbax"`` (JAX's name for its directory backend: ``save_state_orbax``,
    a torch.distributed.checkpoint directory, which JAX's orbax does not
    read, nor the port JAX's);
  - ``engine``: the chain's engine (engine.py; JAX's ``engine`` flag, the
    op engine its ``xla``), whose state layout ``restore()`` holds a
    checkpoint to;
  - ``request_stop()`` (a signal handler's call) makes ``run()`` finish the
    step in flight, drain it, write a final checkpoint and return the
    partial result at the next block boundary.

The step is asynchronous on a CUDA device, so block i+1 is dispatched
before block i's outputs are drained.  Block i's outputs are copied to
pinned host memory by copies queued right after its own dispatch
(``ReadBack``), so the drain waits for dispatch i alone while dispatch
i+1 runs: the host-side drain overlaps the device's work.  As in the JAX
driver (driver.py:41-60, 118-126, 195-250):

  - ``steps_per_dispatch`` S: S blocks a dispatch (``chain.multi_step``, a
    CUDA graph of S steps on the card, runtime/fuse.py), equal to S single
    steps bit for bit; tail blocks that do not fill a megastep run as
    single steps (and are skipped after a stop request), ``block_index``
    advances by S, checkpoints land on megastep boundaries, and the resume
    skip counts blocks;
  - ``prefetch_depth``: the wire bytes go up through a ring of that many
    pinned host buffers, each upload non-blocking on a copy stream that
    runs up to ``prefetch_depth`` blocks ahead of the step that reads it
    (``device_prefetch``); the values are the same.

Spans and counters (utils/profiling.py; spans only while the recorder is
on, each with the first stream-block it concerns): ``prefetch.*`` in
``device_prefetch``; ``dispatch.stack`` (a megastep's blocks stacked),
``driver.dispatch`` (the ``chain.multi_step`` call, over runtime/fuse.py's
``megastep.*``) or ``step.eager`` (a ``chain.step`` call: S = 1, tail
blocks); on a CUDA device ``drain.enqueue`` (a dispatch's read-back
queued, right after it); in ``_drain`` ``drain.wait`` (the host waiting
for its own dispatch's read-back), ``drain.fetch`` (the outputs out of
the staging buffer; on the CPU, read) and ``drain.subchunks`` (the
per-sub-chunk loop; the time in ``on_subchunk`` summed into one child
``drain.on_subchunk``); ``driver.checkpoint`` (a save).  Counters:
``driver.blocks``, ``driver.dispatches``, ``driver.eager_steps``,
``drain.subchunks``, ``drain.audio_subchunks``, ``drain.events``,
``drain.waits_blocked``.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import logging
import time
from typing import Callable, Iterable, Iterator, List, Optional

import numpy as np
import torch

from sdr_pmr446_tpu_torch import config as C
from sdr_pmr446_tpu_torch.runtime import state as state_io
from sdr_pmr446_tpu_torch.scanner.chain import (ScannerChain,
                                                make_runtime_params,
                                                outputs_to_numpy)
from sdr_pmr446_tpu_torch.utils import profiling
from sdr_pmr446_tpu_torch.utils.profiling import count, log_jsonl, span

log = logging.getLogger("sdr_pmr446")


def device_prefetch(blocks: Iterable[np.ndarray], device: torch.device,
                    depth: int, first_block: int = 0
                    ) -> Iterator[torch.Tensor]:
    """Each block's bytes as a uint8 tensor on ``device``, uploaded up to
    ``depth`` blocks ahead of the one yielded (JAX ``_device_prefetch``).

    On a CUDA device a block goes through one of ``depth`` pinned host
    buffers, by a non-blocking copy on a side stream; a buffer is not
    rewritten before its last copy's event has completed, the current
    stream waits on a block's event before the block is yielded, and the
    block's memory is not reused before that stream is done with it.  On
    the CPU the blocks are yielded as they come.

    Spans (``first_block`` numbers the first block): ``prefetch.source``,
    the caller's ``next()``; on a CUDA device ``prefetch.slot_wait`` (the
    wait for a slot's last copy: counted in ``prefetch.slot_waits_blocked``
    when it had not finished), ``prefetch.host_copy`` (into the pinned
    buffer; its first allocation ``prefetch.pin``) and ``prefetch.upload``
    (the device buffer, the copy and its event); ``prefetch.bytes`` counts
    the bytes."""
    blocks = iter(blocks)
    if device.type != "cuda":
        for b in itertools.count(first_block):
            with span("prefetch.source", b):
                blk = next(blocks, _END)
            if blk is _END:
                return
            yield torch.from_numpy(np.ascontiguousarray(blk).view(
                np.uint8).reshape(-1))
    depth = max(1, int(depth))
    copy_stream = torch.cuda.Stream(device)
    compute = torch.cuda.current_stream(device)
    ring: list = [None] * depth          # (pinned buffer, its copy's event)
    queue: collections.deque = collections.deque()

    def ready(item):
        wire, event = item
        compute.wait_event(event)
        wire.record_stream(compute)
        return wire

    for i in itertools.count():
        b = first_block + i
        with span("prefetch.source", b):
            blk = next(blocks, _END)
        if blk is _END:
            break
        slot = i % depth
        if ring[slot] is not None:
            with span("prefetch.slot_wait", b):
                last = ring[slot][1]
                if not last.query():
                    count("prefetch.slot_waits_blocked")
                    last.synchronize()
        with span("prefetch.host_copy", b):
            raw = np.ascontiguousarray(blk).view(np.uint8).reshape(-1)
            if ring[slot] is None or ring[slot][0].numel() != raw.size:
                with span("prefetch.pin", b):
                    ring[slot] = (torch.empty(raw.size, dtype=torch.uint8,
                                              pin_memory=True), None)
            pinned = ring[slot][0]
            pinned.numpy()[:] = raw
        count("prefetch.bytes", raw.size)
        with span("prefetch.upload", b), torch.cuda.stream(copy_stream):
            wire = torch.empty(raw.size, dtype=torch.uint8, device=device)
            wire.copy_(pinned, non_blocking=True)
            event = torch.cuda.Event()
            event.record(copy_stream)
        ring[slot] = (pinned, event)
        queue.append((wire, event))
        if len(queue) >= depth:
            yield ready(queue.popleft())
    while queue:
        yield ready(queue.popleft())


#: the end of a source of blocks (``device_prefetch``)
_END = object()


class ReadBack:
    """A dispatch's outputs on their way to the host, for the drain.

    On a CUDA device ``start``, called right after the dispatch and before
    the next, queues the outputs' copies into pinned host memory on the
    current stream, behind that dispatch and ahead of the next, and records
    an event after them; ``wait`` waits for that event, so for that
    dispatch and its copies alone (counted in ``drain.waits_blocked`` when
    it had not completed); ``fetch`` copies them out into host memory that
    the caller then owns, as numpy arrays by field.  The staging buffers,
    one flat pinned buffer a dispatch in flight, take turns: the driver
    holds at most ``SLOTS`` read-backs (the one it drains and the one just
    dispatched), and a buffer grows to the largest dispatch it has held, so
    the pinned memory is bounded whatever the capture's length.  On the CPU
    ``start`` hands the outputs on, ``wait`` does nothing and ``fetch``
    reads them (``outputs_to_numpy``)."""

    SLOTS = 2
    #: a field's offset in a staging buffer, in bytes
    ALIGN = 16

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        self.slots: list = [None] * self.SLOTS
        self.turn = 0

    def _staging(self, nbytes: int) -> torch.Tensor:
        return torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)

    def start(self, out, block: int):
        """Queue the copies of ``out`` (a StepOutputs just dispatched);
        returns what ``wait`` and ``fetch`` take."""
        if not self.cuda:
            return out
        with span("drain.enqueue", block):
            layout, total = [], 0
            for f, v in zip(out._fields, out):
                nbytes = v.numel() * v.element_size()
                layout.append((f, total, nbytes, v.dtype, v.shape))
                total += -(-nbytes // self.ALIGN) * self.ALIGN
            slot = self.turn % self.SLOTS
            self.turn += 1
            buf = self.slots[slot]
            if buf is None or buf.numel() < total:
                buf = self.slots[slot] = self._staging(total)
            for (_, at, nbytes, dtype, shape), v in zip(layout, out):
                if nbytes:
                    buf[at:at + nbytes].view(dtype).view(shape).copy_(
                        v, non_blocking=True)
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
        return buf, total, layout, done

    def wait(self, pending) -> None:
        if self.cuda:
            done = pending[-1]
            if not done.query():
                count("drain.waits_blocked")
                done.synchronize()

    def fetch(self, pending) -> dict:
        if not self.cuda:
            return outputs_to_numpy(pending)
        buf, total, layout, _ = pending
        host = torch.from_numpy(buf[:total].numpy().copy())
        return {f: host[at:at + nbytes].view(dtype).view(shape).numpy()
                for f, at, nbytes, dtype, shape in layout}


@dataclasses.dataclass
class ScanResult:
    audio: np.ndarray            # concatenated active-channel audio @12.5 kHz
    audio_subchunks: np.ndarray  # sub-chunk index of each audio block
    active_trace: np.ndarray     # [n_subchunks] active channel per sub-chunk
    rssi_trace: np.ndarray       # [n_subchunks, 16]
    rel_rssi: np.ndarray         # [n_subchunks]
    ct_detected: np.ndarray      # [n_subchunks]
    ct_max_idx: np.ndarray       # [n_subchunks]
    events: List[str]            # formatted log lines
    waterfall: Optional[np.ndarray]  # [n_subchunks, W] dB rows or None


class ScannerDriver:
    """``device`` chooses where the chain runs: a CUDA device runs the
    hand-written kernels, the CPU their plain versions (device.resolve).
    ``engine`` chooses the kernel engine (the default) or the op engine
    (engine.py); on the kernel engine ``fuse_band``, ``fuse_dc``,
    ``fuse_rssi``, ``fuse_lp_dc`` and ``fuse_ctcss`` choose its form
    (scanner/chain.py); ``steps_per_dispatch`` and ``prefetch_depth`` as in
    JAX (module docstring)."""

    def __init__(self, args: Optional[C.ScannerArgs] = None,
                 subchunks_per_step: int = 10, input_format: str = "cu8",
                 device="cuda", on_subchunk: Optional[Callable] = None,
                 fuse_band: bool = True, fuse_dc: bool = True,
                 fuse_rssi: bool = True, fuse_lp_dc: bool = True,
                 fuse_ctcss: bool = True,
                 metrics_path: Optional[str] = None,
                 checkpoint_path: Optional[str] = None,
                 checkpoint_every: int = 0, steps_per_dispatch: int = 1,
                 prefetch_depth: int = 2, engine: str = "kernel",
                 checkpoint_backend: str = "npz"):
        if checkpoint_backend not in state_io.BACKENDS:
            raise ValueError(f"checkpoint_backend {checkpoint_backend!r}: "
                             f"one of {', '.join(state_io.BACKENDS)}")
        self.args = args or C.ScannerArgs()
        self.chain = ScannerChain(
            C.BlockConfig(subchunks_per_step), lowpass=self.args.lowpass,
            fir_deemph=self.args.fir_deemph, input_format=input_format,
            device=device, waterfall=self.args.waterfall,
            fuse_band=fuse_band, fuse_dc=fuse_dc, fuse_rssi=fuse_rssi,
            fuse_lp_dc=fuse_lp_dc, fuse_ctcss=fuse_ctcss, engine=engine)
        self.engine = self.chain.engine
        self.device = self.chain.device
        self.on_subchunk = on_subchunk
        self.params = make_runtime_params(self.args, self.device)
        self._read_back = ReadBack(self.device)
        self.state = self.chain.init_state()
        self.block_index = 0
        self.subchunk = 0
        self.metrics_path = metrics_path
        self.checkpoint_path = checkpoint_path
        self.checkpoint_every = checkpoint_every
        self.checkpoint_backend = checkpoint_backend
        self.steps_per_dispatch = max(1, int(steps_per_dispatch))
        self.prefetch_depth = max(1, int(prefetch_depth))
        self._resume_skip = 0            # armed by restore(), one-shot
        # the reference's exit_via_sig flag (src/sdr_pmr446.c:190-199)
        self._stop_requested = False
        self.stopped = False

    def request_stop(self) -> None:
        """Ask run() to stop at the next block boundary (signal-safe: it
        only sets a flag, like the reference's sighandler)."""
        self._stop_requested = True

    def checkpoint_now(self) -> None:
        """Save (block_index, state) now, whatever the cadence (the final
        flush of a stopped run); does nothing without a checkpoint_path."""
        if self.checkpoint_path:
            save, _ = state_io.BACKENDS[self.checkpoint_backend]
            with span("driver.checkpoint", self.block_index):
                save(self.checkpoint_path, self.block_index, self.state)

    def restore(self, path: Optional[str] = None) -> int:
        """Load a checkpoint (``path`` or checkpoint_path); the next run()
        skips the blocks of its input that it covers.  Returns the restored
        block index.  Raises ValueError for a state this chain cannot take
        (the other engine's layout: state.check_layout; a non-history
        shape mismatch), FileNotFoundError for a missing checkpoint."""
        _, load = state_io.BACKENDS[self.checkpoint_backend]
        block_index, loaded = load(path or self.checkpoint_path, self.device)
        state_io.check_layout(loaded, self.engine)
        self.state = state_io.adapt_state_histories(loaded,
                                                    self.chain.init_state())
        self.block_index = block_index
        self.subchunk = block_index * self.chain.block.subchunks_per_step
        self._resume_skip = block_index
        log.info("restored checkpoint at block %d (%d sub-chunks)",
                 self.block_index, self.subchunk)
        return self.block_index

    def _maybe_checkpoint(self) -> None:
        if self.checkpoint_every and \
                self.block_index % self.checkpoint_every == 0:
            self.checkpoint_now()

    @property
    def feed_len(self) -> int:
        """Wire bytes run() expects per block."""
        return self.chain.step_arg_len

    def run(self, blocks: Iterable[np.ndarray]) -> ScanResult:
        """Scan blocks of raw wire bytes (each ``feed_len`` bytes)."""
        acc = dict(audio=[], audio_sub=[], active=[], rssi=[], rel=[],
                   det=[], idx=[], events=[], wf=[])
        pending = None
        # one-shot: only the run() right after restore() skips the blocks
        # the checkpoint covers; a later run() consumes its whole input
        skip, self._resume_skip = self._resume_skip, 0
        n_fuse = self.steps_per_dispatch
        wires = device_prefetch(
            (blk for i, blk in enumerate(blocks) if i >= skip), self.device,
            self.prefetch_depth, self.block_index)
        group: List[torch.Tensor] = []   # blocks awaiting one megastep
        self.stopped = False
        try:
            for wire in wires:
                if n_fuse > 1:
                    group.append(wire)
                    if len(group) < n_fuse:
                        continue
                    with span("dispatch.stack", self.block_index):
                        xs = torch.stack(group)
                    with span("driver.dispatch", self.block_index):
                        self.state, out = self.chain.multi_step(
                            self.state, xs, self.params)
                    del xs           # the stack's memory back before the next
                    count("driver.dispatches")
                    count("driver.blocks", n_fuse)
                    group = []
                else:
                    out = self._step(wire)
                out = self._read_back.start(out, self.block_index)
                if pending is not None:
                    self._drain(pending, acc)
                pending = out
                self.block_index += n_fuse
                self._maybe_checkpoint()
                if self._stop_requested:
                    break
            # tail blocks that do not fill a megastep run as single steps
            # (skipped on a stop request: they resume from the checkpoint)
            for wire in (() if self._stop_requested else group):
                out = self._read_back.start(self._step(wire),
                                            self.block_index)
                if pending is not None:
                    self._drain(pending, acc)
                pending = out
                self.block_index += 1
                self._maybe_checkpoint()
            if pending is not None:
                self._drain(pending, acc)
        except KeyboardInterrupt:
            # an untrapped SIGINT mid-step or mid-drain: keep what was
            # drained; the pending block's outputs are dropped, since a
            # partial drain must not run twice
            self._stop_requested = True
        if self._stop_requested:
            self.stopped = True
            self._stop_requested = False
            # the final flush: a stopped run loses nothing since the last
            # cadence checkpoint (the reference's teardown,
            # src/sdr_pmr446.c:933-940)
            self.checkpoint_now()
        cat = lambda xs, shape, dt: (np.concatenate(xs) if xs
                                     else np.zeros(shape, dt))
        return ScanResult(
            audio=cat(acc["audio"], 0, np.float32),
            audio_subchunks=np.asarray(acc["audio_sub"], np.int64),
            active_trace=cat(acc["active"], 0, np.int32),
            rssi_trace=cat(acc["rssi"], (0, C.NUM_CHANNELS), np.float32),
            rel_rssi=cat(acc["rel"], 0, np.float32),
            ct_detected=cat(acc["det"], 0, bool),
            ct_max_idx=cat(acc["idx"], 0, np.int32),
            events=acc["events"],
            waterfall=np.concatenate(acc["wf"]) if acc["wf"] else None)

    def _step(self, wire):
        """One block as a single step, outside a graph; returns its
        outputs."""
        with span("step.eager", self.block_index):
            self.state, out = self.chain.step(self.state, wire, self.params)
        count("driver.dispatches")
        count("driver.blocks")
        count("driver.eager_steps")
        return out

    def _drain(self, out, acc) -> None:
        """Hand one dispatch's outputs (``out``, its ``ReadBack.start``) to
        the per-sub-chunk loop."""
        block = self.subchunk // self.chain.block.subchunks_per_step
        # the outputs' copies were queued right after their own dispatch,
        # ahead of the one dispatched since: the host waits for those
        # copies alone, while the card runs on
        with span("drain.wait", block):
            self._read_back.wait(out)
        with span("drain.fetch", block):
            o = self._read_back.fetch(out)
        with span("drain.subchunks", block):
            self._subchunks(o, acc)

    def _subchunks(self, o, acc) -> None:
        """The drain's per-sub-chunk loop over the host's outputs ``o``."""
        k = len(o["active_chan"])
        n_events = len(acc["events"])
        on_subchunk = self.on_subchunk
        if on_subchunk is not None and profiling.enabled():
            on_subchunk = profiling.Summed(on_subchunk)
        for i in range(k):
            sub = self.subchunk + i
            msgs = self._event_lines(o, i)
            for m in msgs:
                acc["events"].append(m)
                if self.args.waterfall <= 0:
                    log.info(m)
            if o["audio_valid"][i]:
                acc["audio"].append(o["audio"][i])
                acc["audio_sub"].append(sub)
            if self.metrics_path is not None:
                log_jsonl(self.metrics_path, {
                    "subchunk": sub,
                    "active_chan": int(o["active_chan"][i]),
                    "rel_rssi": float(o["rel_rssi"][i]),
                    "rssi_db": [round(float(v), 2) for v in o["rssi_db"][i]],
                    "ctcss_detected": bool(o["ct_detected"][i]),
                    "ctcss_code": int(o["ct_max_idx"][i]) + 1,
                    "events": msgs,
                })
            if on_subchunk is not None:
                on_subchunk(sub, {f: o[f][i] for f in o})
        acc["active"].append(o["active_chan"])
        acc["rssi"].append(o["rssi_db"])
        acc["rel"].append(o["rel_rssi"])
        acc["det"].append(o["ct_detected"])
        acc["idx"].append(o["ct_max_idx"])
        if self.args.waterfall > 0:
            acc["wf"].append(o["waterfall"])
        self.subchunk += k
        count("drain.subchunks", k)
        count("drain.audio_subchunks",
              int(np.count_nonzero(o["audio_valid"])))
        count("drain.events", len(acc["events"]) - n_events)
        if isinstance(on_subchunk, profiling.Summed):
            end = time.perf_counter_ns()
            profiling.record("drain.on_subchunk", end - on_subchunk.ns, end)

    @staticmethod
    def _event_lines(o, i) -> List[str]:
        """Reference-format log lines (src/sdr_pmr446.c:838-862,614-626)."""
        msgs = []
        if o["ev_changed"][i]:
            msgs.append(f"Changed active channel from "
                        f"{o['ev_prev_chan'][i] + 1} to "
                        f"{o['ev_new_chan'][i] + 1}")
        if o["ev_tuned"][i]:
            msgs.append(f"Tuned to channel {o['active_chan'][i] + 1} "
                        f"(RSSI: {o['rel_rssi'][i]:4.2f}dB)")
        if o["ev_detuned"][i]:
            msgs.append(f"Detuned from channel {o['ev_new_chan'][i] + 1}")
        if o["ev_ct_acquired"][i]:
            msgs.append(f"Acquired CTCSS code: {o['ct_max_idx'][i] + 1} "
                        f"(frequency: {o['ct_freq'][i]:3.2f}Hz)")
        if o["ev_ct_changed"][i]:
            msgs.append(f"CTCSS code change: {o['ct_max_idx'][i] + 1} "
                        f"(frequency: {o['ct_freq'][i]:3.2f}Hz)")
        if o["ev_ct_lost"][i]:
            msgs.append("Lost CTCSS code")
        return msgs


def wire_blocks(raw: np.ndarray, fmt: str, block_bytes: int):
    """Yield ``block_bytes`` blocks of raw wire bytes, the tail padded with
    the format's near-zero value (cu8 zero bytes would decode to -1-1j)."""
    from sdr_pmr446_tpu_torch.ops import decode
    raw = np.ascontiguousarray(raw).view(np.uint8).reshape(-1)
    n_full = len(raw) // block_bytes
    for i in range(n_full):
        yield raw[i * block_bytes:(i + 1) * block_bytes]
    rem = len(raw) - n_full * block_bytes
    if rem:
        elem = np.dtype(decode.WIRE_DTYPE[fmt]).itemsize
        fill = np.full(block_bytes // elem, decode.WIRE_FILL[fmt],
                       decode.WIRE_DTYPE[fmt]).view(np.uint8)
        fill[:rem] = raw[n_full * block_bytes:]
        yield fill
