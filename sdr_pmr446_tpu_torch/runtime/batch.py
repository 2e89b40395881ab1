"""Many captures scanned at once: the loop of apps/scan_batch.py.

``BatchScanner`` is the counterpart of runtime/driver.py's ``ScannerDriver``
for the sharded scanner (parallel/scanner_sharded.py) over many captures,
on a one-card (stream x time) mesh or over several processes
(parallel/distributed.py's ``GlobalMesh``).  ``run(source, on_group)``
takes a source of blocks, ``(wire uint8 [S_loc, bytes], got)`` as
apps/scan_batch.py's readers return them (``got``: the most samples a
capture of the block holds; 0 ends the source, and a short block is its
last), and:

  - uploads the blocks through the pinned ring (``device_prefetch``,
    ``PREFETCH_DEPTH`` blocks ahead);
  - groups them ``steps_per_dispatch`` at a time into the chain's
    ``multi_step`` (a CUDA graph of that many steps on the card); a short
    last group runs block by block (``step``), so it captures no graph of
    its own;
  - reads group i back after group i + 1 is dispatched (``HostFetch``: on a
    copy stream that waits for group i alone);
  - over several processes gathers each group's outputs to every process
    (``distributed.process_allgather``, the sub-chunks on axis 1);
  - on the writer accumulates every capture's audio, event lines and, with
    the waterfall, its rows (``audio``, ``events``, ``wf_lines``);
    ``on_group(host, first_block, n_blocks)``, when given, is called on
    every process with the group's outputs, field -> [S, n_blocks * K, ...]
    numpy of every capture;
  - checks the stop flag after every group; over several processes the
    processes agree on it (``distributed.agree``: a stop on any of them),
    so that every process stops after the same group.  There a stop does
    not end the reading: the source has to go on until the processes agree.

``stop()`` sets the flag (a signal handler's call); so does the
``stop_after``-th group of a ``run``.  A stopped run's blocks read but never
dispatched are not counted in ``total_got``.

Checkpoints (``save(blocks_done, host state)``, when given): every
``checkpoint_every`` full groups of a run, with a copy of the group's state
taken on the device right after its dispatch and read back with its
outputs once the group is drained, so a checkpoint never drains a group
early; and a final one when a stop ends the run, unless the last group's
was saved.  The accumulators stay the caller's to write (``subchunk``,
``total_got``, ``blocks_done`` and the three lists); a resumed caller sets
them, and ``state``, before ``run``.

Spans and counters (utils/profiling.py; spans only while the recorder is
on, each with the first block of its group): ``batch.dispatch`` (the chain
call), ``batch.fetch`` (HostFetch's wait for the group's event and its
copies to the host), ``batch.gather`` (the cross-process gather, over
distributed.py's ``gather.stage`` and ``gather.collective``),
``batch.outputs`` (the writer's loop and ``on_group``), ``batch.agree``
(the agreed stop, several processes only) and ``batch.checkpoint`` (a save,
with its read-back); ``device_prefetch``'s ``prefetch.*``.  Counters:
``batch.groups`` (dispatches: a short last group's blocks one each) and
``batch.blocks``.
"""

from __future__ import annotations

import collections
import time
from typing import Callable, Iterable, Optional

import torch

from sdr_pmr446_tpu_torch.parallel import distributed
from sdr_pmr446_tpu_torch.runtime.driver import device_prefetch
from sdr_pmr446_tpu_torch.ui import waterfall as wf_ui
from sdr_pmr446_tpu_torch.utils.profiling import count, span

#: pinned host buffers the uploads run ahead by (the driver's default)
PREFETCH_DEPTH = 2


class HostFetch:
    """Reads tensors back once the work that made them is done: on a CUDA
    device by a copy stream that waits for an event recorded after that
    work, so a later dispatch keeps the device busy; on the CPU at once."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.stream = torch.cuda.Stream(device) if self.cuda else None

    def mark(self):
        """An event after the work queued so far (None on the CPU)."""
        if not self.cuda:
            return None
        ev = torch.cuda.Event()
        ev.record()
        return ev

    def __call__(self, tensors, event) -> list:
        if not self.cuda:
            return [t.numpy() for t in tensors]
        with torch.cuda.stream(self.stream):
            self.stream.wait_event(event)
            host = [t.to("cpu", non_blocking=True) for t in tensors]
            done = torch.cuda.Event()
            done.record(self.stream)
        done.synchronize()
        return [h.numpy() for h in host]


def event_lines(host: dict, s: int, i: int, sub: int) -> list:
    """JAX scan_batch's event lines of stream s, sub-chunk i."""
    out = []
    if host["ev_tuned"][s][i]:
        out.append(f"subchunk {sub}: Tuned to channel "
                   f"{host['active_chan'][s][i] + 1} "
                   f"(RSSI: {host['rel_rssi'][s][i]:4.2f}dB)")
    if host["ev_detuned"][s][i]:
        out.append(f"subchunk {sub}: Detuned from channel "
                   f"{host['ev_new_chan'][s][i] + 1}")
    if host["ev_ct_acquired"][s][i]:
        out.append(f"subchunk {sub}: Acquired CTCSS code: "
                   f"{host['ct_max_idx'][s][i] + 1} (frequency: "
                   f"{host['ct_freq'][s][i]:3.2f}Hz)")
    return out


class BatchScanner:
    """``chain`` (a ShardedScannerChain on its ``mesh``: a one-card
    ``Mesh`` or a ``distributed.GlobalMesh``), its ``params`` and
    ``state``; ``steps_per_dispatch`` blocks a dispatch; ``writer``: this
    process accumulates every capture's outputs; ``waterfall``: with their
    waterfall rows; ``save``, ``checkpoint_every`` and ``stop_after`` as in
    the module docstring."""

    def __init__(self, chain, params, state, steps_per_dispatch: int = 1,
                 writer: bool = True, waterfall: bool = False,
                 save: Optional[Callable] = None, checkpoint_every: int = 0,
                 stop_after: int = 0):
        self.chain, self.params, self.state = chain, params, state
        self.mesh = chain.mesh
        self.multi = isinstance(self.mesh, distributed.GlobalMesh)
        self.n_fuse = max(1, int(steps_per_dispatch))
        self.writer = writer
        self.save = save
        self.checkpoint_every = checkpoint_every
        self.stop_after = stop_after
        self.n_streams = (self.mesh.global_stream if self.multi
                          else chain.n_stream)
        self.audio = [[] for _ in range(self.n_streams)]
        self.events = [[] for _ in range(self.n_streams)]
        self.wf_lines = ([[] for _ in range(self.n_streams)] if waterfall
                         else None)
        self.subchunk = 0         # sub-chunks drained
        self.total_got = 0        # samples a capture of the blocks dispatched
        self.blocks_done = 0      # blocks dispatched AND drained
        self.first_s = None       # a run's start to its first dispatch's end
        self.wall_s = 0.0         # the last run's
        self._saved_at = -1       # blocks_done of the last checkpoint
        self._stop = False
        self._dispatched = 0      # blocks dispatched
        self._last = 0            # the first block of the last dispatch
        self._fetch = HostFetch(chain.device)

    def stop(self) -> None:
        """Stop after the group in flight (signal-safe: it sets a flag)."""
        self._stop = True

    def _stopped(self) -> bool:
        """The stop flag; over several processes the processes agree on it
        (a stop on any of them), so that all stop after the same group."""
        if self.multi:
            with span("batch.agree", self._last):
                self._stop = distributed.agree(self._stop)
        return self._stop

    def run(self, source: Iterable, on_group: Optional[Callable] = None
            ) -> bool:
        """Scan ``source``'s blocks until it ends or a stop; returns
        whether a stop ended it (``halted``)."""
        block_len = self.chain.block.input_len
        gots: collections.deque = collections.deque()
        multi = self.multi

        def read_blocks():
            """The source's blocks until its end or a stop (over several
            processes, until its end: a stop ends the loop below where the
            processes agree on it); each block's real sample count goes to
            ``gots``."""
            blocks = iter(source)
            while multi or not self._stop:
                item = next(blocks, None)
                if item is None:
                    return
                blk, got = item
                if got == 0:
                    return
                gots.append(got)
                yield blk
                if got < block_len:
                    return

        t0 = time.perf_counter()
        self._dispatched = self.blocks_done
        pending = None
        groups = 0
        group, group_got = [], 0
        for wire in device_prefetch(read_blocks(), self.chain.device,
                                    PREFETCH_DEPTH, self.blocks_done):
            got = gots.popleft()
            self.total_got += got
            group_got += got
            group.append(wire.reshape(self.chain.n_stream, -1))
            if len(group) < self.n_fuse:
                continue
            groups += 1
            if self.stop_after and groups >= self.stop_after:
                self._stop = True
            every = self.checkpoint_every
            ck = bool(self.save is not None and every > 0
                      and groups % every == 0)
            out = self._dispatch(group, ck, t0)
            group, group_got = [], 0
            if pending is not None:
                self._drain(pending, on_group)
            pending = out
            if self._stopped():
                break
        # a short last group runs block by block (no graph of its own)
        for wire in (() if self._stopped() else group):
            out = self._dispatch([wire], False, t0)
            if pending is not None:
                self._drain(pending, on_group)
            pending = out
        halted = self._stopped()
        if not halted:
            group_got = 0
        if pending is not None:
            self._drain(pending, on_group)
        self.wall_s = time.perf_counter() - t0
        if halted:
            self.total_got -= group_got       # read, never dispatched
            if self.save is not None and self._saved_at != self.blocks_done:
                self._checkpoint([v.cpu().numpy() for v in self.state])
        return halted

    def _dispatch(self, wires: list, snapshot: bool, t0: float):
        first = self._last = self._dispatched
        with span("batch.dispatch", first):
            if len(wires) == 1:
                self.state, out = self.chain.step(self.state, wires[0],
                                                  self.params)
            else:
                self.state, out = self.chain.multi_step(
                    self.state, torch.stack(wires), self.params)
            # the checkpoint's state, read back with the outputs once this
            # group is done: a returned state is never written again (step
            # writes nothing in place, a replay returns fresh copies)
            snap = list(self.state) if snapshot else None
            if self.first_s is None:
                self.first_s = time.perf_counter() - t0
            event = self._fetch.mark()
        count("batch.groups")
        count("batch.blocks", len(wires))
        self._dispatched += len(wires)
        return out, len(wires), event, snap, first

    def _drain(self, pending, on_group) -> None:
        out, n_blocks, event, snap, first = pending
        with span("batch.fetch", first):
            host = self._fetch(list(out), event)
        if self.multi:
            with span("batch.gather", first):
                # every process's sub-chunks of its streams, to every one
                host = [t.numpy() for t in distributed.process_allgather(
                    [torch.from_numpy(v) for v in host], self.mesh,
                    time_axis=1)]
        host = dict(zip(out._fields, host))
        k = host["active_chan"].shape[1]
        with span("batch.outputs", first):
            for s in range(self.n_streams if self.writer else 0):
                for i in range(k):
                    sub = self.subchunk + i
                    if host["audio_valid"][s][i]:
                        self.audio[s].append(host["audio"][s][i])
                    self.events[s].extend(event_lines(host, s, i, sub))
                    if self.wf_lines is not None:
                        self.wf_lines[s].append(wf_ui.render_waterfall_line(
                            host["waterfall"][s][i],
                            float(host["rel_rssi"][s][i])))
            if on_group is not None:
                on_group(host, first, n_blocks)
        self.subchunk += k
        self.blocks_done += n_blocks
        if snap is not None:
            with span("batch.checkpoint", first):
                self._checkpoint(self._fetch(snap, event))

    def _checkpoint(self, host_state: list) -> None:
        self._saved_at = self.blocks_done
        self.save(self.blocks_done, host_state)
