"""scan_batch CLI on the PyTorch port — many IQ captures scanned at once.

Counterpart of sdr_pmr446_tpu/apps/scan_batch.py, the serving shape of
BASELINE.json config 5: S independent captures are scanned together by the
sharded scanner (parallel/scanner_sharded.py) on a one-card (stream x
time) mesh, and each capture gets its WAV, its event log and, with -w W,
its waterfall log.

    python -m sdr_pmr446_tpu_torch.apps.scan_batch cap1.cs16 cap2.cu8 ... \\
        --out-dir scans/ [-s 18] [-p max] [--mesh S,T] [-w 80]

Input: io/native.py's BatchReader gives [S, block] complex64 (mixed
formats converted on the host, by libsdrio.so's worker threads when it is
built, else NumPy), shipped as the port's cf32 wire, uint8 [S, block * 8].
With --device-decode all captures share one format and their raw bytes go
as that format's wire, decoded on the device.

Mesh: JAX's --mesh S,T counts stream shards (devices); here every stream is
one row of the one-card mesh, so --mesh S,T checks that the captures divide
over S and the sub-chunks over T, and builds ``make_mesh(captures, T)``;
no --mesh is (captures, 1).

Processes (JAX's semantics: several processes iff --coordinator is given):
--coordinator host:port --num-processes P --process-id r joins the gloo
process group (parallel/distributed.py; rank 0 listens at host:port), and
the P processes split JAX's (S x T) device mesh evenly, time fastest
(``distributed.rank_block``): each holds whole stream shards, or one stream
shard's captures x a run of its time shards, on its device (cuda:(r %
cards), or --device cpu).  A mesh that does not split so, or a process id
outside [0, P), exits 1, and so does --num-processes / --process-id
without --coordinator.  Every process reads only its captures (and, from
the raw --device-decode reader, only its time run of each block; the
host-conversion reader reads its captures' whole blocks and keeps its
run), every block's real sample count taken from the captures' sizes, the
same on every process.  The halos between processes go through
host-staged gloo collectives (a time split's steps then run as a loop, not
a CUDA graph: runtime/fuse.py).  The outputs are gathered to every process
and process 0 writes every file; the others log "process N done (process 0
writes the outputs)".  A checkpoint holds every stream's rows, gathered;
process 0 writes it and its accumulators, then every process syncs; on
--resume every process loads it and keeps its rows.  A stop (a signal on
any process, or --stop-after) ends every process after the same group.

Dispatch: --steps-per-dispatch blocks go through the chain's multi_step (a
CUDA graph of that many steps on the card), uploaded through a pinned
staging ring (runtime/driver.py::device_prefetch); group i is drained after
group i + 1 is dispatched, its outputs read back on a copy stream that
waits only for group i.  A short last group runs block by block, so it
captures no graph of its own.

Checkpoints: --checkpoint (npz: runtime/state.py's save_state of the [S,
...] state, plus an ``.accum.npz`` sidecar of the accumulators) every
--checkpoint-every dispatch groups, --resume, --stop-after N groups and
SIGTERM / SIGINT (stop after the group in flight, final checkpoint,
partial outputs).  A group's checkpoint is a copy of its state taken on the
device right after its dispatch, written with the accumulators when the
group is drained: checkpoints never drain a group early.  The resume guard
refuses another --subchunks-per-step, capture count, capture format,
--device-decode setting, --mesh or process count.  Not ported:
--checkpoint-backend orbax (a JAX library), which exits 2.  --device picks
the implementation (cuda: the
kernels, cpu: their plain versions); --engine the engine (kernel, the
default; op: the JAX op engine's plain ops and state layout, every
K_local), and --resume refuses a checkpoint of the other engine's layout.
"""

from __future__ import annotations

import argparse
import collections
import logging
import os
import signal
import sys
import time
import zipfile

import numpy as np
import torch

from sdr_pmr446_tpu_torch import config as C

log = logging.getLogger("scan_batch")

FORMATS = ("cf32", "cs16", "cu8", "cs8")
ALIASES = {"sc16": "cs16", "rtlsdr": "cu8", "fc32": "cf32"}
#: pinned host buffers the uploads run ahead by (the driver's default)
PREFETCH_DEPTH = 2


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="scan_batch",
        description="scan many IQ captures at once on a one-card mesh "
                    "(PyTorch + CUDA port)")
    p.add_argument("captures", nargs="+", help="IQ capture files")
    p.add_argument("--format", type=str, default=None,
                   help="force input format (cf32/cs16/cu8/cs8); default: "
                        "per-file extension")
    p.add_argument("--out-dir", type=str, default=".",
                   help="directory for per-capture audio WAVs + event logs")
    p.add_argument("-s", "--squelch", type=float,
                   default=C.SDR_DEFAULT_SQUELCH_LEVEL)
    p.add_argument("-a", "--audio-gain", type=float,
                   default=C.SDR_DEFAULT_AUDIO_GAIN)
    p.add_argument("-m", "--mask", type=str, default="")
    p.add_argument("-p", "--lock-mode", choices=["start", "max"],
                   default="start")
    p.add_argument("-l", "--lowpass", action="store_true")
    p.add_argument("-w", "--waterfall", type=int, default=0,
                   help="per-capture ASCII waterfall of this width, written "
                        "to <stem>.waterfall.log")
    p.add_argument("--mesh", type=str, default="",
                   help="mesh shape S,T: the captures divide over S, each "
                        "block's sub-chunks over T time shards (default: "
                        "captures,1)")
    p.add_argument("--coordinator", type=str, default="",
                   help="host:port of process 0: run as --num-processes "
                        "processes over gloo (the halos staged through the "
                        "host)")
    p.add_argument("--num-processes", type=int, default=1)
    p.add_argument("--process-id", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device: 'cuda' runs the CUDA kernels, 'cpu' "
                        "their plain PyTorch versions (default: cuda; "
                        "without a CUDA device the run exits 1)")
    p.add_argument("--engine", choices=["kernel", "op"], default="kernel",
                   help="kernel: the CUDA kernels (JAX's pallas engine); "
                        "op: plain PyTorch ops with the JAX op engine's "
                        "state layout (JAX's xla engine)")
    p.add_argument("--subchunks-per-step", type=int, default=10)
    p.add_argument("--steps-per-dispatch", type=int, default=1,
                   help="blocks fused into one dispatch (a CUDA graph of "
                        "that many steps on the card; outputs equal to 1)")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="checkpoint path (.npz): (blocks done, the [S, ...] "
                        "state) plus <path>.accum.npz, the accumulated "
                        "outputs; a SIGTERM/SIGINT flushes a final one")
    p.add_argument("--checkpoint-every", type=int, default=1,
                   help="dispatch groups between checkpoints (with "
                        "--checkpoint; a checkpoint never drains a group "
                        "early)")
    p.add_argument("--checkpoint-backend", choices=["npz", "orbax"],
                   default="npz",
                   help="checkpoint format; the port writes npz only")
    p.add_argument("--resume", action="store_true",
                   help="restore --checkpoint and continue mid-batch; "
                        "outputs are identical to an uninterrupted run")
    p.add_argument("--stop-after", type=int, default=0,
                   help="stop after N dispatch groups, as a SIGTERM does "
                        "(final checkpoint, partial outputs); 0 = to EOF")
    p.add_argument("--device-decode", action="store_true",
                   help="all captures in ONE of cf32/cs16/cu8/cs8: ship "
                        "their raw bytes as that format's wire and decode "
                        "on the device")
    return p


class RawBatchReader:
    """[S, block * bytes a sample] uint8 wire reader over same-format raw
    captures (JAX ``_RawBatchReader``; the port's wire is bytes, so there
    is no f32 word packing).  With ``run`` = (first sample, samples) it
    reads only that run of each block (a process's time shards)."""

    def __init__(self, paths, fmt: str, run: tuple | None = None):
        from sdr_pmr446_tpu_torch.ops import decode
        self.fmt = fmt
        self.dtype = np.dtype(decode.WIRE_DTYPE[fmt])
        self.fill = decode.WIRE_FILL[fmt]
        self.files = [open(p, "rb") for p in paths]
        self.run = run
        self.block = 0

    def read_block(self, block_len: int):
        """block_len samples a stream (or the run of them): ([S, bytes],
        most samples read), a short tail padded with the format's near-zero
        value."""
        first, n = self.run or (0, block_len)
        elems = 2 * n
        rows, got = [], 0
        for f in self.files:
            if self.run:
                f.seek(2 * (self.block * block_len + first)
                       * self.dtype.itemsize)
            raw = np.fromfile(f, dtype=self.dtype, count=elems)
            got = max(got, len(raw) // 2)
            if len(raw) < elems:
                raw = np.concatenate(
                    [raw, np.full(elems - len(raw), self.fill, self.dtype)])
            rows.append(raw.view(np.uint8))
        self.block += 1
        return np.stack(rows), got

    def skip_blocks(self, n_blocks: int, block_len: int) -> None:
        off = n_blocks * 2 * block_len * self.dtype.itemsize
        for f in self.files:
            f.seek(off, 0)
        self.block = n_blocks

    def close(self) -> None:
        for f in self.files:
            f.close()


class WireBatchReader:
    """io/native.py's BatchReader (host conversion of mixed formats) with
    its [S, block] complex64 blocks as the cf32 wire, uint8 [S, block * 8]."""

    def __init__(self, paths, fmts):
        from sdr_pmr446_tpu_torch.io import native
        self.reader = native.BatchReader(paths, fmts)
        self.kind = ("native" if self.reader._h is not None else "NumPy")

    def read_block(self, block_len: int):
        blocks, got = self.reader.read_block(block_len)
        return np.ascontiguousarray(blocks).view(np.uint8), got

    def skip_blocks(self, n_blocks: int, block_len: int) -> None:
        self.reader.skip_blocks(n_blocks, block_len)

    def close(self) -> None:
        self.reader.close()


class RankReader:
    """A process's reader over several processes: ``reader`` reads the
    process's captures; with ``cut`` = (first, count, n_time) each whole
    block it returns is cut to the process's run of time shards, and every
    block's real sample count comes from the captures' ``lengths``
    (samples), so every process ends on the same block."""

    def __init__(self, reader, lengths, cut: tuple | None = None):
        self.reader = reader
        self.total = max(lengths)
        self.cut = cut
        self.block = 0

    def read_block(self, block_len: int):
        blk, _ = self.reader.read_block(block_len)
        if self.cut:
            first, count, n_time = self.cut
            blk = blk.reshape(blk.shape[0], n_time, -1)[
                :, first:first + count].reshape(blk.shape[0], -1)
        got = min(block_len, max(0, self.total - self.block * block_len))
        self.block += 1
        return blk, got

    def skip_blocks(self, n_blocks: int, block_len: int) -> None:
        self.reader.skip_blocks(n_blocks, block_len)
        self.block = n_blocks

    def close(self) -> None:
        self.reader.close()


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


def _formats(ns, paths):
    """(per-capture host formats, the one wire format of --device-decode
    or None); raises ValueError for an unusable choice."""
    fmts = [ns.format or os.path.splitext(p)[1].lstrip(".") or "cf32"
            for p in paths]
    fmts = [ALIASES.get(f, f) for f in fmts]
    if ns.format and fmts[0] not in FORMATS:
        raise ValueError(f"unknown --format {ns.format!r} (supported: "
                         f"{'/'.join(FORMATS)} + aliases sc16/rtlsdr/fc32)")
    # unknown extensions default to cf32, as io/iq.py does
    fmts = [f if f in FORMATS else "cf32" for f in fmts]
    if ns.device_decode and len(set(fmts)) != 1:
        raise ValueError(f"--device-decode needs all captures in ONE of "
                         f"{'/'.join(FORMATS)} (got: "
                         f"{', '.join(sorted(set(fmts)))})")
    return fmts, (fmts[0] if ns.device_decode else None)


def _mesh_shape(ns, n_streams: int):
    """(stream shards, time shards) of --mesh, checked as JAX does."""
    if ns.mesh:
        try:
            s_axis, t_axis = (int(v) for v in ns.mesh.split(","))
        except ValueError:
            raise ValueError(f"--mesh {ns.mesh!r}: expected S,T") from None
    else:
        s_axis, t_axis = n_streams, 1
    if s_axis < 1 or t_axis < 1:
        raise ValueError(f"--mesh {s_axis},{t_axis}: both axes must be >= 1")
    if n_streams % s_axis:
        raise ValueError(f"{n_streams} captures do not divide across "
                         f"{s_axis} stream shards")
    if ns.subchunks_per_step % t_axis:
        raise ValueError(f"--subchunks-per-step {ns.subchunks_per_step} "
                         f"does not divide across {t_axis} time shards")
    return s_axis, t_axis


def _process_block(ns, n_streams: int, s_axis: int, t_axis: int):
    """This process's distributed.Block of the mesh, or None for one
    process; a ValueError for an unusable choice."""
    from sdr_pmr446_tpu_torch.parallel import distributed
    if not ns.coordinator:
        if ns.num_processes != 1 or ns.process_id != 0:
            raise ValueError("--num-processes / --process-id need "
                             "--coordinator")
        return None
    if ns.num_processes < 1:
        raise ValueError(f"--num-processes {ns.num_processes}: must be >= 1")
    return distributed.rank_block(n_streams, t_axis, ns.num_processes,
                                  ns.process_id, s_axis)


def capture_samples(paths, fmts) -> list:
    """Each capture's samples, from its size and format."""
    from sdr_pmr446_tpu_torch.ops import decode
    return [os.path.getsize(p) // decode.BYTES_PER_SAMPLE[f]
            for p, f in zip(paths, fmts)]


def _event_lines(host: dict, s: int, i: int, sub: int) -> list:
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


def unique_stems(paths) -> list:
    """Output stems, made unique: same-named captures from different
    directories must not overwrite each other's outputs."""
    stems = [os.path.splitext(os.path.basename(p))[0] for p in paths]
    seen: set = set()
    for s, st in enumerate(stems):
        while st in seen:
            st = f"{st}.{s}"
        stems[s] = st
        seen.add(st)
    return stems


def main(argv=None, stats: dict | None = None) -> int:
    """The CLI; returns its exit code.  ``stats``, when given, receives the
    run's reader, engine, blocks done, capture samples, wall seconds,
    seconds to its first dispatch's return (a graph capture at
    --steps-per-dispatch > 1) and the graphs its chain captured."""
    logging.basicConfig(level=logging.INFO,
                        format="[%(asctime)s %(name)s] %(message)s",
                        stream=sys.stderr)
    ns = build_parser().parse_args(argv)
    if ns.checkpoint_backend == "orbax":
        logging.error("not yet ported to sdr_pmr446_tpu_torch: "
                      "--checkpoint-backend orbax (a JAX library)")
        return 2
    try:
        mask = (C.parse_channel_mask(ns.mask) if ns.mask
                else (1 << C.MAX_CHANNELS) - 1)
    except ValueError as e:
        logging.error("%s", e)
        return 1
    if mask == 0:
        logging.error("No channels enabled in channel mask !")
        return 1
    if ns.resume and not ns.checkpoint:
        logging.error("--resume needs --checkpoint")
        return 1
    paths = ns.captures
    n_streams = len(paths)
    for pth in paths:
        if not os.path.exists(pth):
            logging.error("no such capture: %s", pth)
            return 1

    from sdr_pmr446_tpu_torch import device as devices
    from sdr_pmr446_tpu_torch.io import wav
    from sdr_pmr446_tpu_torch.ops import spectrogram
    from sdr_pmr446_tpu_torch.parallel import distributed
    from sdr_pmr446_tpu_torch.parallel.scanner_sharded import (
        ShardedScannerChain, make_mesh)
    from sdr_pmr446_tpu_torch.runtime import state as state_io
    from sdr_pmr446_tpu_torch.runtime.driver import device_prefetch
    from sdr_pmr446_tpu_torch.scanner.chain import make_runtime_params
    from sdr_pmr446_tpu_torch.ui import waterfall as wf_ui
    joined = False
    try:
        s_axis, t_axis = _mesh_shape(ns, n_streams)
        block = _process_block(ns, n_streams, s_axis, t_axis)
        fmts, wire_fmt = _formats(ns, paths)
        spectrogram.validate_width(ns.waterfall)
        if block is None:
            mesh = make_mesh(n_streams, t_axis, ns.device)
        else:
            devices.resolve(ns.device)          # before joining the group
            joined = distributed.initialize(ns.coordinator, ns.num_processes,
                                            ns.process_id)
            mesh = distributed.global_mesh(n_streams, t_axis, ns.device,
                                           s_axis)
        chain = ShardedScannerChain(
            mesh, C.BlockConfig(ns.subchunks_per_step), lowpass=ns.lowpass,
            waterfall=max(ns.waterfall, 0),
            input_format=wire_fmt or "cf32", device=mesh.device,
            engine=ns.engine)
    except (ValueError, RuntimeError) as e:
        logging.error("%s", e)
        if joined:
            distributed.shutdown()
        return 1
    multi = block is not None
    writer = not multi or ns.process_id == 0

    def _leave(rc: int) -> int:
        """Every process past this point, then out of the group it joined."""
        if joined:
            distributed.sync("scan_batch_exit")
            distributed.shutdown()
        return rc

    os.makedirs(ns.out_dir, exist_ok=True)
    args = C.ScannerArgs(
        audio_gain=ns.audio_gain, squelch_level=ns.squelch,
        lowpass=ns.lowpass, channel_mask=mask, lock_mode=ns.lock_mode)
    dev = chain.device
    params = make_runtime_params(args, dev)
    state = chain.init_state()
    block_len = chain.block.input_len
    engine = chain.engine_label
    mine = (slice(block.stream0, block.stream0 + block.n_stream) if multi
            else slice(None))
    # a process's time run of each block, in samples
    run = (None if not multi or block.n_time == t_axis else
           (block.time0 * chain.t_local, block.n_time * chain.t_local))
    if wire_fmt:
        reader = RawBatchReader(paths[mine], wire_fmt, run)
        reader_kind = f"raw {wire_fmt} wire"
    else:
        reader = WireBatchReader(paths[mine], fmts[mine])
        reader_kind = f"{reader.kind} BatchReader"
    log.info("scanning %d captures on a (%d stream x %d time) mesh "
             "(--mesh %d,%d), %s engine, device %s, reader %s", n_streams,
             n_streams, t_axis, s_axis, t_axis, engine, dev, reader_kind)
    if multi:
        reader = RankReader(
            reader, capture_samples(paths, fmts),
            None if wire_fmt or run is None
            else (block.time0, block.n_time, t_axis))
        log.info("process %d of %d: captures %d..%d, time shards %d..%d",
                 ns.process_id, ns.num_processes, block.stream0,
                 block.stream0 + block.n_stream - 1, block.time0,
                 block.time0 + block.n_time - 1)

    audio = [[] for _ in range(n_streams)]
    events = [[] for _ in range(n_streams)]
    wf_lines = [[] for _ in range(n_streams)] if ns.waterfall > 0 else None
    acc = {"subchunk": 0, "total_got": 0}
    n_fuse = max(1, ns.steps_per_dispatch)
    guard = {"subchunks_per_step": ns.subchunks_per_step,
             "n_streams": n_streams, "formats": ",".join(fmts),
             "device_decode": int(bool(ns.device_decode)),
             "mesh": f"{s_axis},{t_axis}",
             "num_processes": ns.num_processes if multi else 1}
    text_keys = ("formats", "mesh")

    saved_at = {"blocks": -1}

    def save_ckpt(blocks_done: int, host_state: list) -> None:
        # every stream's rows (a process holds its own): process 0 writes
        rows = distributed.gather_state(mesh, type(state)(
            *(torch.from_numpy(v) for v in host_state)))
        saved_at["blocks"] = blocks_done
        if not writer:
            distributed.sync("scan_batch_ckpt")
            return
        state_io.save_state(ns.checkpoint, blocks_done, rows)
        arrs = {"subchunk": np.int64(acc["subchunk"]),
                "total_got": np.int64(acc["total_got"])}
        arrs.update({k: np.array(v) for k, v in guard.items()})
        for s in range(n_streams):
            arrs[f"audio{s}"] = (np.stack(audio[s]) if audio[s]
                                 else np.zeros((0, 0), np.float32))
            arrs[f"events{s}"] = np.array("\n".join(events[s]))
            if wf_lines is not None:
                arrs[f"wf{s}"] = np.array("\n".join(wf_lines[s]))
        np.savez(ns.checkpoint + ".accum.npz", **arrs)
        log.info("checkpoint at block %d -> %s", blocks_done, ns.checkpoint)
        distributed.sync("scan_batch_ckpt")

    blocks_done = 0           # blocks dispatched AND drained
    if ns.resume:
        try:
            blocks_done, loaded = state_io.load_state(ns.checkpoint, dev)
            with np.load(ns.checkpoint + ".accum.npz") as z:
                ck = {k: z[k] for k in z.files}
            state_io.check_layout(loaded, chain.engine)
            if multi:
                loaded = state_io.state_rows(loaded, block.stream0,
                                             block.n_stream)
            loaded = state_io.adapt_state_histories(loaded, state)
        except (OSError, ValueError, KeyError, EOFError,
                zipfile.BadZipFile) as e:
            logging.error("cannot restore checkpoint '%s': %s",
                          ns.checkpoint, e)
            return _leave(1)
        # the guard: another block shape, capture count, wire or split
        # would seek mid-block, read another format's bytes or other rows
        saved = {k: (str(ck[k]) if k in text_keys else int(ck[k]))
                 for k in guard if k in ck}
        if saved != guard:
            logging.error("checkpoint was written with %s; resume invoked "
                          "with %s — rerun with the checkpoint's geometry, "
                          "formats, --device-decode, --mesh and process "
                          "count", saved, guard)
            return _leave(1)
        state = loaded
        acc["subchunk"] = int(ck["subchunk"])
        acc["total_got"] = int(ck["total_got"])
        for s in range(n_streams if writer else 0):
            a = ck[f"audio{s}"]
            audio[s] = list(a) if a.size else []
            ev = str(ck[f"events{s}"])
            events[s] = ev.split("\n") if ev else []
            if wf_lines is not None and f"wf{s}" in ck:
                w = str(ck[f"wf{s}"])
                wf_lines[s] = w.split("\n") if w else []
        reader.skip_blocks(blocks_done, block_len)
        log.info("resumed at block %d (%d sub-chunks done)", blocks_done,
                 acc["subchunk"])

    # SIGTERM / SIGINT: finish the group in flight, flush a final
    # checkpoint, write partial outputs (src/sdr_pmr446.c:933-940)
    stop = {"flag": False}

    def _stop(signum, frame):
        stop["flag"] = True
        log.info("signal %d: stopping after the current dispatch", signum)

    prev_handlers = []
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            prev_handlers.append((sig, signal.signal(sig, _stop)))
        except ValueError:        # not the main thread
            pass

    fetch = HostFetch(dev)
    gots: collections.deque = collections.deque()

    def stopped() -> bool:
        """The stop flag; over several processes the processes agree on it
        (a stop on any of them), so that all stop after the same group."""
        if multi:
            stop["flag"] = distributed.agree(stop["flag"])
        return stop["flag"]

    def read_blocks():
        """The reader's blocks until EOF or a stop (over several processes,
        until EOF: a stop ends the loop below where they agree on it); each
        block's real sample count goes to ``gots``."""
        while multi or not stop["flag"]:
            blk, got = reader.read_block(block_len)
            if got == 0:
                return
            gots.append(got)
            yield blk
            if got < block_len:
                return

    def drain(pending) -> None:
        out, nblk, ev, snap = pending
        host = fetch(list(out), ev)
        if multi:
            # every process's sub-chunks of its streams, to every process
            host = [t.numpy() for t in distributed.process_allgather(
                [torch.from_numpy(v) for v in host], mesh, time_axis=1)]
        host = dict(zip(out._fields, host))
        k = host["active_chan"].shape[1]
        for s in range(n_streams if writer else 0):
            for i in range(k):
                sub = acc["subchunk"] + i
                if host["audio_valid"][s][i]:
                    audio[s].append(host["audio"][s][i])
                events[s].extend(_event_lines(host, s, i, sub))
                if wf_lines is not None:
                    wf_lines[s].append(wf_ui.render_waterfall_line(
                        host["waterfall"][s][i],
                        float(host["rel_rssi"][s][i])))
        acc["subchunk"] += k
        nonlocal blocks_done
        blocks_done += nblk
        if snap is not None:
            save_ckpt(blocks_done, fetch(snap, ev))

    def dispatch(wires: list, snapshot: bool):
        nonlocal state, first_s
        if len(wires) == 1:
            state, out = chain.step(state, wires[0], params)
        else:
            state, out = chain.multi_step(state, torch.stack(wires), params)
        # the checkpoint's state, read back with the outputs once this
        # group is done: a returned state is never written again (step
        # writes nothing in place, a replay returns fresh copies)
        snap = list(state) if snapshot else None
        if first_s is None:
            first_s = time.perf_counter() - t0
        return out, len(wires), fetch.mark(), snap

    t0 = time.perf_counter()
    first_s = None
    pending = None
    groups_done = 0
    group, group_got = [], 0
    wires = device_prefetch(read_blocks(), dev, PREFETCH_DEPTH)
    for wire in wires:
        got = gots.popleft()
        acc["total_got"] += got
        group_got += got
        group.append(wire.reshape(chain.n_stream, -1))
        if len(group) < n_fuse:
            continue
        groups_done += 1
        if ns.stop_after and groups_done >= ns.stop_after:
            stop["flag"] = True
        every = ns.checkpoint_every
        ck = bool(ns.checkpoint and every > 0 and groups_done % every == 0)
        out = dispatch(group, ck)
        group, group_got = [], 0
        if pending is not None:
            drain(pending)
        pending = out
        if stopped():
            break
    # a short last group runs block by block (no graph of its own)
    for wire in (() if stopped() else group):
        out = dispatch([wire], False)
        if pending is not None:
            drain(pending)
        pending = out
    halted = stopped()
    if not halted:
        group_got = 0
    if pending is not None:
        drain(pending)
    wall = time.perf_counter() - t0
    reader.close()
    for sig, handler in prev_handlers:   # main() is re-entrant in tests
        signal.signal(sig, handler)
    if halted:
        acc["total_got"] -= group_got     # read, never dispatched
        if ns.checkpoint and saved_at["blocks"] != blocks_done:
            save_ckpt(blocks_done, [v.cpu().numpy() for v in state])
        log.info("stopped by signal at block %d; partial outputs follow",
                 blocks_done)
    samples = n_streams * acc["total_got"]
    log.info("scanned %d blocks of %d captures in %.3f s: %.1f Msamples/s "
             "of capture", blocks_done, n_streams, wall,
             samples / max(wall, 1e-9) / 1e6)
    if stats is not None:
        stats.update(reader=reader_kind, engine=engine, blocks=blocks_done,
                     samples=samples, wall_s=wall, first_s=first_s,
                     graphs=len(chain.megastep.graphs),
                     processes=ns.num_processes if multi else 1)
    _leave(0)
    if not writer:
        log.info("process %d done (process 0 writes the outputs)",
                 ns.process_id)
        return 0

    real_sub = -(-acc["total_got"] // C.SUBCHUNK_IN)
    for s, stem in enumerate(unique_stems(paths)):
        out_wav = os.path.join(ns.out_dir, f"{stem}.wav")
        a = (np.concatenate(audio[s]) if audio[s]
             else np.zeros(0, np.float32))
        wav.write_wav(out_wav, a, C.AUDIO_SAMPLERATE)
        with open(os.path.join(ns.out_dir, f"{stem}.events.log"), "w") as f:
            f.write("\n".join(events[s]) + ("\n" if events[s] else ""))
        if wf_lines is not None:
            # only sub-chunks that hold samples read from the capture get
            # a row (the reference prints one row per received chunk)
            rows = wf_lines[s][:real_sub]
            with open(os.path.join(ns.out_dir, f"{stem}.waterfall.log"),
                      "w") as f:
                f.write("\n".join(rows) + ("\n" if rows else ""))
        log.info("%s: %d audio samples (%.2f s), %d events -> %s", stem,
                 len(a), len(a) / C.AUDIO_SAMPLERATE, len(events[s]),
                 out_wav)
    log.info("Exiting")
    return 0


if __name__ == "__main__":
    sys.exit(main())
