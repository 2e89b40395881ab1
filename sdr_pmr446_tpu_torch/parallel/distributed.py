"""Multi-process execution of the sharded chains (torch.distributed, gloo).

Counterpart of sdr_pmr446_tpu/parallel/distributed.py.  JAX lays the
(stream x time) mesh of parallel/scanner_sharded.py out over the devices of
every process, time fastest, and inserts the collectives between hosts.
Here a process holds ONE device and many shards on it (the one-card mesh),
so P processes split JAX's (stream shards x D) device mesh evenly, time
fastest, each stream shard a group of S / stream shards streams: rank r
holds a rectangle of streams x time shards (``rank_block``), either whole
stream shards with all D time shards (a stream split: the halos stay inside
the rank) or one stream shard's streams x a run of consecutive time shards
(a time split: the ranks that share those streams, their *time group*,
pass halos to each other).

  - ``initialize``: ``init_process_group("gloo", "tcp://<coordinator>")``
    with an explicit timeout, so a missing peer fails the run instead of
    hanging it; idempotent, as JAX's ``_initialized`` guard; ``shutdown``
    for tests;
  - ``global_mesh``: a ``GlobalMesh``, the rank's block of the global mesh
    (its ``n_stream`` x ``n_time`` shards, as a one-card ``Mesh`` has) with
    its global offsets and its time group;
  - ``make_global_array`` / ``globalize_pytree``: a rank's rows of a host
    [S, ...] array (its streams' rows of the state) or its [S_loc, D_loc *
    bytes a shard] block of the wire, on its device;
  - ``process_allgather``: every rank's block of a tensor, assembled into
    the global one on every rank (the writer, rank 0, uses it for the
    outputs and the checkpoint, as JAX's ``_drain`` and ``_save_ckpt``
    do); ``sync``: a barrier.

The transport stages through the host: each collective copies its tensors
to the host (``.cpu()``, which waits for the device work that made them),
runs the gloo collective on bytes, and copies the result back to the
rank's device.  Gloo's CUDA-tensor support does not cover every collective,
and on a machine with one card two ranks share it (NCCL refuses two ranks
on one GPU).  So a distributed step reads the host; ``STATS`` keeps the
calls, the bytes and the host seconds of the staging and of the collectives.
"""

from __future__ import annotations

import datetime
import logging
import time
from typing import NamedTuple

import torch
import torch.distributed as dist

from sdr_pmr446_tpu_torch import device as devices

log = logging.getLogger("distributed")

#: seconds a collective (and the rendezvous) waits for a missing peer
TIMEOUT_S = 120.0

#: the host-staged collectives so far: calls, bytes gathered, host seconds
#: copying to the host (including the wait for the device work before it)
#: and in the gloo collective with the copy back
STATS = {"calls": 0, "bytes": 0, "stage_s": 0.0, "collective_s": 0.0}

_initialized = False
_groups: dict = {}


def reset_stats() -> None:
    STATS.update(calls=0, bytes=0, stage_s=0.0, collective_s=0.0)


def initialize(coordinator_address: str, num_processes: int,
               process_id: int, timeout_s: float = TIMEOUT_S) -> bool:
    """Join the process group at ``coordinator_address`` (host:port; rank 0
    listens there), with an idempotence guard; True when this call joined
    it (its caller then leaves it: ``shutdown``)."""
    global _initialized
    if _initialized:
        return False
    if not 0 <= process_id < num_processes:
        raise ValueError(f"--process-id {process_id} is outside [0, "
                         f"{num_processes})")
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s))
    _initialized = True
    return True


def shutdown() -> None:
    """Leave the process group (tests run several in one process)."""
    global _initialized
    if _initialized:
        dist.destroy_process_group()
    _initialized = False
    _groups.clear()


def process_count() -> int:
    return dist.get_world_size() if _initialized else 1


def process_index() -> int:
    return dist.get_rank() if _initialized else 0


class Block(NamedTuple):
    """A rank's rectangle of the global (stream x time) mesh, in shards."""
    stream0: int
    n_stream: int
    time0: int
    n_time: int


def rank_block(n_stream: int, n_time: int, num_processes: int,
               process_id: int, stream_shards: int | None = None) -> Block:
    """Rank ``process_id``'s block of ``n_stream`` streams x ``n_time`` time
    shards when ``num_processes`` ranks split the (``stream_shards`` x
    ``n_time``) device mesh evenly, time fastest (JAX's ``global_mesh``
    order; each stream shard holds n_stream / stream_shards streams, one
    by default).  A ValueError where the mesh does not split into such
    rectangles."""
    if not 0 <= process_id < num_processes:
        raise ValueError(f"--process-id {process_id} is outside [0, "
                         f"{num_processes})")
    ss = stream_shards or n_stream
    if n_stream % ss:
        raise ValueError(f"{n_stream} streams do not divide across {ss} "
                         f"stream shards")
    per_shard = n_stream // ss
    devs = ss * n_time
    per = devs // num_processes
    if devs % num_processes or not (per % n_time == 0
                                    or n_time % per == 0):
        raise ValueError(
            f"mesh {ss},{n_time} needs its {devs} devices split over "
            f"{num_processes} processes into whole stream shards or runs of "
            f"one stream shard's time shards")
    if per % n_time == 0:
        rows = per // n_time * per_shard
        return Block(process_id * rows, rows, 0, n_time)
    runs = n_time // per
    return Block(process_id // runs * per_shard, per_shard,
                 (process_id % runs) * per, per)


def rank_device(device, process_id: int) -> torch.device:
    """A rank's device: ``cuda:(process_id % cards)``, or the CPU when
    asked.  Ranks share a card when there are fewer cards than ranks."""
    dev = devices.resolve(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    return torch.device("cuda", process_id % torch.cuda.device_count())


class GlobalMesh(NamedTuple):
    """A rank's block of a mesh over several processes.  ``n_stream``,
    ``n_time`` and ``device`` are the rank's, as on a one-card Mesh (the
    chains hold this many shards); the rest place the block in the global
    (``global_stream`` x ``global_time``) mesh.  ``group`` is the time
    group's process group (None when the rank holds whole streams),
    ``group_ranks`` its ranks in time order; ``stream_shards`` the device
    mesh's stream axis (``rank_block``)."""
    n_stream: int
    n_time: int
    device: torch.device
    global_stream: int
    global_time: int
    stream0: int
    time0: int
    group: object
    group_ranks: tuple
    stream_shards: int


def global_mesh(n_stream: int, n_time: int, device=devices.DEFAULT,
                stream_shards: int | None = None) -> GlobalMesh:
    """This rank's block of the (``n_stream`` x ``n_time``) mesh over every
    process (call after ``initialize``; every rank calls it, in the same
    order, since it makes the time groups' process groups)."""
    procs, rank = process_count(), process_index()
    ss = stream_shards or n_stream
    blocks = [rank_block(n_stream, n_time, procs, r, ss)
              for r in range(procs)]
    mine = blocks[rank]
    dev = rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    key = (n_stream, n_time, ss)
    if key not in _groups:
        groups = {}
        if mine.n_time < n_time:
            for s0 in sorted({b.stream0 for b in blocks}):
                ranks = tuple(r for r, b in enumerate(blocks)
                              if b.stream0 == s0)
                groups[s0] = (dist.new_group(list(ranks)), ranks)
        _groups[key] = groups
    group, ranks = _groups[key].get(mine.stream0, (None, (rank,)))
    shared = [r for r in range(procs)
              if rank_device(device, r) == dev and r != rank]
    log.info("process %d of %d: streams %d..%d, time shards %d..%d of the "
             "(%d x %d) mesh on %s%s", rank, procs, mine.stream0,
             mine.stream0 + mine.n_stream - 1, mine.time0,
             mine.time0 + mine.n_time - 1, n_stream, n_time, dev,
             f" (shared with process {shared})" if shared else "")
    return GlobalMesh(mine.n_stream, mine.n_time, dev, n_stream, n_time,
                      mine.stream0, mine.time0, group, ranks, ss)


def blocks_of(mesh: GlobalMesh) -> list:
    """Every rank's Block of ``mesh``."""
    return [rank_block(mesh.global_stream, mesh.global_time,
                       process_count(), r, mesh.stream_shards)
            for r in range(process_count())]


def make_global_array(mesh, host_data, sharded_time: bool = False):
    """The rank's block of an array [S, ...] (numpy or a tensor) on its
    device: its streams' rows, and with ``sharded_time`` (the wire [S, D *
    bytes a shard]) its time shards of each row, [S_loc, D_loc * bytes a
    shard]."""
    t = torch.as_tensor(host_data)
    if isinstance(mesh, GlobalMesh):
        t = t[mesh.stream0:mesh.stream0 + mesh.n_stream]
        if sharded_time:
            t = t.reshape(mesh.n_stream, mesh.global_time, -1)[
                :, mesh.time0:mesh.time0 + mesh.n_time].reshape(
                    mesh.n_stream, -1)
    return t.to(mesh.device)


def globalize_pytree(mesh, tree):
    """``make_global_array`` over the fields of a stacked [S, ...] state
    (a NamedTuple): the rank's streams' rows."""
    return type(tree)(*(make_global_array(mesh, v) for v in tree))


# ---------------------------------------------------------------- transport
#: each tensor's bytes start on this boundary in a collective's buffer, so
#: that every dtype views back in place
_ALIGN = 16


def _padded(n: int) -> int:
    return -(-n // _ALIGN) * _ALIGN


def _to_bytes(t: torch.Tensor) -> torch.Tensor:
    flat = torch.empty(t.numel(), dtype=t.dtype, device=t.device)
    b = flat.copy_(t.detach().reshape(-1)).view(torch.uint8)
    pad = _padded(b.numel()) - b.numel()
    return torch.cat([b, b.new_zeros(pad)]) if pad else b


def all_gather(tensors, group=None) -> list:
    """[[each of ``tensors`` from rank g] for g in the group's ranks]: one
    gloo all_gather of their bytes, staged through the host, the results
    on the tensors' devices."""
    dev = tensors[0].device
    t0 = time.perf_counter()
    buf = torch.cat([_to_bytes(t) for t in tensors]).cpu()
    t1 = time.perf_counter()
    n = dist.get_world_size(group)
    out = [torch.empty_like(buf) for _ in range(n)]
    dist.all_gather(out, buf, group=group)
    back = torch.stack(out).to(dev)
    STATS["calls"] += 1
    STATS["bytes"] += buf.numel() * n
    STATS["stage_s"] += t1 - t0
    STATS["collective_s"] += time.perf_counter() - t1
    res = []
    for g in range(n):
        row, off, got = back[g], 0, []
        for t in tensors:
            nb = t.numel() * t.element_size()
            got.append(row[off:off + nb].view(t.dtype).reshape(t.shape))
            off += _padded(nb)
        res.append(got)
    return res


def process_allgather(tensors, mesh, time_axis: int | None = None):
    """The global tensors from every rank's block of each of ``tensors``
    (a list, or one tensor) in one collective: rows [S_loc, ...] placed at
    each rank's streams, and with ``time_axis`` the rank's time run along
    that axis (its length there the rank's share).  The rows of ranks that
    share streams are replicas; any one serves.  Host tensors stay on the
    host."""
    one = isinstance(tensors, torch.Tensor)
    tensors = [tensors] if one else list(tensors)
    if not isinstance(mesh, GlobalMesh) or process_count() == 1:
        return tensors[0] if one else tensors
    parts = all_gather(tensors)
    runs = mesh.global_time // mesh.n_time
    outs = []
    for i, t in enumerate(tensors):
        shape = list(t.shape)
        shape[0] = mesh.global_stream
        if time_axis is not None:
            shape[time_axis] = t.shape[time_axis] * runs
        out = t.new_empty(shape)
        for b, part in zip(blocks_of(mesh), parts):
            idx = [slice(b.stream0, b.stream0 + b.n_stream)]
            if time_axis is not None:
                n = t.shape[time_axis]
                lo = b.time0 // mesh.n_time * n
                idx += [slice(None)] * (time_axis - 1) + [slice(lo, lo + n)]
            out[tuple(idx)] = part[i]
        outs.append(out)
    return outs[0] if one else outs


def gather_state(mesh, state):
    """Every stream's rows of a stacked state, from the ranks that hold
    them (rank 0 writes the checkpoint from it)."""
    return type(state)(*process_allgather(list(state), mesh))


def agree(flag: bool) -> bool:
    """True on every process when ``flag`` is true on any (a stop that one
    rank's signal asked for, so that every rank stops after the same
    group)."""
    if not _initialized or process_count() == 1:
        return flag
    t = torch.tensor([int(flag)], dtype=torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def sync(name: str) -> None:
    """A barrier over every process (``name`` for the log)."""
    if _initialized and process_count() > 1:
        log.debug("sync %s", name)
        dist.barrier()
