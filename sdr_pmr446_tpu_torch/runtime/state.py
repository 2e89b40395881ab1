"""Carried streaming state of the port's chains (PyTorch).

Counterpart of sdr_pmr446_tpu/runtime/state.py.  ``ScannerState`` has the
JAX field names, shapes and dtypes, so a JAX state converted to numpy
loads into the port and back unchanged, and the npz checkpoint format is
the same file format.  Its layout depends on the engine (engine.py), as
in JAX:

  - the kernel engine's (``use_pallas=True``): the DC-blocked front
    history in ``resamp_hist`` (c64 [384|512]; the raw [345] with
    ``fuse_dc=False``) and the raw-demod history ``audio_hist`` [16,
    512|640] of the audio bank; the four FIR histories of the op path
    (``hp_hist``, ``delay_hist``, ``deemph_hist``, ``audio_lp_hist``) stay
    zero;
  - the op engine's (``use_pallas=False``): the resampler's raw-input
    history ``resamp_hist`` c64 [345] and the four FIR histories carried;
    ``audio_hist`` [16, 512] stays zero.

Checkpoints: ``save_state`` / ``load_state`` write and read the npz file
both packages read; ``save_state_orbax`` / ``load_state_orbax`` (JAX's
names for its orbax backend) a torch.distributed.checkpoint directory with
JAX's tree, for any chain's state, which JAX's orbax does not read (nor
the port JAX's tensorstore directories).

``check_layout`` refuses a state of the other engine's layout, never
reinterprets it.  With the waterfall on, ``wf_hist`` is c64 [w//2] as in
the JAX state, and the port writes it and ``wf_cnt`` every step, so a JAX
XLA-path engine resumes from a port state.

The dsd_in and single-channel chains carry the JAX layouts of their
engine: on the kernel engine the mono engine's (scanner/dsd_in.py::
DsdState, scanner/single.py::SingleState, JAX's PallasDsdState /
PallasSingleState), on the op engine the op engine's (DsdOpState,
SingleOpState, JAX's DsdState / SingleState).  Their numpy conversions
below take the chain's engine and give the fields in the JAX order, so
states pass between the packages both ways.

The time-sharded chains (parallel/) carry S streams' states at once: each
field of the same NamedTuple with a leading [S] dim (``stack_state``), the
layout of a JAX sharded chain's ``init_state(S)``.  The numpy conversions
take and give such a state unchanged, so a sharded state passes between
the packages both ways too.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import warnings
from typing import NamedTuple

import numpy as np
import torch

from sdr_pmr446_tpu_torch import config as C
from sdr_pmr446_tpu_torch import engine as engines
from sdr_pmr446_tpu_torch.scanner.dsd_in import DsdOpState, DsdState
from sdr_pmr446_tpu_torch.scanner.single import SingleOpState, SingleState


class ScannerState(NamedTuple):
    # front end (input rate)
    dc_x: torch.Tensor          # c64 []     IQ DC blocker x[-1]
    dc_y: torch.Tensor          # c64 []     IQ DC blocker y[-1]
    resamp_hist: torch.Tensor   # c64 [384|512] DC-blocked front history
    #                             ([345] resampler history: fuse_dc=False,
    #                             the op engine)
    # band rate (200 kHz)
    pfb_hist: torch.Tensor      # c64 [400]  channelizer history
    frame_parity: torch.Tensor  # i32 []     global PFB frame count mod 2
    # channel rate (12.5 kHz), per channel
    demod_prev: torch.Tensor    # c64 [16]   discriminator previous sample
    hp_hist: torch.Tensor       # f32 [16, 376]   (op engine; kernel: zero)
    delay_hist: torch.Tensor    # f32 [16, 188]   (op engine; kernel: zero)
    lp_dc_x: torch.Tensor       # f32 [16]   CTCSS-branch DC blocker
    lp_dc_y: torch.Tensor       # f32 [16]
    deemph_hist: torch.Tensor   # f32 [16, deemph_taps-1] (op engine)
    audio_lp_hist: torch.Tensor  # f32 [16, 102]  (op engine; kernel: zero)
    audio_hist: torch.Tensor    # f32 [16, 512|640] raw-demod history
    #                             (kernel engine; op: [16, 512], zero)
    # control (squelch FSM)
    fsm_state: torch.Tensor     # i32 []     0=scanning 1=tuned
    active_chan: torch.Tensor   # i32 []     -1..15
    rssi: torch.Tensor          # f32 []     last relative RSSI
    # CTCSS detector
    ct_count: torch.Tensor      # i32 []     samples into the 2441-window
    ct_carry: torch.Tensor      # c64 [38]   partial windowed-DFT sums
    ct_detected: torch.Tensor   # bool []
    ct_max_idx: torch.Tensor    # i32 []
    ct_freq: torch.Tensor       # f32 []     displayed CTCSS frequency
    wf_hist: torch.Tensor       # c64 [w//2] waterfall band history ([0]
    #                             when the waterfall is off)
    wf_cnt: torch.Tensor        # i32 []     waterfall in-hop sample counter


def init_scanner_state(resamp_hist_len: int, pfb_hist_len: int,
                       deemph_hist_len: int, audio_hist_len: int,
                       device, waterfall: int = 0) -> ScannerState:
    nch = C.NUM_CHANNELS
    c64 = dict(dtype=torch.complex64, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    return ScannerState(
        dc_x=torch.zeros((), **c64),
        dc_y=torch.zeros((), **c64),
        resamp_hist=torch.zeros(resamp_hist_len, **c64),
        pfb_hist=torch.zeros(pfb_hist_len, **c64),
        frame_parity=torch.zeros((), **i32),
        demod_prev=torch.zeros(nch, **c64),
        hp_hist=torch.zeros((nch, C.HP_AUDIO_FILT_TAPS - 1), **f32),
        delay_hist=torch.zeros((nch, C.CTCSS_DELAY), **f32),
        lp_dc_x=torch.zeros(nch, **f32),
        lp_dc_y=torch.zeros(nch, **f32),
        deemph_hist=torch.zeros((nch, deemph_hist_len), **f32),
        audio_lp_hist=torch.zeros((nch, C.LP_AUDIO_FILT_TAPS - 1), **f32),
        audio_hist=torch.zeros((nch, audio_hist_len), **f32),
        fsm_state=torch.zeros((), **i32),
        active_chan=torch.full((), -1, **i32),
        rssi=torch.zeros((), **f32),
        ct_count=torch.zeros((), **i32),
        ct_carry=torch.zeros(C.CTCSS_NUM_FREQS, **c64),
        ct_detected=torch.zeros((), dtype=torch.bool, device=device),
        ct_max_idx=torch.zeros((), **i32),
        ct_freq=torch.full((), -1.0, **f32),
        # waterfall <= 0 means "off" everywhere (the chain guards on > 0)
        wf_hist=torch.zeros(max(waterfall, 0) // 2, **c64),
        wf_cnt=torch.zeros((), **i32),
    )


def stack_state(state, n_streams: int):
    """``state`` repeated for ``n_streams`` streams: every field of the same
    NamedTuple with a leading [S] dim (a sharded chain's state)."""
    return type(state)(*(v.unsqueeze(0).repeat((n_streams,) + (1,) * v.dim())
                         for v in state))


def state_rows(state, start: int, count: int):
    """Streams ``start`` .. ``start + count - 1`` of a stacked [S, ...]
    state (a rank's rows over several processes: what it loads from a
    checkpoint of every stream; parallel/distributed.py::gather_state is
    the way back)."""
    return type(state)(*(v[start:start + count] for v in state))


def state_to_numpy(state: ScannerState) -> list[np.ndarray]:
    """The state's fields as numpy arrays, in field order."""
    return [v.detach().cpu().numpy() for v in state]


def state_from_numpy(values, device) -> ScannerState:
    """Build a state from numpy arrays in field order (a JAX state's
    ``[np.asarray(v) for v in state]`` loads unchanged)."""
    return _fields_from_numpy(ScannerState, values, device)


def save_state(path: str, block_index: int, state: ScannerState) -> None:
    """Checkpoint (block index, state) as .npz in the JAX package's format
    (keys ``block_index`` and ``s0`` .. ``s22`` in field order)."""
    arrs = {f"s{i}": v for i, v in enumerate(state_to_numpy(state))}
    np.savez(path, block_index=np.int64(block_index), **arrs)


def load_state(path: str, device) -> tuple[int, ScannerState]:
    """Read a checkpoint written by ``save_state`` here or in the JAX
    package.  A field the file lacks (one appended to the state after the
    file was written) loads as None; ``adapt_state_histories`` then takes
    the chain's init value for it (the driver's restore does both)."""
    with np.load(path) as z:
        vals = [torch.as_tensor(np.array(z[f"s{i}"], copy=True),
                                device=device) if f"s{i}" in z else None
                for i in range(len(ScannerState._fields))]
        return int(z["block_index"]), ScannerState(*vals)


# ------------------------------------------- the directory ("orbax") backend
def save_state_orbax(path: str, block_index: int, state) -> None:
    """Checkpoint (block index, state) as a directory, on
    ``torch.distributed.checkpoint`` (DCP): the port's counterpart of JAX's
    orbax backend (runtime/state.py ``save_state_orbax``), with its name
    and its tree, ``{"block_index", "leaves": {"s<i>": ...}, "empties"}``.
    Works for any chain's state NamedTuple, stacked [S, ...] states too.
    Zero-size fields (``wf_hist`` with the waterfall off) are stored as
    their (shape, dtype) in ``empties``, a JSON byte string, as in JAX.

    ``path`` is overwritten as a whole: the tree goes to ``<path>.dcp-tmp``
    and then replaces ``path``.  With no process group this is one
    process's save.  In a process group it is a collective that every rank
    calls with the same (replicated) tree; DCP plans the writes together,
    writes each tensor once, and rank 0 writes the metadata and moves the
    directory into place before a barrier releases the ranks.

    DCP stores torch's own files (``.metadata``, ``__<rank>_0.distcp``);
    JAX's orbax stores tensorstore / OCDBT.  The two directories are not
    interchangeable: ``load_state_orbax`` refuses a JAX one by name, and the
    npz format (``save_state``) is the one both packages read."""
    import torch.distributed as dist
    import torch.distributed.checkpoint as dcp
    leaves, empties = {}, {}
    for i, v in enumerate(state_to_numpy(state)):
        if v.size == 0:
            empties[f"s{i}"] = [list(v.shape), str(v.dtype)]
        else:
            leaves[f"s{i}"] = torch.from_numpy(v)
    meta = torch.tensor(list(json.dumps(empties).encode()), dtype=torch.uint8)
    tree = {"block_index": torch.tensor(int(block_index), dtype=torch.int64),
            "leaves": leaves, "empties": meta}
    path = os.path.abspath(path)
    tmp = path + ".dcp-tmp"
    group = dist.is_available() and dist.is_initialized()
    writer = not group or dist.get_rank() == 0
    if writer:
        # before the save's first collective: no rank writes into tmp
        # until the writer has cleared it
        shutil.rmtree(tmp, ignore_errors=True)
    with _one_process_quiet():
        dcp.save(tree, checkpoint_id=tmp, no_dist=not group)
    if writer:
        old = path + ".dcp-old"
        shutil.rmtree(old, ignore_errors=True)
        if os.path.isdir(path):
            os.rename(path, old)
        elif os.path.exists(path):
            os.remove(path)
        os.rename(tmp, path)
        shutil.rmtree(old, ignore_errors=True)
    if group:
        dist.barrier()


@contextlib.contextmanager
def _one_process_quiet():
    """Without DCP's warning that a call with no process group is one
    process's (``no_dist`` says so already)."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore",
                                message="torch.distributed is disabled")
        yield


def _dcp_metadata(path: str):
    """The DCP metadata of the checkpoint directory ``path``; raises
    FileNotFoundError where there is nothing, ValueError naming what is
    there where it is no DCP checkpoint (a file, a JAX orbax directory,
    anything else)."""
    from torch.distributed.checkpoint import FileSystemReader
    if not os.path.exists(path):
        raise FileNotFoundError(f"no checkpoint directory {path!r}")
    if not os.path.isdir(path):
        raise ValueError(f"{path!r} is a file, not a checkpoint directory "
                         f"(an npz checkpoint? --checkpoint-backend npz)")
    found = sorted(os.listdir(path))
    if ".metadata" not in found:
        if {"_CHECKPOINT_METADATA", "manifest.ocdbt"} & set(found):
            raise ValueError(
                f"{path!r} is a JAX orbax checkpoint (tensorstore / OCDBT: "
                f"{', '.join(found)}), which only JAX reads; the port reads "
                f"torch.distributed.checkpoint directories and the npz "
                f"format both packages share")
        raise ValueError(
            f"{path!r} is not a torch.distributed.checkpoint directory (no "
            f".metadata; found: {', '.join(found) or 'nothing'})")
    try:
        return FileSystemReader(path).read_metadata()
    except Exception as e:                      # noqa: BLE001 — any reader
        raise ValueError(f"{path!r}: unreadable checkpoint metadata "
                         f"({type(e).__name__}: {e})") from None


def load_state_orbax(path: str, device, state_cls=ScannerState):
    """Restore (block_index, state) from a ``save_state_orbax`` directory
    (JAX runtime/state.py ``load_state_orbax``).  Each tensor is read at
    the shape and dtype the checkpoint's own metadata gives, so a history
    of another length reaches ``adapt_state_histories``; a field the
    checkpoint lacks loads as None (then filled with the chain's init
    value).  A plain read on every process (no collective).  Raises
    FileNotFoundError / ValueError for a missing or foreign directory
    (``_dcp_metadata``)."""
    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint.api import CheckpointException
    from torch.distributed.checkpoint.metadata import TensorStorageMetadata
    path = os.path.abspath(path)
    meta = _dcp_metadata(path)
    tree: dict = {"leaves": {}}
    for key, m in meta.state_dict_metadata.items():
        if not isinstance(m, TensorStorageMetadata):
            continue
        t = torch.zeros(tuple(m.size), dtype=m.properties.dtype)
        if key.startswith("leaves."):
            tree["leaves"][key[len("leaves."):]] = t
        elif key in ("block_index", "empties"):
            tree[key] = t
    if "block_index" not in tree or "empties" not in tree:
        raise ValueError(f"{path!r} holds no state checkpoint (keys: "
                         f"{', '.join(sorted(meta.state_dict_metadata))})")
    try:
        with _one_process_quiet():
            dcp.load(tree, checkpoint_id=path, no_dist=True)
    except CheckpointException as e:     # a BaseException: make it an error
        raise ValueError(f"{path!r}: cannot read the checkpoint ({e})") \
            from None
    empties = json.loads(bytes(tree["empties"].tolist()).decode())
    vals = []
    for i in range(len(state_cls._fields)):
        key = f"s{i}"
        if key in empties:
            shape, dtype = empties[key]
            vals.append(torch.from_numpy(np.zeros(tuple(shape), dtype)).to(
                device))
        elif key in tree["leaves"]:
            vals.append(tree["leaves"][key].to(device))
        else:
            vals.append(None)
    return int(tree["block_index"]), state_cls(*vals)


#: ``--checkpoint-backend`` (JAX's names) -> (save, load)
BACKENDS = {"npz": (save_state, load_state),
            "orbax": (save_state_orbax, load_state_orbax)}


#: the JAX op engine's FIR histories (use_pallas=False), zero on every
#: kernel engine
OP_ENGINE_HISTORIES = ("hp_hist", "delay_hist", "deemph_hist",
                       "audio_lp_hist")
#: the kernel engines' audio-bank history, zero on the op engine
KERNEL_ENGINE_HISTORIES = ("audio_hist",)


def check_layout(state: ScannerState, engine: str) -> None:
    """Raise ValueError if ``state`` (a ScannerState, unsharded or with a
    leading [S]) has the other engine's layout than ``engine``'s: a
    non-zero op-engine FIR history (OP_ENGINE_HISTORIES) on the kernel
    engine, a non-zero ``audio_hist`` on the op engine.  The chain would
    read its audio path wrongly, so such a state is refused, never
    reinterpreted; the message names the engine that takes it."""
    other = {engines.KERNEL: (OP_ENGINE_HISTORIES, engines.OP,
                              "the JAX op engine's (use_pallas=False)"),
             engines.OP: (KERNEL_ENGINE_HISTORIES, engines.KERNEL,
                          "a kernel engine's (use_pallas=True)")}
    names, takes, layout = other[engines.resolve(engine)]
    for name in names:
        v = getattr(state, name)
        if v is not None and bool(torch.any(v != 0)):
            raise ValueError(
                f"state field {name!r} is non-zero: the state has {layout} "
                f"layout, which the {engine} engine does not take (load it "
                f"with --engine {takes} / engine={takes!r})")


def adapt_state_histories(state, reference):
    """Reconcile a checkpoint's history lengths with the target chain's
    (JAX runtime/state.py::adapt_state_histories, the same rules).

    ``reference`` is the target chain's ``init_state()``.  The newest
    samples of every ``*_hist`` field sit at its end, so a longer target is
    left-padded with zeros and a shorter one keeps the newest suffix (the
    duo's 384 and 512-sample front histories, the 512 and 640-sample audio
    history).  A field that is None (missing from the file) takes the
    reference's value.  Any other shape mismatch raises ValueError naming
    the field."""
    fields = getattr(state, "_fields", None)
    vals = []
    for i, (cur, ref) in enumerate(zip(state, reference)):
        name = fields[i] if fields else str(i)
        if cur is None:
            vals.append(ref)
            continue
        if tuple(cur.shape) == tuple(ref.shape):
            vals.append(cur)
            continue
        same_lead = tuple(cur.shape[:-1]) == tuple(ref.shape[:-1])
        if not (name.endswith("_hist") and cur.dim() >= 1 and same_lead):
            raise ValueError(
                f"checkpoint field {name!r} has shape {tuple(cur.shape)}, "
                f"chain expects {tuple(ref.shape)} — not a history, cannot "
                f"migrate")
        want, have = ref.shape[-1], cur.shape[-1]
        if have >= want:
            vals.append(cur[..., have - want:])
        else:
            pad = cur.new_zeros(tuple(cur.shape[:-1]) + (want - have,))
            vals.append(torch.cat([pad, cur], dim=-1))
    return type(state)(*vals)


def _fields_from_numpy(cls, values, device):
    values = list(values)
    if len(values) != len(cls._fields):
        raise ValueError(f"expected {len(cls._fields)} fields, got "
                         f"{len(values)}")
    return cls(*(torch.as_tensor(np.array(v, copy=True), device=device)
                 for v in values))


def dsd_state_to_numpy(state) -> list[np.ndarray]:
    """A DsdInChain state as numpy arrays in the field order of its JAX
    counterpart (PallasDsdState on the kernel engine, DsdState on the op
    engine)."""
    return state_to_numpy(state)


def dsd_state_from_numpy(values, device, engine: str = engines.KERNEL):
    """The ``engine``'s dsd state (DsdState or DsdOpState) from numpy
    arrays in the JAX field order (a JAX state's ``[np.asarray(v) for v in
    state]`` loads unchanged)."""
    cls = DsdOpState if engines.resolve(engine) == engines.OP else DsdState
    return _fields_from_numpy(cls, values, device)


def single_state_to_numpy(state) -> list[np.ndarray]:
    """A SingleChannelChain state as numpy arrays in the field order of its
    JAX counterpart (PallasSingleState / SingleState)."""
    return state_to_numpy(state)


def single_state_from_numpy(values, device, engine: str = engines.KERNEL):
    """The ``engine``'s single state (SingleState or SingleOpState) from
    numpy arrays in the JAX field order."""
    cls = (SingleOpState if engines.resolve(engine) == engines.OP
           else SingleState)
    return _fields_from_numpy(cls, values, device)
