"""Carried streaming state of the port's chains (PyTorch).

Counterpart of sdr_pmr446_tpu/runtime/state.py.  ``ScannerState`` has the
JAX field names, shapes and dtypes of the kernel engine's state
(``ScannerChain(use_pallas=True).init_state()`` for the same input format
and flags), so a JAX state converted to numpy loads into the port and back
unchanged, and the npz checkpoint format is the same file format.  The
four FIR histories of the JAX op path (hp/delay/deemph/audio-lp) stay zero
here, as they do on the JAX kernel engine.  With the waterfall on,
``wf_hist`` is c64 [w//2] as in the JAX state, and the port writes it and
``wf_cnt`` every step, so a JAX XLA-path engine resumes from a port state.
The trio (``fuse_band=False``) carries the duo's layout; with
``fuse_dc=False`` ``resamp_hist`` is the resampler's c64 [345] input
history, as in the JAX chain, and these conversions carry it both ways.

The dsd_in and single-channel chains carry the JAX mono engine's layouts
(scanner/dsd_in.py::DsdState, scanner/single.py::SingleState); their numpy
conversions below take and give the fields in PallasDsdState /
PallasSingleState order, so states pass between the packages both ways.

The time-sharded chains (parallel/) carry S streams' states at once: each
field of the same NamedTuple with a leading [S] dim (``stack_state``), the
layout of a JAX sharded chain's ``init_state(S)``.  The numpy conversions
take and give such a state unchanged, so a sharded state passes between
the packages both ways too.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from sdr_pmr446_tpu_torch import config as C
from sdr_pmr446_tpu_torch.scanner.dsd_in import DsdState
from sdr_pmr446_tpu_torch.scanner.single import SingleState


class ScannerState(NamedTuple):
    # front end (input rate)
    dc_x: torch.Tensor          # c64 []     IQ DC blocker x[-1]
    dc_y: torch.Tensor          # c64 []     IQ DC blocker y[-1]
    resamp_hist: torch.Tensor   # c64 [384|512] DC-blocked front history
    #                             ([345] resampler history, fuse_dc=False)
    # band rate (200 kHz)
    pfb_hist: torch.Tensor      # c64 [400]  channelizer history
    frame_parity: torch.Tensor  # i32 []     global PFB frame count mod 2
    # channel rate (12.5 kHz), per channel
    demod_prev: torch.Tensor    # c64 [16]   discriminator previous sample
    hp_hist: torch.Tensor       # f32 [16, 376]   (op path only: zero)
    delay_hist: torch.Tensor    # f32 [16, 188]   (op path only: zero)
    lp_dc_x: torch.Tensor       # f32 [16]   CTCSS-branch DC blocker
    lp_dc_y: torch.Tensor       # f32 [16]
    deemph_hist: torch.Tensor   # f32 [16, deemph_taps-1] (op path: zero)
    audio_lp_hist: torch.Tensor  # f32 [16, 102]  (op path only: zero)
    audio_hist: torch.Tensor    # f32 [16, 512|640] raw-demod history
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


#: the JAX op engine's FIR histories (use_pallas=False), zero on every
#: kernel engine and in every state the port writes
OP_ENGINE_HISTORIES = ("hp_hist", "delay_hist", "deemph_hist",
                       "audio_lp_hist")


def check_kernel_layout(state: ScannerState) -> None:
    """Raise ValueError if ``state`` carries the JAX op engine's layout (a
    non-zero FIR history of OP_ENGINE_HISTORIES): the port's chains would
    read its audio path wrongly, so such a checkpoint is refused, never
    reinterpreted (ROADMAP queue 1: the JAX op engines)."""
    for name in OP_ENGINE_HISTORIES:
        v = getattr(state, name)
        if v is not None and bool(torch.any(v != 0)):
            raise ValueError(
                f"checkpoint field {name!r} is non-zero: the state has the "
                f"JAX op engine's layout (use_pallas=False), which the "
                f"port's chains do not take yet")


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
    """A DsdInChain state as numpy arrays in the field order of the JAX
    mono engine's PallasDsdState."""
    return state_to_numpy(state)


def dsd_state_from_numpy(values, device):
    """A DsdState from numpy arrays in PallasDsdState's field order (a JAX
    mono-engine state's ``[np.asarray(v) for v in state]`` loads
    unchanged)."""
    return _fields_from_numpy(DsdState, values, device)


def single_state_to_numpy(state) -> list[np.ndarray]:
    """A SingleChannelChain state as numpy arrays in the field order of the
    JAX mono engine's PallasSingleState."""
    return state_to_numpy(state)


def single_state_from_numpy(values, device):
    """A SingleState from numpy arrays in PallasSingleState's field order."""
    return _fields_from_numpy(SingleState, values, device)
