"""Host-side streaming driver: wire blocks in, audio and events out.

Counterpart of sdr_pmr446_tpu/runtime/driver.py (ScannerDriver.run /
_drain / _event_lines): feeds fixed-size blocks of raw capture bytes to the
scanner step, drains the per-sub-chunk outputs, renders the reference-format
log lines for tune/detune/change/CTCSS events (src/sdr_pmr446.c:838-862,
614-626) and accumulates the active channel's audio.

The step is asynchronous on a CUDA device, so block i+1 is dispatched
before block i's outputs are read back: the host-side drain overlaps the
device's work.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Iterable, List, Optional

import numpy as np
import torch

from sdr_pmr446_tpu_torch import config as C
from sdr_pmr446_tpu_torch import device as devices
from sdr_pmr446_tpu_torch.scanner.chain import (ScannerChain,
                                                make_runtime_params,
                                                outputs_to_numpy)

log = logging.getLogger("sdr_pmr446")

ENGINES = ("auto", "cuda", "torch")


def resolve_engine(engine: str, device) -> str:
    """'cuda' = the hand-written kernels (CUDA devices only), 'torch' = the
    kernels' plain PyTorch versions (the CPU only); 'auto' follows the
    device."""
    dev = devices.resolve(device)
    if engine in (None, "auto"):
        engine = "cuda" if dev.type == "cuda" else "torch"
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}")
    if engine == "cuda" and dev.type != "cuda":
        raise ValueError(f"engine 'cuda' needs a CUDA device, got {dev}")
    if engine == "torch" and dev.type != "cpu":
        raise ValueError(f"engine 'torch' (the plain versions) runs on the "
                         f"CPU, got {dev}")
    return engine


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


class ScannerDriver:
    def __init__(self, args: Optional[C.ScannerArgs] = None,
                 subchunks_per_step: int = 10, input_format: str = "cu8",
                 device="cuda", engine: str = "auto"):
        self.args = args or C.ScannerArgs()
        if self.args.waterfall > 0:
            raise ValueError("the waterfall is not yet ported to "
                             "sdr_pmr446_tpu_torch")
        self.engine = resolve_engine(engine, device)
        self.device = torch.device(device)
        self.chain = ScannerChain(
            C.BlockConfig(subchunks_per_step), lowpass=self.args.lowpass,
            fir_deemph=self.args.fir_deemph, input_format=input_format,
            device=self.device)
        self.params = make_runtime_params(self.args, self.device)
        self.state = self.chain.init_state()
        self.block_index = 0
        self.subchunk = 0

    @property
    def feed_len(self) -> int:
        """Wire bytes run() expects per block."""
        return self.chain.step_arg_len

    def run(self, blocks: Iterable[np.ndarray]) -> ScanResult:
        """Scan blocks of raw wire bytes (each ``feed_len`` bytes)."""
        acc = dict(audio=[], audio_sub=[], active=[], rssi=[], rel=[],
                   det=[], idx=[], events=[])
        pending = None
        for blk in blocks:
            raw = np.ascontiguousarray(blk).view(np.uint8).reshape(-1)
            wire = torch.from_numpy(raw).to(self.device)
            self.state, out = self.chain.step(self.state, wire, self.params)
            if pending is not None:
                self._drain(pending, acc)
            pending = out
            self.block_index += 1
        if pending is not None:
            self._drain(pending, acc)
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
            events=acc["events"])

    def _drain(self, out, acc) -> None:
        o = outputs_to_numpy(out)
        k = len(o["active_chan"])
        for i in range(k):
            for m in self._event_lines(o, i):
                acc["events"].append(m)
                log.info(m)
            if o["audio_valid"][i]:
                acc["audio"].append(o["audio"][i])
                acc["audio_sub"].append(self.subchunk + i)
        acc["active"].append(o["active_chan"])
        acc["rssi"].append(o["rssi_db"])
        acc["rel"].append(o["rel_rssi"])
        acc["det"].append(o["ct_detected"])
        acc["idx"].append(o["ct_max_idx"])
        self.subchunk += k

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
