"""Throughput meter, JSONL metrics records and a profiler trace.

Counterpart of sdr_pmr446_tpu/utils/profiling.py, rewritten on PyTorch:

  - ``ThroughputMeter``: per-block host-clock timings -> samples/s and the
    real-time multiple (the caller ends each timed block in a
    synchronize, since a CUDA step returns before the card finishes);
  - ``log_jsonl``: append one structured record a line (the driver's
    per-sub-chunk metrics, runtime/driver.py);
  - ``trace``: ``torch.profiler`` around a code region, its Chrome trace
    written to ``<log_dir>/trace.json`` (CUDA activity too when a card is
    present), in place of ``jax.profiler``'s XProf trace.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from typing import Optional

import torch

from sdr_pmr446_tpu_torch import config as C


@dataclasses.dataclass
class ThroughputMeter:
    """Accumulates per-block timings -> samples/s statistics."""

    samples_per_block: int
    blocks: int = 0
    total_time: float = 0.0
    _t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self):
        if self._t0 is None:
            raise RuntimeError("ThroughputMeter.stop() without start()")
        self.total_time += time.perf_counter() - self._t0
        self.blocks += 1
        self._t0 = None

    @property
    def samples_per_sec(self) -> float:
        if self.total_time == 0:
            return 0.0
        return self.samples_per_block * self.blocks / self.total_time

    @property
    def realtime_multiple(self) -> float:
        return self.samples_per_sec / C.SDR_SAMPLERATE

    def report(self) -> dict:
        return {
            "blocks": self.blocks,
            "samples_per_sec": self.samples_per_sec,
            "realtime_multiple": self.realtime_multiple,
            "ms_per_block": (1e3 * self.total_time / max(self.blocks, 1)),
        }


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the body with torch.profiler; the Chrome trace (chrome://
    tracing, Perfetto) goes to ``<log_dir>/trace.json``.  Yields the
    profiler, whose ``key_averages()`` the caller may read."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def log_jsonl(path: str, record: dict) -> None:
    """Append one structured metrics record (per-sub-chunk event stream)."""
    with open(path, "a") as f:
        f.write(json.dumps(record) + "\n")
