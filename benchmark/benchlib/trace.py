"""The device trace of a run's traced sub-window, and its reduction.

``Tracer`` runs torch.profiler (CPU and CUDA activities) over a stretch of
whole dispatches: the device is synchronized before the profiler starts
and before it stops, so every device event in the trace belongs to work
dispatched inside it.  ``reduce`` turns the raw events into what the
per-layer readers take: the device's busy time (the union of its kernel
and copy intervals), device time by part (K1, K2, copies, the rest) and
by kernel, and the idle gaps named by the harness span the host was in.

The grouping by name is a frozen copy of chip_smoke.py's ``kernel_name`` /
``device_group`` (PyTorch's anonymous-namespace kernels kept apart): K1 is ``duo_*``, ``fe_*`` and ``pfb_*``, K2 ``ab_*``, and
the DC carry scan (``dc_carry_kernel``), which both launch, goes to the
kernel whose part precedes it on the stream.
"""

from __future__ import annotations

import bisect
import time

import torch

#: the parts of a scanner step, by the name prefixes of its device events
PARTS = (("K1", ("duo_", "fe_", "pfb_")), ("K2", ("ab_",)),
         ("copies", ("Memcpy", "Memset")))
SHARED = ("dc_carry",)
#: harness spans (record_function names) that name an idle gap
SPAN_PREFIX = "bench:"


def kernel_name(name: str) -> str:
    """A device event's function name, template arguments kept (PyTorch's
    ``(anonymous namespace)`` kept out of the cut at the argument list)."""
    name = name.removeprefix("void ").replace("(anonymous namespace)", "anon")
    return name.split("(")[0][:160]


def part_of(name: str) -> str:
    fn = kernel_name(name).split("<")[0]
    for label, prefixes in PARTS:
        if fn.startswith(prefixes):
            return label
    if fn.startswith(SHARED):
        return "shared"
    return "other"


class Tracer:
    """One profiler session over whole dispatches (``begin`` / ``end``)."""

    def __init__(self, device):
        self.device = device
        self.prof = None
        self.window_s = 0.0
        self.events: list = []

    def begin(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize(self.device)
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.start()
        self._t0 = time.perf_counter()

    def end(self) -> None:
        torch.cuda.synchronize(self.device)
        self.window_s = time.perf_counter() - self._t0
        self.prof.stop()
        self.events = [(e.name(), _kind(e), e.start_ns(),
                        e.start_ns() + e.duration_ns())
                       for e in self.prof.profiler.kineto_results.events()]
        self.prof = None


class Stretch:
    """The traced stretch of a window: the tracer starts at the first
    dispatch at or after ``start`` and stops at the first at or after
    ``stop`` (or at ``finish``); ``began`` is when it started, the end of
    the window's untraced part."""

    def __init__(self, tracer: Tracer, start: float, stop: float):
        self.tracer, self.start, self.stop = tracer, start, stop
        self.began = None

    @property
    def on(self) -> bool:
        return self.tracer.prof is not None

    def at_dispatch(self, now: float) -> None:
        if not self.on and self.began is None and now >= self.start:
            self.began = now
            self.tracer.begin()
        elif self.on and now >= self.stop:
            self.tracer.end()

    def finish(self) -> None:
        if self.on:
            self.tracer.end()


def _kind(e) -> str:
    """"device" for a kernel or copy, "host" for a host event, "annotation"
    for a range's device-side annotation (no device work)."""
    if e.device_type() != torch.autograd.DeviceType.CUDA:
        return "host"
    if e.is_user_annotation() or e.name().startswith(SPAN_PREFIX):
        return "annotation"
    return "device"


def reduce(events: list, outside: str = "host outside the harness's spans"
           ) -> dict:
    """events: (name, kind (``_kind``), start ns, end ns).  Returns busy_s,
    ms by part (K1, K2, copies, other), seconds by kernel and the idle
    gaps' seconds by the innermost harness span over each gap's middle
    (``outside`` where none is)."""
    dev = sorted((e for e in events if e[1] == "device"),
                 key=lambda e: e[2])
    parts = {"K1": 0.0, "K2": 0.0, "copies": 0.0, "other": 0.0}
    kernels: dict = {}
    last = "other"
    busy, end = 0, None
    gaps = []
    for name, _, a, b in dev:
        label = part_of(name)
        if label == "shared":
            label = last if last in ("K1", "K2") else "other"
        elif label in ("K1", "K2"):
            last = label
        parts[label] += (b - a) / 1e6
        kn = kernel_name(name)
        kernels[kn] = kernels.get(kn, 0.0) + (b - a) / 1e9
        if end is not None and a > end:
            gaps.append((end, a))
        busy += max(0, b - max(a, end if end is not None else a))
        end = b if end is None else max(end, b)
    spans = sorted((a, b, name) for name, kind, a, b in events
                   if kind == "host" and name.startswith(SPAN_PREFIX)
                   and b > a)
    starts = [s[0] for s in spans]
    by_span: dict = {}
    for a, b in gaps:
        mid = (a + b) / 2
        i = bisect.bisect_right(starts, mid)
        # harness spans nest a few deep: the last ones opened before mid
        inner = [s for s in spans[max(0, i - 16):i] if mid <= s[1]]
        label = (min(inner, key=lambda s: s[1] - s[0])[2] if inner
                 else outside)
        by_span[label] = by_span.get(label, 0.0) + (b - a) / 1e9
    return {"busy_s": busy / 1e9, "parts_ms": parts, "kernels_s": kernels,
            "idle_by_span_s": by_span, "device_events": len(dev)}


def top(d: dict, n: int = 10) -> list:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
