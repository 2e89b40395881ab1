"""k1_duo_roofline: K1's bound a call (benchlib/work.py at the
configuration's sizes) over its device time a call in the trace, summed
over its CUDA kernels by name (trace.PARTS), in percent.  Nothing when the
trace holds no K1 kernel."""

from benchlib import work


def read(window, cfg, mix):
    if window.trace is None or not window.trace_blocks:
        return None
    ms = window.trace["parts_ms"]["K1"]
    if ms <= 0:
        return None
    return 100.0 * work.k1_bound_ms(cfg) * window.trace_blocks / ms
