"""device_idle_pct: the share of the traced sub-window in which no kernel
and no copy ran on the card (the union of the profiler's device
intervals), in percent."""


def read(window, cfg, mix):
    if window.trace is None or window.trace_window_s <= 0:
        return None
    busy = window.trace["busy_s"]
    return 100.0 * (1.0 - busy / window.trace_window_s)
