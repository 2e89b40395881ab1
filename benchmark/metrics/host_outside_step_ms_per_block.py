"""host_outside_step_ms_per_block: the untraced part of the window's wall
time minus the time inside the step calls, per stream-block: the ring's
host copy and its waits, the upload, the drain with any wait for the card,
and the driver's per-sub-chunk loop."""


def read(window, cfg, mix):
    if not window.span_blocks:
        return None
    return (window.span_wall_s - window.step_s) * 1e3 / window.span_blocks
