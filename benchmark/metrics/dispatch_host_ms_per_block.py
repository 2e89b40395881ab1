"""dispatch_host_ms_per_block: host time inside the chain's step or
megastep calls per stream-block, over the window's untraced part (the
harness's clock around each call)."""


def read(window, cfg, mix):
    if not window.span_blocks:
        return None
    return window.step_s * 1e3 / window.span_blocks
