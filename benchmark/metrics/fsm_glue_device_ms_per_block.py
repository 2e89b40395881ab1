"""fsm_glue_device_ms_per_block: device time of every CUDA kernel that is
neither K1, K2 nor a copy (the FSM's phases A and C, the RSSI and audio
selects), per stream-block traced."""


def read(window, cfg, mix):
    if window.trace is None or not window.trace_blocks:
        return None
    return window.trace["parts_ms"]["other"] / window.trace_blocks
