"""block_latency_p95_ms: the 95th percentile, over the blocks of the
window's untraced part, of the time from the entry taking a block from the
source to the block's last output on the host (host clock)."""

from benchlib.window import p95_ms


def read(window, cfg, mix):
    lat = window.latencies_s[:window.span_blocks]
    return p95_ms(lat) if lat else None
