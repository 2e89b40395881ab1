"""batch_fetch_ms_per_block: the host time of the read-back of each
dispatch group's outputs (runtime/batch.py's ``batch.fetch`` span:
HostFetch's wait for the group's event and its copies to the host), per
stream-block over the window's untraced part, summed over the ranks: the
``fetch_s`` that the entry reads from the program's spans in a traced
run.  Nothing where the program records no such span."""


def read(window, cfg, mix):
    seconds = window.counters.get("fetch_s")
    if seconds is None or not window.span_blocks:
        return None
    return seconds * 1e3 / window.span_blocks
