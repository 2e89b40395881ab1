"""gather_host_ms_per_block: the host time of the cross-process gather of
each dispatch group's outputs (runtime/batch.py's ``batch.gather`` span,
over parallel/distributed.py's ``gather.stage``, the copy to the host, and
``gather.collective``, gloo and the copy back), per stream-block over the
window's untraced part, summed over the ranks: the ``gather_s`` that the
entry reads from the program's spans in a traced run.  Nothing where the
program records no such span."""


def read(window, cfg, mix):
    seconds = window.counters.get("gather_s")
    if seconds is None or not window.span_blocks:
        return None
    return seconds * 1e3 / window.span_blocks
