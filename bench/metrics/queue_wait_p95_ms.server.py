"""queue_wait_p95_ms.server: the 95th percentile of the time from a
request's due time to the start of its batch (the engine's ``forward``
call for it begins), from the benchmark's spans; nothing where a served
request has no batch span."""
from mnfbench.readers import queue_waits_ms
from mnfbench.records import percentile


def read(run):
    waits = queue_waits_ms(run)
    return None if waits is None else percentile(waits, 95)
