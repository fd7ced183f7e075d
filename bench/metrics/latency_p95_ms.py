"""latency_p95_ms: the 95th percentile over every request due in the
window, from its due time to its logits on the host."""
from mnfbench.readers import latency_pct_ms


def read(run):
    return latency_pct_ms(run, 95)
