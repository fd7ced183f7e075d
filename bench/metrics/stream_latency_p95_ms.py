"""stream_latency_p95_ms: the 95th percentile over every frame of the
window, from its submission to its logits on the host."""
from mnfbench.readers import latency_pct_ms


def read(run):
    return latency_pct_ms(run, 95)
