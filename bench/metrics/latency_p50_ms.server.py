"""latency_p50_ms.server: the median of the latencies that
``latency_p95_ms`` takes its tail from."""
from mnfbench.readers import latency_pct_ms


def read(run):
    return latency_pct_ms(run, 50)
