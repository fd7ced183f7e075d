"""stage_ms.offline: the mean of the benchmark's span around each batch's
staging (``ServeEngine.stage``: the pad and copy into the pinned
buffer), over the window's batches."""
from mnfbench.readers import stage_mean_ms


def read(run):
    return stage_mean_ms(run)
