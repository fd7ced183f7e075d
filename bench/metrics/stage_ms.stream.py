"""stage_ms.stream: as ``stage_ms.offline``, one frame a batch."""
from mnfbench.readers import stage_mean_ms


def read(run):
    return stage_mean_ms(run)
