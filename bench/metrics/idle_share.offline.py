"""idle_share.offline: the share of a tick in which the device runs no
kernel or copy, in percent: 1 - (device busy time a tick in the traced
stretch) / (host time a tick over the set-up's warm ticks, before the
profiler is first started), so the profiler's own cost on the host is
not read as idle."""
from mnfbench.readers import idle_pct


def read(run):
    return idle_pct(run)
