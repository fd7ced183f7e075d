"""idle_share.stream: as ``idle_share.offline``, in the stream cell, a
tick being one frame.  Once the profiler is loaded a frame costs the
host ~1.2 ms more through the whole run, and a traced frame's graph
launch about twice as long, so the host time is read from the warm
frames before the profiler's first start."""
from mnfbench.readers import idle_pct


def read(run):
    return idle_pct(run)
