"""kernel_roofline: the sum over the stretch's batches and their layers
of max(operations / f32 peak, bytes / HBM bandwidth), over the device's
busy time in the stretch, in percent."""
from mnfbench.readers import roofline_pct


def read(run):
    return roofline_pct(run)
