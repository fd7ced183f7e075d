"""kernels_per_frame.stream: device kernels launched in the traced
stretch per frame it completed."""
from mnfbench.readers import kernels_per_request


def read(run):
    return kernels_per_request(run)
