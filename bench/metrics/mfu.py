"""mfu: the useful FLOPs of the requests the traced stretch completed
(counted from the reference's activations, ``mnfbench/work.py``) over
the stretch's seconds times the card's float32 peak, in percent."""
from mnfbench.readers import mfu_pct


def read(run):
    return mfu_pct(run)
