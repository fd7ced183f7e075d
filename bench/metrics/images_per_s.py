"""images_per_s: requests completed in the window over the window's
seconds (from its opening to the last logits on the host)."""


def read(run):
    n = len(run.completed())
    return n / run.window_s if n and run.window_s > 0 else None
