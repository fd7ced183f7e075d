"""setup_s: from the process's start to the window's opening (weights,
images, the system built and its graphs captured, warm ticks)."""


def read(run):
    return run.setup_s
