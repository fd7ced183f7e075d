"""A closed loop: before every tick exactly ``batch`` requests are
submitted, each due when it is submitted, and the next tick starts when
the last one's logits are on the host.  ``batch`` 1 is one client, frame
by frame; a full bucket is an offline job that keeps the queue full."""
import time

clock = time.perf_counter


def drive(win, traffic: dict, seed: int, seconds: float) -> None:
    batch = int(traffic["batch"])
    win.open(seconds)
    while clock() < win.rec.t_close:
        for _ in range(batch):
            win.submit()
        win.tick()
