"""An open loop: requests are due on the mix's arrival schedule whatever
the system does.  Each is submitted at the first step after it is due
(the lateness is recorded), each tick drains what is pending, and the
run ends when every request due in the window has its logits, or
``LATE_S`` after the window closed, whichever comes first: a request
still unanswered then has failed."""
import time

from mnfbench.loads import schedule

clock = time.perf_counter

#: how long after the window's close the loop waits for the last answers
LATE_S = 60.0


def drive(win, traffic: dict, seed: int, seconds: float) -> None:
    offsets = schedule(traffic, seed, seconds)
    n, i = len(offsets), 0
    win.open(seconds)
    due = win.rec.t0 + offsets
    give_up = win.rec.t_close + LATE_S
    while (i < n or win.pending()) and clock() < give_up:
        now = clock()
        while i < n and due[i] <= now:
            win.submit(float(due[i]))
            i += 1
        if win.pending():
            win.tick()
        elif i < n:
            time.sleep(max(0.0, due[i] - clock()))
