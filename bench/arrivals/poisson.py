"""Poisson arrivals, conditioned on their count, so every seed offers the
same work in another order: ``round(rate * length)`` due times spread
uniformly over each stretch of the window.

Parameters: ``rate_per_s``, one rate through the window; or ``phases``,
``[[seconds, rate_per_s], ...]`` repeated in turn until the window ends
(an ON/OFF source, such as bursts: ``[[2.0, 600.0], [3.0, 50.0]]``)."""
import numpy as np

from mnfbench.inputs import subseed


def offsets(traffic: dict, seed: int, seconds: float) -> np.ndarray:
    rng = np.random.default_rng(subseed(seed, "arrivals"))
    phases = traffic.get("phases") or [[seconds, traffic["rate_per_s"]]]
    out, t, k = [], 0.0, 0
    while t < seconds:
        length, rate = phases[k % len(phases)]
        if float(length) <= 0:
            raise ValueError(f"phase of {length} s")
        hi = min(seconds, t + float(length))
        out.append(rng.uniform(t, hi, int(round(rate * (hi - t)))))
        t, k = hi, k + 1
    return np.sort(np.concatenate(out)) if out else np.zeros(0)
