"""``correct`` holds the served logits to the reference: a run of the port
passes; the control (the reference in TF32 put in the program's place)
and each fault a serving cell can have, planted under the timed path,
fail.  The harness's look for a card is skipped: the tiny cell runs on
the port's CPU backend, through every other step of a run."""
import dataclasses
import functools

import pytest
import torch

from bench_testlib import tiny_cell
from mnfbench import cell as cell_mod
from mnfbench import spec
from mnfbench.control import ReferenceServe

SECONDS = 0.3
CnnServe = spec.system("cnn_serve")


class Faulty(CnnServe):
    """The port with one fault planted where its logits are produced
    (``ServeEngine.forward``, under the benchmark's span)."""

    def __init__(self, cfg, params, buckets, device, rec, *, fault):
        super().__init__(cfg, params, buckets, device, rec)
        forward = self.eng.forward
        state = {"last": None}

        def broken(*args, **kwargs):
            y = forward(*args, **kwargs).clone()
            if fault == "altered":
                y[0, 3] += 1e-3 * float(y[0].abs().max())
            elif fault == "half" and len(y) >= 2:
                h = len(y) // 2
                y[h:] = y[:h].mean(0)
            elif fault == "stale":
                # the output never updated: the last call's, or the
                # buffer's first zeros
                last, state["last"] = state["last"], y
                y = last if last is not None and last.shape == y.shape \
                    else torch.zeros_like(y)
            elif fault == "non_finite":
                y[-1, 0] = float("nan")
            return y

        self.eng.forward = broken


def run(cell, make_system=None, traced=False, seed=2**31 + 3):
    return cell_mod.run_cell(cell, seed, SECONDS, traced, device="cpu",
                             make_system=make_system)["result"]


@pytest.mark.parametrize("cell", ["vgg16_224.offline", "vgg16_224.server",
                                  "alexnet_224.stream"])
def test_the_port_is_correct(cell):
    base = cell.split(".")[0]
    out = run(tiny_cell(cell, base=base))
    assert out["correct"], out["compared"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "compared"
    assert set(out["metrics"]) == {m.name for m in
                                   spec.resolve(cell).end_to_end}


@pytest.mark.parametrize("base", ["vgg16_224", "alexnet_224"])
def test_the_tf32_control_is_not_correct(base):
    c = tiny_cell(f"{base}.offline", base=base)
    ctl = functools.partial(ReferenceServe,
                            reference=spec.reference("cnn"),
                            precision="tf32")
    out = run(c, ctl)
    gap = out["compared"]["logit_gap"]
    assert not out["correct"] and gap["value"] > gap["limit"], gap
    f32 = functools.partial(ReferenceServe,
                            reference=spec.reference("cnn"),
                            precision="f32")
    assert run(c, f32)["correct"]


@pytest.mark.parametrize("fault", ["altered", "half", "stale",
                                   "non_finite"])
def test_a_planted_fault_is_not_correct(fault):
    # no warm-up: its batches are the window's first images, which a stale
    # output would hand back right on a loaded host that runs one tick
    c = tiny_cell("vgg16_224.offline")
    c = dataclasses.replace(c, traffic=dict(c.traffic, warmup_s=0.0))
    out = run(c, functools.partial(Faulty, fault=fault))
    assert not out["correct"], (fault, out["compared"])


def test_a_traced_run_reports_its_per_layer_metrics_and_is_judged_alike():
    c = tiny_cell("vgg16_224.offline")
    out = run(c, traced=True)
    assert out["correct"]
    assert set(out["device"]) >= {"busy_s", "window_s"}
    # the CPU has no device trace: only the host-clock metrics are read
    assert set(out["metrics"]) == {"stage_ms.offline"}
    assert torch.isfinite(torch.tensor(out["metrics"]["stage_ms.offline"]
                                       ["value"]))
