"""The traffic and the inputs are functions of --seed: the same seed
gives the same schedule, pool order, images and weights."""
import numpy as np
import pytest
import torch

from bench_testlib import tiny_config
from mnfbench import inputs, loads, spec

SEEDS = (0, 7, 2**31 + 11, 2**40 + 3)


@pytest.mark.parametrize("seed", SEEDS)
def test_poisson_schedule_is_the_seeds(seed):
    t = spec.load_traffic("server_poisson")
    a = loads.schedule(t, seed, 30)
    b = loads.schedule(t, seed, 30)
    assert np.array_equal(a, b)
    assert len(a) == round(t["rate_per_s"] * 30)
    assert np.all(np.diff(a) >= 0) and a[0] >= 0 and a[-1] < 30
    other = loads.schedule(t, seed + 1, 30)
    assert len(other) == len(a) and not np.array_equal(a, other)


@pytest.mark.parametrize("mix", ["offline_b128", "stream_b1"])
def test_closed_loop_has_no_schedule_and_a_seeded_order(mix):
    t = spec.load_traffic(mix)
    assert t["loop"] == "closed" and len(loads.schedule(t, 5, 30)) == 0
    a = inputs.pool_order(t["pool"], 5)
    assert np.array_equal(a, inputs.pool_order(t["pool"], 5))
    assert sorted(a) == list(range(t["pool"]))
    assert not np.array_equal(a, inputs.pool_order(t["pool"], 6))


@pytest.mark.parametrize("seed", [3, 2**33 + 1])
def test_weights_and_images_are_the_seeds(seed):
    cfg = tiny_config()
    w1 = inputs.make_weights(cfg, seed, "cpu")
    w2 = inputs.make_weights(cfg, seed, "cpu")
    base = w1[0].data_ptr()
    for a, b, layer in zip(w1, w2, cfg["layers"]):
        assert (a is None) == (layer["kind"] == "pool")
        if a is not None:
            assert torch.equal(a, b) and a.is_contiguous()
            assert (a.data_ptr() - base) % 256 == 0
    x1 = inputs.make_pool(cfg, 8, seed, "cpu")
    assert torch.equal(x1, inputs.make_pool(cfg, 8, seed, "cpu"))
    assert x1.shape == (8, 8, 8, 3) and bool((x1 >= 0).all())
    zero = float((x1 == 0).float().mean())
    assert abs(zero - cfg["activation_sparsity"]) < 0.08
    flat = torch.cat([w.flatten() for w in w1 if w is not None])
    assert abs(float((flat == 0).float().mean())
               - cfg["weight_sparsity"]) < 0.05
    assert not torch.equal(x1, inputs.make_pool(cfg, 8, seed + 1, "cpu"))



def test_phases_give_each_stretch_its_own_count():
    t = {"arrival": "poisson", "phases": [[2.0, 100.0], [3.0, 10.0]]}
    a = loads.schedule(t, 9, 12.0)
    assert np.array_equal(a, loads.schedule(t, 9, 12.0))
    edges = [0, 2, 5, 7, 10, 12]
    rates = [100, 10, 100, 10, 100]
    for lo, hi, rate in zip(edges, edges[1:], rates):
        assert ((a >= lo) & (a < hi)).sum() == round(rate * (hi - lo))


def test_one_rate_is_one_phase():
    t = spec.load_traffic("server_poisson")
    one = dict(t, phases=[[30.0, t["rate_per_s"]]])
    assert np.array_equal(loads.schedule(t, 4, 30), loads.schedule(one, 4, 30))


def test_every_mix_and_config_finds_its_files_by_name():
    bench = spec.benchmark()
    for w in bench["workloads"]:
        t = spec.load_traffic(w["traffic"])
        assert callable(spec.loop(t["loop"]))
        if "arrival" in t:
            assert callable(spec.arrival(t["arrival"]))
        cfg = spec.load_config(w["config"])
        assert isinstance(spec.system(cfg["system"]), type)
