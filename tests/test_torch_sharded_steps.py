"""The port's sharded steps over gloo on the CPU (``launch.steps`` with a
mesh; ``tests/_torch_ranks.py`` spawns the worlds, joined under a time
limit), each against the port's single-device step — which the other
tests hold against JAX:

- one train step on a (2, 2) mesh of 4 ranks, reduced qwen2-1.5b with
  d_ff 128, vocab 256 and FSDP on (``tests/test_distributed.py``'s JAX
  config; compute in f32, the QKV biases and norm gains seeded off their
  constant init): the loss within 1e-6 relative (JAX's own test allows
  5e-2), the grad norm within 1e-5, each leaf's first moment within 1e-5
  of its max (the gradient), each leaf's new value within 1e-4 of its
  max (AdamW's first step divides each gradient by its own magnitude, so
  reduction-order noise in tiny gradients shows there), and every param
  and moment a DTensor under the placements its logical axes resolve to;
- a prefill and two decode steps on a (1, 2) mesh of qwen2-0.5b (kv
  heads over the model axis): logits and every cache leaf within 1e-5
  of max, the cache DTensors under ``cache_axes``' placements; and
  Hymba's (B10 on each rank's shard, B8 on the whole tensors);
- LeNet-300-100 served batch-parallel on 2 data ranks: logits bitwise
  the mesh-less plan's at batches 1 (whole on each rank), 2 and 4, and a
  ``ServeEngine`` on the mesh bitwise one off it;
- ``launch.train`` in a world of 2 ranks: its own (1, 2) mesh,
  DTensor state, one step, then a run that resumes from the checkpoint
  rank 0 wrote and takes one more.
"""
import dataclasses

import numpy as np
import pytest

from _torch_ranks import (cnn_serve_rank, decode_rank, run_ranks, several,
                          train_driver_rank, train_step_rank)
from repro_torch.configs import get_config
from repro_torch.models import transformer as ttfm
from repro_torch.parallel import sharding as tsh

TRAIN_KW = dict(d_ff=128, vocab_size=256, fsdp=True, compute_dtype="float32")
F32 = dict(compute_dtype="float32")


def _rel(a, b) -> float:
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.fixture(scope="module")
def four():
    return run_ranks(several, 4, [
        ("train", train_step_rank, ((2, 2), TRAIN_KW, 32, 8))],
        timeout=180)


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    ckpt = str(tmp_path_factory.mktemp("ckpt"))
    return run_ranks(several, 2, [
        ("decode", decode_rank, ((1, 2), "qwen2-0.5b", F32, 6, 2)),
        ("hymba", decode_rank, ((1, 2), "hymba-1.5b", F32, 6, 2)),
        ("lenet", cnn_serve_rank, ("lenet", (1, 2, 4))),
        ("driver", train_driver_rank, (ckpt, "qwen2-0.5b"))],
        timeout=180)


def test_sharded_train_step_matches_single_device(four):
    for out in four:
        t = out["train"]
        assert abs(t["loss"] - t["loss_ref"]) <= 1e-6 * abs(t["loss_ref"])
        assert abs(t["grad_norm"] - t["grad_norm_ref"]) \
            <= 1e-5 * t["grad_norm_ref"]
        for m, mr in zip(t["mu"], t["mu_ref"]):
            assert _rel(m, mr) <= 1e-5
        for p, pr in zip(t["params"], t["params_ref"]):
            assert _rel(p, pr) <= 1e-4


def test_sharded_train_step_keeps_its_placements(four):
    """After a step every param and first moment is a DTensor, each
    param under the placements ``logical_to_pspec`` resolves for its
    axes on the (2, 2) mesh — the FSDP embedding over both axes."""
    from torch.distributed.tensor import Replicate, Shard
    cfg = dataclasses.replace(get_config("qwen2-1.5b").reduced(), **TRAIN_KW)
    mesh = tsh.MeshShape((2, 2), ("data", "model"))
    rules = tsh.make_rules(mesh, fsdp=True, seq_shard=cfg.seq_shard)
    shapes = ttfm.tree_map(lambda t: tuple(t.shape),
                           ttfm.init_params(0, cfg, "meta"))
    want = []

    def walk(axes, sh):
        for k in axes:
            if isinstance(axes[k], dict):
                walk(axes[k], sh[k])
            else:
                want.append(tuple(tsh.to_placements(tsh.logical_to_pspec(
                    axes[k], sh[k], mesh, rules), mesh)))
    walk(ttfm.param_axes(cfg), shapes)
    for out in four:
        t = out["train"]
        assert all(t["dtensor"])
        assert t["placements"] == want == t["plan_placements"]
        assert t["mu_placements"] == want
    assert want[0] == (Shard(1), Shard(0))         # tok: embed, vocab
    assert (Shard(1), Replicate()) in want         # a norm gain, FSDP


@pytest.mark.parametrize("part", ["decode", "hymba"])
def test_prefill_and_decode_on_a_mesh_match_one_device(two, part):
    for out in two:
        d = out[part]
        assert d["mesh"]["dtensor"]
        for a, b in zip(d["mesh"]["logits"], d["ref"]["logits"]):
            assert _rel(a, b) <= 1e-5
        assert len(d["mesh"]["cache"]) == len(d["ref"]["cache"])
        for a, b in zip(d["mesh"]["cache"], d["ref"]["cache"]):
            assert np.abs(a - b).max() <= 1e-5 * max(np.abs(b).max(), 1.0)


def test_decode_cache_placements_follow_cache_axes(two):
    """qwen2-0.5b's reduced K/V caches (L, B, S, KH 2, D) on the (1, 2)
    mesh: batch on data, the two kv heads over model."""
    pl = two[0]["decode"]["mesh"]["placements"]
    assert pl == ["(Shard(dim=1), Shard(dim=3))"] * 2


def test_batch_parallel_lenet_serve_is_bitwise(two):
    for out in two:
        s = out["lenet"]
        for b in (1, 2, 4):
            np.testing.assert_array_equal(s[b]["y"], s[b]["y_ref"])
        assert [s[b]["shards"] for b in (1, 2, 4)] == [1, 2, 2]
        assert [s[b]["local_rows"] for b in (1, 2, 4)] == [1, 1, 2]
        assert s[1]["input_sharding"] == "[Replicate(), Replicate()]"
        assert s[4]["input_sharding"] == "[Shard(dim=0), Replicate()]"
        e = s["engine"]
        np.testing.assert_array_equal(e["y"], e["y_ref"])
        assert e["devices"] == 2 and e["data_shards"] == {1: 1, 2: 2, 4: 2}


def test_train_driver_in_a_world_of_two(two):
    first, second = (two[0]["driver"][k] for k in (1, 2))
    assert first["mesh"] == second["mesh"] == (1, 2)
    assert first["dtensor"] and second["dtensor"]
    assert first["final_step"] == 1 and len(first["losses"]) == 1
    # the second run resumed at step 1: one more step, from the saved state
    assert second["final_step"] == 2 and len(second["losses"]) == 1
    # the step is counted on the mesh: this rank's share, the collectives
    # it issues over the (1, 2) mesh's model axis
    rep = first["report"]
    assert (rep.mesh, rep.chips) == ("1x2", 2)
    assert rep.coll_gbytes > 0 and rep.t_collective > 0
    assert rep.coll_breakdown and rep.hlo_gflops > 0
    assert np.isfinite(first["losses"] + second["losses"]).all()
    ranks = [two[r]["driver"][2]["whole"] for r in (0, 1)]
    for a, b in zip(*ranks):
        np.testing.assert_array_equal(a, b)
