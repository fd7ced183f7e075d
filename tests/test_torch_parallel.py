"""The port's collectives and parallel layouts over gloo on the CPU, in
worlds of 2 and 4 spawned ranks (``tests/_torch_ranks.py``; one spawn a
world, joined under a time limit, every check of this file reading its
results):

- ``quantized_psum`` and ``event_psum`` against sums taken in numpy: the
  quantized sum exactly (one shared scale, int32 codes, half to even),
  the fired sum within 1e-6 of max, each rank's residual exactly, fired
  plus residual its gradient plus old residual;
- ``pipeline_apply`` with one stage a rank, bitwise the stages run one
  after another;
- ``elastic_remesh`` + ``reshard_tree`` from (2, 2) to the (2, 1) of two
  survivors (and from (1, 2) to (1, 1) at 2 ranks): every leaf a
  DTensor, bitwise whole on the survivors;
- ``moe_apply_ep`` on a (2, 2) (and a (1, 2)) mesh on the weights of
  JAX's ``test_moe_ep_shard_map_matches_gspmd`` (deepseek-moe-16b
  reduced, f32, x (4, 16, d) x 0.3): y within 1e-5 of max of the port's
  ``moe_apply`` and of JAX's, the load-balance loss within 1e-6, every
  gradient (params and x, of sum(y r) + the load-balance loss) within
  1e-5 of max of ``moe_apply``'s, and one all-reduce a mesh axis of more
  than one rank (the ep sum; the data axis's statistics);
- ``checked_mesh`` in a world of ranks: the capacity error names the
  world, the fallback is 1x1, ``make_serve_mesh`` spans the world.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest

from _torch_ranks import (compression_rank, elastic_rank, mesh_rank,
                          moe_ep_rank, pipeline_rank, run_ranks, several)
from repro.configs import get_config as jget_config
from repro.models import moe as jmoe

K_FRAC = 0.05
MOE_KW = dict(compute_dtype="float32")
LM_KW = dict(d_ff=128, vocab_size=256, fsdp=True)


@functools.lru_cache(maxsize=None)
def _jax_moe():
    """JAX's MoE weights and input of ``test_moe_ep_shard_map_matches_gspmd``,
    as numpy, JAX's ``moe_apply`` output, and a seeded cotangent r."""
    cfg = dataclasses.replace(jget_config("deepseek-moe-16b").reduced(),
                              **MOE_KW)
    p, _ = jmoe.moe_init(jax.random.PRNGKey(0), cfg)
    x = jax.random.normal(jax.random.PRNGKey(1), (4, 16, cfg.d_model)) * 0.3
    y, aux = jmoe.moe_apply(p, x, cfg)
    p_np = jax.tree.map(np.asarray, p)
    r = np.random.default_rng(3).normal(size=x.shape).astype(np.float32)
    return p_np, np.asarray(x), r, np.asarray(y), float(aux[
        "load_balance_loss"])


@pytest.fixture(scope="module", params=[2, 4], ids=["2ranks", "4ranks"])
def world(request):
    n = request.param
    rng = np.random.default_rng(n)
    xs = rng.normal(size=(n, 4096)).astype(np.float32)
    res = (rng.normal(size=(n, 4096)) * 0.1).astype(np.float32)
    ws = (rng.normal(size=(n, 16, 16)) * 0.3).astype(np.float32)
    x = rng.normal(size=(6, 2, 16)).astype(np.float32)
    p_np, mx, mr, jy, jlb = _jax_moe()
    moe_mesh = (2, 2) if n == 4 else (1, 2)
    old = (2, 2) if n == 4 else (1, 2)
    jobs = [("compression", compression_rank, (xs, res, K_FRAC)),
            ("pipeline", pipeline_rank, (ws, x)),
            ("elastic", elastic_rank, ("qwen2-1.5b", LM_KW, old, 2 if n == 4
                                       else 1)),
            ("moe", moe_ep_rank, (moe_mesh, MOE_KW, p_np, mx, mr)),
            ("mesh", mesh_rank, ())]
    out = run_ranks(several, n, jobs, timeout=150)
    return dict(n=n, ranks=out, xs=xs, res=res, jax_y=jy, jax_lb=jlb,
                moe_mesh=moe_mesh)


def test_quantized_psum_matches_numpy(world):
    xs = world["xs"]
    scale = np.float32(np.abs(xs).max()) / np.float32(127)
    codes = np.clip(np.round(xs / scale), -128, 127).astype(np.int32)
    want = codes.sum(axis=0).astype(np.float32) * scale
    for out in world["ranks"]:
        np.testing.assert_array_equal(out["compression"]["q"], want)
        np.testing.assert_allclose(out["compression"]["plain"],
                                   xs.sum(axis=0), rtol=0, atol=1e-5)


def test_event_psum_matches_numpy(world):
    acc = world["xs"] + world["res"]
    k = int(acc.shape[1] * K_FRAC)
    fired = []
    for r, out in enumerate(world["ranks"]):
        theta = np.sort(np.abs(acc[r]))[::-1][k - 1]
        f = np.where(np.abs(acc[r]) >= theta, acc[r], np.float32(0))
        np.testing.assert_array_equal(out["compression"]["residual"],
                                      acc[r] - f)
        np.testing.assert_array_equal(out["compression"]["residual"] + f,
                                      acc[r])
        assert (f != 0).sum() <= k + (np.abs(acc[r]) == theta).sum() - 1
        fired.append(f)
    want = np.sum(fired, axis=0)
    for out in world["ranks"]:
        np.testing.assert_allclose(out["compression"]["total"], want,
                                   rtol=0, atol=1e-6 * np.abs(want).max())


def test_pipeline_apply_matches_sequential_stages(world):
    for out in world["ranks"]:
        np.testing.assert_array_equal(out["pipeline"]["y"],
                                      out["pipeline"]["ref"])
    assert world["ranks"][0]["pipeline"]["y"].shape == (6, 2, 16)


def test_elastic_remesh_and_reshard_are_bitwise(world):
    survivors = 2 if world["n"] == 4 else 1
    for rank, out in enumerate(world["ranks"]):
        e = out["elastic"]
        assert e["shape"] == (survivors, 1)
        assert e["names"] == ("data", "model")
        if rank < survivors:
            assert e["dtensor"] and e["equal"]
            assert len(e["new"]) == len(e["old"])
    # the old mesh shards the embedding over both axes (fsdp)
    assert any(len({str(p) for p in pl}) == 2
               for pl in world["ranks"][0]["elastic"]["old"])


def test_moe_apply_ep_matches_moe_apply_and_jax(world):
    for out in world["ranks"]:
        m = out["moe"]
        assert m["ep"]
        scale = np.abs(m["y_ref"]).max()
        np.testing.assert_allclose(m["y"], m["y_ref"], rtol=0,
                                   atol=1e-5 * scale)
        np.testing.assert_allclose(m["y"], world["jax_y"], rtol=0,
                                   atol=1e-5 * np.abs(world["jax_y"]).max())
        assert abs(m["lb"] - m["lb_ref"]) <= 1e-6
        assert abs(m["lb"] - world["jax_lb"]) <= 1e-6
        assert m["drop"] == 0.0


def test_moe_apply_ep_gradients_match_moe_apply(world):
    for out in world["ranks"]:
        m = out["moe"]
        assert len(m["grads"]) == len(m["grads_ref"])
        for g, gr in zip(m["grads"], m["grads_ref"]):
            np.testing.assert_allclose(g, gr, rtol=0,
                                       atol=1e-5 * np.abs(gr).max())


def test_moe_apply_ep_all_reduces_once_an_axis(world):
    """One all-reduce over the ep axis (the token-sized sum); the data
    axis's load-balance statistics add one where it has two ranks."""
    want = 1 + (world["moe_mesh"][0] > 1)
    assert all(out["moe"]["all_reduce"] == want for out in world["ranks"])


def test_checked_mesh_in_a_world_of_ranks(world):
    n = world["n"]
    for out in world["ranks"]:
        m = out["mesh"]
        assert f"needs {2 * n} ranks but only {n} exist" in m["error"]
        assert f"torchrun --nproc-per-node {2 * n}" in m["error"]
        shape, warned = m["fallback"]
        assert shape == (1, 1) and any("Falling back" in w for w in warned)
        assert m["serve"] == ((n, 1), ("data", "model"))
