"""The port's serving tier (``repro_torch.serving``) against the JAX
package's (``repro.serving``) on the CPU, the same numpy inputs through
both:

- the batcher: ``smallest_bucket``, ``plan_tick``, FIFO across ticks
  under a budget and without one, request stamps, on the same arrival
  sequences; no starvation under a budget; ``pad_bucket`` bitwise;
- a ``ServeEngine(device="cpu")`` on MINI@8 and MLP_MINI with buckets
  (1, 2, 4) and the JAX weights (``params_from_numpy``): padding bitwise
  per bucket and against the unpadded forward, padding rows cannot leak
  (the staging buffer is re-zeroed), captures (here first calls) flat
  over ticks (1, 3, 0, 4, 2), completions FIFO with latency,
  ``boundary_report`` and ``stats()`` keys and counts exactly the JAX
  engine's, served logits within 5e-3 and 1e-4·max of the JAX engine's;
- ``make_cnn_serve_step``'s boundaries exactly JAX's;
- ``launch.serve --smoke`` and ``--mlp mini`` exit 0 on the CPU.
The engine on the card: ``tests/test_torch_cuda.py``.
"""
import json

import jax
import numpy as np
import pytest
import torch

from repro import serving as jserving
from repro.launch import steps as jsteps
from repro.models import cnn as jcnn
from repro.models import mlp as jmlp
from repro_torch import serving as tserving
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.models import cnn as tcnn
from repro_torch.models import mlp as tmlp

BUCKETS = (1, 2, 4)
TICKS = (1, 3, 0, 4, 2)


# -- the batcher, against the JAX package's -----------------------------------

@pytest.mark.parametrize("buckets", [tserving.DEFAULT_BUCKETS, BUCKETS])
def test_smallest_bucket_equals_jax(buckets):
    assert tserving.DEFAULT_BUCKETS == jserving.DEFAULT_BUCKETS
    for n in range(1, buckets[-1] + 2):
        try:
            want = jserving.smallest_bucket(n, buckets)
        except ValueError:
            with pytest.raises(ValueError, match="exceeds the largest"):
                tserving.smallest_bucket(n, buckets)
            continue
        assert tserving.smallest_bucket(n, buckets) == want


@pytest.mark.parametrize("budget", [None, 1, 2])
def test_plan_tick_equals_jax(budget):
    jb = jserving.ContinuousBatcher(jserving.DEFAULT_BUCKETS,
                                    max_batches_per_tick=budget)
    tb = tserving.ContinuousBatcher(tserving.DEFAULT_BUCKETS,
                                    max_batches_per_tick=budget)
    for pending in (0, 1, 2, 5, 8, 9, 32, 33, 128, 129, 200, 300, 517):
        assert tb.plan_tick(pending) == jb.plan_tick(pending), pending


def _drain(batcher, arrivals):
    """Feed ``arrivals`` a tick, drain each tick under the batcher's budget;
    [(tick, bucket, rids, arrival ticks)]."""
    log = []
    for n in arrivals:
        for _ in range(n):
            batcher.submit(None)
        budget = batcher.max_batches_per_tick
        taken = 0
        while budget is None or taken < budget:
            batch = batcher.next_batch()
            if batch is None:
                break
            taken += 1
            bucket, reqs = batch
            log.append((batcher.tick, bucket, [r.rid for r in reqs],
                        [r.arrival_tick for r in reqs]))
            assert all(r.bucket == bucket for r in reqs)
        batcher.end_tick()
    return log


@pytest.mark.parametrize("budget", [None, 1])
@pytest.mark.parametrize("seed", [0, 1])
def test_fifo_across_ticks_equals_jax(seed, budget):
    arrivals = np.random.default_rng(seed).integers(0, 40, size=12).tolist()
    want = _drain(jserving.ContinuousBatcher(
        (1, 8, 32), max_batches_per_tick=budget), arrivals)
    got = _drain(tserving.ContinuousBatcher(
        (1, 8, 32), max_batches_per_tick=budget), arrivals)
    assert got == want
    rids = [rid for _, _, batch, _ in got for rid in batch]
    assert rids == list(range(len(rids)))           # FIFO, none passed over


def test_no_starvation_under_budget():
    """With a 1-batch tick budget and sustained overload, completion order
    is still exactly submission order: no request is passed over."""
    b = tserving.ContinuousBatcher((1, 2), max_batches_per_tick=1)
    done = []
    for _ in range(6):
        for _ in range(3):
            b.submit(None)
        batch = b.next_batch()
        if batch:
            done.extend(r.rid for r in batch[1])
        b.end_tick()
    assert done == list(range(len(done)))
    assert min(r.rid for r in b._queue) == len(done)


def test_request_stamps_equal_jax():
    out = []
    for mod in (jserving, tserving):
        b = mod.ContinuousBatcher(BUCKETS)
        r = b.submit(None, submit_time=1.5)
        b.end_tick()
        r2 = b.submit(None)
        _, reqs = b.next_batch()
        out.append([(q.rid, q.arrival_tick, q.submit_time, q.bucket,
                     q.completion_tick, q.latency_s, q.result)
                    for q in (r, r2)] + [len(reqs)])
    assert out[0] == out[1]
    assert out[1][0][:3] == (0, 0, 1.5) and out[1][1][:2] == (1, 1)


@pytest.mark.parametrize("into", [None, "dirty buffer"])
def test_pad_bucket_bitwise_jax(into):
    """``pad_bucket`` is JAX's bitwise, also written into a buffer that
    held an earlier batch (as the engine stages every batch)."""
    rng = np.random.default_rng(0)
    imgs = [np.maximum(rng.normal(size=(3, 3, 2)), 0).astype(np.float32)
            for _ in range(3)]
    out = None if into is None else torch.full((4, 3, 3, 2), 7.0)
    got = tserving.pad_bucket(imgs, 4, out=out)
    assert out is None or got is out
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    want = jserving.pad_bucket(imgs, 4)
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))
    assert not got[3:].any()


# -- the engine, against the JAX package's ------------------------------------

def _net(name):
    """(JAX spec, port spec, JAX params, port params, 16 requests)."""
    rng = np.random.default_rng(0)
    if name == "mlp_mini":
        params = jmlp.init_mlp_params(jax.random.PRNGKey(0), jmlp.MLP_MINI,
                                      weight_sparsity=0.5)
        tparams = [torch.from_numpy(np.array(p, np.float32)) for p in params]
        x = rng.normal(size=(16, jmlp.MLP_MINI.in_features))
        return (jmlp.MLP_MINI, tmlp.MLP_MINI, params, tparams,
                np.maximum(x, 0).astype(np.float32))
    jspec, tspec = jcnn.MINI.scaled(8), tcnn.MINI.scaled(8)
    params = jcnn.init_cnn_params(jax.random.PRNGKey(0), jspec,
                                  weight_sparsity=0.5)
    tparams = tcnn.params_from_numpy([None if p is None else np.asarray(p)
                                      for p in params])
    x = rng.normal(size=(16, 8, 8, 3))
    return jspec, tspec, params, tparams, np.maximum(x, 0).astype(np.float32)


@pytest.fixture(scope="module", params=["mini", "mlp_mini"])
def served(request):
    """Both engines on the same net and weights, fed the same requests in
    ticks ``TICKS``: (port engine, JAX engine, requests, port spec, port
    params, captures after the warm-up, captures after each tick)."""
    jspec, tspec, params, tparams, images = _net(request.param)
    cfg = dict(buckets=BUCKETS)
    eng = tserving.ServeEngine(tspec, tparams,
                               tserving.ServeEngineConfig(**cfg),
                               device="cpu")
    warm = eng.recompiles
    jeng = jserving.ServeEngine(jspec, params,
                                jserving.ServeEngineConfig(**cfg))
    after = []
    i = 0
    for n in TICKS:
        for img in images[i:i + n]:
            eng.submit(img)
            jeng.submit(img)
        i += n
        eng.run_tick()
        jeng.run_tick()
        after.append(eng.recompiles)
    return eng, jeng, images, tspec, tparams, warm, after


def _forward(spec, params, x):
    fwd = tmlp.mlp_forward if isinstance(spec, tmlp.MLPSpec) \
        else tcnn.cnn_forward
    return fwd(params, torch.from_numpy(x), spec, device="cpu")


def _bits(t):
    return t.contiguous().view(torch.int32)


def test_warmup_captures_every_bucket(served):
    eng, _, _, _, _, warm, _ = served
    assert warm == len(BUCKETS)
    assert set(eng.warmup_s) == set(BUCKETS)
    assert all(p.fn.captures == 1 for p in eng.plans.values())
    assert all(set(w) == {"warmup_s", "capture_s"}
               for w in eng.warmup_s.values())


def test_padding_bitwise_per_bucket(served):
    """Real rows of every padded bucket == the unpadded forward."""
    eng, _, images, spec, params, _, _ = served
    for bucket in BUCKETS:
        for n in {1, bucket // 2 + 1}:
            got = eng.forward(bucket, list(images[:n]))
            ref = _forward(spec, params, images[:n])
            assert torch.equal(_bits(got), _bits(ref)), (bucket, n)


def test_padding_rows_cannot_leak_into_real_rows(served):
    """Within one bucket a real row's logits are bitwise independent of the
    other rows (zeros or real requests), and a short batch after a full
    one finds its padding rows re-zeroed in the staging buffer."""
    eng, _, images, _, _, _, _ = served
    for bucket in BUCKETS[1:]:
        full = eng.forward(bucket, list(images[:bucket]))
        padded = eng.forward(bucket, [images[0]])
        assert not eng._stage[bucket][1:].any()
        assert torch.equal(_bits(padded[0]), _bits(full[0]))


def test_recompile_counter_flat_over_ticks(served):
    _, _, _, _, _, warm, after = served
    assert after == [warm] * len(TICKS)


def test_completions_are_fifo_with_latency(served):
    eng, jeng, _, _, _, _, _ = served
    rids = [r.rid for r in eng.completed]
    assert rids == list(range(sum(TICKS)))
    assert all(r.latency_s > 0 and r.result is not None
               and r.completion_tick == r.arrival_tick
               for r in eng.completed)
    assert [(r.rid, r.bucket, r.arrival_tick, r.completion_tick)
            for r in eng.completed] == [
        (r.rid, r.bucket, r.arrival_tick, r.completion_tick)
        for r in jeng.completed]


def test_boundary_report_equals_jax(served):
    """Routes, counts and the static boundaries of every bucket exactly
    the JAX engine's."""
    eng, jeng, _, _, _, _, _ = served
    for bucket in BUCKETS:
        got, want = eng.boundary_report(bucket), jeng.boundary_report(bucket)
        assert got == want, bucket
        assert got["fallback_decodes"] == 0 and got["chained"] >= 1


def test_stats_keys_and_counts_equal_jax(served):
    eng, jeng, _, _, _, _, _ = served
    got, want = eng.stats(), jeng.stats()
    assert set(got) == set(want) - {"snapshot_hits"}
    for key in ("requests", "recompiles", "devices", "data_shards"):
        assert got[key] == want[key], key
    assert {b: s["requests"] for b, s in got["per_bucket"].items()} == \
        {b: s["requests"] for b, s in want["per_bucket"].items()}
    assert got["requests_s"] > 0 and got["p99_ms"] >= got["p50_ms"] > 0
    assert got["ttfr_s"] > 0 and set(got["warmup_s"]) == set(BUCKETS)


def test_served_logits_near_jax(served):
    eng, jeng, _, _, _, _, _ = served
    got = torch.stack([r.result for r in eng.completed]).numpy()
    want = np.stack([r.result for r in jeng.completed])
    np.testing.assert_allclose(got, want, atol=5e-3, rtol=5e-3)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


@pytest.mark.parametrize("mnf", [True, False])
@pytest.mark.parametrize("net", ["mini", "mlp_mini"])
def test_make_cnn_serve_step_boundaries_equal_jax(net, mnf):
    jspec, tspec, _, _, _ = _net(net)
    plan = tsteps.make_cnn_serve_step(tspec, 4, mnf=mnf, device="cpu")
    want = jsteps.make_cnn_serve_step(jspec, 4, mnf=mnf)
    assert plan.boundaries == want.boundaries
    assert (plan.batch, plan.data_shards, plan.mesh, plan.input_sharding) \
        == (4, 1, None, None)
    assert plan.input_shape == tuple(want.arg_specs[1].shape)
    assert plan.fn.device.type == "cpu" and plan.fn.captures == 0


# -- the driver ---------------------------------------------------------------

def test_serve_smoke_passes_on_cpu(capsys):
    tserve.main(["--smoke", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "serve smoke OK" in out
    stats = json.loads(out.splitlines()[0])
    assert stats["requests"] == 9 and stats["recompiles"] == len(BUCKETS)


def test_serve_cnn_mlp_mini_passes_on_cpu(capsys):
    tserve.main(["--mlp", "mini", "--device", "cpu", "--rate", "5",
                 "--ticks", "3", "--buckets", "1,2,4"])
    stats = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert stats["requests"] == 15 and stats["recompiles"] == 3
    assert stats["device"] == "cpu" and stats["net"] == "mlp_mini"
    assert stats["boundaries"]["fallback_decodes"] == 0
