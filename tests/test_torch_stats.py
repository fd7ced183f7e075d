"""The port's event accounting (``repro_torch`` items of the paper's cost
model) against the JAX package's, on the same numpy inputs, CPU only.
Every count must equal the reference's exactly:

- ``core.events``: ``count_nonzero_events``, ``block_occupancy``,
  ``encode_scalar_events`` (values, addresses, count);
- ``core.fire``: ``fire_stats``, ``fire_to_block_events``;
- ``engine.stream``: ``EventStream.num_events`` and ``occupancy()``,
  the degenerate (empty-grid) stream included;
- ``models.mlp.run_mlp_with_stats`` on MLP_MINI and LeNet-300-100: the
  static fields and the traced counts exactly the JAX package's, the
  logits bitwise the port's own forward (``models.cnn.run_with_stats``
  on ``tests/test_torch_cnn.py``'s specs is
  ``tests/test_torch_stats_cnn.py``); with no ``stats`` list the forward
  runs none of the accounting and dispatches the same trace.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import engine as jengine
from repro.core import events as jev
from repro.models import cnn as jcnn
from repro.models import mlp as jmlp
from repro_torch import engine as tengine
from repro_torch.core import events as tev
from repro_torch.models import cnn as tcnn
from repro_torch.models import mlp as tmlp

from test_torch_cnn import SPECS

# by module path: both packages' ``core`` re-export a function ``fire``
jfire = importlib.import_module("repro.core.fire")
tfire = importlib.import_module("repro_torch.core.fire")


def _maps(seed, shape, zero=0.5):
    """Signed normal values with a share ``zero`` of them exact zeros."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    return np.where(rng.random(shape) < zero, 0.0, x).astype(np.float32)


@pytest.mark.parametrize("threshold", [0.0, 0.5])
@pytest.mark.parametrize("shape", [(37,), (6, 40), (2, 5, 5, 8)])
def test_count_nonzero_events_equals_jax(shape, threshold):
    x = _maps(1, shape)
    want = int(jev.count_nonzero_events(jnp.asarray(x), threshold))
    got = tev.count_nonzero_events(torch.from_numpy(x), threshold)
    assert got.dtype == torch.int64 and int(got) == want


@pytest.mark.parametrize("threshold", [0.0, 0.5])
@pytest.mark.parametrize("shape,blk_k", [((6, 40), 8), ((3, 4, 32), 16),
                                         ((5, 24), 24)])
def test_block_occupancy_equals_jax(shape, blk_k, threshold):
    x = _maps(2, shape, zero=0.8)
    want = np.asarray(jev.block_occupancy(jnp.asarray(x), blk_k, threshold))
    got = tev.block_occupancy(torch.from_numpy(x), blk_k, threshold)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("capacity,threshold", [(None, 0.0), (None, 0.7),
                                                (5, 0.0), (100, 0.3)])
def test_encode_scalar_events_equals_jax(capacity, threshold):
    x = _maps(3, (4, 9, 3))
    want = jev.encode_scalar_events(jnp.asarray(x), capacity, threshold)
    got = tev.encode_scalar_events(torch.from_numpy(x), capacity, threshold)
    assert got.capacity == want.capacity
    assert int(got.count) == int(want.count)
    np.testing.assert_array_equal(got.indices.numpy(),
                                  np.asarray(want.indices))
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))
    assert got.indices.dtype == torch.int32


@pytest.mark.parametrize("cfg", [dict(), dict(threshold=0.4),
                                 dict(threshold=0.4, magnitude=True)])
def test_fire_stats_equals_jax(cfg):
    acc = _maps(4, (8, 24), zero=0.2)
    fired_j, n_j, d_j = jfire.fire_stats(jnp.asarray(acc),
                                         jfire.FireConfig(**cfg))
    fired, n, d = tfire.fire_stats(torch.from_numpy(acc),
                                   tfire.FireConfig(**cfg))
    np.testing.assert_array_equal(fired.numpy(), np.asarray(fired_j))
    assert int(n) == int(n_j)
    assert d.dtype == torch.float32 and float(d) == float(d_j)


@pytest.mark.parametrize("blk_m,blk_k,capacity", [(1, 8, None), (4, 8, None),
                                                  (2, 4, 3)])
def test_fire_to_block_events_equals_jax(blk_m, blk_k, capacity):
    acc = _maps(5, (8, 32), zero=0.6)
    fired_j, bj = jfire.fire_to_block_events(
        jnp.asarray(acc), blk_m=blk_m, blk_k=blk_k, capacity=capacity)
    fired, bt = tfire.fire_to_block_events(
        torch.from_numpy(acc), blk_m=blk_m, blk_k=blk_k, capacity=capacity)
    np.testing.assert_array_equal(fired.numpy(), np.asarray(fired_j))
    np.testing.assert_array_equal(bt.values.numpy(), np.asarray(bj.values))
    np.testing.assert_array_equal(bt.block_idx.numpy(),
                                  np.asarray(bj.block_idx))
    np.testing.assert_array_equal(bt.counts.numpy(), np.asarray(bj.counts))
    assert bt.num_k_blocks == bj.num_k_blocks


@pytest.mark.parametrize("shape,blk_m,blk_k", [((16, 40), 8, 8),
                                               ((13, 40), 4, 16),
                                               ((0, 40), 8, 8),
                                               ((9, 0), 1, 8)])
def test_stream_num_events_and_occupancy_equal_jax(shape, blk_m, blk_k):
    """``num_events`` and ``occupancy()``; a 0-row or 0-column stream has
    an empty grid and occupancy 0.0, not 0/0."""
    x = _maps(6, shape, zero=0.7)
    sj = jengine.EventStream.encode(jnp.asarray(x), blk_m=blk_m,
                                    blk_k=blk_k)
    st = tengine.EventStream.encode(torch.from_numpy(x), blk_m=blk_m,
                                    blk_k=blk_k)
    assert int(st.num_events) == int(sj.num_events)
    occ = st.occupancy()
    assert occ.dtype == torch.float32 and float(occ) == float(sj.occupancy())
    if 0 in shape:
        assert float(occ) == 0.0


def test_layer_dense_macs_and_static_stats_equal_jax():
    for name, (jspec, tspec) in SPECS.items():
        assert tcnn.layer_dense_macs(tspec) == jcnn.layer_dense_macs(jspec)
        assert tcnn._static_layer_stats(tspec, 3) == \
            jcnn._static_layer_stats(jspec, 3), name
    for spec in (jcnn.VGG16, jcnn.ALEXNET):
        tspec = getattr(tcnn, spec.name.upper())
        assert tcnn.layer_dense_macs(tspec) == jcnn.layer_dense_macs(spec)


@pytest.mark.parametrize("spec_name", ["MLP_MINI", "LENET_300_100"])
@pytest.mark.parametrize("threshold", [0.0, 0.05])
def test_run_mlp_with_stats_equals_jax(spec_name, threshold):
    jspec, tspec = getattr(jmlp, spec_name), getattr(tmlp, spec_name)
    params = jmlp.init_mlp_params(jax.random.PRNGKey(3), jspec,
                                  weight_sparsity=0.5)
    rng = np.random.default_rng(3)
    x = np.where(rng.random((4, jspec.in_features)) < 0.7, 0.0,
                 np.abs(rng.normal(size=(4, jspec.in_features))))
    x = x.astype(np.float32)
    _, jstats = jmlp.run_mlp_with_stats(
        params, jnp.asarray(x), jspec,
        fire_cfg=jfire.FireConfig(threshold=threshold))
    tparams = [torch.from_numpy(np.array(p, np.float32)) for p in params]
    tfc = tfire.FireConfig(threshold=threshold)
    y, tstats = tmlp.run_mlp_with_stats(tparams, torch.from_numpy(x), tspec,
                                        fire_cfg=tfc, device="cpu")
    assert tstats == jstats
    y_fwd = tmlp.mlp_forward(tparams, torch.from_numpy(x), tspec,
                             fire_cfg=tfc, device="cpu")
    assert torch.equal(y.view(torch.int32), y_fwd.view(torch.int32))


def _refuse(*args, **kw):
    raise AssertionError("the accounting ran with stats=None")


@pytest.mark.parametrize("net", ["mini", "mlp_mini"])
def test_no_stats_runs_no_accounting_and_the_same_trace(net, monkeypatch):
    """With ``stats`` None the forward (and the pipeline built on it) calls
    none of the accounting helpers, and its trace records are those of
    ``run_with_stats``' forward: the hook dispatches nothing."""
    gen = torch.Generator().manual_seed(0)
    if net == "mlp_mini":
        spec = tmlp.MLP_MINI
        params = tmlp.init_mlp_params(spec, gen, weight_sparsity=0.5)
        x = torch.relu(torch.randn((3, spec.in_features), generator=gen))
        run, make = tmlp.run_mlp_with_stats, tmlp.make_mlp_pipeline
        mod = tmlp
    else:
        spec = tcnn.MINI
        params = tcnn.init_cnn_params(spec, gen, weight_sparsity=0.5)
        x = torch.relu(torch.randn((3, 8, 8, 3), generator=gen))
        run, make = tcnn.run_with_stats, tcnn.make_cnn_pipeline
        mod = tcnn
    with tengine.trace_dispatch() as with_stats:
        y_stats, _ = run(params, x, spec, device="cpu")
    for helper in ("fc_in_events", "_pixel_events", "_density"):
        if hasattr(mod, helper):
            monkeypatch.setattr(mod, helper, _refuse)
    pipe = make(spec, batch=3, device="cpu")
    with tengine.trace_dispatch() as without:
        y = pipe(params, x)
    assert torch.equal(y, y_stats)
    assert without == with_stats and len(without) > 0
