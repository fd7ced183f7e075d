"""The port's MLP family (``repro_torch.models.mlp``) against
``repro.models.mlp`` on the JAX block backend: the same numpy weights and
inputs through both, in f32 and with int8 event values.  Checked per spec
and mode: logits at 5e-3 and at 1e-4·max|logits|, the same trace op/route
sequence, zero fallback_decode, chained == round trip bitwise inside the
port (the fake-quant twin in int8), and the f32 chain within 2e-4 of the
dense oracle (tests/test_mlp_models.py's tolerance)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import engine as jengine
from repro.core.fire import FireConfig as JFireConfig
from repro.models import mlp as jmlp
from repro_torch import engine as tengine
from repro_torch.core.fire import FireConfig
from repro_torch.models import mlp as tmlp

SPECS = {"mlp_mini": (jmlp.MLP_MINI, tmlp.MLP_MINI, 4),
         "lenet_300_100": (jmlp.LENET_300_100, tmlp.LENET_300_100, 2)}


def _x(seed, shape, sparsity):
    """Sparse non-negative inputs, as tests/test_mlp_models.py makes them."""
    r = np.random.default_rng(seed)
    x = np.abs(r.normal(size=shape)) * (r.random(shape) > sparsity)
    return x.astype(np.float32)


def _key(r):
    return (r["op"], r.get("route"), r.get("chained"), r.get("retile"))


@functools.lru_cache(maxsize=None)
def _run(name, int8):
    jspec, tspec, batch = SPECS[name]
    params = [p.numpy() for p in tmlp.init_mlp_params(
        tspec, torch.Generator().manual_seed(5), weight_sparsity=0.5)]
    x = _x(2, (batch, tspec.in_features), 0.6)
    threshold = 0.05 if name == "mlp_mini" else 0.0
    jfire = JFireConfig(threshold=threshold, quantize_to_int8=int8)
    with jengine.trace_dispatch() as jrecs:
        yj = np.asarray(jax.jit(functools.partial(
            jmlp.mlp_forward, spec=jspec, fire_cfg=jfire))(
                [jnp.asarray(p) for p in params], jnp.asarray(x)))
    tparams = [torch.from_numpy(p) for p in params]
    fire_cfg = FireConfig(threshold=threshold, quantize_to_int8=int8)
    kw = dict(fire_cfg=fire_cfg, device="cpu")
    with tengine.trace_dispatch() as trecs:
        yc = tmlp.mlp_forward(tparams, torch.from_numpy(x), tspec, **kw)
    yr = tmlp.mlp_forward(tparams, torch.from_numpy(x), tspec, chain=False,
                          **kw)
    yd = tmlp.mlp_forward(tparams, torch.from_numpy(x), tspec, mnf=False,
                          **kw)
    return dict(yj=yj, yc=yc, yr=yr, yd=yd, jrecs=jrecs, trecs=trecs)


CASES = [(name, int8) for name in sorted(SPECS) for int8 in (False, True)]


@pytest.mark.parametrize("name,int8", CASES)
def test_mlp_logits_match_jax(name, int8):
    r = _run(name, int8)
    assert r["yc"].shape == r["yj"].shape == (SPECS[name][2], 10)
    assert torch.isfinite(r["yc"]).all()
    np.testing.assert_allclose(r["yc"].numpy(), r["yj"], atol=5e-3,
                               rtol=5e-3)
    scale = float(np.abs(r["yj"]).max())
    assert float(np.abs(r["yc"].numpy() - r["yj"]).max()) <= 1e-4 * scale


@pytest.mark.parametrize("name,int8", CASES)
def test_mlp_trace_matches_jax_and_chains(name, int8):
    """Only the two stream-consuming boundaries dispatch through the event
    seam (the head takes the dense input); both chain, none decodes."""
    r = _run(name, int8)
    assert [_key(x) for x in r["trecs"]] == [_key(x) for x in r["jrecs"]]
    assert [_key(x) for x in r["trecs"]] == [("linear", "event", True,
                                              None)] * 2
    assert not any(x.get("fallback_decode") or x.get("decode")
                   for x in r["trecs"])


@pytest.mark.parametrize("name,int8", CASES)
def test_mlp_chained_equals_round_trip_bitwise(name, int8):
    r = _run(name, int8)
    assert torch.equal(r["yc"], r["yr"])
    if int8:
        assert not torch.equal(r["yc"], _run(name, False)["yc"])
    else:
        torch.testing.assert_close(r["yc"], r["yd"], atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("name", sorted(SPECS))
def test_mlp_specs_and_summary_match_jax(name):
    jspec, tspec, batch = SPECS[name]
    assert (tspec.in_features, tspec.widths) == (jspec.in_features,
                                                 jspec.widths)
    assert tspec.feature_sizes() == jspec.feature_sizes()
    assert tspec.num_classes == jspec.num_classes
    assert [layer.out for layer in tspec.layers] == \
        [layer.out for layer in jspec.layers]
    assert tmlp.mlp_layer_dense_macs(tspec) == \
        jmlp.mlp_layer_dense_macs(jspec)
    for int8 in (False, True):
        t = tmlp.mlp_boundary_summary(
            tspec, batch=128, fire_cfg=FireConfig(quantize_to_int8=int8))
        j = jmlp.mlp_boundary_summary(
            jspec, batch=128, fire_cfg=JFireConfig(quantize_to_int8=int8))
        assert t == j
        assert t["densify"] == 0 and t["retile"] == 0
        assert len(t["routes"]) == len(tspec.widths) - 1


def test_init_mlp_params_and_make_mlp_forward():
    spec = tmlp.MLP_MINI
    params = tmlp.init_mlp_params(spec, torch.Generator().manual_seed(0),
                                  weight_sparsity=0.5)
    assert [tuple(p.shape) for p in params] == \
        list(zip(spec.feature_sizes(), spec.widths))
    density = float(sum((p != 0).sum() for p in params)
                    / sum(p.numel() for p in params))
    assert 0.4 < density < 0.6
    x = torch.from_numpy(_x(3, (2, spec.in_features), 0.5))
    fwd = tmlp.make_mlp_forward(spec)
    assert torch.equal(fwd(params, x),
                       tmlp.mlp_forward(params, x, spec, device="cpu"))


def test_mlp_int8_hidden_streams_carry_codes(monkeypatch):
    """Each hidden boundary hands engine.linear an int8 stream with its
    QParams; the head takes the dense f32 input."""
    spec = tmlp.MLP_MINI
    params = tmlp.init_mlp_params(spec, torch.Generator().manual_seed(1))
    x = torch.from_numpy(_x(4, (3, spec.in_features), 0.5))
    seen = []
    linear = tengine.linear

    def spy(x, *a, **kw):
        seen.append(x.events.values.dtype
                    if isinstance(x, tengine.EventStream) else x.dtype)
        return linear(x, *a, **kw)

    monkeypatch.setattr(tengine, "linear", spy)
    tmlp.mlp_forward(params, x, spec, device="cpu",
                     engine_cfg=tengine.EngineConfig(int8_events=True))
    assert seen == [torch.float32, torch.int8, torch.int8]
