"""The port's CNN forward against repro.models.cnn on the JAX block backend:
same weights (``params_from_numpy``), same inputs (numpy).  Checked per
spec: logits allclose at 5e-3 (tests/test_conv_chain.py's tolerance), the
same trace op/route/strip/launches sequence, zero fallback_decode, zero
densify points, and chained == round-trip bitwise inside the port."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import engine as jengine
from repro.models import cnn as jcnn
from repro_torch import engine as tengine
from repro_torch.models import cnn as tcnn


def _vgg16_small(mod):
    """VGG16's topology at input 32 with channels cut to 8–64: still
    reaches strip conv (widths 32/16/8), the window pool (pools 1–2), the
    per-event pool (pools 3–5), the per-tap conv (widths 4/2) and the
    conv→FC re-tile."""
    c, p, f = mod.ConvSpec, mod.PoolSpec, mod.FCSpec
    conv = lambda co: c(co, 3, 1, 1)  # noqa: E731
    layers = (conv(8), conv(8), p(), conv(16), conv(16), p(),
              conv(16), conv(16), conv(16), p(),
              conv(32), conv(32), conv(32), p(),
              conv(32), conv(32), conv(32), p(), f(64), f(64), f(10))
    return mod.CNNSpec("vgg16_small", 32, 3, layers, num_classes=10)


SPECS = {"mini": (jcnn.MINI, tcnn.MINI),
         "mini_s4": (jcnn.MINI_S4, tcnn.MINI_S4),
         "vgg16_small": (_vgg16_small(jcnn), _vgg16_small(tcnn))}


def _key(r):
    return (r["op"], r.get("route"), r.get("strip"), r.get("launches"),
            r.get("chained"), r.get("retile"))


@functools.lru_cache(maxsize=None)
def _run(name):
    jspec, tspec = SPECS[name]
    params = jcnn.init_cnn_params(jax.random.PRNGKey(7), jspec,
                                  weight_sparsity=0.5)
    size = jspec.input_size
    x = np.maximum(np.random.default_rng(7).normal(size=(2, size, size, 3)),
                   0).astype(np.float32)
    with jengine.trace_dispatch() as jrecs:
        # one compiled call: eager JAX compiles op by op, several times slower
        yj = np.asarray(jax.jit(functools.partial(
            jcnn.cnn_forward, spec=jspec))(params, jnp.asarray(x)))
    tparams = tcnn.params_from_numpy(
        [None if p is None else np.asarray(p) for p in params])
    with tengine.trace_dispatch() as trecs:
        yc = tcnn.cnn_forward(tparams, torch.from_numpy(x), tspec,
                              device="cpu")
    yr = tcnn.cnn_forward(tparams, torch.from_numpy(x), tspec, chain=False,
                          device="cpu")
    yd = tcnn.cnn_forward(tparams, torch.from_numpy(x), tspec, mnf=False,
                          device="cpu")
    return dict(yj=yj, yc=yc, yr=yr, yd=yd, jrecs=jrecs, trecs=trecs,
                tspec=tspec)


@pytest.mark.parametrize("name", sorted(SPECS))
def test_logits_match_jax_block(name):
    r = _run(name)
    assert r["yc"].shape == r["yj"].shape
    assert torch.isfinite(r["yc"]).all()
    np.testing.assert_allclose(r["yc"].numpy(), r["yj"], atol=5e-3,
                               rtol=5e-3)
    # much tighter in fact: both sum the same products, in other orders
    scale = float(np.abs(r["yj"]).max())
    assert float(np.abs(r["yc"].numpy() - r["yj"]).max()) <= 1e-4 * scale
    np.testing.assert_allclose(r["yd"].numpy(), r["yj"], atol=5e-3,
                               rtol=5e-3)


@pytest.mark.parametrize("name", sorted(SPECS))
def test_trace_sequence_matches_jax(name):
    r = _run(name)
    assert [_key(x) for x in r["trecs"]] == [_key(x) for x in r["jrecs"]]
    assert not any(x.get("fallback_decode") for x in r["trecs"])
    assert not any(x.get("decode") for x in r["trecs"])
    assert tcnn.chain_boundary_summary(r["tspec"], batch=2)["densify"] == 0


@pytest.mark.parametrize("name", sorted(SPECS))
def test_chained_equals_round_trip_bitwise(name):
    r = _run(name)
    assert torch.equal(r["yc"], r["yr"]), "chained != round-trip bitwise"


def test_vgg16_small_reaches_every_kernel_path():
    recs = _run("vgg16_small")["trecs"]
    routes = {(x["op"], x["route"]) for x in recs}
    assert routes == {("conv2d", "strip"), ("conv2d", "pixel"),
                      ("maxpool2d", "window"), ("maxpool2d", "pixel"),
                      ("linear", "event")}
    assert any(x.get("retile") for x in recs)


def test_vgg16_at_224_plans_zero_densify_and_every_route():
    """The slice's own workload, planned from shapes alone (no compute):
    VGG16@224 batch 4 strips conv1_1–conv3_3, window-pools 1–2, pools 3–5
    per event, runs conv4/conv5 per tap and re-tiles into FC1."""
    s = tcnn.chain_boundary_summary(tcnn.VGG16, batch=4)
    assert s["densify"] == 0 and s["pool_events"] == 5 and s["retile"] == 1
    assert s["input_encode"] == 1
    routes = [(r["op"], r["route"]) for r in s["routes"]]
    assert routes[:3] == [("conv2d", "strip")] * 2 + [("maxpool2d", "window")]
    assert routes.count(("conv2d", "strip")) == 7
    assert routes.count(("conv2d", "pixel")) == 6
    assert routes.count(("maxpool2d", "window")) == 2
    assert routes.count(("maxpool2d", "pixel")) == 3
    assert s == {k: v for k, v in jcnn.chain_boundary_summary(
        jcnn.VGG16, batch=4).items()}
