"""The port's adaptive routing and launch accounting against the JAX
package's, CPU only.

- ``costmodel.crossover``: ``load_crossover_table("BENCH_engine.json")``
  gives JAX's ``ratio`` for every (boundary, backend, shape class,
  flavour) of the file at occupancies 0 to 1 in steps of 0.05;
  ``decide_route`` gives JAX's decision over modes × occupancies × the
  analytic seed and the table; ``route_conflicts`` gives JAX's on the
  trace records of MINI served under ``adaptive`` (and of forced routes,
  where conflicts exist);
- twins of ``tests/test_routing.py``'s adaptive flips on the analytic
  model and on an installed table, the table's flavour conditioning and
  the channel-aware pool shape class;
- the launch accounting: ``fused_conv_plan``, ``pool_plan`` and
  ``pool_window_plan`` dict for dict at every layer of VGG16@224,
  AlexNet@224, ALEXNET_FF@256 and MINI; ``registered_ops``;
- the serve driver: ``--route adaptive --bench BENCH_engine.json`` exits
  0 on the CPU, names the table's device and entry count, clears the
  table after, and reports JAX's driver's routes.
"""
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import engine as jengine
from repro.costmodel import crossover as jx
from repro.engine import registry as jreg
from repro.kernels.event_conv import ops as jconv_ops
from repro.kernels.event_pool import ops as jpool_ops
from repro.models import cnn as jcnn
from repro_torch import engine as tengine
from repro_torch import serving as tserving
from repro_torch.costmodel import crossover as tx
from repro_torch.engine import registry as treg
from repro_torch.kernels.event_conv import ops as tconv_ops
from repro_torch.kernels.event_pool import ops as tpool_ops
from repro_torch.launch import serve as tserve
from repro_torch.models import cnn as tcnn

ROOT = pathlib.Path(__file__).resolve().parents[1]
BENCH = str(ROOT / "BENCH_engine.json")
OCCS = [round(i * 0.05, 2) for i in range(21)]
MODES = ("auto", "adaptive", "dense", "event", "strip", "pixel", "window")


@pytest.fixture(autouse=True)
def _no_table_leaks():
    """Every test starts and ends with no table installed in either
    package."""
    tprev, jprev = tx.set_active_table(None), jx.set_active_table(None)
    yield
    assert tx.active_table() is None and jx.active_table() is None
    tx.set_active_table(tprev)
    jx.set_active_table(jprev)


def _entries():
    with open(BENCH) as f:
        return [e for e in json.load(f)["entries"]
                if e.get("kind") == "crossover"]


# ---------------------------------------------------------------------------
# the crossover table and the decision
# ---------------------------------------------------------------------------

def test_load_crossover_table_ratios_equal_jax():
    t, j = tx.load_crossover_table(BENCH), jx.load_crossover_table(BENCH)
    assert len(t) == len(j) > 0
    assert t.device == "cpu" and t.entries == len(_entries())
    keys = {(e["boundary"], e.get("backend"), e.get("shape_class"))
            for e in _entries()}
    keys |= {(b, be, None) for b, be, _ in keys} | \
        {(b, None, None) for b, _, _ in keys}
    keys |= {("conv", "cuda", "k11s4"), ("pool", "block", "k9s9c1"),
             ("recurrent", "block", "wkv6d64")}
    n = 0
    for boundary, backend, sc in sorted(keys, key=str):
        for flavor in (None,) + tx.EVENT_ROUTES:
            for occ in OCCS:
                got = t.ratio(boundary, occ, backend=backend, shape_class=sc,
                              flavor=flavor)
                want = j.ratio(boundary, occ, backend=backend,
                               shape_class=sc, flavor=flavor)
                assert got == want, (boundary, backend, sc, flavor, occ)
                n += got is not None
    assert n > 1000


def test_load_crossover_table_raw_list_and_absent_file(tmp_path):
    raw = tmp_path / "raw.json"
    raw.write_text(json.dumps(_entries()))
    t, j = tx.load_crossover_table(str(raw)), jx.load_crossover_table(
        str(raw))
    assert len(t) == len(j) and t.device is None
    assert t.ratio("conv", 0.4, backend="block", shape_class="k3s1") == \
        j.ratio("conv", 0.4, backend="block", shape_class="k3s1")
    missing = str(tmp_path / "none.json")
    assert len(tx.load_crossover_table(missing)) == 0 == \
        len(jx.load_crossover_table(missing))


def _decision(mod, mode, occ, event_route, table, **geo):
    d = mod.decide_route(mode, geo.pop("boundary"), occupancy=occ,
                         event_route=event_route, table=table, **geo)
    return (d.route, d.est_event_cost, d.est_dense_cost, d.occupancy,
            d.ratio, d.source, d.is_event)


GEOMETRIES = [
    dict(boundary="conv", dense_macs=2.0 * 16 * 16 * 9 * 8 * 16,
         avg_touched=9.0, c_out=16, backend="block", shape_class="k3s1"),
    dict(boundary="conv", dense_macs=1.4e9, avg_touched=6.4, c_out=96,
         backend="cuda", shape_class="k11s4"),
    dict(boundary="pool", dense_macs=4.0 * 8 * 8 * 4 * 128, avg_touched=1.0,
         c_out=128, backend="block", shape_class="k2s2c128"),
    dict(boundary="linear", dense_macs=2.0 * 512 * 128, avg_touched=1.0,
         c_out=128, backend="pallas", shape_class="n128"),
    dict(boundary="linear", dense_macs=9216.0 * 4096, avg_touched=1.0,
         c_out=4096, backend=None, shape_class=None),
]


@pytest.mark.parametrize("use_table", [False, True], ids=["seed", "table"])
@pytest.mark.parametrize("mode", MODES)
def test_decide_route_equals_jax(mode, use_table):
    tt = tx.load_crossover_table(BENCH) if use_table else None
    jt = jx.load_crossover_table(BENCH) if use_table else None
    for geo in GEOMETRIES:
        for event_route in (None, "strip", "pixel", "window", "event"):
            for occ in OCCS + [None, -0.5, 1.5]:
                got = _decision(tx, mode, occ, event_route, tt, **dict(geo))
                want = _decision(jx, mode, occ, event_route, jt, **dict(geo))
                assert got == want, (mode, geo, event_route, occ)
    assert tx.ROUTE_HYSTERESIS == jx.ROUTE_HYSTERESIS
    assert tx.LAUNCH_OVERHEAD_CYCLES == jx.LAUNCH_OVERHEAD_CYCLES
    assert tx.EVENT_ROUTES == jx.EVENT_ROUTES


def test_active_table_drives_decisions_like_jax():
    tx.set_active_table(tx.load_crossover_table(BENCH))
    jx.set_active_table(jx.load_crossover_table(BENCH))
    try:
        for geo in GEOMETRIES[:4]:
            for occ in OCCS:
                assert _decision(tx, "adaptive", occ, "pixel", None,
                                 **dict(geo)) == \
                    _decision(jx, "adaptive", occ, "pixel", None,
                              **dict(geo))
    finally:
        tx.set_active_table(None)
        jx.set_active_table(None)


# ---------------------------------------------------------------------------
# twins of tests/test_routing.py's adaptive tests, on the port's engine
# ---------------------------------------------------------------------------

def _x(shape, sparsity=0.3, seed=0):
    r = np.random.default_rng(seed)
    x = np.abs(r.normal(size=shape)).astype(np.float32) + 1e-3
    return torch.from_numpy(x * (r.random(shape) > sparsity))


def _cfg(**kw):
    kw.setdefault("backend", "block")
    kw.setdefault("blk_m", 1)
    kw.setdefault("blk_k", 8)
    return tengine.EngineConfig(**kw)


def _route(hint):
    return tengine.route_conv((1, 16, 16, 8), (3, 3, 8, 8),
                              _cfg(route="adaptive", occupancy_hint=hint),
                              stride=1, padding=1, blk_m=1)


def test_adaptive_flips_on_analytic_model():
    lo, hi = _route(0.02), _route(1.0)
    assert lo.route == "pixel" and lo.source == "model"
    assert hi.route == "dense" and hi.source == "model"
    assert lo.ratio < 1.0 < hi.ratio


def test_adaptive_flips_on_installed_table():
    entries = [
        dict(kind="crossover", boundary="conv", backend="block",
             shape_class="k3s1", occupancy=0.02,
             us=dict(pixel=500.0, dense=100.0)),
        dict(kind="crossover", boundary="conv", backend="block",
             shape_class="k3s1", occupancy=1.0,
             us=dict(pixel=10.0, dense=100.0)),
    ]
    tx.set_active_table(tx.CrossoverTable(entries))
    try:
        lo, hi = _route(0.02), _route(1.0)
    finally:
        tx.set_active_table(None)
    assert lo.route == "dense" and lo.source == "table"
    assert hi.route == "pixel" and hi.source == "table"


def test_table_flavor_conditioning():
    entries = [dict(kind="crossover", boundary="conv", backend="block",
                    shape_class="k3s1", occupancy=0.5,
                    us=dict(strip=300.0, pixel=20.0, dense=100.0))]
    t = tx.CrossoverTable(entries)
    assert t.ratio("conv", 0.5, backend="block", shape_class="k3s1",
                   flavor="strip") == pytest.approx(3.0)
    assert t.ratio("conv", 0.5, backend="block", shape_class="k3s1",
                   flavor="pixel") == pytest.approx(0.2)
    assert t.ratio("conv", 0.5, backend="block",
                   shape_class="k3s1") == pytest.approx(0.2)
    dec = tx.decide_route("adaptive", "conv", occupancy=0.5,
                          event_route="strip", dense_macs=1e6,
                          avg_touched=9.0, c_out=8, backend="block",
                          shape_class="k3s1", table=t)
    assert dec.route == "dense" and dec.source == "table"


def test_pool_shape_class_is_channel_aware():
    cfg = _cfg(blk_m=tengine.STRIP_W)
    dec = tengine.route_pool((2, 16, 16, 128), 2, 2, cfg,
                             blk_m=tengine.STRIP_W)
    assert dec is not None
    stream = tengine.fire_conv(_x((2, 16, 16, 128)), cfg,
                               blk_m=tengine.STRIP_W, keep_dense=True)
    with tengine.trace_dispatch() as recs:
        tengine.maxpool2d(stream, 2, 2, cfg=cfg)
    (r,) = [r for r in recs if r.get("op") == "maxpool2d"]
    assert r["shape_class"] == "k2s2c128"


# ---------------------------------------------------------------------------
# route_conflicts on MINI served under adaptive
# ---------------------------------------------------------------------------

FIELDS = ("op", "backend", "route", "occupancy", "route_source",
          "shape_class", "est_event_cost", "est_dense_cost", "chained",
          "routed_dense", "fallback_decode", "pool_events", "retile")


def _jax_records(params, x, route, hint):
    cfg = jengine.EngineConfig(backend="block", route=route,
                               occupancy_hint=hint)
    with jengine.trace_dispatch() as recs:
        jax.eval_shape(lambda p, xx: jcnn.cnn_forward(
            p, xx, jcnn.MINI, engine_cfg=cfg), params, jnp.asarray(x))
    return [r for r in recs if r.get("route") is not None]


def _served_records(tparams, x, route, hint):
    """The records of the bucket a MINI replica on the CPU served ``x``
    through (traced as ``ServeEngine.boundary_report`` traces them)."""
    cfg = tengine.EngineConfig(route=route, occupancy_hint=hint)
    eng = tserving.ServeEngine(
        tcnn.MINI, tparams, tserving.ServeEngineConfig(buckets=(1, 2)),
        engine_cfg=cfg, device="cpu")
    for img in torch.from_numpy(x):
        eng.submit(img)
    eng.run_tick()
    assert len(eng.completed) == x.shape[0]
    plan = eng.plans[2]
    with tengine.trace_dispatch() as recs:
        plan.fn.fwd(eng.params, eng.stage(2, [r.image
                                              for r in eng.completed]))
    return [r for r in recs if r.get("route") is not None]


@pytest.mark.parametrize("route,hint", [("adaptive", 0.05),
                                        ("adaptive", 0.3),
                                        ("adaptive", 0.9), ("dense", 1.0),
                                        ("event", 1.0)])
def test_route_conflicts_equal_jax_on_served_mini(route, hint):
    params = jcnn.init_cnn_params(jax.random.PRNGKey(3), jcnn.MINI,
                                  weight_sparsity=0.5)
    tparams = tcnn.params_from_numpy([None if p is None else np.asarray(p)
                                      for p in params])
    x = np.maximum(np.random.default_rng(3).normal(size=(2, 8, 8, 3)),
                   0).astype(np.float32)
    tt, jt = tx.load_crossover_table(BENCH), jx.load_crossover_table(BENCH)
    tx.set_active_table(tt)
    jx.set_active_table(jt)
    try:
        trecs = _served_records(tparams, x, route, hint)
        jrecs = _jax_records(params, x, route, hint)
    finally:
        tx.set_active_table(None)
        jx.set_active_table(None)
    assert [tuple(r.get(f) for f in FIELDS) for r in trecs] == \
        [tuple(r.get(f) for f in FIELDS) for r in jrecs]
    got = tx.route_conflicts(trecs, tt)
    want = jx.route_conflicts(jrecs, jt)
    assert [(c["op"], c["route"], c["table_ratio"]) for c in got] == \
        [(c["op"], c["route"], c["table_ratio"]) for c in want]
    # each package's gate on the other's records, and on a tighter band
    assert tx.route_conflicts(jrecs, tt) == jx.route_conflicts(jrecs, jt)
    assert tx.route_conflicts(trecs, tt, hysteresis=0.0) == \
        jx.route_conflicts(trecs, jt, hysteresis=0.0)
    if route == "adaptive":
        assert got == []        # the argmin never leaves the band
    else:
        # at full occupancy the table says the FC's events win (ratio
        # 0.72) and the pool's lose (3.05): each forced route conflicts
        assert got


# ---------------------------------------------------------------------------
# the launch accounting
# ---------------------------------------------------------------------------

PLAN_SPECS = [("vgg16", 224, 4), ("alexnet", 224, 8), ("alexnet_ff", 256, 4),
              ("mini", 8, 2)]


def _layers(mod, name, size, batch):
    spec = {"vgg16": mod.VGG16, "alexnet": mod.ALEXNET,
            "alexnet_ff": mod.ALEXNET_FF, "mini": mod.MINI}[name]
    spec = spec.scaled(size)
    return [(layer, (batch,) + shape) for layer, shape in
            zip(spec.layers, mod._trace_shapes(spec))]


@pytest.mark.parametrize("name,size,batch", PLAN_SPECS)
def test_launch_plans_equal_jax(name, size, batch):
    n_conv = n_pool = n_window = 0
    tl, jl = _layers(tcnn, name, size, batch), _layers(jcnn, name, size,
                                                       batch)
    for (layer, shape), (jlayer, jshape) in zip(tl, jl):
        assert shape == jshape
        c = shape[3]
        for nkb, cap in ((-(-c // 8), None), (-(-c // 8), 2),
                         (max(c // 64, 1), 100)):
            if isinstance(layer, tcnn.ConvSpec):
                args = (shape, layer.k, layer.padding)
                kw = dict(nkb=nkb, capacity=cap, stride=layer.stride)
                assert tconv_ops.fused_conv_plan(*args, **kw) == \
                    jconv_ops.fused_conv_plan(*args, **kw)
                n_conv += 1
            elif isinstance(layer, tcnn.PoolSpec):
                args = (shape, layer.k, layer.stride)
                kw = dict(nkb=nkb, capacity=cap)
                assert tpool_ops.pool_plan(*args, **kw) == \
                    jpool_ops.pool_plan(*args, **kw)
                n_pool += 1
                try:
                    want = jpool_ops.pool_window_plan(*args, **kw)
                except AssertionError:
                    with pytest.raises(AssertionError):
                        tpool_ops.pool_window_plan(*args, **kw)
                    continue
                assert tpool_ops.pool_window_plan(*args, **kw) == want
                n_window += 1
    assert n_conv and (n_pool or name == "alexnet_ff")
    if name == "vgg16":
        assert n_window == 2 * 3      # pools 1 and 2 tile into strips


def test_registered_ops_equal_jax():
    assert treg.registered_ops() == jreg.registered_ops()
    assert tengine.registered_ops() == jengine.registered_ops()
    assert "registered_ops" in treg.__all__ and \
        "registered_ops" in tengine.__all__


def test_plans_are_exported():
    assert "fused_conv_plan" in tconv_ops.__all__
    assert {"pool_plan", "pool_window_plan"} <= set(tpool_ops.__all__)


# ---------------------------------------------------------------------------
# the serve driver
# ---------------------------------------------------------------------------

def _routes(out):
    return [(r["op"], r["route"], r["occupancy"], r["source"],
             r["shape_class"]) for r in out["boundaries"]["routes"]]


def test_serve_driver_adaptive_routes_equal_jax(capsys):
    argv = ["--cnn", "mini", "--cnn-size", "8", "--route", "adaptive",
            "--bench", BENCH, "--device", "cpu"]
    tserve.main(argv)
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert tx.active_table() is None     # installed for the serve only
    assert out["crossover_table"] == dict(path=BENCH, device="cpu",
                                          entries=len(_entries()),
                                          curves=len(tx.load_crossover_table(
                                              BENCH)))
    assert out["engine"]["route"] == "adaptive"
    assert out["boundaries"]["fallback_decodes"] == 0
    assert {r[3] for r in _routes(out)} == {"table"}

    # JAX's driver on the same flags, its buckets cut to keep the compile
    # short (routes are per bucket; both report the first, bucket 1)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    res = subprocess.run(
        [sys.executable, "-m", "repro.launch.serve", "--cnn", "mini",
         "--cnn-size", "8", "--route", "adaptive", "--bench", BENCH,
         "--buckets", "1,2", "--rate", "2", "--ticks", "2"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    jout = json.loads(res.stdout.strip().splitlines()[-1])
    assert _routes(out) == _routes(jout)
    assert [(r["op"], r["route"], r["occupancy"], r["source"],
             r["shape_class"]) for r in out["boundaries"]["boundaries"][
                 "routes"]] == \
        [(r["op"], r["route"], r["occupancy"], r["source"],
          r["shape_class"]) for r in jout["boundaries"]["boundaries"][
              "routes"]]
