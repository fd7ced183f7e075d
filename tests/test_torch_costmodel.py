"""The port's cost model and PE mapping (``repro_torch.costmodel``,
``repro_torch.core.mapping``) against the JAX package's, CPU only.

Both are plain Python float arithmetic in the same order, so every number
must be *exactly* the reference's (``==``, never approx):

- ``core.mapping``: Eq. 1 and 2, the NoC grid, the layer plans, Table 3's
  capacities, over a grid of layer shapes;
- ``accelerators``: the MNF, dense and baseline cycle models, the
  utilization curves and ``network_cycles`` for every design on VGG16,
  AlexNet and ALEXNET_FF at both paper profiles;
- ``energy``: every Table 1 shape × density × weight density, for each
  dataflow;
- ``utilization``, ``workloads`` (``analytic_network_stats`` on each
  spec at both profiles) and ``table4`` (every function, and the rows);
- the five benchmark twins' ``derived`` strings, character for
  character.

Then the paper's anchors, held on the port alone, as
``tests/test_costmodel.py`` and ``tests/test_mapping.py`` hold them on the
reference: Fig. 1 (MNF cheapest, its lead growing with sparsity), Fig. 2
(MNF flat, SNAP decaying), Fig. 8 (VGG16 calibrated within 2%, AlexNet
held out within 20%), Table 4 and the worked examples of §5.3.
"""
import importlib
import pathlib
import sys

import pytest

from repro import costmodel as jcm
from repro.core import mapping as jmap
from repro.costmodel import accelerators as jacc
from repro.costmodel import energy as jen
from repro.costmodel import table4 as jt4
from repro.costmodel import utilization as jut
from repro.costmodel import workloads as jwl
from repro.models import cnn as jcnn
from repro_torch import costmodel as tcm
from repro_torch.core import mapping as tmap
from repro_torch.costmodel import accelerators as tacc
from repro_torch.costmodel import energy as ten
from repro_torch.costmodel import table4 as tt4
from repro_torch.costmodel import utilization as tut
from repro_torch.costmodel import workloads as twl
from repro_torch.models import cnn as tcnn

ROOT = pathlib.Path(__file__).resolve().parents[1]
DENSITIES = (1.0, 0.6, 0.3, 0.1, 0.05)
W_DENSITIES = (1.0, 0.6)
DESIGNS = ("mnf", "dense_ideal", "scnn_dense", "scnn", "sparten", "gospa")
SPECS = ("VGG16", "ALEXNET", "ALEXNET_FF")
PROFILES = {"vgg16": (jt4.VGG16_DENSITY_PROFILE, jt4.VGG16_W_DENSITY),
            "alexnet": (jt4.ALEXNET_DENSITY_PROFILE, jt4.ALEXNET_W_DENSITY)}


def test_exports_equal_jax():
    assert tcm.__all__ == jcm.__all__
    for name in jcm.__all__:
        assert hasattr(tcm, name), name
    for mod_t, mod_j in ((tmap, jmap), (ten, jen), (tut, jut), (twl, jwl)):
        assert mod_t.__all__ == mod_j.__all__
    assert set(jacc.__all__) <= set(tacc.__all__)
    assert set(jt4.__all__) <= set(tt4.__all__)


# ---------------------------------------------------------------------------
# constants
# ---------------------------------------------------------------------------

def test_constants_equal_jax():
    assert tacc.PAPER_HW.total_macs == jacc.PAPER_HW.total_macs == 297
    assert (tacc.PAPER_HW.pes, tacc.PAPER_HW.mac_modules_per_pe,
            tacc.PAPER_HW.mults_per_module, tacc.PAPER_HW.freq_hz) == \
        (jacc.PAPER_HW.pes, jacc.PAPER_HW.mac_modules_per_pe,
         jacc.PAPER_HW.mults_per_module, jacc.PAPER_HW.freq_hz)
    assert tacc.FRONTEND_EFF == jacc.FRONTEND_EFF
    assert sorted(tacc.UTIL_CURVES) == sorted(jacc.UTIL_CURVES)
    for e_t, e_j in ((ten.TABLE5_OTHERS, jen.TABLE5_OTHERS),
                     (ten.TABLE5_MNF, jen.TABLE5_MNF)):
        assert vars(e_t) == vars(e_j)
    assert {k: vars(v) for k, v in ten.TABLE1.items()} == \
        {k: vars(v) for k, v in jen.TABLE1.items()}
    assert tt4.PAPER_TABLE4 == jt4.PAPER_TABLE4
    assert tt4.VGG16_DENSITY_PROFILE == jt4.VGG16_DENSITY_PROFILE
    assert tt4.ALEXNET_DENSITY_PROFILE == jt4.ALEXNET_DENSITY_PROFILE
    assert (tt4.VGG16_W_DENSITY, tt4.ALEXNET_W_DENSITY) == \
        (jt4.VGG16_W_DENSITY, jt4.ALEXNET_W_DENSITY)
    assert vars(tmap.PAPER_PE) == vars(jmap.PAPER_PE)


# ---------------------------------------------------------------------------
# core.mapping (§5.3)
# ---------------------------------------------------------------------------

MAP_SHAPES = [(28, 28, 3, 2, 1), (224, 224, 3, 64, 3), (56, 56, 3, 256, 128),
              (13, 13, 3, 384, 256), (55, 55, 11, 96, 3), (4, 4, 3, 512, 512),
              (1, 1, 1, 10, 4096)]
CAPS = [None, (800, 9000), (64, 1000)]


@pytest.mark.parametrize("cap", CAPS, ids=str)
def test_mapping_equals_jax(cap):
    kw_t = {} if cap is None else dict(cap=tmap.PECapacity(*cap))
    kw_j = {} if cap is None else dict(cap=jmap.PECapacity(*cap))
    for ow, oh, k, co, ci in MAP_SHAPES:
        for verbatim in (False, True):
            assert tmap.conv_pes(ow, oh, k, co, ci, paper_verbatim=verbatim,
                                 **kw_t) == \
                jmap.conv_pes(ow, oh, k, co, ci, paper_verbatim=verbatim,
                              **kw_j)
        assert vars(tmap.plan_conv_layer(ow, oh, k, co, ci, **kw_t)) == \
            vars(jmap.plan_conv_layer(ow, oh, k, co, ci, **kw_j))
        for m, n in ((ci * k * k, co), (ow * oh * co, 4096), (1568, 128)):
            assert tmap.fc_pes(m, n, **kw_t) == jmap.fc_pes(m, n, **kw_j)
            assert vars(tmap.plan_fc_layer(m, n, **kw_t)) == \
                vars(jmap.plan_fc_layer(m, n, **kw_j))
    for pes in range(1, 130):
        assert tmap.noc_grid(pes) == jmap.noc_grid(pes)


def test_mapping_paper_examples():
    cap = tmap.PECapacity(neurons=800, weights=9000)
    assert tmap.conv_pes(28, 28, 3, c_out=2, c_in=1, cap=cap) == 2  # Fig. 7
    assert tmap.fc_pes(1568, 128, cap) == 23                       # Eq. 2
    assert tmap.noc_grid(23) == (5, 5) and tmap.noc_grid(1) == (1, 1)
    m = tmap.plan_conv_layer(28, 28, 3, c_out=2, c_in=1, cap=cap)
    assert m.pes == 2 and m.event_fanout == 2 and m.neurons_per_pe == 784
    assert tmap.conv_pes(4, 4, 3, c_out=512, c_in=512, cap=cap) == \
        -(-3 * 3 * 512 * 512 // 9000)                 # weight bound
    assert tmap.PAPER_PE.neurons == int(67.5 * 1024 // 4)  # Table 3
    assert tmap.PAPER_PE.weights == int(691.2 * 1024)


# ---------------------------------------------------------------------------
# accelerators
# ---------------------------------------------------------------------------

def test_layer_cycle_models_equal_jax():
    for c_out in (1, 3, 10, 11, 33, 64, 96, 100, 256, 384, 4096):
        for wd in (1.0, 0.6, 0.596, 0.499, 0.1):
            assert tacc.mnf_channel_util(c_out, wd) == \
                jacc.mnf_channel_util(c_out, wd)
            for n_ev, touched in ((0.0, 9.0), (1.0, 1.0), (1234.5, 6.4),
                                  (802816.0, 9.0)):
                assert tacc.mnf_layer_cycles(n_ev, touched, c_out,
                                             w_density=wd) == \
                    jacc.mnf_layer_cycles(n_ev, touched, c_out,
                                          w_density=wd)
                useful = n_ev * touched * c_out * 0.9
                assert tacc.mnf_utilization(n_ev, touched, c_out, useful) \
                    == jacc.mnf_utilization(n_ev, touched, c_out, useful)
    for macs in (0.0, 1.0, 7840800.0, 1.5e10):
        assert tacc.dense_layer_cycles(macs) == jacc.dense_layer_cycles(macs)
        for design in ("scnn_dense", "scnn", "sparten", "gospa"):
            for d in DENSITIES:
                for wd in W_DENSITIES:
                    assert tacc.baseline_layer_cycles(design, macs, d, wd) \
                        == jacc.baseline_layer_cycles(design, macs, d, wd)


def test_util_curves_equal_jax():
    xs = [i / 200 for i in range(-10, 211)]
    for name in jacc.UTIL_CURVES:
        assert [tacc.UTIL_CURVES[name](x) for x in xs] == \
            [jacc.UTIL_CURVES[name](x) for x in xs]
    pts = [(0.0, 0.5), (0.3, 0.9), (1.0, 0.1)]
    assert [tacc._piecewise(pts)(x) for x in xs] == \
        [jacc._piecewise(pts)(x) for x in xs]


@pytest.mark.parametrize("profile", sorted(PROFILES))
@pytest.mark.parametrize("spec", SPECS)
def test_analytic_stats_and_network_cycles_equal_jax(spec, profile):
    prof, wd = PROFILES[profile]
    st_t = twl.analytic_network_stats(getattr(tcnn, spec), prof)
    st_j = jwl.analytic_network_stats(getattr(jcnn, spec), prof)
    assert st_t == st_j
    assert [type(v) for s in st_t for v in s.values()] == \
        [type(v) for s in st_j for v in s.values()]
    for design in DESIGNS:
        for d_w in (1.0, wd):
            assert tacc.network_cycles(st_t, design, d_w=d_w) == \
                jacc.network_cycles(st_j, design, d_w=d_w), design


# ---------------------------------------------------------------------------
# energy (Fig. 1, Table 5)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layer", sorted(jen.TABLE1))
def test_energy_equals_jax(layer):
    s_t, s_j = ten.TABLE1[layer], jen.TABLE1[layer]
    assert (s_t.stride, s_t.macs, s_t.weights, s_t.inputs, s_t.outputs) == \
        (s_j.stride, s_j.macs, s_j.weights, s_j.inputs, s_j.outputs)
    for d in DENSITIES:
        for wd in W_DENSITIES:
            for flow in ("ws", "is", "os"):
                assert ten.dataflow_energy(s_t, flow, d, wd) == \
                    jen.dataflow_energy(s_j, flow, d, wd)
                assert ten.dataflow_energy(s_t, flow, d, wd,
                                           ten.TABLE5_MNF) == \
                    jen.dataflow_energy(s_j, flow, d, wd, jen.TABLE5_MNF)
            assert ten.mnf_energy(s_t, d, wd) == jen.mnf_energy(s_j, d, wd)
            assert ten.compare_dataflows(s_t, d, wd) == \
                jen.compare_dataflows(s_j, d, wd)
    with pytest.raises(ValueError):
        ten.dataflow_energy(s_t, "rs")


# ---------------------------------------------------------------------------
# utilization (Fig. 2) and Table 4
# ---------------------------------------------------------------------------

def test_utilization_equals_jax():
    for d in DENSITIES + (0.8, 0.4, 0.2, 0.0):
        for c_out in (384, 96, 100, 7):
            assert tut.mnf_utilization_at_density(d, c_out=c_out) == \
                jut.mnf_utilization_at_density(d, c_out=c_out)
        for wd in W_DENSITIES:
            assert tut.snap_utilization_at_density(d, wd) == \
                jut.snap_utilization_at_density(d, wd)
    assert tut.utilization_sweep() == jut.utilization_sweep()
    assert tut.utilization_sweep(DENSITIES, c_out=100) == \
        jut.utilization_sweep(DENSITIES, c_out=100)


@pytest.mark.parametrize("spec", SPECS)
def test_table4_equals_jax(spec):
    for prof, wd in PROFILES.values():
        st_t = twl.analytic_network_stats(getattr(tcnn, spec), prof)
        st_j = jwl.analytic_network_stats(getattr(jcnn, spec), prof)
        for d_w in (1.0, wd):
            assert tt4.frames_per_second(st_t, w_density=d_w) == \
                jt4.frames_per_second(st_j, w_density=d_w)
            assert tt4.power_mw(st_t, w_density=d_w) == \
                jt4.power_mw(st_j, w_density=d_w)
            assert tt4.frames_per_joule(st_t, w_density=d_w) == \
                jt4.frames_per_joule(st_j, w_density=d_w)
            assert tt4.table4_row(st_t, w_density=d_w) == \
                jt4.table4_row(st_j, w_density=d_w)
        assert tt4.dynamic_energy_pj(st_t) == jt4.dynamic_energy_pj(st_j)
        assert tt4.power_mw(st_t, static_mw=80.0, idle_reduction=0.5) == \
            jt4.power_mw(st_j, static_mw=80.0, idle_reduction=0.5)


# ---------------------------------------------------------------------------
# the paper's anchors, on the port
# ---------------------------------------------------------------------------

def test_fig1_mnf_cheapest_and_lead_grows():
    for shape in ten.TABLE1.values():
        for d in (1.0, 0.6, 0.3, 0.1):
            e = ten.compare_dataflows(shape, d, 0.6)
            assert e["mnf"] == min(e.values())
    gains = []
    for d in (1.0, 0.6, 0.3, 0.1):
        e = ten.compare_dataflows(ten.TABLE1["layer1"], d, 0.6)
        gains.append(min(e["ws"], e["inp"], e["os"]) / e["mnf"])
    assert gains == sorted(gains)


def test_fig2_mnf_flat_snap_decays():
    mnf = [tut.mnf_utilization_at_density(d) for d in DENSITIES]
    snap = [tut.snap_utilization_at_density(d) for d in DENSITIES]
    assert min(mnf) > 0.9 and max(mnf) - min(mnf) < 0.08
    assert snap[0] > snap[-1] and snap[-1] < 0.5


def test_fig8_and_table4_anchors():
    stats = twl.analytic_network_stats(tcnn.VGG16, tt4.VGG16_DENSITY_PROFILE)
    mnf = tacc.network_cycles(stats, "mnf", d_w=tt4.VGG16_W_DENSITY)
    for design, paper in (("scnn_dense", 19.0), ("scnn", 8.31),
                          ("sparten", 3.15), ("gospa", 2.57)):
        ours = tacc.network_cycles(stats, design,
                                   d_w=tt4.VGG16_W_DENSITY) / mnf
        assert ours == pytest.approx(paper, rel=0.02), design
    stats = twl.analytic_network_stats(tcnn.ALEXNET,
                                       tt4.ALEXNET_DENSITY_PROFILE)
    mnf = tacc.network_cycles(stats, "mnf", d_w=tt4.ALEXNET_W_DENSITY)
    for design, paper in (("scnn", 7.32), ("sparten", 3.51),
                          ("gospa", 2.68)):
        ours = tacc.network_cycles(stats, design,
                                   d_w=tt4.ALEXNET_W_DENSITY) / mnf
        assert abs(ours - paper) / paper < 0.20, (design, ours)
    for name, spec in (("vgg16", tcnn.VGG16), ("alexnet", tcnn.ALEXNET)):
        prof, wd = PROFILES[name]
        r = tt4.table4_row(twl.analytic_network_stats(spec, prof),
                           w_density=wd)
        p = tt4.PAPER_TABLE4[name]
        assert r["frames_s"] == pytest.approx(p["frames_s"], rel=0.02)
        assert r["power_mw"] == pytest.approx(p["power_mw"], rel=0.30)
        assert r["frames_j"] == pytest.approx(p["frames_j"], rel=0.30)


# ---------------------------------------------------------------------------
# the benchmark twins
# ---------------------------------------------------------------------------

BENCHES = ("fig1_dataflow_energy", "fig2_utilization", "fig8_cycles",
           "table4_comparison", "table5_memory_energy")


@pytest.fixture(scope="module")
def benchmarks_pkg():
    sys.path.insert(0, str(ROOT))
    try:
        yield importlib.import_module("benchmarks")
    finally:
        sys.path.remove(str(ROOT))


@pytest.mark.parametrize("name", BENCHES)
def test_benchmark_twin_rows_equal_jax(benchmarks_pkg, name):
    jmod = importlib.import_module(f"benchmarks.{name}")
    tmod = importlib.import_module(f"benchmarks.torch_{name}")
    want = [(n, derived) for n, _, derived in jmod.rows()]
    got = [(n, derived) for n, _, derived in tmod.rows()]
    assert got == want


def test_paper_fig8_ratios_equal_jax_benchmark(benchmarks_pkg):
    # the port keeps Fig. 8's paper ratios beside Table 4's; the JAX
    # package keeps them in its benchmark
    jmod = importlib.import_module("benchmarks.fig8_cycles")
    assert tt4.PAPER_RATIOS == jmod.PAPER_RATIOS


def test_benchmark_twin_harness_lists_the_five(benchmarks_pkg):
    """The five paper twins, then the dry run's roofline rows."""
    run = importlib.import_module("benchmarks.torch_run")
    assert [tag for tag, _ in run.MODULES] == \
        ["fig1", "fig2", "fig8", "table4", "table5", "roofline"]
    assert [m.__name__ for _, m in run.MODULES] == \
        [f"benchmarks.torch_{n}" for n in BENCHES + ("roofline_table",)]
