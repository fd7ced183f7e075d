"""The port's roofline (``launch.roofline``) and report (``launch.report``)
against the JAX package's, on the CPU:

- ``configs.SHAPES`` equals the JAX package's, and ``model_flops`` is
  ``==`` JAX's for every arch of the registry at every shape;
- ``count_cost`` counts one matmul's FLOPs and bytes exactly (the twin of
  ``tests/test_hlo_analysis.py``'s single-matmul case);
- each kernel wrapper (B1-B10) called on CPU tensors inside
  ``count_cost`` counts its kernel's formula — the function
  ``chip_smoke.py`` bounds the kernel with — and none of its plain
  version's aten ops, and launches nothing;
- the remat policies' recomputation shows in the count: on a reduced
  Qwen2, loss and gradients count 3x the forward's FLOPs under "none",
  more under "dots" (the attention products recomputed), more again and
  at most 4x under "full";
- RWKV6's gated decode step counts one B7 call a layer through its
  formula, and its memory term is at least its bf16 weights' bytes over
  the HBM rate;
- ``report``'s markdown tables and summary equal the JAX package's on the
  same records (written to ``tmp_path``, JAX's ``RESULTS`` pointed there),
  at the JAX package's hardware numbers (the port's over-memory list,
  ``over_hbm``, at JAX's 16 GiB is its ``over_16g``).
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.launch import report as jreport
from repro.launch import roofline as jroofline
from repro_torch import engine as tengine
from repro_torch.configs import SHAPES, ShapeConfig, get_config
from repro_torch.core import events as tev
from repro_torch.core import quantize as qz
from repro_torch.kernels.event_conv.ops import (conv_work, event_conv,
                                                event_conv_dequant,
                                                strip_conv_inputs)
from repro_torch.kernels.event_matmul.ops import (event_matmul,
                                                  event_matmul_dequant,
                                                  matmul_work)
from repro_torch.kernels.event_pool.ops import (event_pool,
                                                event_pool_window,
                                                pool_inputs,
                                                pool_window_inputs,
                                                pool_work)
from repro_torch.kernels.fire_compact.ops import fire_compact, fire_work
from repro_torch.kernels.mamba_scan.ops import (mamba_scan,
                                                mamba_scan_fused,
                                                mamba_scan_fused_work,
                                                mamba_scan_work)
from repro_torch.kernels.mamba_step.ops import mamba_step_events, mamba_work
from repro_torch.kernels.wkv6.ops import wkv6, wkv6_scan_work, wkv6_single
from repro_torch.kernels.wkv6_step.ops import wkv6_step_events, wkv6_work
from repro_torch.launch import report as treport
from repro_torch.launch import roofline as troofline
from repro_torch.launch import serve
from repro_torch.models import transformer as ttfm
from repro_torch.models.param_utils import tree_leaves, tree_map


def test_shapes_equal_jax():
    assert list(SHAPES) == list(JSHAPES)
    for name, shape in SHAPES.items():
        assert dataclasses.asdict(shape) == dataclasses.asdict(JSHAPES[name])


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_equal_jax(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    for name in SHAPES:
        assert troofline.model_flops(cfg, SHAPES[name]) == \
            jroofline.model_flops(jcfg, JSHAPES[name]), name


def test_hw_is_the_h100_datasheet():
    hw = troofline.HW()
    assert (hw.peak_flops, hw.hbm_bw, hw.link_bw, hw.hbm_bytes) == (
        989e12, 3.35e12, 900e9, 80e9)


def test_single_matmul_exact():
    a, b = torch.randn(256, 512), torch.randn(512, 128)
    out, cost = troofline.count_cost(torch.matmul, a, b)
    assert cost.flops == 2 * 256 * 512 * 128
    assert cost.bytes == (256 * 512 + 512 * 128 + 256 * 128) * 4
    assert cost.kernels == {} and tuple(out.shape) == (256, 128)
    # views move nothing
    _, cost = troofline.count_cost(lambda: a.T[:10].unsqueeze(0))
    assert cost.bytes == 0 and cost.flops == 0


# ---------------------------------------------------------------------------
# Each kernel's work: its formula, whatever implements it
# ---------------------------------------------------------------------------

def _relu(*shape, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.relu(torch.randn(shape, generator=g))


def _rand(*shape, seed, lo=None):
    g = torch.Generator().manual_seed(seed)
    if lo is not None:
        return lo + (1 - lo) * torch.rand(shape, generator=g)
    return torch.randn(shape, generator=g)


def _kernel_calls():
    """(wrapper, args, kwargs, its formula's (bytes, operations)) for
    each of the thirteen wrappers, on small CPU inputs."""
    out = []
    acc = _rand(16, 64, seed=0)
    out.append((fire_compact, (acc,), dict(blk_m=8, blk_k=8),
                lambda y: fire_work(acc, blk_m=8, blk_k=8)))
    bev = tev.encode_block_events(_relu(16, 64, seed=1), blk_m=8, blk_k=8)
    wm = _rand(64, 16, seed=2)
    mm = (bev.values, bev.block_idx, bev.counts, wm)
    out.append((event_matmul, mm, {}, lambda y: matmul_work(*mm)))
    qp = qz.calibrate(_relu(16, 64, seed=1))
    bev8 = tev.encode_block_events(qz.quantize(_relu(16, 64, seed=1), qp),
                                   blk_m=8, blk_k=8)
    mm8 = (bev8.values, bev8.block_idx, bev8.counts, qp.scale,
           qp.zero_point, wm)
    out.append((event_matmul_dequant, mm8, {},
                lambda y: matmul_work(*mm8[:3], wm, qbytes=8)))
    strip = tengine.EventStream.encode_nhwc(_relu(1, 4, 16, 8, seed=3),
                                            blk_k=8, blk_m=8,
                                            keep_dense=False)
    cargs, nkb = strip_conv_inputs(strip, _rand(3, 3, 8, 8, seed=4),
                                   stride=1, padding=1)
    ckw = dict(nkb=nkb, row_stride=1)
    out.append((event_conv, cargs, ckw, lambda y: conv_work(cargs, 1)))
    codes = torch.clamp(torch.round(cargs[0] * 20), -127, 127).to(torch.int8)
    c8 = (codes, *cargs[1:6], qp.scale, qp.zero_point, cargs[6])
    out.append((event_conv_dequant, c8, ckw,
                lambda y: conv_work((*c8[:6], c8[8]), 1, qbytes=8)))
    pix = tengine.EventStream.encode_nhwc(_relu(1, 8, 8, 16, seed=5),
                                          blk_k=8, blk_m=1, keep_dense=False)
    pargs = pool_inputs(pix, 2, 2)
    out.append((event_pool, pargs, dict(nkb=2),
                lambda y: pool_work(pargs[0], pargs[4], y.numel())))
    wargs = pool_window_inputs(strip, 2, 2)
    out.append((event_pool_window, wargs, dict(nkb=1, row_stride=2),
                lambda y: pool_work(wargs[0], wargs[4], y.numel())))
    g, d = 6, 20
    st = tengine.fire_delta(_rand(g, d, seed=6))
    r, v, w, u, s = (_rand(g, d, seed=7), _rand(g, d, seed=8),
                     _rand(g, d, seed=9, lo=0.05), _rand(g, d, seed=10),
                     _rand(g, d, d, seed=11))
    bk = st.events.values.shape[-1]
    out.append((wkv6_step_events, (st.events, r, v, w, u, s), dict(blk_k=bk),
                lambda y: wkv6_work(st.events, r)))
    gm = tengine.fire_delta(_rand(4, 40, seed=12))
    da, h = _rand(4, 40, 4, seed=13, lo=0.05), _rand(4, 40, 4, seed=14)
    bm, cm = _rand(4, 4, seed=15), _rand(4, 4, seed=16)
    out.append((mamba_step_events, (gm.events, da, bm, cm, h),
                dict(blk_k=gm.events.values.shape[-1]),
                lambda y: mamba_work(gm.events, h)))
    rk = [_rand(2, 5, 16, seed=17 + i) for i in range(3)] + \
        [_rand(2, 5, 16, seed=20, lo=0.05), _rand(16, seed=21)]
    out.append((wkv6_single, tuple(rk), {},
                lambda y: wkv6_scan_work(*rk)))
    rh = [_rand(2, 3, 5, 16, seed=22 + i) for i in range(3)] + \
        [_rand(2, 3, 5, 16, seed=25, lo=0.05), _rand(3, 16, seed=26),
         _rand(2, 3, 16, 16, seed=27)]
    out.append((wkv6, tuple(rh), {}, lambda y: wkv6_scan_work(*rh)))
    sa = (_rand(2, 5, 8, 4, seed=28, lo=0.05), _rand(2, 5, 8, 4, seed=29),
          _rand(2, 5, 4, seed=30), _rand(2, 8, 4, seed=31))
    out.append((mamba_scan, sa, {}, lambda y: mamba_scan_work(*sa)))
    fa = (_rand(2, 5, 8, seed=32, lo=0.01), _rand(2, 5, 8, seed=33),
          -_rand(8, 4, seed=34, lo=0.1), _rand(2, 5, 4, seed=35),
          _rand(2, 5, 4, seed=36))
    out.append((mamba_scan_fused, fa, {},
                lambda y: mamba_scan_fused_work(*fa)))
    return out


def test_every_kernel_counts_its_formula_on_the_cpu():
    calls = _kernel_calls()
    assert len({fn.__name__ for fn, *_ in calls}) == 13
    for fn, args, kw, formula in calls:
        launches = fn.launches
        y, cost = troofline.count_cost(fn, *args, **kw)
        nbytes, ops = formula(y[0] if isinstance(y, tuple) else y)
        assert cost.kernels == {fn.__name__: [1, nbytes, ops]}, fn.__name__
        assert (cost.aten_flops, cost.aten_bytes) == (0.0, 0.0), fn.__name__
        assert (cost.flops, cost.bytes) == (ops, nbytes)
        assert fn.launches == launches
        # outside the count the wrapper runs as it did
        y2 = fn(*args, **kw)
        for a, b in zip(y if isinstance(y, tuple) else (y,),
                        y2 if isinstance(y2, tuple) else (y2,)):
            assert torch.equal(a, b)


def test_nested_wrapper_counts_once():
    """``event_matmul`` handed int8 codes calls ``event_matmul_dequant``:
    one call counted, with the dequantization's bytes."""
    qp = qz.calibrate(_relu(16, 64, seed=1))
    bev8 = tev.encode_block_events(qz.quantize(_relu(16, 64, seed=1), qp),
                                   blk_m=8, blk_k=8)
    wm = _rand(64, 16, seed=2)
    args = (bev8.values, bev8.block_idx, bev8.counts, wm)
    _, cost = troofline.count_cost(event_matmul, *args, qparams=qp)
    assert cost.kernels == {"event_matmul": [
        1, *matmul_work(*args, qbytes=8)]}


# ---------------------------------------------------------------------------
# Steps
# ---------------------------------------------------------------------------

def _grad_flops(cfg, params, batch):
    def loss_and_grads():
        leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
        loss = ttfm.lm_loss(leaves, batch, cfg)
        return torch.autograd.grad(loss, tree_leaves(leaves))
    return troofline.count_cost(loss_and_grads)[1].flops


def test_remat_recomputation_shows_in_the_count():
    cfg = get_config("qwen2-0.5b").reduced(compute_dtype="float32")
    params = ttfm.init_params(0, cfg, "cpu")
    g = torch.Generator().manual_seed(0)
    toks = torch.randint(0, cfg.vocab_size, (2, 32), generator=g)
    batch = dict(tokens=toks, labels=toks)
    with torch.no_grad():
        fwd = troofline.count_cost(ttfm.lm_loss, params, batch, cfg)[1].flops
    counts = {r: _grad_flops(dataclasses.replace(cfg, remat=r), params,
                             batch) for r in ("none", "dots", "full")}
    assert counts["none"] == 3 * fwd
    # "full" recomputes each region's forward up to the last tensor its
    # backward needs (torch's checkpoint stops there): at most once more
    assert 3 * fwd < counts["dots"] < counts["full"] <= 4 * fwd


def test_rwkv6_gated_decode_counts_b7_through_its_formula():
    cfg = get_config("rwkv6-7b").reduced()
    params = ttfm.compute_params(ttfm.init_params(0, cfg, "cpu"), cfg)
    prompts = serve.make_prompts(cfg, 2, 8, 0, "cpu")
    _, cache = ttfm.prefill(params, prompts, cfg, max_len=9)
    _, cost = troofline.count_cost(ttfm.decode_step, params, cache,
                                   prompts[:, -1:], 8, cfg)
    calls, nbytes, ops = cost.kernels["wkv6_step_events"]
    assert calls == cfg.num_layers and nbytes > 0 and ops > 0
    assert set(cost.kernels) == {"wkv6_step_events"}
    rep = troofline.analyze("rwkv6-7b", cfg, ShapeConfig("d", 9, 2,
                                                         "decode"),
                            "1", 1, cost, 0)
    weights = sum(t.numel() * 2 for t in tree_leaves(params)
                  if t.dtype == torch.bfloat16)
    assert rep.t_memory >= weights / troofline.HW().hbm_bw
    assert rep.bottleneck == "memory" and rep.t_collective == 0.0


# ---------------------------------------------------------------------------
# The report
# ---------------------------------------------------------------------------

def _records():
    """Records in the JAX package's schema: analyzed cells (the port's
    ``RooflineReport.to_json()``), a skipped and a failed cell, another
    mesh and another tag."""
    recs = []
    for i, (arch, shape) in enumerate([("qwen2-0.5b", "train_4k"),
                                       ("gemma2-27b", "decode_32k"),
                                       ("deepseek-moe-16b", "prefill_32k"),
                                       ("rwkv6-7b", "long_500k")]):
        cfg = get_config(arch)
        cost = troofline.Cost(flops=3.1e15 * (i + 1), bytes=7.7e12 / (i + 1),
                              aten_flops=3e15, aten_bytes=7e12, kernels={})
        rep = troofline.analyze(arch, cfg, SHAPES[shape], "16x16", 256, cost,
                                (i + 3) * 6 * 2 ** 30)
        recs.append(dict(arch=arch, shape=shape, mesh="16x16", tag="",
                         status="ok", lower_s=1.5 * i, compile_s=9.25 + i,
                         roofline=rep.to_json()))
    recs.append(dict(arch="whisper-base", shape="long_500k", mesh="16x16",
                     tag="", status="skipped",
                     reason="quadratic: attention at 524288"))
    recs.append(dict(arch="hymba-1.5b", shape="train_4k", mesh="16x16",
                     tag="", status="error", error="ValueError: x"))
    recs.append(dict(recs[0], mesh="2x16x16"))
    recs.append(dict(recs[1], tag="other"))
    return recs


def test_report_equals_jax(tmp_path, monkeypatch):
    for i, rec in enumerate(_records()):
        (tmp_path / f"r{i}.json").write_text(json.dumps(rec))
    monkeypatch.setattr(jreport, "RESULTS", str(tmp_path))
    monkeypatch.setattr(treport, "RESULTS", str(tmp_path))
    # the JAX package's chip: its peaks, and the 16 GiB its summary flags
    jhw = jroofline.HW()
    hw = troofline.HW(peak_flops=jhw.peak_flops, hbm_bw=jhw.hbm_bw,
                      link_bw=jhw.link_bw, hbm_bytes=16 * 2 ** 30)
    monkeypatch.setattr(treport, "HW", lambda: hw)
    for tag in ("", "other"):
        want = jreport.summarize(tag)
        want["over_hbm"] = want.pop("over_16g")
        assert treport.summarize(tag) == want
        assert treport.dryrun_markdown(tag) == jreport.dryrun_markdown(tag)
        for mesh in ("16x16", "2x16x16"):
            assert treport.roofline_markdown(tag, mesh) == \
                jreport.roofline_markdown(tag, mesh)
    assert want["over_hbm"], "no record over the memory: the list untested"
    assert treport.summarize()["ok"] == 5
    assert np.isclose(treport.load()[0]["roofline"]["model_gflops"],
                      jreport.load()[0]["roofline"]["model_gflops"])
