"""B10's backward on the CPU against the JAX package: the same numpy inputs
through both.

- The JAX side: ``jax.vjp`` of a function that forms da = exp(dt A) and
  dbx = (dt x) B as ``repro.models.ssm.mamba_apply`` does and runs
  ``repro.kernels.mamba_scan.ref.mamba_scan_ref`` (the JAX package has no
  backward kernel: it differentiates its scan), with h0 != 0 and both
  cotangents (gy on y, gh on the final state) non-zero.
- The port's side: the plain reverse scan ``mamba_scan_fused_bwd_ref``,
  and the fused entry's ``autograd.Function`` (``mamba_scan_fused`` under
  autograd).  Every gradient within 1e-4 of max|JAX| in f32; bf16 inputs
  give gradients in bf16, the f32 ones rounded; ``gradcheck`` at f64.
- Meta tensors (the dry run's): the forward and the backward give the
  CPU's shapes and dtypes, launch nothing, and ``kernels.count_work``
  counts one call of each by its formula.
- The reduced Hymba train step differentiates through the Function: one
  backward a layer and scan chunk, the forward again under remat.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mamba_scan.ref import mamba_scan_ref as j_mamba_scan_ref
from repro_torch import kernels
from repro_torch.configs import get_config
from repro_torch.data import TokenStreamConfig, markov_lm_batch
from repro_torch.kernels.mamba_scan import ops
from repro_torch.kernels.mamba_scan.ops import (mamba_scan_fused,
                                                mamba_scan_fused_bwd,
                                                mamba_scan_fused_bwd_work,
                                                mamba_scan_fused_work)
from repro_torch.kernels.mamba_scan.ref import mamba_scan_fused_bwd_ref
from repro_torch.models import transformer as ttfm
from repro_torch.models.param_utils import tree_leaves, tree_map

TOL = 1e-4
NAMES = ("dt", "x", "A", "B", "C", "h0")


def _inputs(seed, b=2, t=13, di=24, n=4):
    """dt (softplus of a normal), x, B, C (normal), A = -exp(log 1..n) as
    the Mamba init makes it, h0, and the cotangents gy and gh (normal);
    f32 numpy."""
    r_ = np.random.default_rng(seed)
    f = lambda *s: r_.normal(size=s).astype(np.float32)
    dt = np.log1p(np.exp(f(b, t, di))).astype(np.float32)
    a = -np.tile(np.arange(1, n + 1, dtype=np.float32), (di, 1))
    return (dt, f(b, t, di), a, f(b, t, n), f(b, t, n), f(b, di, n),
            f(b, t, di), f(b, di, n))


def _jax_grads(dt, x, a, bm, cm, h0, gy, gh):
    """jax.vjp of the JAX prefill's stream forming and its scan oracle."""
    def fwd(dt, x, a, bm, cm, h0):
        da = jnp.exp(dt[..., None] * a)
        dbx = (dt * x)[..., None] * bm[..., None, :]
        return j_mamba_scan_ref(da, dbx, cm, h0)
    _, vjp = jax.vjp(fwd, *map(jnp.asarray, (dt, x, a, bm, cm, h0)))
    return [np.asarray(g) for g in vjp((jnp.asarray(gy), jnp.asarray(gh)))]


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("shape", [(2, 13, 24, 4), (1, 40, 40, 16)])
def test_plain_backward_matches_jax_vjp(shape):
    """The plain reverse scan, h0 and both cotangents non-zero: every
    gradient within 1e-4 of max|JAX|."""
    b, t, di, n = shape
    vals = _inputs(sum(shape), b, t, di, n)
    want = _jax_grads(*vals)
    got = mamba_scan_fused_bwd_ref(*map(torch.from_numpy, vals))
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape, name
        assert _rel(g, w) <= TOL, (name, _rel(g, w))


@pytest.mark.parametrize("with_h0", [False, True])
def test_autograd_function_matches_jax_vjp(with_h0):
    """``mamba_scan_fused`` under autograd (the Function) on T-sliced
    inputs, as the prefill hands a chunk: every gradient within 1e-4 of
    JAX's, bitwise the plain backward's, no launch counted on the CPU;
    without h0 the state starts at 0 and has no gradient."""
    dt, x, a, bm, cm, h0, gy, gh = _inputs(7 + with_h0, t=20)
    sl = slice(3, 16)
    vals = [v[:, sl] for v in (dt, x)] + [a] + [v[:, sl] for v in (bm, cm)]
    vals += [h0 if with_h0 else np.zeros_like(h0), gy[:, sl], gh]
    want = _jax_grads(*vals)
    full = [torch.from_numpy(v).requires_grad_() for v in (dt, x, a, bm, cm)]
    h0_t = torch.from_numpy(h0).requires_grad_() if with_h0 else None
    args = [full[0][:, sl], full[1][:, sl], full[2], full[3][:, sl],
            full[4][:, sl], h0_t]
    launches = (mamba_scan_fused.launches, mamba_scan_fused_bwd.launches)
    y, h = mamba_scan_fused(*args)
    ((y * torch.from_numpy(gy[:, sl])).sum()
     + (h * torch.from_numpy(gh)).sum()).backward()
    assert (mamba_scan_fused.launches,
            mamba_scan_fused_bwd.launches) == launches
    plain = mamba_scan_fused_bwd_ref(
        *[t.detach() for t in args[:5]],
        None if h0_t is None else h0_t.detach(),
        torch.from_numpy(gy[:, sl]), torch.from_numpy(gh))
    leaves = [full[0].grad[:, sl], full[1].grad[:, sl], full[2].grad,
              full[3].grad[:, sl], full[4].grad[:, sl],
              None if h0_t is None else h0_t.grad]
    for name, g, p, w in zip(NAMES, leaves, plain, want):
        if name == "h0" and not with_h0:
            assert p is None
            continue
        assert torch.equal(g, p), name
        assert _rel(g, w) <= TOL, (name, _rel(g, w))
    # outside the chunk the inputs get exact zeros
    assert not full[0].grad[:, :3].any() and not full[3].grad[:, 16:].any()


def test_bf16_gradients_are_the_f32_ones_rounded():
    """bf16 dt, x, B and C: the gradients come back in bf16, each the f32
    gradient of the same (rounded) values cast to bf16; A and h0 f32."""
    dt, x, a, bm, cm, h0, gy, gh = map(torch.from_numpy, _inputs(3))
    rows = [v.to(torch.bfloat16) for v in (dt, x, bm, cm)]
    got = mamba_scan_fused_bwd(rows[0], rows[1], a, rows[2], rows[3], h0,
                               gy, gh)
    f32 = mamba_scan_fused_bwd_ref(rows[0].float(), rows[1].float(), a,
                                   rows[2].float(), rows[3].float(), h0, gy,
                                   gh)
    for name, g, w, src in zip(NAMES, got, f32, (rows[0], rows[1], a,
                                                  rows[2], rows[3], h0)):
        assert g.dtype == src.dtype, name
        assert torch.equal(g, w.to(src.dtype)), name


def test_gradcheck_f64():
    """``torch.autograd.gradcheck`` through the Function at f64 (the plain
    versions compute in f64 for f64 inputs), h0 given, T 5."""
    r_ = np.random.default_rng(11)
    b, t, di, n = 1, 5, 3, 2
    f = lambda *s: torch.from_numpy(r_.normal(size=s)).requires_grad_()
    dt = torch.from_numpy(np.log1p(np.exp(r_.normal(size=(b, t, di))))
                          ).requires_grad_()
    a = torch.from_numpy(-np.tile(np.arange(1.0, n + 1), (di, 1))
                         ).requires_grad_()
    args = (dt, f(b, t, di), a, f(b, t, n), f(b, t, n), f(b, di, n))
    assert torch.autograd.gradcheck(mamba_scan_fused, args)


def test_meta_branch_shapes_and_counted_work():
    """Meta tensors: the forward's and the backward's outputs have the CPU
    outputs' shapes and dtypes, nothing launches, and ``count_work``
    counts one call of each wrapper by its formula (gy and gh given)."""
    vals = _inputs(5)
    cpu = [torch.from_numpy(v).requires_grad_() for v in vals[:6]]
    meta = [torch.empty(v.shape, dtype=torch.float32, device="meta"
                        ).requires_grad_() for v in vals[:6]]
    gy, gh = torch.from_numpy(vals[6]), torch.from_numpy(vals[7])
    y_c, h_c = mamba_scan_fused(*cpu)
    g_c = torch.autograd.grad((y_c * gy).sum() + (h_c * gh).sum(), cpu)
    launches = (mamba_scan_fused.launches, mamba_scan_fused_bwd.launches)
    with kernels.count_work() as work:
        y_m, h_m = mamba_scan_fused(*meta)
        g_m = torch.autograd.grad((y_m * gy.to("meta")).sum()
                                  + (h_m * gh.to("meta")).sum(), meta)
    assert (mamba_scan_fused.launches,
            mamba_scan_fused_bwd.launches) == launches
    for u, v in zip((y_c, h_c, *g_c), (y_m, h_m, *g_m)):
        assert v.device.type == "meta"
        assert (u.shape, u.dtype) == (v.shape, v.dtype)
    gy_m = torch.empty(gy.shape, device="meta")
    gh_m = torch.empty(gh.shape, device="meta")
    fwd = mamba_scan_fused_work(*meta)
    bwd = mamba_scan_fused_bwd_work(*meta, gy_m, gh_m)
    assert work == {"mamba_scan_fused": [1, fwd[0], fwd[1]],
                    "mamba_scan_fused_bwd": [1, bwd[0], bwd[1]]}
    b, t, di = vals[0].shape
    assert bwd[1] == b * t * di * (20.0 * vals[2].shape[1] + 4.0)


def test_launcher_refuses_cpu_tensors_and_other_state_widths():
    """The backward's launcher takes CUDA tensors only; the wrapper hands
    a CPU call to the plain version."""
    from repro_torch.kernels.mamba_scan.kernel import (BWD_N,
                                                       mamba_scan_fused_bwd_cuda)
    z = torch.zeros
    with pytest.raises(ValueError, match="CUDA tensors only"):
        mamba_scan_fused_bwd_cuda(z((1, 3, 4)), z((1, 3, 4)), z((4, 2)),
                                  z((1, 3, 2)), z((1, 3, 2)), None,
                                  z((1, 3, 4)), None)
    assert BWD_N == (1, 2, 4, 8, 16, 32)


@pytest.mark.parametrize("remat", ["none", "full"])
def test_reduced_hymba_train_step_runs_the_backward(remat):
    """The reduced Hymba's ``lm_loss`` gradient (T 40, scan chunk 16: three
    chunks a layer) calls the backward once a layer and chunk, and the
    forward once more under remat; the loss and gradients equal those of
    the same step with the scan differentiated by autograd through its
    plain forward (the Function swapped out) within 1e-4 of max|plain|."""
    cfg = get_config("hymba-1.5b").reduced(compute_dtype="float32")
    cfg = dataclasses.replace(cfg, remat=remat, ssm=dataclasses.replace(
        cfg.ssm, scan_chunk=16))
    params = ttfm.init_params(0, cfg, "cpu")
    batch = markov_lm_batch(TokenStreamConfig(
        vocab_size=cfg.vocab_size, seq_len=40, global_batch=2), 0,
        device="cpu")

    def grads():
        p = tree_map(lambda t: t.detach().requires_grad_(), params)
        loss = ttfm.lm_loss(p, batch, cfg)
        return loss.detach(), torch.autograd.grad(loss, tree_leaves(p),
                                                  allow_unused=True)

    with kernels.count_work() as work:
        loss, g = grads()
    chunks = -(-40 // 16) * cfg.num_layers
    assert work["mamba_scan_fused_bwd"][0] == chunks
    assert work["mamba_scan_fused"][0] == chunks * (1 if remat == "none"
                                                    else 2)
    orig = ops._FusedScan.apply
    try:
        ops._FusedScan.apply = staticmethod(
            lambda *a: ops.mamba_scan_fused_ref(*a))
        loss2, g2 = grads()
    finally:
        ops._FusedScan.apply = orig
    assert abs(float(loss) - float(loss2)) <= TOL * abs(float(loss2))
    scale = max(float(u.abs().max()) for u in g2 if u is not None)
    worst = max(float((u - v).abs().max()) for u, v in zip(g, g2)
                if v is not None)
    assert worst <= TOL * scale, worst / scale

