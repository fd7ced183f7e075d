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
- A model of the backward kernel's schedule (``csrc/mamba_scan.cu``
  ``mnf_mamba_scan_bwd``) in plain torch: checkpoints every S steps,
  each segment recomputed from its checkpoint and walked back, dB and dC
  summed over a warp's channels by the shuffles' tree, the warps in
  order, then the CTA columns in order, dA over the batch rows; held
  against ``jax.vjp`` at the segment boundaries.  It checks the design,
  not the kernel: the card tests hold the kernel at the same boundaries.
  The launcher's scratch (``bwd_plan``, ``mamba_scan_fused_bwd_scratch``)
  holds no (B, T, DI, N) term, and its constants are the source's.
"""
import pathlib
import re

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
from repro_torch.kernels.mamba_scan.kernel import (
    BWD_CHANNELS4, BWD_N, BWD_SEG, BWD_THREADS1, bwd_plan,
    mamba_scan_fused_bwd_scratch)
from repro_torch.kernels.mamba_scan.ref import (mamba_scan_fused_bwd_ref,
                                                mamba_scan_streams)
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



def _column_sums(prod, plan):
    """(ncol, B, N): a step's dB or dC products (B, DI, N) summed over
    each CTA column's channels in the kernel's order: a warp's channels by
    the shuffles' tree (at V 4 the channels 4 apart first, ``reduce_steps
    <8, 4>``; at V 1 the neighbours first), then the warps in order."""
    b, di, n = prod.shape
    cpc, ncol = plan["cpc"], plan["ncol"]
    per_warp = 32 * plan["v"] // n
    x = torch.nn.functional.pad(prod, (0, 0, 0, ncol * cpc - di))
    x = x.reshape(b, ncol, cpc // per_warp, per_warp, n)
    while x.shape[3] > 1:
        h = x.shape[3] // 2
        x = (x[:, :, :, :h] + x[:, :, :, h:] if plan["v"] == 4
             else x[:, :, :, 0::2] + x[:, :, :, 1::2])
    s = x[:, :, 0, 0]
    for w in range(1, x.shape[2]):
        s = s + x[:, :, w, 0]
    return s.transpose(0, 1)


def _schedule_bwd(dt, x, a, bm, cm, h0, gy, gh):
    """A model of the backward kernel's schedule in plain torch (f32),
    with its constants (``bwd_plan``): the forward walk keeps the state
    entering each segment of S steps; segments last to first, each
    recomputed from its checkpoint and walked back carrying lambda; dB
    and dC of a step summed over each CTA column's channels
    (:func:`_column_sums`), then over the columns in order; dA's
    per-batch-row partials summed over the rows in order.  It tests the
    design's indices at the segment boundaries, not the kernel, which the
    card tests hold against the plain version at the same boundaries."""
    b, t, di = dt.shape
    n = a.shape[-1]
    plan = bwd_plan(t, di, n)
    seg, ncol = BWD_SEG, plan["ncol"]
    da, dbx, c = mamba_scan_streams(dt, x, a, bm, cm)
    u = dt * x
    zeros = lambda *s: torch.zeros(s, dtype=torch.float32)
    h = zeros(b, di, n) if h0 is None else h0.clone()
    cks = []
    for k in range(plan["nseg"]):
        cks.append(h)
        if k + 1 == plan["nseg"]:
            break
        for i in range(k * seg, (k + 1) * seg):
            h = da[:, i] * h + dbx[:, i]
    lam = zeros(b, di, n) if gh is None else gh.clone()
    acc_a = zeros(b, di, n)
    g_dt, g_x = zeros(b, t, di), zeros(b, t, di)
    part = zeros(2, ncol, b, t, n)
    for k in reversed(range(plan["nseg"])):
        t0, t1 = k * seg, min((k + 1) * seg, t)
        h, hb = cks[k], []
        for i in range(t0, t1):
            hb.append(h)                      # h_{i-1}
            h = da[:, i] * h + dbx[:, i]
        for i in reversed(range(t0, t1)):
            lam = lam + gy[:, i, :, None] * c[:, i, None, :]
            p_c = gy[:, i, :, None] * h       # h = h_i
            p_b = lam * u[:, i, :, None]
            gs = lam * hb[i - t0] * da[:, i]
            acc_a = acc_a + gs * dt[:, i, :, None]
            s1 = (gs * a).sum(-1)
            s2 = (lam * bm[:, i, None, :]).sum(-1)
            g_dt[:, i] = s1 + s2 * x[:, i]
            g_x[:, i] = s2 * dt[:, i]
            part[0, :, :, i] = _column_sums(p_b, plan)
            part[1, :, :, i] = _column_sums(p_c, plan)
            lam = lam * da[:, i]
            h = hb[i - t0]
    g_b, g_c = part[0, 0].clone(), part[1, 0].clone()
    for col in range(1, ncol):
        g_b, g_c = g_b + part[0, col], g_c + part[1, col]
    g_a = acc_a[0].clone()
    for row in range(1, b):
        g_a = g_a + acc_a[row]
    return g_dt, g_x, g_a, g_b, g_c, None if h0 is None else lam


@pytest.mark.parametrize("n", [4, 16])
@pytest.mark.parametrize("t", [1, BWD_SEG - 1, BWD_SEG, BWD_SEG + 1,
                               3 * BWD_SEG + 5])
def test_schedule_model_matches_jax_vjp(t, n):
    """The kernel's schedule at the segment boundaries (T 1, S - 1, S,
    S + 1, 3S + 5), DI 40 (ragged against a CTA's channels at N 16), h0
    and both cotangents non-zero: every gradient within 1e-4 of max|JAX|,
    and of the plain reverse scan."""
    vals = _inputs(t * 7 + n, 2, t, 40, n)
    want = _jax_grads(*vals)
    got = _schedule_bwd(*map(torch.from_numpy, vals))
    plain = mamba_scan_fused_bwd_ref(*map(torch.from_numpy, vals))
    for name, g, w, p_ in zip(NAMES, got, want, plain):
        assert tuple(g.shape) == w.shape, name
        assert _rel(g, w) <= TOL, (name, _rel(g, w))
        assert _rel(g, p_) <= TOL, (name, _rel(g, p_))


#: (B, T, DI, N): Hymba-1.5B's training launch (chunk 512 of a 1024-token
#: row at batch 8), a prefill chunk at batch 4, the card tests' shapes.
SCRATCH_SHAPES = [(8, 512, 1600, 16), (4, 2000, 1600, 16),
                  (2, 37, 40, 16), (2, 600, 40, 4), (1, 64, 40, 32),
                  (3, 96, 257, 1), (2, 128, 40, 2), (2, 128, 40, 8)]


@pytest.mark.parametrize("shape", SCRATCH_SHAPES)
def test_backward_scratch_holds_no_state_array(shape):
    """The launcher's scratch (checkpoints every S steps and partial
    sums) is under half of B T DI N (storing every state and lambda takes
    2 B T DI N), under a quarter at N 16 (four state elements a thread,
    64 channels a CTA), and a CTA's shared memory fits the H100's."""
    b, t, di, n = shape
    plan = bwd_plan(t, di, n)
    floats = mamba_scan_fused_bwd_scratch(b, t, di, n)
    assert floats < b * t * di * n / (4 if n == 16 else 2)
    assert plan["smem"] <= 232448
    assert plan["threads"] % 32 == 0 and plan["threads"] <= 256
    assert plan["cpc"] * n == plan["threads"] * plan["v"]


def test_backward_scratch_at_the_training_launch():
    """Hymba-1.5B's training launch, (8, 512, 1600) x 16: 66.4 MB of
    scratch (52.4 of checkpoints every 8 steps, 13.1 of dB/dC partials
    over 25 CTA columns) where storing the chunk's (B, T, DI, N) states and
    lambdas takes 838.9 MB."""
    floats = mamba_scan_fused_bwd_scratch(8, 512, 1600, 16)
    assert floats * 4 <= 70e6
    assert floats * 4 * 12 < 2 * 8 * 512 * 1600 * 16 * 4


def test_backward_constants_are_the_sources():
    """The Python mirror of ``bwd_plan`` reads the source's constants."""
    src = (pathlib.Path(kernels.__file__).parent.parent / "csrc"
           / "mamba_scan.cu").read_text()
    consts = {m[0]: eval(m[1]) for m in re.findall(
        r"constexpr int (kBwd\w+) = ([\d *]+);", src)}
    assert consts["kBwdSeg"] == BWD_SEG
    assert consts["kBwdChannels4"] == BWD_CHANNELS4
    assert consts["kBwdThreads1"] == BWD_THREADS1
    assert "mnf_mamba_scan_bwd_bc" not in src
    assert not re.search(r"\batomic\w*\(", src)
    assert BWD_N == (1, 2, 4, 8, 16, 32)
