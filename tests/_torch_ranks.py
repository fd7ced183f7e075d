"""Process-group helpers for the port's distributed CPU tests: start a
world of gloo ranks on a ``file://`` store, run one function in each, and
hand back each rank's result.  Imports torch and the port only (no JAX),
so a spawned rank starts quickly; the rank bodies the tests run live
here too, because a spawned process imports its function by module."""
from __future__ import annotations

import dataclasses
import os
import pickle
import tempfile
import time
import traceback

import numpy as np

import torch
import torch.multiprocessing as mp

__all__ = ["run_ranks"]


def _entry(rank: int, world: int, store: str, out_dir: str, fn, args):
    import torch.distributed as dist
    torch.set_num_threads(1)
    out = os.path.join(out_dir, f"rank{rank}.pkl")
    try:
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                rank=rank, world_size=world)
        result = ("ok", fn(rank, world, *args))
    except BaseException:                          # reported to the test
        result = ("error", traceback.format_exc())
    with open(out, "wb") as f:
        pickle.dump(result, f)
    if dist.is_initialized():
        dist.destroy_process_group()


def run_ranks(fn, world: int, *args, timeout: float = 120.0) -> list:
    """``fn(rank, world, *args)`` in ``world`` spawned processes joined
    in a gloo group; returns the ranks' results in rank order.  A rank
    that raises fails the caller with its traceback; a world that has not
    finished within ``timeout`` seconds is killed and fails it too, so a
    hung rendezvous never hangs the run."""
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="torch_ranks_") as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_entry,
                             args=(r, world, store, tmp, fn, args))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        if hung:
            raise TimeoutError(f"ranks {hung} of {world} still running "
                               f"after {timeout} s")
        results = []
        for r in range(world):
            path = os.path.join(tmp, f"rank{r}.pkl")
            if not os.path.exists(path):
                raise RuntimeError(f"rank {r} exited with code "
                                   f"{procs[r].exitcode} and no result")
            with open(path, "rb") as f:
                status, value = pickle.load(f)
            if status != "ok":
                raise RuntimeError(f"rank {r} of {world} failed:\n{value}")
            results.append(value)
        return results


# ---------------------------------------------------------------------------
# Rank bodies
# ---------------------------------------------------------------------------

def _np(x) -> np.ndarray:
    """A tensor (a DTensor gathered whole) as a numpy array."""
    from repro_torch.parallel.sharding import whole
    return whole(x).detach().cpu().numpy()


def compression_rank(rank, world, xs, residuals, k_frac):
    """``quantized_psum`` and ``event_psum`` of rank r's ``xs[r]`` (with
    ``residuals[r]``) over the world."""
    from repro_torch.optim.compression import (event_psum,
                                               make_compressed_grad_fn,
                                               quantized_psum)
    x = torch.from_numpy(xs[rank])
    r = torch.from_numpy(residuals[rank])
    q = quantized_psum(x)
    total, new_res = event_psum(x, r, k_frac=k_frac)
    plain, same = make_compressed_grad_fn("none")(x, r, None)
    assert same is r
    return dict(q=_np(q), total=_np(total), residual=_np(new_res),
                plain=_np(plain))


def pipeline_rank(rank, world, ws, x):
    """``pipeline_apply`` over a ('pipe',) mesh of every rank, and the
    stages run one after another on this rank."""
    from repro_torch.launch.mesh import checked_mesh
    from repro_torch.parallel.pipeline import pipeline_apply
    mesh = checked_mesh((world,), ("pipe",), device_type="cpu")
    ws, x = torch.from_numpy(ws), torch.from_numpy(x)
    stage = lambda w, mb: torch.tanh(mb @ w)
    y = pipeline_apply(stage, ws, x, mesh=mesh, axis="pipe")
    ref = x.clone()
    for s in range(ws.shape[0]):
        ref = torch.stack([stage(ws[s], mb) for mb in ref])
    return dict(y=_np(y), ref=_np(ref))


def _reduced_lm(arch, **kw):
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch).reduced(), **kw)


def elastic_rank(rank, world, arch, cfg_kw, old_shape, survivors):
    """A reduced model's params placed on an ``old_shape`` (data, model)
    mesh, re-meshed to the largest grid of ``survivors`` ranks
    (``model_parallel=1``) and re-placed there: each leaf's placements on
    both meshes, and on the survivors whether its whole value is the
    original's bitwise."""
    from torch.distributed.tensor import DTensor

    from repro_torch.launch.mesh import checked_mesh
    from repro_torch.models import transformer as tfm
    from repro_torch.models.param_utils import tree_leaves
    from repro_torch.parallel.sharding import distribute_tree, make_rules
    from repro_torch.runtime.elastic import elastic_remesh, reshard_tree
    cfg = _reduced_lm(arch, **cfg_kw)
    params = tfm.init_params(0, cfg, "cpu")
    axes = tfm.param_axes(cfg)
    old = checked_mesh(old_shape, ("data", "model"), device_type="cpu")
    placed = distribute_tree(params, axes, old,
                             make_rules(old, fsdp=cfg.fsdp))
    new = elastic_remesh(survivors, model_parallel=1, device_type="cpu")
    moved = reshard_tree(placed, axes, new, fsdp=cfg.fsdp)
    out = dict(shape=tuple(new.shape), names=new.mesh_dim_names,
               old=[tuple(t.placements) for t in tree_leaves(placed)])
    if rank < survivors:
        leaves = tree_leaves(moved)
        out["dtensor"] = all(isinstance(t, DTensor) for t in leaves)
        out["new"] = [tuple(t.placements) for t in leaves]
        out["equal"] = all(torch.equal(t.full_tensor(), p)
                           for t, p in zip(leaves, tree_leaves(params)))
    return out


def mesh_rank(rank, world):
    """What ``checked_mesh`` and ``make_serve_mesh`` make of this world."""
    import warnings

    from repro_torch.launch import mesh as m
    out = {}
    try:
        m.checked_mesh((world, 2), ("data", "model"), device_type="cpu")
    except m.MeshCapacityError as e:
        out["error"] = str(e)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        ones = m.checked_mesh((world, 2), ("data", "model"), fallback=True,
                              device_type="cpu")
    out["fallback"] = (tuple(ones.shape), [str(x.message) for x in w])
    serve = m.make_serve_mesh(device_type="cpu")
    out["serve"] = (tuple(serve.shape), serve.mesh_dim_names)
    return out


def several(rank, world, jobs):
    """Each (name, body, args) of ``jobs`` in turn in one world:
    {name: body(rank, world, *args)}."""
    return {name: body(rank, world, *args) for name, body, args in jobs}


def moe_ep_rank(rank, world, mesh_shape, cfg_kw, p_np, x_np, r_np):
    """``moe_apply_ep`` on a (data, model) mesh against ``moe_apply`` on
    the whole tensors, forward and backward (the gradient of
    sum(y * r) + the load-balance loss w.r.t. every param and x)."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch.mesh import checked_mesh
    from repro_torch.models import moe
    from repro_torch.models.param_utils import tree_leaves, tree_map
    from repro_torch.parallel.sharding import (distribute_tree,
                                               make_rules, make_sharder,
                                               to_placements,
                                               logical_to_pspec)
    cfg = _reduced_lm("deepseek-moe-16b", **cfg_kw)
    mesh = checked_mesh(mesh_shape, ("data", "model"), device_type="cpu")
    rules = make_rules(mesh)
    p = tree_map(torch.from_numpy, p_np)
    x, r = torch.from_numpy(x_np), torch.from_numpy(r_np)
    axes = moe.moe_init(0, cfg, "meta", with_axes=True)[1]

    def loss_of(y, aux):
        return (y * r).sum() + aux["load_balance_loss"]

    leaves = tree_map(lambda t: t.clone().requires_grad_(), p)
    xg = x.clone().requires_grad_()
    y_ref, aux_ref = moe.moe_apply(leaves, xg, cfg)
    g_ref = torch.autograd.grad(loss_of(y_ref, aux_ref),
                                tree_leaves(leaves) + [xg])

    dp = tree_map(lambda t: t.detach().requires_grad_(),
                  distribute_tree(p, axes, mesh, rules))
    x_pl = to_placements(logical_to_pspec(("batch", "seq", None), x.shape,
                                          mesh, rules), mesh)
    xd = distribute_tensor(x, mesh, x_pl,
                           src_data_rank=None).detach().requires_grad_()
    sc = make_sharder(mesh, rules)
    with CommDebugMode() as comm, implicit_replication():
        y, aux = moe.moe_apply_ep(dp, xd, cfg, sc=sc)
    with implicit_replication():
        g = torch.autograd.grad(loss_of(y, aux), tree_leaves(dp) + [xd])
    return dict(
        y=_np(y), y_ref=_np(y_ref), ep=isinstance(y, DTensor),
        lb=float(_np(aux["load_balance_loss"])),
        lb_ref=float(aux_ref["load_balance_loss"]),
        drop=float(_np(aux["drop_fraction"])),
        all_reduce=comm.get_comm_counts().get(
            torch.ops.c10d.allreduce_, 0),
        grads=[_np(t) for t in g], grads_ref=[_np(t) for t in g_ref])


def moe_ep_count_rank(rank, world, cfg_kw, x_np):
    """``moe_apply_ep``'s forward on a (1, world) mesh under
    ``launch.roofline.count_cost``: the collectives it counts, and the
    bytes of this rank's output (the tensor the ep all-reduce writes)."""
    from torch.distributed.tensor import (DTensor, Replicate,
                                          distribute_tensor)
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch.mesh import checked_mesh
    from repro_torch.launch.roofline import count_cost
    from repro_torch.models import moe
    from repro_torch.parallel.sharding import (distribute_tree, make_rules,
                                               make_sharder)
    cfg = _reduced_lm("deepseek-moe-16b", **cfg_kw)
    mesh = checked_mesh((1, world), ("data", "model"), device_type="cpu")
    rules = make_rules(mesh)
    p, axes = moe.moe_init(0, cfg, "cpu", with_axes=True)
    dp = distribute_tree(p, axes, mesh, rules)
    xd = distribute_tensor(torch.from_numpy(x_np), mesh,
                           [Replicate()] * 2, src_data_rank=None)

    def fwd():
        with implicit_replication():
            return moe.moe_apply_ep(dp, xd, cfg, sc=make_sharder(mesh, rules))
    (y, _), cost = count_cost(fwd)
    yl = y.to_local()
    return dict(ep=isinstance(y, DTensor), collectives=cost.collectives,
                y_bytes=yl.numel() * yl.element_size(),
                flops=cost.flops)


def _perturbed_params(cfg, names=("bq", "bk", "bv", "ln_attn", "ln_mlp",
                                  "final_norm"), scale=0.1):
    """``init_params(0, cfg)`` with seeded noise on the leaves the init
    makes constant (the QKV biases, the norm gains), so that no leaf
    starts at zero and AdamW's first step is not a sign function of
    near-zero gradients."""
    from repro_torch.models import transformer as tfm
    gen = torch.Generator().manual_seed(1)

    def walk(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v)
            elif k in names:
                v.add_(scale * torch.randn(v.shape, generator=gen))
        return tree
    return walk(tfm.init_params(0, cfg, "cpu"))


def tree_leaves_of_lists(tree) -> list:
    """The leaves of a dict tree whose leaves are lists."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves_of_lists(v)]
    return [tree]


def train_step_rank(rank, world, mesh_shape, cfg_kw, seq, batch):
    """One sharded train step on a (data, model) mesh against the
    single-device step from the same params and batch: loss, grad norm,
    each leaf's new value and first moment, and its placements."""
    from torch.distributed.tensor import DTensor

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import checked_mesh
    from repro_torch.models.param_utils import tree_leaves
    from repro_torch.optim import adamw_init
    cfg = _reduced_lm("qwen2-1.5b", **cfg_kw)
    shape = ShapeConfig("t", seq, batch, "train")
    mesh = checked_mesh(mesh_shape, ("data", "model"), device_type="cpu")
    params = _perturbed_params(cfg)
    gen = torch.Generator().manual_seed(0)
    data = dict(tokens=torch.randint(0, cfg.vocab_size, (batch, seq),
                                     generator=gen),
                labels=torch.randint(0, cfg.vocab_size, (batch, seq),
                                     generator=gen))
    ref_p, ref_o, ref_m = steps.make_train_step(cfg, shape).fn(
        params, adamw_init(params), data)
    plan = steps.make_train_step(cfg, shape, mesh=mesh)
    t0 = time.perf_counter()
    new_p, new_o, m = plan.fn(params, adamw_init(params), data)
    step_s = time.perf_counter() - t0
    got = tree_leaves(new_p)
    return dict(
        loss=float(m["loss"]), loss_ref=float(ref_m["loss"]),
        grad_norm=float(m["grad_norm"]),
        grad_norm_ref=float(ref_m["grad_norm"]),
        dtensor=[isinstance(t, DTensor) for t in got]
        + [isinstance(t, DTensor) for t in tree_leaves(new_o.mu)],
        placements=[tuple(t.placements) for t in got],
        plan_placements=[tuple(pl) for pl in tree_leaves_of_lists(
            plan.param_placements)],
        mu_placements=[tuple(t.placements) for t in tree_leaves(new_o.mu)],
        params=[_np(t) for t in got],
        params_ref=[_np(t) for t in tree_leaves(ref_p)],
        mu=[_np(t) for t in tree_leaves(new_o.mu)],
        mu_ref=[_np(t) for t in tree_leaves(ref_o.mu)], step_s=step_s)


def decode_rank(rank, world, mesh_shape, arch, cfg_kw, prompt, steps_n):
    """A prefill and ``steps_n`` decode steps on a (data, model) mesh
    against the eager single-device steps: logits, and each cache leaf
    whole and its placements."""
    from torch.distributed.tensor import DTensor

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import checked_mesh
    from repro_torch.models import transformer as tfm
    from repro_torch.models.param_utils import tree_leaves
    cfg = _reduced_lm(arch, **cfg_kw)
    mesh = checked_mesh(mesh_shape, ("data", "model"), device_type="cpu")
    params = _perturbed_params(cfg)
    bsz, max_len = 2, prompt + steps_n
    gen = torch.Generator().manual_seed(0)
    toks = torch.randint(0, cfg.vocab_size, (bsz, max_len), generator=gen)
    out = {}
    for tag, m in (("ref", None), ("mesh", mesh)):
        pre = steps.make_prefill_step(
            cfg, ShapeConfig("p", max_len, bsz, "prefill"), graph=False,
            mesh=m)
        srv = steps.make_serve_step(
            cfg, ShapeConfig("s", max_len, bsz, "decode"), graph=False,
            mesh=m)
        logits, cache = pre.fn(params, dict(tokens=toks[:, :prompt]))
        seq = [_np(logits)]
        for i in range(steps_n):
            logits, cache = srv.fn(params, cache,
                                   dict(tokens=toks[:, prompt + i:][:, :1]),
                                   prompt + i)
            seq.append(_np(logits))
        out[tag] = dict(logits=seq, cache=[_np(t) for t in
                                           tree_leaves(cache)])
        if m is not None:
            out[tag]["dtensor"] = all(isinstance(t, DTensor)
                                      for t in tree_leaves(cache))
            out[tag]["placements"] = [str(t.placements)
                                      for t in tree_leaves(cache)]
    return out


def cnn_serve_rank(rank, world, net, batches):
    """The batch-parallel serve plan of an MLP or CNN on a (world, 1)
    mesh against the mesh-less plan, at each of ``batches``, and a
    ``ServeEngine`` on the mesh against one off it."""
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import checked_mesh
    from repro_torch.launch.steps import make_cnn_serve_step
    from repro_torch.serving import ServeEngine, ServeEngineConfig
    mesh = checked_mesh((world, 1), ("data", "model"), device_type="cpu")
    spec = serve._mlp_spec(net) if net in ("lenet", "mini") \
        else serve._cnn_spec(net, 8)
    params = serve._init_params(spec, 0, "cpu", 0.5)
    out = {}
    for b in batches:
        x = serve.make_requests(spec, b, b)
        plan = make_cnn_serve_step(spec, b, device="cpu", mesh=mesh)
        ref = make_cnn_serve_step(spec, b, device="cpu")
        out[b] = dict(y=_np(plan.fn(params, x)), y_ref=_np(ref.fn(params, x)),
                      shards=plan.data_shards,
                      input_sharding=str(plan.input_sharding),
                      local_rows=plan.fn.inner.shape[0]
                      if plan.data_shards > 1 else b)
    cfg = ServeEngineConfig(buckets=tuple(batches))
    reqs = serve.make_requests(spec, 7, 99)
    served = []
    for m in (mesh, None):
        eng = ServeEngine(spec, params, cfg, device="cpu", mesh=m)
        serve.serve_arrivals(eng, reqs, [3, 4])
        served.append(np.stack([_np(r.result) for r in eng.completed]))
        if m is not None:
            stats = eng.stats()
    out["engine"] = dict(y=served[0], y_ref=served[1],
                         devices=stats["devices"],
                         data_shards=stats["data_shards"])
    return out


def train_driver_rank(rank, world, ckpt_dir, arch):
    """``launch.train`` in this world (``train`` builds its own mesh):
    one step, then a second run that resumes from the first's checkpoint
    and takes one more."""
    from torch.distributed.tensor import DTensor

    from repro_torch.launch import train
    from repro_torch.models.param_utils import tree_leaves
    base = ["--arch", arch, "--reduced", "--device", "cpu", "--batch", "4",
            "--seq", "16", "--ckpt-dir", ckpt_dir, "--ckpt-every", "1",
            "--warmup", "1"]
    out = {}
    for steps in (1, 2):
        args = train.parse_args(base + ["--steps", str(steps)])
        _, _, plan = train.build(args)
        run = train.train(args)
        params = run["state"][0]
        out[steps] = dict(
            final_step=run["final_step"],
            losses=[m["loss"] for m in run["log"]],
            mesh=tuple(plan.mesh.shape),
            dtensor=all(isinstance(t, DTensor) for t in tree_leaves(params)),
            report=run["report"],
            whole=[_np(t) for t in tree_leaves(params)][:3])
    return out
