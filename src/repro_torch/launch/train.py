"""End-to-end training driver — port of ``repro.launch.train``.

Wires config -> train step (``launch.steps.make_train_step``: AdamW under
``warmup_cosine(--lr, --warmup, --steps)``; on the card a CUDA graph that
updates the params and moments in place) -> resilient loop
(``runtime.ResilientLoop``: async checkpoints every ``--ckpt-every``
steps, auto-resume from ``--ckpt-dir``, straggler detection, a final
checkpoint on SIGTERM or SIGINT) -> the synthetic Markov corpus
(``data.markov_lm_batch``, made on the host) through the prefetching
loader (``data.PrefetchLoader``, which puts each batch on the device).
Params are f32 (the configs' param dtype) from seed 0, the compute in the
config's dtype (bf16).  Runs on the card unless ``--device`` says
otherwise.

The (data, model) mesh comes from the world size as in
``repro.launch.train`` (:func:`train_mesh_shape`; the production 16x16
mesh from 512 ranks).
Started by ``torchrun --nproc-per-node N`` (N > 1), every rank trains
the sharded step (``launch.steps`` with the mesh) on the same batches,
and the checkpoints gather the state whole (rank 0 writes).  A single
process is a world of one, whose mesh is 1x1: it places every leaf
whole on the one device, so :func:`train` runs the single-device step and
starts no process group::

    python -m repro_torch.launch.train --arch qwen2-0.5b --steps 30
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
        --reduced --steps 20 --device cpu --ckpt-dir build/ckpt_cpu

Prints the JAX driver's JSON summary (``final_step``, ``preempted``,
``wall_s``, ``first_loss``, ``last_loss``, ``stragglers_flagged``,
``tokens_per_s``), then the roofline of one step, counted before the
loop by ``launch.roofline.count_cost`` on the eager functional step
(``fn.eager``: a graph's replay dispatches no op to count) (a JSON line
and ``format_row``'s row:
the counted GFLOP and GB, the compute and memory terms, the bottleneck,
the model GFLOP, ``useful_ratio``, ``roofline_frac``, and the measured
share on the card, model FLOPs over the median step time at the peak),
then every
``--log-every``-th step.  Interrupt it and run it again: it resumes from
the last checkpoint.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import statistics
import time

import torch

from repro_torch import checkpoint as ckpt_lib
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import (PrefetchLoader, TokenStreamConfig,
                              markov_lm_batch)
from repro_torch.device import default_device
from repro_torch.launch import roofline
from repro_torch.launch.mesh import (checked_mesh, init_world,
                                     make_production_mesh)
from repro_torch.launch.steps import make_train_step
from repro_torch.models import transformer as tfm
from repro_torch.optim import (AdamWConfig, OptState, adamw_init,
                               warmup_cosine)
from repro_torch.parallel.sharding import distribute_tree
from repro_torch.models.param_utils import tree_leaves
from repro_torch.runtime import LoopConfig, ResilientLoop

__all__ = ["build", "main", "parse_args", "train", "train_mesh_shape"]

ROOT = pathlib.Path(__file__).resolve().parents[3]


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen2-0.5b", choices=ARCH_IDS)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--ckpt-dir", default=str(ROOT / "build" / "train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--mnf-threshold", type=float, default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                         "plain versions)")
    return ap.parse_args(argv)


def train_mesh_shape(world: int) -> tuple:
    """``repro.launch.train``'s (data, model) grid for ``world`` ranks
    below 512: the model axis the largest power of two up to 4 that
    divides the world, the rest data.  A world of 1 gives 1x1."""
    model = 1
    while model * 2 <= min(4, world) and world % (model * 2) == 0:
        model *= 2
    return (world // model, model)


def _mesh(device: torch.device):
    """The training mesh, or None in a world of one (module docstring)."""
    world = init_world(device.type)
    if world == 1:
        return None
    if world >= 512:
        return make_production_mesh(device_type=device.type)
    return checked_mesh(train_mesh_shape(world), ("data", "model"),
                        device_type=device.type)


def build(args):
    """(cfg, shape, plan): the config as the flags set it, the batch shape,
    and the train step (a ``CellPlan`` on the training mesh when the world
    has more than one rank)."""
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.mnf_threshold is not None:
        cfg = dataclasses.replace(
            cfg, mnf=dataclasses.replace(cfg.mnf, enabled=True,
                                         threshold=args.mnf_threshold))
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    opt = AdamWConfig(schedule=warmup_cosine(args.lr, args.warmup,
                                             args.steps))
    dev = default_device() if args.device is None else torch.device(
        args.device)
    return cfg, shape, make_train_step(cfg, shape, opt=opt, mesh=_mesh(dev))


def _state_bytes(state) -> int:
    """Bytes of this rank's params and moments (a DTensor's local
    shard)."""
    from torch.distributed.tensor import DTensor
    return sum(t.numel() * t.element_size() for t in (
        x.to_local() if isinstance(x, DTensor) else x
        for x in tree_leaves(dict(params=state[0], mu=state[1].mu,
                                  nu=state[1].nu))))


def _placed(plan, state):
    """``state`` under the mesh step's placements (as is off a mesh)."""
    if getattr(plan, "mesh", None) is None:
        return state
    place = lambda tree: distribute_tree(  # noqa: E731
        tree, plan.param_axes, plan.mesh, plan.rules)
    return place(state[0]), OptState(place(state[1].mu),
                                     place(state[1].nu), state[1].count)


def train(args) -> dict:
    """Run the driver.  Returns the summary's keys, and ``log`` (each
    step's metrics), ``state`` ((params, opt_state) at the end),
    ``report`` (the counted step's ``RooflineReport``), ``cost``,
    ``step_ms`` (the median step after the first), ``measured_frac``,
    ``peak_bytes``, ``cfg`` and ``graph`` (the step's ``graphs.Graph``,
    None where the step runs eagerly).  On a mesh the step is counted on this
    rank's shards, its collective term from the collectives it issues
    (``launch.roofline.count_cost``), and the report names the mesh and
    its size."""
    dev = default_device() if args.device is None else torch.device(
        args.device)
    cfg, shape, plan = build(args)
    params = tfm.init_params(0, cfg, dev)
    state = (params, adamw_init(params))
    ds_cfg = TokenStreamConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                               global_batch=args.batch)
    start = ckpt_lib.latest_step(args.ckpt_dir) or 0

    # the roofline of one step (its result dropped), counted before the
    # loop on the eager step: a graph's replay dispatches no op to count,
    # and the eager step's working set would not fit on the card beside
    # the graph's state and pool at Hymba-1.5B's size.  Counted FLOPs,
    # bytes and collective bytes of this rank against the card's peaks;
    # on a mesh from the state already placed, as the loop's steps get it
    batch = {k: v.to(dev) for k, v in markov_lm_batch(
        ds_cfg, start, device="cpu").items()}
    cost = roofline.count_cost(plan.fn.eager, *_placed(plan, state),
                               batch)[1]
    del batch
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    loader = PrefetchLoader(
        lambda step: markov_lm_batch(ds_cfg, step, device="cpu"),
        start_step=start, device=dev)

    def batch_fn(step):
        got, batch = next(loader)
        if got != step:
            raise RuntimeError(f"the loader yielded step {got} for step "
                               f"{step}")
        return batch

    def step_fn(state, batch):
        p, o, metrics = plan.fn(*state, batch)
        return (p, o), metrics

    loop = ResilientLoop(
        LoopConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                   ckpt_every=args.ckpt_every),
        step_fn, batch_fn)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    try:
        state, final_step, preempted = loop.run(state)
    finally:
        loader.close()
    dt = time.time() - t0
    mesh = getattr(plan, "mesh", None)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
        else _state_bytes(state)

    log = loop.metrics_log
    losses = [m["loss"] for m in log]
    out = dict(
        final_step=final_step, preempted=preempted,
        wall_s=round(dt, 1),
        first_loss=round(losses[0], 4) if losses else None,
        last_loss=round(sum(losses[-10:]) / max(len(losses[-10:]), 1), 4)
        if losses else None,
        stragglers_flagged=int(sum(m["straggler"] for m in log)),
        tokens_per_s=round(len(losses) * args.batch * args.seq / dt, 1))

    chips = 1 if mesh is None else mesh.size()
    mesh_name = "1" if mesh is None else "x".join(
        str(n) for n in mesh.mesh.shape)
    report = roofline.analyze(args.arch, cfg, shape, mesh_name, chips, cost,
                              peak)
    times = [m["step_time_s"] for m in log[1:]] or \
        [m["step_time_s"] for m in log]
    step_s = statistics.median(times) if times else None
    measured = None if step_s is None or dev.type != "cuda" else \
        report.model_gflops * 1e9 / (chips * step_s
                                     * roofline.HW().peak_flops)
    return dict(out, log=log, state=state, report=report, cost=cost,
                step_ms=None if step_s is None else step_s * 1e3,
                measured_frac=measured, peak_bytes=peak, cfg=cfg,
                graph=getattr(plan.fn, "graph", None))


def main(argv=None) -> None:
    args = parse_args(argv)
    print(f"device={args.device or 'cuda'} arch={args.arch} "
          f"reduced={args.reduced}", flush=True)
    run = train(args)
    keys = ("final_step", "preempted", "wall_s", "first_loss", "last_loss",
            "stragglers_flagged", "tokens_per_s")
    print(json.dumps({k: run[k] for k in keys}), flush=True)
    report = run["report"]
    print(json.dumps(dict(
        roofline=report.to_json(), step_ms=run["step_ms"],
        measured_frac=run["measured_frac"], kernels=run["cost"].kernels,
        collectives=run["cost"].collectives)), flush=True)
    print(roofline.format_row(report), flush=True)
    for m in run["log"][::max(1, args.log_every)]:
        print(f"  step {int(m['step']):5d} loss {m['loss']:.4f} "
              f"gnorm {m['grad_norm']:.3f} {m['step_time_s']*1e3:8.1f}ms")


if __name__ == "__main__":
    main()
