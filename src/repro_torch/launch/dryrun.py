"""Dry run on the meta device: every (arch x shape x mesh) cell's sharded
step traced at the production meshes, with no card and no ranks — port
of ``repro.launch.dryrun``.

The JAX package lowers and compiles each cell for 512 placeholder host
devices; torch compiles nothing, so here each cell's step runs once,
eagerly, on DTensors of meta tensors (shapes without data) over a fake
world of the mesh's size (``launch.mesh.dry_mesh``: this process is rank
0, every collective returns at once).  Per cell:

  1. ``launch.steps.plan_cell`` at the 16x16 (2x16x16) mesh;
  2. the meta params, AdamW moments (train) and cache (decode) placed by
     the plan's placements (local shards, no data); the batch whole on
     every rank, as the train driver hands it (the step shards it itself,
     with no collective);
  3. the step run once under ``launch.roofline.counting`` (FLOPs, bytes
     and collective bytes of rank 0's own shards; the kernels by their
     formulas: B7, B8 and B10's fused entry and backward launch nothing
     on meta tensors) and :class:`LiveBytes`;
  4. the record, in the JAX package's fields: ``memory`` — ``args`` exact
     from the local shard shapes of the params, moments, cache and batch
     (the batch's share by its placements), ``temp`` the peak of the live
     storages the step made less its ``output`` (a tracker of storages:
     no allocator slack, rounding or cache, and not the kernels' scratch),
     ``alias`` 0 (the port's steps donate nothing); ``roofline``
     (``analyze``, chips = the mesh size, ``bytes_per_device`` = args +
     temp + output - alias); ``lower_s`` the trace time and
     ``compile_s`` 0 (nothing compiles); beside JAX's fields, the
     kernels' formula counts, the collective bytes by kind and by the
     shapes moved, and the FLOPs by aten op (which part of the step
     costs what).  A failed cell is recorded loudly (status "error",
     the traceback), as JAX's is.

Its numbers are counts of what one device runs, not times on a card.
Records go to ``results/torch_dryrun/<arch>__<shape>__<mesh>.json``
(git-ignored), which ``launch.report`` reads::

    python -m repro_torch.launch.dryrun --arch qwen2-1.5b --shape train_4k
    python -m repro_torch.launch.dryrun --all [--multi-pod] [--skip-done]
    python -m repro_torch.launch.dryrun --arch hymba-1.5b --shape train_4k \\
        --reduced --mesh 2x4          # a reduced config on a small mesh
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.launch import roofline
from repro_torch.launch.mesh import dry_mesh, production_shape
from repro_torch.launch.steps import plan_cell
from repro_torch.models import transformer as tfm
from repro_torch.models.param_utils import tree_leaves
from repro_torch.optim import OptState, adamw_init
from repro_torch.parallel.sharding import (distribute_tree, logical_to_pspec,
                                           to_placements)

__all__ = ["RESULTS_DIR", "LiveBytes", "cell_supported", "main",
           "mesh_for", "run_cell"]

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "torch_dryrun")


def cell_supported(cfg, shape) -> tuple[bool, str]:
    """The JAX dry run's rule: long_500k needs sub-quadratic context
    handling; a decode cell needs a decoder."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "long_500k skipped: full-attention arch (see DESIGN.md)"
    if shape.kind == "decode" and not cfg.has_decoder:
        return False, "decode skipped: encoder-only arch"
    return True, ""


def mesh_for(multi_pod: bool, mesh_shape=None) -> tuple:
    """(shape, axes, name) of a cell's mesh: the production mesh, or
    ``mesh_shape`` over (data, model) or (pod, data, model)."""
    if mesh_shape is None:
        shape, axes = production_shape(multi_pod)
    else:
        shape = tuple(int(s) for s in mesh_shape)
        axes = ("data", "model") if len(shape) == 2 else \
            ("pod", "data", "model")
    return shape, axes, "x".join(map(str, shape))


class LiveBytes(TorchDispatchMode):
    """The bytes of the storages that the ops inside it make: a storage
    counts from the first op that hands back (or takes) a tensor of it,
    unless it is one of ``known``'s (the step's arguments), until the
    storage itself is freed (a finalizer on its Python object, which
    torch keeps while any tensor, an autograd saved tensor too, holds the
    storage).  ``peak`` is the most that was live at once.  Storages, not
    allocator blocks: no rounding, slack or cache."""

    def __init__(self, known=()):
        super().__init__()
        self.known = {t.untyped_storage()._cdata for t in known}
        self.tracked: dict = {}
        self.live = self.peak = 0

    def _free(self, key):
        self.live -= self.tracked.pop(key, 0)

    def _see(self, t):
        if not isinstance(t, torch.Tensor) or type(t) is not torch.Tensor:
            return
        st = t.untyped_storage()
        key = st._cdata
        if key in self.known or key in self.tracked:
            return
        self.tracked[key] = st.nbytes()
        self.live += st.nbytes()
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves((args, kwargs, out)):
            self._see(t)
        return out


def _local(t):
    """A DTensor's local shard; a plain tensor as it is."""
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


def _shard_bytes(shape: tuple, dtype, placements, mesh) -> int:
    """Bytes of rank 0's shard of a tensor of ``shape`` under
    ``placements``: each sharded dim split evenly, DTensor's
    ceil-division for rank 0."""
    from torch.distributed.tensor import Shard
    dims = list(shape)
    for size, pl in zip(mesh.mesh.shape, placements):
        if isinstance(pl, Shard):
            dims[pl.dim] = -(-dims[pl.dim] // size)
    n = 1
    for d in dims:
        n *= d
    return n * torch.empty((), dtype=dtype).element_size()


def _batch(cfg, shape) -> dict:
    return {k: torch.empty(s, dtype=dt, device="meta")
            for k, (s, dt) in tfm.input_specs(cfg, shape).items()}


def _trace(cfg, shape, mesh, rules) -> dict:
    """Place a cell's arguments on the mesh and run its step once under
    the counters.  Returns the record's memory fields, the Cost and the
    trace seconds."""
    plan = plan_cell(cfg, shape, mesh, rules=rules)
    place = lambda tree: distribute_tree(tree, plan.param_axes, mesh,
                                         plan.rules)
    meta = tfm.init_params(0, cfg, "meta")
    params = place(meta)
    batch = _batch(cfg, shape)
    batch_pl = {k: to_placements(logical_to_pspec(
        ("batch",) + (None,) * (v.dim() - 1), tuple(v.shape), mesh,
        plan.rules), mesh) for k, v in batch.items()}
    pos = ()                                   # a decode step's position
    if shape.kind == "train":
        opt = adamw_init(meta)
        state = (params, OptState(place(opt.mu), place(opt.nu), opt.count))
    elif shape.kind == "prefill":
        state = (params,)
    else:
        state = (params, distribute_tree(
            tfm.init_cache(cfg, shape.global_batch, shape.seq_len, "meta"),
            tfm.cache_axes(cfg), mesh, plan.rules))
        pos = (shape.seq_len - 1,)
    args = (*state, batch, *pos)
    held = [_local(t) for t in tree_leaves(state)]
    arg_bytes = sum(t.numel() * t.element_size() for t in held) + sum(
        _shard_bytes(tuple(v.shape), v.dtype, batch_pl[k], mesh)
        for k, v in batch.items())
    tracker = LiveBytes(held + list(batch.values()))
    t0 = time.time()
    with roofline.counting(tracker) as cost:
        out = plan.fn(*args)
    trace_s = time.time() - t0
    out_bytes = sum(t.numel() * t.element_size()
                    for t in map(_local, tree_leaves(out)))
    del out
    return dict(memory=dict(temp=max(tracker.peak - out_bytes, 0),
                            args=int(arg_bytes), output=int(out_bytes),
                            alias=0, generated_code=0),
                cost=cost(), trace_s=trace_s)


def _write(rec: dict, out_dir: str, suffix: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{rec['arch']}__{rec['shape']}__"
                                 f"{rec['mesh']}{suffix}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             out_dir: str = RESULTS_DIR, rules=None, tag: str = "",
             verbose: bool = True, reduced: bool = False, mesh_shape=None,
             shape=None) -> dict:
    """Trace one cell and write its record (module docstring); returns
    it.  ``reduced``: the arch's reduced config; ``mesh_shape``: another
    mesh than the production one; ``shape``: a ``ShapeConfig`` in place
    of ``SHAPES[shape_name]`` (its name is kept)."""
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    shape = shape or SHAPES[shape_name]
    mshape, axes, mesh_name = mesh_for(multi_pod, mesh_shape)
    rec = dict(arch=arch, shape=shape_name, mesh=mesh_name, tag=tag)
    suffix = f"__{tag}" if tag else ""
    ok, why = cell_supported(cfg, shape)
    if not ok:
        rec.update(status="skipped", reason=why)
        _write(rec, out_dir, suffix)
        return rec
    try:
        with dry_mesh(mshape, axes) as mesh:
            got = _trace(cfg, shape, mesh, rules)
        mem = got["memory"]
        per_device = mem["temp"] + mem["args"] + mem["output"] - mem["alias"]
        rep = roofline.analyze(arch, cfg, shape, mesh_name, mesh.size(),
                               got["cost"], per_device)
        rec.update(status="ok", lower_s=round(got["trace_s"], 1),
                   compile_s=0.0, memory=mem, roofline=rep.to_json(),
                   kernels=got["cost"].kernels,
                   collectives=got["cost"].collectives,
                   collective_shapes=got["cost"].collective_shapes,
                   flops_by_op=got["cost"].flops_by_op)
        if verbose:
            print(roofline.format_row(rep), flush=True)
    except Exception as e:  # a failed cell is a bug: record it loudly
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:])
        if verbose:
            print(f"FAIL {arch} {shape_name} {mesh_name}: {e}", flush=True)
    _write(rec, out_dir, suffix)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=tuple(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--skip-done", action="store_true")
    ap.add_argument("--out-dir", default=RESULTS_DIR)
    ap.add_argument("--reduced", action="store_true",
                    help="the arch's reduced config")
    ap.add_argument("--mesh", default=None,
                    help="another mesh than the production one, e.g. 2x4")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if (args.all or not args.arch) else (args.arch,)
    shapes = tuple(SHAPES) if (args.all or not args.shape) else (args.shape,)
    meshes = (False, True) if args.both_meshes else (args.multi_pod,)
    mesh_shape = None if args.mesh is None else \
        tuple(int(s) for s in args.mesh.split("x"))
    n_ok = n_skip = n_fail = 0
    for arch in archs:
        for shp in shapes:
            for mp in meshes:
                name = mesh_for(mp, mesh_shape)[2]
                path = os.path.join(args.out_dir,
                                    f"{arch}__{shp}__{name}.json")
                if args.skip_done and os.path.exists(path):
                    with open(path) as f:
                        if json.load(f).get("status") in ("ok", "skipped"):
                            continue
                rec = run_cell(arch, shp, multi_pod=mp, out_dir=args.out_dir,
                               reduced=args.reduced, mesh_shape=mesh_shape)
                n_ok += rec["status"] == "ok"
                n_skip += rec["status"] == "skipped"
                n_fail += rec["status"] == "error"
    print(f"done: ok={n_ok} skipped={n_skip} failed={n_fail}")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
