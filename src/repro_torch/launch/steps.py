"""Step factories — port of ``repro.launch.steps``: ``make_train_step``,
``make_prefill_step``, ``make_serve_step`` and ``make_cnn_serve_step``,
on one device or, given a ``mesh``, sharded over it (:class:`CellPlan`,
:func:`plan_cell`).

The train step is autograd over ``transformer.lm_loss`` under the
config's remat policy, then AdamW, with ``accum_steps`` microbatches
summed into one optimizer step.

On CUDA tensors a step is compiled as the JAX package's is under
``jax.jit``, here as a CUDA graph (``launch.graphs``): one graph per
prompt length for the prefill, one per (batch, max_len) for the decode,
one for the train step, captured at the first call (or by
``fn.capture``).  The prefill and decode graphs read the parameter
tensors of that call; a call with other parameter tensors raises.  Each
call copies the caller's tensors — the prefill's tokens, audio frames
and patch embeddings alike — into the graph's static buffers, skipping
any that already are those buffers, and replays.  The decode
graph owns its cache (updated in place, the counterpart of the JAX serve
step's donated cache) and its position, a 0-d device integer that each
replay advances by one: a caller that hands back ``fn.position`` and the
returned cache copies nothing but the new tokens.  The train graph owns
the params, the AdamW moments and count (updated in place by
``optim.adamw_update_``: the JAX train step's donated buffers) and the
batch: a call with other state tensors (the first call, a restore from
a checkpoint) copies them in leaf by leaf, and a caller that hands back
the returned trees copies nothing but the batch.  What a step returns
is rewritten by its next replay.  On CPU tensors (the train step: on
any tensors off the card), or with ``graph=False``, ``fn`` is the eager
callable; a train step's ``fn.eager`` is always the eager functional
step (``optim.adamw_update``), which leaves its inputs as they are.

With a ``mesh`` (a ``DeviceMesh``, ``launch.mesh``) the LM steps run
eagerly on DTensors, every rank of the mesh calling them:

- the params, the AdamW moments and the cache are DTensors under the
  placements their logical axes resolve to (``transformer.param_axes``,
  ``transformer.cache_axes``; ``make_rules(mesh, fsdp=cfg.fsdp,
  seq_shard=cfg.seq_shard)`` unless ``rules`` is given), the batch's rows
  over the data axes where they divide (``_batch_placements``), and
  ``sc`` is ``parallel.sharding.make_sharder``.  A step places what it is
  handed (full tensors, the same on every rank, or DTensors) and returns
  params, moments and cache in the same placements; the logits and the
  metrics come back whole, plain tensors on every rank.
- The model runs under DTensor's ``implicit_replication`` (a plain
  tensor the model makes — positions, masks, zero states — is taken as
  replicated).  Where DTensor (as of torch 2.11) has no sharding rule,
  the model gathers or runs locally, at these points only, each named
  in its function's docstring: an activation product gathers a
  sequence-sharded stream first (``layers.mm``); a flat head dim whose
  shards would split a head is gathered before it is split into heads
  (``layers.split_heads``: 12 heads of 128 over 16 ranks); the
  embedding lookup and the cross-entropy's logsumexp and label pick run
  vocab-parallel, each rank on its own vocabulary shard, joined by
  all-reduces of the rows' results (``layers.embed_apply``,
  ``transformer._lse_and_label_logits``); attention, MLA's absorbed decode,
  RWKV6's chunked WKV, the cache writes and Mamba's prefill (B10) run
  on each rank's batch rows (``parallel.sharding.batch_local``);
  Mamba's decode step (B8), RWKV6's gated step (B7) and the MoE of a
  config without ``moe_ep`` run on the whole tensors on every rank
  (``parallel.sharding.replicated_call``); ``moe_apply_ep`` runs its
  dispatch and experts on each rank's shard (``local_map``).
- Gradients are reduced into their params' placements (a partial sum
  reduce-scattered or all-reduced by DTensor) before the update.

:func:`make_cnn_serve_step` is the CNN/MLP serving plan of one batch
bucket (``repro_torch.serving``): the whole network as one pipeline, a
CUDA graph on the card; with a mesh it goes batch-parallel over the data
axes (:class:`BatchParallel`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.engine.config import EngineConfig
from repro_torch.launch import graphs
from repro_torch.models import transformer as tfm
from repro_torch.optim import (AdamWConfig, OptState, adamw_update,
                               adamw_update_)
from repro_torch.models.param_utils import tree_leaves, tree_map
from repro_torch.parallel.sharding import (ShardingRules, data_axis_size,
                                           distribute_tree, logical_to_pspec,
                                           make_rules, make_sharder, place,
                                           serve_batch_pspec, to_placements,
                                           whole)

__all__ = ["BatchParallel", "CNNCellPlan", "CellPlan", "StepPlan",
           "cell_engine_config", "make_cnn_serve_step", "make_prefill_step",
           "make_serve_step", "make_train_step", "plan_cell"]


def cell_engine_config(cfg: ModelConfig) -> EngineConfig:
    """The MNF engine configuration a cell runs under (backend "auto": the
    device of the tensors resolves it)."""
    return EngineConfig.from_mnf(cfg.mnf)


@dataclasses.dataclass(frozen=True)
class StepPlan:
    cfg: ModelConfig
    shape: ShapeConfig
    fn: Callable
    engine: EngineConfig


@dataclasses.dataclass
class CellPlan:
    """A step sharded over a mesh: ``fn``, and what it places its inputs
    by — the rules, each param leaf's logical axes, shape and dtype
    (``param_shapes``) and DTensor placements (``param_placements``)."""

    cfg: ModelConfig
    shape: ShapeConfig
    mesh: Any
    rules: ShardingRules
    param_axes: Any
    param_shapes: Any
    param_placements: Any
    fn: Callable
    engine: EngineConfig


def _batch_placements(shape: tuple, mesh, rules: ShardingRules) -> list:
    """A batch-leading input's placements: its rows over the data axes
    where they divide, replicated otherwise (a batch of 1 on a multi-rank
    mesh stays whole)."""
    axes = ("batch",) + (None,) * (len(shape) - 1)
    return to_placements(logical_to_pspec(axes, shape, mesh, rules), mesh)


def _place_batch(batch: dict, mesh, rules: ShardingRules) -> dict:
    return {k: None if v is None else place(
        v, mesh, _batch_placements(tuple(v.shape), mesh, rules))
        for k, v in batch.items()}


def _cell(cfg, shape, mesh, rules, fn) -> CellPlan:
    axes = tfm.param_axes(cfg)
    shapes = tree_map(lambda t: (tuple(t.shape), t.dtype),
                      tfm.init_params(0, cfg, "meta"))
    placements = tree_map(
        lambda ax, sd: to_placements(logical_to_pspec(ax, sd[0], mesh,
                                                      rules), mesh),
        axes, shapes)
    return CellPlan(cfg, shape, mesh, rules, axes, shapes, placements, fn,
                    cell_engine_config(cfg))


def _mesh_train_step(cfg, shape, mesh, rules, opt, accum_steps) -> CellPlan:
    """The train step on a mesh (the module docstring says how it places
    and where it gathers)."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication

    sc = make_sharder(mesh, rules)
    axes = tfm.param_axes(cfg)
    place_tree = lambda tree: distribute_tree(tree, axes, mesh, rules)

    def loss_and_grads(params, batch):
        leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
        loss = tfm.lm_loss(leaves, _place_batch(batch, mesh, rules), cfg,
                           sc=sc)
        it = iter(torch.autograd.grad(loss, tree_leaves(leaves),
                                      allow_unused=True))
        # a leaf the loss does not read gets a zero gradient; the others'
        # partial sums are reduced into the leaf's own placements
        return loss.detach(), tree_map(
            lambda p: torch.zeros_like(p) if (g := next(it)) is None
            else g.redistribute(mesh, p.placements), leaves)

    def train_step(params, opt_state, batch):
        params = place_tree(params)
        opt_state = OptState(place_tree(opt_state.mu),
                             place_tree(opt_state.nu), opt_state.count)
        batch = {k: whole(v) for k, v in batch.items()}
        with implicit_replication():
            if accum_steps == 1:
                loss, grads = loss_and_grads(params, batch)
            else:
                micro = {k: v.chunk(accum_steps) for k, v in batch.items()}
                loss = 0.0
                grads = tree_map(
                    lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params)
                for i in range(accum_steps):
                    l_i, g_i = loss_and_grads(
                        params, {k: v[i] for k, v in micro.items()})
                    grads = tree_map(lambda a, b: a + b.float(), grads, g_i)
                    loss = loss + l_i
                loss = loss / accum_steps
                grads = tree_map(lambda g: g / accum_steps, grads)
            with torch.no_grad():
                new_p, new_o, metrics = adamw_update(grads, opt_state,
                                                     params, opt)
        metrics = {k: whole(v) for k, v in dict(loss=loss,
                                                 **metrics).items()}
        assert all(isinstance(t, DTensor) for t in tree_leaves(new_p))
        return new_p, new_o, metrics

    train_step.eager = train_step
    return _cell(cfg, shape, mesh, rules, train_step)


def _mesh_prefill_step(cfg, shape, mesh, rules) -> CellPlan:
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication

    sc = make_sharder(mesh, rules)
    axes, caxes = tfm.param_axes(cfg), tfm.cache_axes(cfg)

    def prefill_step(params, batch):
        tok = batch["tokens"]
        # the zero cache on the tokens' device: the mesh's, or "meta" in
        # the dry run
        dev = (tok.to_local() if isinstance(tok, DTensor) else tok).device
        params = distribute_tree(params, axes, mesh, rules)
        batch = _place_batch(dict(batch), mesh, rules)
        cache = distribute_tree(
            tfm.init_cache(cfg, shape.global_batch, shape.seq_len, dev),
            caxes, mesh, rules)
        with implicit_replication():
            logits, cache = tfm.prefill(
                params, batch["tokens"], cfg, max_len=shape.seq_len,
                audio_frames=batch.get("audio_frames"),
                vision_embeds=batch.get("vision_embeds"), sc=sc,
                cache=cache)
        return whole(logits), distribute_tree(cache, caxes, mesh, rules)

    return _cell(cfg, shape, mesh, rules, prefill_step)


def _mesh_serve_step(cfg, shape, mesh, rules) -> CellPlan:
    from torch.distributed.tensor.experimental import implicit_replication

    sc = make_sharder(mesh, rules)
    axes, caxes = tfm.param_axes(cfg), tfm.cache_axes(cfg)

    def serve_step(params, cache, batch, decode_pos):
        params = distribute_tree(params, axes, mesh, rules)
        cache = distribute_tree(cache, caxes, mesh, rules)
        tokens = _place_batch(dict(tokens=batch["tokens"]), mesh,
                              rules)["tokens"]
        with implicit_replication():
            logits, cache = tfm.decode_step(params, cache, tokens,
                                            whole(decode_pos), cfg, sc=sc)
        return whole(logits), distribute_tree(cache, caxes, mesh, rules)

    return _cell(cfg, shape, mesh, rules, serve_step)


def _rules(cfg, mesh, rules) -> ShardingRules:
    return rules or make_rules(mesh, fsdp=cfg.fsdp, seq_shard=cfg.seq_shard)


def _require_bound(g: graphs.Graph, params) -> None:
    if params is not g.static[0] and not graphs.same_tensors(g.static[0],
                                                             params):
        raise ValueError("this step's graph reads the parameter tensors it "
                         "was captured with; make a new step for others")


class _GraphedPrefill:
    """fn(params, batch) -> (last-position logits, filled cache).  ``batch``
    holds ``tokens`` and, for the configs that take them,
    ``audio_frames`` and ``vision_embeds``: static graph inputs like the
    tokens, one graph per shape of the three."""

    def __init__(self, cfg, shape, pool):
        self.cfg, self.shape, self.pool = cfg, shape, pool
        self.graphs: dict[tuple, graphs.Graph] = {}

    def _prefill(self, params, tokens, audio_frames=None, vision_embeds=None):
        return tfm.prefill(params, tokens, self.cfg,
                           max_len=self.shape.seq_len,
                           audio_frames=audio_frames,
                           vision_embeds=vision_embeds)

    def capture(self, params, tokens: torch.Tensor, audio_frames=None,
                vision_embeds=None) -> graphs.Graph:
        """The graph of a prefill of these inputs' shapes (captured once)."""
        extra = (audio_frames, vision_embeds)
        key = (tuple(tokens.shape),) + tuple(
            None if t is None else (tuple(t.shape), t.dtype) for t in extra)
        if key not in self.graphs:
            static = [torch.zeros(tokens.shape, dtype=torch.int64,
                                  device=tokens.device)]
            static += [None if t is None else torch.zeros_like(t)
                       for t in extra]
            self.graphs[key] = graphs.capture(self._prefill, params, *static,
                                              pool=self.pool)
        return self.graphs[key]

    def __call__(self, params, batch):
        inputs = (batch["tokens"], batch.get("audio_frames"),
                  batch.get("vision_embeds"))
        if inputs[0].device.type == "cpu":
            return self._prefill(params, *inputs)
        g = self.capture(params, *inputs)
        _require_bound(g, params)
        for dst, src in zip(g.static[1:], inputs):
            if src is not None:
                dst.copy_(src)
        return g.replay()


class _GraphedServe:
    """fn(params, cache, batch, decode_pos) -> (logits, the graph's cache);
    ``decode_pos`` a 0-d integer tensor."""

    def __init__(self, cfg, shape, pool):
        self.cfg, self.shape, self.pool = cfg, shape, pool
        self.graph: graphs.Graph | None = None

    def _step(self, params, cache, tokens, pos):
        logits, _ = tfm.decode_step(params, cache, tokens, pos, self.cfg,
                                    in_place=True)
        pos.add_(1)
        return logits

    @property
    def position(self) -> torch.Tensor | None:
        """The graph's position (None before the capture)."""
        return None if self.graph is None else self.graph.static[3]

    def capture(self, params, device) -> graphs.Graph:
        """The decode graph, over a zero cache (captured once)."""
        if self.graph is None:
            bsz, max_len = self.shape.global_batch, self.shape.seq_len
            self.graph = graphs.capture(
                self._step, params,
                tfm.init_cache(self.cfg, bsz, max_len, device),
                torch.zeros((bsz, 1), dtype=torch.int64, device=device),
                torch.zeros((), dtype=torch.int64, device=device),
                pool=self.pool)
        return self.graph

    def __call__(self, params, cache, batch, decode_pos):
        tokens = batch["tokens"]
        if tokens.device.type == "cpu":
            return tfm.decode_step(params, cache, tokens, decode_pos,
                                   self.cfg)
        if not isinstance(decode_pos, torch.Tensor):
            raise TypeError("the graphed decode step takes its position as "
                            "a 0-d integer tensor on the device")
        g = self.capture(params, tokens.device)
        _require_bound(g, params)
        _, s_cache, s_tokens, s_pos = g.static
        if cache is not s_cache:
            tfm.copy_cache(s_cache, cache)
        if tokens is not s_tokens:
            s_tokens.copy_(tokens)
        if decode_pos is not s_pos:
            s_pos.copy_(decode_pos)
        return g.replay(), s_cache


def _copy_leaves(dst, src, what: str) -> None:
    """Copy each leaf of ``src`` into the matching leaf of ``dst``,
    skipping those that already are it."""
    dl, sl = tree_leaves(dst), tree_leaves(src)
    if len(dl) != len(sl) or any(d.shape != t.shape or d.dtype != t.dtype
                                 for d, t in zip(dl, sl)):
        raise ValueError(f"the {what} handed to the graphed train step do "
                         f"not match the ones it was captured with")
    for d, t in zip(dl, sl):
        if d is not t:
            d.copy_(t)


class _GraphedTrain:
    """fn(params, opt_state, batch) -> (params, opt_state, metrics), the
    train graph's own trees (module docstring).  ``metrics`` (``loss``,
    ``grad_norm``, ``lr``) are 0-d f32 tensors on the device that the
    next replay rewrites: read or clone them first.  The batch is copied
    in on the current stream, the one the replay runs on (where
    ``data.PrefetchLoader`` puts its non_blocking copies: the default
    stream).  ``eager`` is the functional step; ``state`` the graph's
    (params, opt_state), None before the capture."""

    def __init__(self, loss_and_grads, opt, pool, eager):
        self.loss_and_grads, self.opt, self.pool = loss_and_grads, opt, pool
        self.eager = eager
        self.graph: graphs.Graph | None = None

    def _step(self, params, mu, nu, count, batch):
        loss, grads = self.loss_and_grads(params, batch)
        with torch.no_grad():
            metrics = adamw_update_(grads, OptState(mu, nu, count), params,
                                    self.opt)
        return dict(loss=loss, **metrics)

    @property
    def state(self):
        if self.graph is None:
            return None
        params, mu, nu, count, _ = self.graph.static
        return params, OptState(mu, nu, count)

    def capture(self, params, opt_state: OptState, batch) -> graphs.Graph:
        """The graph of the step (captured once), its buffers holding
        ``params`` and ``opt_state``."""
        if self.graph is None:
            clone = lambda t: t.detach().clone()  # noqa: E731
            self.graph = graphs.capture(
                self._step, tree_map(clone, params),
                tree_map(clone, opt_state.mu), tree_map(clone, opt_state.nu),
                opt_state.count.clone(),
                {k: clone(v) for k, v in batch.items()}, pool=self.pool)
            # the eager warm-up stepped the buffers: the first replay
            # starts from the state handed in
            self._copy_in(params, opt_state)
        return self.graph

    def _copy_in(self, params, opt_state: OptState) -> None:
        s_params, s_mu, s_nu, s_count, _ = self.graph.static
        _copy_leaves(s_params, params, "params")
        _copy_leaves((s_mu, s_nu, s_count),
                     (opt_state.mu, opt_state.nu, opt_state.count),
                     "optimizer state")

    def __call__(self, params, opt_state: OptState, batch):
        if batch["tokens"].device.type != "cuda":
            return self.eager(params, opt_state, batch)
        return self._replay(params, opt_state, batch)

    def _replay(self, params, opt_state: OptState, batch):
        if self.graph is None:
            self.capture(params, opt_state, batch)
        else:
            self._copy_in(params, opt_state)
        g = self.graph
        s_batch = g.static[4]
        if batch.keys() != s_batch.keys():
            raise ValueError(f"batch keys {sorted(batch)}: the graph was "
                             f"captured with {sorted(s_batch)}")
        _copy_leaves([s_batch[k] for k in batch], [batch[k] for k in batch],
                     "batch tensors")
        metrics = g.replay()
        return self.state + (metrics,)


def make_train_step(cfg: ModelConfig, shape: ShapeConfig, *,
                    opt: AdamWConfig | None = None,
                    accum_steps: int = 1, graph: bool = True, pool=None,
                    mesh=None, rules: ShardingRules | None = None):
    """fn(params, opt_state, batch) -> (params, opt_state, metrics): one
    AdamW step on the mean ``lm_loss`` of ``batch`` (``shape.global_batch``
    rows).  ``metrics``: ``loss``, ``grad_norm`` and ``lr``, 0-d f32
    tensors.  With ``accum_steps`` > 1 the batch splits into that many
    microbatches along its rows, run one after another: their gradients
    summed in f32 and averaged, their losses averaged, one optimizer step.
    On CUDA tensors with ``graph`` (the default) ``fn`` replays a CUDA
    graph that owns the state and updates it in place (the module
    docstring; ``pool``: a graph memory pool to share); on other tensors
    (the CPU's, the meta device's), or with ``graph=False``, it is the
    eager step, which returns new trees and leaves the old ones as they
    are (the JAX step's donated buffers are freed once the caller drops
    them).  ``fn.eager`` is the
    eager step either way.  With a ``mesh``: a :class:`CellPlan` whose
    ``fn`` is the sharded step, eager (the module docstring; ``graph``
    and ``pool`` unused)."""
    opt = opt or AdamWConfig()
    if shape.global_batch % accum_steps:
        raise ValueError(f"batch {shape.global_batch} does not split into "
                         f"{accum_steps} microbatches")
    if mesh is not None:
        return _mesh_train_step(cfg, shape, mesh, _rules(cfg, mesh, rules),
                                opt, accum_steps)

    def one_batch(params, batch):
        leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
        loss = tfm.lm_loss(leaves, batch, cfg)
        # a leaf the loss does not read gets a zero gradient, as in JAX
        it = iter(torch.autograd.grad(loss, tree_leaves(leaves),
                                      allow_unused=True))
        return loss.detach(), tree_map(
            lambda p: torch.zeros_like(p) if (g := next(it)) is None else g,
            leaves)

    def loss_and_grads(params, batch):
        if accum_steps == 1:
            return one_batch(params, batch)
        micro = {k: v.chunk(accum_steps) for k, v in batch.items()}
        loss = 0.0
        grads = tree_map(lambda p: torch.zeros(
            p.shape, dtype=torch.float32, device=p.device), params)
        for i in range(accum_steps):
            l_i, g_i = one_batch(params, {k: v[i] for k, v in micro.items()})
            grads = tree_map(lambda a, b: a + b.float(), grads, g_i)
            loss = loss + l_i
        return loss / accum_steps, tree_map(lambda g: g / accum_steps, grads)

    def train_step(params, opt_state, batch):
        loss, grads = loss_and_grads(params, batch)
        with torch.no_grad():
            new_p, new_o, metrics = adamw_update(grads, opt_state, params,
                                                 opt)
        return new_p, new_o, dict(loss=loss, **metrics)

    train_step.eager = train_step
    fn = _GraphedTrain(loss_and_grads, opt, pool, train_step) if graph \
        else train_step
    return StepPlan(cfg, shape, fn, cell_engine_config(cfg))


def make_prefill_step(cfg: ModelConfig, shape: ShapeConfig, *,
                      graph: bool = True, pool=None, mesh=None,
                      rules: ShardingRules | None = None):
    """fn(params, batch) -> (last-position logits, filled cache), the cache
    ``shape.seq_len`` long; ``batch`` holds ``tokens`` and, where the
    config takes them, ``audio_frames`` and ``vision_embeds``.  ``pool``:
    a graph memory pool to share.  With a ``mesh``: a :class:`CellPlan`,
    eager (``graph`` and ``pool`` unused)."""
    if mesh is not None:
        return _mesh_prefill_step(cfg, shape, mesh, _rules(cfg, mesh, rules))
    if graph:
        fn = _GraphedPrefill(cfg, shape, pool)
    else:
        def fn(params, batch):
            return tfm.prefill(params, batch["tokens"], cfg,
                               max_len=shape.seq_len,
                               audio_frames=batch.get("audio_frames"),
                               vision_embeds=batch.get("vision_embeds"))
    return StepPlan(cfg, shape, fn, cell_engine_config(cfg))


def make_serve_step(cfg: ModelConfig, shape: ShapeConfig, *,
                    graph: bool = True, pool=None, mesh=None,
                    rules: ShardingRules | None = None):
    """fn(params, cache, batch, decode_pos) -> (logits, new cache): one new
    token against a cache of ``shape.global_batch`` rows ``shape.seq_len``
    long.  ``pool``: a graph memory pool to share.  With a ``mesh``: a
    :class:`CellPlan`, eager, the new cache a functional update."""
    if mesh is not None:
        return _mesh_serve_step(cfg, shape, mesh, _rules(cfg, mesh, rules))
    if graph:
        fn = _GraphedServe(cfg, shape, pool)
    else:
        def fn(params, cache, batch, decode_pos):
            return tfm.decode_step(params, cache, batch["tokens"],
                                   decode_pos, cfg)
    return StepPlan(cfg, shape, fn, cell_engine_config(cfg))


@dataclasses.dataclass
class CNNCellPlan:
    """Serving plan of a CNN or MLP at one batch: ``fn(params, images) ->
    logits``, the whole network as one pipeline (``models.cnn.Pipeline``,
    a CUDA graph on the card).  ``boundaries``: the static chain
    accounting (``chain_boundary_summary`` / ``mlp_boundary_summary``;
    pool boundaries on the event path, densify points left).  ``mesh``:
    the mesh the plan serves on (None on one device), ``data_shards`` how
    many ways the batch splits over its data axes (1: whole on every
    rank), ``input_sharding`` the image buffer's DTensor placements (None
    off a mesh)."""

    spec: Any
    batch: int
    fn: Callable
    input_shape: tuple
    engine: EngineConfig = dataclasses.field(default_factory=EngineConfig)
    boundaries: dict = dataclasses.field(default_factory=dict)
    mesh: Any = None
    data_shards: int = 1
    input_sharding: Any = None


class BatchParallel:
    """A pipeline run batch-parallel over a mesh's data axes (the JAX
    package's ``shard_map`` with weights replicated and the batch
    sharded): ``fn(params, x)`` takes the full batch (the same on every
    rank), runs the inner pipeline (``models.cnn.Pipeline``, a CUDA graph
    on the card) on this rank's rows, and all-gathers the logits over the
    data axes, so every rank returns them whole.  The forward is
    independent per sample, so the logits are bitwise one device's.
    ``captures``, ``graph`` and ``fwd`` are the inner pipeline's."""

    def __init__(self, inner, mesh, placements: list, shape: tuple):
        self.inner, self.mesh, self.placements = inner, mesh, placements
        self.shape = tuple(shape)
        names = mesh.mesh_dim_names
        self._data_dims = [i for i, a in enumerate(names)
                           if a in ("pod", "data")]

    captures = property(lambda self: self.inner.captures)
    graph = property(lambda self: self.inner.graph)
    fwd = property(lambda self: self.inner.fwd)

    def _shard_index(self) -> int:
        """This rank's place along the data axes, major to minor."""
        coord, idx = self.mesh.get_coordinate(), 0
        for i in self._data_dims:
            idx = idx * self.mesh.size(i) + coord[i]
        return idx

    def __call__(self, params, x: torch.Tensor) -> torch.Tensor:
        from torch.distributed.tensor import DTensor
        if tuple(x.shape) != self.shape:
            raise ValueError(f"input {tuple(x.shape)}: this plan takes "
                             f"{self.shape}")
        rows = self.inner.shape[0]
        local = x.narrow(0, self._shard_index() * rows, rows)
        y = self.inner(params, local)
        return DTensor.from_local(y, self.mesh, self.placements,
                                  run_check=False).full_tensor()


def make_cnn_serve_step(spec, batch: int, *, mnf: bool = True,
                        engine_cfg: EngineConfig | None = None,
                        fire_cfg=None, device=None,
                        mesh=None) -> CNNCellPlan:
    """The event-resident CNN/MLP pipeline for batched serving at
    ``batch``: ``models.cnn.make_cnn_pipeline`` for a ``CNNSpec`` (already
    ``.scaled`` to the serving resolution), ``models.mlp.
    make_mlp_pipeline`` for an ``MLPSpec`` (a flat ``(batch,
    in_features)`` input).  On the card (``default_device()`` unless
    ``device`` says otherwise) ``fn`` captures one CUDA graph at its first
    call and replays it; a capture that fails raises.

    With a ``mesh`` the plan goes batch-parallel over its data axes
    (:class:`BatchParallel`): weights replicated, each data rank's
    pipeline built for ``batch / data`` rows.  A batch that does not
    divide the data axes stays whole on every rank (the same policy as
    ``parallel.sharding.serve_batch_pspec``)."""
    from repro_torch.core.fire import FireConfig
    from repro_torch.device import default_device
    from repro_torch.models import cnn as cnn_mod
    from repro_torch.models import mlp as mlp_mod

    dev = default_device() if device is None else torch.device(device)
    fire_cfg = fire_cfg or FireConfig()
    ecfg = engine_cfg or EngineConfig(backend="auto")
    data = data_axis_size(mesh) if mesh is not None else 1
    shards = data if (data > 1 and batch % data == 0) else 1
    rows = batch // shards
    if isinstance(spec, mlp_mod.MLPSpec):
        fn = mlp_mod.make_mlp_pipeline(spec, batch=rows, mnf=mnf,
                                       fire_cfg=fire_cfg, engine_cfg=ecfg,
                                       device=dev)
        boundaries = mlp_mod.mlp_boundary_summary(
            spec, batch=batch, fire_cfg=fire_cfg, engine_cfg=ecfg,
            device=dev) if mnf else {}
    else:
        fn = cnn_mod.make_cnn_pipeline(spec, batch=rows, mnf=mnf,
                                       fire_cfg=fire_cfg, engine_cfg=ecfg,
                                       device=dev)
        boundaries = cnn_mod.chain_boundary_summary(
            spec, batch=batch, fire_cfg=fire_cfg, engine_cfg=ecfg,
            device=dev) if mnf else {}
    shape = (batch,) + tuple(fn.shape[1:])
    in_sharding = None
    if mesh is not None:
        ndim = len(shape)
        in_sharding = to_placements(
            serve_batch_pspec(mesh, batch, ndim) if shards > 1 else (), mesh)
    if shards > 1:
        fn = BatchParallel(fn, mesh, in_sharding, shape)
    return CNNCellPlan(spec=spec, batch=batch, fn=fn, input_shape=shape,
                       engine=ecfg, boundaries=boundaries, mesh=mesh,
                       data_shards=shards, input_sharding=in_sharding)


def plan_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, **kw) -> CellPlan:
    """The sharded step of a cell's kind: train, prefill or decode."""
    if shape.kind == "train":
        return make_train_step(cfg, shape, mesh=mesh, **kw)
    if shape.kind == "prefill":
        return make_prefill_step(cfg, shape, mesh=mesh, **kw)
    return make_serve_step(cfg, shape, mesh=mesh, **kw)
