"""Mixture-of-Experts with sort-based capacity dispatch — port of
``repro.models.moe`` (``moe_capacity``, ``moe_init``, ``moe_apply``).

The layer is the LM-scale image of the paper's technique: the router's
top-k decides which experts a token *fires* to, the dispatch carries
(value, direct expert address) events, and an expert a token did not
select does no work for it.  Per dispatch group (``cfg.moe_dispatch_groups``,
halved until it divides the token count):

1. top-k of softmax(router logits), in f32 -> (expert, gate) per
   assignment; optionally the gates renormalised;
2. a stable sort of the assignments by expert, the rank within an expert
   by ``searchsorted``, and the assignments past capacity C dropped;
3. the int32 slot -> token map, then a row gather into a dense (E, C, d)
   buffer, every expert's FFN as one batched product over all its slots
   (the MNF fire between up and down), and the gated combine.

Every shape is static and nothing reads a value back to the host, so the
layer runs inside a CUDA graph.  The combine sums each token's k gated
contributions in a fixed order — scattered back to (token, j) order, then
summed over j — where the JAX package scatter-adds them in sorted order
(``.at[].add``, whose CUDA counterpart adds with float atomics in any
order): the port is deterministic run to run, and allclose to JAX.

:func:`moe_apply_ep` is the explicit expert parallelism of a ``moe_ep``
config over a (dp x ep=``model``) mesh: each rank routes every token of
its data shard, runs the experts of its own slice on the events
addressed to them, and one token-sized all-reduce over the ep group sums
the contributions.  Off a mesh it is :func:`moe_apply`.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor

from repro_torch.models import layers
from repro_torch.models.param_utils import Init, fold_in
from repro_torch.parallel.sharding import sum_over_group

__all__ = ["moe_apply", "moe_apply_ep", "moe_capacity", "moe_init", "route"]


def moe_capacity(num_tokens: int, cfg) -> int:
    """Slots per expert and group: the capacity factor's share of the
    group's assignments, rounded up to a multiple of 8 (at least 8)."""
    m = cfg.moe
    c = int(num_tokens * m.top_k * m.capacity_factor / m.num_experts)
    return max(8, -(-c // 8) * 8)


def moe_init(seed: int, cfg, device, *, with_axes: bool = False):
    m = cfg.moe
    d, f, e = cfg.d_model, m.expert_ff, m.num_experts
    b = Init(seed, layers.dtype_of(cfg.param_dtype), device,
             with_axes=with_axes)
    b.dense("router", (d, e), ("embed", "experts"))
    if layers.is_glu(cfg.act):
        b.dense("w_gate", (e, d, f), ("experts", "embed", "ff_expert"))
    b.dense("w_up", (e, d, f), ("experts", "embed", "ff_expert"))
    b.dense("w_down", (e, f, d), ("experts", "ff_expert", "embed"))
    if m.num_shared:
        b.sub("shared", layers.mlp_init(fold_in(seed, 7), cfg,
                                        d_ff=m.num_shared * f, device=device,
                                        with_axes=True))
    return b.done()


def route(router: torch.Tensor, xf: torch.Tensor, cfg):
    """The router's fire decisions on tokens ``xf`` (..., d), in f32:
    (probs (..., E), gates (..., k), experts (..., k))."""
    probs = torch.softmax(layers.mm(xf.float(), router.float()), dim=-1)
    gates, topi = torch.topk(probs, cfg.moe.top_k, dim=-1)
    if cfg.moe.router_renormalize:
        gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return probs, gates, topi


def moe_apply(p: dict, x: torch.Tensor, cfg, sc=lambda x, ax: x):
    """x (B, S, d) -> (y (B, S, d), aux dict: ``load_balance_loss`` (the
    switch-style loss) and ``drop_fraction`` (the share of assignments
    past capacity), 0-d f32 tensors).  On DTensors (a sharded step of a
    config without ``moe_ep``) every rank runs it on the whole tensors
    (``parallel.sharding.replicated_call``: DTensor has no rule for the
    sort dispatch); :func:`moe_apply_ep` is the sharded MoE."""
    if isinstance(x, DTensor):
        from repro_torch.parallel.sharding import replicated_call
        return replicated_call(lambda p_, x_: moe_apply(p_, x_, cfg, sc=sc),
                               p, x)
    m = cfg.moe
    bsz, s, d = x.shape
    t, k, e = bsz * s, m.top_k, m.num_experts
    cdt = x.dtype
    g = max(1, min(cfg.moe_dispatch_groups, t))
    while t % g:
        g //= 2
    tg = t // g                                              # tokens / group
    xf = x.reshape(g, tg, d)
    xf = sc(xf, ("batch", None, None))

    # router: fire decisions
    probs, gates, topi = route(p["router"], xf, cfg)         # (G, Tg, E|k)

    # the group's event list, sorted by expert address
    flat_e = topi.reshape(g, tg * k).to(torch.int32)
    flat_t = (torch.arange(tg * k, dtype=torch.int32, device=x.device)
              // k).expand(g, tg * k)
    order = torch.argsort(flat_e, dim=1, stable=True)
    se = flat_e.gather(1, order)
    st = flat_t.gather(1, order)
    sg = gates.reshape(g, tg * k).gather(1, order)
    rank = torch.arange(tg * k, dtype=torch.int32, device=x.device) \
        - torch.searchsorted(se, se, side="left").to(torch.int32)
    cap = moe_capacity(tg, cfg)
    keep = rank < cap
    slot = torch.where(keep, se * cap + rank, e * cap).long()  # overflow slot

    # dispatch: the slot -> token map (int32 addresses), then a row gather
    inv = torch.full((g, e * cap + 1), -1, dtype=torch.int32,
                     device=x.device).scatter_(1, slot, st)[:, :e * cap]
    rows = xf.gather(1, inv.clamp(min=0).long()[..., None].expand(-1, -1, d))
    de = torch.where((inv >= 0)[..., None], rows,
                     torch.zeros((), dtype=cdt, device=x.device))
    de = de.reshape(g, e, cap, d)
    de = sc(de, ("batch", "experts", None, None))   # the EP all-to-all

    # the experts' FFNs: one batched product over every slot
    act = layers.activation_fn(cfg.act)
    up = torch.einsum("gecd,edf->gecf", de, p["w_up"].to(cdt))
    if layers.is_glu(cfg.act):
        h = act(torch.einsum("gecd,edf->gecf", de, p["w_gate"].to(cdt))) * up
    else:
        h = act(up)
    h = sc(h, ("batch", "experts", None, None))
    h = layers.mnf_sparsify(h, cfg)
    y_ec = torch.einsum("gecf,efd->gecd", h, p["w_down"].to(cdt))
    y_ec = sc(y_ec, ("batch", "experts", None, None))

    # combine: each assignment's gated output, back in (token, j) order,
    # summed over j
    y_pad = torch.cat([y_ec.reshape(g, e * cap, d),
                       torch.zeros((g, 1, d), dtype=cdt, device=x.device)], 1)
    contrib = y_pad.gather(1, slot[..., None].expand(-1, -1, d))
    contrib = torch.where(keep[..., None], contrib,
                          torch.zeros((), dtype=cdt, device=x.device))
    contrib = contrib * sg[..., None].to(cdt)
    unsorted = torch.empty_like(contrib).scatter_(
        1, order[..., None].expand(-1, -1, d), contrib)
    y = unsorted.reshape(g, tg, k, d).sum(dim=2)

    if m.num_shared:
        y = y + layers.mlp_apply(p["shared"], xf, cfg, sc=sc)

    # aux: switch-style load-balance loss and drop stats
    me = probs.reshape(t, e).mean(dim=0)
    ce = torch.zeros((e,), dtype=torch.float32, device=x.device).scatter_add_(
        0, flat_e.reshape(-1).long(),
        torch.ones((t * k,), dtype=torch.float32, device=x.device)) / (t * k)
    # the dropped share from the count (JAX's f32 1 - mean(keep) rounds:
    # it can read -2.98e-08 where nothing drops)
    aux = dict(load_balance_loss=e * torch.sum(me * ce),
               drop_fraction=(~keep).sum().float() / keep.numel())
    return y.reshape(bsz, s, d), aux


def moe_apply_ep(p: dict, x: torch.Tensor, cfg, sc=lambda x, ax: x):
    """Explicit expert parallelism (the JAX package's ``shard_map`` over
    dp x ep=``model``; here ``parallel.sharding.local_map``).

    Tokens shard over the data axes and are replicated over ``model``;
    the router is replicated; expert e lives on ep rank e // (E / ep).
    Each rank routes every token of its data shard, keeps only the
    events addressed to its own expert slice (capacity over its local
    tokens), runs those experts, and combines their gated outputs in
    (token, j) order; one token-sized all-reduce over the ep group sums
    the k contributions (the wire cost of a replicate-and-reduce, 3d a
    token, against 2kd for a dispatch-and-return all-to-all).  The
    load-balance statistics are averaged over the data axes (one packed
    all-reduce per data axis of more than one rank).  Gradients: the
    local inputs hand back partial sums (``grad_placements``) that DTensor
    reduces; the router's load-balance term counts on ep rank 0 only,
    where every ep rank computes it alike.

    Falls back to :func:`moe_apply` where the JAX package does: ``x`` on
    no mesh with a ``model`` axis (a plain tensor), or ``num_experts``
    not divisible by the ep size."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    from repro_torch.parallel.sharding import (local_map, logical_to_pspec,
                                               make_rules, place,
                                               to_placements)

    m = cfg.moe
    mesh = x.device_mesh if isinstance(x, DTensor) else None
    names = (mesh.mesh_dim_names or ()) if mesh is not None else ()
    if "model" not in names:
        return moe_apply(p, x, cfg, sc=sc)
    ep_dim = names.index("model")
    ep_size = mesh.size(ep_dim)
    e, k = m.num_experts, m.top_k
    if e % ep_size:
        return moe_apply(p, x, cfg, sc=sc)
    e_loc = e // ep_size
    bsz, s, d = x.shape
    cdt = x.dtype
    dp_dims = [i for i, a in enumerate(names) if a in ("pod", "data")]
    x_pl = to_placements(logical_to_pspec(("batch", None, None), x.shape,
                                          mesh, make_rules(mesh)), mesh)
    w_pl = [Shard(0) if i == ep_dim else Replicate()
            for i in range(len(names))]
    rep = [Replicate()] * len(names)
    # a data axis the tokens shard over leaves partial gradients behind
    dp_grad = [Partial() if isinstance(pl, Shard) else Replicate()
               for pl in x_pl]
    my = mesh.get_local_rank("model")
    ep_group = mesh.get_group("model")
    dp_groups = [(mesh.get_group(names[i]), mesh.size(i)) for i in dp_dims
                 if mesh.size(i) > 1]

    def local_fn(xl, router, w_gate, w_up, w_down):
        import torch.distributed as dist
        bl = xl.shape[0]
        tl = bl * s
        xf = xl.reshape(tl, d)
        probs, gates, topi = route(router, xf, cfg)
        flat_e = topi.reshape(-1).to(torch.int32)
        flat_t = torch.arange(tl * k, dtype=torch.int32, device=xl.device) \
            // k
        order = torch.argsort(flat_e, stable=True)
        se, st, sg = flat_e[order], flat_t[order], gates.reshape(-1)[order]
        rank = torch.arange(tl * k, dtype=torch.int32, device=xl.device) \
            - torch.searchsorted(se, se, side="left").to(torch.int32)
        cap = moe_capacity(tl, cfg)
        # fire only the events addressed to MY expert slice
        mine = (se >= my * e_loc) & (se < (my + 1) * e_loc)
        keep = (rank < cap) & mine
        slot = torch.where(keep, (se - my * e_loc) * cap + rank,
                           e_loc * cap).long()
        inv = torch.full((e_loc * cap + 1,), -1, dtype=torch.int32,
                         device=xl.device).scatter_(0, slot, st)[:e_loc * cap]
        rows = xf[inv.clamp(min=0).long()]
        de = torch.where((inv >= 0)[:, None], rows,
                         torch.zeros((), dtype=cdt, device=xl.device))
        de = de.reshape(e_loc, cap, d)
        act = layers.activation_fn(cfg.act)
        up = torch.einsum("ecd,edf->ecf", de, w_up.to(cdt))
        if layers.is_glu(cfg.act):
            h = act(torch.einsum("ecd,edf->ecf", de, w_gate.to(cdt))) * up
        else:
            h = act(up)
        h = layers.mnf_sparsify(h, cfg)
        y_ec = torch.einsum("ecf,efd->ecd", h, w_down.to(cdt))
        y_pad = torch.cat([y_ec.reshape(e_loc * cap, d),
                           torch.zeros((1, d), dtype=cdt, device=xl.device)])
        contrib = torch.where(keep[:, None], y_pad[slot],
                              torch.zeros((), dtype=cdt, device=xl.device))
        contrib = contrib * sg[:, None].to(cdt)
        unsorted = torch.empty_like(contrib).index_copy_(0, order, contrib)
        y = unsorted.reshape(tl, k, d).sum(dim=1)
        # each ep rank holds the contributions of ITS experts only
        y = sum_over_group(y, ep_group)

        me = probs.mean(dim=0)
        if my != 0:
            me = me.detach()
        ce = torch.zeros((e,), dtype=torch.float32,
                         device=xl.device).scatter_add_(
            0, flat_e.long(), torch.ones((tl * k,), dtype=torch.float32,
                                         device=xl.device)) / (tl * k)
        drop = ((rank >= cap).sum().float() / (tl * k))[None]
        stats = torch.cat([me, ce, drop])
        for group, n in dp_groups:                 # pmean over the data axes
            stats = sum_over_group(stats, group) / n
        me, ce, drop = stats[:e], stats[e:2 * e], stats[2 * e]
        return y.reshape(bl, s, d), e * torch.sum(me * ce), drop

    w_gate = p.get("w_gate", p["w_up"])            # non-GLU: unused dummy
    xl = place(x, mesh, x_pl).to_local(grad_placements=[
        Partial() if i == ep_dim else pl for i, pl in enumerate(x_pl)])
    wl = [place(w, mesh, w_pl).to_local(grad_placements=[
        Shard(0) if i == ep_dim else pl for i, pl in enumerate(dp_grad)])
        for w in (w_gate, p["w_up"], p["w_down"])]
    rl = place(p["router"], mesh, rep).to_local(grad_placements=[
        Partial() if i == ep_dim else pl for i, pl in enumerate(dp_grad)])
    y, aux_lb, aux_drop = local_map(local_fn, mesh, (x_pl, rep, rep),
                                    xl, rl, *wl)
    y = sc(y, ("batch", "seq", None))
    if m.num_shared:
        y = y + layers.mlp_apply(p["shared"], x, cfg, sc=sc)
    return y, dict(load_balance_loss=aux_lb, drop_fraction=aux_drop)
