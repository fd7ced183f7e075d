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

``moe_apply_ep`` (expert parallelism over a mesh) is not ported: it is
ROADMAP.md queue A item 13, and a config with ``moe_ep`` raises
(``models.transformer``).
"""
from __future__ import annotations

import torch

from repro_torch.models import layers
from repro_torch.models.param_utils import Init, fold_in

__all__ = ["moe_apply", "moe_capacity", "moe_init", "route"]


def moe_capacity(num_tokens: int, cfg) -> int:
    """Slots per expert and group: the capacity factor's share of the
    group's assignments, rounded up to a multiple of 8 (at least 8)."""
    m = cfg.moe
    c = int(num_tokens * m.top_k * m.capacity_factor / m.num_experts)
    return max(8, -(-c // 8) * 8)


def moe_init(seed: int, cfg, device) -> dict:
    m = cfg.moe
    d, f, e = cfg.d_model, m.expert_ff, m.num_experts
    b = Init(seed, layers.dtype_of(cfg.param_dtype), device)
    b.dense("router", (d, e))
    if layers.is_glu(cfg.act):
        b.dense("w_gate", (e, d, f))
    b.dense("w_up", (e, d, f))
    b.dense("w_down", (e, f, d))
    if m.num_shared:
        b.params["shared"] = layers.mlp_init(fold_in(seed, 7), cfg,
                                             d_ff=m.num_shared * f,
                                             device=device)
    return b.done()


def route(router: torch.Tensor, xf: torch.Tensor, cfg):
    """The router's fire decisions on tokens ``xf`` (..., d), in f32:
    (probs (..., E), gates (..., k), experts (..., k))."""
    probs = torch.softmax(xf.float() @ router.float(), dim=-1)
    gates, topi = torch.topk(probs, cfg.moe.top_k, dim=-1)
    if cfg.moe.router_renormalize:
        gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return probs, gates, topi


def moe_apply(p: dict, x: torch.Tensor, cfg):
    """x (B, S, d) -> (y (B, S, d), aux dict: ``load_balance_loss`` (the
    switch-style loss) and ``drop_fraction`` (the share of assignments
    past capacity), 0-d f32 tensors)."""
    m = cfg.moe
    bsz, s, d = x.shape
    t, k, e = bsz * s, m.top_k, m.num_experts
    cdt = x.dtype
    g = max(1, min(cfg.moe_dispatch_groups, t))
    while t % g:
        g //= 2
    tg = t // g                                              # tokens / group
    xf = x.reshape(g, tg, d)

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

    # the experts' FFNs: one batched product over every slot
    act = layers.activation_fn(cfg.act)
    up = torch.einsum("gecd,edf->gecf", de, p["w_up"].to(cdt))
    if layers.is_glu(cfg.act):
        h = act(torch.einsum("gecd,edf->gecf", de, p["w_gate"].to(cdt))) * up
    else:
        h = act(up)
    h = layers.mnf_sparsify(h, cfg)
    y_ec = torch.einsum("gecf,efd->gecd", h, p["w_down"].to(cdt))

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
        y = y + layers.mlp_apply(p["shared"], xf, cfg)

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
