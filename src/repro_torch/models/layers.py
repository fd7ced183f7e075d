"""Layer primitives — the parts of ``repro.models.layers`` the port's
models need: the dense max-pool oracle of the CNN, and the LM's norms,
rotary embedding, MLP, embeddings and MNF fire point.

LM apply-functions take params as dicts of tensors and compute in
``cfg.compute_dtype`` with f32 norm internals, as in the JAX package.
"""
from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.models.param_utils import Init

__all__ = ["MLP_WEIGHTS", "activation_fn", "apply_rope", "dtype_of",
           "embed_apply", "embed_init", "is_glu", "layer_norm",
           "max_pool_nhwc", "mlp_apply", "mlp_init", "mm", "mnf_sparsify",
           "rms_norm", "split_heads", "unembed_matrix"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    """The torch dtype of a config's dtype name ("bfloat16", ...)."""
    return _DTYPES[name]


def split_heads(t: torch.Tensor, heads: int, head_dim: int) -> torch.Tensor:
    """``t`` (..., heads * head_dim) as (..., heads, head_dim).  A DTensor
    whose last dim is sharded over mesh dims that ``heads`` does not
    divide (the flat width divides them, the head count does not, as 12
    heads of 128 over 16 ranks) is gathered on that dim first: DTensor
    cannot unflatten a shard that splits a head.  The caller's ``sc``
    then places the heads by their own rule."""
    if isinstance(t, DTensor):
        last = t.dim() - 1
        split = [i for i, pl in enumerate(t.placements)
                 if isinstance(pl, Shard) and pl.dim == last]
        ways = math.prod(t.device_mesh.mesh.shape[i] for i in split)
        if heads % ways:
            t = t.redistribute(t.device_mesh, [
                Replicate() if i in split else pl
                for i, pl in enumerate(t.placements)])
    return t.reshape(*t.shape[:-1], heads, head_dim)


def mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w``: activations x (..., k) against a weight w (k, n).  A
    DTensor x sharded on a dim between its first and its last (a
    sequence-sharded stream) is gathered whole on that dim first:
    ``@`` flattens the leading dims, and DTensor (torch 2.11) refuses to
    flatten a sharded dim other than the first (the all-gather GSPMD
    issues before the product under sequence parallelism)."""
    if isinstance(x, DTensor) and x.ndim > 2:
        last = x.ndim - 1
        pl = [Replicate() if isinstance(p, Shard) and 0 < p.dim < last
              else p for p in x.placements]
        if pl != list(x.placements):
            x = x.redistribute(x.device_mesh, pl)
        return _GradInPlace.apply(x @ w)
    return x @ w


class _GradInPlace(torch.autograd.Function):
    """Identity whose backward hands on the gradient in the forward
    output's own shards (replicated where the output was a partial sum):
    a gradient that reaches a product's output
    sharded on its sequence dim (from an op that took the stream so)
    comes back gathered on it, so the product's backward need not
    flatten a sharded dim either."""

    @staticmethod
    def forward(ctx, y):
        # a partial sum's gradient is one value on every rank
        ctx.placements = [p if isinstance(p, Shard) else Replicate()
                          for p in y.placements]
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        if isinstance(g, DTensor) and list(g.placements) != ctx.placements:
            g = g.redistribute(g.device_mesh, ctx.placements)
        return g


def max_pool_nhwc(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """VALID k×k max-pool over the spatial axes of a (B, H, W, C) map.

    The dense oracle of the event-native pool (bitwise equal to it: max is
    exact), written as a window view and a max so that no library pooling
    operator stands in for the event kernels."""
    win = x.unfold(1, k, stride).unfold(2, k, stride)   # (B, OH, OW, C, k, k)
    return win.amax(dim=(-2, -1))


def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMS norm in f32, scaled by ``1 + gamma`` (the models store the gain
    as ``ln - 1``), cast back to ``x``'s dtype."""
    dt = x.dtype
    x = x.float()
    var = x.square().mean(-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * (1.0 + gamma.float())).to(dt)


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """Layer norm with f32 statistics (mean, then the variance about it),
    scaled by ``gamma`` and shifted by ``beta``, cast back to ``x``'s
    dtype."""
    dt = x.dtype
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * gamma.float() + beta.float()).to(dt)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding, half-split (the first and second halves of D
    rotate as pairs, not interleaved).  x (..., S, H, D) with D even;
    positions (..., S).  The rotation runs in f32 and casts back."""
    d = x.shape[-1]
    half = d // 2
    freqs = torch.exp(-math.log(theta) * (
        torch.arange(half, dtype=torch.float32, device=x.device) / half))
    angles = positions[..., :, None].float() * freqs        # (..S, half)
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def activation_fn(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if name in ("silu_glu", "silu"):
        return F.silu
    if name in ("gelu_glu", "gelu"):
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "relu":
        return F.relu
    if name == "relu2":
        return lambda x: torch.square(F.relu(x))
    raise ValueError(f"unknown activation {name!r}")


def is_glu(name: str) -> bool:
    return name.endswith("_glu")


def mnf_sparsify(h: torch.Tensor, cfg) -> torch.Tensor:
    """The MNF fire phase on hidden activations plus block-event masking
    for the down projection (``engine.sparsify``); the identity when MNF
    is off, and at threshold 0 on a ReLU-family activation."""
    m = cfg.mnf
    if not m.enabled:
        return h
    from repro_torch import engine
    return engine.sparsify(h, engine.EngineConfig.from_mnf(m))


#: The MLP's matmul weights (each cast to the compute dtype where it
#: multiplies).
MLP_WEIGHTS = ("w_gate", "w_up", "w_down")


def mlp_init(seed: int, cfg, d_ff: int | None = None,
             d_model: int | None = None, *, device, with_axes: bool = False):
    d = d_model or cfg.d_model
    f = d_ff or cfg.d_ff
    b = Init(seed, dtype_of(cfg.param_dtype), device, with_axes=with_axes)
    if is_glu(cfg.act):
        b.dense("w_gate", (d, f), ("embed", "ff"))
    b.dense("w_up", (d, f), ("embed", "ff"))
    b.dense("w_down", (f, d), ("ff", "embed"))
    return b.done()


def mlp_apply(p: dict, x: torch.Tensor, cfg,
              sc=lambda x, ax: x) -> torch.Tensor:
    """x (..., d_model) -> (..., d_model): the MNF fire phase
    (:func:`mnf_sparsify`) sits between the up and down projections."""
    act = activation_fn(cfg.act)
    cdt = dtype_of(cfg.compute_dtype)
    xc = x.to(cdt)
    up = mm(xc, p["w_up"].to(cdt))
    if is_glu(cfg.act):
        h = act(mm(xc, p["w_gate"].to(cdt))) * up
    else:
        h = act(up)
    h = sc(h, ("batch",) + (None,) * (h.ndim - 2) + ("ff",))
    h = mnf_sparsify(h, cfg)
    return mm(h, p["w_down"].to(cdt)).to(x.dtype)


def embed_init(seed: int, cfg, device, *, with_axes: bool = False):
    b = Init(seed, dtype_of(cfg.param_dtype), device, with_axes=with_axes)
    # 1/sqrt(d) rows: keeps tied-unembedding logits at unit scale.
    b.dense("tok", (cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
            scale=cfg.d_model ** -0.5)
    if not cfg.tie_embeddings:
        b.dense("unembed", (cfg.d_model, cfg.vocab_size), ("embed", "vocab"))
    return b.done()


def embed_apply(p: dict, tokens: torch.Tensor, cfg) -> torch.Tensor:
    """Embedding rows gathered, then cast to the compute dtype — the same
    bits whether the table is f32 or its compute-dtype copy
    (``index_select``: far less host time than advanced indexing of the
    (V, d) table; PERF.md §5).  On DTensors the lookup is vocab-parallel
    (:func:`_vocab_parallel_embed`)."""
    if isinstance(tokens, DTensor):
        return _vocab_parallel_embed(p["tok"], tokens, cfg)
    cdt = dtype_of(cfg.compute_dtype)
    emb = p["tok"].index_select(0, tokens.reshape(-1)).reshape(
        *tokens.shape, -1).to(cdt)
    return _embed_scale(emb, cfg)


def _embed_scale(emb: torch.Tensor, cfg) -> torch.Tensor:
    if cfg.tie_embeddings:
        emb = emb * torch.tensor(float(cfg.d_model), dtype=emb.dtype) ** 0.5
    return emb


def _vocab_parallel_embed(table: DTensor, tokens: DTensor,
                          cfg) -> DTensor:
    """:func:`embed_apply` on DTensors.  Each rank looks up its own batch
    rows (the tokens' data shards) in its own vocabulary shard of the
    table, an id outside the shard giving a zero row; one all-reduce over
    the vocabulary's mesh axes, in the compute dtype, sums the shards'
    rows (each id's row lies in one shard: the sum is that row, bitwise).
    The table is gathered only on the mesh dims that shard it otherwise
    (FSDP's embed dim over the data axis), and its gradient comes back
    into those placements, a partial sum over the data axes.  DTensor's
    own ``index_select`` is not used: DTensor 2.11 gives its backward the
    global indices against the local gradient."""
    from torch.distributed.tensor import Partial

    from repro_torch.parallel.sharding import shard_range, sum_over_group
    mesh = tokens.device_mesh
    rows = [pl if isinstance(pl, Shard) and pl.dim == 0 else Replicate()
            for pl in tokens.placements]
    vocab = [i for i, pl in enumerate(table.placements)
             if isinstance(pl, Shard) and pl.dim == 0
             and not isinstance(rows[i], Shard)]
    tbl = table.redistribute(mesh, [
        Shard(0) if i in vocab else Replicate() for i in range(mesh.ndim)
    ]).to_local(grad_placements=[
        Shard(0) if i in vocab else Partial() if isinstance(rows[i], Shard)
        else Replicate() for i in range(mesh.ndim)])
    ids = tokens.redistribute(mesh, rows).to_local()
    lo, n = shard_range(mesh, vocab, table.shape[0])
    flat = ids.reshape(-1) - lo
    miss = (flat < 0) | (flat >= n)
    emb = tbl.index_select(0, flat.masked_fill(miss, 0)).masked_fill(
        miss[:, None], 0).reshape(*ids.shape, -1).to(
        dtype_of(cfg.compute_dtype))
    for i in vocab:
        emb = sum_over_group(emb, mesh.get_group(i))
    return DTensor.from_local(_embed_scale(emb, cfg), mesh, rows,
                              run_check=False)


def unembed_matrix(p: dict, cfg) -> torch.Tensor:
    """The (d, V) unembedding in the compute dtype (the logits multiply
    its bf16-rounded values in f32); a view, no copy, when the table
    already is in the compute dtype (``transformer.compute_params``)."""
    cdt = dtype_of(cfg.compute_dtype)
    if cfg.tie_embeddings:
        return p["tok"].T.to(cdt)
    return p["unembed"].to(cdt)
