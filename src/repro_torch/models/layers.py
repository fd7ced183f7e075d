"""Layer primitives — the parts of ``repro.models.layers`` the port's
models need: the dense max-pool oracle of the CNN, and the LM's norm,
rotary embedding, MLP, embeddings and MNF fire point.

LM apply-functions take params as dicts of tensors and compute in
``cfg.compute_dtype`` with f32 norm internals, as in the JAX package.
"""
from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F

from repro_torch.models.param_utils import Init

__all__ = ["MLP_WEIGHTS", "activation_fn", "apply_rope", "dtype_of", "embed_apply",
           "embed_init", "is_glu", "max_pool_nhwc", "mlp_apply", "mlp_init",
           "mnf_sparsify", "rms_norm", "unembed_matrix"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    """The torch dtype of a config's dtype name ("bfloat16", ...)."""
    return _DTYPES[name]


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
             d_model: int | None = None, *, device) -> dict:
    d = d_model or cfg.d_model
    f = d_ff or cfg.d_ff
    b = Init(seed, dtype_of(cfg.param_dtype), device)
    if is_glu(cfg.act):
        b.dense("w_gate", (d, f))
    b.dense("w_up", (d, f))
    b.dense("w_down", (f, d))
    return b.done()


def mlp_apply(p: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """x (..., d_model) -> (..., d_model): the MNF fire phase
    (:func:`mnf_sparsify`) sits between the up and down projections."""
    act = activation_fn(cfg.act)
    cdt = dtype_of(cfg.compute_dtype)
    xc = x.to(cdt)
    up = xc @ p["w_up"].to(cdt)
    if is_glu(cfg.act):
        h = act(xc @ p["w_gate"].to(cdt)) * up
    else:
        h = act(up)
    h = mnf_sparsify(h, cfg)
    return (h @ p["w_down"].to(cdt)).to(x.dtype)


def embed_init(seed: int, cfg, device) -> dict:
    b = Init(seed, dtype_of(cfg.param_dtype), device)
    # 1/sqrt(d) rows: keeps tied-unembedding logits at unit scale.
    b.dense("tok", (cfg.vocab_size, cfg.d_model), scale=cfg.d_model ** -0.5)
    if not cfg.tie_embeddings:
        b.dense("unembed", (cfg.d_model, cfg.vocab_size))
    return b.done()


def embed_apply(p: dict, tokens: torch.Tensor, cfg) -> torch.Tensor:
    """Embedding rows gathered, then cast to the compute dtype — the same
    bits whether the table is f32 or its compute-dtype copy
    (``index_select``: far less host time than advanced indexing of the
    (V, d) table; PERF.md §5)."""
    cdt = dtype_of(cfg.compute_dtype)
    emb = p["tok"].index_select(0, tokens.reshape(-1)).reshape(
        *tokens.shape, -1).to(cdt)
    if cfg.tie_embeddings:
        emb = emb * torch.tensor(float(cfg.d_model), dtype=cdt) ** 0.5
    return emb


def unembed_matrix(p: dict, cfg) -> torch.Tensor:
    """The (d, V) unembedding in the compute dtype (the logits multiply
    its bf16-rounded values in f32); a view, no copy, when the table
    already is in the compute dtype (``transformer.compute_params``)."""
    cdt = dtype_of(cfg.compute_dtype)
    if cfg.tie_embeddings:
        return p["tok"].T.to(cdt)
    return p["unembed"].to(cdt)
