"""Decoder-LM assembly — port of the ``block_type == "rwkv6"`` branches of
``repro.models.transformer``.

Params are a nested dict: ``embed`` (``tok``, ``unembed``), ``final_norm``
and ``layers``, whose leaves are stacked along a leading L axis as in the
JAX package (``params_from_numpy`` takes its ``init_params(...)[0]`` tree
as numpy arrays).  A Python loop over the layers stands in for
``lax.scan``.  Every other block type raises and names its ROADMAP.md
item.  Entry points run on the card unless the caller passes
``device="cpu"``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import default_device
from repro_torch.models import layers, ssm
from repro_torch.models.param_utils import fold_in, stack_layer_params

__all__ = ["cache_specs", "compute_params", "decode_step", "forward",
           "init_cache", "init_params", "params_from_numpy", "prefill"]


def _require_rwkv6(cfg) -> None:
    if cfg.block_type != "rwkv6":
        raise NotImplementedError(
            f"block_type {cfg.block_type!r} ({cfg.name}) is not ported to "
            f"repro_torch yet; see ROADMAP.md queue A: "
            + ("Hymba-1.5B decode with kernel B8" if cfg.block_type ==
               "hymba" else "item 12, the LM stack"))


def _device(device) -> torch.device:
    return default_device() if device is None else torch.device(device)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def init_params(seed: int, cfg, device=None) -> dict:
    """Random params from ``seed`` (each leaf its own generator,
    ``param_utils.fold_in``), in ``cfg.param_dtype`` on ``device``."""
    _require_rwkv6(cfg)
    dev = _device(device)
    lseed = fold_in(seed, 1)
    return dict(
        embed=layers.embed_init(fold_in(seed, 0), cfg, dev),
        final_norm=torch.ones((cfg.d_model,),
                              dtype=layers.dtype_of(cfg.param_dtype),
                              device=dev),
        layers=stack_layer_params(
            lambda s: ssm.rwkv6_block_init(s, cfg, dev),
            [fold_in(lseed, i) for i in range(cfg.num_layers)]))


def params_from_numpy(tree: dict, cfg, device=None) -> dict:
    """The port's params from the JAX package's ``init_params(key,
    cfg)[0]`` tree, as (nested dicts of) numpy arrays with stacked
    leading-L layer leaves."""
    _require_rwkv6(cfg)
    dev = _device(device)
    want = init_params(0, cfg.reduced(num_layers=1), "cpu")

    def conv(node, ref, path):
        if isinstance(ref, dict):
            if set(node) != set(ref):
                raise KeyError(f"{path or 'params'}: keys {sorted(node)}, "
                               f"expected {sorted(ref)}")
            return {k: conv(node[k], ref[k], f"{path}/{k}") for k in ref}
        return torch.from_numpy(np.array(node)).to(dev)

    return conv(tree, want, "")


def compute_params(params: dict, cfg) -> dict:
    """The params the forward multiplies: each block matmul weight and the
    unembedding cast once to ``cfg.compute_dtype`` — the bits of the JAX
    package's per-use ``astype`` — every other leaf as it is (the decay
    LoRA, norms and lerps stay f32).  At an f32 compute dtype this is
    ``params``' own tensors."""
    cdt = layers.dtype_of(cfg.compute_dtype)
    lay = {k: (v.to(cdt) if k in ssm.MATMUL_WEIGHTS else v)
           for k, v in params["layers"].items()}
    emb = dict(params["embed"])
    if "unembed" in emb:
        emb["unembed"] = emb["unembed"].to(cdt)
    return dict(params, embed=emb, layers=lay)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _apply_layer(p, x, *, cfg, cache=None, decode_pos=None):
    """Returns (x, new_cache).  A one-token input with a cache takes the
    decode branch (a prompt of length 1 too); longer inputs prefill from a
    zero state."""
    _require_rwkv6(cfg)
    train_mode = cache is None and decode_pos is None
    if cache is not None and x.shape[1] == 1:
        x, new_cache = ssm.rwkv6_block_decode(p, x, cfg, cache)
    else:
        x, new_cache = ssm.rwkv6_block_apply(p, x, cfg)
    if train_mode:
        new_cache = None
    return x, new_cache


def forward(params, tokens: torch.Tensor, cfg, *, cache=None,
            decode_pos=None):
    """tokens (B, S) -> (hidden (B, S, d), new_cache).  (The JAX
    package's third output, the MoE auxiliary loss, is 0 for RWKV6.)"""
    x = layers.embed_apply(params["embed"], tokens, cfg)
    per_layer = []
    for i in range(cfg.num_layers):
        p_l = {k: v[i] for k, v in params["layers"].items()}
        c_l = None if cache is None else \
            {k: v[i] for k, v in cache["scan"].items()}
        x, nc = _apply_layer(p_l, x, cfg=cfg, cache=c_l,
                             decode_pos=decode_pos)
        per_layer.append(nc)
    x = layers.rms_norm(x, params["final_norm"] - 1.0, cfg.norm_eps)
    new_cache = None
    if cache is not None or decode_pos is not None:
        new_cache = dict(scan={k: torch.stack([c[k] for c in per_layer])
                               for k in per_layer[0]})
    return x, new_cache


# ---------------------------------------------------------------------------
# Decode cache
# ---------------------------------------------------------------------------

def _layer_cache_spec(cfg, bsz: int, max_len: int) -> dict:
    """(shape, dtype) of each leaf of ONE layer's cache."""
    _require_rwkv6(cfg)
    cdt = layers.dtype_of(cfg.compute_dtype)
    out = dict(shift_att=((bsz, cfg.d_model), cdt),
               shift_ffn=((bsz, cfg.d_model), cdt),
               wkv=((bsz, cfg.num_heads, cfg.head_dim, cfg.head_dim),
                    torch.float32))
    if cfg.mnf.enabled:
        # Per-token fired-event count of the gated decode (DESIGN.md §13).
        out["events"] = ((), torch.float32)
    return out


def cache_specs(cfg, bsz: int, max_len: int) -> dict:
    """(shape, dtype) of each leaf of the full decode cache (leading L)."""
    one = _layer_cache_spec(cfg, bsz, max_len)
    return dict(scan={k: ((cfg.num_layers,) + shape, dt)
                      for k, (shape, dt) in one.items()})


def init_cache(cfg, bsz: int, max_len: int, device=None) -> dict:
    dev = _device(device)
    return dict(scan={k: torch.zeros(shape, dtype=dt, device=dev)
                      for k, (shape, dt) in
                      cache_specs(cfg, bsz, max_len)["scan"].items()})


def _logits(params, h: torch.Tensor, cfg) -> torch.Tensor:
    """f32 logits of f32 hidden states against the compute-dtype
    unembedding's values."""
    w = layers.unembed_matrix(params["embed"], cfg)
    logits = h.float() @ w.float()
    if cfg.final_logit_softcap:
        logits = cfg.final_logit_softcap * torch.tanh(
            logits / cfg.final_logit_softcap)
    return logits


def decode_step(params, cache, tokens: torch.Tensor, decode_pos, cfg):
    """One new token per sequence against a filled cache.  tokens (B, 1).
    Returns (logits (B, 1, V) f32, new_cache)."""
    h, new_cache = forward(params, tokens, cfg, cache=cache,
                           decode_pos=decode_pos)
    return _logits(params, h, cfg), new_cache


def prefill(params, tokens: torch.Tensor, cfg, *, max_len: int | None = None):
    """Run the prompt; returns (last-position logits (B, 1, V), filled
    cache)."""
    bsz, s = tokens.shape
    cache = init_cache(cfg, bsz, max_len or s, tokens.device)
    h, new_cache = forward(params, tokens, cfg, cache=cache, decode_pos=0)
    return _logits(params, h[:, -1:], cfg), new_cache
