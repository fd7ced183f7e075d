"""Decoder-LM assembly — port of the ``block_type`` "rwkv6" and "hymba"
branches of ``repro.models.transformer``.

Params are a nested dict: ``embed`` (``tok``, ``unembed``), ``final_norm``
and ``layers``, whose leaves are stacked along a leading L axis as in the
JAX package (``params_from_numpy`` takes its ``init_params(...)[0]`` tree
as numpy arrays).  A Python loop over the layers stands in for
``lax.scan``, with each layer's attention window
(``cfg.window_for_layer``).  Every other block type raises and names its
ROADMAP.md item.  Entry points run on the card unless the caller passes
``device="cpu"``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import default_device
from repro_torch.models import attention, hymba, layers, ssm
from repro_torch.models.param_utils import Init, fold_in, stack_layer_params

__all__ = ["cache_specs", "compute_params", "copy_cache", "decode_step",
           "forward", "init_cache", "init_params", "params_from_numpy",
           "prefill"]


#: Block types the port serves.
PORTED_BLOCKS = ("rwkv6", "hymba")


def _check_block(cfg) -> None:
    """Raise for a block type the port does not serve yet, naming the
    ROADMAP.md item that brings it."""
    if cfg.block_type not in PORTED_BLOCKS or cfg.qkv_bias:
        raise NotImplementedError(
            f"{cfg.name} (block_type {cfg.block_type!r}"
            f"{', QKV biases' if cfg.qkv_bias else ''}) is not ported to "
            f"repro_torch yet; see ROADMAP.md queue A item 12, the LM stack "
            f"(attention, MLA, MoE, encoder-decoder and vision blocks)")


def _tree_map(fn, tree):
    """``fn`` on every leaf of a nested dict (a tuple is a leaf)."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def copy_cache(dst, src) -> None:
    """Copy each leaf of cache (or cache part) ``src`` over the same leaf
    of ``dst``, skipping a leaf that already is ``dst``'s tensor."""
    if isinstance(dst, dict):
        for k in dst:
            copy_cache(dst[k], src[k])
    elif src is not dst:
        dst.copy_(src)


def _tree_stack(trees: list) -> dict:
    """Stack the leaves of same-structured nested dicts along a new axis 0."""
    if isinstance(trees[0], dict):
        return {k: _tree_stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _device(device) -> torch.device:
    return default_device() if device is None else torch.device(device)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def _layer_init(seed: int, cfg, device) -> dict:
    """One decoder layer's params."""
    if cfg.block_type == "rwkv6":
        return ssm.rwkv6_block_init(seed, cfg, device)
    b = Init(seed, layers.dtype_of(cfg.param_dtype), device)
    b.ones("ln_attn", (cfg.d_model,))
    b.params["mix"] = hymba.hymba_block_init(fold_in(seed, 1), cfg, device)
    b.ones("ln_mlp", (cfg.d_model,))
    b.params["ffn"] = layers.mlp_init(fold_in(seed, 4), cfg, device=device)
    return b.done()


def init_params(seed: int, cfg, device=None) -> dict:
    """Random params from ``seed`` (each leaf its own generator,
    ``param_utils.fold_in``), in ``cfg.param_dtype`` on ``device``."""
    _check_block(cfg)
    dev = _device(device)
    lseed = fold_in(seed, 1)
    return dict(
        embed=layers.embed_init(fold_in(seed, 0), cfg, dev),
        final_norm=torch.ones((cfg.d_model,),
                              dtype=layers.dtype_of(cfg.param_dtype),
                              device=dev),
        layers=stack_layer_params(
            lambda s: _layer_init(s, cfg, dev),
            [fold_in(lseed, i) for i in range(cfg.num_layers)]))


def params_from_numpy(tree: dict, cfg, device=None) -> dict:
    """The port's params from the JAX package's ``init_params(key,
    cfg)[0]`` tree, as (nested dicts of) numpy arrays with stacked
    leading-L layer leaves."""
    _check_block(cfg)
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


#: The layer leaves each block casts to the compute dtype where it uses
#: them (matmul weights, and the Mamba conv taps and biases).
_CAST_LEAVES = {
    "rwkv6": frozenset(ssm.MATMUL_WEIGHTS),
    "hymba": frozenset(attention.ATTN_WEIGHTS + ssm.MAMBA_WEIGHTS
                       + layers.MLP_WEIGHTS),
}


def compute_params(params: dict, cfg) -> dict:
    """The params the forward multiplies: each leaf a block casts to the
    compute dtype where it uses it, and the unembedding, cast once to
    ``cfg.compute_dtype`` — the bits of the JAX package's per-use
    ``astype`` — every other leaf as it is (norms, lerps, the decay LoRA,
    a_log and d_skip stay f32).  At an f32 compute dtype this is
    ``params``' own tensors."""
    cdt = layers.dtype_of(cfg.compute_dtype)
    cast = _CAST_LEAVES[cfg.block_type]

    def conv(node):
        return {k: conv(v) if isinstance(v, dict)
                else (v.to(cdt) if k in cast else v)
                for k, v in node.items()}

    emb = dict(params["embed"])
    if "unembed" in emb:
        emb["unembed"] = emb["unembed"].to(cdt)
    return dict(params, embed=emb, layers=conv(params["layers"]))


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _apply_layer(p, x, *, cfg, positions, window, cache=None,
                 decode_pos=None, in_place=False):
    """Returns (x, new_cache).  A one-token input with a cache takes the
    decode branch (a prompt of length 1 too); longer inputs prefill from a
    zero state."""
    train_mode = cache is None and decode_pos is None
    if cfg.block_type == "rwkv6":
        if cache is not None and x.shape[1] == 1:
            x, new_cache = ssm.rwkv6_block_decode(p, x, cfg, cache)
        else:
            x, new_cache = ssm.rwkv6_block_apply(p, x, cfg)
        return x, None if train_mode else new_cache
    h = layers.rms_norm(x, p["ln_attn"] - 1.0, cfg.norm_eps)
    a, new_cache = hymba.hymba_block_apply(
        p["mix"], h, cfg=cfg, positions=positions, window=window,
        cache=cache, decode_pos=decode_pos, in_place=in_place)
    x = x + a
    h2 = layers.rms_norm(x, p["ln_mlp"] - 1.0, cfg.norm_eps)
    x = x + layers.mlp_apply(p["ffn"], h2, cfg)
    return x, None if train_mode else new_cache


def forward(params, tokens: torch.Tensor, cfg, *, cache=None,
            decode_pos=None, in_place: bool = False):
    """tokens (B, S) -> (hidden (B, S, d), new_cache).  ``decode_pos``:
    an int or a 0-d integer tensor (a CUDA graph's step reads it on the
    device).  The new cache is stacked from the layers' new leaves (the
    JAX package's functional update) or, with ``in_place``, written into
    ``cache``'s own tensors — the KV rows in place, every other leaf
    copied once over its layer's slice — and ``cache`` is returned: the
    counterpart of the JAX serve step's donated cache, for a step that
    owns its cache.  (The JAX package's third output, the MoE auxiliary
    loss, is 0 for these blocks.)"""
    _check_block(cfg)
    if in_place and cache is None:
        raise ValueError("an in-place step needs the cache it writes")
    s = tokens.shape[1]
    x = layers.embed_apply(params["embed"], tokens, cfg)
    positions = torch.arange(s, dtype=torch.int32, device=tokens.device)
    if decode_pos is not None:
        positions = positions + decode_pos
    per_layer = []
    for i in range(cfg.num_layers):
        p_l = _tree_map(lambda v: v[i], params["layers"])
        c_l = None if cache is None else \
            _tree_map(lambda v: v[i], cache["scan"])
        x, nc = _apply_layer(p_l, x, cfg=cfg, positions=positions,
                             window=cfg.window_for_layer(i), cache=c_l,
                             decode_pos=decode_pos, in_place=in_place)
        if in_place:
            copy_cache(c_l, nc)
        else:
            per_layer.append(nc)
    x = layers.rms_norm(x, params["final_norm"] - 1.0, cfg.norm_eps)
    if in_place:
        return x, cache
    new_cache = None
    if cache is not None or decode_pos is not None:
        new_cache = dict(scan=_tree_stack(per_layer))
    return x, new_cache


# ---------------------------------------------------------------------------
# Decode cache
# ---------------------------------------------------------------------------

def _layer_cache_spec(cfg, bsz: int, max_len: int) -> dict:
    """(shape, dtype) of each leaf of ONE layer's cache."""
    _check_block(cfg)
    cdt = layers.dtype_of(cfg.compute_dtype)
    if cfg.block_type == "rwkv6":
        out = dict(shift_att=((bsz, cfg.d_model), cdt),
                   shift_ffn=((bsz, cfg.d_model), cdt),
                   wkv=((bsz, cfg.num_heads, cfg.head_dim, cfg.head_dim),
                        torch.float32))
    else:
        di = cfg.d_model
        kv = ((bsz, max_len, cfg.num_kv_heads, cfg.head_dim), cdt)
        out = dict(attn=dict(k=kv, v=kv),
                   conv=((bsz, cfg.ssm.conv_dim - 1, di), cdt),
                   ssm=((bsz, di, cfg.ssm.state_dim), torch.float32))
    if cfg.mnf.enabled:
        # Per-token fired-event count of the gated decode (DESIGN.md §13).
        out["events"] = ((), torch.float32)
    return out


def cache_specs(cfg, bsz: int, max_len: int) -> dict:
    """(shape, dtype) of each leaf of the full decode cache (leading L)."""
    one = _layer_cache_spec(cfg, bsz, max_len)
    return dict(scan=_tree_map(lambda sd: ((cfg.num_layers,) + sd[0], sd[1]),
                               one))


def init_cache(cfg, bsz: int, max_len: int, device=None) -> dict:
    dev = _device(device)
    return _tree_map(lambda sd: torch.zeros(sd[0], dtype=sd[1], device=dev),
                     cache_specs(cfg, bsz, max_len))


def _logits(params, h: torch.Tensor, cfg) -> torch.Tensor:
    """f32 logits of f32 hidden states against the compute-dtype
    unembedding's values."""
    w = layers.unembed_matrix(params["embed"], cfg)
    logits = h.float() @ w.float()
    if cfg.final_logit_softcap:
        logits = cfg.final_logit_softcap * torch.tanh(
            logits / cfg.final_logit_softcap)
    return logits


def decode_step(params, cache, tokens: torch.Tensor, decode_pos, cfg, *,
                in_place: bool = False):
    """One new token per sequence against a filled cache.  tokens (B, 1);
    ``decode_pos`` an int or a 0-d integer tensor; ``in_place`` as in
    :func:`forward`.  Returns (logits (B, 1, V) f32, new_cache)."""
    h, new_cache = forward(params, tokens, cfg, cache=cache,
                           decode_pos=decode_pos, in_place=in_place)
    return _logits(params, h, cfg), new_cache


def prefill(params, tokens: torch.Tensor, cfg, *, max_len: int | None = None):
    """Run the prompt; returns (last-position logits (B, 1, V), filled
    cache)."""
    bsz, s = tokens.shape
    cache = init_cache(cfg, bsz, max_len or s, tokens.device)
    h, new_cache = forward(params, tokens, cfg, cache=cache, decode_pos=0)
    return _logits(params, h[:, -1:], cfg), new_cache
