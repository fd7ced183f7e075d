"""Decoder-LM assembly — port of ``repro.models.transformer`` for the
decoder-only serving path: the "rwkv6" and "hymba" blocks, and the
attention block — GQA with optional QKV biases, Gemma-2's attention and
final logit softcaps, alternating local and global windows and post-block
norms, DeepSeek-V2's MLA (``attention.mla_apply``) and the sort-dispatched
MoE (``moe.moe_apply``) with its leading dense layers.

Params are a nested dict: ``embed`` (``tok``, ``unembed``),
``final_norm``, ``layers`` and, for an MoE arch, ``dense_layers`` (its
``moe.first_dense_layers`` leading dense-FFN layers), each stack's leaves
along a leading L axis as in the JAX package (``params_from_numpy`` takes
its ``init_params(...)[0]`` tree as numpy arrays).  A Python loop over the
layers stands in for ``lax.scan``, with each layer's attention window
(``cfg.window_for_layer``).  The encoder-decoder and vision inputs and
explicit expert parallelism (``moe_ep``) raise and name their ROADMAP.md
items.  Entry points run on the card unless the caller passes
``device="cpu"``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import default_device
from repro_torch.models import attention, hymba, layers, moe, ssm
from repro_torch.models.param_utils import Init, fold_in, stack_layer_params

__all__ = ["active_params", "cache_specs", "compute_params", "copy_cache",
           "count_params", "decode_step", "forward", "init_cache",
           "init_compute_params", "init_params", "params_from_numpy",
           "prefill", "unembed_logits"]


#: Block types the port serves.
PORTED_BLOCKS = ("rwkv6", "hymba", "attn")


def _check_block(cfg) -> None:
    """Raise for what the port does not serve yet, naming the ROADMAP.md
    item that brings it."""
    if cfg.block_type not in PORTED_BLOCKS:
        raise NotImplementedError(
            f"{cfg.name}: block_type {cfg.block_type!r} is not ported to "
            f"repro_torch")
    if cfg.encoder_decoder or cfg.vision_tokens:
        raise NotImplementedError(
            f"{cfg.name} (encoder-decoder or vision tokens) is not ported to "
            f"repro_torch yet; see ROADMAP.md queue A item 12b (whisper-base "
            f"and phi-3-vision with layer_norm)")
    if cfg.moe_ep:
        raise NotImplementedError(
            f"{cfg.name}: moe_ep (expert parallelism over a mesh) is not "
            f"ported to repro_torch; see ROADMAP.md queue A item 13 (parallel "
            f"and runtime)")


def _tree_map(fn, tree):
    """``fn`` on every leaf of a nested dict (a tuple is a leaf)."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tree_leaves(v)]
    return [tree]


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


def _stacks(cfg) -> list:
    """(cache part, params key, index of its first layer, layers, MoE FFN)
    of each layer stack, in the order the forward runs them: an MoE arch's
    leading dense layers, then the uniform stack (the cache lists them the
    other way round, as the JAX package does)."""
    n_dense = cfg.moe.first_dense_layers if cfg.moe else 0
    out = [("dense", "dense_layers", 0, n_dense, False)] if n_dense else []
    return out + [("scan", "layers", n_dense, cfg.num_layers - n_dense,
                   cfg.moe is not None)]


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def _layer_init(seed: int, cfg, device, *, moe_layer: bool) -> dict:
    """One decoder layer's params."""
    if cfg.block_type == "rwkv6":
        return ssm.rwkv6_block_init(seed, cfg, device)
    d = cfg.d_model
    b = Init(seed, layers.dtype_of(cfg.param_dtype), device)
    b.ones("ln_attn", (d,))
    if cfg.block_type == "hymba":
        mix = hymba.hymba_block_init(fold_in(seed, 1), cfg, device)
    elif cfg.mla is not None:
        mix = attention.mla_init(fold_in(seed, 1), cfg, device)
    else:
        mix = attention.attn_init(fold_in(seed, 1), cfg, device)
    b.params["mix"] = mix
    b.ones("ln_mlp", (d,))
    if cfg.post_block_norm:
        b.ones("ln_attn_post", (d,))
        b.ones("ln_mlp_post", (d,))
    if moe_layer:
        b.params["ffn"] = moe.moe_init(fold_in(seed, 3), cfg, device)
    else:
        d_ff = (cfg.moe.dense_ff or cfg.d_ff) if cfg.moe else cfg.d_ff
        b.params["ffn"] = layers.mlp_init(fold_in(seed, 4), cfg, d_ff=d_ff,
                                          device=device)
    return b.done()


def _init_tree(seed: int, cfg, device, leaf_fn) -> dict:
    """The params from ``seed`` (each leaf its own generator,
    ``param_utils.fold_in``), each module tree — the embeddings, each
    layer — passed through ``leaf_fn`` as it is made."""
    _check_block(cfg)
    out = dict(
        embed=leaf_fn(layers.embed_init(fold_in(seed, 0), cfg, device)),
        final_norm=torch.ones((cfg.d_model,),
                              dtype=layers.dtype_of(cfg.param_dtype),
                              device=device))
    for part, key, _, n, moe_layer in _stacks(cfg):
        base = fold_in(seed, 1 if part == "scan" else 2)
        out[key] = stack_layer_params(
            lambda s: leaf_fn(_layer_init(s, cfg, device,
                                          moe_layer=moe_layer)),
            [fold_in(base, i) for i in range(n)])
    return out


def init_params(seed: int, cfg, device=None) -> dict:
    """Random params from ``seed`` in ``cfg.param_dtype`` on ``device``
    (on the ``meta`` device: shapes and dtypes only)."""
    return _init_tree(seed, cfg, _device(device), lambda tree: tree)


def _cast_leaves(cfg) -> frozenset:
    """The leaves the forward casts to the compute dtype where it uses
    them: the embedding table (cast right after the gather, or as the
    tied unembedding), the unembedding, and each block's matmul weights
    and biases (the Mamba conv taps and biases too)."""
    if cfg.block_type == "rwkv6":
        block = ssm.MATMUL_WEIGHTS
    elif cfg.block_type == "hymba":
        block = attention.ATTN_WEIGHTS + ssm.MAMBA_WEIGHTS \
            + layers.MLP_WEIGHTS
    else:                         # the MoE's experts share the MLP's names
        block = attention.ATTN_WEIGHTS + attention.MLA_WEIGHTS \
            + layers.MLP_WEIGHTS
    return frozenset(("tok", "unembed") + block)


def _cast(tree: dict, names: frozenset, cdt: torch.dtype) -> dict:
    return {k: _cast(v, names, cdt) if isinstance(v, dict)
            else (v.to(cdt) if k in names else v) for k, v in tree.items()}


def compute_params(params: dict, cfg) -> dict:
    """The params the forward multiplies: each leaf it casts to the
    compute dtype where it uses it (``_cast_leaves``), cast once to
    ``cfg.compute_dtype`` — the bits of the JAX package's per-use
    ``astype`` — every other leaf as it is (norms, lerps, the decay LoRA,
    a_log, d_skip and the MoE router stay f32).  At an f32 compute dtype
    this is ``params``' own tensors."""
    return _cast(params, _cast_leaves(cfg),
                 layers.dtype_of(cfg.compute_dtype))


def init_compute_params(seed: int, cfg, device=None) -> dict:
    """``compute_params(init_params(seed, cfg, device), cfg)``, built one
    module at a time: each layer's leaves are drawn in the param dtype,
    the ones the forward casts are cast, and the layer's f32 tensors are
    freed before the next is drawn — the f32 model is never held whole
    (Gemma-2-27B: 109 GB in f32, 54 GB so)."""
    names = _cast_leaves(cfg)
    cdt = layers.dtype_of(cfg.compute_dtype)
    return _init_tree(seed, cfg, _device(device),
                      lambda tree: _cast(tree, names, cdt))


def params_from_numpy(tree: dict, cfg, device=None) -> dict:
    """The port's params from the JAX package's ``init_params(key,
    cfg)[0]`` tree, as (nested dicts of) numpy arrays with stacked
    leading-L layer leaves: the keys and shapes of ``init_params(...,
    cfg)``'s tree are required."""
    dev = _device(device)
    want = init_params(0, cfg, "meta")

    def conv(node, ref, path):
        if isinstance(ref, dict):
            if set(node) != set(ref):
                raise KeyError(f"{path or 'params'}: keys {sorted(node)}, "
                               f"expected {sorted(ref)}")
            return {k: conv(node[k], ref[k], f"{path}/{k}") for k in ref}
        arr = np.array(node)
        if arr.shape != tuple(ref.shape):
            raise ValueError(f"{path}: shape {arr.shape}, expected "
                             f"{tuple(ref.shape)}")
        return torch.from_numpy(arr).to(dev)

    return conv(tree, want, "")


def count_params(cfg) -> int:
    """The model's parameter count (the shapes of ``init_params`` on the
    ``meta`` device, which allocates nothing)."""
    return sum(t.numel() for t in _tree_leaves(init_params(0, cfg, "meta")))


def active_params(cfg) -> int:
    """Parameters touched per token (MoE: the top-k and shared experts
    only)."""
    total = count_params(cfg)
    if cfg.moe is None:
        return total
    m = cfg.moe
    per_expert = (3 if layers.is_glu(cfg.act) else 2) * cfg.d_model \
        * m.expert_ff
    n_moe = cfg.num_layers - m.first_dense_layers
    return total - n_moe * (m.num_experts - m.top_k) * per_expert


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _apply_layer(p, x, *, cfg, positions, window, cache=None,
                 decode_pos=None, in_place=False, moe_layer=False):
    """Returns (x, new_cache).  A one-token input with a cache takes the
    recurrent blocks' decode branch (a prompt of length 1 too); longer
    inputs prefill from a zero state.  An MoE layer's auxiliary losses
    are dropped, as the JAX package's serve steps drop them."""
    train_mode = cache is None and decode_pos is None
    if cfg.block_type == "rwkv6":
        if cache is not None and x.shape[1] == 1:
            x, new_cache = ssm.rwkv6_block_decode(p, x, cfg, cache)
        else:
            x, new_cache = ssm.rwkv6_block_apply(p, x, cfg)
        return x, None if train_mode else new_cache
    h = layers.rms_norm(x, p["ln_attn"] - 1.0, cfg.norm_eps)
    if cfg.block_type == "hymba":
        mix = hymba.hymba_block_apply
    elif cfg.mla is not None:
        mix = attention.mla_apply
    else:
        mix = attention.attn_apply
    a, new_cache = mix(p["mix"], h, cfg=cfg, positions=positions,
                       window=window, cache=cache, decode_pos=decode_pos,
                       in_place=in_place)
    if cfg.post_block_norm:
        a = layers.rms_norm(a, p["ln_attn_post"] - 1.0, cfg.norm_eps)
    x = x + a
    h2 = layers.rms_norm(x, p["ln_mlp"] - 1.0, cfg.norm_eps)
    if moe_layer:
        f, _ = moe.moe_apply(p["ffn"], h2, cfg)
    else:
        f = layers.mlp_apply(p["ffn"], h2, cfg)
    if cfg.post_block_norm:
        f = layers.rms_norm(f, p["ln_mlp_post"] - 1.0, cfg.norm_eps)
    x = x + f
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
    loss, is what training reads; the serving path drops it.)"""
    _check_block(cfg)
    if in_place and cache is None:
        raise ValueError("an in-place step needs the cache it writes")
    s = tokens.shape[1]
    x = layers.embed_apply(params["embed"], tokens, cfg)
    positions = torch.arange(s, dtype=torch.int32, device=tokens.device)
    if decode_pos is not None:
        positions = positions + decode_pos
    stacked = {}
    for part, key, first, n, moe_layer in _stacks(cfg):
        per_layer = []
        for i in range(n):
            p_l = _tree_map(lambda v: v[i], params[key])
            c_l = None if cache is None else \
                _tree_map(lambda v: v[i], cache[part])
            x, nc = _apply_layer(p_l, x, cfg=cfg, positions=positions,
                                 window=cfg.window_for_layer(first + i),
                                 cache=c_l, decode_pos=decode_pos,
                                 in_place=in_place, moe_layer=moe_layer)
            if in_place:
                copy_cache(c_l, nc)
            else:
                per_layer.append(nc)
        stacked[part] = per_layer
    x = layers.rms_norm(x, params["final_norm"] - 1.0, cfg.norm_eps)
    if in_place:
        return x, cache
    new_cache = None
    if cache is not None or decode_pos is not None:
        new_cache = {st[0]: _tree_stack(stacked[st[0]])
                     for st in reversed(_stacks(cfg))}
    return x, new_cache


# ---------------------------------------------------------------------------
# Decode cache
# ---------------------------------------------------------------------------

def _layer_cache_spec(cfg, bsz: int, max_len: int) -> dict:
    """(shape, dtype) of each leaf of ONE layer's cache."""
    _check_block(cfg)
    cdt = layers.dtype_of(cfg.compute_dtype)
    if cfg.block_type == "attn":
        if cfg.mla is not None:
            return dict(c=((bsz, max_len, cfg.mla.kv_lora_rank), cdt),
                        kr=((bsz, max_len, cfg.mla.qk_rope_dim), cdt))
        kv = ((bsz, max_len, cfg.num_kv_heads, cfg.head_dim), cdt)
        return dict(k=kv, v=kv)
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
    """(shape, dtype) of each leaf of the full decode cache: ``scan``, and
    for an MoE arch ``dense``, each leaf with a leading L axis."""
    one = _layer_cache_spec(cfg, bsz, max_len)
    return {part: _tree_map(lambda sd: ((n,) + sd[0], sd[1]), one)
            for part, _, _, n, _ in reversed(_stacks(cfg))}


def init_cache(cfg, bsz: int, max_len: int, device=None) -> dict:
    dev = _device(device)
    return _tree_map(lambda sd: torch.zeros(sd[0], dtype=sd[1], device=dev),
                     cache_specs(cfg, bsz, max_len))


def unembed_logits(params, h: torch.Tensor, cfg) -> torch.Tensor:
    """f32 logits of hidden states ``h`` (B, S, d), taken in f32 against
    the compute-dtype unembedding's values, softcapped where the config
    says (``cfg.final_logit_softcap``)."""
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
    return unembed_logits(params, h, cfg), new_cache


def prefill(params, tokens: torch.Tensor, cfg, *, max_len: int | None = None):
    """Run the prompt; returns (last-position logits (B, 1, V), filled
    cache)."""
    bsz, s = tokens.shape
    cache = init_cache(cfg, bsz, max_len or s, tokens.device)
    h, new_cache = forward(params, tokens, cfg, cache=cache, decode_pos=0)
    return unembed_logits(params, h[:, -1:], cfg), new_cache
