"""LM assembly — port of ``repro.models.transformer``: the "rwkv6" and
"hymba" blocks, and the attention block — GQA with
optional QKV biases, Gemma-2's attention and final logit softcaps,
alternating local and global windows and post-block norms, DeepSeek-V2's
MLA (``attention.mla_apply``) and the sort-dispatched MoE
(``moe.moe_apply``) with its leading dense layers; whisper's
encoder-decoder (a non-causal encoder over precomputed audio frames, and
a cross-attention in each decoder layer whose keys and values the
prefill computes once and the cache carries); phi-3-vision's patch
embeddings in the leading positions.

Params are a nested dict: ``embed`` (``tok``, ``unembed``),
``final_norm``, ``layers``, for an MoE arch ``dense_layers`` (its
``moe.first_dense_layers`` leading dense-FFN layers), and for an
encoder-decoder ``encoder`` and ``enc_final_norm``, each stack's leaves
along a leading L axis as in the JAX package (``params_from_numpy`` takes
its ``init_params(...)[0]`` tree as numpy arrays).  A Python loop over the
layers stands in for ``lax.scan``, with each layer's attention window
(``cfg.window_for_layer``), each layer's params ``unbind`` views of the
stacks (autograd stacks their gradients back in one op a leaf).
Entry points run on the card unless the caller passes ``device="cpu"``.

Sharding: every entry point takes ``sc(x, logical_axes)``, called at the
JAX package's points (``parallel.sharding.make_sharder`` redistributes a
DTensor to the placements the axes resolve to on a mesh); the identity
:data:`_id_sc` by default, and then nothing computed changes.
:func:`param_axes` and :func:`cache_axes` give every param and cache
leaf its logical axes.  A ``moe_ep`` config's MoE layers run
``moe.moe_apply_ep`` (expert parallelism on a mesh, ``moe_apply`` off
one).

Training: :func:`lm_loss` is the chunked softmax cross-entropy of the JAX
package, with the MoE auxiliary loss the forward sums.  Under autograd
each layer of the uniform stack, each encoder layer and each
cross-entropy chunk runs under ``cfg.remat`` (:func:`_remat`, the JAX
package's ``_remat_policy``): "full" recomputes it in the backward,
"dots" saves its matmul outputs, "none" saves everything.  Params stay
in ``cfg.param_dtype`` and are cast where they are used, so the
gradients land on the param-dtype leaves.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import GLOBAL_WINDOW
from repro_torch.device import default_device
from repro_torch.models import attention, hymba, layers, moe, ssm
from repro_torch.models.param_utils import (Init, fold_in, stack_layer_params,
                                           tree_leaves, tree_map)

__all__ = ["Sharder", "active_params", "cache_axes", "cache_specs",
           "compute_params", "copy_cache", "count_params", "decode_step",
           "forward", "init_cache", "init_compute_params", "init_params",
           "input_specs", "lm_loss", "param_axes", "params_from_numpy",
           "prefill", "unembed_logits"]

#: ``sc(x, logical_axes) -> x``: an activation sharding constraint.
Sharder = Callable[[torch.Tensor, tuple], torch.Tensor]
_id_sc: Sharder = lambda x, ax: x


#: Block types the port serves.
PORTED_BLOCKS = ("rwkv6", "hymba", "attn")


def _check_block(cfg) -> None:
    """Raise for a block type the port does not serve."""
    if cfg.block_type not in PORTED_BLOCKS:
        raise NotImplementedError(
            f"{cfg.name}: block_type {cfg.block_type!r} is not ported to "
            f"repro_torch")


def copy_cache(dst, src) -> None:
    """Copy each leaf of cache (or cache part) ``src`` over the same leaf
    of ``dst``, skipping a leaf that already is ``dst``'s tensor."""
    if isinstance(dst, dict):
        for k in dst:
            copy_cache(dst[k], src[k])
    elif src is not dst:
        dst.copy_(src)


def _unstack(tree: dict, n: int) -> list:
    """The ``n`` per-layer trees of a stack: each leaf ``unbind`` along
    axis 0 (views, whose gradients autograd stacks back in one op, where
    indexing each layer would add a stack-sized gradient a layer)."""
    views = tree_map(lambda v: v.unbind(0), tree)
    return [tree_map(lambda t: t[i], views) for i in range(n)]


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

def _layer_init(seed: int, cfg, device, *, moe_layer: bool,
                cross_attn: bool = False, with_axes: bool = False):
    """One decoder layer's params (with ``cross_attn``, an encoder-decoder's
    cross-attention ``cross`` and its norm ``ln_cross``)."""
    if cfg.block_type == "rwkv6":
        return ssm.rwkv6_block_init(seed, cfg, device, with_axes=with_axes)
    d = cfg.d_model
    b = Init(seed, layers.dtype_of(cfg.param_dtype), device,
             with_axes=with_axes)
    b.ones("ln_attn", (d,), ("embed",))
    if cfg.block_type == "hymba":
        mix = hymba.hymba_block_init
    elif cfg.mla is not None:
        mix = attention.mla_init
    else:
        mix = attention.attn_init
    b.sub("mix", mix(fold_in(seed, 1), cfg, device, with_axes=True))
    if cross_attn:
        b.sub("cross", attention.attn_init(fold_in(seed, 2), cfg, device,
                                           with_axes=True))
        b.ones("ln_cross", (d,), ("embed",))
    b.ones("ln_mlp", (d,), ("embed",))
    if cfg.post_block_norm:
        b.ones("ln_attn_post", (d,), ("embed",))
        b.ones("ln_mlp_post", (d,), ("embed",))
    if moe_layer:
        b.sub("ffn", moe.moe_init(fold_in(seed, 3), cfg, device,
                                  with_axes=True))
    else:
        d_ff = (cfg.moe.dense_ff or cfg.d_ff) if cfg.moe else cfg.d_ff
        b.sub("ffn", layers.mlp_init(fold_in(seed, 4), cfg, d_ff=d_ff,
                                     device=device, with_axes=True))
    return b.done()


def _enc_layer_init(seed: int, cfg, device, *, with_axes: bool = False):
    """One encoder layer's params: non-causal self-attention and an MLP."""
    b = Init(seed, layers.dtype_of(cfg.param_dtype), device,
             with_axes=with_axes)
    b.ones("ln_attn", (cfg.d_model,), ("embed",))
    b.sub("mix", attention.attn_init(fold_in(seed, 1), cfg, device,
                                     with_axes=True))
    b.ones("ln_mlp", (cfg.d_model,), ("embed",))
    b.sub("ffn", layers.mlp_init(fold_in(seed, 2), cfg, device=device,
                                 with_axes=True))
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
        cross = cfg.encoder_decoder and part == "scan"
        out[key] = stack_layer_params(
            lambda s: leaf_fn(_layer_init(s, cfg, device, moe_layer=moe_layer,
                                          cross_attn=cross)),
            [fold_in(base, i) for i in range(n)])
    if cfg.encoder_decoder:
        base = fold_in(seed, 3)
        out["encoder"] = stack_layer_params(
            lambda s: leaf_fn(_enc_layer_init(s, cfg, device)),
            [fold_in(base, i) for i in range(cfg.enc_layers)])
        out["enc_final_norm"] = torch.ones(
            (cfg.d_model,), dtype=layers.dtype_of(cfg.param_dtype),
            device=device)
    return out


def init_params(seed: int, cfg, device=None) -> dict:
    """Random params from ``seed`` in ``cfg.param_dtype`` on ``device``
    (on the ``meta`` device: shapes and dtypes only)."""
    return _init_tree(seed, cfg, _device(device), lambda tree: tree)


def param_axes(cfg) -> dict:
    """The logical axes of every param leaf: a tree of the keys of
    :func:`init_params`' tree, each leaf the tuple of axis names the JAX
    package's ``init_params(key, cfg)[1]`` has there (the stacks' leaves
    with ``"layers"`` first)."""
    _check_block(cfg)
    stacked = lambda axes: tree_map(lambda ax: ("layers",) + ax, axes)
    out = dict(embed=layers.embed_init(0, cfg, "meta", with_axes=True)[1],
               final_norm=("embed",))
    for part, key, _, _, moe_layer in _stacks(cfg):
        out[key] = stacked(_layer_init(
            0, cfg, "meta", moe_layer=moe_layer, with_axes=True,
            cross_attn=cfg.encoder_decoder and part == "scan")[1])
    if cfg.encoder_decoder:
        out["encoder"] = stacked(_enc_layer_init(0, cfg, "meta",
                                                 with_axes=True)[1])
        out["enc_final_norm"] = ("embed",)
    return out


def _cast_leaves(cfg) -> frozenset:
    """The leaves the forward casts to the compute dtype where it uses
    them: the embedding table (cast right after the gather, or as the
    tied unembedding), the unembedding, and each block's matmul weights
    and biases (the Mamba conv taps and biases too; the cross-attention's
    and the encoder's share the attention's and the MLP's names)."""
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
    return sum(t.numel() for t in tree_leaves(init_params(0, cfg, "meta")))


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
                 decode_pos=None, in_place=False, moe_layer=False,
                 enc_kv=None, sc: Sharder = _id_sc):
    """Returns (x, new_cache, aux).  A one-token input with a cache takes
    the recurrent blocks' decode branch (a prompt of length 1 too); longer
    inputs prefill from a zero state.  ``aux`` is an MoE layer's
    load-balance loss (0-d f32), 0.0 for any other layer.  A decoder
    layer of an encoder-decoder attends to ``enc_kv`` (its (k, v) from
    :func:`_cross_kv`) and caches them as ``cross_k`` / ``cross_v`` in the
    compute dtype; without ``enc_kv`` it reads them from the cache and
    carries them over unchanged."""
    train_mode = cache is None and decode_pos is None
    if cfg.block_type == "rwkv6":
        if cache is not None and x.shape[1] == 1:
            x, new_cache = ssm.rwkv6_block_decode(p, x, cfg, cache)
        else:
            x, new_cache = ssm.rwkv6_block_apply(p, x, cfg, sc=sc)
        return (sc(x, ("batch", "seq", None)),
                None if train_mode else new_cache, 0.0)
    h = layers.rms_norm(x, p["ln_attn"] - 1.0, cfg.norm_eps)
    if cfg.block_type == "hymba":
        mix = hymba.hymba_block_apply
    elif cfg.mla is not None:
        mix = attention.mla_apply
    else:
        mix = attention.attn_apply
    a, new_cache = mix(p["mix"], h, cfg=cfg, positions=positions,
                       window=window, cache=cache, decode_pos=decode_pos,
                       in_place=in_place, sc=sc)
    if cfg.post_block_norm:
        a = layers.rms_norm(a, p["ln_attn_post"] - 1.0, cfg.norm_eps)
    x = x + a
    x = sc(x, ("batch", "seq", None))
    if "cross" in p:
        hc = layers.rms_norm(x, p["ln_cross"] - 1.0, cfg.norm_eps)
        if enc_kv is None:
            # decode: the encoder is not run again; the cross K/V come from
            # the cache the prefill filled
            kv = (cache["cross_k"].to(x.dtype), cache["cross_v"].to(x.dtype))
        else:
            kv = enc_kv
        c, _ = attention.attn_apply(p["cross"], hc, cfg=cfg,
                                    positions=positions, window=GLOBAL_WINDOW,
                                    causal=False, kv_override=kv, sc=sc)
        x = x + c
        if not train_mode:
            if enc_kv is not None:
                cdt = new_cache["k"].dtype
                new_cache = dict(new_cache, cross_k=kv[0].to(cdt),
                                 cross_v=kv[1].to(cdt))
            else:
                new_cache = dict(new_cache, cross_k=cache["cross_k"],
                                 cross_v=cache["cross_v"])
    h2 = layers.rms_norm(x, p["ln_mlp"] - 1.0, cfg.norm_eps)
    aux = 0.0
    if moe_layer:
        moe_fn = moe.moe_apply_ep if cfg.moe_ep else moe.moe_apply
        f, moe_aux = moe_fn(p["ffn"], h2, cfg, sc=sc)
        aux = moe_aux["load_balance_loss"]
    else:
        f = layers.mlp_apply(p["ffn"], h2, cfg, sc=sc)
    if cfg.post_block_norm:
        f = layers.rms_norm(f, p["ln_mlp_post"] - 1.0, cfg.norm_eps)
    x = x + f
    return sc(x, ("batch", "seq", None)), \
        None if train_mode else new_cache, aux


#: The ops whose outputs "dots" saves: the products without batch dims
#: (``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``).
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots():
    from torch.utils.checkpoint import (CheckpointPolicy,
                                        create_selective_checkpoint_contexts)

    def policy(ctx, op, *args, **kwargs):
        return CheckpointPolicy.MUST_SAVE if op in _DOTS \
            else CheckpointPolicy.PREFER_RECOMPUTE
    return create_selective_checkpoint_contexts(policy)


def _remat(fn, cfg, *args):
    """``fn(*args)`` under the config's rematerialisation policy — the
    JAX package's ``_remat_policy`` around its scan bodies — when autograd
    records (grad mode on and a tensor of ``args`` that requires grad):
    "full" keeps only the inputs and recomputes the rest in the backward,
    "dots" keeps the matmul outputs too (:data:`_DOTS`), "none" keeps
    everything (no checkpoint).  A serving call runs ``fn`` as it is."""
    if cfg.remat == "none" or not torch.is_grad_enabled() or not any(
            t.requires_grad for t in tree_leaves(args)):
        return fn(*args)
    if cfg.remat == "dots":
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=_save_dots)
    if cfg.remat != "full":
        raise ValueError(f"{cfg.name}: remat {cfg.remat!r} is not one of "
                         f"full, dots, none")
    return checkpoint(fn, *args, use_reentrant=False)


# ---------------------------------------------------------------------------
# Whisper encoder
# ---------------------------------------------------------------------------

def _sinusoids(f: int, d: int, device) -> torch.Tensor:
    """(f, d) f32 position encoding: sines then cosines of position x
    10000^(-i / (d/2)), i < d/2."""
    half = d // 2
    f32 = torch.float32
    pos = torch.arange(f, dtype=f32, device=device)
    # the log in f32, as the JAX package takes it (made on the device: a
    # CUDA graph's capture allows no host-to-device copy)
    freqs = torch.exp(-torch.log(torch.full((), 10000.0, dtype=f32,
                                            device=device))
                      * torch.arange(half, dtype=f32, device=device) / half)
    return torch.cat([torch.sin(pos[:, None] * freqs),
                      torch.cos(pos[:, None] * freqs)], dim=-1)


def _encode_audio(params, frames: torch.Tensor, cfg,
                  sc: Sharder = _id_sc) -> torch.Tensor:
    """frames (B, F, d): precomputed frame embeddings (the conv front end
    is a stub, as in the JAX package).  Sinusoidal positions are added,
    then each encoder layer runs non-causal self-attention with RoPE and
    an MLP, and ``enc_final_norm`` closes the stack."""
    _, f, d = frames.shape
    x = frames + _sinusoids(f, d, frames.device).to(frames.dtype)
    positions = torch.arange(f, dtype=torch.int32, device=frames.device)

    def layer(p_l, x):
        h = layers.rms_norm(x, p_l["ln_attn"] - 1.0, cfg.norm_eps)
        a, _ = attention.attn_apply(p_l["mix"], h, cfg=cfg,
                                    positions=positions, window=GLOBAL_WINDOW,
                                    causal=False, sc=sc)
        x = x + a
        h2 = layers.rms_norm(x, p_l["ln_mlp"] - 1.0, cfg.norm_eps)
        return sc(x + layers.mlp_apply(p_l["ffn"], h2, cfg, sc=sc),
                  ("batch", "seq", None))

    for p_l in _unstack(params["encoder"], cfg.enc_layers):
        x = _remat(layer, cfg, p_l, x)
    return layers.rms_norm(x, params["enc_final_norm"] - 1.0, cfg.norm_eps)


def _cross_kv(params, enc_out: torch.Tensor, cfg) -> tuple:
    """Each decoder layer's cross-attention (k, v) from the encoder output
    (no bias): two (L, B, F, KH, D) tensors in ``enc_out``'s dtype."""
    b, f, _ = enc_out.shape
    cross = params["layers"]["cross"]
    ks, vs = [], []
    for i in range(cross["wk"].shape[0]):
        ks.append(layers.split_heads(
            layers.mm(enc_out, cross["wk"][i].to(enc_out.dtype)),
            cfg.num_kv_heads, cfg.head_dim))
        vs.append(layers.split_heads(
            layers.mm(enc_out, cross["wv"][i].to(enc_out.dtype)),
            cfg.num_kv_heads, cfg.head_dim))
    return torch.stack(ks), torch.stack(vs)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _embed(params, tokens: torch.Tensor, cfg, vision_embeds):
    """The token embeddings, with phi-3-vision's patch embeddings in place
    of the leading ``vision_embeds.shape[1]`` positions."""
    x = layers.embed_apply(params["embed"], tokens, cfg)
    if cfg.vision_tokens and vision_embeds is not None:
        nv, s = vision_embeds.shape[1], tokens.shape[1]
        if s < nv:
            raise ValueError(
                f"{cfg.name}: a prompt of {s} tokens is shorter than its "
                f"{nv} vision tokens; the patch embeddings fill the leading "
                f"{nv} positions")
        x = torch.cat([vision_embeds.to(x.dtype), x[:, nv:]], dim=1)
    return x


def forward(params, tokens: torch.Tensor, cfg, *, cache=None,
            decode_pos=None, in_place: bool = False, audio_frames=None,
            vision_embeds=None, sc: Sharder = _id_sc):
    """tokens (B, S) -> (hidden (B, S, d), new_cache).  ``decode_pos``:
    an int or a 0-d integer tensor (a CUDA graph's step reads it on the
    device).  The new cache is stacked from the layers' new leaves (the
    JAX package's functional update) or, with ``in_place``, written into
    ``cache``'s own tensors — the KV rows in place, every other leaf
    copied once over its layer's slice — and ``cache`` is returned: the
    counterpart of the JAX serve step's donated cache, for a step that
    owns its cache.  (The JAX package's third output, the MoE auxiliary
    loss, is what training reads: :func:`lm_loss` takes it from
    :func:`_forward`; the serving path drops it.)

    ``vision_embeds`` (B, NV, d): patch embeddings that replace the first
    NV token embeddings (a prompt shorter than NV raises); without them a
    vision config runs as a text model, as in the JAX package.
    ``audio_frames`` (B, F, d): an encoder-decoder runs its encoder on
    them and its decoder attends to their cross K/V; without them it reads
    the cross K/V from ``cache``, and with no cache either it raises.  The
    encoder runs exactly when ``audio_frames`` is given — a one-token
    prefill too (the JAX package decides by the prompt's length and a
    one-token prefill skips it: ROADMAP C.r7)."""
    x, new_cache, _ = _forward(params, tokens, cfg, cache=cache,
                               decode_pos=decode_pos, in_place=in_place,
                               audio_frames=audio_frames,
                               vision_embeds=vision_embeds, sc=sc)
    return x, new_cache


def _forward(params, tokens: torch.Tensor, cfg, *, cache=None,
             decode_pos=None, in_place: bool = False, audio_frames=None,
             vision_embeds=None, sc: Sharder = _id_sc):
    """:func:`forward`, and the sum of the MoE layers' load-balance losses
    (0-d f32; 0.0 for an arch without MoE): (hidden, new_cache, aux)."""
    _check_block(cfg)
    if in_place and cache is None:
        raise ValueError("an in-place step needs the cache it writes")
    s = tokens.shape[1]
    x = sc(_embed(params, tokens, cfg, vision_embeds), ("batch", "seq", None))
    positions = torch.arange(s, dtype=torch.int32, device=tokens.device)
    if decode_pos is not None:
        positions = positions + decode_pos
    enc_kv = None
    if cfg.encoder_decoder:
        if audio_frames is not None:
            ks, vs = _cross_kv(params, _encode_audio(
                params, audio_frames.to(x.dtype), cfg, sc), cfg)
            enc_kv = list(zip(ks.unbind(0), vs.unbind(0)))
        elif cache is None:
            raise ValueError(f"{cfg.name} is an encoder-decoder: a forward "
                             f"needs audio_frames, or a cache holding the "
                             f"cross K/V of a prefill")
    train_mode = cache is None and decode_pos is None
    stacked, aux = {}, 0.0
    for part, key, first, n, moe_layer in _stacks(cfg):
        per_layer = []
        for i, p_l in enumerate(_unstack(params[key], n)):
            c_l = None if cache is None else \
                tree_map(lambda v: v[i], cache[part])
            kw = dict(cfg=cfg, positions=positions,
                      window=cfg.window_for_layer(first + i), cache=c_l,
                      decode_pos=decode_pos, in_place=in_place,
                      moe_layer=moe_layer, sc=sc,
                      enc_kv=None if enc_kv is None else enc_kv[i])
            if train_mode and part == "scan":
                # the uniform stack: the JAX package's checkpointed scan
                # body
                x, nc, a = _remat(
                    lambda p_, x_, kw=kw: _apply_layer(p_, x_, **kw), cfg,
                    p_l, x)
            else:
                x, nc, a = _apply_layer(p_l, x, **kw)
            aux = aux + a
            if in_place:
                copy_cache(c_l, nc)
            else:
                per_layer.append(nc)
        stacked[part] = per_layer
    x = layers.rms_norm(x, params["final_norm"] - 1.0, cfg.norm_eps)
    if in_place:
        return x, cache, aux
    new_cache = None
    if cache is not None or decode_pos is not None:
        new_cache = {st[0]: _tree_stack(stacked[st[0]])
                     for st in reversed(_stacks(cfg))}
    return x, new_cache, aux


class _ShardedLogSumExp(torch.autograd.Function):
    """logsumexp over a last dim sharded over ``groups``: the max and the
    sum of exponentials all-reduced, no logits gathered; the backward is
    the local slice of the softmax."""

    @staticmethod
    def forward(ctx, x, groups):
        import torch.distributed as dist
        m = x.amax(dim=-1)
        for g in groups:
            dist.all_reduce(m, op=dist.ReduceOp.MAX, group=g)
        s = torch.exp(x - m[..., None]).sum(dim=-1)
        for g in groups:
            dist.all_reduce(s, op=dist.ReduceOp.SUM, group=g)
        lse = m + torch.log(s)
        ctx.save_for_backward(x, lse)
        return lse

    @staticmethod
    def backward(ctx, g):
        x, lse = ctx.saved_tensors
        return g[..., None] * torch.exp(x - lse[..., None]), None


def _lse_and_label_logits(logits: torch.Tensor, tc: torch.Tensor) -> tuple:
    """Each row's logsumexp and its logit at its label.  Logits sharded
    over the vocabulary (DTensors) stay sharded, as in Megatron's
    vocab-parallel cross-entropy: each rank reduces its own shard and
    picks the labels that fall in it (a zero elsewhere), and small
    all-reduces over the vocabulary's mesh axes join the rows' maxima,
    sums of exponentials and picked logits — where DTensor would gather
    the chunk's whole logits for both."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.parallel.sharding import shard_range, sum_over_group
    last = logits.ndim - 1
    vocab = [] if not isinstance(logits, DTensor) else [
        i for i, pl in enumerate(logits.placements)
        if isinstance(pl, Shard) and pl.dim == last]
    if not vocab:
        return (torch.logsumexp(logits, dim=-1),
                logits.gather(-1, tc.clamp(min=0).long()[..., None])[..., 0])
    mesh = logits.device_mesh
    rows = [Replicate() if i in vocab else pl
            for i, pl in enumerate(logits.placements)]
    local = logits.to_local(grad_placements=logits.placements)
    groups = [mesh.get_group(i) for i in vocab]
    lse = _ShardedLogSumExp.apply(local, groups)
    lo, n = shard_range(mesh, vocab, logits.shape[-1])
    idx = tc.redistribute(mesh, rows).to_local().clamp(min=0).long() - lo
    miss = (idx < 0) | (idx >= n)
    ll = local.gather(-1, idx.masked_fill(miss, 0)[..., None])[..., 0] \
        .masked_fill(miss, 0)
    for g in groups:
        ll = sum_over_group(ll, g)
    return tuple(DTensor.from_local(t, mesh, rows, run_check=False)
                 for t in (lse, ll))


def _xent_chunk(hc: torch.Tensor, tc: torch.Tensor, w: torch.Tensor, cfg,
                sc: Sharder = _id_sc):
    """One chunk's summed cross-entropy and its count of labels: f32
    logits of ``hc`` against the unembedding ``w``, softcapped where the
    config says; labels below 0 are left out."""
    logits = layers.mm(hc.float(), w.float())
    logits = sc(logits, ("batch", None, "vocab"))
    if cfg.final_logit_softcap:
        logits = cfg.final_logit_softcap * torch.tanh(
            logits / cfg.final_logit_softcap)
    lse, ll = _lse_and_label_logits(logits, tc)
    valid = tc >= 0
    loss = torch.where(valid, lse - ll, 0.0)
    return loss.sum(), valid.sum()


def lm_loss(params, batch: dict, cfg, *, sc: Sharder = _id_sc) -> torch.Tensor:
    """Mean next-token cross-entropy of ``batch`` (``tokens`` and
    ``labels`` (B, S), a label of -1 left out; a vision config's
    ``vision_embeds``, an encoder-decoder's ``audio_frames``): the logits
    materialized one sequence chunk of ``cfg.xent_chunk`` at a time, in
    f32, each chunk under the remat policy; plus 0.01 x the summed MoE
    load-balance loss for an MoE config.  A 0-d f32 tensor."""
    h, _, aux = _forward(params, batch["tokens"], cfg,
                         vision_embeds=batch.get("vision_embeds"),
                         audio_frames=batch.get("audio_frames"), sc=sc)
    w = layers.unembed_matrix(params["embed"], cfg)
    targets = batch["labels"]
    s = h.shape[1]
    chunk = min(cfg.xent_chunk, s)
    pad = (-s) % chunk
    if pad:
        h = F.pad(h, (0, 0, 0, pad))
        targets = F.pad(targets, (0, pad), value=-1)
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    n = torch.zeros((), dtype=torch.int64, device=h.device)
    for c0 in range(0, s + pad, chunk):
        l_c, n_c = _remat(lambda hc, tc, w_: _xent_chunk(hc, tc, w_, cfg, sc),
                          cfg, h[:, c0:c0 + chunk], targets[:, c0:c0 + chunk],
                          w)
        tot, n = tot + l_c, n + n_c
    loss = tot / torch.clamp(n, min=1)
    if cfg.moe is not None:
        loss = loss + 0.01 * aux
    return loss


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
        out = dict(k=kv, v=kv)
        if cfg.encoder_decoder:
            # cross-attention K/V: written by the prefill, then read only
            cross = ((bsz, cfg.enc_frames, cfg.num_kv_heads, cfg.head_dim),
                     cdt)
            out.update(cross_k=cross, cross_v=cross)
        return out
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
    return {part: tree_map(lambda sd: ((n,) + sd[0], sd[1]), one)
            for part, _, _, n, _ in reversed(_stacks(cfg))}


def _layer_cache_axes(cfg) -> dict:
    """Logical axes of ONE layer's cache (the leaves of
    :func:`_layer_cache_spec`)."""
    _check_block(cfg)
    kv = ("batch", "cache_seq", "kv_heads", None)
    if cfg.block_type == "attn":
        if cfg.mla is not None:
            return dict(c=("batch", "cache_seq", None),
                        kr=("batch", "cache_seq", None))
        out = dict(k=kv, v=kv)
        if cfg.encoder_decoder:
            cross = ("batch", None, "kv_heads", None)
            out.update(cross_k=cross, cross_v=cross)
        return out
    if cfg.block_type == "rwkv6":
        out = dict(shift_att=("batch", None), shift_ffn=("batch", None),
                   wkv=("batch", "heads", None, None))
    else:
        out = dict(attn=dict(k=kv, v=kv), conv=("batch", None, "ff"),
                   ssm=("batch", "ff", None))
    if cfg.mnf.enabled:
        out["events"] = ()                       # a scalar: replicated
    return out


def cache_axes(cfg) -> dict:
    """Logical axes of the full decode cache (:func:`cache_specs`' keys),
    each leaf with ``"layers"`` first."""
    one = tree_map(lambda ax: ("layers",) + ax, _layer_cache_axes(cfg))
    return {part: one for part, _, _, _, _ in reversed(_stacks(cfg))}


def init_cache(cfg, bsz: int, max_len: int, device=None) -> dict:
    dev = _device(device)
    return tree_map(lambda sd: torch.zeros(sd[0], dtype=sd[1], device=dev),
                     cache_specs(cfg, bsz, max_len))


def unembed_logits(params, h: torch.Tensor, cfg) -> torch.Tensor:
    """f32 logits of hidden states ``h`` (B, S, d), taken in f32 against
    the compute-dtype unembedding's values, softcapped where the config
    says (``cfg.final_logit_softcap``)."""
    w = layers.unembed_matrix(params["embed"], cfg)
    logits = layers.mm(h.float(), w.float())
    if cfg.final_logit_softcap:
        logits = cfg.final_logit_softcap * torch.tanh(
            logits / cfg.final_logit_softcap)
    return logits


def decode_step(params, cache, tokens: torch.Tensor, decode_pos, cfg, *,
                in_place: bool = False, sc: Sharder = _id_sc):
    """One new token per sequence against a filled cache.  tokens (B, 1);
    ``decode_pos`` an int or a 0-d integer tensor; ``in_place`` as in
    :func:`forward`.  Returns (logits (B, 1, V) f32, new_cache).  It
    takes no ``audio_frames`` (the JAX package's accepts them and ignores
    them): an encoder-decoder's step reads the cross K/V that the prefill
    left in the cache, and never runs the encoder."""
    h, new_cache = forward(params, tokens, cfg, cache=cache,
                           decode_pos=decode_pos, in_place=in_place, sc=sc)
    return unembed_logits(params, h, cfg), new_cache


def prefill(params, tokens: torch.Tensor, cfg, *, max_len: int | None = None,
            audio_frames=None, vision_embeds=None, sc: Sharder = _id_sc,
            cache=None):
    """Run the prompt; returns (last-position logits (B, 1, V), filled
    cache).  An encoder-decoder needs ``audio_frames`` (B, F, d): its
    encoder runs here, once, and the cache keeps each layer's cross K/V;
    a vision config takes ``vision_embeds`` (B, NV, d) for its leading
    positions.  ``cache``: the zero cache to fill (one ``max_len`` long is
    made when None; a sharded step passes one under its placements)."""
    bsz, s = tokens.shape
    if cfg.encoder_decoder and audio_frames is None:
        raise ValueError(f"{cfg.name} is an encoder-decoder: its prefill "
                         f"needs audio_frames")
    if cache is None:
        cache = init_cache(cfg, bsz, max_len or s, tokens.device)
    h, new_cache = forward(params, tokens, cfg, cache=cache, decode_pos=0,
                           audio_frames=audio_frames,
                           vision_embeds=vision_embeds, sc=sc)
    return unembed_logits(params, h[:, -1:], cfg), new_cache


def input_specs(cfg, shape) -> dict:
    """(shape, dtype) of every model input of a cell (``shape`` a
    ``ShapeConfig``): ``tokens`` (and ``labels`` to train) — int64, torch's
    index dtype, where the JAX package's are int32 — and, as there, a
    vision config's ``vision_embeds`` and an encoder-decoder's
    ``audio_frames`` (not in a decode step, which serves off the cross K/V
    its prefill cached), each in the compute dtype."""
    b, s = shape.global_batch, shape.seq_len
    cdt = layers.dtype_of(cfg.compute_dtype)
    tok = torch.int64
    if shape.kind == "train":
        out = dict(tokens=((b, s), tok), labels=((b, s), tok))
    elif shape.kind == "prefill":
        out = dict(tokens=((b, s), tok))
    else:                      # decode: one new token against an s-long cache
        out = dict(tokens=((b, 1), tok))
    if cfg.vision_tokens:
        out["vision_embeds"] = ((b, cfg.vision_tokens, cfg.d_model), cdt)
    if cfg.encoder_decoder and shape.kind != "decode":
        out["audio_frames"] = ((b, cfg.enc_frames, cfg.d_model), cdt)
    return out
