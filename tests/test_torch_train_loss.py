"""The port's training loss against the JAX package's, on the CPU: the
same numpy inputs, and the JAX package's own weights carried across by
``params_from_numpy``, go through ``transformer.lm_loss`` and its
gradients in both packages, for every architecture of ``ARCH_IDS``
reduced as ``tests/test_archs_smoke.py`` reduces it (batch 2, 32 tokens,
a few labels of -1 left out):

- at an f32 compute dtype the loss and every gradient leaf lie within
  1e-4 of max|JAX|;
- in the configs' own bf16 the loss lies within 3e-2 of JAX's bf16 loss
  (or, where JAX's own bf16 loss lies further from its f32 one, within
  that gap), as ``tests/test_torch_lm_stack.py`` holds the bf16 serve;
- the MoE auxiliary loss the forward sums (``transformer._forward``)
  equals the JAX forward's third output within 1e-6 of it;
- inside the port, the remat policies "full", "dots" and "none" give the
  same loss and gradients bitwise.

The JAX side of each arch is computed once.  This file holds the first
five archs of the registry; ``tests/test_torch_train_loss_more.py`` the
other five.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import get_config as jget_config
from repro.models import transformer as jtfm
from repro_torch.configs import get_config
from repro_torch.models import transformer as ttfm
from repro_torch.models.param_utils import tree_leaves, tree_map

ARCHS = ARCH_IDS[:5]
B, S = 2, 32


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _batch(cfg, seed=0) -> dict:
    """Tokens and labels (three labels of -1), and a vision config's patch
    embeddings or an encoder-decoder's audio frames (normal x 0.02), as
    numpy arrays in the compute dtype's f32 values."""
    rng = np.random.default_rng(seed)
    out = dict(
        tokens=rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
        labels=rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32))
    out["labels"][0, :3] = -1
    if cfg.vision_tokens:
        out["vision_embeds"] = (rng.standard_normal(
            (B, cfg.vision_tokens, cfg.d_model)) * 0.02).astype(np.float32)
    if cfg.encoder_decoder:
        out["audio_frames"] = (rng.standard_normal(
            (B, cfg.enc_frames, cfg.d_model)) * 0.02).astype(np.float32)
    return out


def _jax_batch(batch, cfg):
    cdt = jnp.dtype(cfg.compute_dtype)
    return {k: jnp.asarray(v) if v.dtype == np.int32
            else jnp.asarray(v).astype(cdt) for k, v in batch.items()}


def _torch_batch(batch, cfg):
    from repro_torch.models.layers import dtype_of
    cdt = dtype_of(cfg.compute_dtype)
    return {k: torch.from_numpy(v) if v.dtype == np.int32
            else torch.from_numpy(v).to(cdt) for k, v in batch.items()}


def cfg_pair(arch, compute_dtype, **kw):
    return (jget_config(arch).reduced(compute_dtype=compute_dtype, **kw),
            get_config(arch).reduced(compute_dtype=compute_dtype, **kw))


@functools.lru_cache(maxsize=None)
def jax_side(arch):
    """The JAX package's params (numpy), the batch, and its f32 loss and
    gradients, bf16 loss, and f32 forward aux."""
    jc32, _ = cfg_pair(arch, "float32")
    jc16, _ = cfg_pair(arch, "bfloat16")
    params, _ = jtfm.init_params(jax.random.PRNGKey(0), jc32)
    params = jax.tree.map(np.array, params)
    batch = _batch(jc32)
    loss32, grads = jax.jit(jax.value_and_grad(
        lambda p, b: jtfm.lm_loss(p, b, jc32)))(params,
                                                 _jax_batch(batch, jc32))
    loss16 = jax.jit(lambda p, b: jtfm.lm_loss(p, b, jc16))(
        params, _jax_batch(batch, jc16))
    aux = None
    if jc32.moe is not None:
        aux = float(jax.jit(lambda p, t: jtfm.forward(p, t, jc32)[2])(
            params, batch["tokens"]))
    return (params, batch, float(loss32), jax.tree.map(np.array, grads),
            float(loss16), aux)


def port_loss_and_grads(arch, compute_dtype, **kw):
    """The port's loss and gradient tree on JAX's params and batch."""
    params, batch = jax_side(arch)[:2]
    _, tc = cfg_pair(arch, compute_dtype, **kw)
    tp = tree_map(lambda t: t.requires_grad_(),
                  ttfm.params_from_numpy(params, tc, "cpu"))
    loss = ttfm.lm_loss(tp, _torch_batch(batch, tc), tc)
    grads = iter(torch.autograd.grad(loss, tree_leaves(tp),
                                     allow_unused=True))
    return loss.detach(), tree_map(
        lambda p: torch.zeros_like(p) if (g := next(grads)) is None else g,
        tp)


def _flat(tree, path=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _flat(v, f"{path}{k}/")
        else:
            yield f"{path}{k}", v


def check_f32(arch):
    _, _, jloss, jgrads, _, _ = jax_side(arch)
    loss, grads = port_loss_and_grads(arch, "float32")
    assert torch.isfinite(loss)
    worst = {"loss": _rel(float(loss), jloss)}
    tflat, jflat = dict(_flat(grads)), dict(_flat(jgrads))
    assert set(tflat) == set(jflat)
    for name, g in tflat.items():
        assert tuple(g.shape) == jflat[name].shape, name
        worst[name] = _rel(g.numpy(), jflat[name])
    bad = {k: v for k, v in worst.items() if v > 1e-4}
    assert not bad, bad


def check_bf16(arch):
    _, _, jloss32, _, jloss16, _ = jax_side(arch)
    loss, _ = port_loss_and_grads(arch, "bfloat16")
    own = abs(jloss16 - jloss32) / abs(jloss32)
    assert _rel(float(loss), jloss16) <= max(3e-2, own), \
        (float(loss), jloss16, jloss32)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_grads_match_jax_f32(arch):
    check_f32(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_matches_jax_bf16(arch):
    check_bf16(arch)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "rwkv6-7b"])
@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_policies_agree_bitwise(arch, remat):
    """``_remat``: each policy recomputes (or saves) the same values, so
    the loss and every gradient leaf equal those of remat "none"."""
    want_loss, want = port_loss_and_grads(arch, "float32", remat="none")
    loss, grads = port_loss_and_grads(arch, "float32", remat=remat)
    assert torch.equal(loss, want_loss)
    for (name, g), (_, w) in zip(_flat(grads), _flat(want)):
        assert torch.equal(g, w), name


def test_forward_keeps_its_serving_signature():
    """``forward`` returns (hidden, cache) as the serving path reads it;
    ``_forward`` adds the aux, 0.0 for an arch without MoE."""
    _, tc = cfg_pair("qwen2-0.5b", "float32")
    params = ttfm.init_params(0, tc, "cpu")
    toks = torch.zeros((1, 4), dtype=torch.int64)
    out = ttfm.forward(params, toks, tc)
    assert len(out) == 2 and out[1] is None
    h, cache, aux = ttfm._forward(params, toks, tc)
    assert aux == 0.0 and torch.equal(h, out[0])
    with pytest.raises(ValueError, match="remat"):
        ttfm.lm_loss(tree_map(lambda t: t.requires_grad_(), params),
                     dict(tokens=toks, labels=toks),
                     dataclasses.replace(tc, remat="some"))
