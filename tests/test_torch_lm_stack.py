"""The port's attention decoder stack against ``repro`` on the CPU: QKV
biases (Qwen2), Gemma-2's softcaps, alternating windows, post-block norms
and tied 256k-style vocabulary, the squared-ReLU FFN (Minitron), MLA and
the sort-dispatched MoE (DeepSeek).  The same numpy inputs, and the JAX
package's own weights carried across by ``params_from_numpy``, go
through both packages:

- each of the six reduced configs: a 12-token prefill and 4
  teacher-forced decode steps, logits and every cache leaf within 1e-4 of
  max|JAX| at an f32 compute dtype, and in the configs' own bf16 within
  3e-2 (or, at a step where the JAX package's own bf16 run lies further
  from its f32 run, that far), as ``tests/test_torch_hymba.py``; the QKV
  biases and the norm gains are set to seeded non-zero values in the
  numpy tree (the JAX init makes them zeros and ones);
- ``moe.moe_apply`` alone: y within 1e-5 of max|JAX| and the load-balance
  loss within 1e-6, the selected experts equal (the smallest top-k margin
  printed), the dropped assignments and ``drop_fraction`` exact (JAX's
  within its f32 mean's rounding) — also where the capacity binds
  (capacity factor 0.5, one dispatch group);
- ``attention.mla_apply`` expanded (no cache) and absorbed (a cache, the
  prefill and a decode step), and ``attn_apply`` with biases, softcap and
  a binding window, against JAX;
- inside the port: at θ = 0 the gated serve is bitwise the ungated one;
  ``init_compute_params`` is bitwise ``compute_params(init_params(...))``;
  ``count_params`` and ``active_params`` equal JAX's for the six full
  configs; whisper-base and phi-3-vision raise naming ROADMAP item 12b,
  ``moe_ep`` item 13; ``python -m repro_torch.launch.serve --arch <each>
  --reduced --device cpu`` prints its stats.
"""
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import attention as jattn
from repro.models import moe as jmoe
from repro.models import transformer as jtfm
from repro_torch.configs import NOT_YET_PORTED, get_config
from repro_torch.launch import serve
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttfm

ARCHS = ("qwen2-0.5b", "qwen2-1.5b", "minitron-8b", "gemma2-27b",
         "deepseek-moe-16b", "deepseek-v2-lite-16b")
PROMPT, STEPS, B = 12, 4, 2


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _cfg_pair(arch, **overrides):
    return (jget_config(arch).reduced(**overrides),
            get_config(arch).reduced(**overrides))


def _leaves(tree, path=""):
    """(path, leaf) of a nested dict, in key order."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, f"{path}{k}/")
        else:
            yield f"{path}{k}", v


def _perturb(tree, names, r_, scale):
    """Add seeded noise to every leaf named in ``names``, in place."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _perturb(v, names, r_, scale)
        elif k in names:
            tree[k] = (v + scale * r_.normal(size=v.shape)).astype(v.dtype)


@functools.lru_cache(maxsize=None)
def _jax_params(arch, seed=0):
    """The JAX package's reduced weights as numpy, with seeded non-zero
    QKV biases and norm gains off 1 (the init leaves them zeros and
    ones, which would leave the bias adds and the ``- 1.0`` offsets
    unexercised)."""
    cfg = jget_config(arch).reduced()
    tree = jax.tree.map(np.array, jtfm.init_params(jax.random.PRNGKey(seed),
                                                   cfg)[0])
    r_ = np.random.default_rng(seed)
    _perturb(tree, ("bq", "bk", "bv"), r_, 0.5)
    _perturb(tree, ("ln_attn", "ln_mlp", "ln_attn_post", "ln_mlp_post",
                    "final_norm"), r_, 0.1)
    return tree


@functools.lru_cache(maxsize=None)
def _run_both(arch, compute_dtype):
    """JAX's and the port's prefill (step 0) and teacher-forced decode
    steps: a list of (logits, cache) per package."""
    tree = _jax_params(arch)
    jcfg, tcfg = _cfg_pair(arch, compute_dtype=compute_dtype)
    r_ = np.random.default_rng(7)
    prompt = r_.integers(0, tcfg.vocab_size, (B, PROMPT)).astype(np.int32)
    teach = r_.integers(0, tcfg.vocab_size, (B, STEPS)).astype(np.int32)
    max_len = PROMPT + STEPS

    jparams = jax.tree.map(jnp.asarray, tree)
    jl, jc = jax.jit(functools.partial(jtfm.prefill, cfg=jcfg,
                                       max_len=max_len))(
        jparams, jnp.asarray(prompt))
    jsteps = [(np.asarray(jl), jax.tree.map(np.asarray, jc))]
    dstep = jax.jit(functools.partial(jtfm.decode_step, cfg=jcfg))
    for i in range(STEPS):
        jl, jc = dstep(jparams, jc, jnp.asarray(teach[:, i:i + 1]),
                       jnp.asarray(PROMPT + i, jnp.int32))
        jsteps.append((np.asarray(jl), jax.tree.map(np.asarray, jc)))

    tparams = ttfm.compute_params(
        ttfm.params_from_numpy(tree, tcfg, "cpu"), tcfg)
    tl, tc = ttfm.prefill(tparams, torch.from_numpy(prompt).long(), tcfg,
                          max_len=max_len)
    tsteps = [(tl, tc)]
    for i in range(STEPS):
        tl, tc = ttfm.decode_step(tparams, tc,
                                  torch.from_numpy(teach[:, i:i + 1]).long(),
                                  PROMPT + i, tcfg)
        tsteps.append((tl, tc))
    return jsteps, tsteps


def _worst_per_step(steps_a, steps_b):
    """Per step, the largest relative gap of the logits and of any cache
    leaf of run a from run b."""
    out = []
    for (al, ac), (bl, bc) in zip(steps_a, steps_b):
        bleaves = dict(_leaves(bc))
        out.append(max([_rel(np.asarray(al, np.float32), bl)] + [
            _rel(np.asarray(v, np.float32), bleaves[k])
            for k, v in _leaves(ac)]))
    return out


def _compare(arch, compute_dtype, tol):
    """Prefill (step 0) and each decode step: logits and every cache leaf
    within ``tol`` (a number, or one per step) of max|JAX|, with JAX's
    cache structure, shapes and dtypes."""
    jsteps, tsteps = _run_both(arch, compute_dtype)
    tols = tol if isinstance(tol, list) else [tol] * len(jsteps)
    worst = {}
    for i, ((jl, jc), (tl, tc)) in enumerate(zip(jsteps, tsteps)):
        assert tuple(tl.shape) == jl.shape and torch.isfinite(tl).all()
        tleaves, jleaves = dict(_leaves(tc)), dict(_leaves(jc))
        assert set(tleaves) == set(jleaves)
        worst[(i, "logits")] = _rel(tl.float().numpy(), jl)
        for name, leaf in tleaves.items():
            want = jleaves[name]
            assert tuple(leaf.shape) == want.shape, name
            assert str(leaf.dtype).split(".")[-1] == str(want.dtype), name
            worst[(i, name)] = _rel(leaf.float().numpy(),
                                    want.astype(np.float32))
    bad = {k: v for k, v in worst.items() if v > tols[k[0]]}
    assert not bad, bad
    return worst


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_prefill_and_decode_match_jax_f32(arch):
    """f32 compute: the prefill (12 tokens: gemma2's window of 8 binds in
    its local layer 0; DeepSeek-V2's MLA prefill takes the absorbed form
    against its cache, as JAX's does), then 4 decode steps; every leaf
    within 1e-4 of max|JAX|."""
    _compare(arch, "float32", 1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_prefill_and_decode_match_jax_bf16(arch):
    """The configs' own bf16 compute.  Both packages round every matmul
    output, norm and activation to bf16, but not at the same places (XLA's
    CPU backend computes fused bf16 chains in f32 and rounds once), so
    values land a bf16 step or a few apart.  At each step every leaf and
    the logits lie within 3e-2 of max|JAX bf16|, or, at a step where
    JAX's own bf16 run lies further from its f32 run, within that noise.
    The f32 test holds the algorithm at 1e-4."""
    jb, _ = _run_both(arch, "bfloat16")
    jf, _ = _run_both(arch, "float32")
    own = _worst_per_step(
        [(j[0].astype(np.float32), jax.tree.map(
            lambda a: a.astype(np.float32), j[1])) for j in jb], jf)
    worst = _compare(arch, "bfloat16", [max(3e-2, o) for o in own])
    assert max(worst.values()) > 0    # the packages round differently


def test_reduced_gemma2_window_binds_and_alternates():
    """The reduced Gemma-2's windows alternate (8, global) and the local
    one binds at the 12-token prompt: the same prefill with every window
    global gives other logits."""
    cfg = get_config("gemma2-27b").reduced(compute_dtype="float32")
    assert [cfg.window_for_layer(i) for i in range(2)] == [8, 1 << 30]
    params = ttfm.compute_params(ttfm.params_from_numpy(
        _jax_params("gemma2-27b"), cfg, "cpu"), cfg)
    prompt = serve.make_prompts(cfg, B, PROMPT, 0, "cpu")
    local, _ = ttfm.prefill(params, prompt, cfg)
    wide, _ = ttfm.prefill(params, prompt, dataclasses.replace(
        cfg, sliding_window=PROMPT))
    assert not torch.equal(local, wide)


# ---------------------------------------------------------------------------
# Modules against JAX
# ---------------------------------------------------------------------------

def _np_tree(tree):
    return jax.tree.map(np.array, tree)


def _to_torch(tree):
    return {k: _to_torch(v) if isinstance(v, dict) else torch.from_numpy(v)
            for k, v in tree.items()}


MOE_CASES = {
    "default": dict(),
    "capacity_binds": dict(capacity_factor=0.5),
    "renormalize": dict(router_renormalize=True),
}


def _dropped(experts, k, cap, groups):
    """The (token, j) assignments past capacity, as the sort dispatch
    decides them from the selected experts (T, k): per group, a stable
    sort by expert and the rank within an expert."""
    t = experts.shape[0]
    tg = t // groups
    out = set()
    for gi in range(groups):
        flat = experts[gi * tg:(gi + 1) * tg].reshape(-1)
        order = np.argsort(flat, kind="stable")
        seen = {}
        for pos in order:
            e = int(flat[pos])
            if seen.get(e, 0) >= cap:
                out.add((gi * tg + pos // k, pos % k))
            seen[e] = seen.get(e, 0) + 1
    return out


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_apply_matches_jax(case):
    """y within 1e-5 of max|JAX|, the load-balance loss within 1e-6, the
    same experts selected, the same assignments dropped and
    ``drop_fraction`` their share (JAX's within 1e-6: its f32 mean
    rounds).  "capacity_binds" runs one dispatch group
    of 24 tokens at capacity factor 0.5 (8 slots an expert for 48
    assignments over 4 experts); the default runs JAX's 32-group setting
    (24 groups of one token here)."""
    over = MOE_CASES[case]
    groups = 1 if case == "capacity_binds" else 32
    jcfg, tcfg = (dataclasses.replace(
        c, compute_dtype="float32", moe_dispatch_groups=groups,
        moe=dataclasses.replace(c.moe, **over))
        for c in _cfg_pair("deepseek-v2-lite-16b"))
    p = _np_tree(jmoe.moe_init(jax.random.PRNGKey(3), jcfg)[0])
    x = np.random.default_rng(5).normal(size=(2, 12, 64)).astype(np.float32)

    jy, jaux = jax.jit(functools.partial(jmoe.moe_apply, cfg=jcfg))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    ty, taux = tmoe.moe_apply(_to_torch(p), torch.from_numpy(x), tcfg)

    # the router's fire decisions: JAX's top_k and the port's
    k = tcfg.moe.top_k
    jprobs = jax.nn.softmax(jnp.asarray(x.reshape(-1, 64))
                            @ jnp.asarray(p["router"]), axis=-1)
    _, jtop = jax.lax.top_k(jprobs, k)
    probs, _, ttop = tmoe.route(torch.from_numpy(p["router"]),
                                torch.from_numpy(x.reshape(-1, 64)), tcfg)
    np.testing.assert_array_equal(ttop.numpy(), np.asarray(jtop))
    srt = torch.sort(probs, dim=-1, descending=True).values
    margin = float((srt[:, k - 1] - srt[:, k]).min())
    print(f"moe {case}: smallest top-{k} margin {margin:.3e}")

    g = min(groups, 24)
    while 24 % g:
        g //= 2
    cap = tmoe.moe_capacity(24 // g, tcfg)
    drops = _dropped(ttop.numpy(), k, cap, g)
    assert drops == _dropped(np.asarray(jtop), k, cap, g)
    assert (len(drops) > 0) == (case == "capacity_binds")
    # the dropped share is the count's; JAX's f32 mean of the keep mask
    # rounds (it reads -2.98e-08 where nothing drops)
    assert float(taux["drop_fraction"]) == np.float32(len(drops) / (24 * k))
    assert abs(float(jaux["drop_fraction"]) - len(drops) / (24 * k)) < 1e-6
    assert _rel(ty.numpy(), np.asarray(jy)) <= 1e-5
    assert abs(float(taux["load_balance_loss"])
               - float(jaux["load_balance_loss"])) <= 1e-6


def test_moe_combine_sums_each_token_in_j_order():
    """The combine: each token's y is its k gated expert outputs (and the
    shared experts'), summed in (token, j) order — the same value whatever
    order the dispatch sorted them in."""
    cfg = dataclasses.replace(get_config("deepseek-moe-16b").reduced(
        compute_dtype="float32"), moe_dispatch_groups=1)
    p = tmoe.moe_init(4, cfg, "cpu")
    x = torch.from_numpy(np.random.default_rng(6).normal(
        size=(1, 5, 64)).astype(np.float32))
    y, aux = tmoe.moe_apply(p, x, cfg)
    assert float(aux["drop_fraction"]) == 0.0
    _, gates, top = tmoe.route(p["router"], x[0], cfg)
    act = tlayers.activation_fn(cfg.act)
    for t in range(5):
        want = 0
        for j in range(cfg.moe.top_k):
            e = int(top[t, j])
            h = act(x[0, t] @ p["w_gate"][e]) * (x[0, t] @ p["w_up"][e])
            want = want + (h @ p["w_down"][e]) * gates[t, j]
        want = want + tlayers.mlp_apply(p["shared"], x[0, t], cfg)
        torch.testing.assert_close(y[0, t], want, rtol=1e-5, atol=1e-6)


def _mla_inputs(seed=9):
    jcfg, tcfg = (dataclasses.replace(c, compute_dtype="float32")
                  for c in _cfg_pair("deepseek-v2-lite-16b"))
    p = _np_tree(jattn.mla_init(jax.random.PRNGKey(seed), jcfg)[0])
    r_ = np.random.default_rng(seed)
    x = r_.normal(size=(2, 13, 64)).astype(np.float32)
    return jcfg, tcfg, p, x


def test_mla_expanded_matches_jax():
    jcfg, tcfg, p, x = _mla_inputs()
    pos = np.arange(13, dtype=np.int32)
    jo, (jc, jkr) = jattn.mla_apply(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x), cfg=jcfg,
        positions=jnp.asarray(pos), window=8)
    to, (tc, tkr) = tattn.mla_apply(
        _to_torch(p), torch.from_numpy(x), cfg=tcfg,
        positions=torch.from_numpy(pos), window=8)
    assert _rel(to.numpy(), np.asarray(jo)) <= 1e-5
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tkr.numpy(), np.asarray(jkr), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("in_place", [False, True])
def test_mla_absorbed_prefill_and_decode_match_jax_and_expanded(in_place):
    """The absorbed form against a 16-slot cache: a 12-token prefill at
    position 0, then the 13th token at position 12 — out and both cache
    leaves within 1e-5 of JAX's; the decode's output within 1e-5 of the
    expanded form's last row over all 13 tokens (the same function); the
    in-place write is bitwise the functional one."""
    jcfg, tcfg, p, x = _mla_inputs()
    m = tcfg.mla
    jp, tp = jax.tree.map(jnp.asarray, p), _to_torch(p)
    jcache = dict(c=jnp.zeros((2, 16, m.kv_lora_rank)),
                  kr=jnp.zeros((2, 16, m.qk_rope_dim)))
    tcache = dict(c=torch.zeros((2, 16, m.kv_lora_rank)),
                  kr=torch.zeros((2, 16, m.qk_rope_dim)))
    outs = []
    for lo, hi in ((0, 12), (12, 13)):
        pos = np.arange(lo, hi, dtype=np.int32)
        jo, jcache = jattn.mla_apply(
            jp, jnp.asarray(x[:, lo:hi]), cfg=jcfg,
            positions=jnp.asarray(pos), window=1 << 30, cache=jcache,
            decode_pos=lo)
        ref, _ = tattn.mla_apply(
            tp, torch.from_numpy(x[:, lo:hi]), cfg=tcfg,
            positions=torch.from_numpy(pos), window=1 << 30,
            cache=tcache, decode_pos=lo)
        own = {k: v.clone() for k, v in tcache.items()}
        to, tnew = tattn.mla_apply(
            tp, torch.from_numpy(x[:, lo:hi]), cfg=tcfg,
            positions=torch.from_numpy(pos), window=1 << 30,
            cache=own if in_place else tcache, decode_pos=lo,
            in_place=in_place)
        assert torch.equal(to, ref)
        if in_place:
            assert tnew["c"] is own["c"] and tnew["kr"] is own["kr"]
        assert _rel(to.numpy(), np.asarray(jo)) <= 1e-5
        for name in ("c", "kr"):
            np.testing.assert_allclose(tnew[name].numpy(),
                                       np.asarray(jcache[name]),
                                       rtol=1e-5, atol=1e-6)
        tcache = tnew
        outs.append(to)
    full, _ = tattn.mla_apply(tp, torch.from_numpy(x), cfg=tcfg,
                              positions=torch.arange(13, dtype=torch.int32),
                              window=1 << 30)
    assert _rel(outs[1].numpy(), full[:, 12:].numpy()) <= 1e-5
    assert _rel(outs[0].numpy(), full[:, :12].numpy()) <= 1e-5


@pytest.mark.parametrize("cached", [False, True])
def test_attn_apply_with_biases_softcap_window_matches_jax(cached):
    """Gemma-2's attention softcap (50) and a binding window of 4 with
    Qwen2's QKV biases set non-zero, uncached over 10 tokens, or the 10th
    token at position 9 against a cache of the first 9 (written by the
    port's own prefill and by JAX's)."""
    jcfg, tcfg = (dataclasses.replace(c, compute_dtype="float32",
                                      attn_logit_softcap=50.0)
                  for c in _cfg_pair("qwen2-1.5b"))
    p = _np_tree(jattn.attn_init(jax.random.PRNGKey(2), jcfg)[0])
    r_ = np.random.default_rng(2)
    _perturb(p, ("bq", "bk", "bv"), r_, 0.5)
    x = r_.normal(size=(2, 10, 64)).astype(np.float32)
    jp, tp = jax.tree.map(jnp.asarray, p), _to_torch(p)
    pos = np.arange(10, dtype=np.int32)
    if not cached:
        jo, _ = jattn.attn_apply(jp, jnp.asarray(x), cfg=jcfg,
                                 positions=jnp.asarray(pos), window=4)
        to, _ = tattn.attn_apply(tp, torch.from_numpy(x), cfg=tcfg,
                                 positions=torch.from_numpy(pos), window=4)
    else:
        shape = (2, 12, tcfg.num_kv_heads, tcfg.head_dim)
        jc = dict(k=jnp.zeros(shape), v=jnp.zeros(shape))
        tc = dict(k=torch.zeros(shape), v=torch.zeros(shape))
        _, jc = jattn.attn_apply(jp, jnp.asarray(x[:, :9]), cfg=jcfg,
                                 positions=jnp.asarray(pos[:9]), window=4,
                                 cache=jc, decode_pos=0)
        _, tc = tattn.attn_apply(tp, torch.from_numpy(x[:, :9]), cfg=tcfg,
                                 positions=torch.from_numpy(pos[:9]),
                                 window=4, cache=tc, decode_pos=0)
        jo, _ = jattn.attn_apply(jp, jnp.asarray(x[:, 9:]), cfg=jcfg,
                                 positions=jnp.asarray(pos[9:]), window=4,
                                 cache=jc, decode_pos=9)
        to, _ = tattn.attn_apply(tp, torch.from_numpy(x[:, 9:]), cfg=tcfg,
                                 positions=torch.from_numpy(pos[9:]),
                                 window=4, cache=tc, decode_pos=9)
    assert _rel(to.numpy(), np.asarray(jo)) <= 1e-5


# ---------------------------------------------------------------------------
# Inside the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_gated_serve_at_zero_threshold_is_bitwise_ungated(arch):
    """The configs' own bf16, MNF on at θ = 0 against MNF off: the fire
    between each FFN's (and each expert's) up and down projections is
    the identity on these activations, so the prefill's and every step's
    logits and the greedy tokens are bitwise equal."""
    cfg = get_config(arch).reduced()
    assert cfg.mnf.enabled and cfg.mnf.threshold == 0.0
    off = dataclasses.replace(cfg, mnf=dataclasses.replace(cfg.mnf,
                                                           enabled=False))
    params = ttfm.init_compute_params(0, cfg, "cpu")
    prompts = serve.make_prompts(cfg, B, 7, 0, "cpu")
    runs = [serve.run_lm(params, c, prompts, 3, keep_logits=True)
            for c in (cfg, off)]
    for key in ("prefill_logits", "logits", "tokens"):
        assert torch.equal(runs[0][key], runs[1][key]), key
    assert runs[0]["events"] is None and runs[1]["events"] is None


@pytest.mark.parametrize("arch", ARCHS)
def test_init_compute_params_is_bitwise_compute_params(arch):
    """The layer-at-a-time builder gives ``compute_params(init_params(...))``
    leaf for leaf: values, dtypes and shapes (the cast leaves in bf16, the
    norms and the router in f32)."""
    cfg = get_config(arch).reduced()
    want = dict(_leaves(ttfm.compute_params(ttfm.init_params(0, cfg, "cpu"),
                                            cfg)))
    got = dict(_leaves(ttfm.init_compute_params(0, cfg, "cpu")))
    assert set(got) == set(want)
    for name, leaf in got.items():
        assert leaf.dtype == want[name].dtype, name
        assert torch.equal(leaf, want[name]), name
    assert got["embed/tok"].dtype == torch.bfloat16
    assert got["final_norm"].dtype == torch.float32
    if cfg.moe is not None:
        assert got["layers/ffn/router"].dtype == torch.float32
        assert got["dense_layers/ffn/w_up"].dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ARCHS)
def test_count_and_active_params_equal_jax_full_configs(arch):
    assert ttfm.count_params(get_config(arch)) \
        == jtfm.count_params(jget_config(arch))
    assert ttfm.active_params(get_config(arch)) \
        == jtfm.active_params(jget_config(arch))


@pytest.mark.parametrize("arch", ["whisper-base", "phi-3-vision-4.2b"])
def test_unported_archs_raise_naming_their_item(arch):
    assert "item 12b" in NOT_YET_PORTED[arch]
    with pytest.raises(NotImplementedError, match="item 12b"):
        get_config(arch)
    with pytest.raises(NotImplementedError, match="item 12b"):
        ttfm.init_params(0, jget_config(arch).reduced(), "cpu")


def test_moe_ep_raises_naming_item_13():
    cfg = dataclasses.replace(get_config("deepseek-moe-16b").reduced(),
                              moe_ep=True)
    with pytest.raises(NotImplementedError, match="item 13"):
        ttfm.init_params(0, cfg, "cpu")


def test_params_from_numpy_checks_keys_and_shapes():
    cfg = get_config("deepseek-moe-16b").reduced()
    tree = _np_tree(_jax_params("deepseek-moe-16b"))
    del tree["dense_layers"]["ffn"]["w_gate"]
    with pytest.raises(KeyError, match="dense_layers/ffn"):
        ttfm.params_from_numpy(tree, cfg, "cpu")
    tree = _np_tree(_jax_params("deepseek-moe-16b"))
    tree["layers"]["ffn"]["shared"]["w_up"] = \
        tree["layers"]["ffn"]["shared"]["w_up"][:, :, :-1]
    with pytest.raises(ValueError, match="shared/w_up"):
        ttfm.params_from_numpy(tree, cfg, "cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_reduced_on_cpu_prints_stats(arch, capsys):
    serve.main(["--arch", arch, "--reduced", "--device", "cpu", "--gen",
                "3", "--prompt-len", "5", "--batch", "2"])
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["arch"] == arch and stats["mnf"] is True
    assert stats["generated"] == 3 and stats["device"] == "cpu"
    assert len(stats["sample_tokens"]) == 3
    assert "events_per_token" not in stats    # no gated recurrent step
