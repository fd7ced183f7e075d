"""The port's logical-axis sharding against ``repro`` on the CPU, with no
process spawned:

- ``transformer.param_axes`` and ``cache_axes`` equal the JAX package's
  trees (``init_params(...)[1]`` under ``jax.eval_shape``, and
  ``cache_axes``) for every architecture, reduced;
- at full width, on a 16x16 and a 2x16x16 mesh of names and sizes
  (``MeshShape`` against ``abstract_mesh_compat``), with FSDP on and off,
  every param and cache leaf resolves to JAX's ``PartitionSpec`` entry
  for entry, and ``to_placements`` orders a two-axis entry major to
  minor;
- twins of ``tests/test_sharding_rules.py`` and of
  ``test_choose_mesh_shape``;
- a recording ``sc`` sees the (shape, axes) of JAX's sharding points, in
  JAX's order of first appearance, in one reduced forward of each block
  type (attention, MoE, RWKV6, Hymba, the encoder-decoder).  Hymba's
  scan is the one difference, by design: JAX constrains the chunk's
  decay, increment and state streams (B, C, DI, N), which the port's
  fused scan (B10) never builds;
- the mesh-capacity error and fallback twins of ``tests/test_serving.py``
  and the one-rank group ``checked_mesh`` starts by itself, each in this
  process (the group destroyed after);
- ``quantized_psum`` and ``event_psum`` at one rank against JAX's under
  ``shard_map_compat`` on one device (``tests/test_optim_data_ckpt.py``'s
  pattern): equal at 1e-6, and fired plus residual reconstructing the
  running gradient sum.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as jget_config
from repro.models import transformer as jtfm
from repro.optim.compression import event_psum as jevent_psum
from repro.optim.compression import quantized_psum as jquantized_psum
from repro.parallel import sharding as jsh
from repro.runtime.elastic import choose_mesh_shape as jchoose_mesh_shape
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import mesh as tmesh
from repro_torch.models import transformer as ttfm
from repro_torch.optim.compression import (event_psum, quantized_psum,
                                           topk_threshold)
from repro_torch.parallel import sharding as tsh
from repro_torch.runtime.elastic import choose_mesh_shape

MESHES = [((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]


def _tuples(tree):
    if isinstance(tree, dict):
        return {k: _tuples(v) for k, v in tree.items()}
    return tuple(tree)


def _pairs(axes, shapes, path=""):
    """(path, axes, shape) of matching leaves of two trees."""
    for k in sorted(axes):
        if isinstance(axes[k], dict):
            yield from _pairs(axes[k], shapes[k], f"{path}{k}/")
        else:
            yield f"{path}{k}", tuple(axes[k]), tuple(shapes[k])


@functools.lru_cache(maxsize=None)
def _jax_param_tree(arch: str, reduced: bool):
    """(specs, shapes) of JAX's ``init_params`` for ``arch``."""
    cfg = jget_config(arch).reduced() if reduced else jget_config(arch)
    box = {}

    def init(k):
        p, s = jtfm.init_params(k, cfg)
        box["specs"] = s
        return p

    shapes = jax.eval_shape(init, jax.ShapeDtypeStruct((2,), jnp.uint32))
    return box["specs"], jax.tree.map(lambda s: tuple(s.shape), shapes)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_cache_axes_equal_jax(arch):
    specs, _ = _jax_param_tree(arch, True)
    assert ttfm.param_axes(get_config(arch).reduced()) == _tuples(specs)
    assert ttfm.cache_axes(get_config(arch).reduced()) \
        == _tuples(jtfm.cache_axes(jget_config(arch).reduced()))


def _jax_spec(ps: P) -> tuple:
    return tuple(ps)


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("sizes,names", MESHES,
                         ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_full_width_leaves_resolve_as_jax(arch, sizes, names, fsdp):
    """Every full-width param leaf and every leaf of a decode_32k cache
    (batch 128, 32768 positions) resolves to JAX's spec; each spec's
    placements name a mesh dim at most once, major to minor."""
    from torch.distributed.tensor import Shard

    jmesh = jsh.abstract_mesh_compat(sizes, names)
    tmesh_ = tsh.MeshShape(sizes, names)
    jrules = jsh.make_rules(jmesh, fsdp=fsdp, seq_shard=True)
    trules = tsh.make_rules(tmesh_, fsdp=fsdp, seq_shard=True)
    assert trules.table == jrules.table
    cfg = get_config(arch)
    specs, shapes = _jax_param_tree(arch, False)
    taxes = ttfm.param_axes(cfg)
    tshapes = ttfm.tree_map(lambda t: tuple(t.shape),
                            ttfm.init_params(0, cfg, "meta"))
    assert _tuples(specs) == taxes and tshapes == shapes
    cache = jtfm.cache_specs(jget_config(arch), 128, 32768)
    cshapes = jax.tree.map(lambda s: tuple(s.shape), cache)
    assert ttfm.tree_map(lambda sd: sd[0], ttfm.cache_specs(
        cfg, 128, 32768)) == cshapes
    leaves = list(_pairs(taxes, tshapes)) + list(
        _pairs(ttfm.cache_axes(cfg), cshapes))
    for path, ax, shape in leaves:
        got = tsh.logical_to_pspec(ax, shape, tmesh_, trules)
        want = _jax_spec(jsh.logical_to_pspec(ax, shape, jmesh, jrules))
        assert got == want, (path, got, want)
        pl = tsh.to_placements(got, tmesh_)
        for d, entry in enumerate(got):
            if entry is None:
                continue
            axes = entry if isinstance(entry, tuple) else (entry,)
            assert [i for i, p in enumerate(pl) if p == Shard(d)] \
                == [names.index(a) for a in axes], (path, pl)
            assert shape[d] % tsh.mesh_axis_size(tmesh_, entry) == 0


# -- twins of tests/test_sharding_rules.py -----------------------------------

@pytest.fixture(scope="module")
def mesh16():
    return tsh.MeshShape((16, 16), ("data", "model"))


def test_divisibility_drops_heads(mesh16):
    rules = tsh.make_rules(mesh16)
    ps = tsh.logical_to_pspec(("batch", "attn_seq", "heads", None),
                              (256, 4096, 12, 128), mesh16, rules)
    assert ps == ("data", "model")


def test_priority_prefers_heads(mesh16):
    rules = tsh.make_rules(mesh16)
    ps = tsh.logical_to_pspec(("batch", "attn_seq", "heads", None),
                              (256, 4096, 32, 128), mesh16, rules)
    assert ps == ("data", None, "model")


def test_axis_reuse_blocked(mesh16):
    rules = tsh.make_rules(mesh16)
    ps = tsh.logical_to_pspec(("experts", "embed", "ff"), (64, 2048, 1408),
                              mesh16, rules)
    assert ps == ("model",)


def test_vocab_beats_cache_seq(mesh16):
    rules = tsh.make_rules(mesh16)
    ps = tsh.logical_to_pspec(("cache_seq", "vocab"), (32768, 256000),
                              mesh16, rules)
    assert ps == (None, "model")


def test_fsdp_rule(mesh16):
    rules = tsh.make_rules(mesh16, fsdp=True)
    ps = tsh.logical_to_pspec(("vocab", "embed"), (256000, 4608), mesh16,
                              rules)
    assert ps == ("model", "data")
    rules2 = tsh.make_rules(mesh16, fsdp=False)
    ps2 = tsh.logical_to_pspec(("vocab", "embed"), (256000, 4608), mesh16,
                               rules2)
    assert ps2 == ("model",)


def test_batch_over_pod_and_data():
    from torch.distributed.tensor import Replicate, Shard
    mesh = tsh.MeshShape((2, 16, 16), ("pod", "data", "model"))
    rules = tsh.make_rules(mesh)
    ps = tsh.logical_to_pspec(("batch", None), (256, 4096), mesh, rules)
    assert ps == (("pod", "data"),)
    assert tsh.to_placements(ps, mesh) == [Shard(0), Shard(0), Replicate()]
    assert tsh.serve_batch_pspec(mesh, 256, 2) == ps
    assert tsh.data_axis_size(mesh) == 32
    ps1 = tsh.logical_to_pspec(("batch", None), (1, 4096), mesh, rules)
    assert ps1 == ()
    assert tsh.serve_batch_pspec(mesh, 1, 2) == ()


def test_overrides():
    mesh = tsh.MeshShape((16, 16), ("data", "model"))
    rules = tsh.make_rules(mesh, overrides={"ff": None})
    ps = tsh.logical_to_pspec(("embed", "ff"), (1024, 4096), mesh, rules)
    assert ps == ()


def test_choose_mesh_shape():
    assert choose_mesh_shape(512, model_parallel=16) == (2, 16, 16)
    assert choose_mesh_shape(256, model_parallel=16) == (16, 16)
    shape = choose_mesh_shape(248, model_parallel=16)
    assert np.prod(shape) <= 248
    for n in (1, 2, 3, 4, 6, 8, 12, 248, 250, 256, 384, 512, 1000):
        for mp in (1, 2, 16):
            assert choose_mesh_shape(n, model_parallel=mp) \
                == jchoose_mesh_shape(n, model_parallel=mp)


# -- the sharding points of one forward --------------------------------------

def _recorder(seq):
    def sc(x, axes):
        seq.append((tuple(int(d) for d in x.shape), tuple(axes)))
        return x
    return sc


def _first_seen(seq) -> list:
    return list(dict.fromkeys(seq))


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "deepseek-moe-16b",
                                  "rwkv6-7b", "hymba-1.5b", "whisper-base"])
def test_recording_sc_sees_jax_sharding_points(arch):
    jcfg = dataclasses.replace(jget_config(arch).reduced(),
                               compute_dtype="float32")
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              compute_dtype="float32")
    bsz, s = 2, 12
    tokens = np.arange(bsz * s).reshape(bsz, s) % cfg.vocab_size
    kw, tkw = {}, {}
    if cfg.encoder_decoder:
        frames = np.zeros((bsz, cfg.enc_frames, cfg.d_model), np.float32)
        kw["audio_frames"] = jnp.asarray(frames)
        tkw["audio_frames"] = torch.from_numpy(frames)
    jseq, tseq = [], []
    # traced only (eval_shape): the recorder sees the traced shapes
    jax.eval_shape(lambda k, t, kw: jtfm.forward(
        jtfm.init_params(k, jcfg)[0], t, jcfg, sc=_recorder(jseq), **kw),
        jax.random.PRNGKey(0), jnp.asarray(tokens, jnp.int32), kw)
    ttfm.forward(ttfm.init_params(0, cfg, "cpu"), torch.from_numpy(tokens),
                 cfg, sc=_recorder(tseq), **tkw)
    want = _first_seen(jseq)
    if cfg.block_type == "hymba":
        want = [e for e in want if e[1] != ("batch", None, "ff", None)]
    assert _first_seen(tseq) == want
    assert len(want) >= 3


# -- meshes of ranks ---------------------------------------------------------

@pytest.fixture
def no_group():
    """This process with no default process group, before and after."""
    assert not dist.is_initialized()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def test_mesh_capacity_error_is_actionable(no_group):
    with pytest.raises(tmesh.MeshCapacityError) as ei:
        tmesh.checked_mesh((8192, 2), ("data", "model"), device_type="cpu")
    msg = str(ei.value)
    assert "16384" in msg and "only 1 exist" in msg
    assert "torchrun --nproc-per-node 16384" in msg
    assert not dist.is_initialized()


def test_mesh_capacity_fallback_warns_to_ones(no_group):
    with pytest.warns(RuntimeWarning, match="Falling back"):
        mesh = tmesh.checked_mesh((8192, 2), ("data", "model"),
                                  fallback=True, device_type="cpu")
    assert dict(zip(mesh.mesh_dim_names, mesh.shape)) == \
        {"data": 1, "model": 1}


def test_one_rank_mesh_starts_its_own_group(no_group):
    """With no process group and an all-ones shape ``checked_mesh``
    starts a one-rank gloo group itself; ``make_serve_mesh`` then spans
    the world."""
    mesh = tmesh.checked_mesh((1, 1), ("data", "model"), device_type="cpu")
    assert dist.is_initialized() and dist.get_world_size() == 1
    assert dist.get_backend() == "gloo"
    assert mesh.mesh_dim_names == ("data", "model")
    serve = tmesh.make_serve_mesh(device_type="cpu")
    assert tuple(serve.shape) == (1, 1)
    with pytest.raises(tmesh.MeshCapacityError):
        tmesh.make_serve_mesh(2, fallback=False, device_type="cpu")


# -- compression at one rank against JAX -------------------------------------

@pytest.fixture
def one_rank(no_group):
    tmesh.checked_mesh((1,), ("i",), device_type="cpu")
    yield


def test_quantized_psum_one_rank_matches_jax(one_rank):
    from repro.launch.mesh import checked_mesh
    x = np.linspace(-1, 1, 64, dtype=np.float32) ** 3
    want = jsh.shard_map_compat(
        lambda v: jquantized_psum(v, "i"), checked_mesh((1,), ("i",)),
        in_specs=P(), out_specs=P())(jnp.asarray(x))
    got = quantized_psum(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    scale = np.float32(np.abs(x).max()) / np.float32(127)
    np.testing.assert_array_equal(
        got.numpy(), np.round(x / scale).astype(np.float32) * scale)


def test_event_psum_one_rank_matches_jax(one_rank):
    """Fired + residual reconstructs the running gradient sum, and each
    step's fired tensor and residual equal JAX's."""
    from repro.launch.mesh import checked_mesh
    jmesh = checked_mesh((1,), ("i",))
    residual = torch.zeros(32)
    jres = jnp.zeros(32)
    total_sent = torch.zeros(32)
    total_true = torch.zeros(32)
    rng = np.random.default_rng(0)
    for _ in range(6):
        g = rng.normal(size=32).astype(np.float32)
        jf, jres = jsh.shard_map_compat(
            lambda gv, rv: jevent_psum(gv, rv, "i", k_frac=0.25), jmesh,
            in_specs=(P(), P()), out_specs=(P(), P()))(jnp.asarray(g), jres)
        fired, residual = event_psum(torch.from_numpy(g), residual,
                                     k_frac=0.25)
        np.testing.assert_allclose(fired.numpy(), np.asarray(jf), atol=1e-6)
        np.testing.assert_allclose(residual.numpy(), np.asarray(jres),
                                   atol=1e-6)
        total_sent += fired
        total_true += torch.from_numpy(g)
        np.testing.assert_allclose((total_sent + residual).numpy(),
                                   total_true.numpy(), atol=1e-5)
        assert (fired != 0).float().mean() <= 0.6
    assert float(topk_threshold(torch.arange(100.0), 0.1)) == 90.0
