"""The dry run (``repro_torch.launch.dryrun``) and the roofline's collective
term on the CPU.

- One reduced cell of each step kind (qwen2-0.5b: train, prefill, decode)
  at a 2x4 fake mesh writes a record in the JAX package's fields that
  ``launch.report`` reads.
- Its argument bytes per device equal the sum of the local shard bytes of
  the params, AdamW moments, cache and batch under the specs JAX's
  ``logical_to_pspec`` resolves on a 2x4 abstract mesh (as
  ``tests/test_torch_sharding.py`` resolves them).
- A purely data-parallel cell (reduced Hymba, 4x1) counts 1/4 of the
  one-device step's FLOPs and of B10's forward and backward formulas,
  and a one-rank mesh the one-device FLOPs and no collective byte.
- The embedding lookup and the cross-entropy keep a vocabulary sharded
  over the model axis sharded: all-reduces of the rows' results, no
  table or logits gathered.
- A gloo world of 2 ranks counts ``moe_apply_ep``'s all-reduce at its
  output bytes.
- The command line runs a cell alone.

Fake worlds run in a subprocess, so that pytest's workers (``--dist
loadfile``) never share a process group; the gloo world is spawned by
``tests/_torch_ranks.py``.
"""
import json
import math
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.parallel import sharding as jsh
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import report as treport
from repro_torch.models import transformer as ttfm

from _torch_ranks import moe_ep_count_rank, run_ranks

ROOT = pathlib.Path(__file__).resolve().parents[1]
#: Each step kind's cell, cut to batch 8 x 32 (the record keeps the name).
CELLS = {"train": "train_4k", "prefill": "prefill_32k",
         "decode": "decode_32k"}
KINDS = tuple(CELLS)
SEQ, BATCH = 32, 8

#: Run in a subprocess: the three 2x4 cells, the data-parallel cell (4x1),
#: the one-rank cell (1x1), and the one-device step with no mesh, all on
#: the meta device; a JSON summary on stdout.
_SCRIPT = """
import json, sys
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun, roofline
from repro_torch.launch.steps import make_train_step
from repro_torch.models import transformer as tfm
from repro_torch.optim import adamw_init

out, seq, batch = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
names = dict(train="train_4k", prefill="prefill_32k", decode="decode_32k")
shape = lambda kind: ShapeConfig(names[kind], seq, batch, kind)
recs = {kind: dryrun.run_cell("qwen2-0.5b", names[kind], reduced=True,
                              mesh_shape=(2, 4), shape=shape(kind),
                              out_dir=out, verbose=False)
        for kind in names}
cells = {m: dryrun.run_cell("hymba-1.5b", "train_4k", reduced=True,
                            mesh_shape=m, shape=shape("train"),
                            out_dir=out + "/hymba", verbose=False)
         for m in ((4, 1), (1, 1))}
cfg = get_config("hymba-1.5b").reduced()
params = tfm.init_params(0, cfg, "meta")
_, cost = roofline.count_cost(make_train_step(cfg, shape("train")).fn,
                              params, adamw_init(params),
                              dryrun._batch(cfg, shape("train")))

# the vocabulary-parallel embedding lookup and cross-entropy at 2x4: the
# collectives they issue, by the shapes they move
import torch
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from repro_torch.launch.mesh import dry_mesh
from repro_torch.models import layers
lm = get_config("qwen2-0.5b").reduced()
meta = lambda *s, dt=torch.float32: torch.empty(s, dtype=dt, device="meta")
names = lambda t: [f"S{p.dim}" if p.is_shard() else "R" if p.is_replicate()
                   else "P" for p in t.placements]
vocab = {}
with dry_mesh((2, 4), ("data", "model")) as mesh:
    tbl = distribute_tensor(meta(lm.vocab_size, lm.d_model), mesh,
                            [Replicate(), Shard(0)]).requires_grad_()
    tok = distribute_tensor(meta(batch, seq, dt=torch.int64), mesh,
                            [Shard(0), Replicate()])
    logits = distribute_tensor(meta(batch, seq, lm.vocab_size), mesh,
                               [Shard(0), Shard(2)]).requires_grad_()
    with roofline.counting() as cost_e:
        emb = layers.embed_apply(dict(tok=tbl), tok, lm)
        g = torch.autograd.grad(emb.float().sum(), tbl)[0]
        g = g.redistribute(mesh, tbl.placements)
    with roofline.counting() as cost_x:
        lse, ll = tfm._lse_and_label_logits(logits, tok)
        gx = torch.autograd.grad((lse - ll).sum(), logits)[0]
    vocab = dict(
        embed=dict(coll=cost_e().collective_shapes, dtype=str(emb.dtype),
                   placements=names(emb),
                   shape=list(emb.shape),
                   grad_placements=names(g)),
        xent=dict(coll=cost_x().collective_shapes,
                  placements=names(lse),
                  shape=list(lse.shape),
                  grad_placements=names(gx)))
print(json.dumps(dict(recs=recs, dp=cells[(4, 1)], one_rank=cells[(1, 1)],
                      one_device=dict(flops=cost.flops,
                                      kernels=cost.kernels),
                      vocab=vocab)))
"""


def _run(args, **kw):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, *args], capture_output=True,
                          text=True, env=env, cwd=ROOT, timeout=300, **kw)


@pytest.fixture(scope="module")
def dry(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_dryrun")
    got = _run(["-c", _SCRIPT, str(out), str(SEQ), str(BATCH)])
    assert got.returncode == 0, got.stderr[-4000:]
    return out, json.loads(got.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("kind", KINDS)
def test_reduced_cell_writes_a_record_the_report_reads(dry, kind,
                                                       monkeypatch):
    out, summary = dry
    rec = summary["recs"][kind]
    assert rec["status"] == "ok", rec.get("traceback")
    path = out / f"qwen2-0.5b__{CELLS[kind]}__2x4.json"
    assert json.loads(path.read_text()) == rec
    r = rec["roofline"]
    assert (r["mesh"], r["chips"], r["shape"]) == ("2x4", 8, CELLS[kind])
    assert r["hlo_gflops"] > 0 and r["hlo_gbytes"] > 0
    mem = rec["memory"]
    assert r["bytes_per_device"] == mem["temp"] + mem["args"] \
        + mem["output"] - mem["alias"]
    assert mem["temp"] > 0 and mem["output"] > 0
    # a 2x4 mesh shards the model: the step issues collectives
    assert r["coll_gbytes"] > 0 and r["t_collective"] > 0
    assert r["coll_breakdown"] == {k: float(v[1]) for k, v in
                                   rec["collectives"].items()}
    assert r["t_collective"] == pytest.approx(
        r["coll_gbytes"] * 1e9 / 900e9)
    # the splits by the shapes moved and by op add up to the totals
    for coll, total in rec["collectives"].items():
        parts = [v for k, v in rec["collective_shapes"].items()
                 if k.split(" ")[0] == coll]
        assert [sum(p[0] for p in parts), sum(p[1] for p in parts)] == total
    assert sum(rec["flops_by_op"].values()) == pytest.approx(
        r["xla_raw_gflops"] * 1e9, rel=1e-12)
    monkeypatch.setattr(treport, "RESULTS", str(out))
    # the report's model fields are the full config's; the record's own
    # are the reduced config's
    summary_ = treport.summarize()
    assert summary_["ok"] == 3 and summary_["error"] == 0
    row = [ln for ln in treport.dryrun_markdown().splitlines()
           if ln.startswith(f"| qwen2-0.5b | {CELLS[kind]} | 2x4 | ok")]
    assert len(row) == 1
    assert f"| {r['coll_gbytes']:.1f} |" in row[0]
    assert any(ln.startswith(f"| qwen2-0.5b | {CELLS[kind]} |")
               for ln in treport.roofline_markdown(mesh="2x4").splitlines())


def _shard_bytes(shape, dtype, spec, sizes) -> int:
    """Bytes of one device's shard of a tensor under a JAX spec."""
    n = 1
    for d, size in enumerate(shape):
        entry = spec[d] if d < len(spec) else None
        axes = () if entry is None else (
            entry if isinstance(entry, tuple) else (entry,))
        n *= size // math.prod(sizes[a] for a in axes)
    return n * torch.empty((), dtype=dtype).element_size()


@pytest.mark.parametrize("kind", KINDS)
def test_argument_bytes_are_the_jax_specs_local_shards(dry, kind):
    """The record's ``args``: each param (and, to train, its two f32
    moments and the step count), each cache leaf (decode) and each batch
    input, at one device's shard of JAX's resolved spec."""
    _, summary = dry
    cfg = get_config("qwen2-0.5b").reduced()
    sizes = {"data": 2, "model": 4}
    jmesh = jsh.abstract_mesh_compat((2, 4), ("data", "model"))
    rules = jsh.make_rules(jmesh, fsdp=cfg.fsdp, seq_shard=cfg.seq_shard)

    def leaves(axes, tree):
        if isinstance(axes, dict):
            for k in axes:
                yield from leaves(axes[k], tree[k])
        else:
            yield tuple(axes), tree

    def total(axes, shapes, dtype_of):
        return sum(_shard_bytes(sd[0], dtype_of(sd), tuple(
            jsh.logical_to_pspec(ax, sd[0], jmesh, rules)), sizes)
            for ax, sd in leaves(axes, shapes))

    pshapes = ttfm.tree_map(lambda t: (tuple(t.shape), t.dtype),
                            ttfm.init_params(0, cfg, "meta"))
    want = total(ttfm.param_axes(cfg), pshapes, lambda sd: sd[1])
    if kind == "train":
        want += 2 * total(ttfm.param_axes(cfg), pshapes,
                          lambda sd: torch.float32) + 4
    if kind == "decode":
        cshapes = ttfm.cache_specs(cfg, BATCH, SEQ)
        want += total(ttfm.cache_axes(cfg), cshapes, lambda sd: sd[1])
    shape = ShapeConfig(CELLS[kind], SEQ, BATCH, kind)
    for name, (s, dt) in ttfm.input_specs(cfg, shape).items():
        spec = tuple(jsh.logical_to_pspec(
            ("batch",) + (None,) * (len(s) - 1), s, jmesh, rules))
        want += _shard_bytes(s, dt, spec, sizes)
    assert summary["recs"][kind]["memory"]["args"] == want


def test_data_parallel_cell_counts_a_quarter_of_one_device(dry):
    """Reduced Hymba's train step at 4x1 (batch 8 over 4 data ranks,
    nothing sharded over the model axis of 1): per device exactly 1/4 of
    the one-device step's FLOPs and of B10's forward and backward calls'
    formula bytes and operations (the scan is per batch row); the
    gradients' all-reduce over the data axis is the collective term."""
    _, summary = dry
    dp, one = summary["dp"], summary["one_device"]
    assert dp["status"] == "ok", dp.get("traceback")
    r = dp["roofline"]
    assert r["hlo_gflops"] * 1e9 * 4 == pytest.approx(one["flops"],
                                                      rel=1e-12)
    for name in ("mamba_scan_fused", "mamba_scan_fused_bwd"):
        calls, nbytes, ops = dp["kernels"][name]
        calls1, nbytes1, ops1 = one["kernels"][name]
        assert calls == calls1 > 0
        assert ops * 4 == pytest.approx(ops1, rel=1e-12)
    assert "all-reduce" in dp["collectives"] and r["t_collective"] > 0


def test_one_rank_mesh_counts_no_collective_bytes(dry):
    """At 1x1 every collective is over one rank and moves nothing: the
    collective term is 0, and the FLOPs are the one-device step's."""
    _, summary = dry
    rec, one = summary["one_rank"], summary["one_device"]
    assert rec["status"] == "ok", rec.get("traceback")
    r = rec["roofline"]
    assert r["coll_gbytes"] == 0.0 and r["t_collective"] == 0.0
    assert rec["collectives"] == {} and r["coll_breakdown"] == {}
    assert r["hlo_gflops"] * 1e9 == pytest.approx(one["flops"], rel=1e-12)


def test_embedding_lookup_keeps_the_vocabulary_sharded(dry):
    """The lookup from a table sharded over the model axis (vocab 256 over
    4 ranks) with the tokens' rows over the data axis gathers no table:
    one all-reduce of the rank's rows (4 of batch 8, 32, d 64) in the
    compute dtype, and the gradient's one all-reduce over the data axis
    of the rank's (64, 64) vocabulary shard into the table's
    placements."""
    _, summary = dry
    e = summary["vocab"]["embed"]
    cfg = get_config("qwen2-0.5b").reduced()
    rows, d = (BATCH // 2, SEQ, cfg.d_model), cfg.d_model
    assert e["dtype"] == "torch.bfloat16" and e["shape"] == [BATCH, SEQ, d]
    assert e["placements"] == ["S0", "R"]
    assert e["grad_placements"] == ["R", "S0"]
    v = cfg.vocab_size // 4
    assert e["coll"] == {
        f"all-reduce {rows} bfloat16": [1, math.prod(rows) * 2],
        f"all-reduce {(v, d)} float32": [1, v * d * 4]}


def test_cross_entropy_keeps_the_vocabulary_sharded(dry):
    """The logsumexp and label pick of logits sharded over the model axis
    (vocab 256 over 4 ranks) gather no logits: three all-reduces of the
    rank's rows (4 of batch 8, 32) in f32 — the maxima, the sums of
    exponentials, the picked logits — and none in the backward, whose
    gradient keeps the logits' placements."""
    _, summary = dry
    x = summary["vocab"]["xent"]
    rows = (BATCH // 2, SEQ)
    assert x["shape"] == [BATCH, SEQ]
    assert x["placements"] == ["S0", "R"]
    assert x["grad_placements"] == ["S0", "S2"]
    assert x["coll"] == {
        f"all-reduce {rows} float32": [3, 3 * math.prod(rows) * 4]}


def test_moe_ep_all_reduce_counted_at_its_output_bytes():
    """A gloo world of 2 ranks, ``moe_apply_ep`` on a (1, 2) mesh: the one
    all-reduce over the expert-parallel group (the data group has one
    rank: its statistics' all-reduces move nothing) counted once, at the
    bytes of the rank's output."""
    cfg = get_config("deepseek-moe-16b").reduced()
    x = np.random.default_rng(2).normal(
        size=(2, 8, cfg.d_model)).astype(np.float32) * 0.3
    for out in run_ranks(moe_ep_count_rank, 2,
                         dict(compute_dtype="float32"), x):
        assert out["ep"]
        assert out["collectives"]["all-reduce"] == [1, out["y_bytes"]]
        assert out["y_bytes"] == x.size * 4


def test_cli_runs_a_cell(tmp_path):
    """``python -m repro_torch.launch.dryrun`` on a reduced cell at a 2x2
    mesh: exit 0, the record on disk, the report's row printed."""
    got = _run(["-m", "repro_torch.launch.dryrun", "--arch", "rwkv6-7b",
                "--shape", "decode_32k", "--reduced", "--mesh", "2x2",
                "--out-dir", str(tmp_path)])
    assert got.returncode == 0, got.stderr[-4000:]
    assert "done: ok=1 skipped=0 failed=0" in got.stdout
    rec = json.loads((tmp_path / "rwkv6-7b__decode_32k__2x2.json")
                     .read_text())
    assert rec["status"] == "ok" and rec["roofline"]["chips"] == 4
    # B7 on meta tensors: counted by its formula, one call a layer
    cfg = get_config("rwkv6-7b").reduced()
    assert rec["kernels"]["wkv6_step_events"][0] == cfg.num_layers
