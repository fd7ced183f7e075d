"""Assemble the dry-run and roofline tables from records in the JAX
package's JSON schema — port of ``repro.launch.report``.

Reads ``<repo>/results/torch_dryrun/*.json`` (the port's own directory:
the JAX package's ``results/dryrun`` is neither read nor written), each
record ``{"arch", "shape", "mesh", "status", "tag", "roofline": {...}}``
as the JAX package writes them.  The model-FLOP fields are recomputed
from the port's configs at the H100's peak (``HW()``), and the summary
lists the records over the card's memory (``HW().hbm_bytes``); run as a
script it prints the summary, the dry-run table and a roofline table a
mesh::

    python -m repro_torch.launch.report [tag]
"""
from __future__ import annotations

import glob
import json
import os

from repro_torch.launch.roofline import HW, model_flops

__all__ = ["RESULTS", "dryrun_markdown", "load", "roofline_markdown",
           "summarize"]

RESULTS = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "results", "torch_dryrun")

SHAPE_ORDER = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def _refresh_model_metrics(rec: dict) -> dict:
    """Recompute the MODEL_FLOPS-derived fields from the config (robust to
    cost model fixes without counting the step again)."""
    if rec.get("status") != "ok":
        return rec
    from repro_torch.configs import SHAPES, get_config
    r = rec["roofline"]
    mf = model_flops(get_config(rec["arch"]), SHAPES[rec["shape"]])
    chips = r["chips"]
    flops = r["hlo_gflops"] * 1e9
    terms = dict(compute=r["t_compute"], memory=r["t_memory"],
                 collective=r["t_collective"])
    t_useful = mf / chips / HW().peak_flops
    r["model_gflops"] = mf / 1e9
    r["useful_ratio"] = mf / max(flops * chips, 1.0)
    r["roofline_frac"] = t_useful / max(terms[r["bottleneck"]], 1e-30)
    return rec


def load(tag: str = "") -> list[dict]:
    """The records of ``tag`` in :data:`RESULTS`, refreshed, sorted by
    arch, shape and mesh."""
    out = []
    for p in sorted(glob.glob(os.path.join(RESULTS, "*.json"))):
        with open(p) as f:
            rec = json.load(f)
        if rec.get("tag", "") != tag:
            continue
        out.append(_refresh_model_metrics(rec))
    out.sort(key=lambda r: (r["arch"], SHAPE_ORDER.index(r["shape"])
                            if r["shape"] in SHAPE_ORDER else 9, r["mesh"]))
    return out


def roofline_markdown(tag: str = "", mesh: str = "1") -> str:
    rows = ["| arch | shape | comp (ms) | mem (ms) | coll (ms) | bottleneck "
            "| roofline | useful | GiB/dev |",
            "|---|---|---|---|---|---|---|---|---|"]
    for rec in load(tag):
        if rec["mesh"] != mesh:
            continue
        if rec["status"] == "skipped":
            rows.append(f"| {rec['arch']} | {rec['shape']} | — | — | — | "
                        f"skipped | — | — | — |")
            continue
        if rec["status"] != "ok":
            rows.append(f"| {rec['arch']} | {rec['shape']} | ERROR | | | | "
                        f"| | |")
            continue
        r = rec["roofline"]
        rows.append(
            f"| {rec['arch']} | {rec['shape']} "
            f"| {r['t_compute']*1e3:.1f} | {r['t_memory']*1e3:.1f} "
            f"| {r['t_collective']*1e3:.1f} | {r['bottleneck']} "
            f"| {r['roofline_frac']:.3f} | {r['useful_ratio']:.2f} "
            f"| {r['bytes_per_device']/2**30:.2f} |")
    return "\n".join(rows)


def dryrun_markdown(tag: str = "") -> str:
    rows = ["| arch | shape | mesh | status | lower (s) | compile (s) | "
            "GiB/dev | coll GB/dev |",
            "|---|---|---|---|---|---|---|---|"]
    for rec in load(tag):
        if rec["status"] == "skipped":
            rows.append(f"| {rec['arch']} | {rec['shape']} | {rec['mesh']} "
                        f"| skipped ({rec['reason'].split(':')[0]}) | | | | |")
            continue
        if rec["status"] != "ok":
            rows.append(f"| {rec['arch']} | {rec['shape']} | {rec['mesh']} "
                        f"| **ERROR** | | | | |")
            continue
        r = rec["roofline"]
        rows.append(
            f"| {rec['arch']} | {rec['shape']} | {rec['mesh']} | ok "
            f"| {rec['lower_s']:.1f} | {rec['compile_s']:.1f} "
            f"| {r['bytes_per_device']/2**30:.2f} | {r['coll_gbytes']:.1f} |")
    return "\n".join(rows)


def summarize(tag: str = "") -> dict:
    recs = load(tag)
    ok = [r for r in recs if r["status"] == "ok"]
    return dict(
        total=len(recs), ok=len(ok),
        skipped=sum(r["status"] == "skipped" for r in recs),
        error=sum(r["status"] == "error" for r in recs),
        over_hbm=[f"{r['arch']}/{r['shape']}/{r['mesh']}" for r in ok
                  if r["roofline"]["bytes_per_device"] > HW().hbm_bytes],
    )


if __name__ == "__main__":
    import sys
    tag = sys.argv[1] if len(sys.argv) > 1 else ""
    print(json.dumps(summarize(tag), indent=1))
    print(dryrun_markdown(tag))
    for mesh in sorted({r["mesh"] for r in load(tag)}):
        print(f"\nmesh {mesh}\n{roofline_markdown(tag, mesh)}")
