"""Quickstart of the port: the Multiply-and-Fire pipeline in five minutes —
the twin of ``examples/quickstart.py`` on ``repro_torch``.

1. Build a sparse activation map and encode it as block events (the
   paper's compressed storage scheme, tiled).
2. Run the multiply phase through the engine API (``repro_torch.engine``)
   on ``backend="auto"``: ``cuda`` (the hand-written kernels) on the card,
   ``block`` (their plain PyTorch versions) on CPU tensors; check it
   against the dense product.
3. Run the fire phase: ``engine.fire`` returns an ``EventStream`` that
   feeds the second layer directly (no decode and re-encode between
   layers).
4. Price a layer with the paper's cost model (model numbers of the
   paper's 200 MHz ASIC, not times on the card).

    PYTHONPATH=src python examples/torch_quickstart.py
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""
import argparse

import numpy as np
import torch

from repro_torch import engine
from repro_torch.core.events import encode_block_events
from repro_torch.costmodel import ConvShape, compare_dataflows, \
    mnf_layer_cycles
from repro_torch.device import default_device


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                         "plain versions)")
    args = ap.parse_args(argv)
    dev = default_device() if args.device is None \
        else torch.device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 products in f32
    rng = np.random.default_rng(0)

    # --- a sparse activation matrix (post-ReLU, like a deep CNN layer).
    # Block events live at tile granularity, so channel-structured sparsity
    # (whole channel groups silent) is what the block encoding rides.
    m, k, n = 64, 1024, 512
    acts = rng.normal(size=(m, k)).astype(np.float32)
    acts *= rng.random((1, k // 128, 1)).repeat(128, 1).reshape(1, k) > 0.6
    acts *= rng.random((m, k)) > 0.3
    acts = np.abs(acts)
    w1 = (rng.normal(size=(k, n)) / np.sqrt(k)).astype(np.float32)
    w2 = (rng.normal(size=(n, n)) / np.sqrt(n)).astype(np.float32)
    a_t = torch.from_numpy(acts).to(dev)
    w1_t, w2_t = torch.from_numpy(w1).to(dev), torch.from_numpy(w2).to(dev)

    # --- event encoding: how many weight tiles does MNF even touch? ---
    ev = encode_block_events(a_t, blk_m=8, blk_k=128)
    live = float(ev.counts.sum()) / (ev.block_idx.shape[0]
                                     * ev.num_k_blocks)
    print(f"activation density {np.mean(acts != 0):.2f} -> "
          f"{live:.2f} of weight tiles are event-addressed "
          f"({1 - live:.0%} of tile loads + multiplies skipped)")

    # --- the engine: one config; the operands' device picks the backend
    cfg = engine.EngineConfig(backend="auto", blk_m=8, blk_k=128)
    print("engine:", engine.describe(cfg, dev))

    # --- multiply phase via the engine ---
    y = engine.linear(a_t, w1_t, cfg=cfg)
    dense = a_t @ w1_t
    print("multiply phase == dense:",
          bool(torch.allclose(y, dense, atol=1e-3)))

    # --- fire phase: threshold + events for the next layer, chained ---
    stream = engine.fire(y, cfg)
    print(f"fired {float((stream.dense() > 0).float().mean()):.2f} of "
          f"outputs to layer 2 ({int(stream.num_events)} block events, "
          f"occupancy {float(stream.occupancy()):.2f})")
    # the EventStream feeds layer 2's multiply phase directly: activations
    # stay compressed between layers (the paper's end-to-end dataflow)
    y2 = engine.linear(stream, w2_t, cfg=cfg)
    print("layer-2 output:", tuple(y2.shape))

    # --- what does this cost on the paper's accelerator? ---
    shape = ConvShape(in_ch=256, out_ch=384, in_size=56, out_size=56, k=3)
    for d in (1.0, 0.3, 0.1):
        e = compare_dataflows(shape, d_act=d, d_w=0.6)
        print(f"density {d:.1f}: energy/layer  "
              + "  ".join(f"{kk}={vv/1e6:.1f}uJ" for kk, vv in e.items()))
    cyc = mnf_layer_cycles(n_events=float((acts != 0).sum()), avg_touched=9,
                           c_out=n)
    print(f"MNF multiply-phase cycles for this layer: {cyc:,.0f} "
          f"(@200 MHz = {cyc/200e3:.2f} ms on the paper's ASIC)")


if __name__ == "__main__":
    main()
