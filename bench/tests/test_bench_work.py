"""The useful-work counter against a brute-force count: every output
position, every tap, every channel, on a tiny net with strides, borders
and padding."""
import pytest
import torch

from bench_testlib import BENCH  # noqa: F401  (the harness on sys.path)
from mnfbench import inputs, spec, work

NET = {
    "name": "counted", "input_size": 9, "in_ch": 2, "num_classes": 5,
    "weight_sparsity": 0.5, "activation_sparsity": 0.5,
    "layers": [
        {"kind": "conv", "out": 3, "k": 3, "stride": 2, "padding": 1},
        {"kind": "conv", "out": 4, "k": 3, "stride": 1, "padding": 0},
        {"kind": "pool", "k": 2, "stride": 1},
        {"kind": "conv", "out": 4, "k": 2, "stride": 1, "padding": 1},
        {"kind": "fc", "out": 6},
        {"kind": "fc", "out": 5},
    ],
}


def brute(layer, a):
    """(macs, rows needed) of one image's conv input a (C, H, W)."""
    c, h, w = a.shape
    k, s, p = layer["k"], layer["stride"], layer["padding"]
    oh, ow = (h + 2 * p - k) // s + 1, (w + 2 * p - k) // s + 1
    macs, rows = 0, set()
    for oy in range(oh):
        for ox in range(ow):
            for ky in range(k):
                for kx in range(k):
                    y, x = oy * s - p + ky, ox * s - p + kx
                    if not (0 <= y < h and 0 <= x < w):
                        continue
                    for ci in range(c):
                        if a[ci, y, x] != 0:
                            macs += layer["out"]
                            rows.add((ky * k + kx) * c + ci)
    return macs, rows


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_counter_equals_brute_force(seed):
    ref = spec.reference("cnn")
    params = inputs.make_weights(NET, seed, "cpu")
    x = inputs.make_pool(NET, 3, seed, "cpu")
    acts = []
    ref.forward(NET, params, x,
                hook=lambda i, layer, a, w: acts.append(a.clone()))
    counted = ref.count_work(NET, params, x)
    assert len(counted) == len(NET["layers"])
    for layer, a, d in zip(NET["layers"], acts, counted):
        for b in range(x.shape[0]):
            nnz = int((a[b] != 0).sum())
            assert d["nnz"][b].item() == nnz
            if layer["kind"] == "conv":
                macs, rows = brute(layer, a[b])
                got = set(torch.nonzero(d["rows"][b]).flatten().tolist())
                assert d["macs"][b].item() == macs and got == rows
            elif layer["kind"] == "fc":
                assert d["macs"][b].item() == nnz * layer["out"]
                assert torch.equal(d["rows"][b], a[b] != 0)
            else:
                assert d["macs"][b].item() == 0 and d["rows"] is None


def test_batch_work_sums_layers_and_reads_each_needed_row_once():
    ref = spec.reference("cnn")
    params = inputs.make_weights(NET, 4, "cpu")
    x = inputs.make_pool(NET, 4, 4, "cpu")
    w = work.batch_work(NET, params, x, ref)
    counted = ref.count_work(NET, params, x)
    for d, layer in zip(counted, w["layers"]):
        nbytes = float(d["nnz"].sum()) * 8 + 4 * 4 * d["outs"]
        if d["rows"] is not None:
            nbytes += float(d["rows"].any(0).sum()) * d["row_len"] * 4
        assert layer["bytes"] == nbytes
        assert layer["flops"] == 2 * float(d["macs"].sum())
    assert w["flops"] == sum(x["flops"] for x in w["layers"])
    assert w["bound_s"] >= max(x["bound_s"] for x in w["layers"])
