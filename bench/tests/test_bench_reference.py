"""The plain reference computes the network the port computes: on the
port's MINI net, its CPU ``block`` backend (the chained event path) and
the reference agree on the same weights and images."""
import pytest
import torch

from bench_testlib import tiny_config
from mnfbench import inputs, spec


@pytest.mark.parametrize("seed", [0, 5, 2**32 + 9])
def test_reference_agrees_with_the_port_on_mini(seed):
    from repro_torch.models import cnn

    cfg = tiny_config()
    ref = spec.reference("cnn")
    params = inputs.make_weights(cfg, seed, "cpu")
    x = inputs.make_pool(cfg, 6, seed, "cpu")
    want = ref.forward(cfg, params, x)
    got = cnn.cnn_forward(params, x, cnn.MINI, device="cpu")
    scale = float(want.abs().max())
    assert want.shape == got.shape == (6, 10)
    assert float((got - want).abs().max()) <= 1e-5 * scale


def test_tf32_control_rounds_the_operands():
    ref = spec.reference("cnn")
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 2**-10 + 2**-11,
                      -3.0000001, 0.0])
    r = ref._tf32_round(x)
    assert r.tolist() == [1.0, 1.0, 1.0 + 2**-9, -3.0, 0.0]
