"""The port's training loss against the JAX package's for the last five
architectures of ``ARCH_IDS`` (whisper-base's encoder-decoder,
phi-3-vision's patch tokens, Hymba's parallel Mamba heads through B10's
differentiable plain version, MLA and the two MoE configs): the checks of
``tests/test_torch_train_loss.py`` (f32 loss and gradients within 1e-4
of max|JAX|, the bf16 loss within 3e-2 or JAX's own bf16-to-f32 gap),
and for the MoE configs the auxiliary loss that the forward sums within
1e-6 of the JAX forward's, and ``lm_loss`` adding 0.01 of it.
"""
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro_torch.models import transformer as ttfm

from test_torch_train_loss import (_torch_batch, cfg_pair, check_bf16,
                                   check_f32, jax_side)

ARCHS = ARCH_IDS[5:]


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_grads_match_jax_f32(arch):
    check_f32(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_matches_jax_bf16(arch):
    check_bf16(arch)


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b",
                                  "deepseek-moe-16b"])
def test_moe_aux_equals_jax_and_enters_the_loss(arch):
    params, batch, _, _, _, jaux = jax_side(arch)
    _, tc = cfg_pair(arch, "float32")
    tp = ttfm.params_from_numpy(params, tc, "cpu")
    tb = _torch_batch(batch, tc)
    h, _, aux = ttfm._forward(tp, tb["tokens"], tc)
    assert abs(float(aux) - jaux) <= 1e-6 * abs(jaux)
    loss = ttfm.lm_loss(tp, tb, tc)
    xent = loss - 0.01 * aux
    # the cross-entropy part is the mean over the 61 labels left in
    labels = tb["labels"]
    logits = ttfm.unembed_logits(tp, h, tc)
    lse = torch.logsumexp(logits, -1)
    ll = logits.gather(-1, labels.clamp(min=0).long()[..., None])[..., 0]
    want = torch.where(labels >= 0, lse - ll, 0.0).sum() / (labels >= 0).sum()
    np.testing.assert_allclose(float(xent), float(want), rtol=1e-6)
