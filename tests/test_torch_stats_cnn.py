"""The port's ``models.cnn.run_with_stats`` against the JAX package's on
``tests/test_torch_cnn.py``'s specs, on the same numpy inputs, CPU only:
the static fields and the traced counts of every compute layer exactly
the JAX package's, the logits bitwise the port's own forward.  (The rest
of the event accounting is ``tests/test_torch_stats.py``.)
"""
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import cnn as jcnn
from repro_torch.models import cnn as tcnn

from test_torch_cnn import SPECS

# by module path: both packages' ``core`` re-export a function ``fire``
jfire = importlib.import_module("repro.core.fire")
tfire = importlib.import_module("repro_torch.core.fire")


def _image(seed, spec, batch=2):
    size = spec.input_size
    return np.maximum(np.random.default_rng(seed).normal(
        size=(batch, size, size, spec.in_ch)), 0).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _cnn_stats(name, threshold):
    jspec, tspec = SPECS[name]
    params = jcnn.init_cnn_params(jax.random.PRNGKey(7), jspec,
                                  weight_sparsity=0.5)
    x = _image(7, tspec)
    fc = jfire.FireConfig(threshold=threshold)
    _, jstats = jcnn.run_with_stats(params, jnp.asarray(x), jspec,
                                    fire_cfg=fc)
    tparams = tcnn.params_from_numpy([None if p is None else np.asarray(p)
                                      for p in params])
    tfc = tfire.FireConfig(threshold=threshold)
    y, tstats = tcnn.run_with_stats(tparams, torch.from_numpy(x), tspec,
                                    fire_cfg=tfc, device="cpu")
    y_fwd = tcnn.cnn_forward(tparams, torch.from_numpy(x), tspec,
                             fire_cfg=tfc, device="cpu")
    return jstats, tstats, y, y_fwd


@pytest.mark.parametrize("threshold", [0.0, 0.05])
@pytest.mark.parametrize("name", sorted(SPECS))
def test_run_with_stats_counts_equal_jax(name, threshold):
    """Every field of every compute layer's stats exactly the JAX
    package's: the static ones, the traced counts, the densities and
    ``avg_touched``."""
    jstats, tstats, _, _ = _cnn_stats(name, threshold)
    assert len(tstats) == len(jstats)
    for i, (t, j) in enumerate(zip(tstats, jstats)):
        assert set(t) == set(j), i
        for key in j:
            assert t[key] == j[key], (i, key, t[key], j[key])


@pytest.mark.parametrize("name", sorted(SPECS))
def test_run_with_stats_logits_bitwise_cnn_forward(name):
    _, _, y, y_fwd = _cnn_stats(name, 0.0)
    assert torch.equal(y.view(torch.int32), y_fwd.view(torch.int32))
