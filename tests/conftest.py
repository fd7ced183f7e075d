"""Shared fixtures.  NOTE: no XLA_FLAGS here — smoke tests must see the
real single CPU device; only launch/dryrun.py forces 512 placeholders."""
import pathlib
import sys

import numpy as np
import pytest

# --- hypothesis fallback -----------------------------------------------------
# Property tests import hypothesis at module scope; environments without it
# (see requirements-dev.txt) must still *collect and run* the suite, so when
# the real package is absent we install tests/_hypothesis_fallback.py in its
# place: same decorator API, deterministic example batches, no search.
try:
    import hypothesis  # noqa: F401
except ImportError:                                        # pragma: no cover
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
    import _hypothesis_fallback as _hf

    sys.modules["hypothesis"] = _hf
    sys.modules["hypothesis.strategies"] = _hf.strategies


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running integration test")
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc (skips without one)")
