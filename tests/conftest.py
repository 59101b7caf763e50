import os

# Tests run on the single real CPU device (the dry-run subprocess sets its own
# XLA_FLAGS).  Keep x64 off and make test ordering deterministic.
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running (production dry-run subprocess)"
    )
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (skips without one)"
    )


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def key():
    return jax.random.key(0)


def tiny_dense(**kw):
    from repro.configs.base import ModelConfig

    base = dict(
        name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab_size=256, tie_embeddings=True,
    )
    base.update(kw)
    return ModelConfig(**base)
