"""Test configuration: run on a virtual 8-device CPU mesh.

Must set XLA flags BEFORE jax initializes its backends. GPU measurements
live in bench.py / chip_smoke.py, not the test suite (reference test
strategy: SURVEY.md §4).
"""
import os

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                           " --xla_force_host_platform_device_count=8")
os.environ["JAX_PLATFORMS"] = "cpu"

import jax

jax.config.update("jax_platforms", "cpu")
# float64 on CPU for exactness thresholds (reference tests are float64)
jax.config.update("jax_enable_x64", True)

import pytest  # noqa: E402
import numpy as np  # noqa: E402


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(42)
