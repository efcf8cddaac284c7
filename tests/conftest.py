"""Test configuration: an 8-virtual-device CPU platform, so sharding tests
run without accelerators.  JAX_PLATFORMS naming cuda (as in
`JAX_PLATFORMS=cuda,cpu pytest -m gpu`) keeps the GPU; tests that need
it take the `gpu` fixture, which skips when no card is present.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

if "cuda" not in os.environ.get("JAX_PLATFORMS", ""):
    jax.config.update("jax_platforms", "cpu")

import pytest  # noqa: E402


@pytest.fixture(scope="session")
def rng():
    import numpy as np

    return np.random.default_rng(12345)


@pytest.fixture(scope="session")
def gpu():
    """The first GPU device; skips the test where there is none."""
    cards = [d for d in jax.devices() if d.platform == "gpu"]
    if not cards:
        pytest.skip("needs an NVIDIA GPU: JAX_PLATFORMS=cuda,cpu "
                    "pytest -m gpu -n 0")
    return cards[0]
