"""Test harness: force JAX onto a virtual 8-device CPU mesh so sharding and
collectives are exercised without accelerator hardware (SURVEY.md §4).

Tests that need the card carry the ``gpu`` marker and take the ``gpu``
fixture, which skips them here; on a machine with a GPU run them with
``python -m pytest tests/ -m gpu -p no:xdist`` after unsetting the CPU pin
(``MITOFLEX_TEST_ON_GPU=1``)."""

import os

if os.environ.get("MITOFLEX_TEST_ON_GPU") != "1":
    os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

if os.environ.get("MITOFLEX_TEST_ON_GPU") != "1":
    jax.config.update("jax_platforms", "cpu")

from mitoflex_tpu.utils import compile_cache  # noqa: E402

compile_cache.enable()  # persistent XLA cache: repeat suite runs skip compiles

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where JAX sees none. Decided
    here, at run time, never while a module is imported."""
    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("needs a GPU (JAX sees none)")
    return devs[0]


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running realistic-scale validation"
    )
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skipped where JAX sees none"
    )
