"""Test configuration.

Tests run on the CPU (``JAX_PLATFORMS=cpu``) with an 8-device virtual
mesh, so the suite is hermetic and the multi-device sharding tests have
devices to shard over.  The persistent compile cache stays off here:
CPU executables in it are specific to the host's CPU features.

Tests that need the card carry the ``gpu`` marker and skip elsewhere;
``python chip_smoke.py`` runs them on a GPU as one of its phases.
"""
import os

os.environ.setdefault("XLA_FLAGS",
                      os.environ.get("XLA_FLAGS", "")
                      + " --xla_force_host_platform_device_count=8")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402


# Two-tier suite: the default run skips tests marked ``slow`` (heavy
# model/serving geometries whose features also have light smoke
# coverage) so the routine gate finishes in minutes; set
# QUTLASS_TPU_TEST_FULL=1 for the complete suite (CI / pre-release).
_FULL = os.environ.get("QUTLASS_TPU_TEST_FULL", "") not in ("", "0")


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: heavy test, skipped by default; QUTLASS_TPU_TEST_FULL=1 "
        "(or -m slow) runs it")
    config.addinivalue_line(
        "markers",
        "gpu: needs an NVIDIA GPU (compiled kernels); skipped elsewhere, "
        "run on the card by chip_smoke.py")


def pytest_collection_modifyitems(config, items):
    if _FULL or config.getoption("-m"):
        return  # explicit -m selection overrides the tiering
    skip = pytest.mark.skip(
        reason="slow tier (set QUTLASS_TPU_TEST_FULL=1)")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)


@pytest.fixture(autouse=True)
def _seed_each_test():
    np.random.seed(0)


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skip ``gpu``-marked tests unless JAX's backend is a GPU (decided
    when the test runs, never at import or collection)."""
    if (request.node.get_closest_marker("gpu")
            and jax.default_backend() != "gpu"):
        pytest.skip("needs an NVIDIA GPU (run: python chip_smoke.py)")


@pytest.fixture
def on_gpu():
    return jax.default_backend() == "gpu"
