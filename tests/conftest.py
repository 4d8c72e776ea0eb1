"""Test configuration: run on a virtual 8-device CPU mesh.

Tests run on the CPU, where the Pallas kernels run in interpret mode
(mirrors the reference's RAYCORE_TEST_BACKEND matrix, test/runtests.jl:
31-45 — our 'cpu' lane). Tests that need the GPU carry the ``gpu`` marker
and take the ``gpu`` fixture, which skips them when JAX finds no GPU; run
them on the card with ``python -m pytest tests -m gpu`` without
JAX_PLATFORMS=cpu.
"""
import os

# Fresh per-session capacity-hint store: hints persist across processes by
# design (ops/capacity_store.py), but tests assert cold-routing states.
import tempfile  # noqa: E402
os.environ["RAYCORE_CAPACITY_DIR"] = tempfile.mkdtemp(
    prefix="raycore_caphints_")

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    # Two tiers: `pytest -m "not slow"` is the fast CI-style lane; the
    # full suite is the merge gate.
    config.addinivalue_line(
        "markers", "slow: heavyweight test (full-suite tier only; "
        "deselect with -m 'not slow')")
    config.addinivalue_line(
        "markers", "gpu: needs a GPU; skips elsewhere (see the gpu "
        "fixture)")


@pytest.fixture
def gpu():
    """The first GPU device; skips the test when JAX finds none."""
    devices = [d for d in jax.devices() if d.platform == "gpu"]
    if not devices:
        pytest.skip("needs a GPU: JAX finds none here")
    return devices[0]


@pytest.fixture
def rng():
    return np.random.default_rng(1234)
