"""Test configuration: run on a virtual 8-device CPU mesh with x64 enabled.

Multi-device sharding is validated on host CPU devices; numerical parity
tests use float64 oracles. Env vars are set too late here (a pytest plugin
imports jax before conftest), so we use jax.config.update, which works any
time before the backend is first initialized.

``JAX_PLATFORMS=cuda`` leaves the GPU in place for the ``gpu``-marked tests
(``python -m pytest tests/ -m gpu`` on the card); everywhere else those
tests skip inside the ``gpu`` fixture.
"""
import os
import tempfile

import pytest

ON_GPU = os.environ.get("JAX_PLATFORMS") in ("cuda", "gpu")
if not ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"  # for any late spawned code paths
# a fixed compile cache outside the checkout: test runs must not grow the
# tree (slamtpu.runtime.jaxcache then sets nothing)
os.environ["JAX_COMPILATION_CACHE_DIR"] = os.path.join(
    tempfile.gettempdir(), "slamtpu-tests-jax-cache"
)

import jax

if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_enable_x64", True)
jax.config.update(
    "jax_compilation_cache_dir", os.environ["JAX_COMPILATION_CACHE_DIR"]
)


@pytest.fixture
def gpu():
    """Skips the test unless JAX runs on an NVIDIA GPU."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (JAX_PLATFORMS=cuda pytest -m gpu)")


def pytest_sessionstart(session):
    if ON_GPU:
        return
    assert jax.default_backend() == "cpu", (
        f"tests must run on CPU, got {jax.default_backend()}"
    )
    assert jax.device_count() == 8, f"expected 8 CPU devices, got {jax.device_count()}"
