"""Test configuration: force an 8-device virtual CPU mesh before JAX initializes.

Multi-device sharding tests run against ``jax.sharding.Mesh`` over 8 virtual
CPU devices (no accelerator needed), per SURVEY.md §4.  Tests that need a GPU
carry the ``gpu`` marker and skip here (see the ``gpu`` fixture).
"""

import os

# CPU unless the caller names a platform: the GPU tier runs as
# ``JAX_PLATFORMS=cuda,cpu python -m pytest tests/ -m gpu`` (README).
os.environ.setdefault("JAX_PLATFORMS", "cpu")
xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
jax.config.update("jax_threefry_partitionable", True)


import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Free compiled executables after each test module.

    The suite compiles hundreds of large programs; with the jit cache
    holding every one of them, memory grows over a full run.  Cross-module
    cache reuse is ~nil, so clearing per module costs little."""
    yield
    jax.clear_caches()


@pytest.fixture
def gpu():
    """The GPU that a ``gpu``-marked test runs on; skips where there is none."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs a GPU (JAX_PLATFORMS=cuda,cpu python -m pytest "
                    "tests/ -m gpu)")
    return dev
