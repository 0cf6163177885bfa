"""Test configuration: run everything on a virtual 8-device CPU mesh.

Must set the env vars before jax is imported anywhere in the test process.
"""

import os

# A pytest plugin may import jax before this conftest runs, so the env vars
# alone are not enough. Backends initialize lazily, so forcing the platform
# through jax.config here (before any device query) still works.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("JAX_PLATFORM_NAME", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_ENABLE_X64", "0")

import jax

jax.config.update("jax_platform_name", "cpu")
jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Release compiled executables at module boundaries.

    The full suite compiles ~hundreds of XLA:CPU programs in one
    process; past ~240 tests the accumulated live executables
    deterministically SIGSEGV'd the next compile inside
    backend_compile_and_load (7.9 GB RSS on a 132 GB host, so not
    memory pressure; the same tests pass in isolation). Dropping caches per
    module keeps the live-executable count bounded; repeated shapes
    recompile, which costs ~tens of seconds across the suite."""
    yield
    jax.clear_caches()


@pytest.fixture
def rng():
    return np.random.default_rng(0)
