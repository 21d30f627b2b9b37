"""Test configuration: run everything on a virtual 8-device CPU mesh.

Tests are hermetic and need no accelerator; multi-device sharding paths
run on ``--xla_force_host_platform_device_count=8``.  The GPU path is
checked by ``python chip_smoke.py`` on a machine with a card.

``JAX_PLATFORMS`` is set and the jax config is updated before any backend
is initialized, so the tests stay on the CPU whatever the environment says.
The persistent compilation cache is switched off: the CLIs enable it by
default, and tests must not write compiled programs into the checkout.
"""

import os

xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_compilation_cache", False)

import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Release compiled executables at module boundaries.

    One full-suite process accumulates many hundreds of XLA CPU executables;
    past ~240 tests the NEXT compilation segfaults inside
    ``backend_compile_and_load`` (reproduced twice at the same test, while
    the same test passes at file scope — a cumulative-state crash in the
    CPU JIT, not a bug in the test).  Dropping the jit caches between
    modules keeps the in-process executable population bounded.  Tests
    never share compiled functions across modules, so the only cost is
    recompiling common helpers (renderer, pyramid) per module.
    """
    yield
    jax.clear_caches()
