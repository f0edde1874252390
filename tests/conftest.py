"""Test configuration: force an 8-device virtual CPU platform so sharding
paths are exercised without an accelerator (SURVEY §4 implication)."""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
# the persistent-cache AOT loader logs a noisy (and wrong) machine-feature
# comparison at ERROR level on every load; real failures surface as Python
# exceptions, so silence the C++ log stream for test runs
os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "3")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

# jax may already be imported (e.g. by a plugin) before the env vars
# above are read, so force the platform via config too.
jax.config.update("jax_platforms", "cpu")

import pytest  # noqa: E402

from hullwhite_tpu import tiny_config  # noqa: E402
from hullwhite_tpu.backend import enable_compile_cache  # noqa: E402

# Persistent XLA compilation cache: the module-scoped jax.clear_caches()
# below (needed to bound live JIT code) would otherwise force full
# recompiles of near-identical programs in every module — the dominant
# quick-lane cost.  JAX_COMPILATION_CACHE_DIR wins when set; otherwise
# the cache is <repo>/.jax_cache.
enable_compile_cache()


@pytest.fixture(scope="session")
def cfg():
    return tiny_config()


@pytest.fixture(scope="session")
def key():
    return jax.random.key(1234)


@pytest.fixture(autouse=True, scope="module")
def _bound_compile_cache():
    """Free compiled XLA executables after each test module.

    One pytest process compiles several hundred distinct jitted kernels
    across the suite; on the CPU backend the accumulated JIT code
    eventually segfaults inside a later compile (reproducibly at the
    ~250th test, twice, and never in isolation).  Modules mostly reuse
    their own kernels, so clearing between modules bounds live code at
    a small recompile cost."""
    yield
    jax.clear_caches()
