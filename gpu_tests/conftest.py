"""GPU lane: run on a machine whose JAX sees a GPU (``make gpu-test``).

Unlike tests/conftest.py this does not force the CPU.  Whether a GPU is
present is decided inside a fixture, so every worker collects the same
tests; without one each test skips with the reason."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.fixture(autouse=True, scope="session")
def _gpu_present():
    import jax

    from hullwhite_tpu.backend import enable_compile_cache

    if jax.devices()[0].platform != "gpu":
        pytest.skip(f"needs a GPU; JAX sees {jax.devices()[0].platform}")
    enable_compile_cache()
