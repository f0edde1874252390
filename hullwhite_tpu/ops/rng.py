"""Counter-based RNG plumbing.

Replaces the reference's stateful cuRAND machinery (``init_rng`` +
per-thread ``curandState``, common.cuh:277-280) with JAX's counter-based
keys:

* per-block draws come from ``fold_in(key, block_index)`` — no state arrays,
  no init kernel;
* Common Random Numbers (reference 3_sensitivity_analysis.cu:407-435, a
  device-to-device backup/restore of 2^20 cuRAND states) are *free*: the
  same key always reproduces the same Gaussians;
* antithetic pairing (market_data.cuh:38-55) never draws the second leg —
  engines evaluate both +G and -G from one draw.

Two implementations are exposed:

* ``threefry2x32`` (default) — fully reproducible across backends, used by
  tests;
* ``rbg`` — XLA's RngBitGenerator (not reproducible across backends).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def make_key(seed: int, impl: str = "threefry2x32"):
    return jax.random.key(seed, impl=impl)


def block_normals(key, block_index, shape, dtype=jnp.float32):
    """Gaussian shocks for one path block: G ~ N(0,1), shape (block, steps).

    Deterministic in (key, block_index): the sharded and single-device
    drivers produce identical draws for identical (key, global block index),
    which makes multi-device results bitwise-comparable to single-device
    ones per block.
    """
    k = jax.random.fold_in(key, block_index)
    return jax.random.normal(k, shape, dtype=dtype)
