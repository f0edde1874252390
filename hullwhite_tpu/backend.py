"""Platform decisions in one place: the default engine per platform, the
engine names the pricers accept, the persistent compile cache, device
provisioning for path-sharded meshes, and the card's name and power
limit for the records.

Nothing else in the package reads ``jax.devices()[0].platform`` to pick
a code path.
"""

from __future__ import annotations

import os
import subprocess

import jax

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"

# Every engine is plain XLA and prices every product.  (A Pallas-on-
# Triton curve kernel lost to "exact" ~8x on the H100: PERF.md.)
ENGINES = ("linear", "scan", "exact")

# platform -> default engine (the on-card timing that chose it: PERF.md)
DEFAULT_ENGINE = {"cpu": "exact", "gpu": "exact"}


def default_engine(platform: str | None = None) -> str:
    """Default engine on ``platform`` (the first device's platform when
    omitted).  Unknown platforms raise: there is no silent fallback."""
    if platform is None:
        platform = jax.devices()[0].platform
    if platform not in DEFAULT_ENGINE:
        raise ValueError(f"no engine for platform {platform!r}; "
                         f"supported: {sorted(DEFAULT_ENGINE)}")
    return DEFAULT_ENGINE[platform]


def check_engine(engine: str) -> str:
    """Return ``engine`` if it exists, else raise: a name without an
    implementation is never swapped for another engine."""
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; choose from {ENGINES}")
    return engine


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its path.

    ``JAX_COMPILATION_CACHE_DIR`` wins when set (JAX reads it itself, so
    nothing else is configured).  Otherwise the cache is the fixed
    ``<repo>/.jax_cache`` (a fixed path, because the path is part of what
    makes a later run hit)."""
    env = os.environ.get(CACHE_ENV)
    if env:
        return env
    path = os.path.join(REPO_ROOT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return path


def mesh_devices(n_devices: int):
    """The first ``n_devices`` devices for a path-sharded mesh.

    On the CPU platform too few devices are made up by re-initialising
    the CPU backend with ``n_devices`` virtual devices (the test and CI
    configuration).  On any accelerator too few devices is an error: a
    four-card run must never quietly become a CPU run."""
    have = jax.devices()
    if len(have) < n_devices and have[0].platform == "cpu":
        from jax._src import xla_bridge as _xb

        _xb._clear_backends()
        _xb.get_backend.cache_clear()
        jax.config.update("jax_num_cpu_devices", n_devices)
        have = jax.devices()
    if len(have) < n_devices:
        raise RuntimeError(f"need {n_devices} {have[0].platform} devices, "
                           f"have {len(have)}")
    return have[:n_devices]


def card_info() -> str:
    """Each GPU's ``name, power.limit`` as ``nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader`` prints it, one line per card
    (a card may be capped below its maximum power and then runs slower,
    so every timing is recorded beside this)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"
    return out.strip() or "?"
