"""Device mesh + path-axis sharding.

The reference is single-GPU (SURVEY §2.9): its only parallelism is data
parallelism over Monte Carlo paths, with a warp-shuffle/shared-memory/atomic
reduction hierarchy inside the device.  Here the same decomposition
becomes:

* within a device: ``jnp.sum`` over the path block (an XLA tree
  reduction) — replaces warp shuffles + shared memory + atomics;
* across devices: ``lax.psum`` over a 1-D ``Mesh`` (NCCL over NVLink on
  a multi-GPU host) — a capability the reference does not have (it pins
  one GPU, makefile:27).

Paths are embarrassingly parallel until the final reduction, so the mesh is
one axis ("paths") and every collective is a single psum of a tiny vector
(<= n_mat floats) per pricing call.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

AXIS = "paths"


def path_mesh(devices=None) -> Mesh:
    """1-D mesh over all (or the given) devices, axis name 'paths'."""
    import numpy as np

    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (AXIS,))


def device_count(mesh: Mesh | None) -> int:
    return 1 if mesh is None else mesh.devices.size


def map_blocks(block, n_blocks: int, mesh: Mesh | None):
    """``lax.map(block, arange(n_blocks))`` with the block axis optionally
    shard_mapped over the mesh.

    ``block(b) -> (k,)`` must derive all randomness from the GLOBAL block
    index ``b`` (fold_in), so the sharded result is the same (n_blocks, k)
    stack a single device produces — the library-wide deterministic
    scale-out invariant.  Used by the Bermudan evaluation passes, whose
    RQMC SE needs the per-block rows (not just their psum)."""
    if mesh is None:
        if n_blocks == 1:
            # lax.map compiles its body as a separate scan computation,
            # blocking fusion with the surrounding graph — measured ~2x
            # on the multi-date exotic kernels for the common 1-block case
            return block(jnp.int32(0))[None]
        return lax.map(block, jnp.arange(n_blocks))
    ndev = mesh.devices.size
    if n_blocks % ndev != 0:
        raise ValueError(
            f"n_blocks={n_blocks} must divide over {ndev} devices")
    per_dev = n_blocks // ndev

    @partial(
        jax.shard_map, mesh=mesh,
        in_specs=P(), out_specs=P(AXIS),
        check_vma=False,
    )
    def body(dummy):
        d = lax.axis_index(AXIS)
        return lax.map(block, d * per_dev + jnp.arange(per_dev))

    return body(jnp.zeros((), jnp.int32))


def shard_blocks(local_fn, mesh: Mesh | None):
    """Wrap ``local_fn(key, base_block, n_blocks) -> (k,) partial sums`` into
    a mesh-wide psum-reduced runner.

    ``local_fn`` must derive all randomness from the *global* block index
    ``base_block + i`` so the sharded run consumes exactly the same Gaussian
    blocks as a single-device run (deterministic scale-out).
    """
    if mesh is None:
        def run_single(key, n_blocks):
            return local_fn(key, 0, n_blocks)
        return run_single

    ndev = mesh.devices.size

    def run_sharded(key, n_blocks):
        if n_blocks % ndev != 0:
            raise ValueError(
                f"n_blocks={n_blocks} must divide over {ndev} devices")
        per_dev = n_blocks // ndev

        @partial(
            jax.shard_map, mesh=mesh,
            in_specs=P(), out_specs=P(),
            # the loop carry inside local_fn starts replicated and becomes
            # device-varying after the first block; skip the VMA type check
            check_vma=False,
        )
        def body(k):
            d = lax.axis_index(AXIS)
            local = local_fn(k, d * per_dev, per_dev)
            return lax.psum(local, AXIS)

        return body(key)

    return run_sharded


def block_normals(key, bi, n_paths: int, dim: int, rqmc: bool):
    """(n_paths, dim) fp32 standard normals for global block ``bi``.

    rqmc=False: iid (threefry keyed on the GLOBAL block index — the
    library-wide deterministic scale-out invariant).  rqmc=True: the
    first n_paths points of a ``dim``-dimensional Sobol sequence under
    a per-block random digital shift, mapped through ndtri — each shift
    is an independent unbiased replicate, so callers must report SEs
    ACROSS blocks (n_blocks >= 2), not pooled within them.  Both modes
    key on ``bi`` alone, so sharded == single-device exactly."""
    sub = jax.random.fold_in(key, bi)
    if rqmc:
        from ..ops.sobol import sobol

        shift = jax.random.bits(sub, (dim,), jnp.uint32)
        return jax.scipy.special.ndtri(sobol(n_paths, dim, shift))
    return jax.random.normal(sub, (n_paths, dim), jnp.float32)
