"""Uniform-grid interpolation for per-path table lookups.

``jnp.interp`` / ``jnp.searchsorted`` lower to an O(paths x table)
broadcast-compare plus dynamic gathers — on the Bermudan exposure
kernel's 1501-point value grids that dominated the kernel.  Every
per-path lookup table in this repo (DP value grids, boundary curves
u*(w), coupon lattices) is a linspace, so the cell index is an affine
map: one clip + one gather.

Semantics match ``jnp.interp`` with flat extrapolation outside the
grid (identical up to fp32 rounding of the affine index; tests pin the
pricers either way).
"""

import jax.numpy as jnp

__all__ = ["uinterp"]


def uinterp(grid, V, x):
    """Linear interpolation of ``V`` on the UNIFORM ``grid`` at ``x``
    with flat extrapolation.  ``V`` may carry trailing batch dims on
    the right of its first axis only if it is 1-d per grid point (the
    common case here); for multi-channel tables share the indices by
    hand (see xva._interp2)."""
    h = grid[1] - grid[0]
    u = (x - grid[0]) / h
    ix = jnp.clip(jnp.floor(u), 0, grid.shape[0] - 2).astype(jnp.int32)
    fr = jnp.clip(u - ix, 0.0, 1.0)
    return (1.0 - fr) * V[ix] + fr * V[ix + 1]
