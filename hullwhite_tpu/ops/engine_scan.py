"""Sequential-scan simulation engine (reference implementation).

This is the direct analogue of the reference's per-thread time loops
(``simulate_zcb`` market_data.cuh:25-79, ``simulate_ZBC_control_variate``
common.cuh:286-409, ``simulate_sensitivity`` 3_sensitivity_analysis.cu:22-96):
a ``lax.scan`` over time steps carrying the vectorized path state for a
whole block of paths, evolving both antithetic legs from one shock.

It is the *semantic reference* the fast engines are cross-validated against
(the analogue of the reference's <1e-6 cross-kernel price-consistency check,
benchmark_reductions.cu:158-169).  All engines take the Gaussian shock
matrix ``G`` as an argument so the check is deterministic.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from ..config import HWConfig
from ..models.hull_white import StepTables


def _evolve(r, integral, drift, sig_g, exp_adt, dt):
    """One exact-discretization step + trapezoid integral update
    (reference evolve_hull_white_step, common.cuh:237-244)."""
    r_next = r * exp_adt + (drift + sig_g)
    integral = integral + 0.5 * (r + r_next) * dt
    return r_next, integral


class PathState(NamedTuple):
    r_p: jax.Array  # short rate, +G leg, (block,)
    r_m: jax.Array  # short rate, -G leg
    i_p: jax.Array  # int_0^t r ds, +G leg
    i_m: jax.Array  # int_0^t r ds, -G leg


def antithetic_state(cfg: HWConfig, tables: StepTables, G) -> PathState:
    """Evolve both antithetic legs through ``G.shape[1]`` steps.

    G: (block, n) Gaussian shocks.  Returns the final state at t = n*dt.
    """
    block = G.shape[0]
    dtype = G.dtype
    r0 = jnp.full((block,), cfg.r0, dtype)
    z = jnp.zeros((block,), dtype)

    def step(carry, xs):
        g, drift = xs
        sig_g = tables.sig_st * g
        r_p, i_p = _evolve(carry.r_p, carry.i_p, drift, sig_g, tables.exp_adt, tables.dt)
        r_m, i_m = _evolve(carry.r_m, carry.i_m, drift, -sig_g, tables.exp_adt, tables.dt)
        return PathState(r_p, r_m, i_p, i_m), None

    n = G.shape[1]
    xs = (G.T, tables.drift[:n])
    state, _ = lax.scan(step, PathState(r0, r0, z, z), xs)
    return state


def curve_discount_sums(cfg: HWConfig, tables: StepTables, G):
    """Q1 workhorse: per-maturity sums of discount factors over both
    antithetic legs (reference simulate_zcb, market_data.cuh:25-79).

    G: (block, n_steps).  Returns (n_mat,) with entry m = sum over the block
    of exp(-I(T_m)) for both legs; entry 0 is the exact count ``2*block``
    (P(0,0) = 1 by construction, mirroring market_data.cuh:76-78 but without
    the in-kernel overwrite hack).
    """
    stride = cfg.save_stride
    block = G.shape[0]
    dtype = G.dtype
    r0 = jnp.full((block,), cfg.r0, dtype)
    z = jnp.zeros((block,), dtype)

    # Outer scan over checkpoints, inner scan over the stride sub-steps:
    # accumulation happens at trace-static positions (no scatter per step).
    G_chunks = G.T.reshape(cfg.n_mat - 1, stride, block)
    drift_chunks = tables.drift.reshape(cfg.n_mat - 1, stride)

    def inner(carry, xs):
        g, drift = xs
        sig_g = tables.sig_st * g
        r_p, i_p = _evolve(carry.r_p, carry.i_p, drift, sig_g, tables.exp_adt, tables.dt)
        r_m, i_m = _evolve(carry.r_m, carry.i_m, drift, -sig_g, tables.exp_adt, tables.dt)
        return PathState(r_p, r_m, i_p, i_m), None

    def outer(carry, xs):
        g_chunk, d_chunk = xs
        carry, _ = lax.scan(inner, carry, (g_chunk, d_chunk))
        s = jnp.sum(jnp.exp(-carry.i_p) + jnp.exp(-carry.i_m))
        return carry, s

    _, sums = lax.scan(outer, PathState(r0, r0, z, z), (G_chunks, drift_chunks))
    return jnp.concatenate([jnp.asarray([2.0 * block], dtype), sums])


class DualState(NamedTuple):
    r: jax.Array    # short rate (single leg)
    dr: jax.Array   # d r / d sigma (tangent process)
    i_r: jax.Array  # int r ds
    di_r: jax.Array  # int (dr/dsigma) ds


def dual_state(cfg: HWConfig, tables: StepTables, G) -> DualState:
    """Simultaneous evolution of r(t) and its sigma-tangent (reference
    simulate_sensitivity, 3_sensitivity_analysis.cu:22-96).  Both processes
    share the Brownian shocks; the tangent's shock scale is sig_st/sigma and
    its drift is d(drift)/dsigma.  Single leg (the reference kernel is not
    antithetic)."""
    block = G.shape[0]
    dtype = G.dtype
    r0 = jnp.full((block,), cfg.r0, dtype)
    z = jnp.zeros((block,), dtype)

    def step(carry, xs):
        g, drift, drift_s = xs
        r, i_r = _evolve(carry.r, carry.i_r, drift, tables.sig_st * g,
                         tables.exp_adt, tables.dt)
        dr, di_r = _evolve(carry.dr, carry.di_r, drift_s,
                           (tables.sig_st / tables.sigma) * g,
                           tables.exp_adt, tables.dt)
        return DualState(r, dr, i_r, di_r), None

    n = G.shape[1]
    xs = (G.T, tables.drift[:n], tables.drift_sigma[:n])
    state, _ = lax.scan(step, DualState(r0, z, z, z), xs)
    return state


def sample_paths(cfg: HWConfig, tables: StepTables, G):
    """Full r(t) trajectories for plotting (reference simulate_paths_show,
    market_data.cuh:136-160).  G: (n_show, n_steps) -> (n_show, n_steps+1)."""
    r0 = jnp.full((G.shape[0],), cfg.r0, G.dtype)

    def step(r, xs):
        g, drift = xs
        r_next = r * tables.exp_adt + (drift + tables.sig_st * g)
        return r_next, r_next

    _, rs = lax.scan(step, r0, (G.T, tables.drift[: G.shape[1]]))
    return jnp.concatenate([r0[None, :], rs], axis=0).T
