"""Batched strike/maturity ZBC option grid with shared path generation.

A scaled capability beyond the reference (BASELINE.json config 5): price a
whole (strikes x maturities) surface of European calls on P(S1, S2_j) from
ONE set of simulated paths.  The per-path state (r(S1), int r ds) does not
depend on the contract, so the entire surface reuses the same Gaussian
draws — each extra option costs only elementwise payoff math, and every
option gets its own per-maturity control variate Y_j = disc * P(S1, S2_j)
with E[Y_j] = P(0, S2_j) and its own empirically-optimal beta*_ij.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from .backend import check_engine
from .config import HWConfig
from .models import hull_white as hw
from .models.hull_white import MarketCurve
from .ops.rng import block_normals
from .parallel import mesh as pmesh
from . import pricing


class ZBCGrid(NamedTuple):
    strikes: jax.Array       # (nK,)
    maturities: jax.Array    # (nS2,)
    price: jax.Array         # (nK, nS2) CV-adjusted
    price_raw: jax.Array     # (nK, nS2)
    beta: jax.Array          # (nK, nS2)
    std_error_raw: jax.Array  # (nK, nS2) raw-estimator SE (per leg count)


def _grid_moments(cfg: HWConfig, sigma, market: MarketCurve, state, Ks, S2s):
    """Per-block moment sums for the whole surface (both antithetic legs)."""
    a = cfg.a
    B = hw.b_func(cfg.s1, S2s, a)                      # (nS2,)
    A = hw.a_hw(cfg, sigma, market, cfg.s1, S2s)       # (nS2,)
    P0 = hw.interp_curve(market.P, S2s, cfg)           # (nS2,)

    def leg(r, integral):
        P = A[None, :] * jnp.exp(-B[None, :] * r[:, None])     # (blk, nS2)
        disc = jnp.exp(-integral)[:, None]
        X = disc[:, :, None] * jnp.maximum(
            P[:, None, :] - Ks[None, :, None], 0.0)            # (blk, nK, nS2)
        Yc = disc * P - P0[None, :]                             # (blk, nS2)
        return X, Yc

    x1, y1 = leg(state.r_p, state.i_p)
    x2, y2 = leg(state.r_m, state.i_m)
    s = lambda v: jnp.sum(v, axis=0, dtype=jnp.float32)
    return {
        "sx": s(x1) + s(x2),                       # (nK, nS2)
        "sxx": s(x1 * x1) + s(x2 * x2),
        "sxy": s(x1 * y1[:, None, :]) + s(x2 * y2[:, None, :]),
        "sy": s(y1) + s(y2),                       # (nS2,)
        "syy": s(y1 * y1) + s(y2 * y2),
        "n": jnp.asarray(2.0 * state.r_p.shape[0], jnp.float32),
    }


@lru_cache(maxsize=None)
def _grid_fn(cfg: HWConfig, engine: str, mesh, Ks_t: tuple, S2_t: tuple):
    dtype = jnp.dtype(cfg.dtype)
    n_k, n_s2 = len(Ks_t), len(S2_t)

    check_engine(engine)

    def compute(key, sigma, market):
        tables = hw.step_tables(cfg, sigma, cfg.sigma, dtype)
        Ks = jnp.asarray(Ks_t, jnp.float32)
        S2s = jnp.asarray(S2_t, jnp.float32)
        n_cols, state_of = pricing._xla_state_setup(cfg, engine, tables,
                                                    dual=False)

        def block_fn(key, i):
            G = block_normals(key, i, (cfg.path_block, n_cols), dtype)
            return _grid_moments(cfg, sigma, market, state_of(G), Ks, S2s)

        zero = {
            "sx": jnp.zeros((n_k, n_s2), jnp.float32),
            "sxx": jnp.zeros((n_k, n_s2), jnp.float32),
            "sxy": jnp.zeros((n_k, n_s2), jnp.float32),
            "sy": jnp.zeros((n_s2,), jnp.float32),
            "syy": jnp.zeros((n_s2,), jnp.float32),
            "n": jnp.zeros((), jnp.float32),
        }

        def local(key, base, n_blocks):
            def body(i, acc):
                m = block_fn(key, base + i)
                return jax.tree_util.tree_map(jnp.add, acc, m)

            return lax.fori_loop(0, n_blocks, body, zero)

        runner = pmesh.shard_blocks(local, mesh)
        return runner(key, cfg.n_blocks)

    return jax.jit(compute)


def price_zbc_grid(cfg: HWConfig, key, market: MarketCurve, strikes,
                   maturities, *, sigma=None, engine: str = "exact",
                   mesh=None) -> ZBCGrid:
    """CV-adjusted price surface over (strikes x maturities), shared paths.

    ``maturities`` are the bond maturities S2 > S1 of the underlying
    P(S1, S2); the exercise date is ``cfg.s1`` for every option.
    """
    if sigma is None:
        sigma = cfg.sigma
    Ks_t = tuple(float(x) for x in strikes)
    S2_t = tuple(float(x) for x in maturities)
    Ks = jnp.asarray(Ks_t, jnp.float32)
    S2s = jnp.asarray(S2_t, jnp.float32)
    m = _grid_fn(cfg, engine, mesh, Ks_t, S2_t)(key, sigma, market)

    # NOTE: this re-derives the centered-control beta* algebra of
    # payoffs.cv_estimate for the (nK, nS2) moment layout (shared Y per
    # maturity).  tests/test_grid.py::test_grid_matches_single_option pins
    # the two implementations together cell-by-cell.
    n = m["n"]
    mean_x = m["sx"] / n                       # (nK, nS2)
    mean_yc = m["sy"] / n                      # (nS2,)
    var_y = m["syy"] / n - mean_yc * mean_yc
    var_x = m["sxx"] / n - mean_x * mean_x
    cov = m["sxy"] / n - mean_x * mean_yc[None, :]
    beta = cov / var_y[None, :]
    price = mean_x - beta * mean_yc[None, :]
    se_raw = jnp.sqrt(jnp.maximum(var_x, 0.0) / n)
    return ZBCGrid(strikes=Ks, maturities=S2s, price=price,
                   price_raw=mean_x, beta=beta, std_error_raw=se_raw)


@lru_cache(maxsize=None)
def _grid_vega_fn(cfg: HWConfig, engine: str, mesh, Ks_t: tuple,
                  S2_t: tuple):
    moments_fn = _grid_fn(cfg, engine, mesh, Ks_t, S2_t)

    def compute(key, sigma, market):
        def raw_surface(s):
            m = moments_fn(key, s, market)
            return m["sx"] / m["n"]

        return jax.jvp(raw_surface, (sigma,), (jnp.ones_like(sigma),))

    return jax.jit(compute)


def vega_zbc_grid(cfg: HWConfig, key, market: MarketCurve, strikes,
                  maturities, *, sigma=None, engine: str = "exact",
                  mesh=None):
    """(price_raw, vega) surfaces over (strikes x maturities) by forward-
    mode AD through the shared-path simulation — every cell's vega from
    the same Gaussian draws, one jvp.  The sigma-dependence flows through
    the calibration-consistent drift tables, the shock scale, and the
    A(t,T) reconstruction exactly as in the single-option pathwise method.
    """
    if sigma is None:
        sigma = cfg.sigma
    Ks_t = tuple(float(x) for x in strikes)
    S2_t = tuple(float(x) for x in maturities)
    sigma = jnp.asarray(sigma, jnp.float32)
    return _grid_vega_fn(cfg, engine, mesh, Ks_t, S2_t)(key, sigma, market)
