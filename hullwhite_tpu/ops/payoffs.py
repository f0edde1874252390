"""Payoff, control-variate and vega integrands + moment accumulation.

This is the elementwise tail of the hot kernels — the part the reference
fuses into ``simulate_ZBC_control_variate`` (common.cuh:337-362) and
``simulate_sensitivity`` (3_sensitivity_analysis.cu:64-80) after the time
loop, followed by the warp/block/atomic reduction hierarchy
(common.cuh:367-408).  Here the reduction hierarchy is simply ``jnp.sum``
over the path block (XLA emits an on-device tree reduction) + a
compensated float32 accumulation across blocks + ``lax.psum`` across the
device mesh.

Moment conditioning note: the control variate Y = discount * P(S1,S2) has
E[Y] = P(0,S2) ~ 0.88, so we accumulate moments of the *centered* control
Yc = Y - P(0,S2).  beta* = Cov(X,Yc)/Var(Yc) and the CV-adjusted price
mean(X) - beta * mean(Yc) are algebraically identical to the reference's
uncentered formulas (2_option_pricing.cu:154-179) but avoid the
E[XY] - EX*EY catastrophic cancellation in fp32.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import HWConfig
from ..models.hull_white import MarketCurve, b_func, dp_bond_dsigma, p_bond
from .engine_scan import DualState, PathState

# Moment vector layout (per reference simulate_ZBC_control_variate's five
# global accumulators, common.cuh:286-296):
#   [ sum X, sum Yc, sum X^2, sum Yc^2, sum X*Yc, count ]
N_MOMENTS = 6


def _leg_values(cfg: HWConfig, sigma, market: MarketCurve, r, integral):
    """Discounted payoff X and centered control Yc for one antithetic leg."""
    P = p_bond(cfg, sigma, market, cfg.s1, cfg.s2, r)
    disc = jnp.exp(-integral)
    payoff = disc * jnp.maximum(P - cfg.strike, 0.0)
    control_c = disc * P - market.P[-1]  # centered by P(0,S2)
    return payoff, control_c


def zbc_moments(cfg: HWConfig, sigma, market: MarketCurve, state: PathState):
    """Five CV moments + count, summed over both legs of a block."""
    x1, y1 = _leg_values(cfg, sigma, market, state.r_p, state.i_p)
    x2, y2 = _leg_values(cfg, sigma, market, state.r_m, state.i_m)
    s = lambda v: jnp.sum(v, dtype=jnp.float32)
    return jnp.stack([
        s(x1) + s(x2),
        s(y1) + s(y2),
        s(x1 * x1) + s(x2 * x2),
        s(y1 * y1) + s(y2 * y2),
        s(x1 * y1) + s(x2 * y2),
        jnp.asarray(2.0 * state.r_p.shape[0], jnp.float32),
    ])


class CVEstimate(NamedTuple):
    """Control-variate estimator outputs (reference run_ZBC_control_variate
    host math, 2_option_pricing.cu:154-191)."""

    price: jax.Array        # CV-adjusted price: mean X - beta * (mean Y - P(0,S2))
    price_raw: jax.Array    # mean X (no control variate)
    beta: jax.Array         # optimal beta* = Cov(X,Y)/Var(Y)
    correlation: jax.Array  # rho(X, Y)
    mean_control: jax.Array  # mean Y (uncentered)
    var_x: jax.Array
    var_y: jax.Array
    n: jax.Array


def cv_estimate(moments, p0_s2) -> CVEstimate:
    """beta* control-variate estimator from the reduced moments."""
    sx, sy, sxx, syy, sxy, n = (moments[i] for i in range(N_MOMENTS))
    mean_x = sx / n
    mean_yc = sy / n
    var_y = syy / n - mean_yc * mean_yc
    var_x = sxx / n - mean_x * mean_x
    cov = sxy / n - mean_x * mean_yc
    beta = cov / var_y
    corr = cov / jnp.sqrt(var_x * var_y)
    price = mean_x - beta * mean_yc
    return CVEstimate(
        price=price,
        price_raw=mean_x,
        beta=beta,
        correlation=corr,
        mean_control=mean_yc + p0_s2,
        var_x=var_x,
        var_y=var_y,
        n=n,
    )


def delta_sum(cfg: HWConfig, sigma, market: MarketCurve, state: PathState,
              dr_dr0: float, di_dr0: float):
    """Pathwise delta (d price / d r0) contributions, both antithetic legs.

    The initial rate enters every path affinely: dr(S1)/dr0 = E^{n1} and
    dI(S1)/dr0 = dt (1/2 + sum_k E^k + E^{n1}/2) are deterministic scalars
    (precomputed by the caller), so

      d/dr0 [ e^{-I} (P-K)^+ ] =
          1{P>K} (-P B) dr/dr0 e^{-I}  -  (dI/dr0) e^{-I} (P-K)^+

    This greek is beyond the CUDA reference's scope (it computes vega only).
    """
    B = b_func(cfg.s1, cfg.s2, cfg.a)

    def leg(r, integral):
        P = p_bond(cfg, sigma, market, cfg.s1, cfg.s2, r)
        disc = jnp.exp(-integral)
        term1 = jnp.where(P > cfg.strike, -P * B * dr_dr0 * disc, 0.0)
        term2 = di_dr0 * disc * jnp.maximum(P - cfg.strike, 0.0)
        return term1 - term2

    total = (jnp.sum(leg(state.r_p, state.i_p), dtype=jnp.float32)
             + jnp.sum(leg(state.r_m, state.i_m), dtype=jnp.float32))
    return jnp.stack([total,
                      jnp.asarray(2.0 * state.r_p.shape[0], jnp.float32)])


def vega_sum(cfg: HWConfig, sigma, market: MarketCurve, state: DualState):
    """Pathwise-vega contributions summed over a block (single leg).

    d/dsigma [ e^{-int r} max(P - K, 0) ]
      = 1{P > K} * dP/dsigma * discount  -  (int dr/dsigma) * discount * payoff
    (reference 3_sensitivity_analysis.cu:64-80).
    """
    P = p_bond(cfg, sigma, market, cfg.s1, cfg.s2, state.r)
    disc = jnp.exp(-state.i_r)
    dP = dp_bond_dsigma(cfg, sigma, cfg.s1, cfg.s2, P, state.dr)
    term1 = jnp.where(P > cfg.strike, dP * disc, 0.0)
    term2 = state.di_r * disc * jnp.maximum(P - cfg.strike, 0.0)
    per_path = term1 - term2
    return jnp.stack([
        jnp.sum(per_path, dtype=jnp.float32),
        jnp.asarray(1.0 * state.r.shape[0], jnp.float32),
    ])
