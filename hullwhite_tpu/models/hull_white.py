"""Hull-White one-factor model: closed forms and per-step precompute tables.

JAX replacement for the reference's device math layer
(``include/common.cuh:60-110`` host precompute + ``:180-258`` device
functions).  Everything here is a pure, differentiable ``jax.numpy``
function; the drift tables are *functions of sigma* so that

* the base table at ``sigma == sigma0`` reproduces ``compute_drift_tables``
  (reference ``common.cuh:60-84``),
* its sigma-derivative reproduces the hand-derived sensitivity drift table
  ``d_sigma_drift_table`` (``common.cuh:79-80``), and
* evaluating it at ``sigma0 +/- eps`` reproduces the analytically shifted
  table ``compute_shifted_drift_table`` (``3_sensitivity_analysis.cu:374-398``)
  — so pathwise vega via ``jax.jvp`` and CRN finite differences both fall out
  of the same parameterization with no constant-memory patching dance.

Exact discretization (reference ``evolve_hull_white_step``, common.cuh:237-244):

    r_{i+1} = r_i * e^{-a dt} + drift_i + sig_st * G_i
    I_{i+1} = I_i + 0.5 * (r_i + r_{i+1}) * dt        (trapezoid of int r ds)

with drift_i = int_{t_i}^{t_{i+1}} e^{-a(t_{i+1}-u)} theta(u; sigma) du and
sig_st = sigma * sqrt((1 - e^{-2 a dt}) / (2a)).

The calibration-consistent theta is theta(u; sigma) = theta_0(u) +
(sigma^2 - sigma0^2) (1 - e^{-2 a u}) / (2 a): bumping sigma while keeping
the market curve P(0,.) fixed shifts theta by exactly that amount (this is
the theta-recovery formula of reference ``2_option_pricing.cu:14-35`` solved
for the sigma-dependent convexity term).
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import HWConfig, ThetaSpec


def theta_fn(t, spec: ThetaSpec):
    """Ground-truth piecewise-linear theta(t) (reference common.cuh:228-230)."""
    from ..config import ThetaFromCurve

    if isinstance(spec, ThetaFromCurve):
        raise TypeError(
            "ThetaFromCurve is a drift-table spec (host_tables); it has "
            "no standalone theta_fn form — the q2a theta-recovery lane "
            "compares against the analytic ThetaSpec ground truth only")
    return jnp.where(
        t < spec.t_break,
        spec.alpha0 + spec.beta0 * t,
        spec.alpha1 + spec.beta1 * t,
    )


def market_theta(cfg: HWConfig, market) -> "ThetaFromCurve":
    """ThetaFromCurve spec from an observed/bootstrapped market curve:
    ``cfg.replace(a=.., sigma=.., theta=market_theta(cfg, market))``
    makes every engine's drift reprice the input curve exactly at the
    new parameters (the calibrate -> reprice pipeline's consistency
    requirement; see ThetaFromCurve)."""
    from ..config import ThetaFromCurve

    return ThetaFromCurve(
        f=tuple(float(v) for v in np.asarray(market.f, np.float64)),
        t_final=float(cfg.t_final))


def b_func(t, T, a, exp=jnp.exp):
    """B(t,T) = (1 - e^{-a(T-t)})/a (reference common.cuh:180-182).

    ``exp`` lets precompute-only callers route through the accurate
    software exp (ops/accurate.exp32): a hardware fp32 exp can carry a
    mean relative bias (-8.4e-7 measured on one accelerator) that would
    otherwise propagate into every
    bond-term coefficient (measured as a common -8.5e-7 platform shift
    of the Bermudan bracket AND its oracle).  Per-path hot kernels keep
    the native exp."""
    return (1.0 - exp(-a * (T - t))) / a


class StepTables(NamedTuple):
    """Per-step precompute: the analogue of the reference's
    ``__constant__``-memory bank (common.cuh:47-57).

    All fields are traced jnp values so the whole pytree is differentiable
    with respect to sigma.
    """

    exp_adt: jax.Array     # e^{-a dt}
    sig_st: jax.Array      # sigma * sqrt((1 - e^{-2 a dt}) / (2a))
    dt: jax.Array
    drift: jax.Array       # (n_steps,) int e^{-a(t-u)} theta(u; sigma) du
    drift_sigma: jax.Array  # (n_steps,) d drift / d sigma (tangent-process drift)
    sigma: jax.Array


def sig_st_unit(cfg: HWConfig) -> float:
    """sqrt((1 - e^{-2 a dt}) / (2a)) — sig_st = sigma * sig_st_unit."""
    return math.sqrt((1.0 - math.exp(-2.0 * cfg.a * cfg.dt)) / (2.0 * cfg.a))


def sig_st_fn(cfg: HWConfig, sigma):
    """Stochastic-step scale (reference compute_h_sig_st, common.cuh:87-89)."""
    return sigma * sig_st_unit(cfg)


@lru_cache(maxsize=None)
def host_tables(cfg: HWConfig):
    """Sigma-independent per-step table *shapes*, precomputed on the host in
    float64 (the reference precomputes its tables on the host too,
    common.cuh:60-84, but in fp32).

    Float64 matters here: building E^m on-device in fp32 via exp/log
    amplifies the libm error by m (observed ~5e-4 relative at m=50 on XLA
    CPU).  Sigma only enters through scalar multipliers, so host fp64
    precompute costs nothing in differentiability.

    Returns numpy arrays: ``base`` (drift under ground-truth theta), ``psi``
    (calibration-shift kernel), plus scalars ``E`` = e^{-a dt}.
    """
    a, dt = cfg.a, cfg.dt
    spec = cfg.theta
    E = math.exp(-a * dt)

    from ..config import ThetaFromCurve
    from ..utils import native

    if native.available() and not isinstance(spec, ThetaFromCurve):
        base, psi = native.drift_tables(a, dt, cfg.n_steps, spec)
        return {"E": E, "base": base, "psi": psi}

    one_m = (1.0 - E) / a
    i = np.arange(cfg.n_steps, dtype=np.float64)
    s = i * dt
    t = (i + 1.0) * dt

    if isinstance(spec, ThetaFromCurve):
        # market-implied theta (see ThetaFromCurve): the (f' + a f) part
        # integrates to f(t) - E f(s) EXACTLY, and the convexity part is
        # sigma0^2/2 psi — so base keeps the canonical form and the
        # runtime drift base + 0.5 (sigma^2 - sigma0^2) psi refits the
        # observed curve at every sigma
        psi = (1.0 + np.exp(-2.0 * a * t) - E
               - np.exp(-a * (t + s))) / (a * a)
        Ts = np.linspace(0.0, spec.t_final, len(spec.f))
        fg = np.asarray(spec.f, np.float64)
        base = (np.interp(t, Ts, fg) - E * np.interp(s, Ts, fg)
                + 0.5 * cfg.sigma * cfg.sigma * psi)
        return {"E": E, "base": base, "psi": psi}

    # int_s^t e^{-a(t-u)} (alpha + beta u) du
    #   = alpha (1-E)/a + beta [ (t - E s)/a - (1-E)/a^2 ]
    lin = (t - E * s) / a - one_m / a
    base = np.where(
        s < spec.t_break,
        spec.beta0 * lin + spec.alpha0 * one_m,
        spec.beta1 * lin + spec.alpha1 * one_m,
    )

    # psi_i = int_s^t e^{-a(t-u)} (1 - e^{-2 a u}) du / a
    #       = [1 + e^{-2 a t} - e^{-a(t-s)} - e^{-a(t+s)}] / a^2
    psi = (1.0 + np.exp(-2.0 * a * t) - E - np.exp(-a * (t + s))) / (a * a)

    return {"E": E, "base": base, "psi": psi}


def step_tables(cfg: HWConfig, sigma, sigma0=None, dtype=jnp.float32) -> StepTables:
    """Build the per-step drift tables for volatility ``sigma``.

    ``sigma0`` is the volatility at which the market curve was calibrated
    (defaults to ``cfg.sigma``).  Passing ``sigma0 == sigma`` yields the
    plain ground-truth-theta drift (the reference's ``compute_drift_tables``
    path, used by the *recalibrated* finite-difference mode,
    3_sensitivity_analysis.cu:449-482); ``sigma0 == cfg.sigma != sigma``
    yields the calibration-consistent shifted table
    (compute_shifted_drift_table).
    """
    if sigma0 is None:
        sigma0 = cfg.sigma
    sigma = jnp.asarray(sigma, dtype)
    sigma0 = jnp.asarray(sigma0, dtype)

    host = host_tables(cfg)
    base = jnp.asarray(host["base"], dtype)
    psi = jnp.asarray(host["psi"], dtype)

    drift = base + 0.5 * (sigma * sigma - sigma0 * sigma0) * psi
    drift_sigma = sigma * psi

    return StepTables(
        exp_adt=jnp.asarray(host["E"], dtype),
        sig_st=sigma * jnp.asarray(sig_st_unit(cfg), dtype),
        dt=jnp.asarray(cfg.dt, dtype),
        drift=drift,
        drift_sigma=drift_sigma,
        sigma=sigma,
    )


class MarketCurve(NamedTuple):
    """Bootstrapped market data handoff: P(0,T) and f(0,T) on the maturity
    grid.  Replaces the reference's ``data/P.bin``/``data/f.bin`` seam
    (common.cuh:42-44, 144-176)."""

    P: jax.Array  # (n_mat,)
    f: jax.Array  # (n_mat,)


def maturity_grid(cfg: HWConfig, dtype=jnp.float32):
    return jnp.linspace(0.0, cfg.t_final, cfg.n_mat, dtype=dtype)


def interp_curve(data, T, cfg: HWConfig):
    """Linear interpolation into the maturity grid, clamped at both ends
    (reference ``interpolate``, common.cuh:187-196)."""
    Ts = maturity_grid(cfg, data.dtype)
    return jnp.interp(T, Ts, data)


def a_hw(cfg: HWConfig, sigma, market: MarketCurve, t, T, exp=jnp.exp):
    """A(t,T) from market data (reference compute_A_HW, common.cuh:201-214).

    ``exp`` as in b_func: precompute-only callers pass the accurate
    software exp so bond-term coefficients are platform-independent."""
    a = cfg.a
    B = b_func(t, T, a, exp)
    P0T = interp_curve(market.P, T, cfg)
    P0t = interp_curve(market.P, t, cfg)
    f0t = interp_curve(market.f, t, cfg)
    conv = (sigma * sigma / (4.0 * a)) * (1.0 - exp(-2.0 * a * t)) * B * B
    return (P0T / P0t) * exp(B * f0t - conv)


def p_bond(cfg: HWConfig, sigma, market: MarketCurve, t, T, r):
    """P(t,T) = A(t,T) e^{-B(t,T) r} (reference compute_P_HW, common.cuh:220-225)."""
    return a_hw(cfg, sigma, market, t, T) * jnp.exp(-b_func(t, T, cfg.a) * r)


def dp_bond_dsigma(cfg: HWConfig, sigma, t, T, P_tT, dr_dsigma):
    """Analytical dP(t,T)/dsigma for the pathwise-vega chain rule
    (reference compute_dP_dsigma, 3_sensitivity_analysis.cu:15-19).

    dP/dsigma = -P B [ sigma/(2a) (1 - e^{-2 a t}) B + dr/dsigma ]
    (the first term is d(ln A)/dsigma, the second the state sensitivity).
    """
    a = cfg.a
    B = b_func(t, T, a)
    return -P_tT * B * (sigma / (2.0 * a) * (1.0 - jnp.exp(-2.0 * a * t)) * B + dr_dsigma)


def recover_theta(cfg: HWConfig, sigma, f):
    """theta(T) = df/dT + a f(T) + sigma^2/(2a) (1 - e^{-2aT}) on the
    maturity grid (reference recover_theta kernel, 2_option_pricing.cu:14-35),
    with forward/central/backward differences at the grid boundaries
    (reference compute_derivative, common.cuh:250-258)."""
    a = cfg.a
    Ts = maturity_grid(cfg, f.dtype)
    h = cfg.mat_spacing
    df = jnp.gradient(f, h)  # central interior, one-sided at the boundaries
    convexity = (sigma * sigma / (2.0 * a)) * (1.0 - jnp.exp(-2.0 * a * Ts))
    theta_rec = df + a * f + convexity
    theta_true = theta_fn(Ts, cfg.theta)
    return theta_rec, theta_true, Ts


def forward_from_p(cfg: HWConfig, P):
    """f(0,T) = -d ln P / dT via grid finite differences (reference
    compute_average_and_forward, market_data.cuh:101-127)."""
    lnP = jnp.log(P)
    return -jnp.gradient(lnP, cfg.mat_spacing)
