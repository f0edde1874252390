"""G2++ two-factor Gaussian short-rate model — a second model family.

r(t) = x(t) + y(t) + phi(t),  dx = -a x dt + sigma dW1,
dy = -b y dt + eta dW2,  d<W1,W2> = rho dt,  x(0) = y(0) = 0,
with phi calibrated to the market discount curve P(0,.).

This module demonstrates that the framework's exact-functional design
(SURVEY §7 / docs/MATH.md §3) is not special to Hull-White: the option
state (x(S1), y(S1), int_0^S1 (x+y) ds) is jointly Gaussian with
closed-form covariance, so ZBC pricing under G2++ needs THREE normals per
path and no time grid at all — the law is the exact continuous-time one
(zero discretization error, unlike the reference's per-step scheme).

Closed forms (Brigo & Mercurio ch. 4): bond reconstruction
P(t,T) = A(t,T) e^{-Ba(t,T) x - Bb(t,T) y} with A from the market curve
plus the variance adjustment, and the ZBC price is Black-like with total
log-bond volatility Sigma^2 given below; both are implemented in float64
as validation oracles.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from ..config import HWConfig
# accurate software exp/pdf for the Bermudan bracket path: a biased
# hardware fp32 exp (-8.4e-7 mean relative, measured on one accelerator)
# composes into a -2e-6 bracket floor; see ops/accurate.py
from ..ops.accurate import exp32 as _exp, npdf as _npdf
from . import hull_white as hw
from .hull_white import MarketCurve


@dataclass(frozen=True)
class G2Params:
    a: float = 1.0
    b: float = 0.1
    sigma: float = 0.08
    eta: float = 0.02
    rho: float = -0.6


def _B(k: float, tau: float) -> float:
    return (1.0 - math.exp(-k * tau)) / k


def _v_integral(g: G2Params, tau: float) -> float:
    """V(tau) = Var( int_0^tau (x+y) ds ) for x(0)=y(0)=0 over [0, tau]."""
    a, b, s, e, r = g.a, g.b, g.sigma, g.eta, g.rho
    Ba, Bb = _B(a, tau), _B(b, tau)
    Bab = _B(a + b, tau)
    va = s * s / (a * a) * (tau - 2 * Ba + _B(2 * a, tau))
    vb = e * e / (b * b) * (tau - 2 * Bb + _B(2 * b, tau))
    vab = 2 * r * s * e / (a * b) * (tau - Ba - Bb + Bab)
    return va + vb + vab


@lru_cache(maxsize=None)
def _state_cov(g: G2Params, T: float):
    """fp64 Cov(x(T), y(T), I(T)) from zero start, I = int_0^T (x+y) ds.

    All entries in closed form:
      Var x       = s^2 (1-e^{-2aT})/(2a)
      Cov(x,y)    = rho s e (1-e^{-(a+b)T})/(a+b)
      Cov(x, Ix)  = s^2/(2a^2) (1-e^{-aT})^2
      Cov(x, Iy)  = rho s e / b [ (1-e^{-aT})/a - (1-e^{-(a+b)T})/(a+b) ]
      Var I       = _v_integral
    """
    a, b, s, e, r = g.a, g.b, g.sigma, g.eta, g.rho
    vx = s * s * (1 - math.exp(-2 * a * T)) / (2 * a)
    vy = e * e * (1 - math.exp(-2 * b * T)) / (2 * b)
    cxy = r * s * e * (1 - math.exp(-(a + b) * T)) / (a + b)

    def cov_x_I(k1, v1, k2, v2, corr):
        # Cov( v1 int e^{-k1(T-u)} dW1(u),  v2 int B_{k2}(u,T) dW2(u) )
        return corr * v1 * v2 / k2 * (_B(k1, T) - (1 - math.exp(-(k1 + k2) * T)) / (k1 + k2))

    c_x_I = cov_x_I(a, s, a, s, 1.0) + cov_x_I(a, s, b, e, r)
    c_y_I = cov_x_I(b, e, b, e, 1.0) + cov_x_I(b, e, a, s, r)
    return np.array([
        [vx, cxy, c_x_I],
        [cxy, vy, c_y_I],
        [c_x_I, c_y_I, _v_integral(g, T)],
    ])


@lru_cache(maxsize=None)
def _state_chol(g: G2Params, s1: float):
    """fp32 Cholesky^T of _state_cov (z = x @ L^T sampling)."""
    C = _state_cov(g, s1)
    L = np.linalg.cholesky(C + 1e-18 * np.eye(3))
    return np.asarray(L.T, np.float32)


def _sigma_zbc(g: G2Params, s1: float, s2: float) -> float:
    """Total log-bond volatility of P(S1,S2) under the S1-forward measure."""
    a, b, s, e, r = g.a, g.b, g.sigma, g.eta, g.rho
    tau = s2 - s1
    Ba, Bb = _B(a, tau), _B(b, tau)
    v = (s * s / (2 * a) * Ba * Ba * (1 - math.exp(-2 * a * s1))
         + e * e / (2 * b) * Bb * Bb * (1 - math.exp(-2 * b * s1))
         + 2 * r * s * e / (a + b) * Ba * Bb * (1 - math.exp(-(a + b) * s1)))
    return math.sqrt(v)


def zbc_price_analytic(cfg: HWConfig, g: G2Params, market: MarketCurve,
                       K: float | None = None) -> float:
    """Closed-form G2++ ZBC on the given market curve (float64)."""
    if K is None:
        K = cfg.strike
    Ts = np.linspace(0.0, cfg.t_final, cfg.n_mat)
    P = np.asarray(market.P, np.float64)
    P1 = float(np.interp(cfg.s1, Ts, P))
    P2 = float(np.interp(cfg.s2, Ts, P))
    S = _sigma_zbc(g, cfg.s1, cfg.s2)
    h = math.log(P2 / (K * P1)) / S + 0.5 * S
    from .oracles import _phi

    return P2 * _phi(h) - K * P1 * _phi(h - S)


class G2ZBC(NamedTuple):
    price: jax.Array
    price_raw: jax.Array
    beta: jax.Array
    std_error_raw: jax.Array
    n: int


def _cv_stats(sums, n):
    """(price, raw, beta, se_raw) from the 5 accumulated CV moment sums
    [Sx, Sy, Sxx, Syy, Sxy] over n samples (the control is pre-centered)."""
    mean_x = sums[0] / n
    mean_yc = sums[1] / n
    var_x = sums[2] / n - mean_x ** 2
    var_y = sums[3] / n - mean_yc ** 2
    cov = sums[4] / n - mean_x * mean_yc
    beta = cov / var_y
    return (mean_x - beta * mean_yc, mean_x, beta,
            jnp.sqrt(jnp.maximum(var_x, 0.0) / n))


@lru_cache(maxsize=None)
def _g2_zbc_fn(cfg: HWConfig, g: G2Params, n_paths: int, n_blocks: int,
               mesh):
    from ..parallel import mesh as pmesh

    LT = jnp.asarray(_state_chol(g, cfg.s1))
    a, b = g.a, g.b
    tau = cfg.s2 - cfg.s1
    Ba = jnp.float32(_B(a, tau))
    Bb = jnp.float32(_B(b, tau))
    # A(t,T) variance adjustment: ln A = ln(P2/P1) + 1/2[V(t,T)-V(0,T)+V(0,t)]
    vadj = 0.5 * (_v_integral(g, tau) - _v_integral(g, cfg.s2)
                  + _v_integral(g, cfg.s1))
    # discount to 0: exp(-int phi) * exp(-I) with int_0^S1 phi =
    # -ln P(0,S1) + V(0,S1)/2
    d0 = -0.5 * _v_integral(g, cfg.s1)

    def compute(key, market):
        P1 = hw.interp_curve(market.P, jnp.float32(cfg.s1), cfg)
        P2 = hw.interp_curve(market.P, jnp.float32(cfg.s2), cfg)
        A = (P2 / P1) * jnp.exp(jnp.float32(vadj))
        disc0 = P1 * jnp.exp(jnp.float32(d0))

        def block(bi):
            xn = jax.random.normal(jax.random.fold_in(key, bi),
                                   (n_paths, 3), jnp.float32)
            z = jnp.dot(xn, LT, preferred_element_type=jnp.float32,
                        precision=cfg.matmul_precision)

            def leg(sgn):
                x, y, I = sgn * z[:, 0], sgn * z[:, 1], sgn * z[:, 2]
                Pb = A * jnp.exp(-Ba * x - Bb * y)
                disc = disc0 * jnp.exp(-I)
                X = disc * jnp.maximum(Pb - cfg.strike, 0.0)
                Yc = disc * Pb - P2
                return X, Yc

            x1, y1 = leg(1.0)
            x2, y2 = leg(-1.0)
            return jnp.stack([
                jnp.sum(x1) + jnp.sum(x2), jnp.sum(y1) + jnp.sum(y2),
                jnp.sum(x1 * x1) + jnp.sum(x2 * x2),
                jnp.sum(y1 * y1) + jnp.sum(y2 * y2),
                jnp.sum(x1 * y1) + jnp.sum(x2 * y2)])

        sums = jnp.sum(pmesh.map_blocks(block, n_blocks, mesh), axis=0)
        return _cv_stats(sums, 2.0 * n_paths * n_blocks)

    return jax.jit(compute)


@lru_cache(maxsize=None)
def _g2_validate_fn(cfg: HWConfig, g: G2Params, n_paths: int,
                    n_runs: int, offset: int):
    inner = _g2_zbc_fn(cfg, g, n_paths, 1, None)

    def compute(key, market):
        def one(i):
            return jnp.stack(inner(jax.random.fold_in(key, offset + i),
                                   market))

        return jax.lax.map(one, jnp.arange(n_runs))

    return jax.jit(compute)


def validate_zbc_g2_runs(cfg: HWConfig, g: G2Params, key,
                         market: MarketCurve, *, n_runs: int,
                         n_paths: int | None = None, offset: int = 4000):
    """n_runs independent G2++ CV pricings in ONE device call (the C32
    statistical-validation machinery extended to the second family; same
    lax.map-over-folded-keys batching as pricing.validate_zbc_runs).
    Returns a host (n_runs, 4) array of [price, raw, beta, se_raw]."""
    if n_paths is None:
        n_paths = cfg.n_paths
    return jax.device_get(
        _g2_validate_fn(cfg, g, int(n_paths), int(n_runs),
                        int(offset))(key, market))


def price_zbc_g2(cfg: HWConfig, g: G2Params, key, market: MarketCurve,
                 n_paths: int | None = None, n_blocks: int = 1,
                 mesh=None) -> G2ZBC:
    """CV-adjusted G2++ ZBC price by exact functional sampling: 3 normals
    per path, exact continuous-time law (no time grid).  ``n_paths`` is
    per block; blocks are keyed by their global index and optionally
    shard over ``mesh`` (deterministic scale-out, parallel/mesh.py)."""
    if n_paths is None:
        n_paths = cfg.n_paths
    price, raw, beta, se = _g2_zbc_fn(cfg, g, int(n_paths), int(n_blocks),
                                      mesh)(key, market)
    return G2ZBC(price=price, price_raw=raw, beta=beta, std_error_raw=se,
                 n=int(n_paths) * int(n_blocks))


# ---------------------------------------------------------------------------
# Q1 analogue: curve bootstrap under G2++ (exact joint checkpoint law)
# ---------------------------------------------------------------------------

def _cov_integrals(g: G2Params, T1: float, T2: float) -> float:
    """Cov( int_0^{T1} (x+y) ds,  int_0^{T2} (x+y) ds ) for T1 <= T2.

    Per factor pair (k1,v1),(k2,v2) with correlation c:
      c v1 v2/(k1 k2) [ T1 - B_{k1}(T1) - e^{-k2 (T2-T1)} B_{k2}(T1)
                        + e^{-k2 (T2-T1)} B_{k1+k2}(T1) ]
    summed over the four (factor1/factor2) combinations.
    """
    assert T1 <= T2
    a, b, s, e, r = g.a, g.b, g.sigma, g.eta, g.rho
    d = T2 - T1

    def term(k1, v1, k2, v2, c):
        return (c * v1 * v2 / (k1 * k2)
                * (T1 - _B(k1, T1) - math.exp(-k2 * d) * _B(k2, T1)
                   + math.exp(-k2 * d) * _B(k1 + k2, T1)))

    return (term(a, s, a, s, 1.0) + term(b, e, b, e, 1.0)
            + term(a, s, b, e, r) + term(b, e, a, s, r))


@lru_cache(maxsize=None)
def _curve_chol_g2(cfg: HWConfig, g: G2Params):
    """fp64 Cholesky^T of Cov(I(T_1)..I(T_{n_mat-1})) under G2++."""
    Ts = [cfg.mat_spacing * m for m in range(1, cfg.n_mat)]
    k = len(Ts)
    C = np.empty((k, k))
    for i in range(k):
        for j in range(i, k):
            C[i, j] = C[j, i] = _cov_integrals(g, Ts[i], Ts[j])
    L = np.linalg.cholesky(C + 1e-16 * np.eye(k))
    return np.asarray(L.T, np.float32)


def bootstrap_curve_g2(cfg: HWConfig, g: G2Params, key,
                       target: MarketCurve, n_paths: int | None = None,
                       n_blocks: int = 1, mesh=None):
    """Monte-Carlo P(0,T) curve under G2++ calibrated to ``target``.

    The MC estimate must reproduce ``target.P`` within noise — the G2++
    analogue of the reference's Q1, validating the cross-checkpoint
    covariance law: P(0,T_m) = disc0_m * E[e^{-I_m}] with
    disc0_m = P_target(0,T_m) e^{-V(0,T_m)/2}.  Blocks key on their
    global index and optionally shard over ``mesh``.
    """
    from ..parallel import mesh as pmesh

    if n_paths is None:
        n_paths = cfg.n_paths
    LT = jnp.asarray(_curve_chol_g2(cfg, g))
    v_half = jnp.asarray([0.5 * _v_integral(g, cfg.mat_spacing * m)
                          for m in range(1, cfg.n_mat)], jnp.float32)

    @jax.jit
    def compute(key, P_target):
        def block(bi):
            x = jax.random.normal(jax.random.fold_in(key, bi),
                                  (int(n_paths), cfg.n_mat - 1),
                                  jnp.float32)
            z = jnp.dot(x, LT, preferred_element_type=jnp.float32,
                        precision=cfg.matmul_precision)
            # antithetic: E[e^{-I}] over +/- z; disc0 folds in phi
            return jnp.sum(jnp.exp(-z), axis=0) + jnp.sum(jnp.exp(z),
                                                          axis=0)

        s = jnp.sum(pmesh.map_blocks(block, n_blocks, mesh), axis=0)
        ez = s / (2.0 * n_paths * n_blocks)
        P = P_target[1:] * jnp.exp(-v_half) * ez
        return jnp.concatenate([jnp.ones((1,), jnp.float32), P])

    P = compute(key, target.P)
    return MarketCurve(P=P, f=hw.forward_from_p(cfg, P))


# ---------------------------------------------------------------------------
# Coupon-bond options / European swaptions under G2++ (round 2)
#
# Jamshidian decomposition does not apply with two factors (the exercise
# boundary is a curve in (x, y), not a point in r); the reference has no
# two-factor analogue at all.  Pricing is by the same exact functional
# sampling as the ZBC (3 normals per path, zero time-stepping), and the
# oracle is the standard conditional-decomposition integral: conditional
# on x(S1) the payoff is monotone in y, so the inner y-integral is a sum
# of closed-form Gaussian terms around the root y-bar(x) and only a 1-d
# fp64 quadrature over x remains (the structure of Brigo & Mercurio's
# semi-analytic swaption formula, derived here from scratch).
# ---------------------------------------------------------------------------

def _fwd_means(g: G2Params, T: float):
    """E^{Q^T}[x(T)], E^{Q^T}[y(T)] (the T-forward-measure drift of each
    factor; symmetric formula, Brigo & Mercurio 4.30 style)."""
    a, b, s, e, r = g.a, g.b, g.sigma, g.eta, g.rho

    def m(k1, v1, k2, v2):
        # mean of factor-1 with its own vol v1, speed k1, partner (k2, v2)
        return ((v1 * v1 / (k1 * k1) + r * v1 * v2 / (k1 * k2))
                * (1 - math.exp(-k1 * T))
                - v1 * v1 / (2 * k1 * k1) * (1 - math.exp(-2 * k1 * T))
                - r * v1 * v2 / (k2 * (k1 + k2))
                * (1 - math.exp(-(k1 + k2) * T)))

    return -m(a, s, b, e), -m(b, e, a, s)


def _xy_cov(g: G2Params, T: float):
    """(sx, sy, rho_xy) of (x(T), y(T)) — measure-independent."""
    a, b, s, e, r = g.a, g.b, g.sigma, g.eta, g.rho
    sx = s * math.sqrt((1 - math.exp(-2 * a * T)) / (2 * a))
    sy = e * math.sqrt((1 - math.exp(-2 * b * T)) / (2 * b))
    rxy = r * s * e * (1 - math.exp(-(a + b) * T)) / ((a + b) * sx * sy)
    return sx, sy, rxy


def _bond_terms_g2(cfg: HWConfig, g: G2Params, market: MarketCurve,
                   times, coupons):
    """fp64 (lam0_i, Ba_i, Bb_i): P(S1, T_i) = lam0_i e^{-Ba_i x - Bb_i y}
    reconstructed from the market curve with the G2++ variance adjustment
    ln A = ln(P(0,T)/P(0,S1)) + 1/2 [V(S1,T) - V(0,T) + V(0,S1)]."""
    Ts_grid = np.linspace(0.0, cfg.t_final, cfg.n_mat)
    P = np.asarray(market.P, np.float64)
    P1 = float(np.interp(cfg.s1, Ts_grid, P))
    out = []
    for T_i, c_i in zip(times, coupons):
        tau = T_i - cfg.s1
        vadj = 0.5 * (_v_integral(g, tau) - _v_integral(g, T_i)
                      + _v_integral(g, cfg.s1))
        A = float(np.interp(T_i, Ts_grid, P)) / P1 * math.exp(vadj)
        out.append((c_i * A, _B(g.a, tau), _B(g.b, tau)))
    return out, P1


def swaption_g2_analytic(cfg: HWConfig, g: G2Params, market: MarketCurve,
                         sched, strike: float = 1.0, payer: bool = False,
                         n_quad: int = 2001, width: float = 8.0) -> float:
    """fp64 coupon-bond-option / swaption price by conditional
    decomposition: payer = P(0,S1) E^{S1}[ (K - sum c_i P(S1,T_i))^+ ].

    Conditional on x, V(x, y) = sum lam_i(x) e^{-Bb_i y} is decreasing in
    y; the exercise root y-bar(x) is found by Newton and the inner
    y-integral is closed-form:  E[e^{-beta y} 1{y > ybar}] =
    e^{-beta m + beta^2 s^2 / 2} Phi((m - beta s^2 - ybar)/s).
    """
    terms, P1 = _bond_terms_g2(cfg, g, market, sched.times, sched.coupons)
    lam0 = np.array([t[0] for t in terms])
    Ba = np.array([t[1] for t in terms])
    Bb = np.array([t[2] for t in terms])
    mx, my = _fwd_means(g, cfg.s1)
    sx, sy, rxy = _xy_cov(g, cfg.s1)

    xs = mx + sx * np.linspace(-width, width, n_quad)
    wpdf = np.exp(-0.5 * ((xs - mx) / sx) ** 2) / (sx * math.sqrt(2 * math.pi))
    lam = lam0[None, :] * np.exp(-Ba[None, :] * xs[:, None])  # (nx, ni)
    m_c = my + rxy * sy / sx * (xs - mx)          # conditional mean of y
    s_c = sy * math.sqrt(1.0 - rxy * rxy)

    # Newton for ybar(x): V(x, ybar) = strike  (V decreasing in y)
    yb = np.full_like(xs, my)
    for _ in range(60):
        V = np.sum(lam * np.exp(-Bb[None, :] * yb[:, None]), axis=1)
        dV = -np.sum(lam * Bb[None, :] *
                     np.exp(-Bb[None, :] * yb[:, None]), axis=1)
        step = (V - strike) / dV
        yb = yb - step
        if np.max(np.abs(step)) < 1e-14:
            break

    # inner closed form: for y > ybar, V < strike -> payer payoff K - V
    d = (m_c - yb) / s_c
    from scipy.stats import norm  # fp64 Phi; scipy is available
    e_ind = norm.cdf(d)
    e_v = np.sum(
        lam * np.exp(-Bb[None, :] * m_c[:, None]
                     + 0.5 * (Bb[None, :] * s_c) ** 2)
        * norm.cdf(d[:, None] - Bb[None, :] * s_c), axis=1)
    payer_inner = strike * e_ind - e_v          # E[(K - V) 1{y > ybar}]
    inner = payer_inner if payer else (
        payer_inner + np.sum(lam * np.exp(-Bb[None, :] * m_c[:, None]
                                          + 0.5 * (Bb[None, :] * s_c) ** 2),
                             axis=1) - strike)  # put-call parity per x
    val = np.trapezoid(wpdf * inner, xs)
    return float(P1 * val)


class G2CBO(NamedTuple):
    price: jax.Array
    price_raw: jax.Array
    beta: jax.Array
    std_error_raw: jax.Array
    n: int


@lru_cache(maxsize=None)
def _g2_cbo_fn(cfg: HWConfig, g: G2Params, times, coupons, strike: float,
               payer: bool, n_paths: int, n_blocks: int = 1, mesh=None):
    from ..parallel import mesh as pmesh

    LT = jnp.asarray(_state_chol(g, cfg.s1))
    d0 = -0.5 * _v_integral(g, cfg.s1)
    # static per-cashflow quantities (the market curve stays traced)
    vadj = [0.5 * (_v_integral(g, t - cfg.s1) - _v_integral(g, t)
                   + _v_integral(g, cfg.s1)) for t in times]
    Ba = jnp.asarray([_B(g.a, t - cfg.s1) for t in times], jnp.float32)
    Bb = jnp.asarray([_B(g.b, t - cfg.s1) for t in times], jnp.float32)

    def compute(key, market):
        P1 = hw.interp_curve(market.P, jnp.float32(cfg.s1), cfg)
        P0i = hw.interp_curve(market.P, jnp.asarray(times, jnp.float32),
                              cfg)
        lam0 = (jnp.asarray(coupons, jnp.float32) * P0i / P1
                * jnp.exp(jnp.asarray(vadj, jnp.float32)))
        disc0 = P1 * jnp.exp(jnp.float32(d0))
        # E[disc * V_bond] = sum c_i P(0, T_i) (martingale control)
        EY = jnp.sum(jnp.asarray(coupons, jnp.float32) * P0i)
        sgn_pay = -1.0 if payer else 1.0

        def block(bi):
            xn = jax.random.normal(jax.random.fold_in(key, bi),
                                   (n_paths, 3), jnp.float32)
            z = jnp.dot(xn, LT, preferred_element_type=jnp.float32,
                        precision=cfg.matmul_precision)

            def leg(sgn):
                x, y, I = sgn * z[:, 0], sgn * z[:, 1], sgn * z[:, 2]
                V = jnp.sum(lam0[None, :]
                            * jnp.exp(-Ba[None, :] * x[:, None]
                                      - Bb[None, :] * y[:, None]), axis=1)
                disc = disc0 * jnp.exp(-I)
                X = disc * jnp.maximum(sgn_pay * (V - strike), 0.0)
                Yc = disc * V - EY
                return X, Yc

            x1, y1 = leg(1.0)
            x2, y2 = leg(-1.0)
            return jnp.stack([
                jnp.sum(x1) + jnp.sum(x2), jnp.sum(y1) + jnp.sum(y2),
                jnp.sum(x1 * x1) + jnp.sum(x2 * x2),
                jnp.sum(y1 * y1) + jnp.sum(y2 * y2),
                jnp.sum(x1 * y1) + jnp.sum(x2 * y2)])

        sums = jnp.sum(pmesh.map_blocks(block, n_blocks, mesh), axis=0)
        return _cv_stats(sums, 2.0 * n_paths * n_blocks)

    return jax.jit(compute)


def price_swaption_g2(cfg: HWConfig, g: G2Params, key, market: MarketCurve,
                      sched, strike: float = 1.0, payer: bool = False,
                      n_paths: int | None = None, n_blocks: int = 1,
                      mesh=None) -> G2CBO:
    """CV-adjusted G2++ coupon-bond option (== European swaption on the
    fixed leg) by exact functional sampling: 3 normals per path.
    Blocks key on their global index and optionally shard over ``mesh``."""
    if n_paths is None:
        n_paths = cfg.n_paths
    price, raw, beta, se = _g2_cbo_fn(
        cfg, g, tuple(sched.times), tuple(sched.coupons), float(strike),
        bool(payer), int(n_paths), int(n_blocks), mesh)(key, market)
    return G2CBO(price=price, price_raw=raw, beta=beta, std_error_raw=se,
                 n=int(n_paths) * int(n_blocks))


# ---------------------------------------------------------------------------
# G2++ vega (CRN finite differences) and 3-d RQMC
# ---------------------------------------------------------------------------

def vega_zbc_g2(cfg: HWConfig, g: G2Params, key, market: MarketCurve, *,
                eps: float = 1e-3, n_paths: int | None = None):
    """d price / d sigma by central differences under common random
    numbers (same key => identical normals; the Cholesky factor carries
    all the sigma-dependence, mirroring greeks.fd_vega_crn)."""
    gp = G2Params(a=g.a, b=g.b, sigma=g.sigma + eps, eta=g.eta, rho=g.rho)
    gm = G2Params(a=g.a, b=g.b, sigma=g.sigma - eps, eta=g.eta, rho=g.rho)
    pp = price_zbc_g2(cfg, gp, key, market, n_paths=n_paths).price
    pm = price_zbc_g2(cfg, gm, key, market, n_paths=n_paths).price
    return (pp - pm) / (2.0 * eps)


def vega_bermudan_g2(cfg: HWConfig, g: G2Params, key, market: MarketCurve,
                     sched, exercise_dates, *, strike: float = 1.0,
                     payer: bool = False, eps: float = 1e-3,
                     n_paths: int | None = None, n_blocks: int = 1,
                     rqmc: bool = False, mesh=None):
    """(vega_lower, vega_upper): d/dsigma of the G2++ Bermudan bracket by
    central differences under common random numbers (same key on both
    legs; the joint Cholesky and the dual's closed forms carry all the
    sigma dependence, mirroring vega_zbc_g2)."""
    gp = G2Params(a=g.a, b=g.b, sigma=g.sigma + eps, eta=g.eta, rho=g.rho)
    gm = G2Params(a=g.a, b=g.b, sigma=g.sigma - eps, eta=g.eta, rho=g.rho)
    rp = price_bermudan_g2(cfg, gp, key, market, sched, exercise_dates,
                           strike=strike, payer=payer, n_paths=n_paths,
                           n_blocks=n_blocks, rqmc=rqmc, mesh=mesh)
    rm = price_bermudan_g2(cfg, gm, key, market, sched, exercise_dates,
                           strike=strike, payer=payer, n_paths=n_paths,
                           n_blocks=n_blocks, rqmc=rqmc, mesh=mesh)
    return ((float(rp.price) - float(rm.price)) / (2.0 * eps),
            (float(rp.upper) - float(rm.upper)) / (2.0 * eps))


def _exchange_terms(cfg: HWConfig, g: G2Params, T: float):
    """(Ba, Bb, vadj) of ln P(S1, T) = ln A_T - Ba x - Bb y."""
    tau = T - cfg.s1
    vadj = 0.5 * (_v_integral(g, tau) - _v_integral(g, T)
                  + _v_integral(g, cfg.s1))
    return _B(g.a, tau), _B(g.b, tau), vadj


def exchange_analytic_g2(cfg: HWConfig, g: G2Params, market: MarketCurve,
                         Ta: float, Tb: float, K: float = 1.0) -> float:
    """float64 closed form for the bond-exchange (Margrabe) option
    E[ D(S1) max(P(S1,Ta) - K P(S1,Tb), 0) ] under G2++.

    Genuinely two-factor: the spread ln(Pa/Pb) loads the factors with
    weight DIFFERENCES (Ba(Ta)-Ba(Tb), Bb(Ta)-Bb(Tb)), so no one-factor
    model reproduces it.  Pure Gaussian linear algebra on the state
    covariance _state_cov(g, S1): with W_i = ln P_i - I (so e^{W_i} is
    the discounted bond) and S = ln(Pa/Pb),

        price = disc0 [ e^{mu_a + v_a/2} Phi(d_a)
                        - K e^{mu_b + v_b/2} Phi(d_b) ],
        d_i = (mu_S + Cov(S, W_i) - ln K) / sigma_S,

    and the martingale identity disc0 e^{mu_i + v_i/2} = P(0, T_i) pins
    the K -> 0 limit to P(0, Ta) exactly (tested)."""
    from ..instruments import curve_level
    from .oracles import _phi

    C = _state_cov(g, cfg.s1)
    P1 = curve_level(cfg, market, cfg.s1)
    d0 = -0.5 * _v_integral(g, cfg.s1)
    disc0 = P1 * math.exp(d0)

    def w_of(T):
        Ba, Bb, vadj = _exchange_terms(cfg, g, T)
        lnA = math.log(curve_level(cfg, market, T) / P1) + vadj
        return np.array([-Ba, -Bb, -1.0]), lnA

    wa, lnAa = w_of(Ta)
    wb, lnAb = w_of(Tb)
    ws = np.array([wa[0] - wb[0], wa[1] - wb[1], 0.0])
    mu_s = lnAa - lnAb
    sig_s = math.sqrt(max(ws @ C @ ws, 0.0))
    if K <= 0.0:
        # exchange is always worthwhile: price = E[D(Pa - K Pb)] exactly
        return disc0 * (math.exp(lnAa + 0.5 * float(wa @ C @ wa))
                        - K * math.exp(lnAb + 0.5 * float(wb @ C @ wb)))
    c = math.log(K)

    def leg(w, lnA):
        v = w @ C @ w
        if sig_s < 1e-14:   # Ta == Tb: deterministic spread indicator
            d = math.inf if mu_s > c else -math.inf
        else:
            d = (mu_s + ws @ C @ w - c) / sig_s
        return math.exp(lnA + 0.5 * v) * _phi(d)

    return disc0 * (leg(wa, lnAa) - K * leg(wb, lnAb))


@lru_cache(maxsize=None)
def _g2_exchange_fn(cfg: HWConfig, g: G2Params, Ta: float, Tb: float,
                    K: float, n_paths: int, n_blocks: int, mesh):
    from ..parallel import mesh as pmesh

    LT = jnp.asarray(_state_chol(g, cfg.s1))
    d0 = -0.5 * _v_integral(g, cfg.s1)
    Baa, Bba, vadj_a = _exchange_terms(cfg, g, Ta)
    Bab, Bbb, vadj_b = _exchange_terms(cfg, g, Tb)

    def compute(key, market):
        P1 = hw.interp_curve(market.P, jnp.float32(cfg.s1), cfg)
        Pa0 = hw.interp_curve(market.P, jnp.float32(Ta), cfg)
        Pb0 = hw.interp_curve(market.P, jnp.float32(Tb), cfg)
        Aa = Pa0 / P1 * jnp.exp(jnp.float32(vadj_a))
        Ab = Pb0 / P1 * jnp.exp(jnp.float32(vadj_b))
        disc0 = P1 * jnp.exp(jnp.float32(d0))

        def block(bi):
            xn = jax.random.normal(jax.random.fold_in(key, bi),
                                   (n_paths, 3), jnp.float32)
            z = jnp.dot(xn, LT, preferred_element_type=jnp.float32,
                        precision=cfg.matmul_precision)

            def leg(sgn):
                x, y, I = sgn * z[:, 0], sgn * z[:, 1], sgn * z[:, 2]
                Pa = Aa * jnp.exp(-jnp.float32(Baa) * x
                                  - jnp.float32(Bba) * y)
                Pb = Ab * jnp.exp(-jnp.float32(Bab) * x
                                  - jnp.float32(Bbb) * y)
                disc = disc0 * jnp.exp(-I)
                X = disc * jnp.maximum(Pa - K * Pb, 0.0)
                Yc = disc * Pa - Pa0   # martingale control, E[Yc] = 0
                return X, Yc

            x1, y1 = leg(1.0)
            x2, y2 = leg(-1.0)
            return jnp.stack([
                jnp.sum(x1) + jnp.sum(x2), jnp.sum(y1) + jnp.sum(y2),
                jnp.sum(x1 * x1) + jnp.sum(x2 * x2),
                jnp.sum(y1 * y1) + jnp.sum(y2 * y2),
                jnp.sum(x1 * y1) + jnp.sum(x2 * y2)])

        sums = jnp.sum(pmesh.map_blocks(block, n_blocks, mesh), axis=0)
        return _cv_stats(sums, 2.0 * n_paths * n_blocks)

    return jax.jit(compute)


def price_exchange_g2(cfg: HWConfig, g: G2Params, key,
                      market: MarketCurve, Ta: float, Tb: float,
                      K: float = 1.0, *, n_paths: int | None = None,
                      n_blocks: int = 1, mesh=None) -> G2ZBC:
    """CV-adjusted MC bond-exchange option (see exchange_analytic_g2):
    exact 3-normal states, antithetic, martingale control disc*Pa."""
    if n_paths is None:
        n_paths = cfg.n_paths
    price, raw, beta, se = _g2_exchange_fn(
        cfg, g, float(Ta), float(Tb), float(K), int(n_paths),
        int(n_blocks), mesh)(key, market)
    return G2ZBC(price=price, price_raw=raw, beta=beta, std_error_raw=se,
                 n=int(n_paths) * int(n_blocks))


@lru_cache(maxsize=None)
def _g2_grid_fn(cfg: HWConfig, g: G2Params, Ks_t: tuple, S2_t: tuple,
                n_paths: int, n_blocks: int, mesh):
    from ..parallel import mesh as pmesh

    LT = jnp.asarray(_state_chol(g, cfg.s1))
    d0 = -0.5 * _v_integral(g, cfg.s1)
    terms = [_exchange_terms(cfg, g, t) for t in S2_t]
    vadj = [t[2] for t in terms]
    Ba = jnp.asarray([t[0] for t in terms], jnp.float32)
    Bb = jnp.asarray([t[1] for t in terms], jnp.float32)
    Ks = jnp.asarray(Ks_t, jnp.float32)
    n_k, n_s2 = len(Ks_t), len(S2_t)

    def compute(key, market):
        P1 = hw.interp_curve(market.P, jnp.float32(cfg.s1), cfg)
        P0j = hw.interp_curve(market.P, jnp.asarray(S2_t, jnp.float32),
                              cfg)
        A = P0j / P1 * jnp.exp(jnp.asarray(vadj, jnp.float32))
        disc0 = P1 * jnp.exp(jnp.float32(d0))

        def block(bi):
            xn = jax.random.normal(jax.random.fold_in(key, bi),
                                   (n_paths, 3), jnp.float32)
            z = jnp.dot(xn, LT, preferred_element_type=jnp.float32,
                        precision=cfg.matmul_precision)

            def leg(sgn):
                x, y, I = sgn * z[:, 0], sgn * z[:, 1], sgn * z[:, 2]
                P = A[None, :] * jnp.exp(-Ba[None, :] * x[:, None]
                                         - Bb[None, :] * y[:, None])
                disc = disc0 * jnp.exp(-I)
                X = disc[:, None, None] * jnp.maximum(
                    P[:, None, :] - Ks[None, :, None], 0.0)
                Yc = disc[:, None] * P - P0j[None, :]
                return X, Yc

            x1, y1 = leg(1.0)
            x2, y2 = leg(-1.0)
            s = lambda v: jnp.sum(v, axis=0, dtype=jnp.float32)  # noqa: E731
            return jnp.concatenate([
                (s(x1) + s(x2)).reshape(-1),
                (s(x1 * x1) + s(x2 * x2)).reshape(-1),
                (s(x1 * y1[:, None, :])
                 + s(x2 * y2[:, None, :])).reshape(-1),
                s(y1) + s(y2), s(y1 * y1) + s(y2 * y2)])

        srow = jnp.sum(pmesh.map_blocks(block, n_blocks, mesh), axis=0)
        c = n_k * n_s2
        n = 2.0 * n_paths * n_blocks
        mean_x = srow[:c].reshape(n_k, n_s2) / n
        sxx = srow[c:2 * c].reshape(n_k, n_s2)
        sxy = srow[2 * c:3 * c].reshape(n_k, n_s2)
        mean_yc = srow[3 * c:3 * c + n_s2] / n
        syy = srow[3 * c + n_s2:]
        var_y = syy / n - mean_yc * mean_yc
        var_x = sxx / n - mean_x * mean_x
        cov = sxy / n - mean_x * mean_yc[None, :]
        beta = cov / var_y[None, :]
        price = mean_x - beta * mean_yc[None, :]
        se_raw = jnp.sqrt(jnp.maximum(var_x, 0.0) / n)
        return price, mean_x, beta, se_raw

    return jax.jit(compute)


def price_zbc_grid_g2(cfg: HWConfig, g: G2Params, key,
                      market: MarketCurve, strikes, maturities, *,
                      n_paths: int | None = None, n_blocks: int = 1,
                      mesh=None):
    """CV-adjusted G2++ ZBC price surface over (strikes x maturities)
    from ONE shared set of exact 3-normal states — the two-factor twin of
    grid.price_zbc_grid (exercise at cfg.s1; per-maturity martingale
    controls with per-cell optimal beta).  Returns a grid.ZBCGrid."""
    from ..grid import ZBCGrid

    if n_paths is None:
        n_paths = cfg.n_paths
    Ks_t = tuple(float(x) for x in strikes)
    S2_t = tuple(float(x) for x in maturities)
    price, raw, beta, se = _g2_grid_fn(
        cfg, g, Ks_t, S2_t, int(n_paths), int(n_blocks), mesh)(key, market)
    return ZBCGrid(strikes=jnp.asarray(Ks_t, jnp.float32),
                   maturities=jnp.asarray(S2_t, jnp.float32),
                   price=price, price_raw=raw, beta=beta,
                   std_error_raw=se)


def zbc_grid_analytic_g2(cfg: HWConfig, g: G2Params, market: MarketCurve,
                         strikes, maturities) -> np.ndarray:
    """fp64 closed-form surface: ZBC(K_i, T_j) via the G2++ bond-price
    volatility (per-cell oracle for price_zbc_grid_g2)."""
    from ..instruments import curve_level
    from .oracles import _phi

    out = np.empty((len(strikes), len(maturities)))
    P1 = curve_level(cfg, market, cfg.s1)
    for j, T in enumerate(maturities):
        P2 = curve_level(cfg, market, float(T))
        S = _sigma_zbc(g, cfg.s1, float(T))
        for i, K in enumerate(strikes):
            h = math.log(P2 / (K * P1)) / S + 0.5 * S
            out[i, j] = P2 * _phi(h) - K * P1 * _phi(h - S)
    return out


@lru_cache(maxsize=None)
def _g2_grid_qmc_fn(cfg: HWConfig, g: G2Params, Ks_t: tuple, S2_t: tuple,
                    n_points: int, n_shifts: int):
    from ..ops.sobol import sobol

    LT = jnp.asarray(_state_chol(g, cfg.s1))
    d0 = -0.5 * _v_integral(g, cfg.s1)
    terms = [_exchange_terms(cfg, g, t) for t in S2_t]
    vadj = [t[2] for t in terms]
    Ba = jnp.asarray([t[0] for t in terms], jnp.float32)
    Bb = jnp.asarray([t[1] for t in terms], jnp.float32)
    Ks = jnp.asarray(Ks_t, jnp.float32)

    def one_shift(shift, market):
        P1 = hw.interp_curve(market.P, jnp.float32(cfg.s1), cfg)
        P0j = hw.interp_curve(market.P, jnp.asarray(S2_t, jnp.float32),
                              cfg)
        A = P0j / P1 * jnp.exp(jnp.asarray(vadj, jnp.float32))
        disc0 = P1 * jnp.exp(jnp.float32(d0))
        xn = jax.scipy.special.ndtri(sobol(n_points, 3, shift))
        z = jnp.dot(xn, LT, preferred_element_type=jnp.float32,
                    precision=cfg.matmul_precision)

        def leg(sgn):
            P = A[None, :] * jnp.exp(
                -Ba[None, :] * (sgn * z[:, 0])[:, None]
                - Bb[None, :] * (sgn * z[:, 1])[:, None])
            disc = disc0 * jnp.exp(-sgn * z[:, 2])
            return jnp.mean(disc[:, None, None] * jnp.maximum(
                P[:, None, :] - Ks[None, :, None], 0.0), axis=0)

        return 0.5 * (leg(1.0) + leg(-1.0))

    def compute(key, market):
        shifts = jax.random.bits(key, (n_shifts, 3), jnp.uint32)
        return jax.lax.map(lambda s: one_shift(s, market), shifts)

    return jax.jit(compute)


def vega_zbc_grid_g2(cfg: HWConfig, g: G2Params, key, market: MarketCurve,
                     strikes, maturities, *, eps: float = 1e-3,
                     n_points: int = 1 << 16, n_shifts: int = 8):
    """(vega, se) surfaces over (strikes x maturities): d price/d sigma
    per cell by central differences over the shared-state RQMC surface
    with common random numbers across legs, cells and shifts — the G2++
    twin of grid.vega_zbc_grid (whose one-jvp trick needs traced tables;
    the G2++ statics are host-side fp64 Cholesky factors, so the paired-
    shift RQMC design of vega_zbc_g2_rqmc is lifted to the surface
    instead).  Validated per-cell against the closed-form FD surface
    (vega_zbc_grid_analytic_g2)."""
    Ks_t = tuple(float(x) for x in strikes)
    S2_t = tuple(float(x) for x in maturities)
    gp = G2Params(a=g.a, b=g.b, sigma=g.sigma + eps, eta=g.eta, rho=g.rho)
    gm = G2Params(a=g.a, b=g.b, sigma=g.sigma - eps, eta=g.eta, rho=g.rho)
    vp = _g2_grid_qmc_fn(cfg, gp, Ks_t, S2_t, int(n_points),
                         int(n_shifts))(key, market)
    vm = _g2_grid_qmc_fn(cfg, gm, Ks_t, S2_t, int(n_points),
                         int(n_shifts))(key, market)
    d = (vp - vm) / (2.0 * eps)            # (n_shifts, nK, nS2)
    return (jnp.mean(d, axis=0),
            jnp.std(d, axis=0, ddof=1) / jnp.sqrt(1.0 * d.shape[0]))


def vega_zbc_grid_analytic_g2(cfg: HWConfig, g: G2Params,
                              market: MarketCurve, strikes, maturities,
                              *, eps: float = 1e-3) -> np.ndarray:
    """fp64 closed-form FD vega surface (per-cell oracle for
    vega_zbc_grid_g2)."""
    gp = G2Params(a=g.a, b=g.b, sigma=g.sigma + eps, eta=g.eta, rho=g.rho)
    gm = G2Params(a=g.a, b=g.b, sigma=g.sigma - eps, eta=g.eta, rho=g.rho)
    up = zbc_grid_analytic_g2(cfg, gp, market, strikes, maturities)
    dn = zbc_grid_analytic_g2(cfg, gm, market, strikes, maturities)
    return (up - dn) / (2.0 * eps)


class G2Calibration(NamedTuple):
    params: "G2Params"
    rmse: float
    n_iter: int
    residuals: tuple


def calibrate_g2(cfg: HWConfig, g0: G2Params, quotes, *, tol: float = 1e-12,
                 max_iter: int = 80) -> G2Calibration:
    """Fit (sigma, eta, rho) of G2++ to closed-form instrument quotes
    with (a, b) held fixed — the market-standard reduced calibration
    (mean reversions from historical/term-structure fit, volatilities
    and correlation from the option surface).

    ``quotes``: sequence of ``(pricer, target)`` with
    ``pricer(g: G2Params) -> float64 price`` — build from
    ``zbc_price_analytic``/``swaption_g2_analytic``/``cap_closed_form_g2``
    partials.  Damped Gauss-Newton in (log sigma, log eta, atanh rho)
    so positivity and |rho| < 1 are built in (same scheme as
    greeks.calibrate_hw)."""
    th = np.array([math.log(g0.sigma), math.log(g0.eta),
                   math.atanh(min(max(g0.rho, -0.999), 0.999))])

    def mk(t):
        return G2Params(a=g0.a, b=g0.b, sigma=float(math.exp(t[0])),
                        eta=float(math.exp(t[1])),
                        rho=float(math.tanh(t[2])))

    def resid(t):
        gp = mk(t)
        return np.array([p(gp) - tgt for p, tgt in quotes], np.float64)

    r = resid(th)
    lam = 1e-10
    it = 0
    for it in range(1, max_iter + 1):
        eps = 1e-6
        J = np.empty((len(r), 3))
        for j in range(3):
            tp = th.copy()
            tp[j] += eps
            J[:, j] = (resid(tp) - r) / eps
        A = J.T @ J
        step = np.linalg.solve(A + lam * np.diag(np.diag(A) + 1e-30),
                               J.T @ r)
        th_new = th - step
        r_new = resid(th_new)
        if np.sum(r_new ** 2) <= np.sum(r ** 2):
            th, r = th_new, r_new
            lam = max(lam * 0.25, 1e-12)
        else:
            lam *= 10.0
        if np.max(np.abs(step)) < tol or np.sum(r ** 2) < tol:
            break
    return G2Calibration(params=mk(th),
                         rmse=float(np.sqrt(np.mean(r ** 2))),
                         n_iter=it, residuals=tuple(map(float, r)))


def delta_bermudan_g2(cfg: HWConfig, g: G2Params, key,
                      market: MarketCurve, sched, exercise_dates, *,
                      strike: float = 1.0, payer: bool = False,
                      h: float = 1e-3, n_paths: int | None = None,
                      n_blocks: int = 1, rqmc: bool = False, mesh=None):
    """(delta_lower, delta_upper): d/dh of the G2++ Bermudan bracket under
    a parallel forward-curve shift, CRN central differences (same key =>
    identical exact multi-date states; only the payoff coefficients move
    — see greeks.bermudan_delta for the one-factor analogue and the DP
    oracle test)."""
    from .. import greeks

    mp = greeks.shift_curve(cfg, market, +h)
    mm = greeks.shift_curve(cfg, market, -h)
    rp = price_bermudan_g2(cfg, g, key, mp, sched, exercise_dates,
                           strike=strike, payer=payer, n_paths=n_paths,
                           n_blocks=n_blocks, rqmc=rqmc, mesh=mesh)
    rm = price_bermudan_g2(cfg, g, key, mm, sched, exercise_dates,
                           strike=strike, payer=payer, n_paths=n_paths,
                           n_blocks=n_blocks, rqmc=rqmc, mesh=mesh)
    return ((float(rp.price) - float(rm.price)) / (2.0 * h),
            (float(rp.upper) - float(rm.upper)) / (2.0 * h))


def vega_zbc_g2_analytic(cfg: HWConfig, g: G2Params, market: MarketCurve,
                         eps: float = 1e-6) -> float:
    """fp64 oracle: central difference of the closed form."""
    gp = G2Params(a=g.a, b=g.b, sigma=g.sigma + eps, eta=g.eta, rho=g.rho)
    gm = G2Params(a=g.a, b=g.b, sigma=g.sigma - eps, eta=g.eta, rho=g.rho)
    return (zbc_price_analytic(cfg, gp, market)
            - zbc_price_analytic(cfg, gm, market)) / (2.0 * eps)


def vega_swaption_g2(cfg: HWConfig, g: G2Params, key, market: MarketCurve,
                     sched, *, strike: float = 1.0, payer: bool = False,
                     eps: float = 1e-3, n_paths: int | None = None):
    """Swaption vega by CRN central differences (MC)."""
    gp = G2Params(a=g.a, b=g.b, sigma=g.sigma + eps, eta=g.eta, rho=g.rho)
    gm = G2Params(a=g.a, b=g.b, sigma=g.sigma - eps, eta=g.eta, rho=g.rho)
    pp = price_swaption_g2(cfg, gp, key, market, sched, strike=strike,
                           payer=payer, n_paths=n_paths).price
    pm = price_swaption_g2(cfg, gm, key, market, sched, strike=strike,
                           payer=payer, n_paths=n_paths).price
    return (pp - pm) / (2.0 * eps)


def vega_swaption_g2_rqmc(cfg: HWConfig, g: G2Params, key,
                          market: MarketCurve, sched, *,
                          strike: float = 1.0, payer: bool = False,
                          eps: float = 1e-3, n_points: int = 1 << 16,
                          n_shifts: int = 8):
    """(vega, se): swaption d/dsigma by central differences with paired
    Sobol shifts across the sigma+/-eps legs (see vega_zbc_g2_rqmc)."""
    gp = G2Params(a=g.a, b=g.b, sigma=g.sigma + eps, eta=g.eta, rho=g.rho)
    gm = G2Params(a=g.a, b=g.b, sigma=g.sigma - eps, eta=g.eta, rho=g.rho)
    args = (tuple(sched.times), tuple(sched.coupons), float(strike),
            bool(payer), int(n_points), int(n_shifts))
    _, _, vp = _g2_cbo_qmc_fn(cfg, gp, *args)(key, market)
    _, _, vm = _g2_cbo_qmc_fn(cfg, gm, *args)(key, market)
    d = (vp - vm) / (2.0 * eps)
    return (jnp.mean(d),
            jnp.std(d, ddof=1) / jnp.sqrt(1.0 * n_shifts))


def vega_swaption_g2_analytic(cfg: HWConfig, g: G2Params,
                              market: MarketCurve, sched, *,
                              strike: float = 1.0, payer: bool = False,
                              eps: float = 1e-5) -> float:
    """fp64 oracle: central difference of the 1-d-integral closed form."""
    gp = G2Params(a=g.a, b=g.b, sigma=g.sigma + eps, eta=g.eta, rho=g.rho)
    gm = G2Params(a=g.a, b=g.b, sigma=g.sigma - eps, eta=g.eta, rho=g.rho)
    return (swaption_g2_analytic(cfg, gp, market, sched, strike=strike,
                                 payer=payer)
            - swaption_g2_analytic(cfg, gm, market, sched, strike=strike,
                                   payer=payer)) / (2.0 * eps)


@lru_cache(maxsize=None)
def _g2_zbc_qmc_fn(cfg: HWConfig, g: G2Params, n_points: int,
                   n_shifts: int):
    from ..ops.sobol import sobol

    LT = jnp.asarray(_state_chol(g, cfg.s1))
    a, b = g.a, g.b
    tau = cfg.s2 - cfg.s1
    Ba = jnp.float32(_B(a, tau))
    Bb = jnp.float32(_B(b, tau))
    vadj = 0.5 * (_v_integral(g, tau) - _v_integral(g, cfg.s2)
                  + _v_integral(g, cfg.s1))
    d0 = -0.5 * _v_integral(g, cfg.s1)

    def one_shift(shift, market):
        P1 = hw.interp_curve(market.P, jnp.float32(cfg.s1), cfg)
        P2 = hw.interp_curve(market.P, jnp.float32(cfg.s2), cfg)
        A = (P2 / P1) * jnp.exp(jnp.float32(vadj))
        disc0 = P1 * jnp.exp(jnp.float32(d0))
        u = sobol(n_points, 3, shift)
        xn = jax.scipy.special.ndtri(u)
        z = jnp.dot(xn, LT, preferred_element_type=jnp.float32,
                    precision=cfg.matmul_precision)

        def leg(sgn):
            Pb = A * jnp.exp(-Ba * sgn * z[:, 0] - Bb * sgn * z[:, 1])
            return jnp.mean(disc0 * jnp.exp(-sgn * z[:, 2])
                            * jnp.maximum(Pb - cfg.strike, 0.0))

        return 0.5 * (leg(1.0) + leg(-1.0))

    def compute(key, market):
        shifts = jax.random.bits(key, (n_shifts, 3), jnp.uint32)
        vals = jax.lax.map(lambda s: one_shift(s, market), shifts)
        return (jnp.mean(vals),
                jnp.std(vals, ddof=1) / jnp.sqrt(1.0 * n_shifts),
                vals)

    return jax.jit(compute)


def price_zbc_g2_qmc(cfg: HWConfig, g: G2Params, key, market: MarketCurve,
                     n_points: int = 1 << 16, n_shifts: int = 8):
    """Randomized-QMC G2++ ZBC: 3-d scrambled Sobol through the exact
    functional law (the G2++ analogue of ops.qmc.price_zbc_qmc)."""
    mean, se, _ = _g2_zbc_qmc_fn(cfg, g, n_points, n_shifts)(key, market)
    return mean, se


@lru_cache(maxsize=None)
def _g2_cbo_qmc_fn(cfg: HWConfig, g: G2Params, times, coupons,
                   strike: float, payer: bool, n_points: int,
                   n_shifts: int):
    from ..ops.sobol import sobol

    LT = jnp.asarray(_state_chol(g, cfg.s1))
    d0 = -0.5 * _v_integral(g, cfg.s1)
    vadj = [0.5 * (_v_integral(g, t - cfg.s1) - _v_integral(g, t)
                   + _v_integral(g, cfg.s1)) for t in times]
    Ba = jnp.asarray([_B(g.a, t - cfg.s1) for t in times], jnp.float32)
    Bb = jnp.asarray([_B(g.b, t - cfg.s1) for t in times], jnp.float32)
    sgn_pay = -1.0 if payer else 1.0

    def one_shift(shift, market):
        P1 = hw.interp_curve(market.P, jnp.float32(cfg.s1), cfg)
        P0i = hw.interp_curve(market.P, jnp.asarray(times, jnp.float32),
                              cfg)
        lam0 = (jnp.asarray(coupons, jnp.float32) * P0i / P1
                * jnp.exp(jnp.asarray(vadj, jnp.float32)))
        disc0 = P1 * jnp.exp(jnp.float32(d0))
        u = sobol(n_points, 3, shift)
        xn = jax.scipy.special.ndtri(u)
        z = jnp.dot(xn, LT, preferred_element_type=jnp.float32,
                    precision=cfg.matmul_precision)

        def leg(sgn):
            V = jnp.sum(lam0[None, :]
                        * jnp.exp(-Ba[None, :] * (sgn * z[:, 0])[:, None]
                                  - Bb[None, :] * (sgn * z[:, 1])[:, None]),
                        axis=1)
            disc = disc0 * jnp.exp(-sgn * z[:, 2])
            return jnp.mean(disc * jnp.maximum(sgn_pay * (V - strike), 0.0))

        return 0.5 * (leg(1.0) + leg(-1.0))

    def compute(key, market):
        shifts = jax.random.bits(key, (n_shifts, 3), jnp.uint32)
        vals = jax.lax.map(lambda s: one_shift(s, market), shifts)
        return (jnp.mean(vals),
                jnp.std(vals, ddof=1) / jnp.sqrt(1.0 * n_shifts),
                vals)

    return jax.jit(compute)


def price_swaption_g2_qmc(cfg: HWConfig, g: G2Params, key,
                          market: MarketCurve, sched, *,
                          strike: float = 1.0, payer: bool = False,
                          n_points: int = 1 << 16, n_shifts: int = 8):
    """(price, se): randomized-QMC G2++ coupon-bond option / European
    swaption on the fixed leg — the same exact 3-normal functional law as
    price_swaption_g2 driven by scrambled Sobol points (the G2++ analogue
    of ops.qmc's shared-state swaption RQMC).  SE ~1e-7 at 2^16 points,
    sharp enough to separate MC noise from oracle bias."""
    mean, se, _ = _g2_cbo_qmc_fn(
        cfg, g, tuple(sched.times), tuple(sched.coupons), float(strike),
        bool(payer), int(n_points), int(n_shifts))(key, market)
    return mean, se


def vega_zbc_g2_rqmc(cfg: HWConfig, g: G2Params, key, market: MarketCurve,
                     *, eps: float = 1e-3, n_points: int = 1 << 16,
                     n_shifts: int = 8):
    """(vega, se): d price / d sigma by central differences over the RQMC
    estimator with common random numbers ACROSS LEGS AND SHIFTS — the same
    key drives identical Sobol points + scrambling shifts at sigma±eps, so
    the per-shift FD replicates pair exactly and the SE is the paired one
    (the CUDA reference's CRN trick, 3_sensitivity_analysis.cu:407-435,
    lifted to the RQMC tier; per-run sd collapses ~100x vs the 2^20-path
    MC CRN-FD)."""
    gp = G2Params(a=g.a, b=g.b, sigma=g.sigma + eps, eta=g.eta, rho=g.rho)
    gm = G2Params(a=g.a, b=g.b, sigma=g.sigma - eps, eta=g.eta, rho=g.rho)
    _, _, vp = _g2_zbc_qmc_fn(cfg, gp, n_points, n_shifts)(key, market)
    _, _, vm = _g2_zbc_qmc_fn(cfg, gm, n_points, n_shifts)(key, market)
    d = (vp - vm) / (2.0 * eps)
    return (jnp.mean(d),
            jnp.std(d, ddof=1) / jnp.sqrt(1.0 * n_shifts))


# ---------------------------------------------------------------------------
# Bermudan under G2++: exact multi-date states + closed-form value
# iteration with an AB dual bracket (round 3 rewrite; round 2 was LSMC)
# ---------------------------------------------------------------------------

def _eint(alpha: float, m: float) -> float:
    """int_0^m e^{alpha u} du (exact, alpha -> 0 safe)."""
    if abs(alpha) < 1e-14:
        return m
    return (math.exp(alpha * m) - 1.0) / alpha


def _cov_xx(k1, v1, k2, v2, c, s, t):
    """Cov(x1(s), x2(t)) for OU factors driven by c-correlated Brownians."""
    m = min(s, t)
    return c * v1 * v2 * math.exp(-k1 * s - k2 * t) * _eint(k1 + k2, m)


def _cov_xI(k1, v1, k2, v2, c, s, T):
    """Cov(x1(s), I2(T)) with I2(T) = v2/k2 int_0^T (1-e^{-k2(T-u)}) dW2."""
    m = min(s, T)
    return (c * v1 * v2 / k2
            * (math.exp(-k1 * s) * _eint(k1, m)
               - math.exp(-k1 * s - k2 * T) * _eint(k1 + k2, m)))


def _cov_II(k1, v1, k2, v2, c, T1, T2):
    """Cov(I1(T1), I2(T2)) (both factors' integral contributions)."""
    m = min(T1, T2)
    return (c * v1 * v2 / (k1 * k2)
            * (m - math.exp(-k1 * T1) * _eint(k1, m)
               - math.exp(-k2 * T2) * _eint(k2, m)
               + math.exp(-k1 * T1 - k2 * T2) * _eint(k1 + k2, m)))


@lru_cache(maxsize=None)
def _g2_joint_cov(g: G2Params, ex_dates: tuple) -> np.ndarray:
    """fp64 Cov(x_1, y_1, I_1, ..., x_k, y_k, I_k) at the exercise dates
    (exact continuous-time law, assembled from the elementary exponential
    integral _eint), with the 1e-16 diagonal jitter used by the sampler
    (so every conditional law derived from it matches the SAMPLED law
    exactly, which is what makes the dual martingale exact)."""
    a, b, s_, e_, r = g.a, g.b, g.sigma, g.eta, g.rho
    k = len(ex_dates)
    # factor spec per state row: x -> (a, sigma), y -> (b, eta)
    C = np.zeros((3 * k, 3 * k))

    def cov(i_kind, ti, j_kind, tj):
        # kinds: 0 = x, 1 = y, 2 = I (= Ix + Iy)
        facs = [(a, s_), (b, e_)]

        def corr(f1, f2):
            return 1.0 if f1 == f2 else r

        if i_kind < 2 and j_kind < 2:
            k1, v1 = facs[i_kind]
            k2, v2 = facs[j_kind]
            return _cov_xx(k1, v1, k2, v2, corr(i_kind, j_kind), ti, tj)
        if i_kind < 2 and j_kind == 2:
            k1, v1 = facs[i_kind]
            return sum(_cov_xI(k1, v1, facs[f][0], facs[f][1],
                               corr(i_kind, f), ti, tj) for f in (0, 1))
        if i_kind == 2 and j_kind < 2:
            return cov(j_kind, tj, i_kind, ti)
        return sum(_cov_II(facs[f1][0], facs[f1][1], facs[f2][0],
                           facs[f2][1], corr(f1, f2), ti, tj)
                   for f1 in (0, 1) for f2 in (0, 1))

    for i in range(3 * k):
        for j in range(i, 3 * k):
            C[i, j] = C[j, i] = cov(i % 3, ex_dates[i // 3],
                                    j % 3, ex_dates[j // 3])
    return C + 1e-16 * np.eye(3 * k)


@lru_cache(maxsize=None)
def _g2_joint_chol(g: G2Params, ex_dates: tuple):
    """fp32 Cholesky^T of the joint (x, y, I) covariance (sampler)."""
    L = np.linalg.cholesky(_g2_joint_cov(g, ex_dates))
    return np.asarray(L.T, np.float32)


@lru_cache(maxsize=None)
def _g2_interval_cond(g: G2Params, ex_dates: tuple):
    """fp64 conditional-Gaussian parameters of each exercise interval.

    For date j, conditional on the Markov state (x_s, y_s) at date j-1
    (date 0 conditions on the time-0 state x = y = 0), the triple
    u = (x_t, y_t, dI = I_t - I_s) is Gaussian:

      E[u | x_s, y_s] = B2 (x_s, y_s)^T,   Cov[u | .] = R

    computed by Schur complement DIRECTLY on the jittered joint covariance
    the sampler draws from (not the homogeneous closed forms), so the
    conditional law is exact for the sampled states; the Markov property
    makes conditioning on (x_s, y_s) equal to conditioning on the full
    history.  Returns per-date dicts of B2 rows (bxx..bIy) and R entries
    (vx, vy, cxy, cxI, cyI, vII)."""
    C = _g2_joint_cov(g, ex_dates)
    out = []
    for j in range(len(ex_dates)):
        ix, iy, iI = 3 * j, 3 * j + 1, 3 * j + 2
        if j == 0:
            B2 = np.zeros((3, 2))
            R = C[np.ix_([ix, iy, iI], [ix, iy, iI])]
        else:
            px, py, pI = 3 * j - 3, 3 * j - 2, 3 * j - 1
            cov_us = np.array([
                [C[ix, px], C[ix, py]],
                [C[iy, px], C[iy, py]],
                [C[iI, px] - C[pI, px], C[iI, py] - C[pI, py]]])
            S = C[np.ix_([px, py], [px, py])]
            B2 = cov_us @ np.linalg.inv(S)
            cuu = np.array([
                [C[ix, ix], C[ix, iy], C[ix, iI] - C[ix, pI]],
                [C[iy, ix], C[iy, iy], C[iy, iI] - C[iy, pI]],
                [C[iI, ix] - C[pI, ix], C[iI, iy] - C[pI, iy],
                 C[iI, iI] - 2.0 * C[iI, pI] + C[pI, pI]]])
            R = cuu - B2 @ cov_us.T
        out.append(dict(bxx=B2[0, 0], bxy=B2[0, 1], byx=B2[1, 0],
                        byy=B2[1, 1], bIx=B2[2, 0], bIy=B2[2, 1],
                        vx=R[0, 0], vy=R[1, 1], cxy=R[0, 1],
                        cxI=R[0, 2], cyI=R[1, 2], vII=R[2, 2]))
    return tuple(out)


PROXY_DEG = 6  # total degree of the 2-d monomial proxy basis.  Degree
# matters more than structure here: the continuation surface's Taylor
# scale in standardized states is (B sigma_x) ~ 0.2, so a cubic fit
# leaves ~(0.2)^4/24 ~ 7e-5 residual (the measured round-2 dual gap)
# while quintic leaves ~1e-7 on a SINGLE European surface.  Round 4
# raises 5 -> 6: the k=3 date-1 continuation is a composed Black-like
# surface whose smooth misfit under the quintic was the measured
# ~7-10e-6 dual-gap residual; degree 6 takes a paired-key 3e-6 off it
# (degree 7 was noise-equal at worse fp32 Gram conditioning).
POWXY = tuple((d - iy, iy) for d in range(PROXY_DEG + 1)
              for iy in range(d + 1))
# boundary-relative spline knots: cubic truncated-power columns
# (t - delta)^3_+ in t = sg (v - b(pc)) / sv, the signed distance to the
# exercise boundary in bisected-coordinate sigmas.  They absorb the
# non-polynomial ridge the next date's mollified kink leaves in the
# continuation surface (measured: v-direction residual oscillation
# ~5e-4 under the pure monomial fit); their truncated moments are the
# same U-recursion closed forms, so the martingale stays exact.
# round 4 widens the knot ladder to +-2.0: the mollified-kink ridge's
# Phi-shaped tails extend past the +-1.2 coverage and the missing outer
# knots were worth a paired-key 4e-6 of k=3 dual gap on their own.
SPLINE_DELTAS = (-2.0, -1.2, -0.6, 0.0, 0.6, 1.2, 2.0)
# round-3b: each knot column is TENSORED with probe powers pt^a
# (a <= SPLINE_PDEG) — the kink ridge's AMPLITUDE varies along the
# boundary, which a pc-constant spline coefficient cannot track.
# Their conditional moments are the SAME closed forms: pt is a
# deterministic function of the outer Gauss-Hermite variable, so it
# multiplies through the v-moment.  Round 4 raises the tensor degree
# to 3 (amplitude curvature along the boundary).  Combined round-4
# basis (N_PROXY 37 -> 57), all paired-key 2^17-path measurements vs
# the (481, 96) cubic fp64 DP oracle on the annual bracket:
#   k=3 upper gap  +9.8e-6 -> +3.4e-6 (width 7.3e-6 -> 3.9e-6; the
#     remaining ~2-3e-6 is the documented fp32 eval floor —
#     the paired lower bound sits at the same offset),
#   k=5 annual width 8.7e-7 -> 4.1e-7,  k=2 unchanged at the floor,
#   k=5 SEMIANNUAL (the hard round-3b A/B case) width 6.1e-5 -> 2.9e-5.
SPLINE_PDEG = 3
N_SPL = len(SPLINE_DELTAS) * (SPLINE_PDEG + 1)
N_PROXY = len(POWXY) + N_SPL + 1               # + the bond feature W
N_GH = 24      # Gauss-Hermite nodes for the dual's p-direction integral
BOUND_DEG = 3  # polynomial degree of the fitted exercise-boundary curve
BOUND_RANGE = 3.5  # probe range (in p-sigmas) of the boundary fit
# columns used for the dual value-proxy fit (indices into
# _g2_proxy_cols); the greedy policy needs no regression at all — it
# thresholds on the proxy's own closed-form continuation.  The bond
# feature W is EXCLUDED: its quintic-Taylor content makes it nearly a
# linear combination of the monomial columns, and the resulting
# huge-and-canceling fp32 coefficients (|gamma_W| ~ 60 measured) turn
# rounding differences between the value and cond evaluations into a
# ~1e-4 systematic martingale defect; the monomials alone leave only a
# ~(B sigma)^6 ~ 1e-7 basis residual.
_VAL_COLS = tuple(range(N_PROXY - 1))  # monomials + splines, no W


def _w_feature_consts(lam_j, Ba, Bb, sx, sy):
    """Detrending constants of the bond-value feature W (round 3).

    W(x, y) = (V_bond(x, y)/v0 - 1 - c1 x~ - c2 y~) / cn with
    v0 = V_bond(0, 0) (the G2 states are centered), c1/c2 the exact
    scaled gradients and cn the (sx, sy)-directional curvature — so W is
    O(x~^2)-shaped and the fp32 Gram matrix stays well conditioned (the
    raw feature is ~0.999-correlated with the linear columns, the same
    failure mode bermudan._vb_norms fixes in 1-d).  Unlike the 1-d
    policy feature, W is NOT clipped here: the dual proxy must have an
    exact closed-form conditional expectation, and each e^{-Ba x - Bb y}
    term tilts in closed form (the Gaussian states make the unclipped
    tails harmless: |x~| > 8 has mass ~1e-15)."""
    v0 = jnp.sum(lam_j)
    c1 = -jnp.sum(lam_j * Ba) * sx / v0
    c2 = -jnp.sum(lam_j * Bb) * sy / v0
    cn = 0.5 * jnp.sum(lam_j * (Ba * sx + Bb * sy) ** 2) / v0 + 1e-12
    return v0, c1, c2, cn


def _g2_proxy_cols(x, y, sx, sy, lam_j, Ba, Bb, bnd, swap, pscale, sg):
    """The N_PROXY proxy basis columns: every monomial x~^i y~^j of
    total degree <= PROXY_DEG (POWXY order), then the boundary-relative
    spline columns (t - delta)^3_+ (SPLINE_DELTAS), then the detrended
    bond-value feature W, as a (n, N_PROXY) matrix (W is excluded from
    the fit by _VAL_COLS but kept evaluable: its closed-form tilted
    expectation documents the exponential-feature machinery)."""
    xt, yt = x / sx, y / sy
    V = jnp.sum(lam_j[None, :] * _exp(-Ba[None, :] * x[:, None]
                                         - Bb[None, :] * y[:, None]),
                axis=1)
    v0, c1, c2, cn = _w_feature_consts(lam_j, Ba, Bb, sx, sy)
    W = (V / v0 - 1.0 - c1 * xt - c2 * yt) / cn
    xp = [jnp.ones_like(xt)]
    yp = [jnp.ones_like(yt)]
    for _ in range(PROXY_DEG):
        xp.append(xp[-1] * xt)
        yp.append(yp[-1] * yt)
    p, v = (y, x) if swap else (x, y)
    sv_m = sx if swap else sy
    sp_m = sy if swap else sx
    t = sg * (v - _g2_boundary_eval(bnd, p / pscale)) / sv_m
    ptp = p / sp_m
    spl = []
    for d in SPLINE_DELTAS:
        base = jnp.maximum(t - d, 0.0) ** 3
        fac = jnp.ones_like(ptp)
        for _ in range(SPLINE_PDEG + 1):
            spl.append(base * fac)
            fac = fac * ptp
    return jnp.stack([xp[ix] * yp[iy] for ix, iy in POWXY] + spl + [W],
                     axis=1)


def _g2_boundary_eval(c, u):
    """Evaluate the fitted boundary polynomial b(u) = sum_m c_m u^m
    (Horner; u is the probe coordinate in pscale units)."""
    out = c[BOUND_DEG]
    for m in range(BOUND_DEG - 1, -1, -1):
        out = out * u + c[m]
    return out


def _g2_piecewise_value(x, y, gamma, sx, sy, lam_j, Ba, Bb, strike,
                        bnd, swap, pscale, sg, prec):
    """Dual value proxy V^(x, y): intrinsic sg(V_bond - K) on the
    exercise side of the fitted CURVED boundary v = b(p) (p the probe
    coordinate, v the bisected one; ``swap`` statically picks which of
    x/y is which, so either factor may degenerate), a full 2-d cubic
    plus the raw bond-value feature W (11 columns, _g2_proxy_cols) on
    the continuation side.  Receiver sg = +1 exercises at LOW v, payer
    sg = -1 at HIGH v.  Round 3: the boundary is a degree-BOUND_DEG
    polynomial in p rather than a straight line — the conditional
    expectation stays (near-)exact because v given p keeps 1-d
    truncated-Gaussian/lognormal closed forms and the p-direction is a
    SMOOTH integral handled by Gauss-Hermite in _g2_piecewise_cond."""
    V = jnp.sum(lam_j[None, :] * _exp(-Ba[None, :] * x[:, None]
                                         - Bb[None, :] * y[:, None]),
                axis=1)
    intr = sg * (V - strike)
    X = _g2_proxy_cols(x, y, sx, sy, lam_j, Ba, Bb, bnd, swap, pscale,
                       sg)
    poly = jnp.dot(X, gamma, precision=prec)
    p, v = (y, x) if swap else (x, y)
    bcut = _g2_boundary_eval(bnd, p / pscale)
    return jnp.where(sg * (bcut - v) > 0, intr, poly)


def _g2_piecewise_cond(gamma, sx, sy, lam_j, Ba, Bb, strike, bnd, swap,
                       pscale, sg, mx, my, mI, p):
    """E[ e^{-dI} V^(x_t, y_t) | x_s, y_s ] for the curved-boundary
    piecewise proxy: exact in the bisected coordinate, Gauss-Hermite in
    the probe coordinate.

    (x_t, y_t, dI) | (x_s, y_s) is trivariate Gaussian with per-path
    means (mx, my, mI) and constant covariance p (from
    _g2_interval_cond).  Tilting by e^{-dI} multiplies by
    w0 = e^{-mI + vII/2} and shifts the (x, y) means by (-cxI, -cyI).
    Writing (pc, v) for the (probe, bisected) coordinates (``swap``
    statically picks which of x/y is which), the proxy's exercise set is
    {sg (b(pc) - v) > 0} with b the fitted boundary POLYNOMIAL
    (_g2_boundary_eval).  Conditioning on pc:

    * v | pc is 1-d Gaussian, so on the exercise side each bond term
      e^{-gp pc - gv v} takes the truncated-lognormal mean
      e^{-gp pc} e^{-gv m + gv^2 s^2/2} Phi(sg((b(pc) - m)/s + gv s))
      and the strike term is sg-truncated mass — the SAME closed forms
      as the 1-factor dual (bermudan._piecewise_cond);
    * on the continuation side every basis monomial p^a v^c splits into
      p^a times a truncated v power moment (T0..T3), and the bond
      feature W reuses the complementary exponential means;
    * the OUTER pc-integral has a smooth integrand (the v-kink is
      integrated out exactly, and Phi/phi are analytic), so N_GH-node
      Gauss-Hermite is accurate to ~1e-9 — the measured martingale
      defect, far below the MC noise (validated against a 200-node
      reference in tests).

    The increments make M a martingale up to that quadrature floor, so
    the AB bound is valid to the same precision — no nested simulation,
    and no straight-line boundary-curvature error (the round-2 line
    proxy left a ~4e-5 dual gap; this form removes it)."""
    from jax.scipy.stats import norm as jnorm

    f32 = jnp.float32
    vx, vy, cxy = f32(p["vx"]), f32(p["vy"]), f32(p["cxy"])
    cxI, cyI, vII = f32(p["cxI"]), f32(p["cyI"]), f32(p["vII"])
    w0 = _exp(-mI + 0.5 * vII)
    mx_ = mx - cxI
    my_ = my - cyI
    if swap:      # probe coordinate is y, bisected coordinate is x
        mp, mv, vp, vv, cpv = my_, mx_, vy, vx, cxy
        gp, gv = Bb, Ba
        sp_m, sv_m = sy, sx
    else:         # probe x, bisected y
        mp, mv, vp, vv, cpv = mx_, my_, vx, vy, cxy
        gp, gv = Ba, Bb
        sp_m, sv_m = sx, sy
    vp_s = jnp.maximum(vp, 1e-18)
    sp = jnp.sqrt(vp_s)
    beta_vp = cpv / vp_s
    s2 = jnp.maximum(vv - cpv * beta_vp, 1e-18)
    s = jnp.sqrt(s2)
    v0, c1, c2, cn = _w_feature_consts(lam_j, Ba, Bb, sx, sy)
    # detrending slopes of W in (pc, v) coordinates
    c_p, c_v = (c2, c1) if swap else (c1, c2)
    # basis exponents (a in pc, c in v) per column, after the swap
    POW = [(iy, ix) if swap else (ix, iy) for ix, iy in POWXY]
    nodes, wq = np.polynomial.hermite_e.hermegauss(N_GH)
    wq = wq / math.sqrt(2.0 * math.pi)
    uw = (jnp.asarray(nodes, jnp.float32), jnp.asarray(wq, jnp.float32))

    def node(acc, uw1):
        u, w = uw1
        pc = mp + sp * u                     # (n,) probe value
        m = mv + beta_vp * (pc - mp)         # v | pc mean
        bcut = _g2_boundary_eval(bnd, pc / pscale)
        alpha = (bcut - m) / s
        phi_a = _npdf(alpha)
        # standardized sided moments on the CONTINUATION side, by the
        # recursion U_p = sg alpha^{p-1} phi + (p-1) U_{p-2}
        U = [jnorm.cdf(-sg * alpha), sg * phi_a]
        apow = jnp.ones_like(alpha)
        for pdeg in range(2, PROXY_DEG + 1):
            apow = apow * alpha
            U.append(sg * apow * phi_a + (pdeg - 1) * U[pdeg - 2])
        # raw truncated moments T_c = E[v^c 1{cont side} | pc] via the
        # binomial expansion v = m + s w
        spow = [1.0]
        for _ in range(PROXY_DEG):
            spow.append(spow[-1] * s)
        Ts = []
        for c in range(PROXY_DEG + 1):
            t = U[0] * m ** c if c else U[0]
            for i in range(1, c + 1):
                t = t + math.comb(c, i) * m ** (c - i) * spow[i] * U[i]
            Ts.append(t)
        # exercise-side exponentials (truncated-lognormal means)
        eterm = (lam_j[None, :]
                 * _exp(-gp[None, :] * pc[:, None]
                           - gv[None, :] * m[:, None]
                           + 0.5 * (gv * gv)[None, :] * s2))
        e_ex = jnp.sum(eterm * jnorm.cdf(sg * (alpha[:, None]
                                               + gv[None, :] * s)),
                       axis=1)
        e_full = jnp.sum(eterm, axis=1)
        e_intr = sg * (e_ex - strike * jnorm.cdf(sg * alpha))
        # continuation-side polynomial columns: p^a v^c factorizes
        pt = pc / sp_m
        ppow = [jnp.ones_like(pt)]
        for _ in range(PROXY_DEG):
            ppow.append(ppow[-1] * pt)
        e_poly = sum(gamma[col] * ppow[a] * Ts[c] / sv_m ** c
                     for col, (a, c) in enumerate(POW))
        # boundary-relative spline columns: central moments of
        # t = sg (v - b)/sv_m around delta, upper-truncated in t at
        # max(delta, 0) (the feature's own knot or the boundary,
        # whichever binds on the continuation side)
        m_t = sg * (m - bcut) / sv_m
        s_t = s / sv_m
        s_t2 = s_t * s_t
        e_sp = jnp.zeros_like(m)
        for i, dlt in enumerate(SPLINE_DELTAS):
            at = (max(dlt, 0.0) - m_t) / s_t
            phi_t = _npdf(at)
            V0 = jnorm.cdf(-at)
            V2 = V0 + at * phi_t
            V3 = (2.0 + at * at) * phi_t
            md = m_t - dlt
            mom = (md ** 3 * V0 + 3.0 * md * md * s_t * phi_t
                   + 3.0 * md * s_t2 * V2 + s_t2 * s_t * V3)
            # tensor factor: pt^a is deterministic at the node, so it
            # multiplies straight through the v-moment (closed form,
            # martingale exactness preserved)
            base_col = len(POWXY) + i * (SPLINE_PDEG + 1)
            coef = sum(gamma[base_col + a] * ppow[a]
                       for a in range(SPLINE_PDEG + 1))
            e_sp = e_sp + coef * mom
        # bond feature W on the continuation side
        e_W = ((e_full - e_ex) / v0 - Ts[0] - c_p * pt * Ts[0]
               - c_v * Ts[1] / sv_m) / cn
        return (acc + w * (e_intr + e_poly + e_sp
                           + gamma[N_PROXY - 1] * e_W), None)

    acc0 = jnp.zeros_like(mp)
    total, _ = lax.scan(node, acc0, uw)
    return w0 * total


class G2Bermudan(NamedTuple):
    price: jax.Array            # out-of-sample greedy-policy lower bound
    price_in_sample: jax.Array  # same policy on the proxy-fit cloud
    std_error: jax.Array
    n_paths: int
    exercise_dates: tuple
    upper: jax.Array            # Andersen-Broadie dual upper bound
    upper_std_error: jax.Array
    # martingale-CV lower bound (E[M_tau] = 0; see bermudan.py)
    price_cv: jax.Array | None = None
    cv_std_error: jax.Array | None = None


@lru_cache(maxsize=None)
def _g2_bermudan_fn(cfg: HWConfig, g: G2Params, ex_dates: tuple, times,
                    coupons, strike: float, payer: bool, n_paths: int,
                    n_blocks: int = 1, rqmc: bool = False, mesh=None):
    k = len(ex_dates)
    LT = jnp.asarray(_g2_joint_chol(g, ex_dates))
    # per-date bond-term statics and discounting constants
    date_stat = []
    for t_ex in ex_dates:
        alive = [i for i, t in enumerate(times) if t > t_ex + 1e-9]
        vadj = [0.5 * (_v_integral(g, times[i] - t_ex)
                       - _v_integral(g, times[i]) + _v_integral(g, t_ex))
                for i in alive]
        Ba = [_B(g.a, times[i] - t_ex) for i in alive]
        Bb = [_B(g.b, times[i] - t_ex) for i in alive]
        date_stat.append((alive, vadj, Ba, Bb,
                          -0.5 * _v_integral(g, t_ex)))
    sx = [math.sqrt(max(_cov_xx(g.a, g.sigma, g.a, g.sigma, 1.0, t, t),
                        1e-18)) for t in ex_dates]
    sy = [math.sqrt(max(_cov_xx(g.b, g.eta, g.b, g.eta, 1.0, t, t),
                        1e-18)) for t in ex_dates]
    sg = -1.0 if payer else 1.0   # receiver exercises at LOW z = y + kx
    icond = _g2_interval_cond(g, ex_dates)

    def compute(key, market):
        P_at = lambda t: hw.interp_curve(market.P, jnp.float32(t), cfg)
        lam = []
        disc_det = []
        for j, t_ex in enumerate(ex_dates):
            alive, vadj, Ba, Bb, d0 = date_stat[j]
            P1 = P_at(t_ex)
            lam_j = jnp.stack([
                coupons[i] * P_at(times[i]) / P1 * _exp(jnp.float32(v))
                for i, v in zip(alive, vadj)])
            lam.append((lam_j, jnp.asarray(Ba, jnp.float32),
                        jnp.asarray(Bb, jnp.float32)))
            disc_det.append(P1 * _exp(jnp.float32(d0)))

        def states(subkey):
            xn = jax.random.normal(subkey, (n_paths, 3 * k), jnp.float32)
            z = jnp.dot(xn, LT, preferred_element_type=jnp.float32,
                        precision=cfg.matmul_precision)
            return z[:, 0::3], z[:, 1::3], z[:, 2::3]

        def payoff_at(j, x, y):
            lam_j, Ba, Bb = lam[j]
            V = jnp.sum(lam_j[None, :]
                        * _exp(-Ba[None, :] * x[:, None]
                                  - Bb[None, :] * y[:, None]), axis=1)
            intrinsic = (strike - V) if payer else (V - strike)
            return jnp.maximum(intrinsic, 0.0)

        def basis(j, x, y, bnd):
            # the fit must see exactly the columns the dual proxy
            # evaluates (monomials + boundary splines + raw W)
            return _g2_proxy_cols(x, y, sx[j], sy[j], *lam[j], *bnd, sg)

        def cont_at(j, xs, ys, gam_next, bnd_next):
            """Closed-form continuation value at date j (in date-j money
            units): ratio * E[e^{-dI} V^_{j+1} | (x_j, y_j)] — the same
            conditional expectation the dual's martingale increment
            integrates, so the greedy policy gets it for free."""
            p = icond[j + 1]
            f32 = jnp.float32
            mx = f32(p["bxx"]) * xs + f32(p["bxy"]) * ys
            my = f32(p["byx"]) * xs + f32(p["byy"]) * ys
            mI = f32(p["bIx"]) * xs + f32(p["bIy"]) * ys
            cond = _g2_piecewise_cond(
                gam_next, sx[j + 1], sy[j + 1], *lam[j + 1], strike,
                *bnd_next, sg, mx, my, mI, p)
            return (disc_det[j + 1] / disc_det[j]) * cond

        def fit_boundary(j, contfun):
            """Degree-BOUND_DEG phi-weighted polynomial fit of the
            exercise boundary v = b(pc) from 21 bisected probes.  The
            root is BISECTED along whichever factor the payoff is more
            sensitive to (host-side static choice — eta -> 0 makes the
            boundary vertical in x and the y-bisection degenerate) and
            PROBED along the other over +-BOUND_RANGE sigmas; the fit
            runs in the scaled probe u = pc/pscale (|u| <= 1 on the
            probes, so the fp32 normal equations are well
            conditioned)."""
            from ..bermudan import _bisect

            lam_j, Ba, Bb = lam[j]
            _, _, Ba_h, Bb_h, _ = date_stat[j]
            bisect_y = sy[j] * max(Bb_h) >= sx[j] * max(Ba_h)
            s_pr, s_bi = (sx[j], sy[j]) if bisect_y else (sy[j], sx[j])
            pscale = s_pr * BOUND_RANGE
            n_pr = 21
            un = np.linspace(-1.0, 1.0, n_pr)
            wn = jnp.asarray(np.exp(-0.5 * (BOUND_RANGE * un) ** 2),
                             jnp.float32)
            unj = jnp.asarray(un, jnp.float32)
            Xd = jnp.stack([unj ** m for m in range(BOUND_DEG + 1)],
                           axis=1)
            pp = jnp.asarray(pscale * un, jnp.float32)

            def xy(bv):
                return (pp, bv) if bisect_y else (bv, pp)

            def intr(bv):
                xv, yv = xy(bv)
                V = jnp.sum(lam_j[None, :]
                            * _exp(-Ba[None, :] * xv[:, None]
                                      - Bb[None, :] * yv[:, None]),
                            axis=1)
                return sg * (V - strike)

            far = jnp.full((n_pr,), -sg * 14.0 * s_bi, jnp.float32)
            hi = jnp.full((n_pr,), sg * 14.0 * s_bi, jnp.float32)
            b_root = _bisect(intr, far, hi)
            if contfun is None:
                b_star = b_root
            else:
                def gfun(bv):
                    xv, yv = xy(bv)
                    return intr(bv) - jnp.maximum(contfun(xv, yv), 0.0)

                b_star = _bisect(gfun, far, b_root)
            A = jnp.dot(Xd.T, wn[:, None] * Xd, precision="highest")
            rhs = jnp.dot(Xd.T, wn * b_star, precision="highest")
            coef = jnp.linalg.solve(
                A + 1e-7 * jnp.eye(BOUND_DEG + 1, dtype=jnp.float32),
                rhs)
            return coef, not bisect_y, pscale

        def fit_proxy(x, y):
            """Backward VALUE-ITERATION fit of the dual proxy chain on
            the pass-1 state cloud.  Round 3: the regression target at
            date j is the CLOSED-FORM continuation of the date-(j+1)
            proxy — zero Monte Carlo noise, so the proxy error is pure
            basis residual per date (the round-2 realized-cashflow
            targets left ~4e-5 of regression noise in the dual gap;
            this fit leaves ~2e-6).  Any fitted chain yields a VALID
            bracket: validity needs only exact increments, not a good
            fit."""
            from ..bermudan import _wls

            prec = cfg.matmul_precision
            gammas = [None] * (k - 1) + [jnp.zeros((N_PROXY,),
                                                   jnp.float32)]
            bnds = [None] * k
            bnds[k - 1] = fit_boundary(k - 1, None)
            for j in range(k - 2, -1, -1):
                gn, bn = gammas[j + 1], bnds[j + 1]
                T = cont_at(j, x[:, j], y[:, j], gn, bn)
                bnds[j] = fit_boundary(
                    j, lambda xv, yv, j=j, gn=gn, bn=bn:
                    cont_at(j, xv, yv, gn, bn))
                coef, swap, pscale = bnds[j]
                pc, v = ((y[:, j], x[:, j]) if swap
                         else (x[:, j], y[:, j]))
                bcut = _g2_boundary_eval(coef, pc / pscale)
                # fit on the continuation side, capped at 4 sigmas: the
                # few >4-sigma cloud points carry residuals ~100x the
                # bulk's (the quintic diverges from the saturating bond
                # exponentials out there) and would otherwise dominate
                # the LS objective and distort the fit where the dual
                # actually lives
                wc = ((sg * (bcut - v) <= 0)
                      & (jnp.abs(x[:, j]) < 4.0 * sx[j])
                      & (jnp.abs(y[:, j]) < 4.0 * sy[j])
                      ).astype(jnp.float32)
                X = basis(j, x[:, j], y[:, j], bnds[j])
                gv = _wls(X[:, jnp.asarray(_VAL_COLS)], T, wc, prec)
                gammas[j] = (jnp.zeros((N_PROXY,), jnp.float32)
                             .at[jnp.asarray(_VAL_COLS)].set(gv))
            return gammas, bnds

        def dual_path_bound(x, y, I, gammas, bnds):
            """Per path: the AB dual max_j (Z_j - M_j) with the
            closed-form martingale increments of the piecewise proxy,
            PLUS the greedy-policy cashflow/stopping time.  The policy
            'exercise iff payoff > proxy continuation' reuses the cond
            values the dual already computes (they are the same
            conditional expectations, one date shifted), so the lower
            bound's policy is NOISE-FREE — no LSMC regression."""
            D = jnp.stack([disc_det[j] * _exp(-I[:, j])
                           for j in range(k)], axis=1)
            M = jnp.zeros((x.shape[0],), jnp.float32)
            Ms = []       # M after each date's increment (for M_tau)
            conds = []    # ratio * cond at date j, given state_{j-1}
            best = None   # initialized from the first date (no -inf
            # literal: an infinity constant in the traced graph can
            # surface as NaN under XLA fusion)
            for j in range(k):
                p = icond[j]
                coef, swap, pscale = bnds[j]
                lam_j, Ba, Bb = lam[j]
                if j == 0:
                    zero = jnp.zeros((x.shape[0],), jnp.float32)
                    mx = my = mI = zero
                    D_prev = jnp.ones_like(M)
                    ratio = disc_det[0]
                else:
                    xs, ys = x[:, j - 1], y[:, j - 1]
                    f32 = jnp.float32
                    mx = f32(p["bxx"]) * xs + f32(p["bxy"]) * ys
                    my = f32(p["byx"]) * xs + f32(p["byy"]) * ys
                    mI = f32(p["bIx"]) * xs + f32(p["bIy"]) * ys
                    D_prev = D[:, j - 1]
                    ratio = disc_det[j] / disc_det[j - 1]
                cond = _g2_piecewise_cond(
                    gammas[j], sx[j], sy[j], lam_j, Ba, Bb, strike,
                    coef, swap, pscale, sg, mx, my, mI, p)
                conds.append(ratio * cond)
                vhat = _g2_piecewise_value(
                    x[:, j], y[:, j], gammas[j], sx[j], sy[j], lam_j,
                    Ba, Bb, strike, coef, swap, pscale, sg,
                    cfg.matmul_precision)
                M = M + D[:, j] * vhat - D_prev * ratio * cond
                Ms.append(M)
                Z = D[:, j] * payoff_at(j, x[:, j], y[:, j])
                best = Z - M if best is None else jnp.maximum(best, Z - M)
            # greedy stopping: exercise at the first date whose payoff
            # beats the proxy continuation (conds[j + 1] given state_j
            # IS the date-j continuation; the last date has none)
            stop = jnp.full((x.shape[0],), k - 1, jnp.int32)
            cf = payoff_at(k - 1, x[:, k - 1], y[:, k - 1]) * D[:, k - 1]
            for j in range(k - 2, -1, -1):
                pj = payoff_at(j, x[:, j], y[:, j])
                contv = jnp.maximum(conds[j + 1], 0.0)
                exercise = (pj > contv) & (pj > 0.0)
                cf = jnp.where(exercise, pj * D[:, j], cf)
                stop = jnp.where(exercise, j, stop)
            return best, jnp.stack(Ms, axis=1), cf, stop

        k_est, k_val = jax.random.split(key)

        # --- pass 1: fit the proxy chain (single batch, noise-free
        # closed-form targets) + in-sample greedy price ---
        xa, ya, Ia = states(k_est)
        gammas, bnds = fit_proxy(xa, ya)
        _, _, cf_in, _ = dual_path_bound(xa, ya, Ia, gammas, bnds)

        # --- pass 2: out-of-sample lower + dual upper, block-streamed ---
        def block(b):
            kb = jax.random.fold_in(k_val, b)
            if rqmc:
                from ..ops.sobol import sobol

                shift = jax.random.bits(kb, (3 * k,), jnp.uint32)
                xn = jax.scipy.special.ndtri(sobol(n_paths, 3 * k, shift))
                z = jnp.dot(xn.astype(jnp.float32), LT,
                            preferred_element_type=jnp.float32,
                            precision=cfg.matmul_precision)
                xv, yv, Iv = z[:, 0::3], z[:, 1::3], z[:, 2::3]
            else:
                xv, yv, Iv = states(kb)
            u, Ms, cf, stop = dual_path_bound(xv, yv, Iv, gammas, bnds)
            # martingale control: E[M_tau] = 0 (see bermudan.py)
            m_tau = jnp.take_along_axis(Ms, stop[:, None], axis=1)[:, 0]
            cv = cf - m_tau
            return jnp.stack([jnp.sum(cf), jnp.sum(cf * cf),
                              jnp.sum(u), jnp.sum(u * u),
                              jnp.sum(cv), jnp.sum(cv * cv)])

        from ..parallel import mesh as pmesh

        per_block = pmesh.map_blocks(block, n_blocks, mesh)  # (n_blocks, 6)
        sums = jnp.sum(per_block, axis=0)
        n_tot = 1.0 * n_paths * n_blocks
        p_out = sums[0] / n_tot
        up = sums[2] / n_tot
        p_cv = sums[4] / n_tot
        if rqmc:
            # the digital shifts are the independent replicates (a block's
            # Sobol points are deterministic given its shift)
            bm_lo = per_block[:, 0] / n_paths
            bm_up = per_block[:, 2] / n_paths
            bm_cv = per_block[:, 4] / n_paths
            se = jnp.std(bm_lo, ddof=1) / jnp.sqrt(1.0 * n_blocks)
            up_se = jnp.std(bm_up, ddof=1) / jnp.sqrt(1.0 * n_blocks)
            cv_se = jnp.std(bm_cv, ddof=1) / jnp.sqrt(1.0 * n_blocks)
        else:
            se = jnp.sqrt(jnp.maximum(sums[1] / n_tot - p_out ** 2, 0.0)
                          / n_tot)
            up_se = jnp.sqrt(jnp.maximum(sums[3] / n_tot - up ** 2, 0.0)
                             / n_tot)
            cv_se = jnp.sqrt(jnp.maximum(sums[5] / n_tot - p_cv ** 2, 0.0)
                             / n_tot)
        return p_out, jnp.mean(cf_in), se, up, up_se, p_cv, cv_se

    return jax.jit(compute)


def price_bermudan_g2(cfg: HWConfig, g: G2Params, key,
                      market: MarketCurve, sched, exercise_dates, *,
                      strike: float = 1.0, payer: bool = False,
                      n_paths: int | None = None, n_blocks: int = 1,
                      rqmc: bool = False, mesh=None) -> G2Bermudan:
    """Bermudan coupon-bond option under G2++ by closed-form VALUE
    ITERATION (round 3): states (x, y, int r) at the exercise dates
    sampled EXACTLY (3k normals per path, continuous-time law); a
    piecewise dual value proxy — intrinsic on the exercise side of a
    fitted CURVED boundary v = b(pc), quintic monomials + boundary
    splines on the continuation side — is fitted backward with
    NOISE-FREE targets (each date's target is the closed-form tilted
    conditional expectation of the next date's proxy, exact in the
    bisected coordinate and Gauss-Hermite in the probe coordinate; see
    _g2_piecewise_cond).  The lower bound exercises greedily against
    the proxy's own continuation (no LSMC regression), the upper bound
    is the Andersen-Broadie dual on the same proxy's exact martingale,
    and the martingale control variate collapses the lower SE.  The
    round-2 straight-line/cubic LSMC left a ~4e-5 dual gap; this chain
    measures ~6e-6 at k=3 and ~1e-6 at k=5 against the fp64 2-d DP
    oracle.  Sanity pins: k=1 == the European conditional-
    decomposition oracle, the 2-d DP oracle bracket, and the eta -> 0
    degeneration to the 1-factor module.

    ``n_paths`` is the per-block path count; the evaluation pass streams
    ``n_blocks`` independent blocks (constant memory), or with
    ``rqmc=True`` draws each block from a 3k-dimensional digitally-
    shifted Sobol sequence (the shifts are the SE replicates).
    """
    if n_paths is None:
        n_paths = cfg.n_paths
    ex = tuple(sorted(float(t) for t in exercise_dates))
    if not ex:
        raise ValueError("need at least one exercise date")
    if ex[-1] >= max(sched.times):
        raise ValueError("exercise dates must precede the last cashflow")
    if rqmc and n_blocks < 2:
        raise ValueError("rqmc needs n_blocks >= 2 (the digital shifts "
                         "are the independent SE replicates)")
    p, p_in, se, up, up_se, p_cv, cv_se = _g2_bermudan_fn(
        cfg, g, ex, tuple(sched.times), tuple(sched.coupons),
        float(strike), bool(payer), int(n_paths), int(n_blocks),
        bool(rqmc), mesh)(key, market)
    return G2Bermudan(price=p, price_in_sample=p_in, std_error=se,
                      n_paths=int(n_paths) * int(n_blocks),
                      exercise_dates=ex, upper=up, upper_std_error=up_se,
                      price_cv=p_cv, cv_std_error=cv_se)


# ---------------------------------------------------------------------------
# Caps / floors under G2++ (round 2b)
# ---------------------------------------------------------------------------

def _zbp_closed_g2(cfg: HWConfig, g: G2Params, market: MarketCurve,
                   t1: float, t2: float, K: float) -> float:
    """float64 G2++ zero-bond put on P(t1, t2) struck at K: the shared
    Black formula with the two-factor bond volatility."""
    from ..instruments import curve_level, zbp_black

    return zbp_black(curve_level(cfg, market, t1),
                     curve_level(cfg, market, t2), K,
                     _sigma_zbc(g, t1, t2))


def cap_closed_form_g2(cfg: HWConfig, g: G2Params, market: MarketCurve, *,
                       rate: float, start: float | None = None,
                       tenor: float = 4.0, freq: float = 1.0,
                       floor: bool = False):
    """float64 G2++ cap/floor = sum of scaled ZBP/ZBC per period (the
    shared caplet replication with the G2++ zero-bond put)."""
    from ..instruments import cap_replication

    if start is None:
        start = cfg.s1
    return cap_replication(
        cfg, market,
        lambda t1, t2, K: _zbp_closed_g2(cfg, g, market, t1, t2, K),
        rate=rate, start=start, tenor=tenor, freq=freq, floor=floor)


@lru_cache(maxsize=None)
def _g2_cap_fn(cfg: HWConfig, g: G2Params, rate: float, start: float,
               n: int, tau: float, floor: bool, n_paths: int):
    dates = tuple(start + j * tau for j in range(n + 1))
    LT = jnp.asarray(_g2_joint_chol(g, dates))
    k = len(dates)
    # per-period bond reconstruction statics
    vadj = [0.5 * (_v_integral(g, tau) - _v_integral(g, dates[j + 1])
                   + _v_integral(g, dates[j])) for j in range(n)]
    Ba = jnp.float32(_B(g.a, tau))
    Bb = jnp.float32(_B(g.b, tau))
    d0 = [-0.5 * _v_integral(g, t) for t in dates]

    def compute(key, market):
        P_at = lambda t: hw.interp_curve(market.P, jnp.float32(t), cfg)
        xn = jax.random.normal(key, (n_paths, 3 * k), jnp.float32)
        z = jnp.dot(xn, LT, preferred_element_type=jnp.float32,
                    precision=cfg.matmul_precision)
        x, y, I = z[:, 0::3], z[:, 1::3], z[:, 2::3]

        def leg(sgn):
            vals = []
            for j in range(n):
                A = (P_at(dates[j + 1]) / P_at(dates[j])
                     * jnp.exp(jnp.float32(vadj[j])))
                Pb = A * jnp.exp(-Ba * sgn * x[:, j] - Bb * sgn * y[:, j])
                L = (1.0 / Pb - 1.0) / tau
                disc = (P_at(dates[j + 1])
                        * jnp.exp(jnp.float32(d0[j + 1]))
                        * jnp.exp(-sgn * I[:, j + 1]))
                intrinsic = (rate - L) if floor else (L - rate)
                vals.append(disc * tau * jnp.maximum(intrinsic, 0.0))
            return jnp.stack(vals, axis=1)

        V = 0.5 * (leg(1.0) + leg(-1.0))
        tot = jnp.sum(V, axis=1)
        return (jnp.mean(tot),
                jnp.std(tot, ddof=1) / jnp.sqrt(1.0 * n_paths),
                jnp.mean(V, axis=0))

    return jax.jit(compute)


def price_cap_g2(cfg: HWConfig, g: G2Params, key, market: MarketCurve, *,
                 rate: float, start: float | None = None,
                 tenor: float = 4.0, freq: float = 1.0, floor: bool = False,
                 n_paths: int | None = None):
    """G2++ cap/floor: every caplet from one exactly-sampled multi-date
    (x, y, I) state set (antithetic).  Returns (price, se, caplets)."""
    if start is None:
        start = cfg.s1
    if n_paths is None:
        n_paths = cfg.n_paths
    n = int(round(tenor * freq))
    return _g2_cap_fn(cfg, g, float(rate), float(start), n, 1.0 / freq,
                      bool(floor), int(n_paths))(key, market)


# ---------------------------------------------------------------------------
# 2-d dynamic-programming oracle for the G2++ Bermudan (round 2b)
# ---------------------------------------------------------------------------

def dp_oracle_g2(cfg: HWConfig, g: G2Params, market: MarketCurve, sched,
                 exercise_dates, *, strike: float = 1.0,
                 payer: bool = False, n_grid: int = 121,
                 width: float = 6.5, n_quad: int = 48) -> float:
    """float64 G2++ Bermudan price (``dp_solution_g2``'s headline)."""
    return dp_solution_g2(cfg, g, market, sched, exercise_dates,
                          strike=strike, payer=payer, n_grid=n_grid,
                          width=width, n_quad=n_quad)["price"]


def dp_solution_g2(cfg: HWConfig, g: G2Params, market: MarketCurve,
                   sched, exercise_dates, *, strike: float = 1.0,
                   payer: bool = False, n_grid: int = 121,
                   width: float = 6.5, n_quad: int = 48,
                   order: str = "cubic") -> dict:
    """float64 G2++ Bermudan solution by 2-d backward induction on an
    (x, y) grid, keeping the per-date grids for the exposure oracle's
    forward pass (xva.py; the 1-factor analogue is
    ``bermudan.dp_solution``).

    Per interval, conditional on (x, y): x' = x e^{-a d} + xi_x,
    y' = y e^{-b d} + xi_y, dI = x Ba(d) + y Bb(d) + xi_I with
    (xi_x, xi_y, xi_I) ~ _state_cov(g, d).  Tilting by e^{-dI} multiplies
    by e^{-mI + vI/2} and shifts the innovation means by -Cov(., xi_I).
    The inner y'-integral of the interpolated V is EXACT per segment
    (the value function's kink lives there; range_note._kernel_avg's
    Phi/phi forms, cubic-Hermite by default — the round-3 bilinear
    version carried a +1.3e-4 O(h^2) convexity bias at the 121/48
    defaults); the outer x'-integral of the then-smoothed function uses
    Gauss-Hermite with a Catmull-Rom column blend (linear under
    order="linear").

    Round-4 vectorization: the tilted conditional y'-mean shifts by
    rho_i sy_i node_q independently of the SOURCE x row (xq[i] - m_x[i]
    = sx_i node_q), so one batched kernel integration per Gauss-Hermite
    node serves every x-target column and every source at once —
    O(k nq ny ny nx) with no per-(i, q) Python dispatch (measured
    ~300x over the round-3 loop at the defaults).
    """
    from ..range_note import _catmull_weights, _ghost_cols, _kernel_avg

    ex = tuple(sorted(float(t) for t in exercise_dates))
    k = len(ex)
    times = tuple(sched.times)
    coupons = tuple(sched.coupons)
    Ts_grid = np.linspace(0.0, cfg.t_final, cfg.n_mat)
    P_mkt = np.asarray(market.P, np.float64)

    def payoff_at(j, X, Y):
        """payoff on meshgrid arrays X, Y at date ex[j] (fp64)."""
        t_ex = ex[j]
        P1 = float(np.interp(t_ex, Ts_grid, P_mkt))
        V = np.zeros_like(X)
        for t_i, c_i in zip(times, coupons):
            if t_i <= t_ex + 1e-9:
                continue
            tau = t_i - t_ex
            vadj = 0.5 * (_v_integral(g, tau) - _v_integral(g, t_i)
                          + _v_integral(g, t_ex))
            lam = c_i * float(np.interp(t_i, Ts_grid, P_mkt)) / P1 \
                * math.exp(vadj)
            V += lam * np.exp(-_B(g.a, tau) * X - _B(g.b, tau) * Y)
        intrinsic = (strike - V) if payer else (V - strike)
        return np.maximum(intrinsic, 0.0)

    # deterministic discount factors per date (phi integral + variance adj)
    dd = [float(np.interp(t, Ts_grid, P_mkt))
          * math.exp(-0.5 * _v_integral(g, t)) for t in ex]

    sxs = [math.sqrt(_state_cov(g, t)[0, 0] + 1e-18) for t in ex]
    sys_ = [math.sqrt(_state_cov(g, t)[1, 1] + 1e-18) for t in ex]
    gxs = [sxs[j] * np.linspace(-width, width, n_grid) for j in range(k)]
    gys = [sys_[j] * np.linspace(-width, width, n_grid) for j in range(k)]

    nodes, wq = np.polynomial.hermite_e.hermegauss(n_quad)
    wq = wq / math.sqrt(2.0 * math.pi)

    def backward_step(j_from, j_to, V, x_src, y_src):
        """cont(x, y) for sources (x_src grid, y_src grid or scalars)."""
        d = ex[j_to] - (ex[j_from] if j_from >= 0 else 0.0)
        C = _state_cov(g, d)
        Ea, Eb = math.exp(-g.a * d), math.exp(-g.b * d)
        Ba, Bb = _B(g.a, d), _B(g.b, d)
        vI = C[2, 2]
        sx_i = math.sqrt(C[0, 0] + 1e-18)
        sy_i = math.sqrt(C[1, 1] + 1e-18)
        rho_i = C[0, 1] / (sx_i * sy_i) if sx_i * sy_i > 0 else 0.0
        gx_t, gy_t = gxs[j_to], gys[j_to]
        X, Y = np.meshgrid(x_src, y_src, indexing="ij")
        mI = X * Ba + Y * Bb
        w0 = np.exp(-mI + 0.5 * vI) * (dd[j_to] / (dd[j_from]
                                                   if j_from >= 0 else 1.0))
        m_x = x_src * Ea - C[0, 2]         # tilted x' mean (per x row)
        # outer GH nodes in x' per source x
        xq = m_x[:, None] + sx_i * nodes[None, :]          # (nx_src, nq)
        s_c = sy_i * math.sqrt(max(1.0 - rho_i * rho_i, 1e-14))
        # the tilted conditional y' mean at node q is
        #   y Eb - C[1,2] + rho_i sy_i node_q  — independent of the
        # SOURCE x row, so ONE exact kernel integration per node serves
        # every x-target column and every y source at once
        cont = np.zeros((len(x_src), len(y_src)))
        for q in range(n_quad):
            m_y = y_src * Eb - C[1, 2] + rho_i * sy_i * nodes[q]
            Eq = _kernel_avg(m_y, s_c, gy_t, V.T, order=order)  # (ny_src, nx_t)
            xv = xq[:, q]
            if order == "cubic":
                Eg = _ghost_cols(Eq)
                idx, cw = _catmull_weights(gx_t, xv)
                blend = (cw[0][:, None] * Eg[:, idx].T
                         + cw[1][:, None] * Eg[:, idx + 1].T
                         + cw[2][:, None] * Eg[:, idx + 2].T
                         + cw[3][:, None] * Eg[:, idx + 3].T)
            else:
                idx = np.clip(np.searchsorted(gx_t, xv) - 1, 0,
                              len(gx_t) - 2)
                lam = np.clip((xv - gx_t[idx]) / (gx_t[idx + 1]
                                                  - gx_t[idx]), 0.0, 1.0)
                blend = ((1.0 - lam)[:, None] * Eq[:, idx].T
                         + lam[:, None] * Eq[:, idx + 1].T)
            cont += wq[q] * blend
        return w0 * cont

    X, Y = np.meshgrid(gxs[k - 1], gys[k - 1], indexing="ij")
    pays = [None] * k
    conts = [None] * k
    Vs = [None] * k
    pays[k - 1] = payoff_at(k - 1, X, Y)
    conts[k - 1] = np.zeros_like(pays[k - 1])
    Vs[k - 1] = pays[k - 1]
    for j in range(k - 2, -1, -1):
        conts[j] = backward_step(j, j + 1, Vs[j + 1], gxs[j], gys[j])
        Xj, Yj = np.meshgrid(gxs[j], gys[j], indexing="ij")
        pays[j] = payoff_at(j, Xj, Yj)
        Vs[j] = np.maximum(pays[j], conts[j])
    price = backward_step(-1, 0, Vs[0], np.array([0.0]), np.array([0.0]))
    return dict(ex=ex, gxs=gxs, gys=gys, V=Vs, cont=conts, payoff=pays,
                dd=dd, price=float(price[0, 0]))


# ---------------------------------------------------------------------------
# Range-accrual leg under G2++ (round 3): the two-factor twin of
# instruments.price_range_accrual.  The LIBOR band 1 + delta L =
# e^{Ba x + Bb y}/A is a STRIP c_lo <= u <= c_hi in the projected
# coordinate u = Ba x + Bb y, so every observation is still an interval
# indicator on a 1-d Gaussian and the fp64 oracle stays EXACT closed
# form: tilting by e^{-I(T_p)} cancels the e^{-V/2} drift adjustment
# (Var I = V) and shifts u's mean by -Cov(u, I_p), read directly off the
# same _g2_joint_cov the sampler Choleskys — oracle and MC integrate the
# identical law.
# ---------------------------------------------------------------------------

class G2Range(NamedTuple):
    price: jax.Array
    std_error: jax.Array
    periods: jax.Array
    mean_fraction: jax.Array
    n_paths: int


def _range_dates_g2(start: float, n: int, tau: float, m: int):
    obs = [tuple(start + j * tau + i * tau / m for i in range(m))
           for j in range(n)]
    pays = tuple(start + (j + 1) * tau for j in range(n))
    dates = tuple(sorted({t for o in obs for t in o} | set(pays)))
    return obs, pays, dates


def _libor_strip_g2(cfg: HWConfig, g: G2Params, market, t: float,
                    delta: float, lo: float, hi: float):
    """(Ba, Bb, c_lo, c_hi): lo <= L(t, t+delta) <= hi  <=>
    c_lo <= Ba x + Bb y <= c_hi, with c = ln A + log1p(delta L) and
    A = (P0(t+d)/P0(t)) e^{(V(d) - V(t+d) + V(t))/2}.  The c edges are
    traced (market curve); B and the V adjustment are static."""
    Ba, Bb = _B(g.a, delta), _B(g.b, delta)
    vadj = 0.5 * (_v_integral(g, delta) - _v_integral(g, t + delta)
                  + _v_integral(g, t))
    lnA = (jnp.log(hw.interp_curve(market.P, jnp.float32(t + delta), cfg))
           - jnp.log(hw.interp_curve(market.P, jnp.float32(t), cfg))
           + jnp.float32(vadj))

    def edge(level):
        if 1.0 + delta * level <= 0.0:
            return jnp.float32(-jnp.inf)
        return lnA + math.log1p(delta * level)

    return Ba, Bb, edge(lo), edge(hi)


@lru_cache(maxsize=None)
def _g2_functional_cov(g: G2Params, specs: tuple):
    """fp64 covariance of an arbitrary tuple of centered functionals:
    ("u", t, Ba, Bb) = Ba x(t) + Bb y(t) (the strip projection itself
    is Gaussian — sample it directly, one column per observation
    instead of (x, y, I) triples), or ("I", t).  Exact continuous-time
    law from the _cov_* kernels, with the sampler's 1e-16 jitter (the
    2-d note DP conditions on this same matrix, so oracle and MC
    integrate the identical law)."""
    a, b, s_, e_, r = g.a, g.b, g.sigma, g.eta, g.rho
    fx, fy = (a, s_), (b, e_)

    def cxx(f1, t1, f2, t2):
        c = 1.0 if f1 == f2 else r
        return _cov_xx(f1[0], f1[1], f2[0], f2[1], c, t1, t2)

    def cxI(f1, t1, T2):
        return sum(_cov_xI(f1[0], f1[1], f2[0], f2[1],
                           1.0 if f1 == f2 else r, t1, T2)
                   for f2 in (fx, fy))

    def cII(T1, T2):
        return sum(_cov_II(f1[0], f1[1], f2[0], f2[1],
                           1.0 if f1 == f2 else r, T1, T2)
                   for f1 in (fx, fy) for f2 in (fx, fy))

    def cov(s1, s2):
        if s1[0] == "u" and s2[0] == "u":
            _, t1, Ba1, Bb1 = s1
            _, t2, Ba2, Bb2 = s2
            return (Ba1 * Ba2 * cxx(fx, t1, fx, t2)
                    + Ba1 * Bb2 * cxx(fx, t1, fy, t2)
                    + Bb1 * Ba2 * cxx(fy, t1, fx, t2)
                    + Bb1 * Bb2 * cxx(fy, t1, fy, t2))
        if s1[0] == "u" and s2[0] == "I":
            _, t1, Ba1, Bb1 = s1
            return Ba1 * cxI(fx, t1, s2[1]) + Bb1 * cxI(fy, t1, s2[1])
        if s1[0] == "I" and s2[0] == "u":
            return cov(s2, s1)
        return cII(s1[1], s2[1])

    kk = len(specs)
    C = np.zeros((kk, kk))
    for i in range(kk):
        for j in range(i, kk):
            C[i, j] = C[j, i] = cov(specs[i], specs[j])
    return C + 1e-16 * np.eye(kk)


@lru_cache(maxsize=None)
def _g2_functional_chol(g: G2Params, specs: tuple):
    """fp32 Cholesky^T of _g2_functional_cov (z = x @ L^T sampling)."""
    L = np.linalg.cholesky(_g2_functional_cov(g, specs))
    return np.asarray(L.T, np.float32)


@lru_cache(maxsize=None)
def _g2_range_fn(cfg: HWConfig, g: G2Params, coupon: float, lo: float,
                 hi: float, start: float, n: int, tau: float, m: int,
                 delta: float, n_paths: int, n_blocks: int, mesh):
    from ..parallel import mesh as pmesh

    obs, pays, dates = _range_dates_g2(start, n, tau, m)
    del dates
    v_half = [0.5 * _v_integral(g, p) for p in pays]
    # sample exactly the functionals the payoff touches, in payoff order:
    # the strip projection u = Ba x + Bb y at each observation (itself
    # Gaussian — no need for (x, y, I) triples) and I at the payments.
    # n*m + n columns instead of 3(nm+1), and no gathers in the kernel.
    Ba, Bb = _B(g.a, delta), _B(g.b, delta)
    specs = tuple([("u", t, Ba, Bb) for o in obs for t in o]
                  + [("I", p) for p in pays])
    LT = jnp.asarray(_g2_functional_chol(g, specs))
    nm = n * m

    def compute(key, market):
        edges = [_libor_strip_g2(cfg, g, market, t, delta, lo, hi)
                 for o in obs for t in o]
        c_lo = jnp.stack([e[2] for e in edges]).reshape(n, m)
        c_hi = jnp.stack([e[3] for e in edges]).reshape(n, m)
        disc0 = jnp.stack(
            [hw.interp_curve(market.P, jnp.float32(p), cfg)
             * jnp.exp(jnp.float32(-v_half[j]))
             for j, p in enumerate(pays)])

        def block(bi):
            xn = jax.random.normal(jax.random.fold_in(key, bi),
                                   (n_paths, nm + n), jnp.float32)
            z = jnp.dot(xn, LT, preferred_element_type=jnp.float32,
                        precision=cfg.matmul_precision)

            def leg(sgn):
                u = sgn * z[:, :nm].reshape(-1, n, m)    # (paths, n, m)
                in_band = ((u >= c_lo[None, :, :])
                           & (u <= c_hi[None, :, :]))
                fracs = jnp.mean(in_band.astype(jnp.float32), axis=2)
                disc = disc0[None, :] * jnp.exp(-sgn * z[:, nm:])
                return coupon * tau * fracs * disc, fracs

            Vp, Fp = leg(1.0)
            Vm, Fm = leg(-1.0)
            V, F = 0.5 * (Vp + Vm), 0.5 * (Fp + Fm)
            tot = jnp.sum(V, axis=1)
            return jnp.concatenate([
                jnp.stack([jnp.sum(tot), jnp.sum(tot * tot)]),
                jnp.sum(V, axis=0), jnp.sum(F, axis=0)])

        s = jnp.sum(pmesh.map_blocks(block, n_blocks, mesh), axis=0)
        n_tot = 1.0 * n_paths * n_blocks
        mean = s[0] / n_tot
        var = jnp.maximum(s[1] / n_tot - mean ** 2, 0.0)
        var = var * n_tot / jnp.maximum(n_tot - 1.0, 1.0)
        return (mean, jnp.sqrt(var / n_tot), s[2:2 + n] / n_tot,
                s[2 + n:] / n_tot)

    return jax.jit(compute)


def price_range_accrual_g2(cfg: HWConfig, g: G2Params, key,
                           market: MarketCurve, *, coupon: float,
                           lo: float, hi: float, start: float | None = None,
                           tenor: float = 4.0, freq: float = 1.0,
                           obs_per_period: int = 5,
                           libor_tenor: float | None = None,
                           n_paths: int | None = None, n_blocks: int = 1,
                           mesh=None) -> G2Range:
    """Monte Carlo G2++ range-accrual leg from one exactly-sampled
    multi-date (x, y, I) state set (antithetic); blocks key on the
    global index, optionally sharded over ``mesh``.  fp64 oracle:
    range_accrual_closed_form_g2 (exact, no quadrature)."""
    if n_paths is None:
        n_paths = cfg.n_paths
    if start is None:
        start = cfg.s1
    n = int(round(tenor * freq))
    tau = 1.0 / freq
    if libor_tenor is None:
        libor_tenor = tau / obs_per_period
    price, se, periods, fracs = _g2_range_fn(
        cfg, g, float(coupon), float(lo), float(hi), float(start), n,
        float(tau), int(obs_per_period), float(libor_tenor), int(n_paths),
        int(n_blocks), mesh)(key, market)
    return G2Range(price=price, std_error=se, periods=periods,
                   mean_fraction=fracs,
                   n_paths=int(n_paths) * int(n_blocks))


def range_accrual_closed_form_g2(cfg: HWConfig, g: G2Params,
                                 market: MarketCurve, *, coupon: float,
                                 lo: float, hi: float,
                                 start: float | None = None,
                                 tenor: float = 4.0, freq: float = 1.0,
                                 obs_per_period: int = 5,
                                 libor_tenor: float | None = None):
    """float64 G2++ range-accrual leg in CLOSED FORM: per observation

        coupon tau/m P(0,T_p) (Phi((c_hi - mu~)/s_u) - Phi((c_lo - mu~)/s_u)),

    u = Ba x(t_i) + Bb y(t_i), mu~ = -Cov(u, I(T_p)), s_u^2 = Var u,
    all read off _g2_joint_cov (the sampler's own covariance, jitter
    included) — the e^{Var I/2} tilt normalizer cancels the e^{-V/2}
    drift adjustment exactly.  Returns (leg value, per-period list)."""
    from .oracles import _phi

    if start is None:
        start = cfg.s1
    n = int(round(tenor * freq))
    tau = 1.0 / freq
    m = int(obs_per_period)
    if libor_tenor is None:
        libor_tenor = tau / m
    obs, pays, dates = _range_dates_g2(float(start), n, tau, m)
    idx = {t: q for q, t in enumerate(dates)}
    C = _g2_joint_cov(g, dates)
    Ts_grid = np.linspace(0.0, cfg.t_final, cfg.n_mat)
    P0 = np.asarray(market.P, np.float64)
    Ba, Bb = _B(g.a, libor_tenor), _B(g.b, libor_tenor)
    total, per = 0.0, []
    for j in range(n):
        qp = idx[pays[j]]
        P0p = float(np.interp(pays[j], Ts_grid, P0))
        v = 0.0
        for t in obs[j]:
            qi = idx[t]
            var_u = (Ba * Ba * C[3 * qi, 3 * qi]
                     + 2.0 * Ba * Bb * C[3 * qi, 3 * qi + 1]
                     + Bb * Bb * C[3 * qi + 1, 3 * qi + 1])
            cov_uI = (Ba * C[3 * qi, 3 * qp + 2]
                      + Bb * C[3 * qi + 1, 3 * qp + 2])
            s_u = math.sqrt(var_u)
            vadj = 0.5 * (_v_integral(g, libor_tenor)
                          - _v_integral(g, t + libor_tenor)
                          + _v_integral(g, t))
            lnA = (math.log(float(np.interp(t + libor_tenor, Ts_grid, P0)))
                   - math.log(float(np.interp(t, Ts_grid, P0))) + vadj)

            def edge(level):
                if 1.0 + libor_tenor * level <= 0.0:
                    return -math.inf
                return lnA + math.log1p(libor_tenor * level)

            p = (_phi((edge(hi) + cov_uI) / s_u)
                 - _phi((edge(lo) + cov_uI) / s_u))
            v += coupon * tau / m * P0p * p
        per.append(v)
        total += v
    return total, per


# ---------------------------------------------------------------------------
# CMS cap/floor leg under G2++ (round 3): the two-factor twin of
# instruments.price_cms.  The par rate S(x, y) is increasing in BOTH
# factors, so the fp64 oracle tilts the bivariate state by e^{-I(T_p)}
# (means shift by -Cov(., I_p), covariance unchanged, normalizer cancels
# the e^{-V/2} drift adjustment) and integrates exactly-in-x /
# Gauss-Hermite-in-y: per outer y node the strike root x*(y) is bisected
# and the smooth ITM side Gauss-Legendre'd — the same decomposition the
# G2++ Bermudan value-iteration targets use.
# ---------------------------------------------------------------------------

def _swap_terms_g2(cfg: HWConfig, g: G2Params, t: float, swap_tenor: float,
                   swap_freq: float):
    """Static parts of P(t, T_i; x, y) = A_i e^{-Ba_i x - Bb_i y} for the
    payments of the par swap observed at t: (times, Ba, Bb, vadj)."""
    mm = int(round(swap_tenor * swap_freq))
    tau_s = 1.0 / swap_freq
    Ts = [t + (i + 1) * tau_s for i in range(mm)]
    Ba = [_B(g.a, T - t) for T in Ts]
    Bb = [_B(g.b, T - t) for T in Ts]
    vadj = [0.5 * (_v_integral(g, T - t) - _v_integral(g, T)
                   + _v_integral(g, t)) for T in Ts]
    return Ts, Ba, Bb, vadj, tau_s


@lru_cache(maxsize=None)
def _g2_cms_fn(cfg: HWConfig, g: G2Params, rate: float, start: float,
               n: int, tau: float, swap_tenor: float, swap_freq: float,
               floor: bool, n_paths: int, n_blocks: int, mesh):
    from ..parallel import mesh as pmesh

    dates = tuple(start + j * tau for j in range(n + 1))
    idx = {t: q for q, t in enumerate(dates)}
    LT = jnp.asarray(_g2_joint_chol(g, dates))
    k = len(dates)
    terms = [_swap_terms_g2(cfg, g, dates[j], swap_tenor, swap_freq)
             for j in range(n)]
    v_half = [0.5 * _v_integral(g, dates[j + 1]) for j in range(n)]

    def compute(key, market):
        lam = []
        for j in range(n):
            Ts, Ba, Bb, vadj, tau_s = terms[j]
            P0t = hw.interp_curve(market.P, jnp.float32(dates[j]), cfg)
            A = [hw.interp_curve(market.P, jnp.float32(T), cfg) / P0t
                 * jnp.exp(jnp.float32(v)) for T, v in zip(Ts, vadj)]
            lam.append(jnp.stack(A))
        disc0 = [hw.interp_curve(market.P, jnp.float32(dates[j + 1]), cfg)
                 * jnp.exp(jnp.float32(-v_half[j])) for j in range(n)]

        def block(bi):
            xn = jax.random.normal(jax.random.fold_in(key, bi),
                                   (n_paths, 3 * k), jnp.float32)
            z = jnp.dot(xn, LT, preferred_element_type=jnp.float32,
                        precision=cfg.matmul_precision)

            def leg(sgn):
                vals = []
                for j in range(n):
                    Ts, Ba, Bb, vadj, tau_s = terms[j]
                    q = idx[dates[j]]
                    x = sgn * z[:, 3 * q]
                    y = sgn * z[:, 3 * q + 1]
                    P = lam[j][None, :] * jnp.exp(
                        -jnp.asarray(Ba, jnp.float32)[None, :] * x[:, None]
                        - jnp.asarray(Bb, jnp.float32)[None, :] * y[:, None])
                    S = (1.0 - P[:, -1]) / (tau_s * jnp.sum(P, axis=1))
                    I_p = sgn * z[:, 3 * idx[dates[j + 1]] + 2]
                    disc = disc0[j] * jnp.exp(-I_p)
                    intrinsic = (rate - S) if floor else (S - rate)
                    vals.append(disc * tau * jnp.maximum(intrinsic, 0.0))
                return jnp.stack(vals, axis=1)

            V = 0.5 * (leg(1.0) + leg(-1.0))
            tot = jnp.sum(V, axis=1)
            return jnp.concatenate([
                jnp.stack([jnp.sum(tot), jnp.sum(tot * tot)]),
                jnp.sum(V, axis=0)])

        s = jnp.sum(pmesh.map_blocks(block, n_blocks, mesh), axis=0)
        n_tot = 1.0 * n_paths * n_blocks
        mean = s[0] / n_tot
        var = jnp.maximum(s[1] / n_tot - mean ** 2, 0.0)
        var = var * n_tot / jnp.maximum(n_tot - 1.0, 1.0)
        return mean, jnp.sqrt(var / n_tot), s[2:] / n_tot

    return jax.jit(compute)


def price_cms_g2(cfg: HWConfig, g: G2Params, key, market: MarketCurve, *,
                 rate: float, start: float | None = None,
                 tenor: float = 4.0, freq: float = 1.0,
                 swap_tenor: float = 5.0, swap_freq: float = 1.0,
                 floor: bool = False, n_paths: int | None = None,
                 n_blocks: int = 1, mesh=None) -> G2Range:
    """Monte Carlo G2++ CMS cap/floor leg (convexity-bearing payoff) from
    one exactly-sampled multi-date (x, y, I) state set (antithetic);
    blocks key on the global index, optionally sharded over ``mesh``.
    fp64 oracle: cms_quadrature_g2."""
    if n_paths is None:
        n_paths = cfg.n_paths
    if start is None:
        start = cfg.s1
    n = int(round(tenor * freq))
    tau = 1.0 / freq
    price, se, periods = _g2_cms_fn(
        cfg, g, float(rate), float(start), n, float(tau),
        float(swap_tenor), float(swap_freq), bool(floor), int(n_paths),
        int(n_blocks), mesh)(key, market)
    return G2Range(price=price, std_error=se, periods=periods,
                   mean_fraction=periods * 0.0,
                   n_paths=int(n_paths) * int(n_blocks))


def cms_quadrature_g2(cfg: HWConfig, g: G2Params, market: MarketCurve, *,
                      rate: float, start: float | None = None,
                      tenor: float = 4.0, freq: float = 1.0,
                      swap_tenor: float = 5.0, swap_freq: float = 1.0,
                      floor: bool = False, n_gh: int = 64,
                      n_quad: int = 200):
    """float64 G2++ CMS leg: exponential tilting by e^{-I(T_p)} (means
    shift by -Cov(., I_p); the e^{Var I/2} normalizer cancels the
    e^{-V/2} adjustment, leaving P(0,T_p) as the prefactor), then
    exact-in-x / GH-in-y: S(x,y) is increasing in x for every y, so per
    outer Gauss-Hermite y-node the strike root x*(y) is bisected and the
    smooth ITM side integrated by Gauss-Legendre on the conditional
    x | y Gaussian.  Returns (leg value, per-period list)."""
    from numpy.polynomial.legendre import leggauss

    if start is None:
        start = cfg.s1
    n = int(round(tenor * freq))
    tau = 1.0 / freq
    dates = tuple(start + j * tau for j in range(n + 1))
    idx = {t: q for q, t in enumerate(dates)}
    C = _g2_joint_cov(g, dates)
    Ts_grid = np.linspace(0.0, cfg.t_final, cfg.n_mat)
    P0 = np.asarray(market.P, np.float64)
    gh_x, gh_w = np.polynomial.hermite.hermgauss(n_gh)
    gh_w = gh_w / math.sqrt(math.pi)
    gl_x, gl_w = leggauss(n_quad)
    total, per = 0.0, []
    for j in range(n):
        qj, qp = idx[dates[j]], idx[dates[j + 1]]
        var_x, var_y = C[3 * qj, 3 * qj], C[3 * qj + 1, 3 * qj + 1]
        cov_xy = C[3 * qj, 3 * qj + 1]
        mx = -C[3 * qj, 3 * qp + 2]            # tilted means
        my = -C[3 * qj + 1, 3 * qp + 2]
        P0p = float(np.interp(dates[j + 1], Ts_grid, P0))
        Ts, Ba, Bb, vadj, tau_s = _swap_terms_g2(cfg, g, dates[j],
                                                 swap_tenor, swap_freq)
        P0t = float(np.interp(dates[j], Ts_grid, P0))
        A = np.array([float(np.interp(T, Ts_grid, P0)) / P0t * math.exp(v)
                      for T, v in zip(Ts, vadj)])
        Ba = np.asarray(Ba)
        Bb = np.asarray(Bb)

        def srate(x, y):
            P = A[None, :] * np.exp(-Ba[None, :] * np.atleast_1d(x)[:, None]
                                    - Bb[None, :] * y)
            return (1.0 - P[:, -1]) / (tau_s * np.sum(P, axis=1))

        s_y = math.sqrt(var_y)
        bx = cov_xy / var_y
        s_xy = math.sqrt(max(var_x - cov_xy * cov_xy / var_y, 0.0))
        v = 0.0
        for yk, wk in zip(my + math.sqrt(2.0) * s_y * gh_x, gh_w):
            m_x = mx + bx * (yk - my)
            lo_x, hi_x = m_x - 12.0 * s_xy, m_x + 12.0 * s_xy
            # S increasing in x: bisect the strike root
            if srate(np.array([hi_x]), yk)[0] < rate:
                root = hi_x                    # fully OTM (cap) / ITM (floor)
            elif srate(np.array([lo_x]), yk)[0] > rate:
                root = lo_x
            else:
                a_, b_ = lo_x, hi_x
                for _ in range(200):
                    mid = 0.5 * (a_ + b_)
                    if srate(np.array([mid]), yk)[0] < rate:
                        a_ = mid
                    else:
                        b_ = mid
                root = 0.5 * (a_ + b_)
            a_, b_ = (lo_x, root) if floor else (root, hi_x)
            if b_ <= a_:
                continue
            xq = 0.5 * (b_ - a_) * gl_x + 0.5 * (a_ + b_)
            wq = 0.5 * (b_ - a_) * gl_w
            pdf = np.exp(-0.5 * ((xq - m_x) / s_xy) ** 2) / (
                s_xy * math.sqrt(2.0 * math.pi))
            intr = (rate - srate(xq, yk)) if floor else (srate(xq, yk)
                                                         - rate)
            v += wk * tau * P0p * float(
                np.sum(np.maximum(intr, 0.0) * pdf * wq))
        per.append(v)
        total += v
    return total, per
