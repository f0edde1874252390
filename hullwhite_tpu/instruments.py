"""Coupon-bond options and European swaptions.

An instrument-family extension beyond the CUDA reference (which prices a
single zero-coupon-bond call): under the one-factor Hull-White model the
time-S1 value of a coupon bond is a monotone function of the short rate,

    V(r) = sum_i c_i P(S1, T_i; r) = sum_i c_i A_i e^{-B_i r},

so the whole instrument still only needs the 2-d Gaussian state
(r(S1), int r ds) of the exact engine — each extra cashflow costs one
elementwise term.  A receiver swaption is a call on the coupon bond at
strike 1 (coupons including notional); a payer swaption is the put.

The control variate generalizes naturally: Y = disc * V(r) with
E[Y] = sum_i c_i P(0, T_i) read off the market curve.

Validation: Jamshidian's decomposition (exact for monotone one-factor
models) — find r* with V(r*) = K, then the option is a portfolio of
zero-coupon-bond options with strikes K_i = c_i-weighted P(S1,T_i; r*) —
implemented in float64 as ``jamshidian_price``.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from .config import HWConfig
from .models import hull_white as hw
from .models.hull_white import MarketCurve
from .ops.accurate import exp32
from .ops.payoffs import cv_estimate
from .ops.rng import block_normals
from .parallel import mesh as pmesh
from . import pricing


class CouponSchedule(NamedTuple):
    times: tuple      # payment times T_i > S1
    coupons: tuple    # cashflows c_i (last one typically includes notional)


def swap_fixed_leg(cfg: HWConfig, rate: float, tenor: float,
                   freq: float = 1.0) -> CouponSchedule:
    """Fixed leg (plus notional) of a swap starting at cfg.s1: payments
    rate/freq at S1 + k/freq, k = 1..tenor*freq, notional 1 at the end."""
    n = int(round(tenor * freq))
    times = tuple(cfg.s1 + (k + 1) / freq for k in range(n))
    coupons = tuple(rate / freq + (1.0 if k == n - 1 else 0.0)
                    for k in range(n))
    return CouponSchedule(times=times, coupons=coupons)


def _bond_value_terms(cfg: HWConfig, sigma, market: MarketCurve,
                      sched: CouponSchedule, t=None):
    """(A_i c_i, B_i) arrays so V(r) = sum_i (c_i A_i) e^{-B_i r} at time
    ``t`` (default cfg.s1); cashflows at or before t are zeroed."""
    if t is None:
        t = cfg.s1
    Ts = jnp.asarray(sched.times, jnp.float32)
    cs = jnp.asarray(sched.coupons, jnp.float32)
    alive = (Ts > t + 1e-9).astype(jnp.float32)
    # accurate software exp: these coefficients are prep-only but feed
    # both the MC estimators and the fp64 DP oracles; a biased hardware
    # exp (-8.4e-7 mean, measured on one accelerator) showed up as a
    # common -8.5e-7 platform shift of the Bermudan bracket + oracle
    A = hw.a_hw(cfg, sigma, market, t, Ts, exp=exp32)
    B = hw.b_func(t, Ts, cfg.a, exp=exp32)
    return alive * cs * A, B


@lru_cache(maxsize=None)
def _cbo_moments_fn(cfg: HWConfig, engine: str, mesh, sched: CouponSchedule,
                    strike: float, payer: bool):
    dtype = jnp.dtype(cfg.dtype)

    def compute(key, sigma, market):
        tables = hw.step_tables(cfg, sigma, cfg.sigma, dtype)
        n_cols, state_of = pricing._xla_state_setup(cfg, engine, tables,
                                                    dual=False)
        cA, B = _bond_value_terms(cfg, sigma, market, sched)
        Ts = jnp.asarray(sched.times, jnp.float32)
        ey = jnp.sum(jnp.asarray(sched.coupons, jnp.float32)
                     * hw.interp_curve(market.P, Ts, cfg))  # E[Y]

        def leg(r, integral):
            V = jnp.sum(cA[None, :] * jnp.exp(-B[None, :] * r[:, None]),
                        axis=1)
            disc = jnp.exp(-integral)
            intrinsic = (strike - V) if payer else (V - strike)
            X = disc * jnp.maximum(intrinsic, 0.0)
            Yc = disc * V - ey
            return X, Yc

        def block_fn(key, i):
            G = block_normals(key, i, (cfg.path_block, n_cols), dtype)
            st = state_of(G)
            x1, y1 = leg(st.r_p, st.i_p)
            x2, y2 = leg(st.r_m, st.i_m)
            s = lambda v: jnp.sum(v, dtype=jnp.float32)
            return jnp.stack([
                s(x1) + s(x2), s(y1) + s(y2),
                s(x1 * x1) + s(x2 * x2), s(y1 * y1) + s(y2 * y2),
                s(x1 * y1) + s(x2 * y2),
                jnp.asarray(2.0 * cfg.path_block, jnp.float32),
            ])

        runner = pmesh.shard_blocks(pricing._block_loop(block_fn, 6), mesh)
        return runner(key, cfg.n_blocks), ey

    return jax.jit(compute)


def price_coupon_bond_option(cfg: HWConfig, key, market: MarketCurve,
                             sched: CouponSchedule, strike: float = 1.0,
                             *, payer: bool = False, sigma=None,
                             engine: str = "exact", mesh=None):
    """CV-adjusted MC price of a call (payer=False) or put (payer=True) on
    the coupon bond, exercised at cfg.s1."""
    if sigma is None:
        sigma = cfg.sigma
    moments, ey = _cbo_moments_fn(cfg, engine, mesh, sched, float(strike),
                                  bool(payer))(key, sigma, market)
    return cv_estimate(moments, ey)


def price_swaption(cfg: HWConfig, key, market: MarketCurve, *, rate: float,
                   tenor: float, freq: float = 1.0, payer: bool = True,
                   sigma=None, engine: str = "exact", mesh=None):
    """European swaption with expiry cfg.s1 on a (rate, tenor) swap.

    payer swaption = put on the fixed-leg coupon bond at strike 1;
    receiver = call.
    """
    sched = swap_fixed_leg(cfg, rate, tenor, freq)
    return price_coupon_bond_option(cfg, key, market, sched, 1.0,
                                    payer=payer, sigma=sigma, engine=engine,
                                    mesh=mesh)


# ---------------------------------------------------------------------------
# RQMC pricing (the payoff is a function of the same 2-d Gaussian state)
# ---------------------------------------------------------------------------

@lru_cache(maxsize=None)
def _cbo_qmc_fn(cfg: HWConfig, sched: CouponSchedule, strike: float,
                payer: bool, n_points: int, n_shifts: int):
    from .ops import engine_exact
    from .ops.qmc import sobol2

    def one_shift(shift, zw, cA, B):
        u = sobol2(n_points, shift)
        x = jax.scipy.special.ndtri(u)
        st = engine_exact.antithetic_state(cfg, zw, x)

        def leg(r, integral):
            V = jnp.sum(cA[None, :] * jnp.exp(-B[None, :] * r[:, None]),
                        axis=1)
            intrinsic = (strike - V) if payer else (V - strike)
            return jnp.exp(-integral) * jnp.maximum(intrinsic, 0.0)

        return 0.5 * (jnp.mean(leg(st.r_p, st.i_p))
                      + jnp.mean(leg(st.r_m, st.i_m)))

    def compute(key, sigma, market):
        # shift-invariant work hoisted out of the replicate loop
        tables = hw.step_tables(cfg, sigma, cfg.sigma, jnp.float32)
        zw = engine_exact.zbc_weights(cfg, tables)
        cA, B = _bond_value_terms(cfg, sigma, market, sched)
        shifts = jax.random.bits(key, (n_shifts, 2), jnp.uint32)
        vals = jax.lax.map(lambda s: one_shift(s, zw, cA, B), shifts)
        return (jnp.mean(vals),
                jnp.std(vals, ddof=1) / jnp.sqrt(1.0 * n_shifts))

    return jax.jit(compute)


def price_coupon_bond_option_qmc(cfg: HWConfig, key, market: MarketCurve,
                                 sched: CouponSchedule, strike: float = 1.0,
                                 *, payer: bool = False, sigma=None,
                                 n_points: int = 1 << 16,
                                 n_shifts: int = 8):
    """(price, SE) by randomized QMC — same ~100-460x SE advantage as the
    ZBC pricer since the instrument shares its 2-d Gaussian state."""
    if n_shifts < 2:
        raise ValueError("n_shifts must be >= 2 for a valid standard error")
    if sigma is None:
        sigma = cfg.sigma
    return _cbo_qmc_fn(cfg, sched, float(strike), bool(payer), int(n_points),
                       int(n_shifts))(key, jnp.asarray(sigma, jnp.float32),
                                      market)


# ---------------------------------------------------------------------------
# Jamshidian decomposition (float64 host oracle / fast analytic pricer)
# ---------------------------------------------------------------------------

def _np_curve(cfg: HWConfig, market: MarketCurve):
    Ts = np.linspace(0.0, cfg.t_final, cfg.n_mat)
    return Ts, np.asarray(market.P, np.float64), np.asarray(market.f, np.float64)


def _np_AB(cfg: HWConfig, market: MarketCurve, t: float, T, sigma: float):
    Ts, P, f = _np_curve(cfg, market)
    T = np.asarray(T, np.float64)
    a = cfg.a
    B = (1.0 - np.exp(-a * (T - t))) / a
    P0T = np.interp(T, Ts, P)
    P0t = np.interp(t, Ts, P)
    f0t = np.interp(t, Ts, f)
    conv = (sigma**2 / (4 * a)) * (1 - math.exp(-2 * a * t)) * B * B
    return (P0T / P0t) * np.exp(B * f0t - conv), B, P0T, P0t


def _zbc_closed(cfg: HWConfig, market: MarketCurve, T_mat: float, K: float,
                sigma: float):
    """Closed-form ZBC(S1, T_mat, K) on the given market curve."""
    from .models.oracles import _phi as phi

    Ts, P, _ = _np_curve(cfg, market)
    a, s1 = cfg.a, cfg.s1
    P1 = float(np.interp(s1, Ts, P))
    P2 = float(np.interp(T_mat, Ts, P))
    B = (1.0 - math.exp(-a * (T_mat - s1))) / a
    sp = sigma * B * math.sqrt((1 - math.exp(-2 * a * s1)) / (2 * a))
    h = math.log(P2 / (K * P1)) / sp + 0.5 * sp
    return P2 * phi(h) - K * P1 * phi(h - sp)


def jamshidian_price(cfg: HWConfig, market: MarketCurve,
                     sched: CouponSchedule, strike: float = 1.0,
                     *, payer: bool = False, sigma=None) -> float:
    """Exact coupon-bond-option price as a portfolio of ZBC/ZBP options.

    Solve V(r*) = strike by Newton (V is strictly decreasing in r), then
    price = sum_i c_i ZBC(S1, T_i, K_i) with K_i = P(S1, T_i; r*); the put
    (payer swaption) follows by parity per cashflow:
    ZBP = ZBC - P(0,T_i) + K_i P(0,S1).
    """
    if sigma is None:
        sigma = cfg.sigma
    A, B, P0T, _ = _np_AB(cfg, market, cfg.s1, np.asarray(sched.times),
                          float(sigma))
    cs = np.asarray(sched.coupons, np.float64)

    def V(r):
        return float(np.sum(cs * A * np.exp(-B * r)))

    def dV(r):
        return float(-np.sum(cs * A * B * np.exp(-B * r)))

    r = 0.02
    for _ in range(60):
        step = (V(r) - strike) / dV(r)
        r -= step
        if abs(step) < 1e-14:
            break
    K_i = A * np.exp(-B * r)  # P(S1, T_i; r*)

    Ts, P, _ = _np_curve(cfg, market)
    P0s1 = float(np.interp(cfg.s1, Ts, P))
    total = 0.0
    for c, T_i, k_i, p0 in zip(cs, sched.times, K_i, P0T):
        zbc = _zbc_closed(cfg, market, float(T_i), float(k_i), float(sigma))
        if payer:
            zbc = zbc - float(p0) + float(k_i) * P0s1  # put by parity
        total += float(c) * zbc
    return total


# ---------------------------------------------------------------------------
# Caps / floors (round 2) — a further instrument family beyond the reference
#
# A caplet on the simple forward rate L(t1, t2) with strike K and accrual
# tau = t2 - t1 equals (1 + tau K) zero-bond PUTS struck at 1/(1 + tau K)
# (classic static replication), so the float64 oracle is the Hull-White
# ZBP closed form per period.  Monte Carlo prices every caplet from ONE
# exactly-sampled multi-date state set (the Bermudan machinery's joint
# (r, I) Cholesky over reset/payment dates): payoff_j =
# e^{-I(t_{j+1})} tau max(L_j - K, 0) with L_j a function of r(t_j) only.
# ---------------------------------------------------------------------------

class CapResult(NamedTuple):
    price: jax.Array          # cap (or floor) value
    std_error: jax.Array
    caplets: jax.Array        # (n_periods,) per-caplet values
    reset_times: tuple
    n_paths: int


def curve_level(cfg: HWConfig, market: MarketCurve, t: float) -> float:
    """float64 P(0, t) interpolated off the market curve."""
    Ts = np.linspace(0.0, cfg.t_final, cfg.n_mat)
    return float(np.interp(t, Ts, np.asarray(market.P, np.float64)))


def zbp_black(P1: float, P2: float, K: float, S: float) -> float:
    """float64 zero-bond put on P(t1, t2) struck at K, given the curve
    levels and the model's total bond-price volatility S — the shared
    Black-style formula; Hull-White and G2++ differ only in S."""
    import math as m

    from .models.oracles import _phi

    h = m.log(P2 / (K * P1)) / S + 0.5 * S
    return K * P1 * _phi(-h + S) - P2 * _phi(-h)


def _zbp_closed(cfg: HWConfig, market: MarketCurve, t1: float, t2: float,
                K: float, sigma: float | None = None) -> float:
    """float64 Hull-White zero-bond put P(t1)-strike-K on P(t1, t2)."""
    import math as m

    if sigma is None:
        sigma = cfg.sigma
    a = cfg.a
    B = (1.0 - m.exp(-a * (t2 - t1))) / a
    sp = sigma * B * m.sqrt((1.0 - m.exp(-2.0 * a * t1)) / (2.0 * a))
    return zbp_black(curve_level(cfg, market, t1),
                     curve_level(cfg, market, t2), K, sp)


def cap_replication(cfg: HWConfig, market: MarketCurve, zbp, *,
                    rate: float, start: float, tenor: float, freq: float,
                    floor: bool):
    """Shared caplet replication: cap = sum over periods of (1 + tau K)
    zero-bond puts struck at 1/(1 + tau K); floorlets via per-period
    put-call parity.  ``zbp(t1, t2, K)`` supplies the model-specific
    zero-bond put (the only model-dependent piece)."""
    n = int(round(tenor * freq))
    tau = 1.0 / freq
    total, per = 0.0, []
    for j in range(n):
        t1 = start + j * tau
        t2 = t1 + tau
        v = (1.0 + tau * rate) * zbp(t1, t2, 1.0 / (1.0 + tau * rate))
        if floor:
            # floorlet = caplet - forward value (put-call parity per period)
            v = v - (curve_level(cfg, market, t1)
                     - (1.0 + tau * rate) * curve_level(cfg, market, t2))
        per.append(v)
        total += v
    return total, per


def cap_closed_form(cfg: HWConfig, market: MarketCurve, *, rate: float,
                    start: float | None = None, tenor: float = 5.0,
                    freq: float = 1.0, floor: bool = False,
                    sigma: float | None = None):
    """float64 cap/floor value: sum of caplets = scaled ZBP/ZBC options."""
    if start is None:
        start = cfg.s1
    return cap_replication(
        cfg, market,
        lambda t1, t2, K: _zbp_closed(cfg, market, t1, t2, K, sigma),
        rate=rate, start=start, tenor=tenor, freq=freq, floor=floor)


@lru_cache(maxsize=None)
def _cap_fn(cfg: HWConfig, rate: float, start: float, n: int, tau: float,
            floor: bool, n_paths: int, n_blocks: int = 1, mesh=None):
    from .bermudan import _joint_chol, _det_states

    dates = tuple(start + j * tau for j in range(n + 1))
    LT = jnp.asarray(_joint_chol(cfg, dates))
    k = len(dates)

    def compute(key, sigma, market):
        tables = hw.step_tables(cfg, sigma, cfg.sigma, jnp.float32)
        r_det, i_det = _det_states(cfg, tables, dates)

        def block(bi):
            x = jax.random.normal(jax.random.fold_in(key, bi),
                                  (n_paths, 2 * k), jnp.float32)
            z = tables.sig_st * jnp.dot(x, LT,
                                        preferred_element_type=jnp.float32,
                                        precision=cfg.matmul_precision)

            def leg(sgn):
                r = r_det[None, :] + sgn * z[:, 0::2]
                integral = i_det[None, :] + sgn * z[:, 1::2]
                vals = []
                for j in range(n):
                    t1, t2 = dates[j], dates[j + 1]
                    A = hw.a_hw(cfg, sigma, market, t1, jnp.float32(t2))
                    B = hw.b_func(t1, t2, cfg.a)
                    Pb = A * jnp.exp(-B * r[:, j])    # P(t1, t2) on path
                    L = (1.0 / Pb - 1.0) / tau
                    disc = jnp.exp(-integral[:, j + 1])
                    intrinsic = (rate - L) if floor else (L - rate)
                    vals.append(disc * tau * jnp.maximum(intrinsic, 0.0))
                return jnp.stack(vals, axis=1)        # (n_paths, n)

            V = 0.5 * (leg(1.0) + leg(-1.0))
            tot = jnp.sum(V, axis=1)
            return jnp.concatenate([
                jnp.stack([jnp.sum(tot), jnp.sum(tot * tot)]),
                jnp.sum(V, axis=0)])

        s = jnp.sum(pmesh.map_blocks(block, n_blocks, mesh), axis=0)
        n_tot = 1.0 * n_paths * n_blocks
        mean = s[0] / n_tot
        var = jnp.maximum(s[1] / n_tot - mean ** 2, 0.0)
        # ddof=1 correction to match the former per-batch jnp.std
        var = var * n_tot / jnp.maximum(n_tot - 1.0, 1.0)
        return mean, jnp.sqrt(var / n_tot), s[2:] / n_tot

    return jax.jit(compute)


def price_cap(cfg: HWConfig, key, market: MarketCurve, *, rate: float,
              start: float | None = None, tenor: float = 5.0,
              freq: float = 1.0, floor: bool = False, sigma=None,
              n_paths: int | None = None, n_blocks: int = 1,
              mesh=None) -> CapResult:
    """Monte Carlo cap/floor on the simple forward rate, all periods from
    one exactly-sampled multi-date state set (antithetic).  Blocks key on
    their global index and optionally shard over ``mesh``."""
    if sigma is None:
        sigma = cfg.sigma
    if n_paths is None:
        n_paths = cfg.n_paths
    if start is None:
        start = cfg.s1
    n = int(round(tenor * freq))
    tau = 1.0 / freq
    price, se, caplets = _cap_fn(cfg, float(rate), float(start), n,
                                 float(tau), bool(floor), int(n_paths),
                                 int(n_blocks), mesh)(
        key, jnp.asarray(sigma, jnp.float32), market)
    return CapResult(price=price, std_error=se, caplets=caplets,
                     reset_times=tuple(start + j * tau for j in range(n)),
                     n_paths=int(n_paths) * int(n_blocks))


# ---------------------------------------------------------------------------
# CMS cap/floor leg (round 3): constant-maturity-swap caplets on the exact
# multi-date states.  A genuinely convexity-bearing payoff the reference's
# product layer (2_option_pricing.cu:14-35) has no analogue of: the payer
# leg pays tau (S(T_j) - K)^+ at T_{j+1}, with S(T_j) the ``swap_tenor``
# par swap rate OBSERVED at the reset — paid at the "wrong" time, so the
# price carries the CMS convexity adjustment automatically (the exact
# joint (r, I) law prices it with no measure-change approximation).
# ---------------------------------------------------------------------------

class CMSResult(NamedTuple):
    price: jax.Array          # leg value
    std_error: jax.Array
    periods: jax.Array        # (n_periods,) per-caplet values
    reset_times: tuple
    n_paths: int


def _swap_rate_terms(cfg: HWConfig, sigma, market, t: float,
                     swap_tenor: float, swap_freq: float):
    """(cA, B) arrays so S(r) = (1 - cA_n e^{-B_n r}) / annuity(r) with
    annuity(r) = sum_i tau_s cA_i e^{-B_i r}: the par ``swap_tenor`` swap
    rate at observation time t as a closed function of r(t)."""
    m = int(round(swap_tenor * swap_freq))
    tau_s = 1.0 / swap_freq
    Ts = [t + (i + 1) * tau_s for i in range(m)]
    A = jnp.stack([hw.a_hw(cfg, sigma, market, t, jnp.float32(Ti))
                   for Ti in Ts])
    B = jnp.asarray([hw.b_func(t, Ti, cfg.a) for Ti in Ts], jnp.float32)
    return A, B, tau_s


@lru_cache(maxsize=None)
def _cms_fn(cfg: HWConfig, rate: float, start: float, n: int, tau: float,
            swap_tenor: float, swap_freq: float, floor: bool,
            n_paths: int, n_blocks: int, mesh):
    from .bermudan import _joint_chol, _det_states

    dates = tuple(start + j * tau for j in range(n + 1))
    LT = jnp.asarray(_joint_chol(cfg, dates))
    k = len(dates)

    def compute(key, sigma, market):
        tables = hw.step_tables(cfg, sigma, cfg.sigma, jnp.float32)
        r_det, i_det = _det_states(cfg, tables, dates)
        terms = [_swap_rate_terms(cfg, sigma, market, dates[j],
                                  swap_tenor, swap_freq)
                 for j in range(n)]

        def block(bi):
            x = jax.random.normal(jax.random.fold_in(key, bi),
                                  (n_paths, 2 * k), jnp.float32)
            z = tables.sig_st * jnp.dot(x, LT,
                                        preferred_element_type=jnp.float32,
                                        precision=cfg.matmul_precision)

            def leg(sgn):
                r = r_det[None, :] + sgn * z[:, 0::2]
                integral = i_det[None, :] + sgn * z[:, 1::2]
                vals = []
                for j in range(n):
                    A, B, tau_s = terms[j]
                    P = A[None, :] * jnp.exp(-B[None, :] * r[:, j][:, None])
                    annuity = tau_s * jnp.sum(P, axis=1)
                    S = (1.0 - P[:, -1]) / annuity
                    disc = jnp.exp(-integral[:, j + 1])
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


def price_cms(cfg: HWConfig, key, market: MarketCurve, *, rate: float,
              start: float | None = None, tenor: float = 4.0,
              freq: float = 1.0, swap_tenor: float = 5.0,
              swap_freq: float = 1.0, floor: bool = False, sigma=None,
              n_paths: int | None = None, n_blocks: int = 1,
              mesh=None) -> CMSResult:
    """Monte Carlo CMS cap/floor leg: tau (S(T_j) - K)^+ paid at T_{j+1}
    with S the observed ``swap_tenor`` par rate, all periods from one
    exactly-sampled multi-date (r, I) state set (antithetic).  Blocks key
    on their global index and optionally shard over ``mesh``.  fp64
    oracle: cms_quadrature (exponential tilting + adaptive-domain
    Gauss-Legendre on the 1-d short-rate law)."""
    if sigma is None:
        sigma = cfg.sigma
    if n_paths is None:
        n_paths = cfg.n_paths
    if start is None:
        start = cfg.s1
    n = int(round(tenor * freq))
    tau = 1.0 / freq
    price, se, periods = _cms_fn(cfg, float(rate), float(start), n,
                                 float(tau), float(swap_tenor),
                                 float(swap_freq), bool(floor),
                                 int(n_paths), int(n_blocks), mesh)(
        key, jnp.asarray(sigma, jnp.float32), market)
    return CMSResult(price=price, std_error=se, periods=periods,
                     reset_times=tuple(start + j * tau for j in range(n)),
                     n_paths=int(n_paths) * int(n_blocks))


def cms_quadrature(cfg: HWConfig, market: MarketCurve, *, rate: float,
                   start: float | None = None, tenor: float = 4.0,
                   freq: float = 1.0, swap_tenor: float = 5.0,
                   swap_freq: float = 1.0, floor: bool = False,
                   sigma: float | None = None, n_quad: int = 400):
    """float64 CMS leg by 1-d quadrature under the model's DISCRETE
    trapezoid law (the same law the engines sample, so this pins the MC
    estimator to quadrature accuracy, not to a continuous-time formula).

    Per period, (r(T), I(T_p)) is Gaussian: tilting by e^{-I_p}
    multiplies by E[e^{-I_p}] and shifts r's mean by -Cov(r_T, I_p); the
    kinked payoff is integrated exactly by locating the strike root r*
    (bisection) and Gauss-Legendre over the in-the-money side only
    (smooth integrand).  Returns (leg value, per-period list)."""
    from numpy.polynomial.legendre import leggauss

    from .bermudan import _det_states, _step_index
    from .ops.engine_linear import _shock_shapes

    if sigma is None:
        sigma = cfg.sigma
    if start is None:
        start = cfg.s1
    n = int(round(tenor * freq))
    tau = 1.0 / freq
    dates = tuple(start + j * tau for j in range(n + 1))
    tables = hw.step_tables(cfg, sigma, cfg.sigma, jnp.float32)
    r_det, i_det = (np.asarray(a, np.float64)
                    for a in _det_states(cfg, tables, dates))
    sig = float(tables.sig_st)
    gx, gw = leggauss(n_quad)
    total, per = 0.0, []
    for j in range(n):
        nT = _step_index(cfg, dates[j])
        np_ = _step_index(cfg, dates[j + 1])
        uT, _ = (np.asarray(a, np.float64)
                 for a in _shock_shapes(cfg, nT))
        _, wp = (np.asarray(a, np.float64)
                 for a in _shock_shapes(cfg, np_))
        var_r = sig * sig * float(uT @ uT)
        var_I = sig * sig * float(wp @ wp)
        cov_rI = sig * sig * float(uT @ wp[:nT])
        w0 = math.exp(-i_det[j + 1] + 0.5 * var_I)
        m_r = r_det[j] - cov_rI           # tilted mean of r(T_j)
        s_r = math.sqrt(var_r)
        A, B, tau_s = _swap_rate_terms(cfg, sigma, market, dates[j],
                                       swap_tenor, swap_freq)
        A = np.asarray(A, np.float64)
        B = np.asarray(B, np.float64)

        def srate(r):
            P = A[None, :] * np.exp(-B[None, :] * np.atleast_1d(r)[:, None])
            return (1.0 - P[:, -1]) / (tau_s * np.sum(P, axis=1))

        # strike root (S is increasing in r)
        lo, hi = m_r - 12.0 * s_r, m_r + 12.0 * s_r
        for _ in range(200):
            mid = 0.5 * (lo + hi)
            if srate(mid)[0] < rate:
                lo = mid
            else:
                hi = mid
        rstar = 0.5 * (lo + hi)
        # integrate the ITM side with GL (smooth there)
        if floor:
            a_, b_ = m_r - 12.0 * s_r, rstar
        else:
            a_, b_ = rstar, m_r + 12.0 * s_r
        r = 0.5 * (b_ - a_) * gx + 0.5 * (a_ + b_)
        wq = 0.5 * (b_ - a_) * gw
        pdf = np.exp(-0.5 * ((r - m_r) / s_r) ** 2) / (
            s_r * math.sqrt(2.0 * math.pi))
        intr = (rate - srate(r)) if floor else (srate(r) - rate)
        v = w0 * tau * float(np.sum(np.maximum(intr, 0.0) * pdf * wq))
        per.append(v)
        total += v
    return total, per


# ---------------------------------------------------------------------------
# CMS spread option (beyond-reference exotic, same product layer as the
# reference's single option, src/2_option_pricing.cu:14-35): each period
# pays tau (S_long(T_j) - S_short(T_j) - K)^+ at T_{j+1}, both par swap
# rates OBSERVED at the reset.  Under one-factor Hull-White both rates are
# closed functions of r(T_j), so the whole leg reuses the exact multi-date
# (r, I) states of the CMS leg; the spread's dependence on r need not be
# monotone, so the fp64 oracle locates every root of the spread-minus-
# strike function before integrating.
# ---------------------------------------------------------------------------

@lru_cache(maxsize=None)
def _cms_spread_fn(cfg: HWConfig, strike: float, start: float, n: int,
                   tau: float, long_tenor: float, short_tenor: float,
                   swap_freq: float, floor: bool, n_paths: int,
                   n_blocks: int, mesh):
    from .bermudan import _joint_chol, _det_states

    dates = tuple(start + j * tau for j in range(n + 1))
    LT = jnp.asarray(_joint_chol(cfg, dates))
    k = len(dates)

    def compute(key, sigma, market):
        tables = hw.step_tables(cfg, sigma, cfg.sigma, jnp.float32)
        r_det, i_det = _det_states(cfg, tables, dates)
        terms = [(
            _swap_rate_terms(cfg, sigma, market, dates[j], long_tenor,
                             swap_freq),
            _swap_rate_terms(cfg, sigma, market, dates[j], short_tenor,
                             swap_freq)) for j in range(n)]

        def srate(term, r_col):
            A, B, tau_s = term
            P = A[None, :] * jnp.exp(-B[None, :] * r_col[:, None])
            return (1.0 - P[:, -1]) / (tau_s * jnp.sum(P, axis=1))

        def block(bi):
            x = jax.random.normal(jax.random.fold_in(key, bi),
                                  (n_paths, 2 * k), jnp.float32)
            z = tables.sig_st * jnp.dot(x, LT,
                                        preferred_element_type=jnp.float32,
                                        precision=cfg.matmul_precision)

            def leg(sgn):
                r = r_det[None, :] + sgn * z[:, 0::2]
                integral = i_det[None, :] + sgn * z[:, 1::2]
                vals = []
                for j in range(n):
                    tl, ts = terms[j]
                    spread = srate(tl, r[:, j]) - srate(ts, r[:, j])
                    disc = jnp.exp(-integral[:, j + 1])
                    intrinsic = (strike - spread) if floor \
                        else (spread - strike)
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


def price_cms_spread(cfg: HWConfig, key, market: MarketCurve, *,
                     strike: float, start: float | None = None,
                     tenor: float = 4.0, freq: float = 1.0,
                     long_tenor: float = 10.0, short_tenor: float = 2.0,
                     swap_freq: float = 1.0, floor: bool = False,
                     sigma=None, n_paths: int | None = None,
                     n_blocks: int = 1, mesh=None) -> CMSResult:
    """Monte Carlo CMS spread cap/floor leg: tau (S_long - S_short - K)^+
    paid at T_{j+1}, both par rates observed at T_j, all periods from one
    exactly-sampled multi-date (r, I) state set (antithetic).  Blocks key
    on their global index and optionally shard over ``mesh``.  fp64
    oracle: cms_spread_quadrature (root-located piecewise Gauss-Legendre
    on the tilted 1-d short-rate law)."""
    if sigma is None:
        sigma = cfg.sigma
    if n_paths is None:
        n_paths = cfg.n_paths
    if start is None:
        start = cfg.s1
    n = int(round(tenor * freq))
    tau = 1.0 / freq
    price, se, periods = _cms_spread_fn(
        cfg, float(strike), float(start), n, float(tau), float(long_tenor),
        float(short_tenor), float(swap_freq), bool(floor), int(n_paths),
        int(n_blocks), mesh)(key, jnp.asarray(sigma, jnp.float32), market)
    return CMSResult(price=price, std_error=se, periods=periods,
                     reset_times=tuple(start + j * tau for j in range(n)),
                     n_paths=int(n_paths) * int(n_blocks))


def cms_spread_quadrature(cfg: HWConfig, market: MarketCurve, *,
                          strike: float, start: float | None = None,
                          tenor: float = 4.0, freq: float = 1.0,
                          long_tenor: float = 10.0, short_tenor: float = 2.0,
                          swap_freq: float = 1.0, floor: bool = False,
                          sigma: float | None = None, n_quad: int = 400):
    """float64 CMS spread leg by 1-d quadrature under the model's DISCRETE
    trapezoid law (same tilting as cms_quadrature).  The spread S_long(r)
    - S_short(r) is NOT monotone in general, so the in-the-money set is
    found by dense sign scanning plus bisection of every root of
    spread(r) - K, then each ITM interval is integrated by Gauss-Legendre
    (the integrand is smooth inside an interval).  Returns
    (leg value, per-period list)."""
    from numpy.polynomial.legendre import leggauss

    from .bermudan import _det_states, _step_index
    from .ops.engine_linear import _shock_shapes

    if sigma is None:
        sigma = cfg.sigma
    if start is None:
        start = cfg.s1
    n = int(round(tenor * freq))
    tau = 1.0 / freq
    dates = tuple(start + j * tau for j in range(n + 1))
    tables = hw.step_tables(cfg, sigma, cfg.sigma, jnp.float32)
    r_det, i_det = (np.asarray(a, np.float64)
                    for a in _det_states(cfg, tables, dates))
    sig = float(tables.sig_st)
    gx, gw = leggauss(n_quad)
    total, per = 0.0, []
    for j in range(n):
        nT = _step_index(cfg, dates[j])
        np_ = _step_index(cfg, dates[j + 1])
        uT, _ = (np.asarray(a, np.float64)
                 for a in _shock_shapes(cfg, nT))
        _, wp = (np.asarray(a, np.float64)
                 for a in _shock_shapes(cfg, np_))
        var_r = sig * sig * float(uT @ uT)
        var_I = sig * sig * float(wp @ wp)
        cov_rI = sig * sig * float(uT @ wp[:nT])
        w0 = math.exp(-i_det[j + 1] + 0.5 * var_I)
        m_r = r_det[j] - cov_rI           # tilted mean of r(T_j)
        s_r = math.sqrt(var_r)

        def srate_np(term, r):
            A, B, tau_s = term
            A = np.asarray(A, np.float64)
            B = np.asarray(B, np.float64)
            P = A[None, :] * np.exp(-B[None, :] * np.atleast_1d(r)[:, None])
            return (1.0 - P[:, -1]) / (tau_s * np.sum(P, axis=1))

        tl = _swap_rate_terms(cfg, sigma, market, dates[j], long_tenor,
                              swap_freq)
        ts = _swap_rate_terms(cfg, sigma, market, dates[j], short_tenor,
                              swap_freq)

        def g(r):
            return srate_np(tl, r) - srate_np(ts, r) - strike

        lo, hi = m_r - 12.0 * s_r, m_r + 12.0 * s_r
        grid = np.linspace(lo, hi, 2001)
        gv = g(grid)
        roots = []
        for i in range(len(grid) - 1):
            if gv[i] == 0.0:
                roots.append(grid[i])
            elif gv[i] * gv[i + 1] < 0.0:
                a_, b_ = grid[i], grid[i + 1]
                fa = gv[i]
                for _ in range(80):
                    mid = 0.5 * (a_ + b_)
                    fm = g(np.array([mid]))[0]
                    if fa * fm <= 0.0:
                        b_ = mid
                    else:
                        a_, fa = mid, fm
                roots.append(0.5 * (a_ + b_))
        edges = [lo] + roots + [hi]
        pdf_c = 1.0 / (s_r * math.sqrt(2.0 * math.pi))
        v = 0.0
        for a_, b_ in zip(edges[:-1], edges[1:]):
            mid_val = g(np.array([0.5 * (a_ + b_)]))[0]
            itm = (mid_val < 0.0) if floor else (mid_val > 0.0)
            if not itm:
                continue
            r = 0.5 * (b_ - a_) * gx + 0.5 * (a_ + b_)
            wq = 0.5 * (b_ - a_) * gw
            pdf = pdf_c * np.exp(-0.5 * ((r - m_r) / s_r) ** 2)
            intr = -g(r) if floor else g(r)
            v += w0 * tau * float(np.sum(intr * pdf * wq))
        per.append(v)
        total += v
    return total, per


# ---------------------------------------------------------------------------
# Range accrual (beyond-reference exotic): period j accrues
# coupon * tau * (1/m) sum_i 1{lo <= L(t_ji; delta) <= hi}, paid at
# T_{j+1}, with L the delta-LIBOR observed at t_ji = T_j + i tau/m.  Under
# Hull-White L(t) = (1/delta)(1/P(t, t+delta) - 1) is increasing in r(t),
# so every observation is an interval indicator on r — the leg value is a
# sum of tilted Gaussian probabilities and the fp64 oracle is CLOSED FORM
# (no quadrature at all), the tightest oracle in the instrument family.
# ---------------------------------------------------------------------------

class RangeAccrualResult(NamedTuple):
    price: jax.Array          # leg value
    std_error: jax.Array
    periods: jax.Array        # (n_periods,) per-period values
    mean_fraction: jax.Array  # (n_periods,) mean accrual fractions (undisc.)
    n_paths: int


def _libor_r_bounds(cfg: HWConfig, sigma, market, t: float, delta: float,
                    lo: float, hi: float):
    """(r_lo, r_hi) so that lo <= L(t, t+delta) <= hi  <=>  r in the
    interval: P(t, t+delta; r) = A e^{-B r} and 1 + delta L = 1/P give
    r = (log A + log(1 + delta L)) / B exactly (L increasing in r)."""
    A = hw.a_hw(cfg, sigma, market, t, jnp.float32(t + delta))
    B = hw.b_func(t, t + delta, cfg.a)

    def bound(level):
        # L > -1/delta always (P > 0): a band edge at or below the floor
        # maps to r = -inf (never binding)
        if 1.0 + delta * level <= 0.0:
            return jnp.float32(-jnp.inf)
        return (jnp.log(A) + math.log1p(delta * level)) / B

    return bound(lo), bound(hi)


@lru_cache(maxsize=None)
def _range_accrual_fn(cfg: HWConfig, coupon: float, lo: float, hi: float,
                      start: float, n: int, tau: float, m: int,
                      delta: float, n_paths: int, n_blocks: int, mesh):
    from .bermudan import _joint_chol, _det_states

    from .bermudan import _functional_chol, _functional_det

    obs = [tuple(start + j * tau + i * tau / m for i in range(m))
           for j in range(n)]
    pays = tuple(start + (j + 1) * tau for j in range(n))
    # sample EXACTLY the functionals the payoff touches, in payoff order:
    # r at the n*m observations, then I at the n payments — no gathers or
    # strided slices in the kernel (a per-observation loop, and even a
    # single (n, m) gather off the full date set, measured ~2-4x the
    # draws+matmul floor)
    specs = tuple([("r", t) for o in obs for t in o]
                  + [("I", t) for t in pays])
    LT = jnp.asarray(_functional_chol(cfg, specs))
    nm = n * m

    def compute(key, sigma, market):
        tables = hw.step_tables(cfg, sigma, cfg.sigma, jnp.float32)
        det = _functional_det(cfg, sigma, specs)
        r_det = det[:nm].reshape(n, m)
        i_det = det[nm:]
        b_lo, b_hi = (jnp.stack(b).reshape(n, m) for b in zip(
            *[_libor_r_bounds(cfg, sigma, market, t, delta, lo, hi)
              for o in obs for t in o]))

        def block(bi):
            x = jax.random.normal(jax.random.fold_in(key, bi),
                                  (n_paths, nm + n), jnp.float32)
            z = tables.sig_st * jnp.dot(x, LT,
                                        preferred_element_type=jnp.float32,
                                        precision=cfg.matmul_precision)

            def leg(sgn):
                ro = r_det[None, :, :] + sgn * z[:, :nm].reshape(
                    -1, n, m)                            # (paths, n, m)
                in_band = ((ro >= b_lo[None, :, :])
                           & (ro <= b_hi[None, :, :]))
                fracs = jnp.mean(in_band.astype(jnp.float32), axis=2)
                disc = jnp.exp(-(i_det[None, :]
                                 + sgn * z[:, nm:]))     # (paths, n)
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


def price_range_accrual(cfg: HWConfig, key, market: MarketCurve, *,
                        coupon: float, lo: float, hi: float,
                        start: float | None = None, tenor: float = 4.0,
                        freq: float = 1.0, obs_per_period: int = 5,
                        libor_tenor: float | None = None, sigma=None,
                        n_paths: int | None = None, n_blocks: int = 1,
                        mesh=None) -> RangeAccrualResult:
    """Monte Carlo range-accrual leg: coupon tau (1/m) sum_i
    1{lo <= L(t_i) <= hi} paid at each T_{j+1}, every observation and
    payment drawn from one exactly-sampled multi-date (r, I) state set
    (antithetic).  Observation dates must sit on the step grid (tau/m a
    multiple of cfg.dt).  Blocks key on their global index and optionally
    shard over ``mesh``.  fp64 oracle: range_accrual_closed_form — exact
    tilted-Gaussian probabilities, no quadrature."""
    if sigma is None:
        sigma = cfg.sigma
    if n_paths is None:
        n_paths = cfg.n_paths
    if start is None:
        start = cfg.s1
    n = int(round(tenor * freq))
    tau = 1.0 / freq
    if libor_tenor is None:
        libor_tenor = tau / obs_per_period
    price, se, periods, fracs = _range_accrual_fn(
        cfg, float(coupon), float(lo), float(hi), float(start), n,
        float(tau), int(obs_per_period), float(libor_tenor), int(n_paths),
        int(n_blocks), mesh)(key, jnp.asarray(sigma, jnp.float32), market)
    return RangeAccrualResult(price=price, std_error=se, periods=periods,
                              mean_fraction=fracs,
                              n_paths=int(n_paths) * int(n_blocks))


def range_accrual_closed_form(cfg: HWConfig, market: MarketCurve, *,
                              coupon: float, lo: float, hi: float,
                              start: float | None = None, tenor: float = 4.0,
                              freq: float = 1.0, obs_per_period: int = 5,
                              libor_tenor: float | None = None,
                              sigma: float | None = None):
    """float64 range-accrual leg in CLOSED FORM under the model's DISCRETE
    trapezoid law: each observation contributes

        coupon tau/m E[e^{-I(T_p)} 1{r_lo <= r(t_i) <= r_hi}]
      = coupon tau/m e^{-I_det(T_p) + var_I/2}
          (Phi((r_hi - mu~)/s) - Phi((r_lo - mu~)/s)),

    with mu~ = r_det(t_i) - Cov(r(t_i), I(T_p)) the exponentially tilted
    mean (Gaussian change of measure; same tilting as cms_quadrature but
    the interval indicator integrates to Phi differences exactly).
    Returns (leg value, per-period list)."""
    from .bermudan import _det_states, _step_index
    from .models.oracles import _phi
    from .ops.engine_linear import _shock_shapes

    if sigma is None:
        sigma = cfg.sigma
    if start is None:
        start = cfg.s1
    n = int(round(tenor * freq))
    tau = 1.0 / freq
    m = int(obs_per_period)
    if libor_tenor is None:
        libor_tenor = tau / m
    obs = [tuple(start + j * tau + i * tau / m for i in range(m))
           for j in range(n)]
    pays = tuple(start + (j + 1) * tau for j in range(n))
    dates = tuple(sorted({t for o in obs for t in o} | set(pays)))
    idx = {t: q for q, t in enumerate(dates)}
    tables = hw.step_tables(cfg, sigma, cfg.sigma, jnp.float32)
    r_det, i_det = (np.asarray(a, np.float64)
                    for a in _det_states(cfg, tables, dates))
    sig = float(tables.sig_st)
    total, per = 0.0, []
    for j in range(n):
        npay = _step_index(cfg, pays[j])
        _, wp = (np.asarray(a, np.float64)
                 for a in _shock_shapes(cfg, npay))
        var_I = sig * sig * float(wp @ wp)
        w0 = math.exp(-i_det[idx[pays[j]]] + 0.5 * var_I)
        v = 0.0
        for t in obs[j]:
            ni = _step_index(cfg, t)
            u, _ = (np.asarray(a, np.float64)
                    for a in _shock_shapes(cfg, ni))
            s_r = sig * math.sqrt(float(u @ u))
            mu = r_det[idx[t]] - sig * sig * float(u @ wp[:ni])
            r_lo, r_hi = (float(np.asarray(b, np.float64))
                          for b in _libor_r_bounds(
                              cfg, jnp.float32(sigma), market, t,
                              libor_tenor, lo, hi))
            p = _phi((r_hi - mu) / s_r) - _phi((r_lo - mu) / s_r)
            v += coupon * tau / m * w0 * p
        per.append(v)
        total += v
    return total, per
