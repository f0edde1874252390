"""Counterparty exposure profiles and CVA on a vanilla swap (beyond-
reference XVA layer).

The reference computes one European option price and its vega
(src/2_option_pricing.cu:14-35, src/3_sensitivity_analysis.cu:22-96);
the production use of exactly that machinery is counterparty credit:
expected exposure EE(t) = E[e^{-I(t)} (V_swap(t))^+] per future date, the
potential future exposure quantile PFE_q(t), and the credit valuation
adjustment CVA = (1-R) sum_j EE(t_j) dPD(t_j).  Under one-factor
Hull-White all of it rides the exact functional engine:

* the swap's value at a reset date T_j is a DETERMINISTIC function of
  r(T_j): for unit notional the floating leg has just reset to par, so
  receiver value = CB_j(r) - 1 with CB_j(r) = sum_{T_i > T_j} c_i
  A(T_j,T_i) e^{-B_i r} the remaining coupon bond (instruments
  ``_bond_value_terms``).  Exposure therefore needs only the functionals
  (r(T_0), I(T_0), ..., r(T_{m-1}), I(T_{m-1})) — sampled EXACTLY with
  2m normals per path through ``bermudan._functional_chol``, no time
  stepping;

* the fp64 oracle is CLOSED FORM per date on the same discrete trapezoid
  law the sampler draws from: tilting by e^{-I} shifts the Gaussian
  r-mean by -cov(r, I) and multiplies by w0 = E[e^{-I}], and the one
  strike root r* of CB_j(r) = 1 (CB_j is strictly decreasing) turns
  E[(CB - 1)^+] into Phi terms per cashflow — the Jamshidian
  decomposition evaluated date by date, so the whole EE profile is a
  strip of discrete-law swaption prices (instruments.jamshidian_price
  is the continuous-law pin for the first date);

* PFE_q(t) is exact by monotonicity: the q-quantile of the swap value is
  the value at the (1-q)- (receiver) or q- (payer) quantile of the
  GAUSSIAN r(t) — no simulation, no sorting; the MC validates it by
  measuring the exceedance fraction per date (must be ~ 1-q);

* the per-date control variate is the DISCOUNTED SWAP VALUE
  e^{-I_j} (CB_j - 1) whose exact discrete-law mean is a lognormal
  expectation per cashflow (computed inside the kernel as a function of
  sigma, so CRN-FD and jvp vega differentiate through it); the same CV
  aggregated with the default-probability weights collapses the CVA
  noise.

Engine invariants kept: blocks key on the GLOBAL block index
(``parallel.mesh.block_normals`` — rqmc draws digitally-shifted Sobol,
SEs across blocks), sigma enters only through ``tables.sig_st`` and the
affine drift, and the pricer takes n_blocks/mesh like every MC product.
"""

from __future__ import annotations

import math
from functools import lru_cache
from statistics import NormalDist
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from .config import HWConfig
from .models import hull_white as hw
from .models.hull_white import MarketCurve
from .instruments import CouponSchedule, _bond_value_terms, _np_AB
from .parallel import mesh as pmesh
from .range_note import _nphi

_NDTRI = NormalDist().inv_cdf


def swap_schedule(cfg: HWConfig, rate: float, tenor: float,
                  freq: float = 1.0, start: float | None = None
                  ) -> CouponSchedule:
    """Fixed leg plus notional of a swap whose first reset is ``start``
    (default cfg.s1): payments rate/freq at start + k/freq,
    k = 1..tenor*freq, notional 1 at the end."""
    if start is None:
        start = cfg.s1
    n = int(round(tenor * freq))
    times = tuple(start + (k + 1) / freq for k in range(n))
    coupons = tuple(rate / freq + (1.0 if k == n - 1 else 0.0)
                    for k in range(n))
    return CouponSchedule(times=times, coupons=coupons)


def exposure_dates(cfg: HWConfig, tenor: float, freq: float = 1.0,
                   start: float | None = None) -> tuple:
    """Reset dates T_0..T_{m-1} (T_0 = swap start): the dates where the
    floating leg is at par and the swap value is exactly CB_j(r) - 1."""
    if start is None:
        start = cfg.s1
    n = int(round(tenor * freq))
    return tuple(start + j / freq for j in range(n))


def _pd_weights(dates: tuple, hazard):
    """Default-probability increments pd_j = S(t_{j-1}) - S(t_j), t_{-1}
    = 0 (EE evaluated at the right endpoint of each bucket), and their
    parallel-shift derivatives d pd_j / d eps for h(t) -> h(t) + eps.
    ``hazard`` is a flat float or a ``credit.CreditCurve`` (the shift
    derivative -t S(t) has the same form either way)."""
    from .credit import survival

    prev = 0.0
    pd, dpd = [], []
    for t in dates:
        sp, st = survival(hazard, prev), survival(hazard, t)
        pd.append(sp - st)
        dpd.append(t * st - prev * sp)
        prev = t
    return tuple(pd), tuple(dpd)


def _haz(hazard):
    """Static cache key for a hazard argument: flat floats normalize
    through float(); ``CreditCurve``s are hashable NamedTuples and pass
    through unchanged.  (The WWR layer models a STOCHASTIC intensity
    and keeps flat-float lambda0 only.)"""
    from .credit import CreditCurve

    return hazard if isinstance(hazard, CreditCurve) else float(hazard)


@lru_cache(maxsize=None)
def _date_stats(cfg: HWConfig, dates: tuple):
    """fp64 per-date second moments of (r(t), I(t)) per unit sig_st:
    (u.u, w.w, u.w) from the shock shapes — the same dot products every
    discrete-law closed form in the repo is built from."""
    from .bermudan import _step_index
    from .ops.engine_linear import _shock_shapes

    out = []
    for t in dates:
        n = _step_index(cfg, t)
        u, w = (np.asarray(a, np.float64) for a in _shock_shapes(cfg, n))
        out.append((float(u @ u), float(w @ w), float(u @ w)))
    return tuple(out)


@lru_cache(maxsize=None)
def _det_rI(cfg: HWConfig, dates: tuple):
    """fp64 deterministic (r, I) affine pieces at ``dates``:
    r = rA + c rB, I = iA + c iB with c = 0.5 (sigma^2 - sigma0^2)."""
    from .bermudan import _det_affine, _step_index

    rA, rB, iA, iB = _det_affine(cfg)
    idx = [_step_index(cfg, t) - 1 for t in dates]
    return (tuple(float(rA[i]) for i in idx),
            tuple(float(rB[i]) for i in idx),
            tuple(float(iA[i]) for i in idx),
            tuple(float(iB[i]) for i in idx))


def _np_terms(cfg: HWConfig, market: MarketCurve, sched: CouponSchedule,
              t: float, sigma: float):
    """fp64 (lam_i, B_i) with cashflows at or before t zeroed, so the
    remaining coupon bond at ``t`` is CB(r) = sum_i lam_i e^{-B_i r}."""
    A, B, _, _ = _np_AB(cfg, market, t, np.asarray(sched.times), sigma)
    cs = np.asarray(sched.coupons, np.float64)
    alive = (np.asarray(sched.times, np.float64) > t + 1e-9)
    return alive * cs * A, B


def _cb_root(lams, Bs, strike: float) -> float:
    """Newton root r* of CB(r) = strike (CB strictly decreasing)."""
    r = 0.02
    for _ in range(80):
        v = float(np.sum(lams * np.exp(-Bs * r)))
        dv = float(-np.sum(lams * Bs * np.exp(-Bs * r)))
        step = (v - strike) / dv
        r -= step
        if abs(step) < 1e-15:
            break
    return r


def _ee_closed(lams, Bs, strike: float, mu: float, s: float,
               sg: float) -> float:
    """E[(sg (CB(r) - strike))^+] for r ~ N(mu, s^2), closed form via the
    strike root (the per-date Jamshidian decomposition)."""
    rstar = _cb_root(lams, Bs, strike)
    d = (rstar - mu) / s
    emom = lams * np.exp(-Bs * mu + 0.5 * Bs * Bs * s * s)
    if sg > 0:       # receiver pays when r < r*
        val = float(np.sum(emom * _nphi(d + Bs * s))) - strike * _nphi(d)
    else:            # payer pays when r > r*
        val = strike * _nphi(-d) - float(
            np.sum(emom * _nphi(-d - Bs * s)))
    return max(val, 0.0)


class OracleXVA(NamedTuple):
    dates: tuple
    ee: tuple            # discounted expected exposure per date
    pfe: tuple           # undiscounted PFE_q level per date
    disc_swap: tuple     # E[e^{-I_j} V_j] per date (CV exact means)
    epe: float           # average of ee over the dates
    cva: float
    hazard_delta: float  # dCVA / dhazard


def exposure_oracle(cfg: HWConfig, market: MarketCurve, *,
                    rate: float = 0.02, tenor: float = 4.0,
                    freq: float = 1.0, start: float | None = None,
                    payer: bool = False, quantile: float = 0.95,
                    hazard: float = 0.02, recovery: float = 0.4,
                    sigma: float | None = None) -> OracleXVA:
    """float64 closed-form exposure profile + CVA on the discrete
    trapezoid law (see module docstring).  EE(t_j) is exact (strike-root
    decomposition), PFE is exact (monotone quantile map), CVA is the
    pd-weighted EE sum — all pinned against the MC in tests and against
    ``instruments.jamshidian_price`` at the first date."""
    if sigma is None:
        sigma = cfg.sigma
    if start is None:
        start = cfg.s1
    sched = swap_schedule(cfg, rate, tenor, freq, start)
    dates = exposure_dates(cfg, tenor, freq, start)
    sg = -1.0 if payer else 1.0
    tables = hw.step_tables(cfg, float(sigma), cfg.sigma, jnp.float32)
    sig = float(tables.sig_st)
    c = 0.5 * (float(sigma) ** 2 - cfg.sigma ** 2)
    rA, rB, iA, iB = _det_rI(cfg, dates)
    stats = _date_stats(cfg, dates)
    zq = _NDTRI(quantile if payer else 1.0 - quantile)
    ee, pfe, dm = [], [], []
    for j, t in enumerate(dates):
        lams, Bs = _np_terms(cfg, market, sched, t, float(sigma))
        uu, ww, uw = stats[j]
        v_r, v_I, c_rI = sig * sig * uu, sig * sig * ww, sig * sig * uw
        r_det = rA[j] + c * rB[j]
        i_det = iA[j] + c * iB[j]
        s_r = math.sqrt(v_r)
        w0 = math.exp(-i_det + 0.5 * v_I)
        ee.append(w0 * _ee_closed(lams, Bs, 1.0, r_det - c_rI, s_r, sg))
        r_q = r_det + s_r * zq
        pfe.append(max(sg * (float(np.sum(lams * np.exp(-Bs * r_q))) - 1.0),
                       0.0))
        # E[e^{-I} (CB - 1)]: lognormal mean per cashflow
        emean = float(np.sum(lams * np.exp(
            -i_det - Bs * r_det + 0.5 * (v_I + Bs * Bs * v_r
                                         + 2.0 * Bs * c_rI))))
        dm.append(sg * (emean - w0))
    pd, dpd = _pd_weights(dates, hazard)
    lgd = 1.0 - recovery
    cva = lgd * sum(p * e for p, e in zip(pd, ee))
    hdelta = lgd * sum(p * e for p, e in zip(dpd, ee))
    return OracleXVA(dates=dates, ee=tuple(ee), pfe=tuple(pfe),
                     disc_swap=tuple(dm), epe=sum(ee) / len(ee),
                     cva=cva, hazard_delta=hdelta)


def ee_quadrature(cfg: HWConfig, market: MarketCurve, t: float, *,
                  rate: float = 0.02, tenor: float = 4.0,
                  freq: float = 1.0, start: float | None = None,
                  payer: bool = False, sigma: float | None = None,
                  n_quad: int = 96) -> float:
    """fp64 quadrature EE(t) — the independent cross-check of the
    strike-root closed form.  The positive part has a kink at the strike
    root, so plain Gauss-Hermite stalls at ~1e-4 (the same indicator
    failure documented for the range-accrual note, docs/MATH.md §19);
    instead the integral runs Gauss-Legendre over the PAYING side only
    ([mu - 12 s, r*] receiver, [r*, mu + 12 s] payer), where the
    integrand is analytic and the rule converges spectrally."""
    if sigma is None:
        sigma = cfg.sigma
    if start is None:
        start = cfg.s1
    sched = swap_schedule(cfg, rate, tenor, freq, start)
    sg = -1.0 if payer else 1.0
    tables = hw.step_tables(cfg, float(sigma), cfg.sigma, jnp.float32)
    sig = float(tables.sig_st)
    c = 0.5 * (float(sigma) ** 2 - cfg.sigma ** 2)
    dates = (float(t),)
    rA, rB, iA, iB = _det_rI(cfg, dates)
    (uu, ww, uw), = _date_stats(cfg, dates)
    v_r, v_I, c_rI = sig * sig * uu, sig * sig * ww, sig * sig * uw
    r_det, i_det = rA[0] + c * rB[0], iA[0] + c * iB[0]
    w0 = math.exp(-i_det + 0.5 * v_I)
    lams, Bs = _np_terms(cfg, market, sched, float(t), float(sigma))
    mu, s = r_det - c_rI, math.sqrt(v_r)
    rstar = _cb_root(lams, Bs, 1.0)
    lo, hi = (mu - 12.0 * s, rstar) if sg > 0 else (rstar, mu + 12.0 * s)
    nodes, wq = np.polynomial.legendre.leggauss(n_quad)
    r = 0.5 * (hi + lo) + 0.5 * (hi - lo) * nodes
    dens = np.exp(-0.5 * ((r - mu) / s) ** 2) / (s * math.sqrt(2 * math.pi))
    V = sg * (np.exp(-np.outer(r, Bs)) @ lams - 1.0)
    return w0 * 0.5 * (hi - lo) * float(wq @ (np.maximum(V, 0.0) * dens))


class ExposureProfile(NamedTuple):
    dates: tuple
    ee: jax.Array           # (m,) CV'd discounted EE per date
    ee_std_error: jax.Array
    ee_raw: jax.Array       # plain MC per date (no CV)
    beta: jax.Array         # per-date CV coefficients
    pfe: jax.Array          # (m,) closed-form quantile levels
    exceed: jax.Array       # measured P(V_j > pfe_j), ~ 1 - quantile
    epe: jax.Array
    n_paths: int


class CVAResult(NamedTuple):
    cva: jax.Array
    std_error: jax.Array
    raw_cva: jax.Array
    raw_std_error: jax.Array
    beta: jax.Array
    hazard_delta: jax.Array  # dCVA/dhazard off the CV'd EE profile
    profile: ExposureProfile


@lru_cache(maxsize=None)
def _xva_fn(cfg: HWConfig, rate: float, start: float, n: int, tau: float,
            payer: bool, quantile: float, hazard: float, recovery: float,
            n_paths: int, n_blocks: int, rqmc: bool, mesh):
    from .bermudan import _functional_chol, _functional_det

    sched = swap_schedule(cfg, rate, n * tau, 1.0 / tau, start)
    dates = exposure_dates(cfg, n * tau, 1.0 / tau, start)
    m = len(dates)
    sg = -1.0 if payer else 1.0
    specs = tuple([("r", t) for t in dates] + [("I", t) for t in dates])
    LT = jnp.asarray(_functional_chol(cfg, specs))
    stats = jnp.asarray(_date_stats(cfg, dates), jnp.float32)  # (m, 3)
    pd, dpd = _pd_weights(dates, hazard)
    pdw = jnp.asarray(pd, jnp.float32)
    dpdw = jnp.asarray(dpd, jnp.float32)
    lgd = 1.0 - recovery
    zq = jnp.float32(_NDTRI(quantile if payer else 1.0 - quantile))

    def compute(key, sigma, market):
        tables = hw.step_tables(cfg, sigma, cfg.sigma, jnp.float32)
        det = _functional_det(cfg, sigma, specs)
        r_det, i_det = det[:m], det[m:]
        lam, B = (jnp.stack(v) for v in zip(
            *[_bond_value_terms(cfg, sigma, market, sched, t)
              for t in dates]))                              # (m, ncf)
        sig2 = tables.sig_st * tables.sig_st
        v_r, v_I, c_rI = (sig2 * stats[:, q] for q in range(3))
        s_r = jnp.sqrt(v_r)
        w0 = jnp.exp(-i_det + 0.5 * v_I)
        # exact discrete-law CV means E[e^{-I_j} (CB_j - 1)], a function
        # of sigma so CRN-FD and jvp vega differentiate through them
        emean = jnp.sum(lam * jnp.exp(
            -i_det[:, None] - B * r_det[:, None]
            + 0.5 * (v_I[:, None] + B * B * v_r[:, None]
                     + 2.0 * B * c_rI[:, None])), axis=1)
        cv_mean = sg * (emean - w0)                          # (m,)
        # closed-form PFE levels (monotone quantile map; exceedance
        # counts below validate them against the sampled paths)
        r_q = r_det + s_r * zq
        pfe = jnp.maximum(
            sg * (jnp.sum(lam * jnp.exp(-B * r_q[:, None]), axis=1) - 1.0),
            0.0)

        def block(bi):
            x = pmesh.block_normals(key, bi, n_paths, 2 * m, rqmc)
            z = tables.sig_st * jnp.dot(
                x, LT, preferred_element_type=jnp.float32,
                precision=cfg.matmul_precision)

            def leg(sgn):
                ro = r_det[None, :] + sgn * z[:, :m]         # (paths, m)
                disc = jnp.exp(-(i_det[None, :] + sgn * z[:, m:]))
                cb = jnp.sum(lam[None, :, :]
                             * jnp.exp(-B[None, :, :] * ro[:, :, None]),
                             axis=2)
                V = sg * (cb - 1.0)
                X = disc * jnp.maximum(V, 0.0)               # EE samples
                Y = disc * V                                 # CV samples
                E = (V > pfe[None, :]).astype(jnp.float32)
                return X, Y, E

            Xp, Yp, Ep = leg(1.0)
            Xm, Ym, Em = leg(-1.0)
            X, Y = 0.5 * (Xp + Xm), 0.5 * (Yp + Ym)
            E = 0.5 * (Ep + Em)
            Xc = jnp.dot(X, pdw)                             # (paths,)
            Yc = jnp.dot(Y, pdw)
            per_date = jnp.concatenate([
                jnp.sum(X, axis=0), jnp.sum(X * X, axis=0),
                jnp.sum(Y, axis=0), jnp.sum(Y * Y, axis=0),
                jnp.sum(X * Y, axis=0), jnp.sum(E, axis=0)])
            agg = jnp.stack([jnp.sum(Xc), jnp.sum(Xc * Xc), jnp.sum(Yc),
                             jnp.sum(Yc * Yc), jnp.sum(Xc * Yc)])
            return jnp.concatenate([per_date, agg])

        per_block = pmesh.map_blocks(block, n_blocks, mesh)
        return _profile_reduce(per_block, m, n_paths, n_blocks, rqmc,
                               cv_mean, pdw, dpdw, lgd) + (pfe,)

    return jax.jit(compute)


def _profile_reduce(per_block, m: int, n_paths: int, n_blocks: int,
                    rqmc: bool, cv_mean, pdw, dpdw, lgd: float,
                    extra_means=()):
    """Shared EE-profile / CVA reduction: per-date and pd-aggregated
    beta* control variates from the stacked block moments
    [sum X, sum X^2, sum Y, sum Y^2, sum XY, exceed] x m + the 5
    aggregate moments; rqmc reports SEs across the digital shifts.
    ``extra_means`` adds one generic CV'd aggregate channel per entry
    (exact CV mean): the block rows carry 5 more moments
    [sum Z, sum Z^2, sum W, sum W^2, sum ZW] per channel after the CVA
    aggregate, and the return gains one (est, se, raw, raw_se, beta)
    tuple per channel — the bilateral BCVA / FVA headline quotes."""
    s = jnp.sum(per_block, axis=0)
    n_tot = 1.0 * n_paths * n_blocks
    D = [s[q * m:(q + 1) * m] / n_tot for q in range(6)]
    mx, my = D[0], D[2]
    var_x = jnp.maximum(D[1] - mx * mx, 0.0)
    var_y = jnp.maximum(D[3] - my * my, 1e-30)
    cov = D[4] - mx * my
    beta = cov / var_y
    ee = mx - beta * (my - cv_mean)
    A = s[6 * m:] / n_tot
    mxc, myc = A[0], A[2]
    var_xc = jnp.maximum(A[1] - mxc * mxc, 0.0)
    var_yc = jnp.maximum(A[3] - myc * myc, 1e-30)
    cov_c = A[4] - mxc * myc
    beta_c = cov_c / var_yc
    cv_mean_c = jnp.dot(pdw, cv_mean)
    cva = lgd * (mxc - beta_c * (myc - cv_mean_c))
    raw_cva = lgd * mxc
    if rqmc:
        # the digital shifts are the independent replicates: SEs come
        # from the across-block spread of the CV'd estimates
        pb = per_block / n_paths
        ee_b = pb[:, :m] - beta[None, :] * pb[:, 2 * m:3 * m]
        ee_se = jnp.std(ee_b, axis=0, ddof=1) / jnp.sqrt(1.0 * n_blocks)
        cva_b = lgd * (pb[:, 6 * m] - beta_c * pb[:, 6 * m + 2])
        cva_se = jnp.std(cva_b, ddof=1) / jnp.sqrt(1.0 * n_blocks)
        raw_se = lgd * jnp.std(pb[:, 6 * m], ddof=1) \
            / jnp.sqrt(1.0 * n_blocks)
    else:
        bessel = n_tot / jnp.maximum(n_tot - 1.0, 1.0)
        var_cv = jnp.maximum(var_x - cov * cov / var_y, 0.0)
        ee_se = jnp.sqrt(bessel * var_cv / n_tot)
        var_cva = jnp.maximum(var_xc - cov_c * cov_c / var_yc, 0.0)
        cva_se = lgd * jnp.sqrt(bessel * var_cva / n_tot)
        raw_se = lgd * jnp.sqrt(bessel * var_xc / n_tot)
    hdelta = lgd * jnp.dot(dpdw, ee)
    base = (ee, ee_se, mx, beta, D[5], jnp.mean(ee),
            cva, cva_se, raw_cva, raw_se, beta_c, hdelta)
    extras = []
    for q, zmean in enumerate(extra_means):
        off = 6 * m + 5 + 5 * q
        Zs, Z2, Ws, W2, ZW = (s[off + i] / n_tot for i in range(5))
        var_w = jnp.maximum(W2 - Ws * Ws, 1e-30)
        cov_zw = ZW - Zs * Ws
        bq = cov_zw / var_w
        est = Zs - bq * (Ws - zmean)
        if rqmc:
            pb = per_block / n_paths
            zb = pb[:, off] - bq * pb[:, off + 2]
            se = jnp.std(zb, ddof=1) / jnp.sqrt(1.0 * n_blocks)
            raw_se_q = jnp.std(pb[:, off], ddof=1) \
                / jnp.sqrt(1.0 * n_blocks)
        else:
            bessel = n_tot / jnp.maximum(n_tot - 1.0, 1.0)
            var_z = jnp.maximum(Z2 - Zs * Zs, 0.0)
            var_cv = jnp.maximum(var_z - cov_zw * cov_zw / var_w, 0.0)
            se = jnp.sqrt(bessel * var_cv / n_tot)
            raw_se_q = jnp.sqrt(bessel * var_z / n_tot)
        extras.append((est, se, Zs, raw_se_q, bq))
    return base + tuple(extras)


def price_exposure(cfg: HWConfig, key, market: MarketCurve, *,
                   rate: float = 0.02, tenor: float = 4.0,
                   freq: float = 1.0, start: float | None = None,
                   payer: bool = False, quantile: float = 0.95,
                   hazard: float = 0.02, recovery: float = 0.4,
                   sigma=None, n_paths: int | None = None,
                   n_blocks: int = 1, rqmc: bool = False,
                   mesh=None) -> CVAResult:
    """Monte Carlo exposure profile + CVA on exactly-sampled multi-date
    (r, I) functionals, with the discounted swap value as per-date (and
    pd-weighted) control variate at its exact discrete-law mean.  fp64
    oracle: ``exposure_oracle``.  rqmc=True needs n_blocks >= 2 (SEs
    across digital shifts); blocks key on their global index, optionally
    sharded over ``mesh``."""
    if rqmc and n_blocks < 2:
        raise ValueError("rqmc needs n_blocks >= 2 (the digital shifts "
                         "are the independent replicates)")
    if sigma is None:
        sigma = cfg.sigma
    if n_paths is None:
        n_paths = cfg.n_paths
    if start is None:
        start = cfg.s1
    n = int(round(tenor * freq))
    out = _xva_fn(cfg, float(rate), float(start), n, 1.0 / freq,
                  bool(payer), float(quantile), _haz(hazard),
                  float(recovery), int(n_paths), int(n_blocks),
                  bool(rqmc), mesh)(
        key, jnp.asarray(sigma, jnp.float32), market)
    prof = ExposureProfile(
        dates=exposure_dates(cfg, tenor, freq, start), ee=out[0],
        ee_std_error=out[1], ee_raw=out[2], beta=out[3], pfe=out[12],
        exceed=out[4], epe=out[5], n_paths=int(n_paths) * int(n_blocks))
    return CVAResult(cva=out[6], std_error=out[7], raw_cva=out[8],
                     raw_std_error=out[9], beta=out[10],
                     hazard_delta=out[11], profile=prof)


class CVAVega(NamedTuple):
    vega: jax.Array          # jvp tangent of the CV'd CVA
    fd_vega: jax.Array       # CRN central difference (same kernel)
    oracle_vega: float       # fp64 closed-form central difference
    epsilon: float


def vega_cva(cfg: HWConfig, key, market: MarketCurve, *,
             rate: float = 0.02, tenor: float = 4.0, freq: float = 1.0,
             start: float | None = None, payer: bool = False,
             quantile: float = 0.95, hazard: float = 0.02,
             recovery: float = 0.4, eps: float = 1e-3,
             n_paths: int | None = None, n_blocks: int = 1,
             rqmc: bool = False, mesh=None) -> CVAVega:
    """dCVA/dsigma three ways on one kernel: forward-mode jvp (the
    positive part is a.s. differentiable and the CV mean is computed
    inside the trace), CRN central difference, and the fp64 closed-form
    oracle's central difference.  The jvp flows through the SAME
    sigma-multiplier parameterization every engine uses (dz/dsigma =
    z/sigma), reference vega protocol src/3_sensitivity_analysis.cu."""
    if rqmc and n_blocks < 2:
        raise ValueError("rqmc needs n_blocks >= 2 (the digital shifts "
                         "are the independent replicates)")
    if n_paths is None:
        n_paths = cfg.n_paths
    if start is None:
        start = cfg.s1
    n = int(round(tenor * freq))
    fn = _xva_fn(cfg, float(rate), float(start), n, 1.0 / freq,
                 bool(payer), float(quantile), _haz(hazard),
                 float(recovery), int(n_paths), int(n_blocks),
                 bool(rqmc), mesh)

    def cva_of(s):
        return fn(key, s, market)[6]

    sig0 = jnp.asarray(cfg.sigma, jnp.float32)
    _, tangent = jax.jvp(cva_of, (sig0,), (jnp.ones_like(sig0),))
    up = cva_of(jnp.asarray(cfg.sigma + eps, jnp.float32))
    dn = cva_of(jnp.asarray(cfg.sigma - eps, jnp.float32))
    kw = dict(rate=rate, tenor=tenor, freq=freq, start=start, payer=payer,
              quantile=quantile, hazard=hazard, recovery=recovery)
    o_up = exposure_oracle(cfg, market, sigma=cfg.sigma + eps, **kw).cva
    o_dn = exposure_oracle(cfg, market, sigma=cfg.sigma - eps, **kw).cva
    return CVAVega(vega=tangent, fd_vega=(up - dn) / (2.0 * eps),
                   oracle_vega=(o_up - o_dn) / (2.0 * eps), epsilon=eps)


# ---------------------------------------------------------------------------
# G2++ twin: the same exposure metrics on the two-factor model.  The swap
# value at a reset date is CB_j(x, y) = sum_i lam_{j,i} e^{-Ba_i x - Bb_i y}
# - a function of BOTH factors, so the EE oracle generalizes
# swaption_g2_analytic date by date (outer x-quadrature, inner closed-form
# y-decomposition at the conditional root), the PFE quantile comes from
# bisecting the exact conditional-CDF mixture, and the CV mean is the
# martingale identity E[D_j P(T_j, T_i)] = P(0, T_i).
# ---------------------------------------------------------------------------


def _g2_date_terms(cfg: HWConfig, g, market: MarketCurve,
                   sched: CouponSchedule, t: float):
    """fp64 (lam0_i, Ba_i, Bb_i) with P(t, T_i) = lam0_i e^{-Ba x - Bb y}
    reconstructed from the market curve with the G2++ variance
    adjustment at expiry ``t`` (models.g2pp._bond_terms_g2 generalized
    off the fixed cfg.s1 expiry), cashflows at or before t zeroed."""
    from .models.g2pp import _B, _v_integral

    Ts_grid = np.linspace(0.0, cfg.t_final, cfg.n_mat)
    P = np.asarray(market.P, np.float64)
    Pt = float(np.interp(t, Ts_grid, P))
    lam, Ba, Bb = [], [], []
    for T_i, c_i in zip(sched.times, sched.coupons):
        if T_i <= t + 1e-9:
            lam.append(0.0)
            Ba.append(0.0)
            Bb.append(0.0)
            continue
        tau = T_i - t
        vadj = 0.5 * (_v_integral(g, tau) - _v_integral(g, T_i)
                      + _v_integral(g, t))
        lam.append(c_i * float(np.interp(T_i, Ts_grid, P)) / Pt
                   * math.exp(vadj))
        Ba.append(_B(g.a, tau))
        Bb.append(_B(g.b, tau))
    return np.asarray(lam), np.asarray(Ba), np.asarray(Bb), Pt


def _g2_y_root(lam, Ba, Bb, xs, strike: float):
    """Newton root ybar(x) of V(x, ybar) = strike per x node (V strictly
    decreasing in y)."""
    lx = lam[None, :] * np.exp(-Ba[None, :] * xs[:, None])
    yb = np.zeros_like(xs)
    for _ in range(80):
        E = np.exp(-Bb[None, :] * yb[:, None])
        V = np.sum(lx * E, axis=1)
        dV = -np.sum(lx * Bb[None, :] * E, axis=1)
        step = (V - strike) / dV
        yb = yb - step
        if np.max(np.abs(step)) < 1e-14:
            break
    return yb, lx


def _ee_g2_closed(lam, Ba, Bb, strike: float, mx: float, my: float,
                  sx: float, sy: float, rxy: float, sg: float,
                  n_quad: int = 2001, width: float = 8.0) -> float:
    """E[(sg (V(x, y) - strike))^+], (x, y) bivariate normal: outer
    trapezoid in x, inner closed form in y at the conditional root
    (the swaption_g2_analytic decomposition, per exposure date)."""
    xs = mx + sx * np.linspace(-width, width, n_quad)
    wpdf = np.exp(-0.5 * ((xs - mx) / sx) ** 2) \
        / (sx * math.sqrt(2 * math.pi))
    m_c = my + rxy * sy / sx * (xs - mx)
    s_c = sy * math.sqrt(max(1.0 - rxy * rxy, 1e-16))
    yb, lx = _g2_y_root(lam, Ba, Bb, xs, strike)
    d = (m_c - yb) / s_c
    e_full = np.sum(lx * np.exp(-Bb[None, :] * m_c[:, None]
                                + 0.5 * (Bb[None, :] * s_c) ** 2), axis=1)
    e_low = np.sum(lx * np.exp(-Bb[None, :] * m_c[:, None]
                               + 0.5 * (Bb[None, :] * s_c) ** 2)
                   * _nphi(d[:, None] - Bb[None, :] * s_c), axis=1)
    payer_inner = strike * _nphi(d) - e_low    # E[(K - V) 1{y > ybar}]
    inner = payer_inner if sg < 0 else payer_inner + e_full - strike
    return float(np.trapezoid(wpdf * np.maximum(inner, 0.0), xs))


def _pfe_g2(lam, Ba, Bb, sx: float, sy: float, rxy: float, sg: float,
            quantile: float, n_quad: int = 801,
            width: float = 8.0) -> float:
    """q-quantile of (sg (V(x, y) - 1))^+ under the RISK-NEUTRAL law
    ((x, y) centered; the covariance is measure-independent): bisect the
    level v in the exact conditional-CDF mixture
    P(V <= K) = E_x[P(y >= ybar(x, K) | x)] (V decreasing in y)."""
    xs = sx * np.linspace(-width, width, n_quad)
    wpdf = np.exp(-0.5 * (xs / sx) ** 2) / (sx * math.sqrt(2 * math.pi))
    wpdf = wpdf / np.trapezoid(wpdf, xs)       # renormalize the tails
    m_c = rxy * sy / sx * xs
    s_c = sy * math.sqrt(max(1.0 - rxy * rxy, 1e-16))

    def cdf(v):
        # P(sg (V - 1) <= v)
        K = 1.0 + sg * v
        yb, _ = _g2_y_root(lam, Ba, Bb, xs, K)
        p_le = np.trapezoid(wpdf * _nphi(-(yb - m_c) / s_c), xs)
        return p_le if sg > 0 else 1.0 - p_le

    lo, hi = -0.5, 0.5
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if cdf(mid) < quantile:
            lo = mid
        else:
            hi = mid
        if hi - lo < 1e-12:
            break
    return max(0.5 * (lo + hi), 0.0)


def exposure_oracle_g2(cfg: HWConfig, g, market: MarketCurve, *,
                       rate: float = 0.02, tenor: float = 4.0,
                       freq: float = 1.0, start: float | None = None,
                       payer: bool = False, quantile: float = 0.95,
                       hazard: float = 0.02,
                       recovery: float = 0.4) -> OracleXVA:
    """fp64 G2++ exposure profile + CVA: EE(t_j) = P(0,t_j) x the
    t_j-forward-measure positive part (outer-quadrature / closed-inner,
    exact to the 2001-node trapezoid like swaption_g2_analytic, which
    pins the first date); PFE by conditional-CDF bisection; the
    discounted-swap means are the exact martingale identities
    sg (sum_i c_i P(0,T_i) - P(0,t_j))."""
    from .models.g2pp import _fwd_means, _xy_cov

    if start is None:
        start = cfg.s1
    sched = swap_schedule(cfg, rate, tenor, freq, start)
    dates = exposure_dates(cfg, tenor, freq, start)
    sg = -1.0 if payer else 1.0
    Ts_grid = np.linspace(0.0, cfg.t_final, cfg.n_mat)
    P = np.asarray(market.P, np.float64)
    ee, pfe, dm = [], [], []
    for t in dates:
        lam, Ba, Bb, Pt = _g2_date_terms(cfg, g, market, sched, t)
        mx, my = _fwd_means(g, t)
        sx, sy, rxy = _xy_cov(g, t)
        ee.append(Pt * _ee_g2_closed(lam, Ba, Bb, 1.0, mx, my, sx, sy,
                                     rxy, sg))
        pfe.append(_pfe_g2(lam, Ba, Bb, sx, sy, rxy, sg, quantile))
        alive = np.asarray(sched.times, np.float64) > t + 1e-9
        cs = np.asarray(sched.coupons, np.float64)
        P0i = np.interp(np.asarray(sched.times), Ts_grid, P)
        dm.append(sg * (float(np.sum(alive * cs * P0i)) - Pt))
    pd, dpd = _pd_weights(dates, hazard)
    lgd = 1.0 - recovery
    cva = lgd * sum(p * e for p, e in zip(pd, ee))
    hdelta = lgd * sum(p * e for p, e in zip(dpd, ee))
    return OracleXVA(dates=dates, ee=tuple(ee), pfe=tuple(pfe),
                     disc_swap=tuple(dm), epe=sum(ee) / len(ee),
                     cva=cva, hazard_delta=hdelta)


@lru_cache(maxsize=None)
def _xva_g2_fn(cfg: HWConfig, g, rate: float, start: float, n: int,
               tau: float, payer: bool, hazard: float, recovery: float,
               n_paths: int, n_blocks: int, rqmc: bool, mesh):
    from .models.g2pp import _B, _g2_functional_chol, _v_integral

    sched = swap_schedule(cfg, rate, n * tau, 1.0 / tau, start)
    dates = exposure_dates(cfg, n * tau, 1.0 / tau, start)
    m = len(dates)
    sg = -1.0 if payer else 1.0
    # sample exactly the payoff's functionals: x, y at each reset (unit
    # projections of the strip machinery) and I at each reset
    specs = tuple([s for t in dates
                   for s in (("u", t, 1.0, 0.0), ("u", t, 0.0, 1.0))]
                  + [("I", t) for t in dates])
    LT = jnp.asarray(_g2_functional_chol(g, specs))
    d0 = jnp.asarray([-0.5 * _v_integral(g, t) for t in dates],
                     jnp.float32)
    # per-date bond terms: static exponents, curve-traced lam built in
    # compute (cashflows at or before each date are zeroed)
    BaM = np.zeros((m, len(sched.times)))
    BbM = np.zeros((m, len(sched.times)))
    vadjM = np.zeros((m, len(sched.times)))
    aliveM = np.zeros((m, len(sched.times)))
    for j, t in enumerate(dates):
        for i, T_i in enumerate(sched.times):
            if T_i <= t + 1e-9:
                continue
            aliveM[j, i] = 1.0
            BaM[j, i] = _B(g.a, T_i - t)
            BbM[j, i] = _B(g.b, T_i - t)
            vadjM[j, i] = 0.5 * (_v_integral(g, T_i - t)
                                 - _v_integral(g, T_i) + _v_integral(g, t))
    BaM, BbM = jnp.asarray(BaM, jnp.float32), jnp.asarray(BbM, jnp.float32)
    fac = jnp.asarray(aliveM * np.exp(vadjM)
                      * np.asarray(sched.coupons)[None, :], jnp.float32)
    aliveM = jnp.asarray(aliveM, jnp.float32)
    pd, dpd = _pd_weights(dates, hazard)
    pdw = jnp.asarray(pd, jnp.float32)
    dpdw = jnp.asarray(dpd, jnp.float32)
    lgd = 1.0 - recovery

    def compute(key, market, pfe):
        Pt = hw.interp_curve(market.P, jnp.asarray(dates, jnp.float32),
                             cfg)                               # (m,)
        P0i = hw.interp_curve(market.P,
                              jnp.asarray(sched.times, jnp.float32), cfg)
        lam = fac * (P0i[None, :] / Pt[:, None])                # (m, ncf)
        disc0 = Pt * jnp.exp(d0)
        # exact martingale CV means E[D_j V_j] = sg (sum c_i P0i - P0t)
        cv_mean = sg * (jnp.sum(aliveM * jnp.asarray(
            sched.coupons, jnp.float32)[None, :] * P0i[None, :], axis=1)
            - Pt)

        def block(bi):
            xn = pmesh.block_normals(key, bi, n_paths, 3 * m, rqmc)
            z = jnp.dot(xn, LT, preferred_element_type=jnp.float32,
                        precision=cfg.matmul_precision)

            def leg(sgn):
                x = sgn * z[:, 0:2 * m:2]                   # (paths, m)
                y = sgn * z[:, 1:2 * m:2]
                I = sgn * z[:, 2 * m:]
                cb = jnp.sum(lam[None, :, :]
                             * jnp.exp(-BaM[None, :, :] * x[:, :, None]
                                       - BbM[None, :, :] * y[:, :, None]),
                             axis=2)
                V = sg * (cb - 1.0)
                D = disc0[None, :] * jnp.exp(-I)
                X = D * jnp.maximum(V, 0.0)
                Y = D * V
                E = (V > pfe[None, :]).astype(jnp.float32)
                return X, Y, E

            Xp, Yp, Ep = leg(1.0)
            Xm, Ym, Em = leg(-1.0)
            X, Y = 0.5 * (Xp + Xm), 0.5 * (Yp + Ym)
            E = 0.5 * (Ep + Em)
            Xc = jnp.dot(X, pdw)
            Yc = jnp.dot(Y, pdw)
            per_date = jnp.concatenate([
                jnp.sum(X, axis=0), jnp.sum(X * X, axis=0),
                jnp.sum(Y, axis=0), jnp.sum(Y * Y, axis=0),
                jnp.sum(X * Y, axis=0), jnp.sum(E, axis=0)])
            agg = jnp.stack([jnp.sum(Xc), jnp.sum(Xc * Xc), jnp.sum(Yc),
                             jnp.sum(Yc * Yc), jnp.sum(Xc * Yc)])
            return jnp.concatenate([per_date, agg])

        per_block = pmesh.map_blocks(block, n_blocks, mesh)
        return _profile_reduce(per_block, m, n_paths, n_blocks, rqmc,
                               cv_mean, pdw, dpdw, lgd)

    return jax.jit(compute)


def price_exposure_g2(cfg: HWConfig, g, key, market: MarketCurve, *,
                      rate: float = 0.02, tenor: float = 4.0,
                      freq: float = 1.0, start: float | None = None,
                      payer: bool = False, quantile: float = 0.95,
                      hazard: float = 0.02, recovery: float = 0.4,
                      n_paths: int | None = None, n_blocks: int = 1,
                      rqmc: bool = False, mesh=None) -> CVAResult:
    """G2++ twin of ``price_exposure``: 3m exactly-sampled functionals
    (x, y, I per reset date), discounted-swap CV at its exact martingale
    mean, PFE levels from the fp64 conditional-CDF bisection (validated
    by the measured exceedance fractions).  fp64 oracle:
    ``exposure_oracle_g2``."""
    if rqmc and n_blocks < 2:
        raise ValueError("rqmc needs n_blocks >= 2 (the digital shifts "
                         "are the independent replicates)")
    if n_paths is None:
        n_paths = cfg.n_paths
    if start is None:
        start = cfg.s1
    n = int(round(tenor * freq))
    o = exposure_oracle_g2(cfg, g, market, rate=rate, tenor=tenor,
                           freq=freq, start=start, payer=payer,
                           quantile=quantile, hazard=hazard,
                           recovery=recovery)
    pfe = jnp.asarray(o.pfe, jnp.float32)
    out = _xva_g2_fn(cfg, g, float(rate), float(start), n, 1.0 / freq,
                     bool(payer), _haz(hazard), float(recovery),
                     int(n_paths), int(n_blocks), bool(rqmc), mesh)(
        key, market, pfe)
    prof = ExposureProfile(
        dates=exposure_dates(cfg, tenor, freq, start), ee=out[0],
        ee_std_error=out[1], ee_raw=out[2], beta=out[3], pfe=pfe,
        exceed=out[4], epe=out[5], n_paths=int(n_paths) * int(n_blocks))
    return CVAResult(cva=out[6], std_error=out[7], raw_cva=out[8],
                     raw_std_error=out[9], beta=out[10],
                     hazard_delta=out[11], profile=prof)


def vega_cva_g2(cfg: HWConfig, g, key, market: MarketCurve, *,
                eps: float = 1e-3, **kw) -> CVAVega:
    """dCVA/dsigma_x on the G2++ twin by CRN central difference (the
    G2Params are static in the kernel, so FD with a shared key is the
    repo's G2 vega protocol, cf. models.g2pp.vega_zbc_g2) vs the fp64
    oracle's central difference."""
    from dataclasses import replace

    up_g = replace(g, sigma=g.sigma + eps)
    dn_g = replace(g, sigma=g.sigma - eps)
    up = price_exposure_g2(cfg, up_g, key, market, **kw).cva
    dn = price_exposure_g2(cfg, dn_g, key, market, **kw).cva
    okw = {k: v for k, v in kw.items()
           if k in ("rate", "tenor", "freq", "start", "payer", "quantile",
                    "hazard", "recovery")}
    o_up = exposure_oracle_g2(cfg, up_g, market, **okw).cva
    o_dn = exposure_oracle_g2(cfg, dn_g, market, **okw).cva
    fd = (up - dn) / (2.0 * eps)
    return CVAVega(vega=fd, fd_vega=fd,
                   oracle_vega=(o_up - o_dn) / (2.0 * eps), epsilon=eps)


# ---------------------------------------------------------------------------
# Netting sets: a portfolio of swaps (mixed payer/receiver, different
# rates/tenors, shared reset grid) nets to ONE exposure per date:
# V_j(r) = sum_i lam_{j,i} e^{-B_i r} - K_j with SIGNED lam (payer legs
# enter negatively) and K_j the net par-float count.  V_j is no longer
# monotone in r, so the oracle decomposes the positive set into segments
# between the (bisected) roots of V_j and applies the lognormal partial
# means per segment; PFE bisects the exact piecewise CDF the same way.
# ---------------------------------------------------------------------------


class SwapLeg(NamedTuple):
    rate: float
    tenor: float
    payer: bool = False


def _portfolio_terms(cfg: HWConfig, market: MarketCurve, legs: tuple,
                     t: float, sigma: float, freq: float, start: float):
    """fp64 signed (lam_i, B_i, K) of the netted portfolio value at
    reset date t: V(r) = sum lam_i e^{-B_i r} - K."""
    lams, Bs, K = [], [], 0.0
    for leg in legs:
        sg = -1.0 if leg.payer else 1.0
        if t >= start + leg.tenor - 1e-9:
            continue                       # this swap has matured
        sched = swap_schedule(cfg, leg.rate, leg.tenor, freq, start)
        la, B = _np_terms(cfg, market, sched, t, sigma)
        lams.append(sg * la)
        Bs.append(B)
        K += sg
    return np.concatenate(lams), np.concatenate(Bs), K


def _v_segments(lams, Bs, K: float, mu: float, s: float,
                width: float = 10.0, n_scan: int = 4001):
    """Positive segments of V(r) = sum lam_i e^{-B_i r} - K on
    [mu - width s, mu + width s]: scan for sign changes, bisect each
    root to ~1e-14, return ((a, b), ...) with V > 0 on each."""
    def V(r):
        return np.exp(-np.outer(np.atleast_1d(r), Bs)) @ lams - K

    rs = mu + s * np.linspace(-width, width, n_scan)
    vs = V(rs)
    roots = []
    for i in range(n_scan - 1):
        if vs[i] == 0.0 or vs[i] * vs[i + 1] < 0.0:
            lo, hi = rs[i], rs[i + 1]
            flo = vs[i]
            for _ in range(100):
                mid = 0.5 * (lo + hi)
                fm = float(V(mid)[0])
                if flo * fm <= 0.0:
                    hi = mid
                else:
                    lo, flo = mid, fm
                if hi - lo < 1e-15 * max(1.0, abs(mid)):
                    break
            roots.append(0.5 * (lo + hi))
    edges = [rs[0]] + roots + [rs[-1]]
    segs = []
    for a, b in zip(edges[:-1], edges[1:]):
        if float(V(0.5 * (a + b))[0]) > 0.0:
            segs.append((a, b))
    return tuple(segs)


def _ee_segments(lams, Bs, K: float, mu: float, s: float, segs) -> float:
    """E[V(r)^+], r ~ N(mu, s^2): closed-form lognormal partial means
    over each positive segment (the multi-root generalization of
    _ee_closed)."""
    total = 0.0
    emom = lams * np.exp(-Bs * mu + 0.5 * Bs * Bs * s * s)
    for a, b in segs:
        za, zb = (a - mu) / s, (b - mu) / s
        total += float(np.sum(emom * (_nphi(zb + Bs * s)
                                      - _nphi(za + Bs * s))))
        total -= K * float(_nphi(zb) - _nphi(za))
    return max(total, 0.0)


def netting_oracle(cfg: HWConfig, market: MarketCurve, legs, *,
                   freq: float = 1.0, start: float | None = None,
                   quantile: float = 0.95, hazard: float = 0.02,
                   recovery: float = 0.4,
                   sigma: float | None = None) -> OracleXVA:
    """fp64 netted exposure profile + CVA of a swap portfolio
    (``legs`` = iterable of SwapLeg).  EE per date is exact via the
    segment decomposition; PFE bisects the piecewise-monotone CDF
    P(V <= v) = sum of Gaussian masses of {V <= v} intervals.  A
    one-leg portfolio reproduces ``exposure_oracle`` exactly (tested)."""
    if sigma is None:
        sigma = cfg.sigma
    if start is None:
        start = cfg.s1
    legs = tuple(SwapLeg(*l) for l in legs)
    tenor_max = max(l.tenor for l in legs)
    dates = exposure_dates(cfg, tenor_max, freq, start)
    tables = hw.step_tables(cfg, float(sigma), cfg.sigma, jnp.float32)
    sig = float(tables.sig_st)
    c = 0.5 * (float(sigma) ** 2 - cfg.sigma ** 2)
    rA, rB, iA, iB = _det_rI(cfg, dates)
    stats = _date_stats(cfg, dates)
    ee, pfe, dm = [], [], []
    for j, t in enumerate(dates):
        lams, Bs, K = _portfolio_terms(cfg, market, legs, t, float(sigma),
                                       freq, start)
        uu, ww, uw = stats[j]
        v_r, v_I, c_rI = sig * sig * uu, sig * sig * ww, sig * sig * uw
        r_det = rA[j] + c * rB[j]
        i_det = iA[j] + c * iB[j]
        s_r = math.sqrt(v_r)
        w0 = math.exp(-i_det + 0.5 * v_I)
        mu_t = r_det - c_rI
        segs = _v_segments(lams, Bs, K, mu_t, s_r)
        ee.append(w0 * _ee_segments(lams, Bs, K, mu_t, s_r, segs))
        # PFE: bisect the exact piecewise CDF of V under the
        # (undiscounted) risk-neutral law r ~ N(r_det, v_r)
        def cdf(v):
            pos = _v_segments(lams - 0.0, Bs, K + v, r_det, s_r)
            mass = sum(_nphi((b - r_det) / s_r) - _nphi((a - r_det) / s_r)
                       for a, b in pos)
            return 1.0 - mass            # P(V <= v)
        pfe.append(_pfe_root(cdf, quantile))
        emean = float(np.sum(lams * np.exp(
            -i_det - Bs * r_det + 0.5 * (v_I + Bs * Bs * v_r
                                         + 2.0 * Bs * c_rI))))
        dm.append(emean - K * w0)
    pd, dpd = _pd_weights(dates, hazard)
    lgd = 1.0 - recovery
    cva = lgd * sum(p * e for p, e in zip(pd, ee))
    hdelta = lgd * sum(p * e for p, e in zip(dpd, ee))
    return OracleXVA(dates=dates, ee=tuple(ee), pfe=tuple(pfe),
                     disc_swap=tuple(dm), epe=sum(ee) / len(ee),
                     cva=cva, hazard_delta=hdelta)


@lru_cache(maxsize=None)
def _netting_fn(cfg: HWConfig, legs: tuple, freq: float, start: float,
                hazard: float, recovery: float, n_paths: int,
                n_blocks: int, rqmc: bool, mesh, bil=None,
                agg_weights: tuple | None = None):
    """``agg_weights`` (static m-tuple) overrides the default-probability
    aggregate weights — the KVA layer reuses this kernel with its
    capital weights (the headline slot then returns lgd x sum w_j EE_j
    with the same optimal-beta CV).

    ``bil`` (optional, static): two extra headline aggregate channels
    Z = X wx + Y wy with CV W = Y wv, as ((wx, wy, wv), (wx, wy, wv)) of
    m-tuples — the bilateral BCVA and asymmetric-FVA samples (X_j is the
    discounted positive part at date j, Y_j the discounted value, so
    the discounted NEGATIVE part is X_j - Y_j pathwise)."""
    from .bermudan import _functional_chol, _functional_det

    tenor_max = max(l.tenor for l in legs)
    dates = exposure_dates(cfg, tenor_max, freq, start)
    m = len(dates)
    specs = tuple([("r", t) for t in dates] + [("I", t) for t in dates])
    LT = jnp.asarray(_functional_chol(cfg, specs))
    stats = jnp.asarray(_date_stats(cfg, dates), jnp.float32)
    pd, dpd = _pd_weights(dates, hazard)
    if agg_weights is not None:
        pd, dpd = agg_weights, tuple(0.0 for _ in dates)
    pdw = jnp.asarray(pd, jnp.float32)
    dpdw = jnp.asarray(dpd, jnp.float32)
    lgd = 1.0 - recovery
    # static netting layout: signs, per-leg schedules, par-float counts
    scheds = [swap_schedule(cfg, l.rate, l.tenor, freq, start)
              for l in legs]
    sgs = [(-1.0 if l.payer else 1.0) for l in legs]
    Kv = np.zeros(m)
    for j, t in enumerate(dates):
        Kv[j] = sum(sg for l, sg in zip(legs, sgs)
                    if t < start + l.tenor - 1e-9)
    Kv = jnp.asarray(Kv, jnp.float32)
    bilw = None if bil is None else [
        tuple(jnp.asarray(w, jnp.float32) for w in ch) for ch in bil]

    def compute(key, sigma, market, pfe):
        tables = hw.step_tables(cfg, sigma, cfg.sigma, jnp.float32)
        det = _functional_det(cfg, sigma, specs)
        r_det, i_det = det[:m], det[m:]
        # signed per-date terms, concatenated over legs (dead legs of a
        # date contribute zeroed columns via _bond_value_terms' alive
        # mask plus the explicit maturity cutoff)
        lam_rows, B_rows = [], []
        for j, t in enumerate(dates):
            ls, bs = [], []
            for leg, sched, sg in zip(legs, scheds, sgs):
                la, B = _bond_value_terms(cfg, sigma, market, sched, t)
                alive = 1.0 if t < start + leg.tenor - 1e-9 else 0.0
                ls.append(sg * alive * la)
                bs.append(B)
            lam_rows.append(jnp.concatenate(ls))
            B_rows.append(jnp.concatenate(bs))
        lam = jnp.stack(lam_rows)                        # (m, ncf_tot)
        B = jnp.stack(B_rows)
        sig2 = tables.sig_st * tables.sig_st
        v_r, v_I, c_rI = (sig2 * stats[:, q] for q in range(3))
        w0 = jnp.exp(-i_det + 0.5 * v_I)
        emean = jnp.sum(lam * jnp.exp(
            -i_det[:, None] - B * r_det[:, None]
            + 0.5 * (v_I[:, None] + B * B * v_r[:, None]
                     + 2.0 * B * c_rI[:, None])), axis=1)
        cv_mean = emean - Kv * w0

        def block(bi):
            x = pmesh.block_normals(key, bi, n_paths, 2 * m, rqmc)
            z = tables.sig_st * jnp.dot(
                x, LT, preferred_element_type=jnp.float32,
                precision=cfg.matmul_precision)

            def leg(sgn):
                ro = r_det[None, :] + sgn * z[:, :m]
                disc = jnp.exp(-(i_det[None, :] + sgn * z[:, m:]))
                V = jnp.sum(lam[None, :, :]
                            * jnp.exp(-B[None, :, :] * ro[:, :, None]),
                            axis=2) - Kv[None, :]
                X = disc * jnp.maximum(V, 0.0)
                Y = disc * V
                E = (V > pfe[None, :]).astype(jnp.float32)
                return X, Y, E

            Xp, Yp, Ep = leg(1.0)
            Xm, Ym, Em = leg(-1.0)
            X, Y = 0.5 * (Xp + Xm), 0.5 * (Yp + Ym)
            E = 0.5 * (Ep + Em)
            Xc = jnp.dot(X, pdw)
            Yc = jnp.dot(Y, pdw)
            per_date = jnp.concatenate([
                jnp.sum(X, axis=0), jnp.sum(X * X, axis=0),
                jnp.sum(Y, axis=0), jnp.sum(Y * Y, axis=0),
                jnp.sum(X * Y, axis=0), jnp.sum(E, axis=0)])
            agg = [jnp.sum(Xc), jnp.sum(Xc * Xc), jnp.sum(Yc),
                   jnp.sum(Yc * Yc), jnp.sum(Xc * Yc)]
            if bilw is not None:
                for wx, wy, wv in bilw:
                    Z = jnp.dot(X, wx) + jnp.dot(Y, wy)
                    W = jnp.dot(Y, wv)
                    agg += [jnp.sum(Z), jnp.sum(Z * Z), jnp.sum(W),
                            jnp.sum(W * W), jnp.sum(Z * W)]
            return jnp.concatenate([per_date, jnp.stack(agg)])

        per_block = pmesh.map_blocks(block, n_blocks, mesh)
        extra_means = () if bilw is None else tuple(
            jnp.dot(wv, cv_mean) for _, _, wv in bilw)
        return _profile_reduce(per_block, m, n_paths, n_blocks, rqmc,
                               cv_mean, pdw, dpdw, lgd,
                               extra_means=extra_means)

    return jax.jit(compute)


def price_netting(cfg: HWConfig, key, market: MarketCurve, legs, *,
                  freq: float = 1.0, start: float | None = None,
                  quantile: float = 0.95, hazard: float = 0.02,
                  recovery: float = 0.4, sigma=None,
                  n_paths: int | None = None, n_blocks: int = 1,
                  rqmc: bool = False, mesh=None) -> CVAResult:
    """Monte Carlo netted exposure + CVA of a swap portfolio on the same
    exact multi-date states; the netted discounted portfolio value is
    the CV at its exact mean.  fp64 oracle: ``netting_oracle``.  The
    netting benefit (sum of standalone CVAs minus the netted CVA) is
    non-negative by |sum| <= sum|.|; tests pin both."""
    if rqmc and n_blocks < 2:
        raise ValueError("rqmc needs n_blocks >= 2 (the digital shifts "
                         "are the independent replicates)")
    if sigma is None:
        sigma = cfg.sigma
    if n_paths is None:
        n_paths = cfg.n_paths
    if start is None:
        start = cfg.s1
    legs = tuple(SwapLeg(*l) for l in legs)
    o = netting_oracle(cfg, market, legs, freq=freq, start=start,
                       quantile=quantile, hazard=hazard,
                       recovery=recovery, sigma=float(sigma))
    pfe = jnp.asarray(o.pfe, jnp.float32)
    out = _netting_fn(cfg, legs, float(freq), float(start), _haz(hazard),
                      float(recovery), int(n_paths), int(n_blocks),
                      bool(rqmc), mesh)(
        key, jnp.asarray(sigma, jnp.float32), market, pfe)
    tenor_max = max(l.tenor for l in legs)
    prof = ExposureProfile(
        dates=exposure_dates(cfg, tenor_max, freq, start), ee=out[0],
        ee_std_error=out[1], ee_raw=out[2], beta=out[3], pfe=pfe,
        exceed=out[4], epe=out[5], n_paths=int(n_paths) * int(n_blocks))
    return CVAResult(cva=out[6], std_error=out[7], raw_cva=out[8],
                     raw_std_error=out[9], beta=out[10],
                     hazard_delta=out[11], profile=prof)


def vega_cva_netting(cfg: HWConfig, key, market: MarketCurve, legs, *,
                     freq: float = 1.0, start: float | None = None,
                     quantile: float = 0.95, hazard: float = 0.02,
                     recovery: float = 0.4, eps: float = 1e-3,
                     n_paths: int | None = None, n_blocks: int = 1,
                     rqmc: bool = False, mesh=None) -> CVAVega:
    """dCVA/dsigma of the NETTED book, three ways on the netting kernel
    (the same jvp/CRN-FD/oracle-FD protocol as ``vega_cva``; sigma flows
    through the one multiplier parameterization, and the CV mean is
    sigma-dependent inside the trace so the tangent differentiates the
    CV'd estimator, not just the raw mean)."""
    if rqmc and n_blocks < 2:
        raise ValueError("rqmc needs n_blocks >= 2 (the digital shifts "
                         "are the independent replicates)")
    if n_paths is None:
        n_paths = cfg.n_paths
    if start is None:
        start = cfg.s1
    legs = tuple(SwapLeg(*l) for l in legs)
    o = netting_oracle(cfg, market, legs, freq=freq, start=start,
                       quantile=quantile, hazard=hazard,
                       recovery=recovery)
    pfe = jnp.asarray(o.pfe, jnp.float32)   # exceed channel only; the
    # CVA output is pfe-independent, so the base-sigma levels are fine
    fn = _netting_fn(cfg, legs, float(freq), float(start), _haz(hazard),
                     float(recovery), int(n_paths), int(n_blocks),
                     bool(rqmc), mesh)

    def cva_of(s):
        return fn(key, s, market, pfe)[6]

    sig0 = jnp.asarray(cfg.sigma, jnp.float32)
    _, tangent = jax.jvp(cva_of, (sig0,), (jnp.ones_like(sig0),))
    up = cva_of(jnp.asarray(cfg.sigma + eps, jnp.float32))
    dn = cva_of(jnp.asarray(cfg.sigma - eps, jnp.float32))
    kw = dict(freq=freq, start=start, quantile=quantile, hazard=hazard,
              recovery=recovery)
    o_up = netting_oracle(cfg, market, legs, sigma=cfg.sigma + eps,
                          **kw).cva
    o_dn = netting_oracle(cfg, market, legs, sigma=cfg.sigma - eps,
                          **kw).cva
    return CVAVega(vega=tangent, fd_vega=(up - dn) / (2.0 * eps),
                   oracle_vega=(o_up - o_dn) / (2.0 * eps), epsilon=eps)


# ---------------------------------------------------------------------------
# Collateralized exposure: CSA with threshold H and a margin period of
# risk of ``lag`` reset periods.  Collateral held over (t_{j-1}, t_j] is
# set at the margin call date t_{j-lag}: C_j = (V(t_{j-lag}) - H)^+
# (one-way CSA, zero MTA), and the residual exposure is
# (V(t_j) - C_j)^+ — the discrete Pykhtin-Zhu margin model with the
# MPoR equal to ``lag`` reset periods (lag=0 is continuous margining,
# where the exposure collapses to min(V, H)^+ and stays closed form).
# The first ``lag`` dates are uncollateralized (no call before the
# first reset).  Oracles:
#   lag=0: segments of {0 < V <= H} + H x P(V > H) — one extra
#          _v_segments call per date, exact;
#   lag>=1: (r_s, r_t) is bivariate Gaussian (s = t_{j-lag}), so
#          EE_c = E[e^{-I_t} (V_t - C(r_s))^+]
#               = w0 integral phi(x) E[(V_t - K - C(x))^+ | r_s = x] dx
#          with the inner expectation the SAME segment closed form on
#          the conditional law; the outer integral runs panel-split
#          Gauss-Legendre with panel edges at the roots of V_s = H
#          (C is analytic inside each panel, so the rule converges
#          spectrally).  The e^{-I_t} tilt shifts BOTH means by their
#          covariances with I_t; PFE bisects the same mixture CDF under
#          the untilted law.
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _pair_stats(cfg: HWConfig, s: float, t: float):
    """fp64 second moments per unit sig_st of (r(s), r(t), I(t)):
    (var_rs, cov_rs_rt, cov_rs_It) — the cross-date quantities the
    collateral oracle needs beyond _date_stats (s <= t; the per-step
    shocks are shared, so covariances are prefix dot products of the
    shock shapes)."""
    from .bermudan import _step_index
    from .ops.engine_linear import _shock_shapes

    ns, nt = _step_index(cfg, s), _step_index(cfg, t)
    u_s, _ = (np.asarray(a, np.float64) for a in _shock_shapes(cfg, ns))
    u_t, w_t = (np.asarray(a, np.float64) for a in _shock_shapes(cfg, nt))
    return (float(u_s @ u_s), float(u_s @ u_t[:ns]),
            float(u_s @ w_t[:ns]))


def _panel_nodes(edges, mu: float, sd: float, n_per: int = 48,
                 width: float = 10.0):
    """Gauss-Legendre nodes/weights (already including the Gaussian
    density) over [mu - width sd, mu + width sd] split at ``edges``."""
    gl_x, gl_w = np.polynomial.legendre.leggauss(n_per)
    cuts = [mu - width * sd] + [e for e in sorted(edges)
                                if mu - width * sd < e < mu + width * sd] \
        + [mu + width * sd]
    xs, ws = [], []
    for a, b in zip(cuts[:-1], cuts[1:]):
        x = 0.5 * (a + b) + 0.5 * (b - a) * gl_x
        dens = np.exp(-0.5 * ((x - mu) / sd) ** 2) \
            / (sd * math.sqrt(2.0 * math.pi))
        xs.append(x)
        ws.append(0.5 * (b - a) * gl_w * dens)
    return np.concatenate(xs), np.concatenate(ws)


def collateral_oracle(cfg: HWConfig, market: MarketCurve, legs, *,
                      threshold: float = 0.01, lag: int = 1,
                      freq: float = 1.0, start: float | None = None,
                      quantile: float = 0.95, hazard: float = 0.02,
                      recovery: float = 0.4,
                      sigma: float | None = None) -> OracleXVA:
    """fp64 collateralized exposure profile + CVA of a netted swap
    portfolio under the threshold-H, lag-period-MPoR CSA (module
    comment above).  lag=0 is exact closed form; lag>=1 is exact up to
    the panel Gauss-Legendre outer rule (pinned against an independent
    brute-force 2-d trapezoid to its ~5e-7 resolution in tests)."""
    if sigma is None:
        sigma = cfg.sigma
    if start is None:
        start = cfg.s1
    if lag < 0:
        raise ValueError("lag must be >= 0 reset periods")
    legs = tuple(SwapLeg(*l) for l in legs)
    H = float(threshold)
    tenor_max = max(l.tenor for l in legs)
    dates = exposure_dates(cfg, tenor_max, freq, start)
    tables = hw.step_tables(cfg, float(sigma), cfg.sigma, jnp.float32)
    sig = float(tables.sig_st)
    c = 0.5 * (float(sigma) ** 2 - cfg.sigma ** 2)
    rA, rB, iA, iB = _det_rI(cfg, dates)
    stats = _date_stats(cfg, dates)
    ee, pfe, dm = [], [], []
    for j, t in enumerate(dates):
        lams, Bs, K = _portfolio_terms(cfg, market, legs, t, float(sigma),
                                       freq, start)
        uu, ww, uw = stats[j]
        v_r, v_I, c_rI = sig * sig * uu, sig * sig * ww, sig * sig * uw
        r_det = rA[j] + c * rB[j]
        i_det = iA[j] + c * iB[j]
        s_r = math.sqrt(v_r)
        w0 = math.exp(-i_det + 0.5 * v_I)
        mu_t = r_det - c_rI            # tilted mean of r_t
        emean = float(np.sum(lams * np.exp(
            -i_det - Bs * r_det + 0.5 * (v_I + Bs * Bs * v_r
                                         + 2.0 * Bs * c_rI))))
        dm.append(emean - K * w0)
        if j < lag:                    # uncollateralized head
            segs = _v_segments(lams, Bs, K, mu_t, s_r)
            ee.append(w0 * _ee_segments(lams, Bs, K, mu_t, s_r, segs))
            pfe.append(_pfe_root(
                lambda v: 1.0 - _seg_mass(lams, Bs, K + v, r_det, s_r),
                quantile))
            continue
        if lag == 0:
            # min(V, H)^+ = V 1{0 < V <= H} + H 1{V > H}
            s0 = _v_segments(lams, Bs, K, mu_t, s_r)
            sH = _v_segments(lams, Bs, K + H, mu_t, s_r)
            band = _seg_diff(s0, sH)
            ee.append(w0 * (_ee_segments(lams, Bs, K, mu_t, s_r, band)
                            + H * _seg_gauss_mass(sH, mu_t, s_r)))
            pfe.append(_pfe_bisect(
                lambda v: 1.0 - _seg_mass(lams, Bs, K + min(v, H) + (
                    max(v - H, 0.0) * 1e18), r_det, s_r)
                if v < H else 1.0, quantile))
            continue
        # lag >= 1: margin call at s = dates[j - lag]
        s_date = dates[j - lag]
        lams_s, Bs_s, K_s = _portfolio_terms(cfg, market, legs, s_date,
                                             float(sigma), freq, start)
        uu_s, cov_st, cov_sI = _pair_stats(cfg, s_date, t)
        v_s = sig * sig * uu_s
        c_st = sig * sig * cov_st
        c_sI = sig * sig * cov_sI
        js = j - lag
        mu_s = (rA[js] + c * rB[js]) - c_sI      # tilted mean of r_s
        sd_s = math.sqrt(v_s)
        rho_sl = c_st / v_s                      # regression slope
        s_cond = math.sqrt(max(v_r - c_st * c_st / v_s, 1e-30))
        segs_H = _v_segments(lams_s, Bs_s, K_s + H, mu_s, sd_s)
        edges = [e for ab in segs_H for e in ab]
        xs, wq = _panel_nodes(edges, mu_s, sd_s)
        Vs = np.exp(-np.outer(xs, Bs_s)) @ lams_s - K_s
        C = np.maximum(Vs - H, 0.0)
        mu_c = mu_t + rho_sl * (xs - mu_s)
        # vectorized over the outer nodes: one shared-grid row-segment
        # call replaces len(xs) scalar _v_segments calls (same math;
        # the rows machinery is the G2 netting oracle's)
        lxr = np.broadcast_to(lams, (len(xs), len(lams)))
        Asg, Bsg, msk = _v_segments_rows(lxr, Bs, K + C, mu_c, s_cond)
        inner = _ee_rows(lxr, Bs, K + C, mu_c, s_cond, Asg, Bsg, msk)
        ee.append(w0 * float(wq @ inner))
        # PFE under the untilted law: same mixture, means unshifted
        mu_s0 = rA[js] + c * rB[js]
        segs_H0 = _v_segments(lams_s, Bs_s, K_s + H, mu_s0, sd_s)
        xs0, wq0 = _panel_nodes([e for ab in segs_H0 for e in ab],
                                mu_s0, sd_s)
        Vs0 = np.exp(-np.outer(xs0, Bs_s)) @ lams_s - K_s
        C0 = np.maximum(Vs0 - H, 0.0)
        mu_c0 = r_det + rho_sl * (xs0 - mu_s0)
        lxr0 = np.broadcast_to(lams, (len(xs0), len(lams)))
        grid0 = _v_grid_rows(lxr0, Bs, mu_c0, s_cond)

        def cdf(v):
            A0, B0, m0 = _v_segments_rows(lxr0, Bs, K + C0 + v, mu_c0,
                                          s_cond, iters=60, grid=grid0)
            return 1.0 - float(wq0 @ _mass_rows(mu_c0, s_cond,
                                                A0, B0, m0))

        pfe.append(_pfe_root(cdf, quantile))
    pd, dpd = _pd_weights(dates, hazard)
    lgd = 1.0 - recovery
    cva = lgd * sum(p * e for p, e in zip(pd, ee))
    hdelta = lgd * sum(p * e for p, e in zip(dpd, ee))
    return OracleXVA(dates=dates, ee=tuple(ee), pfe=tuple(pfe),
                     disc_swap=tuple(dm), epe=sum(ee) / len(ee),
                     cva=cva, hazard_delta=hdelta)


def _seg_mass(lams, Bs, K: float, mu: float, s: float) -> float:
    """P(V > 0) for V = sum lam e^{-B r} - K, r ~ N(mu, s^2)."""
    return _seg_gauss_mass(_v_segments(lams, Bs, K, mu, s), mu, s)


def _seg_gauss_mass(segs, mu: float, s: float) -> float:
    return sum(_nphi((b - mu) / s) - _nphi((a - mu) / s)
               for a, b in segs)


def _seg_diff(s0, sH):
    """Segments of {V > 0} minus {V > H} = {0 < V <= H} (H >= 0, so
    each sH segment is contained in an s0 segment)."""
    out = []
    for a, b in s0:
        cuts = [a]
        for c_, d in sH:
            if c_ >= a - 1e-300 and d <= b + 1e-300:
                cuts += [c_, d]
        cuts.append(b)
        for lo, hi in zip(cuts[::2], cuts[1::2]):
            if hi > lo:
                out.append((lo, hi))
    return tuple(out)


def _pfe_bisect(cdf, quantile: float, lo: float = 0.0,
                hi: float = 2.0) -> float:
    """Smallest v >= 0 with P(exposure <= v) >= quantile."""
    if cdf(lo) >= quantile:
        return 0.0
    for _ in range(100):
        mid = 0.5 * (lo + hi)
        if cdf(mid) < quantile:
            lo = mid
        else:
            hi = mid
    return max(0.5 * (lo + hi), 0.0)


@lru_cache(maxsize=None)
def _collateral_fn(cfg: HWConfig, legs: tuple, H: float, lag: int,
                   freq: float, start: float, hazard: float,
                   recovery: float, n_paths: int, n_blocks: int,
                   rqmc: bool, mesh):
    """Netting kernel with the CSA overlay: per path, C_j is the lagged
    thresholded value and the exposure sample is (V_j - C_j)^+.  The CV
    stays the discounted UNcollateralized value at its exact lognormal
    mean (same correlation machinery; beta* adapts)."""
    from .bermudan import _functional_chol, _functional_det

    tenor_max = max(l.tenor for l in legs)
    dates = exposure_dates(cfg, tenor_max, freq, start)
    m = len(dates)
    specs = tuple([("r", t) for t in dates] + [("I", t) for t in dates])
    LT = jnp.asarray(_functional_chol(cfg, specs))
    stats = jnp.asarray(_date_stats(cfg, dates), jnp.float32)
    pd, dpd = _pd_weights(dates, hazard)
    pdw = jnp.asarray(pd, jnp.float32)
    dpdw = jnp.asarray(dpd, jnp.float32)
    lgd = 1.0 - recovery
    scheds = [swap_schedule(cfg, l.rate, l.tenor, freq, start)
              for l in legs]
    sgs = [(-1.0 if l.payer else 1.0) for l in legs]
    Kv = np.zeros(m)
    for j, t in enumerate(dates):
        Kv[j] = sum(sg for l, sg in zip(legs, sgs)
                    if t < start + l.tenor - 1e-9)
    Kv = jnp.asarray(Kv, jnp.float32)

    def compute(key, sigma, market, pfe):
        tables = hw.step_tables(cfg, sigma, cfg.sigma, jnp.float32)
        det = _functional_det(cfg, sigma, specs)
        r_det, i_det = det[:m], det[m:]
        lam_rows, B_rows = [], []
        for j, t in enumerate(dates):
            ls, bs = [], []
            for leg, sched, sg in zip(legs, scheds, sgs):
                la, B = _bond_value_terms(cfg, sigma, market, sched, t)
                alive = 1.0 if t < start + leg.tenor - 1e-9 else 0.0
                ls.append(sg * alive * la)
                bs.append(B)
            lam_rows.append(jnp.concatenate(ls))
            B_rows.append(jnp.concatenate(bs))
        lam = jnp.stack(lam_rows)
        B = jnp.stack(B_rows)
        sig2 = tables.sig_st * tables.sig_st
        v_r, v_I, c_rI = (sig2 * stats[:, q] for q in range(3))
        w0 = jnp.exp(-i_det + 0.5 * v_I)
        emean = jnp.sum(lam * jnp.exp(
            -i_det[:, None] - B * r_det[:, None]
            + 0.5 * (v_I[:, None] + B * B * v_r[:, None]
                     + 2.0 * B * c_rI[:, None])), axis=1)
        cv_mean = emean - Kv * w0

        def block(bi):
            x = pmesh.block_normals(key, bi, n_paths, 2 * m, rqmc)
            z = tables.sig_st * jnp.dot(
                x, LT, preferred_element_type=jnp.float32,
                precision=cfg.matmul_precision)

            def leg(sgn):
                ro = r_det[None, :] + sgn * z[:, :m]
                disc = jnp.exp(-(i_det[None, :] + sgn * z[:, m:]))
                V = jnp.sum(lam[None, :, :]
                            * jnp.exp(-B[None, :, :] * ro[:, :, None]),
                            axis=2) - Kv[None, :]
                posted = jnp.maximum(V - H, 0.0)
                if lag == 0:
                    C = posted
                else:
                    C = jnp.concatenate(
                        [jnp.zeros_like(V[:, :lag]), posted[:, :m - lag]],
                        axis=1)
                Ex = V - C
                X = disc * jnp.maximum(Ex, 0.0)
                Y = disc * V
                E = (Ex > pfe[None, :]).astype(jnp.float32)
                return X, Y, E

            Xp, Yp, Ep = leg(1.0)
            Xm, Ym, Em = leg(-1.0)
            X, Y = 0.5 * (Xp + Xm), 0.5 * (Yp + Ym)
            E = 0.5 * (Ep + Em)
            Xc = jnp.dot(X, pdw)
            Yc = jnp.dot(Y, pdw)
            per_date = jnp.concatenate([
                jnp.sum(X, axis=0), jnp.sum(X * X, axis=0),
                jnp.sum(Y, axis=0), jnp.sum(Y * Y, axis=0),
                jnp.sum(X * Y, axis=0), jnp.sum(E, axis=0)])
            agg = jnp.stack([jnp.sum(Xc), jnp.sum(Xc * Xc), jnp.sum(Yc),
                             jnp.sum(Yc * Yc), jnp.sum(Xc * Yc)])
            return jnp.concatenate([per_date, agg])

        per_block = pmesh.map_blocks(block, n_blocks, mesh)
        return _profile_reduce(per_block, m, n_paths, n_blocks, rqmc,
                               cv_mean, pdw, dpdw, lgd)

    return jax.jit(compute)


def price_collateral(cfg: HWConfig, key, market: MarketCurve, legs, *,
                     threshold: float = 0.01, lag: int = 1,
                     freq: float = 1.0, start: float | None = None,
                     quantile: float = 0.95, hazard: float = 0.02,
                     recovery: float = 0.4, sigma=None,
                     n_paths: int | None = None, n_blocks: int = 1,
                     rqmc: bool = False, mesh=None) -> CVAResult:
    """Monte Carlo collateralized exposure + CVA under the threshold-H,
    lag-period-MPoR CSA; fp64 oracle ``collateral_oracle``.  Same exact
    multi-date states as ``price_netting`` — the collateral is a lagged
    thresholded readout of the value path the kernel already has."""
    if rqmc and n_blocks < 2:
        raise ValueError("rqmc needs n_blocks >= 2 (the digital shifts "
                         "are the independent replicates)")
    if sigma is None:
        sigma = cfg.sigma
    if n_paths is None:
        n_paths = cfg.n_paths
    if start is None:
        start = cfg.s1
    legs = tuple(SwapLeg(*l) for l in legs)
    o = collateral_oracle(cfg, market, legs, threshold=threshold,
                          lag=lag, freq=freq, start=start,
                          quantile=quantile, hazard=hazard,
                          recovery=recovery, sigma=float(sigma))
    pfe = jnp.asarray(o.pfe, jnp.float32)
    out = _collateral_fn(cfg, legs, float(threshold), int(lag),
                         float(freq), float(start), _haz(hazard),
                         float(recovery), int(n_paths), int(n_blocks),
                         bool(rqmc), mesh)(
        key, jnp.asarray(sigma, jnp.float32), market, pfe)
    tenor_max = max(l.tenor for l in legs)
    prof = ExposureProfile(
        dates=exposure_dates(cfg, tenor_max, freq, start), ee=out[0],
        ee_std_error=out[1], ee_raw=out[2], beta=out[3], pfe=pfe,
        exceed=out[4], epe=out[5], n_paths=int(n_paths) * int(n_blocks))
    return CVAResult(cva=out[6], std_error=out[7], raw_cva=out[8],
                     raw_std_error=out[9], beta=out[10],
                     hazard_delta=out[11], profile=prof)


# ---------------------------------------------------------------------------
# Bilateral XVA: DVA and funding off the SAME kernel.  The pathwise
# identity (-V)^+ = V^+ - V means the discounted negative exposure is
# X_j - Y_j with X, Y the samples the netting kernel already carries, so
# ENE_j = EE_j - E[D_j V_j] is exact given the profile and the CV means
# — no new sampling.  Default times are independent exponentials
# (hazards h_c, h_o); the discrete bucket weights follow the same
# right-endpoint convention as _pd_weights:
#
#   CVA  = (1-R_c) sum_j S_o(t_j) [S_c(t_{j-1}) - S_c(t_j)] EE_j
#   DVA  = (1-R_o) sum_j S_c(t_j) [S_o(t_{j-1}) - S_o(t_j)] ENE_j
#   BCVA = CVA - DVA
#   FCA/FBA = s_b/s_l sum_j S_c S_o (t_j - t_{j-1}) EE_j/ENE_j,
#   FVA = FCA - FBA   (with s_b = s_l, FVA = s sum w_j E[D_j V_j]
#                      exactly — the MC channel's CV collapses its
#                      variance to zero, tested)
#
# The MC headline quotes (BCVA, FVA) are single per-path samples with
# their own optimal-beta CV (``bil`` channels of _netting_fn), so each
# quoted SE is the SE of the quoted number — per-date SEs never get
# summed across correlated dates.
# ---------------------------------------------------------------------------


def _surv_weights(dates: tuple, hazard_c: float, hazard_o: float):
    """(wc, wo, wf): CVA, DVA and funding bucket weights under
    independent default times (flat hazards or ``CreditCurve``s)."""
    from .credit import survival

    prev = 0.0
    wc, wo, wf = [], [], []
    for t in dates:
        sc_p, sc = survival(hazard_c, prev), survival(hazard_c, t)
        so_p, so = survival(hazard_o, prev), survival(hazard_o, t)
        wc.append(so * (sc_p - sc))
        wo.append(sc * (so_p - so))
        wf.append(sc * so * (t - prev))
        prev = t
    return tuple(wc), tuple(wo), tuple(wf)


class BilateralOracle(NamedTuple):
    dates: tuple
    ee: tuple
    ene: tuple           # discounted expected NEGATIVE exposure
    cva: float           # survival-adjusted counterparty leg
    dva: float
    bcva: float
    fca: float
    fba: float
    fva: float


def bilateral_oracle(cfg: HWConfig, market: MarketCurve, legs, *,
                     freq: float = 1.0, start: float | None = None,
                     hazard: float = 0.02, recovery: float = 0.4,
                     hazard_own: float = 0.01,
                     recovery_own: float = 0.4,
                     spread_borrow: float = 0.005,
                     spread_lend: float = 0.005,
                     sigma: float | None = None) -> BilateralOracle:
    """fp64 bilateral CVA/DVA/FVA of a netted swap portfolio: EE from
    the segment decomposition (``netting_oracle``), ENE from the exact
    identity ENE_j = EE_j - E[D_j V_j] (tested against an independent
    direct segment integration of the negative part)."""
    o = netting_oracle(cfg, market, legs, freq=freq, start=start,
                       hazard=hazard, recovery=recovery, sigma=sigma)
    ene = tuple(e - d for e, d in zip(o.ee, o.disc_swap))
    wc, wo, wf = _surv_weights(o.dates, hazard, hazard_own)
    lgd_c, lgd_o = 1.0 - recovery, 1.0 - recovery_own
    cva = lgd_c * sum(w * e for w, e in zip(wc, o.ee))
    dva = lgd_o * sum(w * e for w, e in zip(wo, ene))
    fca = spread_borrow * sum(w * e for w, e in zip(wf, o.ee))
    fba = spread_lend * sum(w * e for w, e in zip(wf, ene))
    return BilateralOracle(dates=o.dates, ee=o.ee, ene=ene, cva=cva,
                           dva=dva, bcva=cva - dva, fca=fca, fba=fba,
                           fva=fca - fba)


class BilateralResult(NamedTuple):
    bcva: jax.Array
    bcva_se: jax.Array
    fva: jax.Array
    fva_se: jax.Array
    cva: jax.Array       # per-date-profile point estimates (CV'd)
    dva: jax.Array
    fca: jax.Array
    fba: jax.Array
    ene: jax.Array       # (m,) CV'd ENE profile, se == profile ee se
    base: CVAResult      # the underlying netted profile/CVA result


def price_bilateral(cfg: HWConfig, key, market: MarketCurve, legs, *,
                    freq: float = 1.0, start: float | None = None,
                    quantile: float = 0.95, hazard: float = 0.02,
                    recovery: float = 0.4, hazard_own: float = 0.01,
                    recovery_own: float = 0.4,
                    spread_borrow: float = 0.005,
                    spread_lend: float = 0.005, sigma=None,
                    n_paths: int | None = None, n_blocks: int = 1,
                    rqmc: bool = False, mesh=None) -> BilateralResult:
    """Monte Carlo bilateral XVA on the netted portfolio: the BCVA and
    asymmetric-FVA headline numbers are dedicated per-path aggregate
    channels with their own optimal-beta CVs (exact means from the
    lognormal identities), so the quoted SEs are exact for the quoted
    quantities.  fp64 oracle: ``bilateral_oracle``."""
    if rqmc and n_blocks < 2:
        raise ValueError("rqmc needs n_blocks >= 2 (the digital shifts "
                         "are the independent replicates)")
    if sigma is None:
        sigma = cfg.sigma
    if n_paths is None:
        n_paths = cfg.n_paths
    if start is None:
        start = cfg.s1
    legs = tuple(SwapLeg(*l) for l in legs)
    o = netting_oracle(cfg, market, legs, freq=freq, start=start,
                       quantile=quantile, hazard=hazard,
                       recovery=recovery, sigma=float(sigma))
    wc, wo, wf = _surv_weights(o.dates, hazard, hazard_own)
    lgd_c, lgd_o = 1.0 - recovery, 1.0 - recovery_own
    # BCVA sample: sum_j [lgd_c wc_j X_j - lgd_o wo_j (X_j - Y_j)]
    bx = tuple(lgd_c * c - lgd_o * w for c, w in zip(wc, wo))
    by = tuple(lgd_o * w for w in wo)
    # FVA sample: sum_j [s_b wf_j X_j - s_l wf_j (X_j - Y_j)]
    fx = tuple((spread_borrow - spread_lend) * w for w in wf)
    fy = tuple(spread_lend * w for w in wf)
    bil = ((bx, by, bx), (fx, fy, wf))
    pfe = jnp.asarray(o.pfe, jnp.float32)
    out = _netting_fn(cfg, legs, float(freq), float(start), _haz(hazard),
                      float(recovery), int(n_paths), int(n_blocks),
                      bool(rqmc), mesh, bil)(
        key, jnp.asarray(sigma, jnp.float32), market, pfe)
    tenor_max = max(l.tenor for l in legs)
    prof = ExposureProfile(
        dates=exposure_dates(cfg, tenor_max, freq, start), ee=out[0],
        ee_std_error=out[1], ee_raw=out[2], beta=out[3], pfe=pfe,
        exceed=out[4], epe=out[5], n_paths=int(n_paths) * int(n_blocks))
    base = CVAResult(cva=out[6], std_error=out[7], raw_cva=out[8],
                     raw_std_error=out[9], beta=out[10],
                     hazard_delta=out[11], profile=prof)
    (bcva, bcva_se, _, _, _), (fva, fva_se, _, _, _) = out[12], out[13]
    dm = jnp.asarray(o.disc_swap, jnp.float32)
    ene = out[0] - dm
    wcj = jnp.asarray(wc, jnp.float32)
    woj = jnp.asarray(wo, jnp.float32)
    wfj = jnp.asarray(wf, jnp.float32)
    return BilateralResult(
        bcva=bcva, bcva_se=bcva_se, fva=fva, fva_se=fva_se,
        cva=lgd_c * jnp.dot(wcj, out[0]), dva=lgd_o * jnp.dot(woj, ene),
        fca=spread_borrow * jnp.dot(wfj, out[0]),
        fba=spread_lend * jnp.dot(wfj, ene), ene=ene, base=base)


# ---------------------------------------------------------------------------
# G2++ netting twin: the netted portfolio value at a reset date is
# V(x, y) = sum_i lam_i e^{-Ba_i x - Bb_i y} - K with SIGNED lam across
# the legs' cashflows.  Conditional on x it is AGAIN a signed sum of
# exponentials in y — exactly the one-factor form — so the oracle is the
# outer x-quadrature of the HW segment machinery applied row by row:
# EE_j = P(0,t_j) integral phi(x) E[(V | x)^+] dx with the inner
# expectation the lognormal partial means over the (vectorized, padded)
# positive y-segments per x node, and the PFE CDF the same mixture of
# per-row Gaussian segment masses.  A one-leg portfolio reproduces
# exposure_oracle_g2 (Newton single-root inner) to quadrature precision.
# ---------------------------------------------------------------------------

try:
    from scipy.special import ndtr as _vphi      # fast vectorized Phi
except Exception:                                # pragma: no cover
    _vphi = _nphi


def _g2_portfolio_terms(cfg: HWConfig, g, market: MarketCurve,
                        legs: tuple, t: float, freq: float, start: float):
    """fp64 signed (lam_i, Ba_i, Bb_i, K) of the netted G2++ portfolio
    at reset date t: V(x, y) = sum lam_i e^{-Ba_i x - Bb_i y} - K."""
    lams, Bas, Bbs, K = [], [], [], 0.0
    for leg in legs:
        sg = -1.0 if leg.payer else 1.0
        if t >= start + leg.tenor - 1e-9:
            continue
        sched = swap_schedule(cfg, leg.rate, leg.tenor, freq, start)
        lam, Ba, Bb, _ = _g2_date_terms(cfg, g, market, sched, t)
        lams.append(sg * lam)
        Bas.append(Ba)
        Bbs.append(Bb)
        K += sg
    return (np.concatenate(lams), np.concatenate(Bas),
            np.concatenate(Bbs), K)


def _v_grid_rows(lx, Bs, mu, s: float, width: float = 10.0,
                 res: float = 150.0):
    """Shared scan grid for _v_segments_rows: (ys, V0) with
    V0[k, j] = sum_i lx[k,i] e^{-Bs_i ys_j} — K-independent, so a PFE
    bisection over the level v reuses one grid for every probe."""
    n = lx.shape[0]
    mu = np.broadcast_to(np.asarray(mu, np.float64), (n,))
    lo = float(np.min(mu)) - width * s
    hi = float(np.max(mu)) + width * s
    n_scan = min(int((hi - lo) / (s / res)) + 2, 20001)
    ys = np.linspace(lo, hi, n_scan)
    return ys, lx @ np.exp(-np.outer(Bs, ys))


def _v_segments_rows(lx, Bs, K, mu, s: float, width: float = 10.0,
                     res: float = 150.0, iters: int = 80, grid=None):
    """Vectorized multi-row _v_segments: positive segments of
    V_k(y) = sum_i lx[k,i] e^{-Bs_i y} - K_k per row k (K scalar or
    per-row), scanned on a SHARED grid covering every row's
    [mu_k - width s, mu_k + width s] window at resolution s/res, every
    sign-change cell bisected in lockstep.  Returns (A, B, mask) of
    shape (n_rows, S): segment [A, B] is a positive interval of row k
    where mask is True."""
    n = lx.shape[0]
    if grid is None:
        grid = _v_grid_rows(lx, Bs, mu, s, width, res)
    ys, V0 = grid
    lo, hi = float(ys[0]), float(ys[-1])
    Kv = np.broadcast_to(np.asarray(K, np.float64), (n,))
    V = V0 - Kv[:, None]                                # (n, n_scan)
    flip = (V[:, :-1] == 0.0) | (V[:, :-1] * V[:, 1:] < 0.0)
    rows, cols = np.nonzero(flip)
    a_, b_ = ys[cols], ys[cols + 1]
    fa = V[rows, cols]
    lxr = lx[rows]
    Kr = Kv[rows]
    for _ in range(iters):
        m_ = 0.5 * (a_ + b_)
        fm = np.sum(lxr * np.exp(-np.outer(m_, Bs)), axis=1) - Kr
        take = fa * fm <= 0.0
        b_ = np.where(take, m_, b_)
        a_ = np.where(take, a_, m_)
        fa = np.where(take, fa, fm)
    counts = np.bincount(rows, minlength=n)
    r_max = int(counts.max()) if len(rows) else 0
    roots = np.full((n, r_max), hi)
    if len(rows):
        starts = np.concatenate([[0], np.cumsum(counts)])[:-1]
        roots[rows, np.arange(len(rows)) - starts[rows]] = 0.5 * (a_ + b_)
    edges = np.concatenate([np.full((n, 1), lo), roots,
                            np.full((n, 1), hi)], axis=1)
    A, B = edges[:, :-1], edges[:, 1:]
    mids = 0.5 * (A + B)
    Vm = np.sum(lx[:, None, :]
                * np.exp(-Bs[None, None, :] * mids[:, :, None]),
                axis=2) - Kv[:, None]
    mask = (Vm > 0.0) & (B > A)
    return A, B, mask


def _ee_rows(lx, Bs, K, mu, s: float, A, B, mask):
    """(n,) E[V_k(y)^+], y ~ N(mu_k, s^2): the _ee_segments lognormal
    partial means, vectorized over the padded row segments (K scalar
    or per-row)."""
    n = lx.shape[0]
    mu = np.broadcast_to(np.asarray(mu, np.float64), (n,))
    Kv = np.broadcast_to(np.asarray(K, np.float64), (n,))
    emom = lx * np.exp(-Bs[None, :] * mu[:, None]
                       + 0.5 * (Bs * s) ** 2)           # (n, ncf)
    za = (A - mu[:, None]) / s                          # (n, S)
    zb = (B - mu[:, None]) / s
    dphi = _vphi(zb[:, :, None] + Bs[None, None, :] * s) \
        - _vphi(za[:, :, None] + Bs[None, None, :] * s)
    t1 = np.sum(emom[:, None, :] * dphi, axis=2)        # (n, S)
    t2 = Kv[:, None] * (_vphi(zb) - _vphi(za))
    return np.maximum(np.sum(np.where(mask, t1 - t2, 0.0), axis=1), 0.0)


def _mass_rows(mu, s: float, A, B, mask):
    """(n,) P(y in positive segments), y ~ N(mu_k, s^2)."""
    n = A.shape[0]
    mu = np.broadcast_to(np.asarray(mu, np.float64), (n,))
    d = _vphi((B - mu[:, None]) / s) - _vphi((A - mu[:, None]) / s)
    return np.sum(np.where(mask, d, 0.0), axis=1)


def _pfe_root(cdf, quantile: float, hi: float = 0.5) -> float:
    """``_pfe_bisect`` semantics via Brent: the cdf here is a smooth
    Gaussian-mixture mass, so superlinear root-finding cuts the ~100
    grid-scan probes per date to ~10-15."""
    if cdf(0.0) >= quantile:
        return 0.0
    while cdf(hi) < quantile:
        hi *= 2.0
    try:
        from scipy.optimize import brentq
        return float(brentq(lambda v: cdf(v) - quantile, 0.0, hi,
                            xtol=1e-13, rtol=8.9e-16))
    except Exception:                               # pragma: no cover
        return _pfe_bisect(cdf, quantile, hi=hi)


def _g2_net_ee(g, lam, Ba, Bb, K: float, t: float,
               means=None) -> float:
    """E^{T_t}[(sum_i lam_i e^{-Ba_i x - Bb_i y} - K)^+] under the
    t-forward means (no P(0,t) factor): outer 2001-node +-8 sigma
    trapezoid in x (same grid as _ee_g2_closed so the one-leg pin is
    quadrature-exact) x exact row-segment closed form in y.  ``means``
    overrides the (mx, my) tilt — the WWR oracle passes its own
    two-date tilted means; the centered covariance is tilt-invariant."""
    from .models.g2pp import _fwd_means, _xy_cov

    mx, my = _fwd_means(g, t) if means is None else means
    sx, sy, rxy = _xy_cov(g, t)
    s_c = sy * math.sqrt(max(1.0 - rxy * rxy, 1e-16))
    xs = mx + sx * np.linspace(-8.0, 8.0, 2001)
    wpdf = np.exp(-0.5 * ((xs - mx) / sx) ** 2) \
        / (sx * math.sqrt(2.0 * math.pi))
    m_c = my + rxy * sy / sx * (xs - mx)
    lxs = lam[None, :] * np.exp(-Ba[None, :] * xs[:, None])
    Asg, Bsg, msk = _v_segments_rows(lxs, Bb, K, m_c, s_c)
    inner = _ee_rows(lxs, Bb, K, m_c, s_c, Asg, Bsg, msk)
    return float(np.trapezoid(wpdf * inner, xs))


def _g2_net_pfe(g, lam, Ba, Bb, K: float, t: float,
                quantile: float) -> float:
    """q-quantile of (sum lam e^{-Ba x - Bb y} - K)^+ under the CENTERED
    risk-neutral law at t: Brent on the Gaussian-mixture segment-mass
    CDF over an 801-node outer x grid (cf. _pfe_g2)."""
    from .models.g2pp import _xy_cov

    sx, sy, rxy = _xy_cov(g, t)
    s_c = sy * math.sqrt(max(1.0 - rxy * rxy, 1e-16))
    xs0 = sx * np.linspace(-8.0, 8.0, 801)
    w0 = np.exp(-0.5 * (xs0 / sx) ** 2) / (sx * math.sqrt(2 * math.pi))
    w0 = w0 / np.trapezoid(w0, xs0)
    m_c0 = rxy * sy / sx * xs0
    lxs0 = lam[None, :] * np.exp(-Ba[None, :] * xs0[:, None])
    grid0 = _v_grid_rows(lxs0, Bb, m_c0, s_c, res=100.0)

    def cdf(v):
        Av, Bv, mv = _v_segments_rows(lxs0, Bb, K + v, m_c0, s_c,
                                      res=100.0, iters=60, grid=grid0)
        return 1.0 - float(np.trapezoid(
            w0 * _mass_rows(m_c0, s_c, Av, Bv, mv), xs0))

    return _pfe_root(cdf, quantile)


_G2_ORACLE_CACHE: dict = {}


def _g2_oracle_memo(name: str, market: MarketCurve, key_tail: tuple):
    """Memo key for the fp64 G2++ XVA oracles (the profiles are pure
    functions of the market curve bytes + scalar parameters; the MC
    pricers re-call the oracle for the PFE levels, so memoizing keeps
    tests and oracle+MC CLI paths from paying the quadrature twice)."""
    return (name, np.asarray(market.P, np.float32).tobytes()) + key_tail


def netting_oracle_g2(cfg: HWConfig, g, market: MarketCurve, legs, *,
                      freq: float = 1.0, start: float | None = None,
                      quantile: float = 0.95, hazard: float = 0.02,
                      recovery: float = 0.4) -> OracleXVA:
    """fp64 netted G2++ exposure profile + CVA (module comment above):
    per date, outer 2001-node trapezoid in x under the t_j-forward
    measure x the exact segment decomposition of the conditional
    one-factor law in y; PFE bisects the mixture CDF under the centered
    risk-neutral law.  One leg reproduces ``exposure_oracle_g2``; the
    netting benefit is non-negative pathwise (both tested)."""
    if start is None:
        start = cfg.s1
    mk = _g2_oracle_memo("net", market, (cfg, g, tuple(map(tuple, legs)),
                                         freq, start, quantile, hazard,
                                         recovery))
    if mk in _G2_ORACLE_CACHE:
        return _G2_ORACLE_CACHE[mk]
    legs = tuple(SwapLeg(*l) for l in legs)
    tenor_max = max(l.tenor for l in legs)
    dates = exposure_dates(cfg, tenor_max, freq, start)
    Ts_grid = np.linspace(0.0, cfg.t_final, cfg.n_mat)
    P = np.asarray(market.P, np.float64)
    ee, pfe, dm = [], [], []
    for t in dates:
        lam, Ba, Bb, K = _g2_portfolio_terms(cfg, g, market, legs, t,
                                             freq, start)
        Pt = float(np.interp(t, Ts_grid, P))
        ee.append(Pt * _g2_net_ee(g, lam, Ba, Bb, K, t))
        pfe.append(_g2_net_pfe(g, lam, Ba, Bb, K, t, quantile))
        # exact martingale CV mean per leg
        total = 0.0
        for leg in legs:
            if t >= start + leg.tenor - 1e-9:
                continue
            sg = -1.0 if leg.payer else 1.0
            sched = swap_schedule(cfg, leg.rate, leg.tenor, freq, start)
            alive = np.asarray(sched.times, np.float64) > t + 1e-9
            cs = np.asarray(sched.coupons, np.float64)
            P0i = np.interp(np.asarray(sched.times), Ts_grid, P)
            total += sg * (float(np.sum(alive * cs * P0i)) - Pt)
        dm.append(total)
    pd, dpd = _pd_weights(dates, hazard)
    lgd = 1.0 - recovery
    cva = lgd * sum(p * e for p, e in zip(pd, ee))
    hdelta = lgd * sum(p * e for p, e in zip(dpd, ee))
    out = OracleXVA(dates=dates, ee=tuple(ee), pfe=tuple(pfe),
                    disc_swap=tuple(dm), epe=sum(ee) / len(ee),
                    cva=cva, hazard_delta=hdelta)
    _G2_ORACLE_CACHE[mk] = out
    return out


@lru_cache(maxsize=None)
def _netting_g2_fn(cfg: HWConfig, g, legs: tuple, freq: float,
                   start: float, hazard: float, recovery: float,
                   n_paths: int, n_blocks: int, rqmc: bool, mesh,
                   bil=None, agg_weights: tuple | None = None):
    """G2++ twin of ``_netting_fn``: the exactly-sampled functionals
    (x, y, I per reset date, 3m normals/path) are LEG-independent, so
    the netted kernel is ``_xva_g2_fn`` with the per-leg bond terms
    concatenated (signed, alive-masked) along the cashflow axis and the
    par-float constant summed into the per-date Kv.  ``bil`` and
    ``agg_weights`` as in ``_netting_fn``."""
    from .models.g2pp import _B, _g2_functional_chol, _v_integral

    tenor_max = max(l.tenor for l in legs)
    dates = exposure_dates(cfg, tenor_max, freq, start)
    m = len(dates)
    specs = tuple([s for t in dates
                   for s in (("u", t, 1.0, 0.0), ("u", t, 0.0, 1.0))]
                  + [("I", t) for t in dates])
    LT = jnp.asarray(_g2_functional_chol(g, specs))
    d0 = jnp.asarray([-0.5 * _v_integral(g, t) for t in dates],
                     jnp.float32)
    scheds = [swap_schedule(cfg, l.rate, l.tenor, freq, start)
              for l in legs]
    sgs = [(-1.0 if l.payer else 1.0) for l in legs]
    ncf = sum(len(s.times) for s in scheds)
    BaM = np.zeros((m, ncf))
    BbM = np.zeros((m, ncf))
    facM = np.zeros((m, ncf))       # sg * alive * c_i * exp(vadj)
    cpM = np.zeros((m, ncf))        # sg * alive * c_i  (CV means)
    timesC = np.concatenate([np.asarray(s.times) for s in scheds])
    Kv = np.zeros(m)
    col0 = 0
    for leg, sched, sg in zip(legs, scheds, sgs):
        nl = len(sched.times)
        for j, t in enumerate(dates):
            if t >= start + leg.tenor - 1e-9:
                continue
            Kv[j] += sg
            for i, T_i in enumerate(sched.times):
                if T_i <= t + 1e-9:
                    continue
                c = col0 + i
                BaM[j, c] = _B(g.a, T_i - t)
                BbM[j, c] = _B(g.b, T_i - t)
                vadj = 0.5 * (_v_integral(g, T_i - t)
                              - _v_integral(g, T_i) + _v_integral(g, t))
                facM[j, c] = sg * sched.coupons[i] * math.exp(vadj)
                cpM[j, c] = sg * sched.coupons[i]
        col0 += nl
    BaJ, BbJ = jnp.asarray(BaM, jnp.float32), jnp.asarray(BbM, jnp.float32)
    facJ = jnp.asarray(facM, jnp.float32)
    cpJ = jnp.asarray(cpM, jnp.float32)
    KvJ = jnp.asarray(Kv, jnp.float32)
    timesJ = jnp.asarray(timesC, jnp.float32)
    pd, dpd = _pd_weights(dates, hazard)
    if agg_weights is not None:
        pd, dpd = agg_weights, tuple(0.0 for _ in dates)
    pdw = jnp.asarray(pd, jnp.float32)
    dpdw = jnp.asarray(dpd, jnp.float32)
    lgd = 1.0 - recovery
    bilw = None if bil is None else [
        tuple(jnp.asarray(w, jnp.float32) for w in ch) for ch in bil]

    def compute(key, market, pfe):
        Pt = hw.interp_curve(market.P, jnp.asarray(dates, jnp.float32),
                             cfg)                                # (m,)
        P0i = hw.interp_curve(market.P, timesJ, cfg)             # (ncf,)
        lam = facJ * (P0i[None, :] / Pt[:, None])                # (m, ncf)
        disc0 = Pt * jnp.exp(d0)
        # exact martingale CV means E[D_j V_j] = sum sg (sum c P0i - P0t)
        cv_mean = jnp.sum(cpJ * P0i[None, :], axis=1) - KvJ * Pt

        def block(bi):
            xn = pmesh.block_normals(key, bi, n_paths, 3 * m, rqmc)
            z = jnp.dot(xn, LT, preferred_element_type=jnp.float32,
                        precision=cfg.matmul_precision)

            def leg(sgn):
                x = sgn * z[:, 0:2 * m:2]                   # (paths, m)
                y = sgn * z[:, 1:2 * m:2]
                I = sgn * z[:, 2 * m:]
                V = jnp.sum(lam[None, :, :]
                            * jnp.exp(-BaJ[None, :, :] * x[:, :, None]
                                      - BbJ[None, :, :] * y[:, :, None]),
                            axis=2) - KvJ[None, :]
                D = disc0[None, :] * jnp.exp(-I)
                X = D * jnp.maximum(V, 0.0)
                Y = D * V
                E = (V > pfe[None, :]).astype(jnp.float32)
                return X, Y, E

            Xp, Yp, Ep = leg(1.0)
            Xm, Ym, Em = leg(-1.0)
            X, Y = 0.5 * (Xp + Xm), 0.5 * (Yp + Ym)
            E = 0.5 * (Ep + Em)
            Xc = jnp.dot(X, pdw)
            Yc = jnp.dot(Y, pdw)
            per_date = jnp.concatenate([
                jnp.sum(X, axis=0), jnp.sum(X * X, axis=0),
                jnp.sum(Y, axis=0), jnp.sum(Y * Y, axis=0),
                jnp.sum(X * Y, axis=0), jnp.sum(E, axis=0)])
            agg = [jnp.sum(Xc), jnp.sum(Xc * Xc), jnp.sum(Yc),
                   jnp.sum(Yc * Yc), jnp.sum(Xc * Yc)]
            if bilw is not None:
                for wx, wy, wv in bilw:
                    Z = jnp.dot(X, wx) + jnp.dot(Y, wy)
                    W = jnp.dot(Y, wv)
                    agg += [jnp.sum(Z), jnp.sum(Z * Z), jnp.sum(W),
                            jnp.sum(W * W), jnp.sum(Z * W)]
            return jnp.concatenate([per_date, jnp.stack(agg)])

        per_block = pmesh.map_blocks(block, n_blocks, mesh)
        extra_means = () if bilw is None else tuple(
            jnp.dot(wv, cv_mean) for _, _, wv in bilw)
        return _profile_reduce(per_block, m, n_paths, n_blocks, rqmc,
                               cv_mean, pdw, dpdw, lgd,
                               extra_means=extra_means)

    return jax.jit(compute)


def price_netting_g2(cfg: HWConfig, g, key, market: MarketCurve, legs, *,
                     freq: float = 1.0, start: float | None = None,
                     quantile: float = 0.95, hazard: float = 0.02,
                     recovery: float = 0.4, n_paths: int | None = None,
                     n_blocks: int = 1, rqmc: bool = False,
                     mesh=None) -> CVAResult:
    """G2++ twin of ``price_netting``: netted exposure profile + CVA of
    a swap portfolio on the exactly-sampled (x, y, I) states; the netted
    discounted portfolio value is the CV at its exact martingale mean.
    fp64 oracle: ``netting_oracle_g2``."""
    if rqmc and n_blocks < 2:
        raise ValueError("rqmc needs n_blocks >= 2 (the digital shifts "
                         "are the independent replicates)")
    if n_paths is None:
        n_paths = cfg.n_paths
    if start is None:
        start = cfg.s1
    legs = tuple(SwapLeg(*l) for l in legs)
    o = netting_oracle_g2(cfg, g, market, legs, freq=freq, start=start,
                          quantile=quantile, hazard=hazard,
                          recovery=recovery)
    pfe = jnp.asarray(o.pfe, jnp.float32)
    out = _netting_g2_fn(cfg, g, legs, float(freq), float(start),
                         _haz(hazard), float(recovery), int(n_paths),
                         int(n_blocks), bool(rqmc), mesh)(
        key, market, pfe)
    tenor_max = max(l.tenor for l in legs)
    prof = ExposureProfile(
        dates=exposure_dates(cfg, tenor_max, freq, start), ee=out[0],
        ee_std_error=out[1], ee_raw=out[2], beta=out[3], pfe=pfe,
        exceed=out[4], epe=out[5], n_paths=int(n_paths) * int(n_blocks))
    return CVAResult(cva=out[6], std_error=out[7], raw_cva=out[8],
                     raw_std_error=out[9], beta=out[10],
                     hazard_delta=out[11], profile=prof)


def bilateral_oracle_g2(cfg: HWConfig, g, market: MarketCurve, legs, *,
                        freq: float = 1.0, start: float | None = None,
                        hazard: float = 0.02, recovery: float = 0.4,
                        hazard_own: float = 0.01,
                        recovery_own: float = 0.4,
                        spread_borrow: float = 0.005,
                        spread_lend: float = 0.005) -> BilateralOracle:
    """fp64 bilateral CVA/DVA/FVA of a netted G2++ portfolio: EE from
    ``netting_oracle_g2``, ENE by ENE_j = EE_j - E[D_j V_j] (the exact
    pathwise identity (-V)^+ = V^+ - V)."""
    o = netting_oracle_g2(cfg, g, market, legs, freq=freq, start=start,
                          hazard=hazard, recovery=recovery)
    ene = tuple(e - d for e, d in zip(o.ee, o.disc_swap))
    wc, wo, wf = _surv_weights(o.dates, hazard, hazard_own)
    lgd_c, lgd_o = 1.0 - recovery, 1.0 - recovery_own
    cva = lgd_c * sum(w * e for w, e in zip(wc, o.ee))
    dva = lgd_o * sum(w * e for w, e in zip(wo, ene))
    fca = spread_borrow * sum(w * e for w, e in zip(wf, o.ee))
    fba = spread_lend * sum(w * e for w, e in zip(wf, ene))
    return BilateralOracle(dates=o.dates, ee=o.ee, ene=ene, cva=cva,
                           dva=dva, bcva=cva - dva, fca=fca, fba=fba,
                           fva=fca - fba)


def price_bilateral_g2(cfg: HWConfig, g, key, market: MarketCurve,
                       legs, *, freq: float = 1.0,
                       start: float | None = None, quantile: float = 0.95,
                       hazard: float = 0.02, recovery: float = 0.4,
                       hazard_own: float = 0.01,
                       recovery_own: float = 0.4,
                       spread_borrow: float = 0.005,
                       spread_lend: float = 0.005,
                       n_paths: int | None = None, n_blocks: int = 1,
                       rqmc: bool = False, mesh=None) -> BilateralResult:
    """G2++ twin of ``price_bilateral``: BCVA and asymmetric-FVA headline
    channels with their own optimal-beta CVs on the netted G2++ kernel.
    fp64 oracle: ``bilateral_oracle_g2``."""
    if rqmc and n_blocks < 2:
        raise ValueError("rqmc needs n_blocks >= 2 (the digital shifts "
                         "are the independent replicates)")
    if n_paths is None:
        n_paths = cfg.n_paths
    if start is None:
        start = cfg.s1
    legs = tuple(SwapLeg(*l) for l in legs)
    o = netting_oracle_g2(cfg, g, market, legs, freq=freq, start=start,
                          quantile=quantile, hazard=hazard,
                          recovery=recovery)
    wc, wo, wf = _surv_weights(o.dates, hazard, hazard_own)
    lgd_c, lgd_o = 1.0 - recovery, 1.0 - recovery_own
    bx = tuple(lgd_c * c - lgd_o * w for c, w in zip(wc, wo))
    by = tuple(lgd_o * w for w in wo)
    fx = tuple((spread_borrow - spread_lend) * w for w in wf)
    fy = tuple(spread_lend * w for w in wf)
    bil = ((bx, by, bx), (fx, fy, wf))
    pfe = jnp.asarray(o.pfe, jnp.float32)
    out = _netting_g2_fn(cfg, g, legs, float(freq), float(start),
                         _haz(hazard), float(recovery), int(n_paths),
                         int(n_blocks), bool(rqmc), mesh, bil)(
        key, market, pfe)
    tenor_max = max(l.tenor for l in legs)
    prof = ExposureProfile(
        dates=exposure_dates(cfg, tenor_max, freq, start), ee=out[0],
        ee_std_error=out[1], ee_raw=out[2], beta=out[3], pfe=pfe,
        exceed=out[4], epe=out[5], n_paths=int(n_paths) * int(n_blocks))
    base = CVAResult(cva=out[6], std_error=out[7], raw_cva=out[8],
                     raw_std_error=out[9], beta=out[10],
                     hazard_delta=out[11], profile=prof)
    (bcva, bcva_se, _, _, _), (fva, fva_se, _, _, _) = out[12], out[13]
    dm = jnp.asarray(o.disc_swap, jnp.float32)
    ene = out[0] - dm
    wcj = jnp.asarray(wc, jnp.float32)
    woj = jnp.asarray(wo, jnp.float32)
    wfj = jnp.asarray(wf, jnp.float32)
    return BilateralResult(
        bcva=bcva, bcva_se=bcva_se, fva=fva, fva_se=fva_se,
        cva=lgd_c * jnp.dot(wcj, out[0]), dva=lgd_o * jnp.dot(woj, ene),
        fca=spread_borrow * jnp.dot(wfj, out[0]),
        fba=spread_lend * jnp.dot(wfj, ene), ene=ene, base=base)


# ---------------------------------------------------------------------------
# G2++ collateral twin (threshold-H CSA, MPoR = lag reset periods).
# The margin-call value V_s and the exposure value V_t live on the
# 4-d Gaussian (x_s, y_s, x_t, y_t); tilting by e^{-I_t} (the t-forward
# measure) shifts every mean by -cov(., I_t), all five covariances from
# _g2_functional_cov — the sampler's own matrix.  lag=0 collapses by the
# pathwise identity min(V, H)^+ = V^+ - (V - H)^+ to two uncollateralized
# EE calls; lag>=1 is the triple quadrature
#   EE_c = P(0,t) int phi(z1) [ sum_panels GL(y_s) int phi(z3)
#                                E[(V_t - K - C)^+ | x_s, y_s, x_t] ]
# with y_s panel edges at the roots of V_s = H (the kink of
# C = (V_s - H)^+, so each panel integrand is analytic) and the
# innermost expectation the exact row-segment closed form in
# STANDARDIZED y_t coordinates: the conditional variance of y_t given
# (x_s, y_s, x_t) is homoskedastic, so folding e^{-Bb mu4} into each
# row's lam puts every row on one shared [-10, 10] unit scan grid.
# ---------------------------------------------------------------------------


def _g2_csa_cov(g, s: float, t: float):
    """Tilted means m4 = -cov(., I_t) and covariance S of
    (x_s, y_s, x_t, y_t), plus the conditioning chain
    (sd1, b2, sd2, b3, sd3, b4, sd4) for the sequential quadrature."""
    from .models.g2pp import _g2_functional_cov

    C5 = _g2_functional_cov(g, (("u", s, 1.0, 0.0), ("u", s, 0.0, 1.0),
                                ("u", t, 1.0, 0.0), ("u", t, 0.0, 1.0),
                                ("I", t)))
    m4 = -C5[:4, 4]
    S = C5[:4, :4]
    sd1 = math.sqrt(S[0, 0])
    b2 = S[0, 1] / S[0, 0]
    sd2 = math.sqrt(S[1, 1] - S[0, 1] ** 2 / S[0, 0])
    b3 = np.linalg.solve(S[:2, :2], S[:2, 2])
    sd3 = math.sqrt(S[2, 2] - S[2, :2] @ b3)
    b4 = np.linalg.solve(S[:3, :3], S[:3, 3])
    sd4 = math.sqrt(S[3, 3] - S[3, :3] @ b4)
    return m4, S, (sd1, b2, sd2, b3, sd3, b4, sd4)


def _g2_csa_rows(g, lam_s, Ba_s, Bb_s, K_s: float, lam, Ba, Bb,
                 H: float, s: float, t: float, *, tilted: bool,
                 n_outer: int, n_per: int, n_mid: int):
    """Flattened (row_lx, row_K_minus_Kt, row_weight) of the lag>=1
    triple quadrature: rows are (x_s, y_s panel node, x_t node) triples
    in STANDARDIZED y_t coordinates (mu=0, s=1 after folding the
    conditional mean into lam), K column holds C = (V_s - H)^+ (add
    K_t + level before the segment call), weights include all three
    quadrature layers.  tilted=False zeroes the means (risk-neutral
    law, for the PFE CDF)."""
    m4, _, (sd1, b2, sd2, b3, sd3, b4, sd4) = _g2_csa_cov(g, s, t)
    if not tilted:
        m4 = np.zeros(4)
    z1 = np.linspace(-8.0, 8.0, n_outer)
    w1 = np.full(n_outer, z1[1] - z1[0])
    w1[0] = w1[-1] = 0.5 * (z1[1] - z1[0])
    w1 *= np.exp(-0.5 * z1 * z1) / math.sqrt(2.0 * math.pi)
    z3 = np.linspace(-8.0, 8.0, n_mid)
    w3 = np.full(n_mid, z3[1] - z3[0])
    w3[0] = w3[-1] = 0.5 * (z3[1] - z3[0])
    w3 *= np.exp(-0.5 * z3 * z3) / math.sqrt(2.0 * math.pi)
    Bb_u = Bb * sd4
    rows_lx, rows_C, rows_w = [], [], []
    for x1, wx1 in zip(m4[0] + sd1 * z1, w1):
        mu2 = m4[1] + b2 * (x1 - m4[0])
        lx_s = lam_s * np.exp(-Ba_s * x1)
        segs = _v_segments(lx_s, Bb_s, K_s + H, mu2, sd2)
        # fixed +-{2,4,6} sigma cuts bound every GL panel to <= 2 sigma:
        # n_per nodes on a 16-sigma panel (the no-root case) would be
        # the dominant quadrature error otherwise
        cuts = [mu2 + k * sd2 for k in (-6.0, -4.0, -2.0, 0.0,
                                        2.0, 4.0, 6.0)]
        ys, wy = _panel_nodes([e for ab in segs for e in ab] + cuts,
                              mu2, sd2, n_per=n_per, width=8.0)
        n2 = len(ys)
        C = np.maximum(np.exp(-np.outer(ys, Bb_s)) @ lx_s - K_s - H, 0.0)
        mu3 = m4[2] + b3[0] * (x1 - m4[0]) + b3[1] * (ys - m4[1])
        xt = mu3[:, None] + sd3 * z3[None, :]               # (n2, n_mid)
        mu4 = (m4[3] + b4[0] * (x1 - m4[0])
               + b4[1] * (ys[:, None] - m4[1])
               + b4[2] * (xt - m4[2]))                      # (n2, n_mid)
        lx = lam[None, :] * np.exp(
            -Ba[None, :] * xt.reshape(-1, 1)
            - Bb[None, :] * mu4.reshape(-1, 1))             # (n2*n_mid, ncf)
        rows_lx.append(lx)
        rows_C.append(np.repeat(C, n_mid))
        rows_w.append((wx1 * np.outer(wy, w3)).ravel())
    return (np.concatenate(rows_lx), np.concatenate(rows_C),
            np.concatenate(rows_w), Bb_u)


def collateral_oracle_g2(cfg: HWConfig, g, market: MarketCurve, legs, *,
                         threshold: float = 0.01, lag: int = 1,
                         freq: float = 1.0, start: float | None = None,
                         quantile: float = 0.95, hazard: float = 0.02,
                         recovery: float = 0.4) -> OracleXVA:
    """fp64 collateralized G2++ exposure profile + CVA under the
    threshold-H, lag-period-MPoR CSA (module comment above).  lag=0 is
    two uncollateralized segment EEs (exact); lag>=1 is the triple
    quadrature (61 x panel-GL x 61 for EE; pinned against an
    independent dense 4-d tensor-grid trapezoid in tests).  PFE roots
    the mixture CDF on precomputed quadrature rows with a reused unit
    scan grid, bracketed above by the uncollateralized PFE."""
    if start is None:
        start = cfg.s1
    if lag < 0:
        raise ValueError("lag must be >= 0 reset periods")
    legs = tuple(SwapLeg(*l) for l in legs)
    H = float(threshold)
    mk = _g2_oracle_memo("csa", market, (cfg, g, legs, H, lag, freq,
                                         start, quantile, hazard,
                                         recovery))
    if mk in _G2_ORACLE_CACHE:
        return _G2_ORACLE_CACHE[mk]
    tenor_max = max(l.tenor for l in legs)
    dates = exposure_dates(cfg, tenor_max, freq, start)
    Ts_grid = np.linspace(0.0, cfg.t_final, cfg.n_mat)
    P = np.asarray(market.P, np.float64)
    ee, pfe, dm = [], [], []
    for j, t in enumerate(dates):
        lam, Ba, Bb, K = _g2_portfolio_terms(cfg, g, market, legs, t,
                                             freq, start)
        Pt = float(np.interp(t, Ts_grid, P))
        # exact martingale CV mean (uncollateralized discounted value)
        total = 0.0
        for leg in legs:
            if t >= start + leg.tenor - 1e-9:
                continue
            sg = -1.0 if leg.payer else 1.0
            sched = swap_schedule(cfg, leg.rate, leg.tenor, freq, start)
            alive = np.asarray(sched.times, np.float64) > t + 1e-9
            cs = np.asarray(sched.coupons, np.float64)
            P0i = np.interp(np.asarray(sched.times), Ts_grid, P)
            total += sg * (float(np.sum(alive * cs * P0i)) - Pt)
        dm.append(total)
        if j < lag:                       # uncollateralized head
            ee.append(Pt * _g2_net_ee(g, lam, Ba, Bb, K, t))
            pfe.append(_g2_net_pfe(g, lam, Ba, Bb, K, t, quantile))
            continue
        if lag == 0:
            # min(V, H)^+ = V^+ - (V - H)^+, and the PFE caps at H
            ee.append(Pt * (_g2_net_ee(g, lam, Ba, Bb, K, t)
                            - _g2_net_ee(g, lam, Ba, Bb, K + H, t)))
            pfe.append(min(_g2_net_pfe(g, lam, Ba, Bb, K, t, quantile),
                           H))
            continue
        s_date = dates[j - lag]
        lam_s, Ba_s, Bb_s, K_s = _g2_portfolio_terms(cfg, g, market,
                                                     legs, s_date, freq,
                                                     start)
        lx, Cr, wr, Bb_u = _g2_csa_rows(
            g, lam_s, Ba_s, Bb_s, K_s, lam, Ba, Bb, H, s_date, t,
            tilted=True, n_outer=61, n_per=10, n_mid=61)
        # coarse scan is safe: |Bb sd4| << 1 so V is slowly varying in
        # the unit coordinate; chunk rows to bound the scan temporaries
        total_ee = 0.0
        for c0 in range(0, lx.shape[0], 32768):
            sl = slice(c0, c0 + 32768)
            Kr = K + Cr[sl]
            A, Bseg, msk = _v_segments_rows(lx[sl], Bb_u, Kr, 0.0, 1.0,
                                            width=8.0, res=25.0,
                                            iters=60)
            inner = _ee_rows(lx[sl], Bb_u, Kr, 0.0, 1.0, A, Bseg, msk)
            total_ee += float(wr[sl] @ inner)
        ee.append(Pt * total_ee)
        # PFE on the untilted rows: reuse one reduced-res unit grid
        # (accuracy gate is the MC exceedance tolerance ~6e-3, so the
        # probe quadrature runs at reduced node counts)
        lx0, Cr0, wr0, _ = _g2_csa_rows(
            g, lam_s, Ba_s, Bb_s, K_s, lam, Ba, Bb, H, s_date, t,
            tilted=False, n_outer=25, n_per=8, n_mid=25)
        grid0 = _v_grid_rows(lx0, Bb_u, 0.0, 1.0, width=6.0, res=25.0)

        def cdf(v):
            Av, Bv, mv = _v_segments_rows(lx0, Bb_u, K + Cr0 + v, 0.0,
                                          1.0, width=6.0, res=25.0,
                                          iters=45, grid=grid0)
            return 1.0 - float(wr0 @ _mass_rows(0.0, 1.0, Av, Bv, mv))

        hi0 = _g2_net_pfe(g, lam, Ba, Bb, K, t, quantile)  # dominance
        pfe.append(_pfe_root(cdf, quantile, hi=max(hi0, 1e-9)))
    pd, dpd = _pd_weights(dates, hazard)
    lgd = 1.0 - recovery
    cva = lgd * sum(p * e for p, e in zip(pd, ee))
    hdelta = lgd * sum(p * e for p, e in zip(dpd, ee))
    out = OracleXVA(dates=dates, ee=tuple(ee), pfe=tuple(pfe),
                    disc_swap=tuple(dm), epe=sum(ee) / len(ee),
                    cva=cva, hazard_delta=hdelta)
    _G2_ORACLE_CACHE[mk] = out
    return out


@lru_cache(maxsize=None)
def _collateral_g2_fn(cfg: HWConfig, g, legs: tuple, H: float, lag: int,
                      freq: float, start: float, hazard: float,
                      recovery: float, n_paths: int, n_blocks: int,
                      rqmc: bool, mesh):
    """G2++ netting kernel with the CSA overlay: per path, C_j is the
    lagged thresholded value readout of the value path the kernel
    already carries and the exposure sample is (V_j - C_j)^+; the CV
    stays the discounted UNcollateralized value at its exact martingale
    mean (collateral only truncates, the correlation survives)."""
    from .models.g2pp import _B, _g2_functional_chol, _v_integral

    tenor_max = max(l.tenor for l in legs)
    dates = exposure_dates(cfg, tenor_max, freq, start)
    m = len(dates)
    specs = tuple([s for t in dates
                   for s in (("u", t, 1.0, 0.0), ("u", t, 0.0, 1.0))]
                  + [("I", t) for t in dates])
    LT = jnp.asarray(_g2_functional_chol(g, specs))
    d0 = jnp.asarray([-0.5 * _v_integral(g, t) for t in dates],
                     jnp.float32)
    scheds = [swap_schedule(cfg, l.rate, l.tenor, freq, start)
              for l in legs]
    sgs = [(-1.0 if l.payer else 1.0) for l in legs]
    ncf = sum(len(s.times) for s in scheds)
    BaM = np.zeros((m, ncf))
    BbM = np.zeros((m, ncf))
    facM = np.zeros((m, ncf))
    cpM = np.zeros((m, ncf))
    timesC = np.concatenate([np.asarray(s.times) for s in scheds])
    Kv = np.zeros(m)
    col0 = 0
    for leg, sched, sg in zip(legs, scheds, sgs):
        nl = len(sched.times)
        for j, t in enumerate(dates):
            if t >= start + leg.tenor - 1e-9:
                continue
            Kv[j] += sg
            for i, T_i in enumerate(sched.times):
                if T_i <= t + 1e-9:
                    continue
                c = col0 + i
                BaM[j, c] = _B(g.a, T_i - t)
                BbM[j, c] = _B(g.b, T_i - t)
                vadj = 0.5 * (_v_integral(g, T_i - t)
                              - _v_integral(g, T_i) + _v_integral(g, t))
                facM[j, c] = sg * sched.coupons[i] * math.exp(vadj)
                cpM[j, c] = sg * sched.coupons[i]
        col0 += nl
    BaJ, BbJ = jnp.asarray(BaM, jnp.float32), jnp.asarray(BbM, jnp.float32)
    facJ = jnp.asarray(facM, jnp.float32)
    cpJ = jnp.asarray(cpM, jnp.float32)
    KvJ = jnp.asarray(Kv, jnp.float32)
    timesJ = jnp.asarray(timesC, jnp.float32)
    pd, dpd = _pd_weights(dates, hazard)
    pdw = jnp.asarray(pd, jnp.float32)
    dpdw = jnp.asarray(dpd, jnp.float32)
    lgd = 1.0 - recovery

    def compute(key, market, pfe):
        Pt = hw.interp_curve(market.P, jnp.asarray(dates, jnp.float32),
                             cfg)
        P0i = hw.interp_curve(market.P, timesJ, cfg)
        lam = facJ * (P0i[None, :] / Pt[:, None])
        disc0 = Pt * jnp.exp(d0)
        cv_mean = jnp.sum(cpJ * P0i[None, :], axis=1) - KvJ * Pt

        def block(bi):
            xn = pmesh.block_normals(key, bi, n_paths, 3 * m, rqmc)
            z = jnp.dot(xn, LT, preferred_element_type=jnp.float32,
                        precision=cfg.matmul_precision)

            def leg(sgn):
                x = sgn * z[:, 0:2 * m:2]
                y = sgn * z[:, 1:2 * m:2]
                I = sgn * z[:, 2 * m:]
                V = jnp.sum(lam[None, :, :]
                            * jnp.exp(-BaJ[None, :, :] * x[:, :, None]
                                      - BbJ[None, :, :] * y[:, :, None]),
                            axis=2) - KvJ[None, :]
                posted = jnp.maximum(V - H, 0.0)
                if lag == 0:
                    C = posted
                else:
                    C = jnp.concatenate(
                        [jnp.zeros_like(V[:, :lag]), posted[:, :m - lag]],
                        axis=1)
                Ex = V - C
                D = disc0[None, :] * jnp.exp(-I)
                X = D * jnp.maximum(Ex, 0.0)
                Y = D * V
                E = (Ex > pfe[None, :]).astype(jnp.float32)
                return X, Y, E

            Xp, Yp, Ep = leg(1.0)
            Xm, Ym, Em = leg(-1.0)
            X, Y = 0.5 * (Xp + Xm), 0.5 * (Yp + Ym)
            E = 0.5 * (Ep + Em)
            Xc = jnp.dot(X, pdw)
            Yc = jnp.dot(Y, pdw)
            per_date = jnp.concatenate([
                jnp.sum(X, axis=0), jnp.sum(X * X, axis=0),
                jnp.sum(Y, axis=0), jnp.sum(Y * Y, axis=0),
                jnp.sum(X * Y, axis=0), jnp.sum(E, axis=0)])
            agg = jnp.stack([jnp.sum(Xc), jnp.sum(Xc * Xc), jnp.sum(Yc),
                             jnp.sum(Yc * Yc), jnp.sum(Xc * Yc)])
            return jnp.concatenate([per_date, agg])

        per_block = pmesh.map_blocks(block, n_blocks, mesh)
        return _profile_reduce(per_block, m, n_paths, n_blocks, rqmc,
                               cv_mean, pdw, dpdw, lgd)

    return jax.jit(compute)


def price_collateral_g2(cfg: HWConfig, g, key, market: MarketCurve,
                        legs, *, threshold: float = 0.01, lag: int = 1,
                        freq: float = 1.0, start: float | None = None,
                        quantile: float = 0.95, hazard: float = 0.02,
                        recovery: float = 0.4,
                        n_paths: int | None = None, n_blocks: int = 1,
                        rqmc: bool = False, mesh=None) -> CVAResult:
    """G2++ twin of ``price_collateral``: collateralized exposure + CVA
    under the threshold-H, lag-period-MPoR CSA on the exactly-sampled
    (x, y, I) states.  fp64 oracle: ``collateral_oracle_g2``."""
    if rqmc and n_blocks < 2:
        raise ValueError("rqmc needs n_blocks >= 2 (the digital shifts "
                         "are the independent replicates)")
    if n_paths is None:
        n_paths = cfg.n_paths
    if start is None:
        start = cfg.s1
    legs = tuple(SwapLeg(*l) for l in legs)
    o = collateral_oracle_g2(cfg, g, market, legs, threshold=threshold,
                             lag=lag, freq=freq, start=start,
                             quantile=quantile, hazard=hazard,
                             recovery=recovery)
    pfe = jnp.asarray(o.pfe, jnp.float32)
    out = _collateral_g2_fn(cfg, g, legs, float(threshold), int(lag),
                            float(freq), float(start), _haz(hazard),
                            float(recovery), int(n_paths), int(n_blocks),
                            bool(rqmc), mesh)(key, market, pfe)
    tenor_max = max(l.tenor for l in legs)
    prof = ExposureProfile(
        dates=exposure_dates(cfg, tenor_max, freq, start), ee=out[0],
        ee_std_error=out[1], ee_raw=out[2], beta=out[3], pfe=pfe,
        exceed=out[4], epe=out[5], n_paths=int(n_paths) * int(n_blocks))
    return CVAResult(cva=out[6], std_error=out[7], raw_cva=out[8],
                     raw_std_error=out[9], beta=out[10],
                     hazard_delta=out[11], profile=prof)


# ---------------------------------------------------------------------------
# Wrong-way risk: stochastic default intensity lambda_t = lambda0 + gamma r_t
# (the Hull-White WWR model: default arrives as the first jump of a Cox
# process whose intensity is AFFINE in the short rate, so the integrated
# hazard Lambda_t = lambda0 t + gamma int_0^t r ds = lambda0 t + gamma I_t
# is a linear functional the engine already samples exactly).  Discrete
# CVA with default bucketed between reset dates, exposure at the right
# endpoint (same convention as _pd_weights):
#
#   CVA = LGD sum_j E[(e^{-Lambda_{t_{j-1}}} - e^{-Lambda_{t_j}})
#                     e^{-I_{t_j}} V_j^+]
#
# Each term is TWO Gaussian exponential tilts of the same netted payoff:
# e^{-Lambda_s - I_t} (s = t_{j-1}) shifts the r_t mean by
# -(gamma cov(r_t, I_s) + cov(r_t, I_t)) with constant
# exp(-lambda0 s - gamma i_s - i_t + Var(gamma I_s + I_t)/2), and
# e^{-Lambda_t - I_t} = e^{-lambda0 t - (1+gamma) I_t - gamma-det} shifts
# by -(1+gamma) cov(r_t, I_t) — so the oracle is closed form via the
# SAME segment decomposition as the netting oracle, and gamma = 0
# reduces it to pd_j x EE_j exactly (tested).  gamma > 0 makes default
# likely when rates are high: wrong-way for a payer swap, right-way for
# a receiver (sign pinned in tests).
#
# The MC kernel reuses the netted (r_j, I_j) states: per path
# S_j = e^{-lambda0 t_j - gamma Itot_j} and the CVA sample is
# sum_j (S_{j-1} - S_j) D_j V_j^+ with the SAME weighting of the signed
# value as CV at its exact two-tilt mean; dCVA/dgamma and dCVA/dlambda0
# are PATHWISE (differentiate the smooth S weights, the positive part
# is untouched), each CV'd against the matching derivative of the value
# channel at its exact fp64 mean.  Note the per-path bucket weight
# S_{j-1} - S_j can go negative when gamma Itot decreases faster than
# lambda0 t grows — the usual Gaussian-rates affine-intensity artifact;
# expectations (and the oracle) are exact for the discrete model as
# stated.  Reference anchor: this is the production extension of the
# reference's CVA-style option machinery (src/2_option_pricing.cu:14-35).
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _wwr_pair_stats(cfg: HWConfig, s: float, t: float):
    """fp64 per-unit-sig_st^2 cross-date moments (Var I_s, cov(I_s, I_t),
    cov(r_t, I_s)) for 0 <= s <= t (zeros at s = 0; per-step shocks are
    shared so covariances are prefix dot products of the shapes)."""
    if s <= 1e-12:
        return (0.0, 0.0, 0.0)
    from .bermudan import _step_index
    from .ops.engine_linear import _shock_shapes

    ns, nt = _step_index(cfg, s), _step_index(cfg, t)
    _, w_s = (np.asarray(a, np.float64) for a in _shock_shapes(cfg, ns))
    u_t, w_t = (np.asarray(a, np.float64) for a in _shock_shapes(cfg, nt))
    return (float(w_s @ w_s), float(w_s @ w_t[:ns]),
            float(w_s @ u_t[:ns]))


def _wwr_terms_closed(cfg: HWConfig, market: MarketCurve, legs: tuple,
                      freq: float, start: float, lambda0: float,
                      gamma: float, sigma: float):
    """fp64 per-date (contrib_j, cv_mean_j): the WWR CVA bucket terms
    E[(S_{j-1} - S_j) D_j V_j^+] (closed form, module comment) and the
    matching signed-value means E[(S_{j-1} - S_j) D_j V_j] (the MC CV
    targets — lognormal means under each tilt)."""
    legs = tuple(SwapLeg(*l) for l in legs)
    tenor_max = max(l.tenor for l in legs)
    dates = exposure_dates(cfg, tenor_max, freq, start)
    tables = hw.step_tables(cfg, float(sigma), cfg.sigma, jnp.float32)
    sig2 = float(tables.sig_st) ** 2
    c = 0.5 * (float(sigma) ** 2 - cfg.sigma ** 2)
    rA, rB, iA, iB = _det_rI(cfg, dates)
    stats = _date_stats(cfg, dates)
    contribs, cvm = [], []
    for j, t in enumerate(dates):
        lams, Bs, K = _portfolio_terms(cfg, market, legs, t, float(sigma),
                                       freq, start)
        uu, ww, uw = stats[j]
        v_r, v_I, c_rI = sig2 * uu, sig2 * ww, sig2 * uw
        r_det = rA[j] + c * rB[j]
        i_det = iA[j] + c * iB[j]
        s_r = math.sqrt(v_r)
        s_date = dates[j - 1] if j else 0.0
        i_det_s = (iA[j - 1] + c * iB[j - 1]) if j else 0.0
        wws, c_II, c_rIs = _wwr_pair_stats(cfg, s_date, t)
        wws, c_II, c_rIs = sig2 * wws, sig2 * c_II, sig2 * c_rIs
        gm = gamma
        # tilt A: e^{-Lambda_s - I_t}
        varA = gm * gm * wws + 2.0 * gm * c_II + v_I
        w0A = math.exp(-lambda0 * s_date - gm * i_det_s - i_det
                       + 0.5 * varA)
        muA = r_det - (gm * c_rIs + c_rI)
        # tilt B: e^{-Lambda_t - I_t}
        w0B = math.exp(-lambda0 * t - (1.0 + gm) * i_det
                       + 0.5 * (1.0 + gm) ** 2 * v_I)
        muB = r_det - (1.0 + gm) * c_rI

        def ee(mu):
            return _ee_segments(lams, Bs, K, mu, s_r,
                                _v_segments(lams, Bs, K, mu, s_r))

        def val(mu):
            return float(np.sum(
                lams * np.exp(-Bs * mu + 0.5 * Bs * Bs * v_r))) - K

        contribs.append(w0A * ee(muA) - w0B * ee(muB))
        cvm.append(w0A * val(muA) - w0B * val(muB))
    return dates, tuple(contribs), tuple(cvm)


class WWROracle(NamedTuple):
    dates: tuple
    contrib: tuple       # E[(S_{j-1} - S_j) D_j V_j^+] per date
    cv_mean: tuple       # E[(S_{j-1} - S_j) D_j V_j] per date
    cva: float
    cva_indep: float     # gamma = 0 CVA at the same lambda0
    wwr_ratio: float     # cva / cva_indep — the WWR multiplier
    gamma_delta: float   # dCVA/dgamma (fp64 central FD of closed form)
    lambda0_delta: float


def wwr_oracle(cfg: HWConfig, market: MarketCurve, legs, *,
               lambda0: float = 0.02, gamma: float = 0.5,
               freq: float = 1.0, start: float | None = None,
               recovery: float = 0.4,
               sigma: float | None = None) -> WWROracle:
    """fp64 closed-form wrong-way-risk CVA of a netted swap portfolio
    under lambda_t = lambda0 + gamma r_t (module comment above).  Exact
    on the discrete law: two segment-decomposition tilts per date.
    gamma = 0 reproduces ``netting_oracle(...).cva`` with
    hazard = lambda0 exactly; deltas are fp64 central differences of
    the closed form (h = 1e-6)."""
    if sigma is None:
        sigma = cfg.sigma
    if start is None:
        start = cfg.s1
    legs = tuple(SwapLeg(*l) for l in legs)
    lgd = 1.0 - recovery

    def cva_at(l0, gm):
        _, con, _ = _wwr_terms_closed(cfg, market, legs, freq, start,
                                      l0, gm, float(sigma))
        return lgd * sum(con)

    dates, contribs, cvm = _wwr_terms_closed(
        cfg, market, legs, freq, start, float(lambda0), float(gamma),
        float(sigma))
    cva = lgd * sum(contribs)
    cva0 = cva_at(float(lambda0), 0.0)
    h = 1e-6
    gd = (cva_at(float(lambda0), gamma + h)
          - cva_at(float(lambda0), gamma - h)) / (2.0 * h)
    ld = (cva_at(lambda0 + h, float(gamma))
          - cva_at(lambda0 - h, float(gamma))) / (2.0 * h)
    return WWROracle(dates=dates, contrib=contribs, cv_mean=cvm,
                     cva=cva, cva_indep=cva0, wwr_ratio=cva / cva0,
                     gamma_delta=gd, lambda0_delta=ld)


@lru_cache(maxsize=None)
def _wwr_fn(cfg: HWConfig, legs: tuple, freq: float, start: float,
            lambda0: float, gamma: float, recovery: float, n_paths: int,
            n_blocks: int, rqmc: bool, mesh):
    """Netted kernel with stochastic-intensity default weights: per path
    S_j = e^{-lambda0 t_j - gamma Itot_j} and the per-date exposure
    sample is (S_{j-1} - S_j) D_j V_j^+, CV = the same weighting of the
    signed value at its exact two-tilt mean.  Two extra aggregate
    channels carry the PATHWISE dCVA/dgamma and dCVA/dlambda0 (smooth
    weights differentiate; the positive part is untouched), each CV'd
    against its own derivative value channel."""
    from .bermudan import _functional_chol, _functional_det

    tenor_max = max(l.tenor for l in legs)
    dates = exposure_dates(cfg, tenor_max, freq, start)
    m = len(dates)
    specs = tuple([("r", t) for t in dates] + [("I", t) for t in dates])
    LT = jnp.asarray(_functional_chol(cfg, specs))
    scheds = [swap_schedule(cfg, l.rate, l.tenor, freq, start)
              for l in legs]
    sgs = [(-1.0 if l.payer else 1.0) for l in legs]
    Kv = np.zeros(m)
    for j, t in enumerate(dates):
        Kv[j] = sum(sg for l, sg in zip(legs, sgs)
                    if t < start + l.tenor - 1e-9)
    Kv = jnp.asarray(Kv, jnp.float32)
    tj = jnp.asarray(dates, jnp.float32)
    tprev = jnp.concatenate([jnp.zeros(1, jnp.float32), tj[:-1]])
    ones = jnp.ones(m, jnp.float32)
    zeros = jnp.zeros(m, jnp.float32)
    lgd = 1.0 - recovery
    l0 = jnp.float32(lambda0)
    gm = jnp.float32(gamma)

    def compute(key, sigma, market, pfe, cvm, mg, ml):
        tables = hw.step_tables(cfg, sigma, cfg.sigma, jnp.float32)
        det = _functional_det(cfg, sigma, specs)
        r_det, i_det = det[:m], det[m:]
        lam_rows, B_rows = [], []
        for j, t in enumerate(dates):
            ls, bs = [], []
            for leg, sched, sg in zip(legs, scheds, sgs):
                la, B = _bond_value_terms(cfg, sigma, market, sched, t)
                alive = 1.0 if t < start + leg.tenor - 1e-9 else 0.0
                ls.append(sg * alive * la)
                bs.append(B)
            lam_rows.append(jnp.concatenate(ls))
            B_rows.append(jnp.concatenate(bs))
        lam = jnp.stack(lam_rows)
        B = jnp.stack(B_rows)

        def block(bi):
            x = pmesh.block_normals(key, bi, n_paths, 2 * m, rqmc)
            z = tables.sig_st * jnp.dot(
                x, LT, preferred_element_type=jnp.float32,
                precision=cfg.matmul_precision)

            def leg(sgn):
                ro = r_det[None, :] + sgn * z[:, :m]
                Itot = i_det[None, :] + sgn * z[:, m:]
                D = jnp.exp(-Itot)
                V = jnp.sum(lam[None, :, :]
                            * jnp.exp(-B[None, :, :] * ro[:, :, None]),
                            axis=2) - Kv[None, :]
                S = jnp.exp(-l0 * tj[None, :] - gm * Itot)
                Sprev = jnp.concatenate(
                    [jnp.ones_like(S[:, :1]), S[:, :-1]], axis=1)
                Iprev = jnp.concatenate(
                    [jnp.zeros_like(Itot[:, :1]), Itot[:, :-1]], axis=1)
                w = Sprev - S
                Vp = jnp.maximum(V, 0.0)
                X = w * D * Vp
                Y = w * D * V
                E = (V > pfe[None, :]).astype(jnp.float32)
                dg = -Iprev * Sprev + Itot * S      # dw/dgamma
                dl = -tprev[None, :] * Sprev + tj[None, :] * S
                DV = D * Vp
                DY = D * V
                Zg = jnp.sum(dg * DV, axis=1)
                Wg = jnp.sum(dg * DY, axis=1)
                Zl = jnp.sum(dl * DV, axis=1)
                Wl = jnp.sum(dl * DY, axis=1)
                return X, Y, E, Zg, Wg, Zl, Wl

            p = leg(1.0)
            q = leg(-1.0)
            X, Y, E, Zg, Wg, Zl, Wl = (0.5 * (a + b)
                                       for a, b in zip(p, q))
            Xc = jnp.sum(X, axis=1)
            Yc = jnp.sum(Y, axis=1)
            per_date = jnp.concatenate([
                jnp.sum(X, axis=0), jnp.sum(X * X, axis=0),
                jnp.sum(Y, axis=0), jnp.sum(Y * Y, axis=0),
                jnp.sum(X * Y, axis=0), jnp.sum(E, axis=0)])
            agg = jnp.stack([
                jnp.sum(Xc), jnp.sum(Xc * Xc), jnp.sum(Yc),
                jnp.sum(Yc * Yc), jnp.sum(Xc * Yc),
                jnp.sum(Zg), jnp.sum(Zg * Zg), jnp.sum(Wg),
                jnp.sum(Wg * Wg), jnp.sum(Zg * Wg),
                jnp.sum(Zl), jnp.sum(Zl * Zl), jnp.sum(Wl),
                jnp.sum(Wl * Wl), jnp.sum(Zl * Wl)])
            return jnp.concatenate([per_date, agg])

        per_block = pmesh.map_blocks(block, n_blocks, mesh)
        return _profile_reduce(per_block, m, n_paths, n_blocks, rqmc,
                               cvm, ones, zeros, lgd,
                               extra_means=(mg, ml))

    return jax.jit(compute)


class WWRResult(NamedTuple):
    cva: jax.Array
    std_error: jax.Array
    raw_cva: jax.Array
    raw_std_error: jax.Array
    beta: jax.Array
    gamma_delta: jax.Array       # pathwise dCVA/dgamma, CV'd
    gamma_delta_se: jax.Array
    lambda0_delta: jax.Array     # pathwise dCVA/dlambda0, CV'd
    lambda0_delta_se: jax.Array
    profile: ExposureProfile     # per-date WWR bucket contributions


def price_wwr(cfg: HWConfig, key, market: MarketCurve, legs, *,
              lambda0: float = 0.02, gamma: float = 0.5,
              freq: float = 1.0, start: float | None = None,
              quantile: float = 0.95, recovery: float = 0.4,
              sigma=None, n_paths: int | None = None, n_blocks: int = 1,
              rqmc: bool = False, mesh=None) -> WWRResult:
    """Monte Carlo wrong-way-risk CVA of a netted swap portfolio under
    lambda_t = lambda0 + gamma r_t, with pathwise gamma / lambda0
    deltas.  fp64 oracle: ``wwr_oracle`` (closed form; deltas pinned
    against its central differences).  The profile's PFE/exceed channel
    is the default-free netted quantile (default weighting does not
    change the market-value distribution)."""
    if rqmc and n_blocks < 2:
        raise ValueError("rqmc needs n_blocks >= 2 (the digital shifts "
                         "are the independent replicates)")
    if sigma is None:
        sigma = cfg.sigma
    if n_paths is None:
        n_paths = cfg.n_paths
    if start is None:
        start = cfg.s1
    legs = tuple(SwapLeg(*l) for l in legs)
    on = netting_oracle(cfg, market, legs, freq=freq, start=start,
                        quantile=quantile, hazard=lambda0,
                        recovery=recovery, sigma=float(sigma))
    _, _, cvm = _wwr_terms_closed(cfg, market, legs, float(freq),
                                  float(start), float(lambda0),
                                  float(gamma), float(sigma))
    h = 1e-6

    def cv_sum(l0, gmv):
        _, _, c = _wwr_terms_closed(cfg, market, legs, float(freq),
                                    float(start), l0, gmv, float(sigma))
        return sum(c)

    mg = (cv_sum(float(lambda0), gamma + h)
          - cv_sum(float(lambda0), gamma - h)) / (2.0 * h)
    ml = (cv_sum(lambda0 + h, float(gamma))
          - cv_sum(lambda0 - h, float(gamma))) / (2.0 * h)
    pfe = jnp.asarray(on.pfe, jnp.float32)
    out = _wwr_fn(cfg, legs, float(freq), float(start), float(lambda0),
                  float(gamma), float(recovery), int(n_paths),
                  int(n_blocks), bool(rqmc), mesh)(
        key, jnp.asarray(sigma, jnp.float32), market, pfe,
        jnp.asarray(cvm, jnp.float32), jnp.float32(mg), jnp.float32(ml))
    lgd = 1.0 - recovery
    tenor_max = max(l.tenor for l in legs)
    prof = ExposureProfile(
        dates=exposure_dates(cfg, tenor_max, freq, start), ee=out[0],
        ee_std_error=out[1], ee_raw=out[2], beta=out[3], pfe=pfe,
        exceed=out[4], epe=out[5], n_paths=int(n_paths) * int(n_blocks))
    (gd, gd_se, _, _, _), (ld, ld_se, _, _, _) = out[12], out[13]
    return WWRResult(cva=out[6], std_error=out[7], raw_cva=out[8],
                     raw_std_error=out[9], beta=out[10],
                     gamma_delta=lgd * gd, gamma_delta_se=lgd * gd_se,
                     lambda0_delta=lgd * ld,
                     lambda0_delta_se=lgd * ld_se, profile=prof)


# ---------------------------------------------------------------------------
# G2++ WWR twin: lambda_t = lambda0 + gamma r_t with r = x + y + phi(t),
# so Lambda_t = lambda0 t + gamma (phi_det(t) + I_t) with
# phi_det(t) = -ln P(0,t) + V(t)/2 (so that E[e^{-int r}] = P(0,t)) and
# I_t the centered Gaussian integral the sampler already draws.  The
# two tilts shift the (x_t, y_t) means by -cov(., gamma I_s + I_t) and
# -(1+gamma) cov(., I_t); the inner EE is the netted row-segment
# machinery at the shifted means (the centered covariance is
# tilt-invariant).  gamma = 0 reduces to pd_j x the netted G2 EE.
# ---------------------------------------------------------------------------


def _g2_phi_det(g, market: MarketCurve, cfg: HWConfig, t: float) -> float:
    """Deterministic part of int_0^t r ds in G2++ fitted to the curve."""
    from .models.g2pp import _v_integral

    Ts = np.linspace(0.0, cfg.t_final, cfg.n_mat)
    Pt = float(np.interp(t, Ts, np.asarray(market.P, np.float64)))
    return -math.log(Pt) + 0.5 * _v_integral(g, t)


@lru_cache(maxsize=None)
def _g2_wwr_stats(g, s: float, t: float):
    """fp64 (cxIs, cyIs, cxIt, cyIt, VIs, cIsIt, VIt): covariances of
    (x_t, y_t) with the integrals at the bucket edges (zeros at s=0)."""
    from .models.g2pp import _g2_functional_cov

    if s <= 1e-12:
        C = _g2_functional_cov(g, (("u", t, 1.0, 0.0), ("u", t, 0.0, 1.0),
                                   ("I", t)))
        return (0.0, 0.0, float(C[0, 2]), float(C[1, 2]), 0.0, 0.0,
                float(C[2, 2]))
    C = _g2_functional_cov(g, (("u", t, 1.0, 0.0), ("u", t, 0.0, 1.0),
                               ("I", s), ("I", t)))
    return (float(C[0, 2]), float(C[1, 2]), float(C[0, 3]),
            float(C[1, 3]), float(C[2, 2]), float(C[2, 3]),
            float(C[3, 3]))


def _g2_wwr_terms_closed(cfg: HWConfig, g, market: MarketCurve,
                         legs: tuple, freq: float, start: float,
                         lambda0: float, gamma: float):
    """fp64 per-date (contrib_j, cv_mean_j) of the G2++ WWR CVA sum
    (module comment above)."""
    from .models.g2pp import _xy_cov

    legs = tuple(SwapLeg(*l) for l in legs)
    tenor_max = max(l.tenor for l in legs)
    dates = exposure_dates(cfg, tenor_max, freq, start)
    contribs, cvm = [], []
    for j, t in enumerate(dates):
        lam, Ba, Bb, K = _g2_portfolio_terms(cfg, g, market, legs, t,
                                             freq, start)
        s_date = dates[j - 1] if j else 0.0
        cxIs, cyIs, cxIt, cyIt, VIs, cIsIt, VIt = _g2_wwr_stats(
            g, s_date, t)
        sx, sy, rxy = _xy_cov(g, t)
        phs = _g2_phi_det(g, market, cfg, s_date) if j else 0.0
        pht = _g2_phi_det(g, market, cfg, t)
        gm = gamma
        varA = gm * gm * VIs + 2.0 * gm * cIsIt + VIt
        w0A = math.exp(-lambda0 * s_date - gm * phs - pht + 0.5 * varA)
        mA = (-(gm * cxIs + cxIt), -(gm * cyIs + cyIt))
        w0B = math.exp(-lambda0 * t - (1.0 + gm) * pht
                       + 0.5 * (1.0 + gm) ** 2 * VIt)
        mB = (-(1.0 + gm) * cxIt, -(1.0 + gm) * cyIt)

        def val(m):
            mx, my = m
            return float(np.sum(lam * np.exp(
                -Ba * mx - Bb * my
                + 0.5 * (Ba * Ba * sx * sx + 2.0 * Ba * Bb * rxy * sx * sy
                         + Bb * Bb * sy * sy)))) - K

        contribs.append(w0A * _g2_net_ee(g, lam, Ba, Bb, K, t, means=mA)
                        - w0B * _g2_net_ee(g, lam, Ba, Bb, K, t,
                                           means=mB))
        cvm.append(w0A * val(mA) - w0B * val(mB))
    return dates, tuple(contribs), tuple(cvm)


def wwr_oracle_g2(cfg: HWConfig, g, market: MarketCurve, legs, *,
                  lambda0: float = 0.02, gamma: float = 0.5,
                  freq: float = 1.0, start: float | None = None,
                  recovery: float = 0.4) -> WWROracle:
    """fp64 G2++ wrong-way-risk CVA of a netted portfolio under
    lambda_t = lambda0 + gamma r_t: two tilted netted-EE quadratures
    per date.  gamma = 0 reproduces ``netting_oracle_g2(...).cva`` with
    hazard = lambda0 to quadrature precision; deltas are fp64 central
    differences (h = 1e-6)."""
    if start is None:
        start = cfg.s1
    legs = tuple(SwapLeg(*l) for l in legs)
    mk = _g2_oracle_memo("wwr", market, (cfg, g, legs, lambda0, gamma,
                                         freq, start, recovery))
    if mk in _G2_ORACLE_CACHE:
        return _G2_ORACLE_CACHE[mk]
    lgd = 1.0 - recovery

    def cva_at(l0, gm):
        _, con, _ = _g2_wwr_terms_closed(cfg, g, market, legs, freq,
                                         start, l0, gm)
        return lgd * sum(con)

    dates, contribs, cvm = _g2_wwr_terms_closed(
        cfg, g, market, legs, freq, start, float(lambda0), float(gamma))
    cva = lgd * sum(contribs)
    cva0 = cva_at(float(lambda0), 0.0)
    h = 1e-6
    gd = (cva_at(float(lambda0), gamma + h)
          - cva_at(float(lambda0), gamma - h)) / (2.0 * h)
    ld = (cva_at(lambda0 + h, float(gamma))
          - cva_at(lambda0 - h, float(gamma))) / (2.0 * h)
    out = WWROracle(dates=dates, contrib=contribs, cv_mean=cvm,
                    cva=cva, cva_indep=cva0, wwr_ratio=cva / cva0,
                    gamma_delta=gd, lambda0_delta=ld)
    _G2_ORACLE_CACHE[mk] = out
    return out


@lru_cache(maxsize=None)
def _wwr_g2_fn(cfg: HWConfig, g, legs: tuple, freq: float, start: float,
               lambda0: float, gamma: float, recovery: float,
               n_paths: int, n_blocks: int, rqmc: bool, mesh):
    """G2++ twin of ``_wwr_fn``: the netted G2 kernel with
    stochastic-intensity default weights S_j = e^{-lambda0 t_j
    - gamma (phi_det_j + I_j)} and pathwise gamma / lambda0 delta
    channels (Itot = phi_det + I is the full integrated short rate)."""
    from .models.g2pp import _B, _g2_functional_chol, _v_integral

    tenor_max = max(l.tenor for l in legs)
    dates = exposure_dates(cfg, tenor_max, freq, start)
    m = len(dates)
    specs = tuple([s for t in dates
                   for s in (("u", t, 1.0, 0.0), ("u", t, 0.0, 1.0))]
                  + [("I", t) for t in dates])
    LT = jnp.asarray(_g2_functional_chol(g, specs))
    d0 = jnp.asarray([-0.5 * _v_integral(g, t) for t in dates],
                     jnp.float32)
    scheds = [swap_schedule(cfg, l.rate, l.tenor, freq, start)
              for l in legs]
    sgs = [(-1.0 if l.payer else 1.0) for l in legs]
    ncf = sum(len(s.times) for s in scheds)
    BaM = np.zeros((m, ncf))
    BbM = np.zeros((m, ncf))
    facM = np.zeros((m, ncf))
    timesC = np.concatenate([np.asarray(s.times) for s in scheds])
    Kv = np.zeros(m)
    col0 = 0
    for leg, sched, sg in zip(legs, scheds, sgs):
        nl = len(sched.times)
        for j, t in enumerate(dates):
            if t >= start + leg.tenor - 1e-9:
                continue
            Kv[j] += sg
            for i, T_i in enumerate(sched.times):
                if T_i <= t + 1e-9:
                    continue
                c = col0 + i
                BaM[j, c] = _B(g.a, T_i - t)
                BbM[j, c] = _B(g.b, T_i - t)
                vadj = 0.5 * (_v_integral(g, T_i - t)
                              - _v_integral(g, T_i) + _v_integral(g, t))
                facM[j, c] = sg * sched.coupons[i] * math.exp(vadj)
        col0 += nl
    BaJ, BbJ = jnp.asarray(BaM, jnp.float32), jnp.asarray(BbM, jnp.float32)
    facJ = jnp.asarray(facM, jnp.float32)
    KvJ = jnp.asarray(Kv, jnp.float32)
    timesJ = jnp.asarray(timesC, jnp.float32)
    tj = jnp.asarray(dates, jnp.float32)
    tprev = jnp.concatenate([jnp.zeros(1, jnp.float32), tj[:-1]])
    ones = jnp.ones(m, jnp.float32)
    zeros = jnp.zeros(m, jnp.float32)
    lgd = 1.0 - recovery
    l0 = jnp.float32(lambda0)
    gm = jnp.float32(gamma)

    def compute(key, market, pfe, cvm, mg, ml):
        Pt = hw.interp_curve(market.P, tj, cfg)
        P0i = hw.interp_curve(market.P, timesJ, cfg)
        lam = facJ * (P0i[None, :] / Pt[:, None])
        disc0 = Pt * jnp.exp(d0)
        phi = -jnp.log(Pt) - d0                       # phi_det per date

        def block(bi):
            xn = pmesh.block_normals(key, bi, n_paths, 3 * m, rqmc)
            z = jnp.dot(xn, LT, preferred_element_type=jnp.float32,
                        precision=cfg.matmul_precision)

            def leg(sgn):
                x = sgn * z[:, 0:2 * m:2]
                y = sgn * z[:, 1:2 * m:2]
                I = sgn * z[:, 2 * m:]
                V = jnp.sum(lam[None, :, :]
                            * jnp.exp(-BaJ[None, :, :] * x[:, :, None]
                                      - BbJ[None, :, :] * y[:, :, None]),
                            axis=2) - KvJ[None, :]
                D = disc0[None, :] * jnp.exp(-I)
                Itot = phi[None, :] + I
                S = jnp.exp(-l0 * tj[None, :] - gm * Itot)
                Sprev = jnp.concatenate(
                    [jnp.ones_like(S[:, :1]), S[:, :-1]], axis=1)
                Iprev = jnp.concatenate(
                    [jnp.zeros_like(Itot[:, :1]), Itot[:, :-1]], axis=1)
                w = Sprev - S
                Vp = jnp.maximum(V, 0.0)
                X = w * D * Vp
                Y = w * D * V
                E = (V > pfe[None, :]).astype(jnp.float32)
                dg = -Iprev * Sprev + Itot * S
                dl = -tprev[None, :] * Sprev + tj[None, :] * S
                DV = D * Vp
                DY = D * V
                return (X, Y, E, jnp.sum(dg * DV, axis=1),
                        jnp.sum(dg * DY, axis=1),
                        jnp.sum(dl * DV, axis=1),
                        jnp.sum(dl * DY, axis=1))

            p = leg(1.0)
            q = leg(-1.0)
            X, Y, E, Zg, Wg, Zl, Wl = (0.5 * (a + b)
                                       for a, b in zip(p, q))
            Xc = jnp.sum(X, axis=1)
            Yc = jnp.sum(Y, axis=1)
            per_date = jnp.concatenate([
                jnp.sum(X, axis=0), jnp.sum(X * X, axis=0),
                jnp.sum(Y, axis=0), jnp.sum(Y * Y, axis=0),
                jnp.sum(X * Y, axis=0), jnp.sum(E, axis=0)])
            agg = jnp.stack([
                jnp.sum(Xc), jnp.sum(Xc * Xc), jnp.sum(Yc),
                jnp.sum(Yc * Yc), jnp.sum(Xc * Yc),
                jnp.sum(Zg), jnp.sum(Zg * Zg), jnp.sum(Wg),
                jnp.sum(Wg * Wg), jnp.sum(Zg * Wg),
                jnp.sum(Zl), jnp.sum(Zl * Zl), jnp.sum(Wl),
                jnp.sum(Wl * Wl), jnp.sum(Zl * Wl)])
            return jnp.concatenate([per_date, agg])

        per_block = pmesh.map_blocks(block, n_blocks, mesh)
        return _profile_reduce(per_block, m, n_paths, n_blocks, rqmc,
                               cvm, ones, zeros, lgd,
                               extra_means=(mg, ml))

    return jax.jit(compute)


def price_wwr_g2(cfg: HWConfig, g, key, market: MarketCurve, legs, *,
                 lambda0: float = 0.02, gamma: float = 0.5,
                 freq: float = 1.0, start: float | None = None,
                 quantile: float = 0.95, recovery: float = 0.4,
                 n_paths: int | None = None, n_blocks: int = 1,
                 rqmc: bool = False, mesh=None) -> WWRResult:
    """G2++ twin of ``price_wwr``: wrong-way-risk CVA + pathwise
    gamma / lambda0 deltas on the exactly-sampled netted (x, y, I)
    states.  fp64 oracle: ``wwr_oracle_g2``."""
    if rqmc and n_blocks < 2:
        raise ValueError("rqmc needs n_blocks >= 2 (the digital shifts "
                         "are the independent replicates)")
    if n_paths is None:
        n_paths = cfg.n_paths
    if start is None:
        start = cfg.s1
    legs = tuple(SwapLeg(*l) for l in legs)
    on = netting_oracle_g2(cfg, g, market, legs, freq=freq, start=start,
                           quantile=quantile, hazard=lambda0,
                           recovery=recovery)
    _, _, cvm = _g2_wwr_terms_closed(cfg, g, market, legs, float(freq),
                                     float(start), float(lambda0),
                                     float(gamma))
    h = 1e-6

    def cv_sum(l0v, gmv):
        _, _, c = _g2_wwr_terms_closed(cfg, g, market, legs, float(freq),
                                       float(start), l0v, gmv)
        return sum(c)

    mg = (cv_sum(float(lambda0), gamma + h)
          - cv_sum(float(lambda0), gamma - h)) / (2.0 * h)
    ml = (cv_sum(lambda0 + h, float(gamma))
          - cv_sum(lambda0 - h, float(gamma))) / (2.0 * h)
    pfe = jnp.asarray(on.pfe, jnp.float32)
    out = _wwr_g2_fn(cfg, g, legs, float(freq), float(start),
                     float(lambda0), float(gamma), float(recovery),
                     int(n_paths), int(n_blocks), bool(rqmc), mesh)(
        key, market, pfe, jnp.asarray(cvm, jnp.float32),
        jnp.float32(mg), jnp.float32(ml))
    lgd = 1.0 - recovery
    tenor_max = max(l.tenor for l in legs)
    prof = ExposureProfile(
        dates=exposure_dates(cfg, tenor_max, freq, start), ee=out[0],
        ee_std_error=out[1], ee_raw=out[2], beta=out[3], pfe=pfe,
        exceed=out[4], epe=out[5], n_paths=int(n_paths) * int(n_blocks))
    (gd, gd_se, _, _, _), (ld, ld_se, _, _, _) = out[12], out[13]
    return WWRResult(cva=out[6], std_error=out[7], raw_cva=out[8],
                     raw_std_error=out[9], beta=out[10],
                     gamma_delta=lgd * gd, gamma_delta_se=lgd * gd_se,
                     lambda0_delta=lgd * ld,
                     lambda0_delta_se=lgd * ld_se, profile=prof)


# ---------------------------------------------------------------------------
# MVA: margin valuation adjustment for a dynamically posted initial
# margin.  IM is the SIMM-style delta-normal dynamic margin: at state
# s_t the loss over the margin period of risk delta is approximated by
# the portfolio gradient times the state increment, so
#
#   IM_t = z_q sqrt(g(s_t)^T Sigma_delta g(s_t)),    z_q = Phi^{-1}(q),
#
# with Sigma_delta the CONDITIONAL covariance of the state over
# [t, t + delta] (state-independent in a Gaussian model) and g the
# portfolio value gradient.  In Hull-White g = dV/dr = -W(r) with
# W(r) = sum_i lam_i B_i e^{-B_i r}, so IM_t = z_q s_delta |W(r_t)| and
#
#   MVA = spread_im sum_j Delta_j e^{-(h_c + h_o) t_j} E[e^{-I_j} IM_j]
#
# (IM funded until the earlier default, flat hazards).  E[e^{-I} |W|]
# is CLOSED FORM: the e^{-I} tilt shifts the r-mean, |W| = 2 W^+ - W,
# and W^+ is the segment decomposition of one more exponential sum —
# so the oracle is exact and the MC CV is the SIGNED gradient channel
# D_j W_j at its exact lognormal mean.  The G2++ twin has
# g = (-sum lam Ba e^{.}, -sum lam Bb e^{.}) and
# IM = z_q sqrt(g' Sigma_delta g); the oracle is a 2-d tilted
# quadrature of the smooth integrand (no kinks: sqrt of a positive
# quadratic form), the CV is the QUADRATIC channel D Q,
# Q = g' Sigma_delta g, whose tilted mean is a double sum of lognormal
# moments.  delta is snapped to the step grid (HW) / used exactly (G2).
# ---------------------------------------------------------------------------


class MVAOracle(NamedTuple):
    dates: tuple
    delta: float        # margin period of risk actually used (snapped)
    im: tuple           # E[e^{-I_j} IM_j] per date (discounted margin)
    cv_mean: tuple      # E[e^{-I_j} W_j] (HW) / E[e^{-I_j} Q_j] (G2)
    s_cond: tuple       # conditional state std (HW) per date
    mva: float


class MVAResult(NamedTuple):
    mva: jax.Array
    std_error: jax.Array
    raw_mva: jax.Array
    raw_std_error: jax.Array
    beta: jax.Array
    im: jax.Array           # per-date E[D IM] estimates (CV'd)
    im_std_error: jax.Array
    dates: tuple
    delta: float


def _mva_weights(dates: tuple, freq: float, spread_im: float,
                 hazard, hazard_own):
    """Funding weights spread * Delta_j * S_c(t_j) S_o(t_j) (flat
    hazards or ``CreditCurve``s)."""
    from .credit import survival

    return tuple(spread_im * (1.0 / freq)
                 * survival(hazard, t) * survival(hazard_own, t)
                 for t in dates)


def mva_oracle(cfg: HWConfig, market: MarketCurve, legs, *,
               mpor: float = 0.1, quantile_im: float = 0.99,
               spread_im: float = 0.005, freq: float = 1.0,
               start: float | None = None, hazard: float = 0.02,
               hazard_own: float = 0.01,
               sigma: float | None = None) -> MVAOracle:
    """fp64 closed-form MVA of a netted portfolio under delta-normal
    dynamic IM (module comment above).  ``mpor`` is snapped to the step
    grid; E[D IM] per date is exact via the tilted segment
    decomposition of the gradient sum W."""
    if sigma is None:
        sigma = cfg.sigma
    if start is None:
        start = cfg.s1
    legs = tuple(SwapLeg(*l) for l in legs)
    tenor_max = max(l.tenor for l in legs)
    dates = exposure_dates(cfg, tenor_max, freq, start)
    delta = max(1, round(float(mpor) / cfg.dt)) * cfg.dt
    tables = hw.step_tables(cfg, float(sigma), cfg.sigma, jnp.float32)
    sig2 = float(tables.sig_st) ** 2
    c = 0.5 * (float(sigma) ** 2 - cfg.sigma ** 2)
    rA, rB, iA, iB = _det_rI(cfg, dates)
    stats = _date_stats(cfg, dates)
    zq = _NDTRI(quantile_im)
    im, cvm, s_cond = [], [], []
    for j, t in enumerate(dates):
        lams, Bs, K = _portfolio_terms(cfg, market, legs, t, float(sigma),
                                       freq, start)
        lamW = lams * Bs                      # W(r) = sum lamW e^{-B r}
        uu, ww, uw = stats[j]
        v_r, v_I, c_rI = sig2 * uu, sig2 * ww, sig2 * uw
        r_det = rA[j] + c * rB[j]
        i_det = iA[j] + c * iB[j]
        s_r = math.sqrt(v_r)
        # conditional std of r over [t, t + delta]
        uu_t, c_tu, _ = _pair_stats(cfg, t, t + delta)
        (uu_u, _, _), = _date_stats(cfg, (t + delta,))
        s_d = math.sqrt(sig2 * max(uu_u - c_tu * c_tu / uu_t, 0.0))
        s_cond.append(s_d)
        w0 = math.exp(-i_det + 0.5 * v_I)
        mu_t = r_det - c_rI
        # E_tilt[W] (lognormal) and E_tilt[W^+] (segments, K = 0)
        ew = float(np.sum(lamW * np.exp(-Bs * mu_t
                                        + 0.5 * Bs * Bs * v_r)))
        ewp = _ee_segments(lamW, Bs, 0.0, mu_t, s_r,
                           _v_segments(lamW, Bs, 0.0, mu_t, s_r))
        im.append(w0 * zq * s_d * (2.0 * ewp - ew))
        cvm.append(w0 * zq * s_d * ew)
    w = _mva_weights(dates, freq, spread_im, hazard, hazard_own)
    return MVAOracle(dates=dates, delta=delta, im=tuple(im),
                     cv_mean=tuple(cvm), s_cond=tuple(s_cond),
                     mva=sum(a * b for a, b in zip(w, im)))


@lru_cache(maxsize=None)
def _mva_fn(cfg: HWConfig, legs: tuple, freq: float, start: float,
            delta: float, quantile_im: float, spread_im: float,
            hazard: float, hazard_own: float, n_paths: int,
            n_blocks: int, rqmc: bool, mesh):
    """Netted kernel sampling the delta-normal IM: per path
    IM_j = z_q s_d_j |W_j(r_j)|, CV = the SIGNED gradient channel
    D_j z_q s_d_j W_j at its exact lognormal mean."""
    from .bermudan import _functional_chol, _functional_det

    tenor_max = max(l.tenor for l in legs)
    dates = exposure_dates(cfg, tenor_max, freq, start)
    m = len(dates)
    specs = tuple([("r", t) for t in dates] + [("I", t) for t in dates])
    LT = jnp.asarray(_functional_chol(cfg, specs))
    scheds = [swap_schedule(cfg, l.rate, l.tenor, freq, start)
              for l in legs]
    sgs = [(-1.0 if l.payer else 1.0) for l in legs]
    wj = jnp.asarray(_mva_weights(dates, freq, spread_im, hazard,
                                  hazard_own), jnp.float32)
    zeros = jnp.zeros(m, jnp.float32)
    zq = jnp.float32(_NDTRI(quantile_im))

    def compute(key, sigma, market, s_cond, cvm):
        tables = hw.step_tables(cfg, sigma, cfg.sigma, jnp.float32)
        det = _functional_det(cfg, sigma, specs)
        r_det, i_det = det[:m], det[m:]
        lam_rows, B_rows = [], []
        for j, t in enumerate(dates):
            ls, bs = [], []
            for leg, sched, sg in zip(legs, scheds, sgs):
                la, B = _bond_value_terms(cfg, sigma, market, sched, t)
                alive = 1.0 if t < start + leg.tenor - 1e-9 else 0.0
                ls.append(sg * alive * la)
                bs.append(B)
            lam_rows.append(jnp.concatenate(ls))
            B_rows.append(jnp.concatenate(bs))
        lam = jnp.stack(lam_rows)
        B = jnp.stack(B_rows)
        lamW = lam * B                      # gradient magnitude terms
        fac = zq * s_cond                   # (m,)

        def block(bi):
            x = pmesh.block_normals(key, bi, n_paths, 2 * m, rqmc)
            z = tables.sig_st * jnp.dot(
                x, LT, preferred_element_type=jnp.float32,
                precision=cfg.matmul_precision)

            def leg(sgn):
                ro = r_det[None, :] + sgn * z[:, :m]
                disc = jnp.exp(-(i_det[None, :] + sgn * z[:, m:]))
                W = jnp.sum(lamW[None, :, :]
                            * jnp.exp(-B[None, :, :] * ro[:, :, None]),
                            axis=2)
                X = disc * fac[None, :] * jnp.abs(W)
                Y = disc * fac[None, :] * W
                return X, Y

            Xp, Yp = leg(1.0)
            Xm, Ym = leg(-1.0)
            X, Y = 0.5 * (Xp + Xm), 0.5 * (Yp + Ym)
            Xc = jnp.dot(X, wj)
            Yc = jnp.dot(Y, wj)
            per_date = jnp.concatenate([
                jnp.sum(X, axis=0), jnp.sum(X * X, axis=0),
                jnp.sum(Y, axis=0), jnp.sum(Y * Y, axis=0),
                jnp.sum(X * Y, axis=0), jnp.zeros(m, jnp.float32)])
            agg = jnp.stack([jnp.sum(Xc), jnp.sum(Xc * Xc), jnp.sum(Yc),
                             jnp.sum(Yc * Yc), jnp.sum(Xc * Yc)])
            return jnp.concatenate([per_date, agg])

        per_block = pmesh.map_blocks(block, n_blocks, mesh)
        return _profile_reduce(per_block, m, n_paths, n_blocks, rqmc,
                               cvm, wj, zeros, 1.0)

    return jax.jit(compute)


def price_mva(cfg: HWConfig, key, market: MarketCurve, legs, *,
              mpor: float = 0.1, quantile_im: float = 0.99,
              spread_im: float = 0.005, freq: float = 1.0,
              start: float | None = None, hazard: float = 0.02,
              hazard_own: float = 0.01, sigma=None,
              n_paths: int | None = None, n_blocks: int = 1,
              rqmc: bool = False, mesh=None) -> MVAResult:
    """Monte Carlo MVA under delta-normal dynamic IM on the netted
    multi-date states.  fp64 oracle: ``mva_oracle`` (exact tilted
    segment decomposition of the gradient sum)."""
    if rqmc and n_blocks < 2:
        raise ValueError("rqmc needs n_blocks >= 2 (the digital shifts "
                         "are the independent replicates)")
    if sigma is None:
        sigma = cfg.sigma
    if n_paths is None:
        n_paths = cfg.n_paths
    if start is None:
        start = cfg.s1
    legs = tuple(SwapLeg(*l) for l in legs)
    o = mva_oracle(cfg, market, legs, mpor=mpor,
                   quantile_im=quantile_im, spread_im=spread_im,
                   freq=freq, start=start, hazard=hazard,
                   hazard_own=hazard_own, sigma=float(sigma))
    out = _mva_fn(cfg, legs, float(freq), float(start), float(o.delta),
                  float(quantile_im), float(spread_im), _haz(hazard),
                  _haz(hazard_own), int(n_paths), int(n_blocks),
                  bool(rqmc), mesh)(
        key, jnp.asarray(sigma, jnp.float32), market,
        jnp.asarray(o.s_cond, jnp.float32),
        jnp.asarray(o.cv_mean, jnp.float32))
    return MVAResult(mva=out[6], std_error=out[7], raw_mva=out[8],
                     raw_std_error=out[9], beta=out[10], im=out[0],
                     im_std_error=out[1], dates=o.dates, delta=o.delta)


@lru_cache(maxsize=None)
def _g2_cond_cov(g, t: float, delta: float):
    """fp64 conditional covariance of (x, y) over [t, t + delta] given
    the state at t (state-independent): the Schur complement of the
    4-d functional covariance."""
    from .models.g2pp import _g2_functional_cov

    u = t + delta
    C = _g2_functional_cov(g, (("u", t, 1.0, 0.0), ("u", t, 0.0, 1.0),
                               ("u", u, 1.0, 0.0), ("u", u, 0.0, 1.0)))
    A, Bx, D = C[:2, :2], C[:2, 2:], C[2:, 2:]
    S = D - Bx.T @ np.linalg.solve(A, Bx)
    return (float(S[0, 0]), float(S[0, 1]), float(S[1, 1]))


def mva_oracle_g2(cfg: HWConfig, g, market: MarketCurve, legs, *,
                  mpor: float = 0.1, quantile_im: float = 0.99,
                  spread_im: float = 0.005, freq: float = 1.0,
                  start: float | None = None, hazard: float = 0.02,
                  hazard_own: float = 0.01) -> MVAOracle:
    """fp64 G2++ MVA under delta-normal dynamic IM:
    IM = z_q sqrt(g' Sigma_delta g) with g the (x, y) value gradient.
    E[D IM] per date is a 2-d tilted trapezoid of the SMOOTH integrand
    (sqrt of a positive quadratic form — no kinks, so the tensor rule
    converges cleanly); the CV mean E[D Q], Q = g' Sigma_delta g, is a
    double sum of tilted lognormal moments (exact)."""
    from .models.g2pp import _fwd_means, _xy_cov

    if start is None:
        start = cfg.s1
    legs = tuple(SwapLeg(*l) for l in legs)
    mk = _g2_oracle_memo("mva", market, (cfg, g, legs, mpor, quantile_im,
                                         spread_im, freq, start, hazard,
                                         hazard_own))
    if mk in _G2_ORACLE_CACHE:
        return _G2_ORACLE_CACHE[mk]
    tenor_max = max(l.tenor for l in legs)
    dates = exposure_dates(cfg, tenor_max, freq, start)
    delta = float(mpor)
    Ts_grid = np.linspace(0.0, cfg.t_final, cfg.n_mat)
    P = np.asarray(market.P, np.float64)
    zq = _NDTRI(quantile_im)
    nq = 601
    zs = np.linspace(-8.0, 8.0, nq)
    wtr = np.full(nq, zs[1] - zs[0])
    wtr[0] = wtr[-1] = 0.5 * (zs[1] - zs[0])
    wpdf = wtr * np.exp(-0.5 * zs * zs) / math.sqrt(2.0 * math.pi)
    im, cvm, s_cond = [], [], []
    for t in dates:
        lam, Ba, Bb, K = _g2_portfolio_terms(cfg, g, market, legs, t,
                                             freq, start)
        Sxx, Sxy, Syy = _g2_cond_cov(g, t, delta)
        mx, my = _fwd_means(g, t)
        sx, sy, rxy = _xy_cov(g, t)
        s_c = sy * math.sqrt(max(1.0 - rxy * rxy, 1e-16))
        Pt = float(np.interp(t, Ts_grid, P))
        xs = mx + sx * zs
        m_c = my + rxy * sy / sx * (xs - mx)
        X = xs[:, None, None]                       # (nq, 1, 1)
        Y = (m_c[:, None] + s_c * zs[None, :])[:, :, None]
        Eterm = lam[None, None, :] * np.exp(-Ba[None, None, :] * X
                                            - Bb[None, None, :] * Y)
        gx = np.sum(Eterm * Ba[None, None, :], axis=2)
        gy = np.sum(Eterm * Bb[None, None, :], axis=2)
        del Eterm
        Q = Sxx * gx * gx + 2.0 * Sxy * gx * gy + Syy * gy * gy
        inner = np.sqrt(np.maximum(Q, 0.0)) @ wpdf          # (nq,)
        im.append(Pt * zq * float(wpdf @ inner))
        # E_tilt[Q]: double lognormal sum under the t-forward means
        BaP = Ba[:, None] + Ba[None, :]
        BbP = Bb[:, None] + Bb[None, :]
        coef = (lam[:, None] * lam[None, :]
                * (Sxx * Ba[:, None] * Ba[None, :]
                   + Sxy * (Ba[:, None] * Bb[None, :]
                            + Bb[:, None] * Ba[None, :])
                   + Syy * Bb[:, None] * Bb[None, :]))
        emom = np.exp(-BaP * mx - BbP * my
                      + 0.5 * (BaP * BaP * sx * sx
                               + 2.0 * BaP * BbP * rxy * sx * sy
                               + BbP * BbP * sy * sy))
        cvm.append(Pt * float(np.sum(coef * emom)))
        s_cond.append(0.0)
    w = _mva_weights(dates, freq, spread_im, hazard, hazard_own)
    out = MVAOracle(dates=dates, delta=delta, im=tuple(im),
                    cv_mean=tuple(cvm), s_cond=tuple(s_cond),
                    mva=sum(a * b for a, b in zip(w, im)))
    _G2_ORACLE_CACHE[mk] = out
    return out


@lru_cache(maxsize=None)
def _mva_g2_fn(cfg: HWConfig, g, legs: tuple, freq: float, start: float,
               delta: float, quantile_im: float, spread_im: float,
               hazard: float, hazard_own: float, n_paths: int,
               n_blocks: int, rqmc: bool, mesh):
    """G2++ MVA kernel: per path Q = g' Sigma_delta g on the netted
    (x, y, I) states, IM = z_q sqrt(Q), CV = the quadratic channel
    D Q at its exact tilted-lognormal mean."""
    from .models.g2pp import _B, _g2_functional_chol, _v_integral

    tenor_max = max(l.tenor for l in legs)
    dates = exposure_dates(cfg, tenor_max, freq, start)
    m = len(dates)
    specs = tuple([s for t in dates
                   for s in (("u", t, 1.0, 0.0), ("u", t, 0.0, 1.0))]
                  + [("I", t) for t in dates])
    LT = jnp.asarray(_g2_functional_chol(g, specs))
    d0 = jnp.asarray([-0.5 * _v_integral(g, t) for t in dates],
                     jnp.float32)
    scheds = [swap_schedule(cfg, l.rate, l.tenor, freq, start)
              for l in legs]
    sgs = [(-1.0 if l.payer else 1.0) for l in legs]
    ncf = sum(len(s.times) for s in scheds)
    BaM = np.zeros((m, ncf))
    BbM = np.zeros((m, ncf))
    facM = np.zeros((m, ncf))
    timesC = np.concatenate([np.asarray(s.times) for s in scheds])
    SxxV = np.zeros(m)
    SxyV = np.zeros(m)
    SyyV = np.zeros(m)
    col0 = 0
    for leg, sched, sg in zip(legs, scheds, sgs):
        nl = len(sched.times)
        for j, t in enumerate(dates):
            if t >= start + leg.tenor - 1e-9:
                continue
            for i, T_i in enumerate(sched.times):
                if T_i <= t + 1e-9:
                    continue
                c = col0 + i
                BaM[j, c] = _B(g.a, T_i - t)
                BbM[j, c] = _B(g.b, T_i - t)
                vadj = 0.5 * (_v_integral(g, T_i - t)
                              - _v_integral(g, T_i) + _v_integral(g, t))
                facM[j, c] = sg * sched.coupons[i] * math.exp(vadj)
        col0 += nl
    for j, t in enumerate(dates):
        SxxV[j], SxyV[j], SyyV[j] = _g2_cond_cov(g, t, delta)
    BaJ, BbJ = jnp.asarray(BaM, jnp.float32), jnp.asarray(BbM, jnp.float32)
    facJ = jnp.asarray(facM, jnp.float32)
    timesJ = jnp.asarray(timesC, jnp.float32)
    SxxJ = jnp.asarray(SxxV, jnp.float32)
    SxyJ = jnp.asarray(SxyV, jnp.float32)
    SyyJ = jnp.asarray(SyyV, jnp.float32)
    tj = jnp.asarray(dates, jnp.float32)
    wj = jnp.asarray(_mva_weights(dates, freq, spread_im, hazard,
                                  hazard_own), jnp.float32)
    zeros = jnp.zeros(m, jnp.float32)
    zq = jnp.float32(_NDTRI(quantile_im))

    def compute(key, market, cvm):
        Pt = hw.interp_curve(market.P, tj, cfg)
        P0i = hw.interp_curve(market.P, timesJ, cfg)
        lam = facJ * (P0i[None, :] / Pt[:, None])
        disc0 = Pt * jnp.exp(d0)

        def block(bi):
            xn = pmesh.block_normals(key, bi, n_paths, 3 * m, rqmc)
            z = jnp.dot(xn, LT, preferred_element_type=jnp.float32,
                        precision=cfg.matmul_precision)

            def leg(sgn):
                x = sgn * z[:, 0:2 * m:2]
                y = sgn * z[:, 1:2 * m:2]
                I = sgn * z[:, 2 * m:]
                Eterm = lam[None, :, :] * jnp.exp(
                    -BaJ[None, :, :] * x[:, :, None]
                    - BbJ[None, :, :] * y[:, :, None])
                gx = jnp.sum(Eterm * BaJ[None, :, :], axis=2)
                gy = jnp.sum(Eterm * BbJ[None, :, :], axis=2)
                Q = (SxxJ[None, :] * gx * gx
                     + 2.0 * SxyJ[None, :] * gx * gy
                     + SyyJ[None, :] * gy * gy)
                D = disc0[None, :] * jnp.exp(-I)
                X = D * zq * jnp.sqrt(jnp.maximum(Q, 0.0))
                Y = D * Q
                return X, Y

            Xp, Yp = leg(1.0)
            Xm, Ym = leg(-1.0)
            X, Y = 0.5 * (Xp + Xm), 0.5 * (Yp + Ym)
            Xc = jnp.dot(X, wj)
            Yc = jnp.dot(Y, wj)
            per_date = jnp.concatenate([
                jnp.sum(X, axis=0), jnp.sum(X * X, axis=0),
                jnp.sum(Y, axis=0), jnp.sum(Y * Y, axis=0),
                jnp.sum(X * Y, axis=0), jnp.zeros(m, jnp.float32)])
            agg = jnp.stack([jnp.sum(Xc), jnp.sum(Xc * Xc), jnp.sum(Yc),
                             jnp.sum(Yc * Yc), jnp.sum(Xc * Yc)])
            return jnp.concatenate([per_date, agg])

        per_block = pmesh.map_blocks(block, n_blocks, mesh)
        return _profile_reduce(per_block, m, n_paths, n_blocks, rqmc,
                               cvm, wj, zeros, 1.0)

    return jax.jit(compute)


def price_mva_g2(cfg: HWConfig, g, key, market: MarketCurve, legs, *,
                 mpor: float = 0.1, quantile_im: float = 0.99,
                 spread_im: float = 0.005, freq: float = 1.0,
                 start: float | None = None, hazard: float = 0.02,
                 hazard_own: float = 0.01, n_paths: int | None = None,
                 n_blocks: int = 1, rqmc: bool = False,
                 mesh=None) -> MVAResult:
    """G2++ twin of ``price_mva``: delta-normal dynamic IM funded cost
    on the netted (x, y, I) states.  fp64 oracle: ``mva_oracle_g2``."""
    if rqmc and n_blocks < 2:
        raise ValueError("rqmc needs n_blocks >= 2 (the digital shifts "
                         "are the independent replicates)")
    if n_paths is None:
        n_paths = cfg.n_paths
    if start is None:
        start = cfg.s1
    legs = tuple(SwapLeg(*l) for l in legs)
    o = mva_oracle_g2(cfg, g, market, legs, mpor=mpor,
                      quantile_im=quantile_im, spread_im=spread_im,
                      freq=freq, start=start, hazard=hazard,
                      hazard_own=hazard_own)
    out = _mva_g2_fn(cfg, g, legs, float(freq), float(start),
                     float(o.delta), float(quantile_im),
                     float(spread_im), _haz(hazard), _haz(hazard_own),
                     int(n_paths), int(n_blocks), bool(rqmc), mesh)(
        key, market, jnp.asarray(o.cv_mean, jnp.float32))
    return MVAResult(mva=out[6], std_error=out[7], raw_mva=out[8],
                     raw_std_error=out[9], beta=out[10], im=out[0],
                     im_std_error=out[1], dates=o.dates, delta=o.delta)


# ---------------------------------------------------------------------------
# KVA: capital valuation adjustment.  Regulatory capital held against the
# netted counterparty exposure is modelled as a fraction of the exposure,
# K_j = kappa EE*_j with EE*_j = E[e^{-I_j} V_j^+] the DISCOUNTED expected
# exposure (an EAD proxy; the discount factor the capital-cost integral
# would otherwise apply is absorbed into the EAD — the same discounted-EE
# convention every other adjustment in this module quotes).  The capital
# is remunerated at the hurdle rate c_h while both parties survive:
#
#   KVA = c_h kappa sum_j EE*_j e^{-(h_c + h_o) t_j} Delta_j,
#
# the discrete analogue of c_h int K(t) S_c(t) S_o(t) dt.  kappa bundles
# the capital ratio x risk weight of the counterparty-credit-risk charge
# (8% x 100% = 0.08 by default); swapping in a richer capital model is a
# reweighting of the same EE profile.  The MC estimator is therefore the
# netted-exposure kernel (`_netting_fn` / `_netting_g2_fn`) with the
# default-probability aggregate weights replaced by the KVA weights — the
# per-date optimal-beta CVs and the aggregated headline CV (the netted
# discounted portfolio value at its exact martingale mean) carry over
# unchanged.  Oracle: the exact segment-decomposition EE profile of
# `netting_oracle` (tilted bivariate quadrature in the G2++ twin) dotted
# with the same weights.
#
# Reference anchor: the exposure/aggregation layer being extended is the
# reference's discounted-payoff reduction (src/2_option_pricing.cu:14-35);
# KVA itself is beyond-reference scope on the same machinery.
# ---------------------------------------------------------------------------


class KVAOracle(NamedTuple):
    dates: tuple
    capital: tuple        # per-date discounted capital K_j = kappa EE*_j
    kva: float


class KVAResult(NamedTuple):
    kva: jax.Array
    std_error: jax.Array
    raw_kva: jax.Array
    raw_std_error: jax.Array
    beta: jax.Array
    capital: jax.Array        # per-date kappa x EE (CV'd estimates)
    capital_std_error: jax.Array
    dates: tuple


def _kva_weights(dates: tuple, freq: float, cost_of_capital: float,
                 capital_ratio: float, hazard, hazard_own):
    """Capital-cost weights c_h kappa Delta_j S_c(t_j) S_o(t_j) (flat
    hazards or ``CreditCurve``s)."""
    from .credit import survival

    return tuple(cost_of_capital * capital_ratio * (1.0 / freq)
                 * survival(hazard, t) * survival(hazard_own, t)
                 for t in dates)


def kva_oracle(cfg: HWConfig, market: MarketCurve, legs, *,
               freq: float = 1.0, start: float | None = None,
               cost_of_capital: float = 0.10, capital_ratio: float = 0.08,
               hazard: float = 0.02, hazard_own: float = 0.01,
               sigma: float | None = None) -> KVAOracle:
    """fp64 closed-form KVA of a netted portfolio (module comment above):
    the exact segment-decomposition EE profile dotted with the
    survival-discounted capital-cost weights."""
    if start is None:
        start = cfg.s1
    legs = tuple(SwapLeg(*l) for l in legs)
    o = netting_oracle(cfg, market, legs, freq=freq, start=start,
                       sigma=sigma)
    w = _kva_weights(o.dates, freq, cost_of_capital, capital_ratio,
                     hazard, hazard_own)
    cap = tuple(capital_ratio * e for e in o.ee)
    return KVAOracle(dates=o.dates, capital=cap,
                     kva=sum(a * b for a, b in zip(w, o.ee)))


def price_kva(cfg: HWConfig, key, market: MarketCurve, legs, *,
              freq: float = 1.0, start: float | None = None,
              cost_of_capital: float = 0.10, capital_ratio: float = 0.08,
              hazard: float = 0.02, hazard_own: float = 0.01, sigma=None,
              n_paths: int | None = None, n_blocks: int = 1,
              rqmc: bool = False, mesh=None) -> KVAResult:
    """Monte Carlo KVA on the netted multi-date states: the netting
    kernel with the pd aggregate weights swapped for the KVA weights
    (recovery pinned to 0 so the kernel's lgd factor is 1).  fp64
    oracle: ``kva_oracle``."""
    if rqmc and n_blocks < 2:
        raise ValueError("rqmc needs n_blocks >= 2 (the digital shifts "
                         "are the independent replicates)")
    if sigma is None:
        sigma = cfg.sigma
    if n_paths is None:
        n_paths = cfg.n_paths
    if start is None:
        start = cfg.s1
    legs = tuple(SwapLeg(*l) for l in legs)
    o = netting_oracle(cfg, market, legs, freq=freq, start=start,
                       sigma=float(sigma))
    w = _kva_weights(o.dates, freq, cost_of_capital, capital_ratio,
                     hazard, hazard_own)
    pfe = jnp.asarray(o.pfe, jnp.float32)
    out = _netting_fn(cfg, legs, float(freq), float(start), _haz(hazard),
                      0.0, int(n_paths), int(n_blocks), bool(rqmc), mesh,
                      agg_weights=w)(
        key, jnp.asarray(sigma, jnp.float32), market, pfe)
    kr = jnp.float32(capital_ratio)
    return KVAResult(kva=out[6], std_error=out[7], raw_kva=out[8],
                     raw_std_error=out[9], beta=out[10],
                     capital=kr * out[0], capital_std_error=kr * out[1],
                     dates=o.dates)


def kva_oracle_g2(cfg: HWConfig, g, market: MarketCurve, legs, *,
                  freq: float = 1.0, start: float | None = None,
                  cost_of_capital: float = 0.10,
                  capital_ratio: float = 0.08, hazard: float = 0.02,
                  hazard_own: float = 0.01) -> KVAOracle:
    """G2++ twin of ``kva_oracle`` on the tilted bivariate-quadrature EE
    profile of ``netting_oracle_g2``."""
    if start is None:
        start = cfg.s1
    legs = tuple(SwapLeg(*l) for l in legs)
    o = netting_oracle_g2(cfg, g, market, legs, freq=freq, start=start)
    w = _kva_weights(o.dates, freq, cost_of_capital, capital_ratio,
                     hazard, hazard_own)
    cap = tuple(capital_ratio * e for e in o.ee)
    return KVAOracle(dates=o.dates, capital=cap,
                     kva=sum(a * b for a, b in zip(w, o.ee)))


def price_kva_g2(cfg: HWConfig, g, key, market: MarketCurve, legs, *,
                 freq: float = 1.0, start: float | None = None,
                 cost_of_capital: float = 0.10,
                 capital_ratio: float = 0.08, hazard: float = 0.02,
                 hazard_own: float = 0.01, n_paths: int | None = None,
                 n_blocks: int = 1, rqmc: bool = False,
                 mesh=None) -> KVAResult:
    """G2++ twin of ``price_kva`` on the netted (x, y, I) states.  fp64
    oracle: ``kva_oracle_g2``."""
    if rqmc and n_blocks < 2:
        raise ValueError("rqmc needs n_blocks >= 2 (the digital shifts "
                         "are the independent replicates)")
    if n_paths is None:
        n_paths = cfg.n_paths
    if start is None:
        start = cfg.s1
    legs = tuple(SwapLeg(*l) for l in legs)
    o = netting_oracle_g2(cfg, g, market, legs, freq=freq, start=start)
    w = _kva_weights(o.dates, freq, cost_of_capital, capital_ratio,
                     hazard, hazard_own)
    pfe = jnp.asarray(o.pfe, jnp.float32)
    out = _netting_g2_fn(cfg, g, legs, float(freq), float(start),
                         _haz(hazard), 0.0, int(n_paths), int(n_blocks),
                         bool(rqmc), mesh, agg_weights=w)(
        key, market, pfe)
    kr = jnp.float32(capital_ratio)
    return KVAResult(kva=out[6], std_error=out[7], raw_kva=out[8],
                     raw_std_error=out[9], beta=out[10],
                     capital=kr * out[0], capital_std_error=kr * out[1],
                     dates=o.dates)


# ---------------------------------------------------------------------------
# XVA on callable products: Bermudan swaption exposure (the "American
# Monte Carlo" problem).  The holder of a cash-settled Bermudan receiver
# is exposed, while the option is unexercised, to the option's own mark
# V_j(r_j) = max(payoff_j, cont_j) — so the profile needs the value
# FUNCTION at every date (the DP solution), an exercise policy deciding
# which paths are still alive, and the discounted alive measure:
#
#   EE_j  = E[ e^{-I_j} V_j(r_j) 1{tau >= j} ],       tau = policy stop
#   flows_j = E[ e^{-I_j} payoff_j(r_j) 1{tau = j} ],
#   CVA  = lgd sum_j pd_j EE_j.
#
# Oracle (fp64): the backward pass is bermudan.dp_solution (exact
# piecewise-linear x tilted-Gaussian sweeps); the forward pass
# propagates the DISCOUNTED alive sub-density G_j(r) =
# E[e^{-I_j} 1{alive} delta(r_j - r)] interval by interval with the
# SAME tilted kernels (each interval's e^{-dI} tilt is the lognormal
# prefactor w0(r_s) and a -ctI mean shift — bermudan._interval_params),
# and a second UNTILTED pass for the PFE quantile.  The policy is the
# threshold boundary r*_j (the payoff-cont crossing interpolated off
# the DP grid; receivers exercise at LOW r).  Self-check: the stopped
# discounted value Y_j = D_tau payoff_tau 1{tau<j} + D_j V_j 1{tau>=j}
# has E[Y_j] = price for EVERY j by optional stopping (the DP value is
# the policy's own continuation on the alive set) — the oracle pins
# y_means_j == price to quadrature error, and Y_j at that exact mean is
# the MC's per-date control variate (the same optimal-stopping CV idea
# as the Bermudan lower bound's martingale CV, bermudan.py).
#
# MC: exact Gaussian functionals (r, I) at the exercise dates (the
# netting kernel's sampler), the frozen boundary policy, and the DP
# value grids interpolated on device (fp32 interp of the fp64 grids;
# O(h^2) ~ 1e-6, below MC noise).  Reference anchor: the discounted-
# payoff reduction layer, src/2_option_pricing.cu:14-35; the callable-
# exposure composition is beyond-reference scope.
# ---------------------------------------------------------------------------


class BermudanXVAOracle(NamedTuple):
    dates: tuple
    ee: tuple             # E[D_j V_j 1{alive}]
    pfe: tuple            # untilted quantile of V_j 1{alive}
    flows: tuple          # E[D_j payoff_j 1{tau = j}]
    y_means: tuple        # stopped-value means (== price, pinned)
    rstars: tuple         # policy boundaries r*_j
    price: float          # DP price (rolled to 0)
    cva: float


def _berm_solution(cfg: HWConfig, market: MarketCurve,
                   sched: CouponSchedule, ex: tuple, strike: float,
                   payer: bool, n_grid: int = 1501, width: float = 8.5):
    """Memoized ``bermudan.dp_solution`` (the exposure oracle and the
    MC pricer share one backward pass; same memo idea as
    ``_g2_oracle_memo``)."""
    from .bermudan import dp_solution

    mk = _g2_oracle_memo("bxva_sol", market,
                         (cfg, sched, ex, strike, payer, n_grid, width))
    if mk not in _G2_ORACLE_CACHE:
        _G2_ORACLE_CACHE[mk] = dp_solution(
            cfg, market, sched, ex, strike=strike, payer=payer,
            n_grid=n_grid, width=width)
    return _G2_ORACLE_CACHE[mk]


def _dp_boundary(grid, payoff, cont, sg: float):
    """Threshold boundary r* of the DP policy on one date's grid:
    the crossing of f = payoff - cont inside {payoff > 0}, interpolated
    linearly; receivers (sg=+1) exercise at r < r*, payers at r > r*.
    No crossing => the whole ITM side exercises (pure-intrinsic dates)
    or nothing does (f < 0 everywhere): the boundary collapses to the
    strike root or to the far OTM end respectively."""
    f = payoff - cont
    itm = payoff > 0.0
    if not np.any(itm & (f > 0.0)):
        return float(grid[0] - 1.0) if sg > 0 else float(grid[-1] + 1.0)
    # scan from the OTM side toward ITM: the policy region is the sg
    # side of the LAST sign change of f restricted to the ITM set
    idx = np.nonzero((f[:-1] > 0.0) != (f[1:] > 0.0))[0]
    if len(idx) == 0:
        # f > 0 on all of ITM: boundary = the ITM edge (strike root)
        edge = np.nonzero(itm)[0]
        i = edge[-1] if sg > 0 else edge[0]
        return float(grid[i])
    i = idx[-1] if sg > 0 else idx[0]
    a, b = grid[i], grid[i + 1]
    fa, fb = f[i], f[i + 1]
    return float(a + (b - a) * fa / (fa - fb))


def bermudan_exposure_oracle(cfg: HWConfig, market: MarketCurve,
                             sched: CouponSchedule, ex_dates, *,
                             strike: float = 1.0, payer: bool = False,
                             quantile: float = 0.95,
                             hazard: float = 0.02, recovery: float = 0.4,
                             n_grid: int = 1501,
                             width: float = 8.5) -> BermudanXVAOracle:
    """fp64 Bermudan exposure profile + CVA by forward propagation of
    the discounted alive sub-density through the DP solution (module
    comment above)."""
    sol = _berm_solution(cfg, market, sched, tuple(ex_dates), strike,
                         payer, n_grid, width)
    ex, grids, Vs, conts, pays = (sol["ex"], sol["grids"], sol["V"],
                                  sol["cont"], sol["payoff"])
    r_det, i_det, ivp, sig = (sol["r_det"], sol["i_det"], sol["ivp"],
                              sol["sig"])
    k = len(ex)
    sg = -1.0 if payer else 1.0
    rstars = [_dp_boundary(grids[j], pays[j], conts[j], sg)
              for j in range(k)]
    masks = [(grids[j] < rstars[j]) if sg > 0 else (grids[j] > rstars[j])
             for j in range(k)]
    tws = []
    for j in range(k):
        tw = np.full(n_grid, grids[j][1] - grids[j][0])
        tw[0] = tw[-1] = 0.5 * (grids[j][1] - grids[j][0])
        tws.append(tw)

    def forward(tilted: bool):
        """Per-date alive densities at the grid nodes under the
        e^{-I}-tilted (discounted) or plain law."""
        Gs = []
        for j in range(k):
            p = ivp[j]
            vt = sig * sig * p["vt"]
            vI = sig * sig * p["vI"]
            ctI = sig * sig * p["ctI"]
            didet = i_det[j] - (i_det[j - 1] if j > 0 else 0.0)
            s_t = math.sqrt(vt)
            if j == 0:
                # from the deterministic start r(0) = r0
                m = r_det[0] - (ctI if tilted else 0.0)
                w0 = math.exp(-didet + 0.5 * vI) if tilted else 1.0
                G = w0 * np.exp(-0.5 * ((grids[0] - m) / s_t) ** 2) \
                    / (s_t * math.sqrt(2.0 * math.pi))
            else:
                src = Gs[j - 1] * tws[j - 1] * (~masks[j - 1])
                m = (r_det[j] + p["bt"] * (grids[j - 1] - r_det[j - 1])
                     - (ctI if tilted else 0.0))
                if tilted:
                    w0 = np.exp(-(didet + p["bI"]
                                  * (grids[j - 1] - r_det[j - 1]))
                                + 0.5 * vI)
                else:
                    w0 = 1.0
                ker = np.exp(-0.5 * ((grids[j][None, :] - m[:, None])
                                     / s_t) ** 2) \
                    / (s_t * math.sqrt(2.0 * math.pi))
                G = (src * w0) @ ker
            Gs.append(G)
        return Gs

    Gt = forward(True)
    Gu = forward(False)
    ee, flows, pfe = [], [], []
    for j in range(k):
        w = Gt[j] * tws[j]
        ee.append(float(w @ Vs[j]))
        flows.append(float((w * masks[j]) @ pays[j]))
        wu = Gu[j] * tws[j]

        def cdf(v, wu=wu, Vj=Vs[j]):
            return 1.0 - float(wu @ (Vj > v))
        pfe.append(_pfe_root(cdf, quantile))
    y_means = []
    acc = 0.0
    for j in range(k):
        y_means.append(acc + ee[j])
        acc += flows[j]
    pd, dpd = _pd_weights(ex, hazard)
    lgd = 1.0 - recovery
    cva = lgd * sum(p * e for p, e in zip(pd, ee))
    return BermudanXVAOracle(dates=ex, ee=tuple(ee), pfe=tuple(pfe),
                             flows=tuple(flows), y_means=tuple(y_means),
                             rstars=tuple(rstars), price=sol["price"],
                             cva=cva)


def _clenshaw(coef, u):
    """Chebyshev series evaluation by Clenshaw recurrence (coef is a
    static 1-d fp32 array; u in [-1, 1]).  Pure fused multiply-adds —
    no table gathers, which dominated the first version of this kernel
    before interpolation was replaced with closed forms + Chebyshev."""
    b1 = jnp.zeros_like(u)
    b2 = jnp.zeros_like(u)
    for c in coef[:0:-1]:
        b1, b2 = 2.0 * u * b1 - b2 + c, b1
    return u * b1 - b2 + coef[0]


@lru_cache(maxsize=None)
def _berm_xva_fn(cfg: HWConfig, sched: CouponSchedule, ex: tuple,
                 strike: float, payer: bool, hazard, recovery: float,
                 n_paths: int, n_blocks: int, rqmc: bool, mesh,
                 cheb: tuple = ()):
    """Bermudan-exposure kernel: exact (r, I) functionals at the
    exercise dates, frozen DP boundary policy, per-date stopped-value
    CVs (exact means from the forward oracle).  The value function is
    V_j = max(intrinsic_j, cont_j) with the intrinsic in closed form
    and cont_j the per-date Chebyshev refit of the DP continuation
    (``cheb`` = ((lo, hi, coefs), ...) static): cont is analytic, so
    degree 40 reproduces the 1501-point grid to ~1e-15 — tighter than
    the bilinear interpolation it replaces, and gather-free."""
    from .bermudan import _functional_chol, _functional_det

    k = len(ex)
    specs = tuple([("r", t) for t in ex] + [("I", t) for t in ex])
    LT = jnp.asarray(_functional_chol(cfg, specs))
    pd, dpd = _pd_weights(ex, hazard)
    pdw = jnp.asarray(pd, jnp.float32)
    dpdw = jnp.asarray(dpd, jnp.float32)
    lgd = 1.0 - recovery
    sg = -1.0 if payer else 1.0
    chebJ = [(jnp.float32(lo), jnp.float32(hi),
              jnp.asarray(cf, jnp.float32)) for lo, hi, cf in cheb]

    def compute(key, market, rstars, pfe, ym):
        tables = hw.step_tables(cfg, cfg.sigma, cfg.sigma, jnp.float32)
        det = _functional_det(cfg, jnp.float32(cfg.sigma), specs)
        r_det, i_det = det[:k], det[k:]
        terms = [_bond_value_terms(cfg, cfg.sigma, market, sched, t)
                 for t in ex]

        def block(bi):
            x = pmesh.block_normals(key, bi, n_paths, 2 * k, rqmc)
            z = tables.sig_st * jnp.dot(
                x, LT, preferred_element_type=jnp.float32,
                precision=cfg.matmul_precision)

            def leg(sgn):
                ro = r_det[None, :] + sgn * z[:, :k]
                D = jnp.exp(-(i_det[None, :] + sgn * z[:, k:]))
                alive = jnp.ones((ro.shape[0],), jnp.float32)
                flow = jnp.zeros((ro.shape[0],), jnp.float32)
                Xs, Ys, Es = [], [], []
                for j in range(k):
                    cA, B = terms[j]
                    intr = sg * (jnp.sum(
                        cA[None, :] * jnp.exp(-B[None, :]
                                              * ro[:, j][:, None]),
                        axis=1) - strike)
                    lo, hi, cf = chebJ[j]
                    u = jnp.clip((2.0 * ro[:, j] - (hi + lo))
                                 / (hi - lo), -1.0, 1.0)
                    vj = jnp.maximum(jnp.maximum(intr, _clenshaw(cf, u)),
                                     0.0)
                    Xj = D[:, j] * vj * alive
                    Xs.append(Xj)
                    Ys.append(flow + Xj)
                    Es.append((vj * alive > pfe[j]).astype(jnp.float32))
                    hit = (sg * (rstars[j] - ro[:, j]) > 0.0)
                    exe = alive * hit.astype(jnp.float32)
                    flow = flow + exe * D[:, j] * jnp.maximum(intr, 0.0)
                    alive = alive * (1.0 - exe)
                return (jnp.stack(Xs, 1), jnp.stack(Ys, 1),
                        jnp.stack(Es, 1))

            Xp, Yp, Ep = leg(1.0)
            Xm, Ym, Em = leg(-1.0)
            X, Y = 0.5 * (Xp + Xm), 0.5 * (Yp + Ym)
            E = 0.5 * (Ep + Em)
            Xc = jnp.dot(X, pdw)
            Yc = jnp.dot(Y, pdw)
            per_date = jnp.concatenate([
                jnp.sum(X, axis=0), jnp.sum(X * X, axis=0),
                jnp.sum(Y, axis=0), jnp.sum(Y * Y, axis=0),
                jnp.sum(X * Y, axis=0), jnp.sum(E, axis=0)])
            agg = jnp.stack([jnp.sum(Xc), jnp.sum(Xc * Xc), jnp.sum(Yc),
                             jnp.sum(Yc * Yc), jnp.sum(Xc * Yc)])
            return jnp.concatenate([per_date, agg])

        per_block = pmesh.map_blocks(block, n_blocks, mesh)
        return _profile_reduce(per_block, k, n_paths, n_blocks, rqmc,
                               ym, pdw, dpdw, lgd)

    return jax.jit(compute)


def price_bermudan_xva(cfg: HWConfig, key, market: MarketCurve,
                       sched: CouponSchedule, ex_dates, *,
                       strike: float = 1.0, payer: bool = False,
                       quantile: float = 0.95, hazard: float = 0.02,
                       recovery: float = 0.4, n_paths: int | None = None,
                       n_blocks: int = 1, rqmc: bool = False,
                       mesh=None, n_grid: int = 1501,
                       width: float = 8.5):
    """Monte Carlo Bermudan-swaption exposure profile + CVA under the
    frozen DP boundary policy (module comment above).  fp64 oracle:
    ``bermudan_exposure_oracle``.  Returns (CVAResult, oracle)."""
    if rqmc and n_blocks < 2:
        raise ValueError("rqmc needs n_blocks >= 2 (the digital shifts "
                         "are the independent replicates)")
    if n_paths is None:
        n_paths = cfg.n_paths
    ex = tuple(sorted(float(t) for t in ex_dates))
    o = bermudan_exposure_oracle(cfg, market, sched, ex, strike=strike,
                                 payer=payer, quantile=quantile,
                                 hazard=hazard, recovery=recovery,
                                 n_grid=n_grid, width=width)
    sol = _berm_solution(cfg, market, sched, ex, float(strike),
                         bool(payer), n_grid, width)
    cheb = []
    for g, c in zip(sol["grids"], sol["cont"]):
        u = np.linspace(-1.0, 1.0, len(g))
        cf = np.polynomial.chebyshev.chebfit(u, c, 40)
        cheb.append((float(g[0]), float(g[-1]), tuple(map(float, cf))))
    rstars = jnp.asarray(o.rstars, jnp.float32)
    pfe = jnp.asarray(o.pfe, jnp.float32)
    ym = jnp.asarray(o.y_means, jnp.float32)
    out = _berm_xva_fn(cfg, sched, ex, float(strike), bool(payer),
                       _haz(hazard), float(recovery), int(n_paths),
                       int(n_blocks), bool(rqmc), mesh, tuple(cheb))(
        key, market, rstars, pfe, ym)
    prof = ExposureProfile(
        dates=ex, ee=out[0], ee_std_error=out[1], ee_raw=out[2],
        beta=out[3], pfe=pfe, exceed=out[4], epe=out[5],
        n_paths=int(n_paths) * int(n_blocks))
    return CVAResult(cva=out[6], std_error=out[7], raw_cva=out[8],
                     raw_std_error=out[9], beta=out[10],
                     hazard_delta=out[11], profile=prof), o


# ---------------------------------------------------------------------------
# G2++ twin of the Bermudan exposure layer: the forward pass propagates
# the 2-d discounted alive sub-density G_j(x, y) through the dp_solution_g2
# grids.  Per interval of length d, conditional on the source state,
# (x', y') is bivariate Gaussian with means (x e^{-ad}, y e^{-bd}) and the
# innovation covariance _state_cov(g, d); tilting by e^{-dI} multiplies by
# exp(-(x Ba + y Bb) + vI/2) x the deterministic dd ratio and shifts the
# innovation means by -Cov(., xi_I) — exactly the backward sweep's kernel
# run forward.  The policy is the node mask {payoff > cont}; the MC
# thresholds the bilinear interpolant of f = payoff - cont (identical at
# the nodes; misclassification inside a boundary cell is third order
# because V = payoff = cont ON the boundary).  Optional stopping pins
# y_means_j == price to the 2-d quadrature error, and the stopped value
# is the per-date CV exactly as in the 1-factor layer.
# ---------------------------------------------------------------------------


def _berm_g2_solution(cfg: HWConfig, g, market: MarketCurve, sched,
                      ex: tuple, strike: float, payer: bool,
                      n_grid: int, width: float):
    from .models.g2pp import dp_solution_g2

    mk = _g2_oracle_memo("bxva_g2_sol", market,
                         (cfg, g, tuple(sched.times), tuple(sched.coupons),
                          ex, strike, payer, n_grid, width))
    if mk not in _G2_ORACLE_CACHE:
        _G2_ORACLE_CACHE[mk] = dp_solution_g2(
            cfg, g, market, sched, ex, strike=strike, payer=payer,
            n_grid=n_grid, width=width)
    return _G2_ORACLE_CACHE[mk]


def bermudan_exposure_oracle_g2(cfg: HWConfig, g, market: MarketCurve,
                                sched: CouponSchedule, ex_dates, *,
                                strike: float = 1.0, payer: bool = False,
                                quantile: float = 0.95,
                                hazard: float = 0.02,
                                recovery: float = 0.4, n_grid: int = 121,
                                width: float = 6.5) -> BermudanXVAOracle:
    """fp64 G2++ Bermudan exposure profile + CVA (module comment
    above)."""
    from .models.g2pp import _B, _state_cov

    ex = tuple(sorted(float(t) for t in ex_dates))
    sol = _berm_g2_solution(cfg, g, market, sched, ex, strike, payer,
                            n_grid, width)
    gxs, gys, Vs, conts, pays, dd = (sol["gxs"], sol["gys"], sol["V"],
                                     sol["cont"], sol["payoff"],
                                     sol["dd"])
    k = len(ex)
    masks = [pays[j] - conts[j] > 0.0 for j in range(k)]
    tw2 = []
    for j in range(k):
        twx = np.full(n_grid, gxs[j][1] - gxs[j][0])
        twx[0] = twx[-1] = 0.5 * twx[1]
        twy = np.full(n_grid, gys[j][1] - gys[j][0])
        twy[0] = twy[-1] = 0.5 * twy[1]
        tw2.append(np.outer(twx, twy))

    def forward(tilted: bool):
        Gs = []
        for j in range(k):
            d = ex[j] - (ex[j - 1] if j > 0 else 0.0)
            C = _state_cov(g, d)
            Ea, Eb = math.exp(-g.a * d), math.exp(-g.b * d)
            Ba, Bb = _B(g.a, d), _B(g.b, d)
            sx = math.sqrt(C[0, 0] + 1e-18)
            sy = math.sqrt(C[1, 1] + 1e-18)
            rho = C[0, 1] / (sx * sy)
            shx = C[0, 2] if tilted else 0.0
            shy = C[1, 2] if tilted else 0.0
            ddr = (dd[j] / (dd[j - 1] if j > 0 else 1.0)) if tilted \
                else 1.0
            norm2 = 1.0 / (2.0 * math.pi * sx * sy
                           * math.sqrt(1.0 - rho * rho))
            if j == 0:
                src_x = np.array([0.0])
                src_y = np.array([0.0])
                S = np.array([math.exp(0.5 * C[2, 2]) * ddr
                              if tilted else 1.0])
            else:
                X, Y = np.meshgrid(gxs[j - 1], gys[j - 1], indexing="ij")
                w0 = (np.exp(-(X * Ba + Y * Bb) + 0.5 * C[2, 2]) * ddr
                      if tilted else np.ones_like(X))
                M = Gs[j - 1] * tw2[j - 1] * (~masks[j - 1]) * w0
                S = M.ravel()
                src_x = X.ravel()
                src_y = Y.ravel()
                keep = np.abs(S) > 1e-18 * np.abs(S).max()
                S, src_x, src_y = S[keep], src_x[keep], src_y[keep]
            mx = src_x * Ea - shx
            my = src_y * Eb - shy
            G = np.zeros((n_grid, n_grid))
            q2 = 2.0 * (1.0 - rho * rho)
            for c0 in range(0, len(S), 256):
                sl = slice(c0, c0 + 256)
                dxn = (gxs[j][None, :] - mx[sl, None]) / sx
                dyn = (gys[j][None, :] - my[sl, None]) / sy
                E = np.exp(-(dxn[:, :, None] ** 2 + dyn[:, None, :] ** 2
                             - 2.0 * rho * dxn[:, :, None]
                             * dyn[:, None, :]) / q2)
                G += np.einsum("c,cxy->xy", S[sl], E)
            Gs.append(norm2 * G)
        return Gs

    Gt = forward(True)
    Gu = forward(False)
    ee, flows, pfe = [], [], []
    for j in range(k):
        w = Gt[j] * tw2[j]
        ee.append(float(np.sum(w * Vs[j])))
        flows.append(float(np.sum(w * masks[j] * pays[j])))
        wu = Gu[j] * tw2[j]

        def cdf(v, wu=wu, Vj=Vs[j]):
            return 1.0 - float(np.sum(wu * (Vj > v)))
        pfe.append(_pfe_root(cdf, quantile))
    y_means = []
    acc = 0.0
    for j in range(k):
        y_means.append(acc + ee[j])
        acc += flows[j]
    pd, dpd = _pd_weights(ex, hazard)
    lgd = 1.0 - recovery
    cva = lgd * sum(p * e for p, e in zip(pd, ee))
    return BermudanXVAOracle(dates=ex, ee=tuple(ee), pfe=tuple(pfe),
                             flows=tuple(flows), y_means=tuple(y_means),
                             rstars=(), price=sol["price"], cva=cva)


def _interp2(gx, gy, F, x, y):
    """Vectorized bilinear interpolation of F — (nx, ny) for one
    surface or (nx, ny, c) for c surfaces sharing the same corner
    gathers — at (x, y) points with flat extrapolation (the DP grids
    cover +/- 6.5 sd; tail mass is negligible and the clip keeps
    values bounded).  Uniform-grid affine indexing + one flattened
    gather per corner: jnp.searchsorted lowers to an O(paths x table)
    broadcast-compare (far slower); stacking V and the
    policy surface into one (.., 2) table halves the remaining gather
    count."""
    hx = gx[1] - gx[0]
    hy = gy[1] - gy[0]
    ux = (x - gx[0]) / hx
    uy = (y - gy[0]) / hy
    ix = jnp.clip(jnp.floor(ux), 0, gx.shape[0] - 2).astype(jnp.int32)
    iy = jnp.clip(jnp.floor(uy), 0, gy.shape[0] - 2).astype(jnp.int32)
    fx = jnp.clip(ux - ix, 0.0, 1.0)
    fy = jnp.clip(uy - iy, 0.0, 1.0)
    ny = gy.shape[0]
    chan = F.ndim == 3
    Ff = F.reshape(-1, F.shape[2]) if chan else F.reshape(-1)
    base = ix * ny + iy
    if chan:
        fx, fy = fx[:, None], fy[:, None]
    return ((1 - fx) * (1 - fy) * Ff[base] + fx * (1 - fy) * Ff[base + ny]
            + (1 - fx) * fy * Ff[base + 1] + fx * fy * Ff[base + ny + 1])


@lru_cache(maxsize=None)
def _berm_xva_g2_fn(cfg: HWConfig, g, sched: CouponSchedule, ex: tuple,
                    strike: float, payer: bool, hazard: float,
                    recovery: float, n_paths: int, n_blocks: int,
                    rqmc: bool, mesh):
    """G2++ Bermudan-exposure kernel: exact (x, y, I) functionals at the
    exercise dates, frozen bilinear f = payoff - cont policy, on-device
    bilinear interpolation of the DP value grids."""
    from .models.g2pp import _B, _g2_functional_chol, _v_integral

    k = len(ex)
    specs = tuple([s for t in ex
                   for s in (("u", t, 1.0, 0.0), ("u", t, 0.0, 1.0))]
                  + [("I", t) for t in ex])
    LT = jnp.asarray(_g2_functional_chol(g, specs))
    d0 = jnp.asarray([-0.5 * _v_integral(g, t) for t in ex], jnp.float32)
    # per-date payoff terms lam_i = c_i (P0(T_i)/P0(t)) e^{vadj}
    BaM, BbM, facM = [], [], []
    for t in ex:
        Ba_r, Bb_r, fac_r = [], [], []
        for T_i, c_i in zip(sched.times, sched.coupons):
            if T_i <= t + 1e-9:
                continue
            tau = T_i - t
            vadj = 0.5 * (_v_integral(g, tau) - _v_integral(g, T_i)
                          + _v_integral(g, t))
            Ba_r.append(_B(g.a, tau))
            Bb_r.append(_B(g.b, tau))
            fac_r.append(c_i * math.exp(vadj))
        BaM.append((tuple(Ba_r), tuple(Bb_r), tuple(fac_r)))
    pd, dpd = _pd_weights(ex, hazard)
    pdw = jnp.asarray(pd, jnp.float32)
    dpdw = jnp.asarray(dpd, jnp.float32)
    lgd = 1.0 - recovery
    sg = -1.0 if payer else 1.0
    tj = jnp.asarray(ex, jnp.float32)
    timesJ = jnp.asarray(sched.times, jnp.float32)

    def compute(key, market, gx, gy, VFg, pfe, ym):
        Pt = hw.interp_curve(market.P, tj, cfg)
        P0i = hw.interp_curve(market.P, timesJ, cfg)
        disc0 = Pt * jnp.exp(d0)

        def block(bi):
            xn = pmesh.block_normals(key, bi, n_paths, 3 * k, rqmc)
            z = jnp.dot(xn, LT, preferred_element_type=jnp.float32,
                        precision=cfg.matmul_precision)

            def leg(sgn):
                x = sgn * z[:, 0:2 * k:2]
                y = sgn * z[:, 1:2 * k:2]
                I = sgn * z[:, 2 * k:]
                alive = jnp.ones((x.shape[0],), jnp.float32)
                flow = jnp.zeros((x.shape[0],), jnp.float32)
                Xs, Ys, Es = [], [], []
                for j in range(k):
                    Dj = disc0[j] * jnp.exp(-I[:, j])
                    vf = _interp2(gx[j], gy[j], VFg[j], x[:, j],
                                  y[:, j])
                    vj, fj = vf[:, 0], vf[:, 1]
                    Xj = Dj * vj * alive
                    Xs.append(Xj)
                    Ys.append(flow + Xj)
                    Es.append((vj * alive > pfe[j]).astype(jnp.float32))
                    exe = alive * (fj > 0.0).astype(jnp.float32)
                    Ba_r, Bb_r, fac_r = BaM[j]
                    lam = (jnp.asarray(fac_r, jnp.float32)[None, :]
                           * P0i[None, len(sched.times) - len(fac_r):]
                           / Pt[j])
                    Vb = jnp.sum(lam * jnp.exp(
                        -jnp.asarray(Ba_r, jnp.float32)[None, :]
                        * x[:, j][:, None]
                        - jnp.asarray(Bb_r, jnp.float32)[None, :]
                        * y[:, j][:, None]), axis=1)
                    pay = jnp.maximum(sg * (Vb - strike), 0.0)
                    flow = flow + exe * Dj * pay
                    alive = alive * (1.0 - exe)
                return (jnp.stack(Xs, 1), jnp.stack(Ys, 1),
                        jnp.stack(Es, 1))

            Xp, Yp, Ep = leg(1.0)
            Xm, Ym, Em = leg(-1.0)
            X, Y = 0.5 * (Xp + Xm), 0.5 * (Yp + Ym)
            E = 0.5 * (Ep + Em)
            Xc = jnp.dot(X, pdw)
            Yc = jnp.dot(Y, pdw)
            per_date = jnp.concatenate([
                jnp.sum(X, axis=0), jnp.sum(X * X, axis=0),
                jnp.sum(Y, axis=0), jnp.sum(Y * Y, axis=0),
                jnp.sum(X * Y, axis=0), jnp.sum(E, axis=0)])
            agg = jnp.stack([jnp.sum(Xc), jnp.sum(Xc * Xc), jnp.sum(Yc),
                             jnp.sum(Yc * Yc), jnp.sum(Xc * Yc)])
            return jnp.concatenate([per_date, agg])

        per_block = pmesh.map_blocks(block, n_blocks, mesh)
        return _profile_reduce(per_block, k, n_paths, n_blocks, rqmc,
                               ym, pdw, dpdw, lgd)

    return jax.jit(compute)


def price_bermudan_xva_g2(cfg: HWConfig, g, key, market: MarketCurve,
                          sched: CouponSchedule, ex_dates, *,
                          strike: float = 1.0, payer: bool = False,
                          quantile: float = 0.95, hazard: float = 0.02,
                          recovery: float = 0.4,
                          n_paths: int | None = None, n_blocks: int = 1,
                          rqmc: bool = False, mesh=None,
                          n_grid: int = 121, width: float = 6.5):
    """G2++ twin of ``price_bermudan_xva``.  fp64 oracle:
    ``bermudan_exposure_oracle_g2``.  Returns (CVAResult, oracle)."""
    if rqmc and n_blocks < 2:
        raise ValueError("rqmc needs n_blocks >= 2 (the digital shifts "
                         "are the independent replicates)")
    if n_paths is None:
        n_paths = cfg.n_paths
    ex = tuple(sorted(float(t) for t in ex_dates))
    o = bermudan_exposure_oracle_g2(cfg, g, market, sched, ex,
                                    strike=strike, payer=payer,
                                    quantile=quantile, hazard=hazard,
                                    recovery=recovery, n_grid=n_grid,
                                    width=width)
    sol = _berm_g2_solution(cfg, g, market, sched, ex, float(strike),
                            bool(payer), n_grid, width)
    gx = tuple(jnp.asarray(a, jnp.float32) for a in sol["gxs"])
    gy = tuple(jnp.asarray(a, jnp.float32) for a in sol["gys"])
    VFg = tuple(jnp.asarray(np.stack([v, p - c], axis=-1), jnp.float32)
                for v, p, c in zip(sol["V"], sol["payoff"], sol["cont"]))
    pfe = jnp.asarray(o.pfe, jnp.float32)
    ym = jnp.asarray(o.y_means, jnp.float32)
    out = _berm_xva_g2_fn(cfg, g, sched, ex, float(strike), bool(payer),
                          _haz(hazard), float(recovery), int(n_paths),
                          int(n_blocks), bool(rqmc), mesh)(
        key, market, gx, gy, VFg, pfe, ym)
    prof = ExposureProfile(
        dates=ex, ee=out[0], ee_std_error=out[1], ee_raw=out[2],
        beta=out[3], pfe=pfe, exceed=out[4], epe=out[5],
        n_paths=int(n_paths) * int(n_blocks))
    return CVAResult(cva=out[6], std_error=out[7], raw_cva=out[8],
                     raw_std_error=out[9], beta=out[10],
                     hazard_delta=out[11], profile=prof), o


class CS01Result(NamedTuple):
    cva: float                 # base oracle CVA under the curve
    cva_mc: jax.Array
    cva_se: jax.Array
    deltas: tuple              # oracle CS01 per quote (per `bump`)
    deltas_mc: tuple           # MC CS01 per quote (exact-CRN re-dot)
    delta_bounds: tuple        # SE upper bounds sum_j |w_jk| se_j
    quotes: tuple
    bump: float


def cva_cs01(cfg: HWConfig, key, market: MarketCurve, legs, *, quotes,
             recovery: float = 0.4, bump: float = 1e-4,
             freq: float = 1.0, start: float | None = None,
             quantile: float = 0.95, n_paths: int | None = None,
             n_blocks: int = 1, rqmc: bool = False,
             mesh=None) -> CS01Result:
    """Bucketed credit deltas (CS01) of the netted CVA under a
    CDS-bootstrapped hazard curve.  The EE profile is independent of
    the credit side, so each bucket's delta is a host-side re-dot of
    the SAME exposure run with the rebootstrapped pd weights
    (``credit.cs01_weights``) — exact common random numbers, no
    resampling; the fp64 oracle deltas re-dot the closed-form EE
    profile identically.  ``delta_bounds`` are conservative per-bucket
    SE bounds sum_j |w_jk| se_j (the per-date EE errors are
    positively correlated, so the true SEs are smaller)."""
    from . import credit

    if start is None:
        start = cfg.s1
    quotes = tuple((float(m), float(s)) for m, s in quotes)
    legs = tuple(SwapLeg(*l) for l in legs)
    tenor_max = max(l.tenor for l in legs)
    dates = exposure_dates(cfg, tenor_max, freq, start)
    df = credit.market_df(cfg, market)
    curve, rows = credit.cs01_weights(df, quotes, dates,
                                      recovery=recovery, bump=bump)
    lgd = 1.0 - recovery
    o = netting_oracle(cfg, market, legs, freq=freq, start=start,
                       quantile=quantile, hazard=curve,
                       recovery=recovery)
    r = price_netting(cfg, key, market, legs, freq=freq, start=start,
                      quantile=quantile, hazard=curve, recovery=recovery,
                      n_paths=n_paths, n_blocks=n_blocks, rqmc=rqmc,
                      mesh=mesh)
    ee_mc = np.asarray(r.profile.ee, np.float64)
    ee_se = np.asarray(r.profile.ee_std_error, np.float64)
    ee_o = np.asarray(o.ee)
    deltas = tuple(float(lgd * np.dot(w, ee_o)) for w in rows)
    deltas_mc = tuple(float(lgd * np.dot(w, ee_mc)) for w in rows)
    bounds = tuple(float(lgd * np.dot(np.abs(w), ee_se)) for w in rows)
    return CS01Result(cva=o.cva, cva_mc=r.cva, cva_se=r.std_error,
                      deltas=deltas, deltas_mc=deltas_mc,
                      delta_bounds=bounds, quotes=quotes, bump=bump)
