"""Bermudan swaptions / coupon-bond options: two-pass Longstaff-Schwartz
lower bound + Andersen-Broadie dual upper bound + near-exact DP oracle.

A multi-date extension of the exact functional engine: the state the policy
needs — (r(e_1), I(e_1), ..., r(e_k), I(e_k)) at the exercise dates — is
jointly Gaussian with covariance computable from the same shock shapes as
everything else, so Bermudan paths are sampled EXACTLY with 2k normals per
path (no time stepping, no discretization of the policy dates).

Pricing (cf. the regression-based literature in PAPERS.md):

* LOWER bound: backward induction over exercise dates, regressing realized
  discounted continuation on a basis [1, r, r^2, r^3, V_bond(r)] over
  in-the-money paths (ridge-regularized normal equations on device); the
  TWO-PASS split (policy estimated on one path set, price evaluated
  out-of-sample on independent paths) removes foresight bias, so the price
  is a true lower bound in expectation.  The evaluation pass streams path
  blocks (lax.map over folded keys) so the SE-determining sample size is
  unbounded by memory, and can optionally use randomized QMC (2k-dim
  scrambled Sobol from ops.sobol).

* UPPER bound: Andersen-Broadie duality, price <= E[max_j (Z_j - M_j)]
  for ANY martingale M.  M is built from a PIECEWISE value proxy that
  mirrors the true value function's structure: below the (policy)
  exercise boundary r*_j the proxy IS the intrinsic value
  sum_i cA_i e^{-B_i r} - K, above it a cubic continuation fit; the
  one-step conditional expectations E[e^{-dI} V^_j(r_t) | r_s] that make
  M a martingale are CLOSED FORM on both sides (Gaussian exponential
  tilting + truncated-lognormal means for the exponential terms,
  truncated Gaussian power moments for the polynomial terms), so no
  nested simulation is needed — the reference's GPU literature pays an
  inner simulation per date here.  At the LAST date the proxy equals the
  exact payoff (boundary = the strike root, zero continuation), so a
  single-date "Bermudan" upper bound is the closed-form European price
  with ~zero variance.

* ORACLE: r(t) is 1-d Gauss-Markov, so the true Bermudan price is a 1-d
  dynamic program: V_j(r) = max(payoff_j(r), E[e^{-dI} V_{j+1}(r_t)|r_s]),
  evaluated in float64 on a fine grid with Gauss-Hermite quadrature and
  the same closed-form discount tilting.  ``dp_oracle`` is exact up to
  quadrature/interpolation error (~1e-6) and pins BOTH Monte Carlo bounds
  in tests — far stronger than bracket-width checks alone.

Sanity identities tested: one exercise date == European (Jamshidian);
lower <= oracle <= upper within MC noise; more dates never cheapen.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import NamedTuple, Sequence

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from .config import HWConfig
from .models import hull_white as hw
from .models.hull_white import MarketCurve
from .instruments import CouponSchedule, _bond_value_terms
from .ops.engine_linear import _shock_shapes, det_trajectory
# accurate software exp/pdf: a hardware fp32 exp can carry a mean
# relative bias (one accelerator measured -8.4e-7, 40 ulp max) that
# composes into a -2e-6 bracket floor; exp32 is ~1 ulp unbiased on every
# backend, so device fp32 == CPU fp32 == fp64 oracle to ~1e-7 and the
# bracket needs no device allowance (ops/accurate.py)
from .ops.accurate import exp32 as _exp, npdf as _npdf
from .parallel import mesh as pmesh

BASIS_DEGREE = 3   # polynomial part of the basis: [1, r, r^2, r^3]
RIDGE = 1e-9


def _step_index(cfg: HWConfig, t: float) -> int:
    n = int(round(t / cfg.dt))
    if abs(n * cfg.dt - t) > 1e-9 or not (0 < n <= cfg.n_steps):
        raise ValueError(f"exercise date {t} must sit on the step grid")
    return n


@lru_cache(maxsize=None)
def _joint_chol(cfg: HWConfig, ex_dates: tuple):
    """fp64 Cholesky^T of the (2k, 2k) covariance of
    (r(e_1), I(e_1), ..., r(e_k), I(e_k)) / sig_st."""
    k = len(ex_dates)
    U = np.zeros((cfg.n_steps, 2 * k))
    for j, t in enumerate(ex_dates):
        n = _step_index(cfg, t)
        u, w = _shock_shapes(cfg, n)
        U[:n, 2 * j] = np.asarray(u, np.float64)
        U[:n, 2 * j + 1] = np.asarray(w, np.float64)
    C = U.T @ U + RIDGE * np.eye(2 * k)
    L = np.linalg.cholesky(C)
    return np.asarray(L.T, np.float32)  # z = x @ L^T


@lru_cache(maxsize=None)
def _functional_chol(cfg: HWConfig, specs: tuple):
    """fp64 Cholesky^T of the covariance of an arbitrary tuple of
    functionals, specs = (("r"|"I", t), ...), per unit sig_st.  The
    generalization of _joint_chol that samples ONLY the quantities a
    payoff touches — the multi-date exotics draw (r at observations,
    I at payments) directly in payoff order, with no gathers or strided
    slices in the kernel."""
    U = np.zeros((cfg.n_steps, len(specs)))
    for c, (kind, t) in enumerate(specs):
        n = _step_index(cfg, t)
        u, w = _shock_shapes(cfg, n)
        U[:n, c] = np.asarray(u if kind == "r" else w, np.float64)
    C = U.T @ U + RIDGE * np.eye(len(specs))
    L = np.linalg.cholesky(C)
    return np.asarray(L.T, np.float32)  # z = x @ L^T


@lru_cache(maxsize=None)
def _det_affine(cfg: HWConfig):
    """Host fp64 affine decomposition of the deterministic (G = 0) path:
    drift = base + c psi with c = 0.5 (sigma^2 - sigma0^2), and the
    recursion r' = r E + drift, I += (r + r')dt/2 is linear in drift, so
    r_n = rA_n + c rB_n and I_n = iA_n + c iB_n.  Precomputing (rA, rB,
    iA, iB) once removes the per-call 1000-step lax.scan
    (det_trajectory) from the exotic pricers' hot graphs."""
    host = hw.host_tables(cfg)
    E, dt = host["E"], cfg.dt

    def roll(drift, r0):
        rs = np.empty(cfg.n_steps)
        Is = np.empty(cfg.n_steps)
        r, integral = r0, 0.0
        for nstep in range(cfg.n_steps):
            r_next = r * E + drift[nstep]
            integral += 0.5 * (r + r_next) * dt
            rs[nstep] = r_next
            Is[nstep] = integral
            r = r_next
        return rs, Is

    rA, iA = roll(np.asarray(host["base"], np.float64), cfg.r0)
    rB, iB = roll(np.asarray(host["psi"], np.float64), 0.0)
    return rA, rB, iA, iB


@lru_cache(maxsize=None)
def _functional_det_affine(cfg: HWConfig, specs: tuple):
    """(detA, detB) fp32 arrays so the deterministic part of each spec
    functional is detA + 0.5 (sigma^2 - sigma0^2) detB — exact (the path
    is affine in the drift), differentiable in sigma, and scan-free."""
    rA, rB, iA, iB = _det_affine(cfg)
    A, B = [], []
    for kind, t in specs:
        nidx = _step_index(cfg, t) - 1
        A.append(rA[nidx] if kind == "r" else iA[nidx])
        B.append(rB[nidx] if kind == "r" else iB[nidx])
    # numpy, not jnp: this is lru-cached and a jnp constant materialized
    # inside one jit trace must not leak into another
    return (np.asarray(A, np.float32), np.asarray(B, np.float32))


def _functional_det(cfg: HWConfig, sigma, specs: tuple, sigma0=None):
    """(len(specs),) deterministic parts matching _functional_chol."""
    if sigma0 is None:
        sigma0 = cfg.sigma
    A, B = _functional_det_affine(cfg, specs)
    return (jnp.asarray(A)
            + 0.5 * (sigma * sigma - jnp.float32(sigma0) ** 2)
            * jnp.asarray(B))


@lru_cache(maxsize=None)
def _interval_params(cfg: HWConfig, ex_dates: tuple):
    """fp64 conditional-Gaussian parameters of each exercise interval.

    For interval i (from s = e_{i-1}, with e_0 = 0, to t = e_i), writing
    centered variables per unit sig_st, conditional on r_s:

      r_t | r_s  ~  N( rdet_t + bt (r_s - rdet_s),  sig^2 vt )
      dI  | r_s  ~  N( didet  + bI (r_s - rdet_s),  sig^2 vI )
      Cov(r_t, dI | r_s) = sig^2 ctI

    Returns a list of dicts {bt, bI, vt, vI, ctI} (sig-independent; the
    deterministic parts come from the runtime drift tables).
    """
    out = []
    prev_n = 0
    u_prev = w_prev = None
    for t in ex_dates:
        n = _step_index(cfg, t)
        u_cur, w_cur = (np.asarray(a, np.float64)
                        for a in _shock_shapes(cfg, n))
        d = w_cur.copy()
        if prev_n:
            d[:prev_n] -= w_prev
            up = np.zeros(n)
            up[:prev_n] = u_prev
        else:
            up = np.zeros(n)
        v_ss = float(up @ up)
        c_st = float(up @ u_cur)
        v_tt = float(u_cur @ u_cur)
        c_sI = float(up @ d)
        c_tI = float(u_cur @ d)
        v_II = float(d @ d)
        if v_ss > 1e-14:
            bt, bI = c_st / v_ss, c_sI / v_ss
            vt = v_tt - c_st * c_st / v_ss
            vI = v_II - c_sI * c_sI / v_ss
            ctI = c_tI - c_st * c_sI / v_ss
        else:
            bt = bI = 0.0
            vt, vI, ctI = v_tt, v_II, c_tI
        out.append(dict(bt=bt, bI=bI, vt=vt, vI=vI, ctI=ctI))
        prev_n, u_prev, w_prev = n, u_cur, w_cur
    return tuple(out)


def _det_states(cfg: HWConfig, tables, ex_dates: tuple):
    """(k,) deterministic r and I at the exercise dates (G = 0 scan)."""
    rs, Is = det_trajectory(cfg, tables)
    idx = jnp.asarray([_step_index(cfg, t) - 1 for t in ex_dates])
    return rs[idx], Is[idx]


# ---------------------------------------------------------------------------
# Regression basis: [1, r~, r~^2, r~^3, V_bond(r)] — a fixed function of r
# per date (model statistics, never batch statistics: the out-of-sample
# pass must apply the SAME policy or the lower-bound guarantee is lost).
# ---------------------------------------------------------------------------

def _vb_norms(mu, sd, cA, B, v0):
    """Linear-detrend slope and curvature scale of the bond-value feature
    at the model mean (both deterministic functions of the date): the raw
    V_bond(r)/v0 is ~0.999-correlated with the linear term over the state
    range, which makes the fp32 normal equations solve unstable (observed:
    compiled vs eager solutions diverged).  The detrended, curvature-
    rescaled residual is O(r~^2)-shaped and well conditioned."""
    e = cA * _exp(-B * mu)
    c1 = -sd * jnp.sum(e * B) / v0
    c2 = 0.5 * sd * sd * jnp.sum(e * B * B) / v0
    return c1, c2


def _poly_basis(r, mu, sd):
    """The polynomial columns only (the dual value proxy / gamma fits);
    avoids evaluating the per-cashflow exponentials of the bond feature
    just to slice them away."""
    rt = (r - mu) / sd
    return jnp.stack([rt ** p for p in range(BASIS_DEGREE + 1)], axis=1)


def _basis(r, mu, sd, cA, B, v0):
    """Policy basis: [1, r~, r~^2, r~^3, clip(V-residual)].  The bond
    feature is clipped at +/-8 (its exponential tails otherwise dominate
    the fp32 Gram matrix); the policy may be ANY fixed function of r, so
    clipping costs nothing in lower-bound validity.  The dual value proxy
    uses only the polynomial columns (closed-form expectations)."""
    rt = (r - mu) / sd
    vb = jnp.sum(cA[None, :] * _exp(-B[None, :] * r[:, None]), axis=1)
    c1, c2 = _vb_norms(mu, sd, cA, B, v0)
    feat = jnp.clip((vb / v0 - 1.0 - c1 * rt) / c2, -8.0, 8.0)
    cols = [rt ** p for p in range(BASIS_DEGREE + 1)] + [feat]
    return jnp.stack(cols, axis=1)


def _wls(X, y, w, prec):
    """Weighted least squares by QR (normal equations in fp32 were
    observed to flip solutions between compiled and eager execution on
    this basis; QR is backward-stable)."""
    sw = jnp.sqrt(w)[:, None]
    Xw = jnp.concatenate(
        [X * sw, math.sqrt(RIDGE) * jnp.eye(X.shape[1], dtype=X.dtype)])
    yw = jnp.concatenate([y * sw[:, 0], jnp.zeros((X.shape[1],), X.dtype)])
    Q, R = jnp.linalg.qr(Xw)
    return jax.scipy.linalg.solve_triangular(
        R, jnp.dot(Q.T, yw, precision=prec), lower=False)


def _piecewise_value(r, gamma, mu, sd, cA, B, strike, rstar, sg, prec):
    """The dual value proxy V^(r): intrinsic sg*(V_bond(r) - K) on the
    exercise side of the boundary r* (sg = +1 receiver exercises at LOW r,
    sg = -1 payer at HIGH r), cubic gamma . poly(r~) on the other side.
    The poly dot must run at cfg.matmul_precision: _piecewise_cond is the
    EXACT conditional expectation of this proxy, so any rounding here is a
    systematic martingale defect in the dual increments."""
    vb = jnp.sum(cA[None, :] * _exp(-B[None, :] * r[:, None]), axis=1)
    intr = sg * (vb - strike)
    poly = jnp.dot(_poly_basis(r, mu, sd), gamma, precision=prec)
    return jnp.where(sg * (rstar - r) > 0, intr, poly)


def _piecewise_cond(gamma, mu, sd, cA, B, strike, rstar, sg,
                    m_t, v_t, mI, vI, ctI):
    """E[ e^{-dI} V^(r_t) | r_s ] for the piecewise proxy, closed form.

    (r_t, dI) | r_s is bivariate normal with means (m_t, mI) (arrays over
    paths) and scalar (v_t, vI, ctI).  Tilting by e^{-dI} multiplies by
    w0 = e^{-mI + vI/2} and shifts r_t's mean to m = m_t - ctI.  Then with
    r ~ N(m, v_t):

    * exponential terms on the exercise side ({r < r*} receiver):
      E[e^{-B r} 1{r<c}] = e^{-B m + B^2 v/2} Phi((c - m + B v)/s)
      (a truncated-lognormal mean); the payer side mirrors via sg.
    * polynomial terms on the continuation side: truncated Gaussian power
      moments of y = (r - mu)/sd by the standard recursion
      E[y^p 1{y>c}] = my T_{p-1} + (p-1) vy T_{p-2} + sy c^{p-1} phi(a).

    Both families are exact, so M built from these increments is an exact
    martingale and the AB bound is valid (not just asymptotically).
    """
    from jax.scipy.stats import norm as jnorm

    w0 = _exp(-mI + 0.5 * vI)
    m = m_t - ctI                      # per-path tilted mean
    s = jnp.sqrt(v_t)
    # --- intrinsic side: sg * (sum_i cA_i e^{-B_i r} - K) ---
    eterm = _exp(-B[None, :] * m[:, None]
                    + 0.5 * (B * B)[None, :] * v_t)
    argB = sg * (rstar - m[:, None] + B[None, :] * v_t) / s
    e_intr = jnp.sum(cA[None, :] * eterm * jnorm.cdf(argB), axis=1)
    e_intr = sg * (e_intr - strike * jnorm.cdf(sg * (rstar - m) / s))
    # --- polynomial side (the complement): truncated power moments ---
    my = (m - mu) / sd
    vy = v_t / (sd * sd)
    sy = s / sd
    cy = (rstar - mu) / sd
    alpha = (cy - my) / sy
    phi_a = _npdf(alpha)
    # upper moments T_p = E[y^p 1{y > cy}]
    T = [jnorm.cdf(-alpha)]
    T.append(my * T[0] + sy * phi_a)
    T.append(my * T[1] + vy * T[0] + sy * cy * phi_a)
    T.append(my * T[2] + 2.0 * vy * T[1] + sy * cy * cy * phi_a)
    if sg < 0:  # payer: continuation side is r < c -> lower = full - upper
        full = [jnp.ones_like(my), my, my * my + vy, my ** 3 + 3 * my * vy]
        T = [f - t for f, t in zip(full, T)]
    e_poly = sum(gamma[p] * T[p] for p in range(BASIS_DEGREE + 1))
    return w0 * (e_intr + e_poly)


def _bisect(f, a, b, iters=60):
    """Scalar bisection assuming f(a) > 0 > f(b); a, b may be traced and
    need not be ordered.  Unrolled (static trip count) for jit."""
    a = jnp.asarray(a, jnp.float32)
    b = jnp.asarray(b, jnp.float32)
    for _ in range(iters):
        mid = 0.5 * (a + b)
        pos = f(mid) > 0
        a = jnp.where(pos, mid, a)
        b = jnp.where(pos, b, mid)
    return 0.5 * (a + b)


class BermudanResult(NamedTuple):
    price: jax.Array            # out-of-sample LSMC lower bound
    price_in_sample: jax.Array  # in-sample (upward-biased)
    std_error: jax.Array        # out-of-sample SE
    upper: jax.Array            # Andersen-Broadie dual upper bound
    upper_std_error: jax.Array
    n_paths: int
    exercise_dates: tuple
    # martingale-CV lower bound: same expectation as `price` (optional
    # stopping: E[M_tau] = 0), variance collapsed by subtracting the
    # dual's exact martingale at the policy's stopping time
    price_cv: jax.Array | None = None
    cv_std_error: jax.Array | None = None


@lru_cache(maxsize=None)
def _bermudan_fn(cfg: HWConfig, ex_dates: tuple, sched: CouponSchedule,
                 strike: float, payer: bool, n_paths: int, n_blocks: int,
                 rqmc: bool, mesh=None):
    k = len(ex_dates)
    LT = jnp.asarray(_joint_chol(cfg, ex_dates))
    ivp = _interval_params(cfg, ex_dates)

    def states_from_normals(x, sigma, tables):
        z = tables.sig_st * jnp.dot(x, LT,
                                    preferred_element_type=jnp.float32,
                                    precision=cfg.matmul_precision)
        r_det, i_det = _det_states(cfg, tables, ex_dates)
        return r_det[None, :] + z[:, 0::2], i_det[None, :] + z[:, 1::2]

    def payoff_terms(j, sigma, market):
        cA, B = _bond_value_terms(cfg, sigma, market, sched, t=ex_dates[j])
        return cA, B

    def payoff_at(r_j, cA, B):
        V = jnp.sum(cA[None, :] * _exp(-B[None, :] * r_j[:, None]),
                    axis=1)
        intrinsic = (strike - V) if payer else (V - strike)
        return jnp.maximum(intrinsic, 0.0)

    def model_stats(sigma, tables):
        r_det, _ = _det_states(cfg, tables, ex_dates)
        sds = tables.sig_st * jnp.asarray(
            [float(np.linalg.norm(
                _shock_shapes(cfg, _step_index(cfg, t))[0], ord=2))
             for t in ex_dates], jnp.float32)
        return r_det, sds

    def backward(r, integral, sigma, market, stats, terms, v0s,
                 betas=None, fit_value=False):
        """LSMC backward induction; optionally also fit the dual value
        proxy's continuation coefficients gamma_j on the continuation-
        region paths (the exercise side of the proxy is exact intrinsic).
        """
        prec = cfg.matmul_precision
        D = _exp(-integral)
        cf = payoff_at(r[:, k - 1], *terms[k - 1]) * D[:, k - 1]
        stop = jnp.full((r.shape[0],), k - 1, jnp.int32)
        est = betas is None
        out_betas = [None] * max(k - 1, 0)
        # last-date value proxy: the exact payoff (zero continuation fit)
        gammas = [None] * (k - 1) + [jnp.zeros((BASIS_DEGREE + 1,),
                                               jnp.float32)]
        for j in range(k - 2, -1, -1):
            pj = payoff_at(r[:, j], *terms[j])
            X = _basis(r[:, j], stats[0][j], stats[1][j], *terms[j], v0s[j])
            y = cf / D[:, j]
            itm = (pj > 0.0).astype(jnp.float32)
            if est:
                beta = _wls(X, y, itm, prec)
                out_betas[j] = beta
            else:
                beta = betas[j]
            cont = jnp.dot(X, beta, precision=prec)
            exercise = (pj > cont) & (pj > 0.0)
            if fit_value:
                # continuation proxy for the dual: fit the REALIZED
                # continuation value on the continuation-region paths (the
                # exercise side of the piecewise proxy is exact intrinsic,
                # so the fit only has to be good where it is used)
                wc = 1.0 - exercise.astype(jnp.float32)
                gammas[j] = _wls(X[:, :BASIS_DEGREE + 1], y, wc, prec)
            cf = jnp.where(exercise, pj * D[:, j], cf)
            stop = jnp.where(exercise, j, stop)
        return cf, out_betas, gammas, stop

    sg = 1.0 if not payer else -1.0   # receiver exercises at LOW r

    def exercise_boundaries(stats, terms, v0s, betas):
        """Per-date boundary r*_j of the fitted policy (last date: the
        strike root).  g(r) = intrinsic - max(cont, 0) is positive exactly
        on the policy's exercise set {pj > 0 and pj > cont}; a 60-step
        bisection between the deep-in-the-money end and the strike root
        locates its crossing.  If the fitted cubic refuses exercise even
        deep ITM, bisection collapses to the far end and the exercise side
        of the piecewise proxy becomes (harmlessly) empty."""
        rstars = []
        for j in range(k):
            cA, B = terms[j]
            mu, sd = stats[0][j], stats[1][j]

            def intr(rv, cA=cA, B=B):
                return sg * (jnp.sum(cA * _exp(-B * rv)) - strike)

            far = mu - sg * 14.0 * sd          # deep ITM end
            r_k = _bisect(intr, far, mu + sg * 14.0 * sd)
            if j == k - 1:
                rstars.append(r_k)             # exact payoff proxy
                continue
            beta, v0 = betas[j], v0s[j]

            def g(rv, cA=cA, B=B, mu=mu, sd=sd, beta=beta, v0=v0):
                rv1 = jnp.reshape(rv, (1,))
                cont = jnp.dot(_basis(rv1, mu, sd, cA, B, v0), beta,
                               precision=cfg.matmul_precision)[0]
                return intr(rv) - jnp.maximum(cont, 0.0)

            rstars.append(_bisect(g, far, r_k))
        return rstars

    def dual_path_bound(r, integral, tables, stats, terms, gammas, rstars):
        """max_j (Z_j - M_j) per path: the AB dual with the closed-form
        martingale increments of the piecewise value proxy (no nested
        simulation)."""
        sig2 = tables.sig_st * tables.sig_st
        r_det, i_det = _det_states(cfg, tables, ex_dates)
        D = _exp(-integral)
        M = jnp.zeros((r.shape[0],), jnp.float32)
        Ms = []       # M after each date's increment (for M_tau)
        best = None   # initialized from the first date (no -inf literal:
        # an infinity constant in the traced graph can surface as NaN
        # under XLA fusion in some branch combinations)
        for j in range(k):
            p = ivp[j]
            if j == 0:
                r_s = jnp.full((r.shape[0],), cfg.r0, jnp.float32)
                D_prev = jnp.ones_like(M)
                rdet_s = jnp.float32(cfg.r0)
                didet = i_det[0]
            else:
                r_s = r[:, j - 1]
                D_prev = D[:, j - 1]
                rdet_s = r_det[j - 1]
                didet = i_det[j] - i_det[j - 1]
            m_t = r_det[j] + jnp.float32(p["bt"]) * (r_s - rdet_s)
            mI = didet + jnp.float32(p["bI"]) * (r_s - rdet_s)
            v_t = sig2 * jnp.float32(p["vt"])
            vI = sig2 * jnp.float32(p["vI"])
            ctI = sig2 * jnp.float32(p["ctI"])
            cA, B = terms[j]
            mu, sd = stats[0][j], stats[1][j]
            cond = _piecewise_cond(gammas[j], mu, sd, cA, B, strike,
                                   rstars[j], sg, m_t, v_t, mI, vI, ctI)
            vhat = _piecewise_value(r[:, j], gammas[j], mu, sd, cA, B,
                                    strike, rstars[j], sg,
                                    cfg.matmul_precision)
            M = M + D[:, j] * vhat - D_prev * cond
            Ms.append(M)
            Z = D[:, j] * payoff_at(r[:, j], *terms[j])
            best = Z - M if best is None else jnp.maximum(best, Z - M)
        return best, jnp.stack(Ms, axis=1)

    def compute(key, sigma, market):
        tables = hw.step_tables(cfg, sigma, cfg.sigma, jnp.float32)
        stats = model_stats(sigma, tables)
        terms = [payoff_terms(j, sigma, market) for j in range(k)]
        # bond value at the model-mean rate (basis normalizer)
        v0s = [jnp.sum(terms[j][0] * _exp(-terms[j][1] * stats[0][j]))
               for j in range(k)]
        k_est, k_val = jax.random.split(key)

        # --- pass 1: estimate policy + value proxy (single batch) ---
        x = jax.random.normal(k_est, (n_paths, 2 * k), jnp.float32)
        r_a, i_a = states_from_normals(x, sigma, tables)
        cf_in, betas, gammas, _ = backward(r_a, i_a, sigma, market,
                                           stats, terms, v0s,
                                           fit_value=True)
        p_in = jnp.mean(cf_in)
        rstars = exercise_boundaries(stats, terms, v0s, betas)

        # --- pass 2: out-of-sample lower + dual upper, block-streamed ---
        def block(b):
            if rqmc:
                from .ops.sobol import sobol

                shift = jax.random.bits(jax.random.fold_in(k_val, b),
                                        (2 * k,), jnp.uint32)
                x = jax.scipy.special.ndtri(sobol(n_paths, 2 * k, shift))
            else:
                x = jax.random.normal(jax.random.fold_in(k_val, b),
                                      (n_paths, 2 * k), jnp.float32)
            r_b, i_b = states_from_normals(x, sigma, tables)
            cf, _, _, stop = backward(r_b, i_b, sigma, market, stats,
                                      terms, v0s, betas=betas)
            u, Ms = dual_path_bound(r_b, i_b, tables, stats, terms,
                                    gammas, rstars)
            # martingale control variate for the lower bound: E[M_tau]=0
            # by optional stopping (tau adapted, M an exact martingale),
            # and cf ~ V0 + M_tau for a near-optimal policy/proxy, so
            # cf - M_tau has ~zero variance (same expectation as cf)
            m_tau = jnp.take_along_axis(Ms, stop[:, None], axis=1)[:, 0]
            cv = cf - m_tau
            return jnp.stack([jnp.sum(cf), jnp.sum(cf * cf),
                              jnp.sum(u), jnp.sum(u * u),
                              jnp.sum(cv), jnp.sum(cv * cv)])

        per_block = pmesh.map_blocks(block, n_blocks, mesh)  # (n_blocks, 6)
        sums = jnp.sum(per_block, axis=0)
        n_tot = 1.0 * n_paths * n_blocks
        p_out = sums[0] / n_tot
        up = sums[2] / n_tot
        p_cv = sums[4] / n_tot
        if rqmc:
            # within a block the Sobol points are deterministic given the
            # digital shift, so the iid pooled SE is invalid; the shifts
            # are the independent replicates (requires n_blocks >= 2)
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
        return p_out, p_in, se, up, up_se, p_cv, cv_se

    return jax.jit(compute)


def price_bermudan(cfg: HWConfig, key, market: MarketCurve,
                   sched: CouponSchedule, exercise_dates: Sequence[float],
                   *, strike: float = 1.0, payer: bool = False, sigma=None,
                   n_paths: int | None = None, n_blocks: int = 1,
                   rqmc: bool = False, mesh=None) -> BermudanResult:
    """Two-pass LSMC Bermudan price bracketed by the AB dual upper bound.

    ``n_paths`` is the per-block path count (the policy-estimation pass
    uses one block); the evaluation pass streams ``n_blocks`` independent
    blocks, so the total out-of-sample sample is n_paths * n_blocks with
    constant memory.  ``rqmc=True`` draws each evaluation block from a
    2k-dimensional digitally-shifted Sobol sequence instead (the shifts
    are the block replicates).
    """
    if sigma is None:
        sigma = cfg.sigma
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
    # convention: exercising exactly on a payment date forfeits that
    # payment (the `alive` mask in payoff_at is strict), i.e. exercise
    # happens immediately after the coupon.
    p_out, p_in, se, up, up_se, p_cv, cv_se = _bermudan_fn(
        cfg, ex, sched, float(strike), bool(payer), int(n_paths),
        int(n_blocks), bool(rqmc), mesh)(
        key, jnp.asarray(sigma, jnp.float32), market)
    return BermudanResult(price=p_out, price_in_sample=p_in, std_error=se,
                          upper=up, upper_std_error=up_se,
                          n_paths=int(n_paths) * int(n_blocks),
                          exercise_dates=ex, price_cv=p_cv,
                          cv_std_error=cv_se)


# ---------------------------------------------------------------------------
# Near-exact oracle: 1-d dynamic programming on the Gauss-Markov short rate
# ---------------------------------------------------------------------------

def dp_oracle(cfg: HWConfig, market: MarketCurve, sched: CouponSchedule,
              exercise_dates: Sequence[float], *, strike: float = 1.0,
              payer: bool = False, n_grid: int = 1501,
              width: float = 8.5, order: str = "cubic") -> float:
    """float64 Bermudan price by backward induction on an r-grid.

    V_k(r) = payoff_k(r); V_j(r) = max(payoff_j(r),
    E[e^{-dI} V_{j+1}(r') | r]).  The conditional expectation integrates
    an interpolant of V_{j+1} against the e^{-dI}-tilted Gaussian
    EXACTLY (Phi/phi closed forms per segment, flat tails) —
    Gauss-Hermite quadrature was tried first and converges slowly on the
    kinked value functions (~5e-5 residual).  The round-3 piecewise-
    LINEAR interpolant left an O(h^2) convexity bias (~+2e-6 at the
    default grid — enough to sit ABOVE the dual upper bounds in the
    k-sweep); the round-4 cubic-Hermite default (docs/MATH.md §38)
    removes it."""
    return dp_solution(cfg, market, sched, exercise_dates, strike=strike,
                       payer=payer, n_grid=n_grid, width=width,
                       order=order)["price"]


def dp_solution(cfg: HWConfig, market: MarketCurve, sched: CouponSchedule,
                exercise_dates: Sequence[float], *, strike: float = 1.0,
                payer: bool = False, n_grid: int = 1501,
                width: float = 8.5, order: str = "cubic") -> dict:
    """Full ``dp_oracle`` backward-induction solution, keeping the
    per-date grids for downstream consumers (the Bermudan exposure
    oracle's forward density propagation, xva.py): returns a dict with
    the exercise dates ``ex``, per-date r-``grids``, post-decision value
    ``V``, ``cont``inuation and ``payoff`` arrays, deterministic states
    ``r_det``/``i_det``, interval params ``ivp``, per-date state sds,
    ``sig`` and the rolled-back ``price``.

    order="cubic" (round-4 default, docs/MATH.md §38) integrates the
    C^1 cubic-Hermite interpolant exactly instead of the piecewise-
    linear one, removing the ~+2e-6 default-grid convexity bias that
    sat ABOVE the dual upper bounds in the k-sweep; "linear" restores
    the round-3 kernel (and is the fallback when only a pre-round-4
    native library is on disk)."""
    from scipy.stats import norm

    ex = tuple(sorted(float(t) for t in exercise_dates))
    k = len(ex)
    ivp = _interval_params(cfg, ex)
    tables = hw.step_tables(cfg, cfg.sigma, cfg.sigma, jnp.float32)
    r_det, i_det = (np.asarray(a, np.float64)
                    for a in _det_states(cfg, tables, ex))
    sig = float(tables.sig_st)
    sds = np.array([np.linalg.norm(np.asarray(
        _shock_shapes(cfg, _step_index(cfg, t))[0], np.float64))
        for t in ex]) * sig

    def payoff_np(j, r):
        cA, B = _bond_value_terms(cfg, cfg.sigma, market, sched, t=ex[j])
        cA = np.asarray(cA, np.float64)
        B = np.asarray(B, np.float64)
        V = np.sum(cA[None, :] * np.exp(-B[None, :] * r[:, None]), axis=1)
        return np.maximum((strike - V) if payer else (V - strike), 0.0)

    def exact_lin_expect(m, s, grid, V):
        """E[V^(X)], X ~ N(m, s^2) per element of m, with V^ the piecewise
        linear interpolant of (grid, V) and flat extrapolation.  (The
        production path runs the same sweep in the native C++ runtime,
        hw_dp_continuation; this is the NumPy reference/fallback,
        cross-checked by tests/test_native.py.)"""
        m = np.atleast_1d(m)
        t = (grid[None, :] - m[:, None]) / s          # (nm, ng)
        Phi = norm.cdf(t)
        phi = norm.pdf(t)
        b = np.diff(V) / np.diff(grid)                # (ng-1,)
        a = V[:-1] - b * grid[:-1]
        dPhi = Phi[:, 1:] - Phi[:, :-1]
        dphi = phi[:, 1:] - phi[:, :-1]
        mid = np.sum((a[None, :] + b[None, :] * m[:, None]) * dPhi
                     - b[None, :] * s * dphi, axis=1)
        return mid + V[0] * Phi[:, 0] + V[-1] * (1.0 - Phi[:, -1])

    from .utils import native as hw_native

    use_native = hw_native.available() and (
        order != "cubic" or hw_native.has_dp_cubic())

    def continuation(r_s, j_to, rdet_s, V):
        """cont(r_s) for the interval ending at date index j_to."""
        p = ivp[j_to]
        didet = i_det[j_to] - (i_det[j_to - 1] if j_to > 0 else 0.0)
        v_t, vI, ctI = (sig * sig * p["vt"], sig * sig * p["vI"],
                        sig * sig * p["ctI"])
        grid_t = grids[j_to]
        if use_native:
            return hw_native.dp_continuation(
                r_s, grid_t, V, rdet_s, r_det[j_to], didet,
                p["bt"], p["bI"], v_t, vI, ctI, order=order)
        m_t = r_det[j_to] + p["bt"] * (r_s - rdet_s)
        mI = didet + p["bI"] * (r_s - rdet_s)
        w0 = np.exp(-mI + 0.5 * vI)
        if order == "cubic":
            from .range_note import _kernel_avg

            return w0 * _kernel_avg(m_t - ctI, math.sqrt(v_t), grid_t, V,
                                    order="cubic")
        return w0 * exact_lin_expect(m_t - ctI, math.sqrt(v_t), grid_t, V)

    grids = [r_det[j] + sds[j] * np.linspace(-width, width, n_grid)
             for j in range(k)]
    payoffs = [payoff_np(j, grids[j]) for j in range(k)]
    Vs = [None] * k
    conts = [None] * k
    Vs[k - 1] = payoffs[k - 1]
    conts[k - 1] = np.zeros(n_grid)
    for j in range(k - 2, -1, -1):
        conts[j] = continuation(grids[j], j + 1, r_det[j], Vs[j + 1])
        Vs[j] = np.maximum(payoffs[j], conts[j])
    # discount from e_1 to 0 (deterministic start r(0) = r0)
    price = float(continuation(np.array([cfg.r0]), 0, cfg.r0, Vs[0])[0])
    return dict(ex=ex, grids=grids, V=Vs, cont=conts, payoff=payoffs,
                r_det=r_det, i_det=i_det, ivp=ivp, sds=sds, sig=sig,
                price=price)

