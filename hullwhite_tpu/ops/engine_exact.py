"""Exact functional-sampling engine — distributionally exact, minimal RNG.

The observation that unlocks speed-of-light pricing: all
quantities the reference ever extracts from a simulated path are *linear
functionals of the Brownian increments* (see engine_linear), hence jointly
Gaussian with covariance computable in closed form from the shock-weight
matrix:

    Q1:    (I(T_1) .. I(T_{n_mat-1}))  ~  N(c,  sig_st^2 * Ws^T Ws)
    Q2/Q3: (r(S1), I(S1))              ~  N((c_r, c_I),  sig_st^2 * Sigma2)

So instead of simulating n_steps Gaussian shocks per path (the reference
burns its GPU on 2^31 cuRAND draws + SDE steps, market_data.cuh:43-67), we
sample the functionals DIRECTLY through the Cholesky factor:

    z = x @ L^T,   x ~ N(0, I_k),   k = n_mat-1 (Q1) or 2 (Q2/Q3)

This produces estimators with *identical distribution* to the step-by-step
simulation — not a variance reduction, not an approximation: the same
Monte Carlo estimator law, at 10x (Q1) to 250x (Q2) fewer random numbers
and zero sequential steps: the random-number generation and the
sequential stepping that dominate the reference's kernels shrink to a
small matmul.

Sigma-dependence stays scalar (z scales with sig_st = sigma * const), so
CRN (same x), antithetic (+/-z), and the vega tangent (dz/dsigma = z/sigma)
all carry over from engine_linear unchanged.

Cholesky factors are computed on the host in float64 (cached per config)
from the same fp64 shock shapes engine_linear uses.
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from ..config import HWConfig
from ..models.hull_white import StepTables
from .engine_scan import DualState, PathState
from .engine_linear import CurveWeights, ZBCWeights, _curve_shape, _det_integrals, _shock_shapes
from .engine_linear import zbc_weights as _linear_zbc_weights


@lru_cache(maxsize=None)
def curve_chol(cfg: HWConfig):
    """L with L L^T = Ws^T Ws (fp64), Ws = sigma-independent curve shock
    shapes; rows/cols = maturities 1..n_mat-1.  Returns fp32 L^T for the
    sampling matmul z = x @ L^T."""
    Ws = np.asarray(_curve_shape(cfg), np.float64)[:, 1:]  # (n_steps, n_mat-1)
    C = Ws.T @ Ws
    # jitter-free: C is positive definite by construction (full-rank columns)
    L = np.linalg.cholesky(C)
    return np.asarray(L.T, np.float32)  # (n_mat-1, n_mat-1), upper triangular


@lru_cache(maxsize=None)
def zbc_chol(cfg: HWConfig):
    """2x2 Cholesky of the sigma-independent covariance of (r(S1), I(S1))/sig_st.

    Returns scalars (l11, l21, l22):  z_r = l11 x1;  z_I = l21 x1 + l22 x2.
    """
    u, w = (np.asarray(a, np.float64) for a in _shock_shapes(cfg, cfg.n_steps_s1))
    c_rr = float(u @ u)
    c_ri = float(u @ w)
    c_ii = float(w @ w)
    l11 = np.sqrt(c_rr)
    l21 = c_ri / l11
    l22 = np.sqrt(c_ii - l21 * l21)
    return (l11, l21, l22)


def curve_weights(cfg: HWConfig, tables: StepTables) -> CurveWeights:
    """Same container as engine_linear but W holds sig_st * L^T (the
    (n_mat-1, n_mat-1) sampling matrix) instead of the (n_steps, n_mat)
    shock matrix."""
    dtype = tables.drift.dtype
    LT = tables.sig_st * jnp.asarray(curve_chol(cfg), dtype)
    stride = cfg.save_stride
    st = _det_integrals(cfg, tables)
    c = jnp.concatenate([jnp.zeros((1,), dtype), st[stride - 1:: stride]])
    return CurveWeights(W=LT, c=c)


def zbc_weights(cfg: HWConfig, tables: StepTables) -> ZBCWeights:
    """Same container as engine_linear but U holds the 2x2 factor sig_st*L^T."""
    l11, l21, l22 = zbc_chol(cfg)
    dtype = tables.drift.dtype
    LT = tables.sig_st * jnp.asarray(
        np.array([[l11, l21], [0.0, l22]]), dtype)  # (2, 2): z = x @ LT
    lin = _linear_zbc_weights(cfg, tables)  # reuse its deterministic parts
    return ZBCWeights(U=LT, det=lin.det, sigma=tables.sigma, sig_st=tables.sig_st)


# ---------------------------------------------------------------------------
# Block evaluators: X is a standard-normal block of shape (block, k)
# ---------------------------------------------------------------------------

def curve_discount_sums(cfg: HWConfig, cw: CurveWeights, X):
    """(n_mat,) discount sums over both antithetic legs from
    X ~ N(0, I_{n_mat-1})."""
    z = jnp.dot(X, cw.W, preferred_element_type=jnp.float32,
                precision=cfg.matmul_precision)
    c = cw.c[1:][None, :]
    contrib = jnp.exp(-(c + z)) + jnp.exp(-(c - z))
    sums = jnp.sum(contrib, axis=0)
    return jnp.concatenate(
        [jnp.full((1,), 2.0 * X.shape[0], sums.dtype), sums])


def antithetic_state(cfg: HWConfig, zw: ZBCWeights, X) -> PathState:
    z = jnp.dot(X, zw.U, preferred_element_type=jnp.float32,
                precision=cfg.matmul_precision)
    c_r, c_i = zw.det[0], zw.det[1]
    return PathState(
        r_p=c_r + z[:, 0], r_m=c_r - z[:, 0],
        i_p=c_i + z[:, 1], i_m=c_i - z[:, 1],
    )


def dual_state(cfg: HWConfig, zw: ZBCWeights, X) -> DualState:
    z = jnp.dot(X, zw.U, preferred_element_type=jnp.float32,
                precision=cfg.matmul_precision)
    c_r, c_i, c_dr, c_di = zw.det[0], zw.det[1], zw.det[2], zw.det[3]
    return DualState(
        r=c_r + z[:, 0],
        dr=c_dr + z[:, 0] / zw.sigma,
        i_r=c_i + z[:, 1],
        di_r=c_di + z[:, 1] / zw.sigma,
    )
