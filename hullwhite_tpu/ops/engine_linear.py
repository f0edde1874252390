"""Linear-functional (matmul) simulation engine — the full-step tier.

The exact-discretization Hull-White recursion is *affine in the Gaussian
shocks*:

    r_n      = det_r(n)  + sig_st * sum_i E^{n-1-i} G_i
    I_n      = det_I(n)  + sum_i w(n-1-i) G_i,
    w(m)     = sig_st * dt * [ (1 - E^m)/(1 - E) + E^m / 2 ]     (E = e^{-a dt})

(the w(m) row follows from pushing each shock through the trapezoid
integral: shock i enters r_k for all k > i with weight E^{k-1-i}, and I_n
weights interior r_k by dt and the endpoint r_n by dt/2).

So the whole 1000-step simulation collapses to ONE matmul

    Z = G @ W            # (paths, steps) @ (steps, functionals)

followed by elementwise payoff math — this is where the reference's 2^30
sequential SDE steps (market_data.cuh:43-67) become matmul work.  Consequences:

* antithetic legs are +/-Z from one matmul (no second pass);
* the strided 101-maturity accumulation of ``simulate_zcb``
  (market_data.cuh:56-78, SURVEY C19) is just 101 columns of W — no shared
  memory, no atomics, no scatter;
* the vega tangent process costs nothing extra: its stochastic part is
  Z / sigma (the tangent shock scale is sig_st/sigma with the same decay),
  only its deterministic part differs;
* CRN finite differences reuse G and rebuild W(sigma) — exact common random
  numbers with zero state copying (vs 3_sensitivity_analysis.cu:407-435).

Deterministic parts are obtained by running the scan engine once with G = 0
(one path, n_steps scalar FMAs) so both engines share step semantics
bit-for-bit on the drift path.

All results are algebraically identical to the scan engine; fp32 matmul
accumulation is in fact *better*-conditioned than the sequential trapezoid.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import HWConfig
from ..models.hull_white import StepTables, host_tables
from .engine_scan import DualState, PathState
from .engine_scan import dual_state as _scan_dual_state


class CurveWeights(NamedTuple):
    W: jax.Array  # (n_steps, n_mat)  dI(T_m)/dG_i
    c: jax.Array  # (n_mat,)          deterministic I(T_m)


class ZBCWeights(NamedTuple):
    U: jax.Array    # (n1, 2) columns [dr(S1)/dG_i, dI(S1)/dG_i]
    det: jax.Array  # (4,) [r_det, I_det, dr_det, dI_det] at S1
    sigma: jax.Array
    sig_st: jax.Array


@lru_cache(maxsize=None)
def _shock_shapes(cfg: HWConfig, n: int):
    """Host fp64 sigma-independent shapes of (dr_n/dG_i, dI_n/dG_i) / sig_st.

    With m = n-1-i:  dr/dG_i = sig_st E^m,
                     dI/dG_i = sig_st dt [ (1-E^m)/(1-E) + E^m/2 ].
    Computed in float64 because E^m in on-device fp32 exp/log loses ~m ulps.
    """
    E = host_tables(cfg)["E"]
    m = (n - 1) - np.arange(n, dtype=np.float64)
    Em = np.exp(np.log(E) * m)
    u_shape = Em
    w_shape = cfg.dt * ((1.0 - Em) / (1.0 - E) + 0.5 * Em)
    return (np.asarray(u_shape, np.float32), np.asarray(w_shape, np.float32))


@lru_cache(maxsize=None)
def _curve_shape(cfg: HWConfig):
    """Host fp64 sigma-independent shape of W: W[i,m] = sig_st * shape."""
    E = host_tables(cfg)["E"]
    stride, n_mat = cfg.save_stride, cfg.n_mat
    ii = np.arange(cfg.n_steps, dtype=np.float64)[:, None]
    nn = (np.arange(n_mat, dtype=np.float64) * stride)[None, :]
    m = nn - 1.0 - ii
    Em = np.exp(np.log(E) * m)
    w = cfg.dt * ((1.0 - Em) / (1.0 - E) + 0.5 * Em)
    return np.asarray(np.where(ii < nn, w, 0.0), np.float32)


def curve_weights(cfg: HWConfig, tables: StepTables) -> CurveWeights:
    """W[i, m] = dI(T_m)/dG_i and the deterministic curve c[m] = det I(T_m)."""
    dtype = tables.drift.dtype
    stride = cfg.save_stride
    W = tables.sig_st * jnp.asarray(_curve_shape(cfg), dtype)

    # Deterministic I at every step via the scan recursion with G = 0.
    st = _det_integrals(cfg, tables)
    c = jnp.concatenate([jnp.zeros((1,), dtype), st[stride - 1:: stride]])
    return CurveWeights(W=W, c=c)


def det_trajectory(cfg: HWConfig, tables: StepTables):
    """Deterministic (r_n, I_n) for every step n (G = 0 scan)."""
    dtype = tables.drift.dtype

    def step(carry, drift):
        r, integral = carry
        r_next = r * tables.exp_adt + drift
        integral = integral + 0.5 * (r + r_next) * tables.dt
        return (r_next, integral), (r_next, integral)

    (_, _), (rs, integrals) = jax.lax.scan(
        step, (jnp.asarray(cfg.r0, dtype), jnp.zeros((), dtype)), tables.drift
    )
    return rs, integrals


def _det_integrals(cfg: HWConfig, tables: StepTables):
    """Deterministic I_n for every step n (G = 0), shape (n_steps,)."""
    return det_trajectory(cfg, tables)[1]


def zbc_weights(cfg: HWConfig, tables: StepTables) -> ZBCWeights:
    """Functionals for the option leg: r(S1), I(S1) and the tangent pair."""
    n1 = cfg.n_steps_s1
    u_shape, w_shape = _shock_shapes(cfg, n1)
    U = tables.sig_st * jnp.stack(
        [jnp.asarray(u_shape, tables.drift.dtype),
         jnp.asarray(w_shape, tables.drift.dtype)], axis=1)
    d = _scan_dual_state(cfg, tables, jnp.zeros((1, n1), tables.drift.dtype))
    det = jnp.stack([d.r[0], d.i_r[0], d.dr[0], d.di_r[0]])
    return ZBCWeights(U=U, det=det, sigma=tables.sigma, sig_st=tables.sig_st)


# ---------------------------------------------------------------------------
# Block evaluators (same signatures/semantics as engine_scan)
# ---------------------------------------------------------------------------

def curve_discount_sums(cfg: HWConfig, cw: CurveWeights, G):
    """(n_mat,) per-maturity discount sums over both antithetic legs."""
    z = jnp.dot(G, cw.W, preferred_element_type=jnp.float32,
                precision=cfg.matmul_precision)
    contrib = jnp.exp(-(cw.c[None, :] + z)) + jnp.exp(-(cw.c[None, :] - z))
    sums = jnp.sum(contrib, axis=0)
    # T=0 entry: I=0 exactly for every path.
    return sums.at[0].set(2.0 * G.shape[0])


def antithetic_state(cfg: HWConfig, zw: ZBCWeights, G) -> PathState:
    """Final (r, I) at S1 for both legs from one matmul."""
    z = jnp.dot(G, zw.U, preferred_element_type=jnp.float32,
                precision=cfg.matmul_precision)
    c_r, c_i = zw.det[0], zw.det[1]
    return PathState(
        r_p=c_r + z[:, 0], r_m=c_r - z[:, 0],
        i_p=c_i + z[:, 1], i_m=c_i - z[:, 1],
    )


def dual_state(cfg: HWConfig, zw: ZBCWeights, G) -> DualState:
    """(r, dr/dsigma, I, dI/dsigma) at S1, single +G leg.

    The tangent's stochastic part is exactly z / sigma because its shock
    scale is sig_st/sigma with identical mean-reversion decay
    (3_sensitivity_analysis.cu:54-61).
    """
    z = jnp.dot(G, zw.U, preferred_element_type=jnp.float32,
                precision=cfg.matmul_precision)
    c_r, c_i, c_dr, c_di = zw.det[0], zw.det[1], zw.det[2], zw.det[3]
    return DualState(
        r=c_r + z[:, 0],
        dr=c_dr + z[:, 0] / zw.sigma,
        i_r=c_i + z[:, 1],
        di_r=c_di + z[:, 1] / zw.sigma,
    )
