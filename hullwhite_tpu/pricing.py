"""Host drivers & estimators: curve bootstrap, theta recovery, ZBC pricing,
pathwise vega.

JAX replacement for the reference's L4 host-driver layer (the four
``main()``s and their ``run_*`` helpers, SURVEY §2.6): instead of
alloc/memcpy/kernel-launch sequences, each product is a single jitted
function that streams Gaussian blocks through an engine and reduces partial
sums — on one device or across a mesh (``parallel.mesh``).

Engines:
  * ``"linear"`` — the full-step matmul formulation (ops.engine_linear);
  * ``"scan"``   — the lax.scan reference implementation (ops.engine_scan);
  * ``"exact"``  — Cholesky functional sampling (ops.engine_exact).
Cross-engine price agreement is enforced by tests, mirroring the
reference's <1e-6 reduction-variant consistency check
(benchmark_reductions.cu:158-169).
"""

from __future__ import annotations

from functools import lru_cache, partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from .backend import ENGINES, check_engine
from .config import HWConfig
from .models import hull_white as hw
from .models.hull_white import MarketCurve
from .ops import engine_exact, engine_linear, engine_scan, payoffs
from .ops.payoffs import CVEstimate, N_MOMENTS
from .ops.rng import block_normals
from .parallel import mesh as pmesh

# Engine tiers (the analogue of the reference's three reduction-strategy
# kernel variants, perf_benchmark.cuh):
#   scan         lax.scan step-by-step (semantic reference)
#   linear       full shock matmul (step-exact, fp32)
#   exact        Cholesky functional sampling (distributionally exact)
# (the list is backend.ENGINES, re-exported here for the CLI.)

_XLA_ENGINES = {"linear": engine_linear, "scan": engine_scan,
                "exact": engine_exact}


def _xla_state_setup(cfg: HWConfig, engine: str, tables, dual: bool):
    """(n_cols, state_of) for the option-leg products."""
    n1 = cfg.n_steps_s1
    if engine == "scan":
        fn = engine_scan.dual_state if dual else engine_scan.antithetic_state
        return n1, lambda G: fn(cfg, tables, G)
    if engine == "linear":
        zw = engine_linear.zbc_weights(cfg, tables)
        fn = engine_linear.dual_state if dual else engine_linear.antithetic_state
        return n1, lambda G: fn(cfg, zw, G)
    if engine == "exact":
        zw = engine_exact.zbc_weights(cfg, tables)
        fn = engine_exact.dual_state if dual else engine_exact.antithetic_state
        return 2, lambda G: fn(cfg, zw, G)
    raise ValueError(engine)


def _dtype(cfg: HWConfig):
    return jnp.dtype(cfg.dtype)


def _block_loop(block_fn, out_dim):
    """(key, base, n_blocks) -> float32 (out_dim,) partial sums.

    The running sum is compensated (Kahan): a plain fp32 accumulator over
    512 blocks of the 2^24-pair curve loses ~1e-5 of P(0,T) — as much as
    the Monte Carlo error — and makes a sharded run (fewer blocks per
    device) differ from the single-device one by that much."""

    def local(key, base, n_blocks):
        def body(i, carry):
            total, comp = carry
            y = block_fn(key, base + i) - comp
            t = total + y
            return t, (t - total) - y

        zero = jnp.zeros((out_dim,), jnp.float32)
        return lax.fori_loop(0, n_blocks, body, (zero, zero))[0]

    return local


# ---------------------------------------------------------------------------
# Q1 — zero-coupon curve bootstrap (reference 1_bond_pricing.cu:23-185)
# ---------------------------------------------------------------------------

# Prepared/run split: the sigma-dependent tables and weights are a
# chain of small ops, and the reference's compute_constants runs OUTSIDE
# its cudaEvent window (1_bond_pricing.cu:49 vs :60).  Drivers that time
# the hot kernel therefore prepare once per sigma (_curve_prep_fn) and
# loop the run function (_curve_sums_run_fn); the composed _curve_sums_fn
# keeps the one-call API for everything else.

def _curve_prep_body(cfg: HWConfig, engine: str, sigma, sigma0):
    check_engine(engine)
    tables = hw.step_tables(cfg, sigma, sigma0, _dtype(cfg))
    if engine == "scan":
        return tables
    if engine == "linear":
        return engine_linear.curve_weights(cfg, tables)
    return engine_exact.curve_weights(cfg, tables)


def _curve_run_body(cfg: HWConfig, engine: str, mesh, key, prepared):
    check_engine(engine)
    dtype = _dtype(cfg)
    if engine == "scan":
        n_cols = cfg.n_steps
        block_sums = lambda G: engine_scan.curve_discount_sums(
            cfg, prepared, G)
    elif engine == "linear":
        n_cols = cfg.n_steps
        block_sums = lambda G: engine_linear.curve_discount_sums(
            cfg, prepared, G)
    else:
        n_cols = cfg.n_mat - 1
        block_sums = lambda G: engine_exact.curve_discount_sums(
            cfg, prepared, G)

    def block_fn(key, i):
        G = block_normals(key, i, (cfg.path_block, n_cols), dtype)
        return block_sums(G).astype(jnp.float32)

    local = _block_loop(block_fn, cfg.n_mat)
    runner = pmesh.shard_blocks(local, mesh)
    return runner(key, cfg.n_blocks)


@lru_cache(maxsize=None)
def _curve_prep_fn(cfg: HWConfig, engine: str):
    return jax.jit(partial(_curve_prep_body, cfg, engine))


@lru_cache(maxsize=None)
def _curve_sums_run_fn(cfg: HWConfig, engine: str, mesh):
    return jax.jit(partial(_curve_run_body, cfg, engine, mesh))


@lru_cache(maxsize=None)
def _curve_sums_fn(cfg: HWConfig, engine: str, mesh):
    def compute(key, sigma, sigma0):
        return _curve_run_body(cfg, engine, mesh, key,
                               _curve_prep_body(cfg, engine, sigma, sigma0))

    return jax.jit(compute)


def bootstrap_curve(cfg: HWConfig, key, *, sigma=None, sigma0=None,
                    engine: str = "linear", mesh=None) -> MarketCurve:
    """Monte-Carlo P(0,T) curve + forward rates f(0,T).

    P(0,T_m) = E[exp(-int_0^{T_m} r ds)] over 2*n_paths antithetic legs;
    f = -d ln P / dT by grid finite differences (market_data.cuh:101-127).
    """
    if sigma is None:
        sigma = cfg.sigma
    if sigma0 is None:
        sigma0 = cfg.sigma
    sums = _curve_sums_fn(cfg, engine, mesh)(key, sigma, sigma0)
    P = sums / (2.0 * cfg.n_paths)
    f = hw.forward_from_p(cfg, P)
    return MarketCurve(P=P, f=f)


class ThetaRecovery(NamedTuple):
    Ts: jax.Array
    theta_recovered: jax.Array
    theta_true: jax.Array
    max_error: float
    mean_error: float
    success: bool


def theta_recovery(cfg: HWConfig, market: MarketCurve,
                   sigma=None) -> ThetaRecovery:
    """Q2a: recover theta(T) from the bootstrapped forward curve and gate
    max error < 0.01 (reference 2_option_pricing.cu:39-102)."""
    if sigma is None:
        sigma = cfg.sigma
    rec, true, Ts = hw.recover_theta(cfg, sigma, market.f)
    err = jnp.abs(rec - true)
    max_err = float(jnp.max(err))
    mean_err = float(jnp.mean(err))
    return ThetaRecovery(Ts, rec, true, max_err, mean_err, max_err < 0.01)


# ---------------------------------------------------------------------------
# Q2b — ZBC option with optimal-beta control variate
# (reference simulate_ZBC_control_variate + run_ZBC_control_variate)
# ---------------------------------------------------------------------------

def _option_prep_body(cfg: HWConfig, engine: str, kind: str, sigma, sigma0,
                      market):
    """(prepared, sigma, market-ish) pytree for the option products.

    The engines keep (weights, sigma) and consume ``market`` at run time.
    The output is kind-independent (zbc_weights serve both the zbc and
    vega run bodies; dual vs antithetic is a run-time choice)."""
    check_engine(engine)
    dtype = _dtype(cfg)
    tables = hw.step_tables(cfg, sigma, sigma0, dtype)
    if engine == "scan":
        w = tables
    elif engine == "linear":
        w = engine_linear.zbc_weights(cfg, tables)
    else:
        w = engine_exact.zbc_weights(cfg, tables)
    return (w, jnp.asarray(sigma, dtype))


def _option_run_body(cfg: HWConfig, engine: str, kind: str, mesh, key,
                     prepared, market):
    check_engine(engine)
    dtype = _dtype(cfg)
    w, sigma = prepared
    n1 = cfg.n_steps_s1
    eng = _XLA_ENGINES[engine]
    fn = eng.dual_state if kind == "vega" else eng.antithetic_state
    n_cols = {"scan": n1, "linear": n1, "exact": 2}[engine]

    def block_fn(key, i):
        G = block_normals(key, i, (cfg.path_block, n_cols), dtype)
        st = fn(cfg, w, G)
        if kind == "zbc":
            return payoffs.zbc_moments(cfg, sigma, market, st)
        return payoffs.vega_sum(cfg, sigma, market, st)

    local = _block_loop(block_fn, N_MOMENTS if kind == "zbc" else 2)
    runner = pmesh.shard_blocks(local, mesh)
    return runner(key, cfg.n_blocks)


@lru_cache(maxsize=None)
def _option_prep_fn(cfg: HWConfig, engine: str, kind: str):
    return jax.jit(partial(_option_prep_body, cfg, engine, kind))


@lru_cache(maxsize=None)
def _option_run_fn(cfg: HWConfig, engine: str, kind: str, mesh):
    return jax.jit(partial(_option_run_body, cfg, engine, kind, mesh))


@lru_cache(maxsize=None)
def _zbc_moments_fn(cfg: HWConfig, engine: str, mesh):
    def compute(key, sigma, sigma0, market):
        prepared = _option_prep_body(cfg, engine, "zbc", sigma, sigma0,
                                     market)
        return _option_run_body(cfg, engine, "zbc", mesh, key, prepared,
                                market)

    return jax.jit(compute)


def price_zbc(cfg: HWConfig, key, market: MarketCurve, *, sigma=None,
              sigma0=None, engine: str = "linear", mesh=None) -> CVEstimate:
    """European call on P(S1,S2), CV-adjusted with empirically optimal beta*."""
    if sigma is None:
        sigma = cfg.sigma
    if sigma0 is None:
        sigma0 = cfg.sigma
    moments = _zbc_moments_fn(cfg, engine, mesh)(key, sigma, sigma0, market)
    return payoffs.cv_estimate(moments, market.P[-1])


# ---------------------------------------------------------------------------
# N-run statistical validation, batched on device
#
# The reference re-launches its kernel from a host loop, once per seed
# (2_option_pricing.cu:210-468).  Here the whole validation is ONE device
# call: lax.map over run indices (each folding its own key), with the
# CV-estimator math vmapped inside the same jit — one compile, one host
# fetch instead of n launches and n transfers.
# ---------------------------------------------------------------------------

@lru_cache(maxsize=None)
def _validate_zbc_fn(cfg: HWConfig, engine: str, mesh, n_runs: int,
                     offset: int):
    inner = _zbc_moments_fn(cfg, engine, mesh)

    def compute(key, sigma, sigma0, market):
        def one(i):
            m = inner(jax.random.fold_in(key, offset + i), sigma, sigma0,
                      market)
            return payoffs.cv_estimate(m, market.P[-1])

        return lax.map(one, jnp.arange(n_runs))

    return jax.jit(compute)


def validate_zbc_runs(cfg: HWConfig, key, market: MarketCurve, *,
                      n_runs: int, engine: str = "linear", mesh=None,
                      offset: int = 1000) -> CVEstimate:
    """n_runs independent CV estimates in one device call; every leaf of the
    returned CVEstimate is a host (n_runs,) array."""
    est = _validate_zbc_fn(cfg, engine, mesh, n_runs, offset)(
        key, cfg.sigma, cfg.sigma, market)
    return jax.device_get(est)


@lru_cache(maxsize=None)
def _validate_vega_fn(cfg: HWConfig, engine: str, mesh, n_runs: int,
                      offset: int):
    inner = _vega_sums_fn(cfg, engine, mesh)

    def compute(key, sigma, sigma0, market):
        def one(i):
            s = inner(jax.random.fold_in(key, offset + i), sigma, sigma0,
                      market)
            return s[0] / s[1]

        return lax.map(one, jnp.arange(n_runs))

    return jax.jit(compute)


def validate_vega_runs(cfg: HWConfig, key, market: MarketCurve, *,
                       n_runs: int, engine: str = "linear", mesh=None,
                       offset: int = 2000):
    """n_runs independent pathwise-vega estimates, one device call."""
    v = _validate_vega_fn(cfg, engine, mesh, n_runs, offset)(
        key, cfg.sigma, cfg.sigma, market)
    return jax.device_get(v)


# ---------------------------------------------------------------------------
# Q3 — pathwise vega via the hand-derived dual (tangent) process
# (reference simulate_sensitivity, 3_sensitivity_analysis.cu:22-96)
# ---------------------------------------------------------------------------

@lru_cache(maxsize=None)
def _vega_sums_fn(cfg: HWConfig, engine: str, mesh):
    def compute(key, sigma, sigma0, market):
        prepared = _option_prep_body(cfg, engine, "vega", sigma, sigma0,
                                     market)
        return _option_run_body(cfg, engine, "vega", mesh, key, prepared,
                                market)

    return jax.jit(compute)


def pathwise_vega(cfg: HWConfig, key, market: MarketCurve, *, sigma=None,
                  engine: str = "linear", mesh=None):
    """E[ 1{P>K} dP/dsigma * D - (int dr/dsigma) * D * payoff ] (single leg
    per path, like the reference kernel)."""
    if sigma is None:
        sigma = cfg.sigma
    sums = _vega_sums_fn(cfg, engine, mesh)(key, sigma, cfg.sigma, market)
    return sums[0] / sums[1]


# ---------------------------------------------------------------------------
# Pathwise delta (d price / d r0) — beyond the reference's greeks
# ---------------------------------------------------------------------------

def _r0_sensitivities(cfg: HWConfig):
    """Deterministic (dr(S1)/dr0, dI(S1)/dr0) in float64 on the host."""
    import math

    E = math.exp(-cfg.a * cfg.dt)
    n1 = cfg.n_steps_s1
    dr = E ** n1
    di = cfg.dt * (0.5 + sum(E ** k for k in range(1, n1)) + 0.5 * E ** n1)
    return dr, di


@lru_cache(maxsize=None)
def _delta_sums_fn(cfg: HWConfig, engine: str, mesh):
    dtype = _dtype(cfg)
    dr_dr0, di_dr0 = _r0_sensitivities(cfg)

    def compute(key, sigma, sigma0, market):
        tables = hw.step_tables(cfg, sigma, sigma0, dtype)
        n_cols, state_of = _xla_state_setup(cfg, engine, tables, dual=False)

        def block_fn(key, i):
            G = block_normals(key, i, (cfg.path_block, n_cols), dtype)
            return payoffs.delta_sum(cfg, sigma, market, state_of(G),
                                     dr_dr0, di_dr0)

        local = _block_loop(block_fn, 2)
        runner = pmesh.shard_blocks(local, mesh)
        return runner(key, cfg.n_blocks)

    return jax.jit(compute)


def pathwise_delta(cfg: HWConfig, key, market: MarketCurve, *, sigma=None,
                   engine: str = "exact", mesh=None):
    """Pathwise d price / d r0 over both antithetic legs (sensitivity to
    the initial short rate at fixed market data)."""
    if sigma is None:
        sigma = cfg.sigma
    check_engine(engine)
    sums = _delta_sums_fn(cfg, engine, mesh)(key, sigma, cfg.sigma, market)
    return sums[0] / sums[1]


class Pricer(NamedTuple):
    """Public prepared/run pair for latency-critical serving loops.

    ``prepare(sigma, sigma0[, market])`` jit-builds the sigma-dependent
    tables/weights once; ``run(key, prepared[, market])`` executes only
    the hot kernel.  Repricing the same model under many keys (the serving
    pattern) skips the per-call weight build that the one-call API pays;
    CRN/vega semantics are unchanged
    (prepare is a pure jitted function of sigma).
    """

    prepare: callable
    run: callable


def curve_pricer(cfg: HWConfig, *, engine: str = "linear",
                 mesh=None) -> Pricer:
    """prepare(sigma, sigma0) -> prepared;  run(key, prepared) ->
    (n_mat,) discount sums (divide by 2 n_paths for P(0,T))."""
    return Pricer(prepare=_curve_prep_fn(cfg, engine),
                  run=_curve_sums_run_fn(cfg, engine, mesh))


def zbc_pricer(cfg: HWConfig, *, engine: str = "linear",
               mesh=None) -> Pricer:
    """prepare(sigma, sigma0, market) -> prepared;  run(key, prepared,
    market) -> (6,) CV moments (payoffs.cv_estimate finishes the job)."""
    return Pricer(prepare=_option_prep_fn(cfg, engine, "zbc"),
                  run=_option_run_fn(cfg, engine, "zbc", mesh))


def vega_pricer(cfg: HWConfig, *, engine: str = "linear",
                mesh=None) -> Pricer:
    """prepare(sigma, sigma0, market) -> prepared;  run(key, prepared,
    market) -> (2,) [vega sum, count]."""
    return Pricer(prepare=_option_prep_fn(cfg, engine, "vega"),
                  run=_option_run_fn(cfg, engine, "vega", mesh))
